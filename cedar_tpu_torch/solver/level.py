"""Per-level data container (reference: include/cedar/level.h:14-45).

PyTorch counterpart of :mod:`cedar_tpu.solver.level`, with the fields the
2D point- and line-relaxation and the 3D point- and plane-relaxation paths
use.  ``levels[l+1].ci`` interpolates level ``l+1`` -> ``l``; the coarsest
level holds ``ainv`` (the direct coarse solve) or ``inner`` (``cg-solver:
cedar``: the nested hierarchy of the inner multigrid solve, itself a tuple
of levels whose coarsest may hold an ``inner`` again).

A level of a batched 2D hierarchy (the embedded plane solvers of plane
relaxation) holds a batch of planes, the batch axis after the leading
axis: ``so`` ``(ndir, B, nx, ny)``, ``ci`` ``(8, B, …)``, ``sor_*`` ``(2,
B, nx, ny)``, ``ainv`` ``(B, n, n)``; its ``inner`` is batched alike.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple, Optional

import numpy as np
import torch


class Level(NamedTuple):
    so: torch.Tensor                          # (ndir, nx, ny[, nz]) stencil
    recip: Optional[torch.Tensor] = None      # 1/diag (point relax)
    ci: Optional[torch.Tensor] = None         # interp weights to the finer level
    sor_x: Optional[torch.Tensor] = None      # x-line LDLᵀ factors (CPU path)
    sor_y: Optional[torch.Tensor] = None      # y-line LDLᵀ factors (CPU path)
    ainv: Optional[torch.Tensor] = None       # coarsest: dense inverse
    # 3D plane relaxation: orient -> (colour 0, colour 1) batched 2D
    # hierarchies of the planes of that zebra colour (None when empty)
    planes: Optional[dict] = None
    # coarsest, cg-solver cedar: the inner solver's hierarchy
    inner: Optional[tuple] = None


def levels_from_numpy(levels_np, device=None, dtype=None) -> tuple:
    """A hierarchy of numpy arrays (e.g. ``np.asarray`` of each field of the
    JAX package's ``Level``s, or those ``Level``s themselves) as this
    package's :class:`Level` tuple.

    Each entry is a mapping or a ``NamedTuple`` with any of the fields
    ``so``, ``recip``, ``ci``, ``sor_x``, ``sor_y``, ``ainv``, ``planes``,
    ``inner`` (the nested hierarchy of ``cg-solver: cedar``, carried across
    the same way, to any depth);
    other fields are ignored, among them the TPU layouts that the port's
    dense kernels do not use: those of a JAX ``Solver2`` hierarchy with
    ``kernels.fine-split`` (``cip``, the padded CI; ``rec2``, the
    lane-split 1/diag; ``so2``, the lane-split stencil), whose fused cycle
    the port runs from ``so`` and ``ci``, and those of a JAX ``Solver3``
    hierarchy (``cip``, the padded restriction weights; ``so2``, the
    octant-split stencil; ``pw4``, the split transfer weights).  The arrays
    are copied as they are: a periodic hierarchy comes across unchanged,
    CI with its wrap entries (tests/test_torch_periodic2_solver.py,
    tests/test_torch_periodic3_solver.py).  A
    ``sor_x`` / ``sor_y`` that is not an array (the JAX package's SPIKE
    factors, ``lines2.SpikeLines``, which it builds for lines of 16 points
    or more) is not converted: the field stays None and the line sweep
    factors the lines from ``so`` with
    :func:`cedar_tpu_torch.ops.lines2.setup_lines`'s recurrence.

    ``planes`` (orient -> the JAX package's batched 2D hierarchy over all
    planes, batch axis first: ``(B, ndir, nx, ny)``, ``(B, 8, …)``, ``(B, n,
    n)``, its ``inner`` batched alike) becomes orient -> one hierarchy per
    zebra colour in this package's layout, the planes ``c::2`` of the
    batch, contiguous.
    """
    out = []
    for lev in levels_np:
        fields = _fields(lev)
        conv = {k: torch.tensor(np.asarray(fields[k]), dtype=dtype,
                                device=device)
                for k in Level._fields if _is_array(fields.get(k))}
        if fields.get("planes") is not None:
            conv["planes"] = {
                orient: tuple(_colour(hier, c, device, dtype) for c in (0, 1))
                for orient, hier in fields["planes"].items()
            }
        if fields.get("inner") is not None:
            conv["inner"] = levels_from_numpy(fields["inner"], device, dtype)
        out.append(Level(**conv))
    return tuple(out)


def _fields(lev) -> Mapping:
    return lev if isinstance(lev, Mapping) else lev._asdict()


def _is_array(v) -> bool:
    return v is not None and not isinstance(v, (tuple, Mapping))


def _colour(hier, c: int, device, dtype):
    """The planes ``c::2`` of a batch-first JAX plane hierarchy, moved to
    this package's layout (batch axis after the leading axis of the
    stencil, CI and line factors; first for ``ainv`` and ``recip``), its
    ``inner`` hierarchy too, or None when that colour has no plane."""
    levels = []
    for lev in hier:
        fields = _fields(lev)
        conv = {}
        if fields.get("inner") is not None:
            conv["inner"] = _colour(fields["inner"], c, device, dtype)
        for k in Level._fields:
            if not _is_array(fields.get(k)):
                continue
            a = np.asarray(fields[k])
            if a.shape[0] <= c:
                return None
            a = np.swapaxes(a, 0, 1)[:, c::2] if a.ndim == 4 else a[c::2]
            conv[k] = torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)
        levels.append(Level(**conv))
    return tuple(levels)
