"""Per-level data container (reference: include/cedar/level.h:14-45).

PyTorch counterpart of :mod:`cedar_tpu.solver.level`, with the fields the
2D point- and line-relaxation and the 3D point-relaxation paths with a
direct coarse solve use.  ``levels[l+1].ci`` interpolates level ``l+1`` ->
``l``; ``ainv`` is set on the coarsest level.
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


def levels_from_numpy(levels_np, device=None, dtype=None) -> tuple:
    """A hierarchy of numpy arrays (e.g. ``np.asarray`` of each field of the
    JAX package's ``Level``s, or those ``Level``s themselves) as this
    package's :class:`Level` tuple.

    Each entry is a mapping or a ``NamedTuple`` with any of the fields
    ``so``, ``recip``, ``ci``, ``sor_x``, ``sor_y``, ``ainv``; other fields
    are ignored, among them the TPU layouts of a JAX ``Solver3`` hierarchy
    (``cip``, the padded restriction weights; ``so2``, the octant-split
    stencil; ``pw4``, the split transfer weights), which the port's dense
    kernels do not use.  The arrays are copied.  A ``sor_x`` / ``sor_y`` that is
    not an array (the JAX package's SPIKE factors, ``lines2.SpikeLines``,
    which it builds for lines of 16 points or more) is not converted: the
    field stays None and the line sweep factors the lines from ``so`` with
    :func:`cedar_tpu_torch.ops.lines2.setup_lines`'s recurrence.
    """
    out = []
    for lev in levels_np:
        fields = lev if isinstance(lev, Mapping) else lev._asdict()
        out.append(Level(**{
            k: torch.tensor(np.asarray(fields[k]), dtype=dtype, device=device)
            for k in Level._fields
            if fields.get(k) is not None and not isinstance(fields[k], tuple)
        }))
    return tuple(out)
