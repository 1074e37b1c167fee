"""2D multicolor Gauss-Seidel point relaxation.

PyTorch counterpart of :mod:`cedar_tpu.ops.relax2` and of the sweep entry
of :mod:`cedar_tpu.ops.pallas2` (``fuse_residual`` and ``origin``).  Each
colour phase updates all points of one colour at once:
``q <- (b + offdiag·q) * recip`` there.  Colour semantics match the
reference (BMG2_SymStd_relax_GS.f90):

* 5-point: red-black by parity of ``z + w``; DOWN sweeps parity 0 then 1,
  UP (symmetric post-smoothing) the reverse.
* 9-point: four colours ``(w % 2, z % 2)`` in the order
  ``(0,0), (0,1), (1,0), (1,1)`` DOWN, reversed UP.

Colours anchor to GLOBAL indices ``(z + origin[0], w + origin[1])``.  A
batch of independent planes (``q`` ``(B, nx, ny)``, ``so`` ``(ndir, B,
nx, ny)``: plane relaxation's embedded point smoothers) is swept plane by
plane, each plane's colours anchored to its own origin.

On a periodic axis (``periodic``, cedar_tpu/ops/relax2.py:73-83) the
couplings wrap around.  Along a periodic axis of odd extent the wrap couples
points of one colour (the last point and the first); a phase still computes
every point of its colour from the values before the phase.

:func:`point_relax` dispatches by device (and ``kernels.backend``,
:mod:`cedar_tpu_torch.ops.backend`: under ``xla`` every tensor takes the
plain version): a CUDA tensor goes to the sweep kernel
(:mod:`cedar_tpu_torch.ops.cuda2`, one launch a sweep), a CPU tensor to
its plain version, which runs :func:`sweep_torch`.  Either way it
returns the swept iterate in a new tensor and leaves ``q`` as it was, as
the JAX function does: callers rebind it.
"""

from __future__ import annotations

import functools

import torch

from cedar_tpu_torch.ops import backend
from cedar_tpu_torch.core.types import Dir2, StencilKind
from cedar_tpu_torch.ops.stencil2 import offdiag_apply, residual


def setup_recip(so: torch.Tensor) -> torch.Tensor:
    """1/diag (reference: BMG2_SymStd_SETUP_recip.f90)."""
    return 1.0 / so[Dir2.O]


def color_order(kind: StencilKind, updown: str):
    """Colour phases in sweep order: 5-point parities, 9-point ``(cw, cz)``
    pairs (``cw`` is the parity of the second axis, ``w``)."""
    if kind == StencilKind.five_pt:
        return [0, 1] if updown == "down" else [1, 0]
    order = [(0, 0), (0, 1), (1, 0), (1, 1)]
    return order if updown == "down" else order[::-1]


@functools.lru_cache(maxsize=None)
def pack_colors(kind: StencilKind, updown: str) -> tuple[int, int]:
    """The colour codes of :func:`color_order` packed 4 bits each in sweep
    order (5-point parity; 9-point ``2 cw + cz``), as the sweep kernels
    take them, and their count."""
    codes = [2 * c[0] + c[1] if kind == StencilKind.nine_pt else c
             for c in color_order(kind, updown)]
    return sum(code << (4 * k) for k, code in enumerate(codes)), len(codes)


def color_masks(shape, kind: StencilKind, updown: str, origin=(0, 0),
                device=None):
    """Boolean masks for each colour phase, in reference sweep order,
    colouring the last two axes of ``shape``: each plane of a batch ``(B,
    nx, ny)`` is coloured from its own origin."""
    zp = (torch.arange(shape[-2], device=device)[:, None] + origin[0]) % 2
    wp = (torch.arange(shape[-1], device=device)[None, :] + origin[1]) % 2
    masks = []
    for c in color_order(kind, updown):
        if kind == StencilKind.five_pt:
            m = (zp + wp) % 2 == c
        else:
            cw, cz = c
            m = (wp == cw) & (zp == cz)
        masks.append(m.expand(tuple(shape)))
    return masks


def sweep_torch(so, q, b, recip, kind: StencilKind, updown: str,
                fuse_residual: bool = False, origin=(0, 0),
                periodic=(False, False)):
    """One multicolour GS sweep in torch ops; returns new tensors
    (``q`` is not modified).  With ``fuse_residual`` returns ``(q, res)``."""
    if recip is None:
        recip = setup_recip(so)
    for mask in color_masks(q.shape, kind, updown, origin, q.device):
        upd = (b + offdiag_apply(so, q, kind, periodic)) * recip
        q = torch.where(mask, upd, q)
    if fuse_residual:
        return q, residual(so, q, b, kind, periodic)
    return q


def point_relax(so, q, b, recip, kind: StencilKind, updown: str,
                fuse_residual: bool = False, origin=(0, 0),
                periodic=(False, False)):
    """One multicolour GS sweep (all colours), DOWN or UP ordering.

    Returns the swept iterate, a new tensor; with ``fuse_residual`` returns
    ``(q_new, b - A q_new)``.  ``q`` is left as it was on both devices.
    ``recip`` (``1/diag``) feeds the CPU path; the CUDA kernel forms
    ``1/diag`` itself, with the same rounding.
    """
    from cedar_tpu_torch.ops import cuda2

    if backend.kernels(q, "sweep"):
        return cuda2.sweep(so, q, b, kind, updown, fuse_residual, origin,
                           periodic)
    return cuda2.sweep_plain(so, q, b, kind, updown, fuse_residual, origin,
                             periodic, recip=recip)
