"""3D multicolor Gauss-Seidel point relaxation.

PyTorch counterpart of :mod:`cedar_tpu.ops.relax3` and of the sweep entry
of :mod:`cedar_tpu.ops.pallas3` (``fuse_residual`` and ``origin``).  Each
colour phase updates all points of one colour at once:
``q <- (b + offdiag·q) * recip`` there.  Colour semantics match the
reference (BMG3_SymStd_relax_GS.f90:85-187):

* 27-point: eight colours ``c = pts - 1`` (``pts = 1..8``) with parities
  ``x: c % 2``, ``y: (c // 2) % 2``, ``z: (c // 4) % 2``.  UP sweeps
  ``pts`` 1..8, DOWN 8..1 — the mirror of the 2D convention, where DOWN
  runs forward.
* 7-point: red-black on the parity of ``x + y + z``; UP relaxes parity 0
  then 1, DOWN parity 1 then 0.

Colours anchor to GLOBAL indices ``(x + origin[0], y + origin[1],
z + origin[2])``.

On a periodic axis (``periodic``, cedar_tpu/ops/relax3.py:61-84) the
couplings wrap around.  Along a periodic axis of odd extent the wrap couples
points of one colour (the last point and the first); a phase still computes
every point of its colour from the values before the phase, as the JAX
masked update does.

:func:`point_relax` dispatches by device (and ``kernels.backend``,
:mod:`cedar_tpu_torch.ops.backend`: under ``xla`` every tensor takes the
plain version): a CUDA tensor goes to the sweep kernel
(:mod:`cedar_tpu_torch.ops.cuda3`), a CPU tensor to its plain version,
which runs :func:`sweep3_torch`.  Both return the swept iterate
in a new tensor and leave ``q`` as it was.
"""

from __future__ import annotations

import functools

import torch

from cedar_tpu_torch.ops import backend
from cedar_tpu_torch.core.types import Dir3, StencilKind
from cedar_tpu_torch.ops.stencil3 import offdiag_apply, residual


def setup_recip(so: torch.Tensor) -> torch.Tensor:
    """1/diag (reference: BMG3_SymStd_SETUP_recip.f90)."""
    return 1.0 / so[Dir3.P]


def color_order(kind: StencilKind, updown: str) -> list[int]:
    """Colour phases in sweep order: 7-point parities of ``x + y + z``,
    27-point colours ``c = pts - 1`` (parities ``(c & 1, c >> 1 & 1,
    c >> 2 & 1)`` on x, y, z).  The sweep kernel's wrapper reads this too."""
    if kind == StencilKind.seven_pt:
        return [0, 1] if updown == "up" else [1, 0]
    order = list(range(8))
    return order if updown == "up" else order[::-1]


@functools.lru_cache(maxsize=None)
def pack_colors(kind: StencilKind, updown: str) -> int:
    """The colour codes of :func:`color_order` packed 4 bits each in sweep
    order, as the sweep kernels take them."""
    return sum(c << (4 * k) for k, c in enumerate(color_order(kind, updown)))


def check_sweep(so, q, b, kind: StencilKind) -> None:
    """The operand checks of a 3D point sweep (the kernels' wrappers and
    their plain versions)."""
    if kind not in (StencilKind.seven_pt, StencilKind.twenty_seven_pt):
        # a phase updates its colour from the others' values only for
        # colourings in which no point couples to its own colour: red-black
        # 7-pt, 8-colour 27-pt
        raise ValueError(f"sweep takes 3D seven_pt or twenty_seven_pt, "
                         f"not {kind}")
    if q.ndim != 3 or b.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} and b {tuple(b.shape)}")
    if tuple(so.shape) != (kind.ndirs, *q.shape):
        raise ValueError(
            f"so {tuple(so.shape)} does not fit {kind} on {tuple(q.shape)}"
        )


def color_masks(shape, kind: StencilKind, updown: str, origin=(0, 0, 0),
                device=None):
    """Boolean masks for each colour phase, in reference sweep order."""
    xp = (torch.arange(shape[0], device=device)[:, None, None]
          + origin[0]) % 2
    yp = (torch.arange(shape[1], device=device)[None, :, None]
          + origin[1]) % 2
    zp = (torch.arange(shape[2], device=device)[None, None, :]
          + origin[2]) % 2
    masks = []
    for c in color_order(kind, updown):
        if kind == StencilKind.seven_pt:
            m = (xp + yp + zp) % 2 == c
        else:
            m = ((xp == (c & 1)) & (yp == ((c >> 1) & 1))
                 & (zp == ((c >> 2) & 1)))
        masks.append(m.expand(tuple(shape)))
    return masks


def sweep3_torch(so, q, b, recip, kind: StencilKind, updown: str,
                 fuse_residual: bool = False, origin=(0, 0, 0),
                 periodic=(False, False, False)):
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
                fuse_residual: bool = False, origin=None,
                periodic=(False, False, False)):
    """One multicolour GS sweep (all colours), DOWN or UP ordering.

    Returns the swept iterate in a new tensor and leaves ``q`` as it was;
    with ``fuse_residual`` returns ``(q_new, b - A q_new)``.  ``origin``
    (default zeros) is the global index of ``q[0, 0, 0]``.  ``recip``
    (``1/diag``) feeds the CPU path; the CUDA kernels form ``1/diag``
    themselves, with the same rounding.  ``periodic`` marks the axes whose
    couplings wrap around.
    """
    from cedar_tpu_torch.ops import cuda3

    origin = (0, 0, 0) if origin is None else tuple(int(o) for o in origin)
    if backend.kernels(q, "sweep"):
        return cuda3.sweep(so, q, b, kind, updown, fuse_residual, origin,
                           periodic)
    return cuda3.sweep_plain(so, q, b, kind, updown, fuse_residual, origin,
                             periodic, recip=recip)
