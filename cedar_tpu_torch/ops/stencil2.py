"""2D stencil application primitives: matvec, residual, full-offset views.

PyTorch counterpart of :mod:`cedar_tpu.ops.stencil2` (reference:
BMG2_SymStd_residual.f90:85-119, BMG2_SymStd_UTILS_matvec.f90).  On an axis
marked in ``periodic`` the shifts wrap around (a neighbour at -1 is the last
point, and an up-shifted coupling at the last point reads the first).

Sign convention (reference residual loop): off-diagonals are stored positive
so ``(A q)(z,w) = O·q - Σ_offdiag so_d·q_neighbor`` and
``res = b - A q = b + Σ offdiag·q_nb - O·q``.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.shift import shift2
from cedar_tpu_torch.core.types import Dir2, StencilKind

# The 8 neighbor offsets of the full 2D stencil, with the symmetric-storage
# plane and the shift applied to that plane to place the coupling at the row
# point: (dz, dw) -> (plane, plane_shift_z, plane_shift_w).
#   coupling to (z-1,w)   = W(z,w)
#   coupling to (z+1,w)   = W(z+1,w)
#   coupling to (z,w-1)   = S(z,w)
#   coupling to (z,w+1)   = S(z,w+1)
#   coupling to (z-1,w-1) = SW(z,w)
#   coupling to (z+1,w-1) = NW(z+1,w)
#   coupling to (z-1,w+1) = NW(z,w+1)
#   coupling to (z+1,w+1) = SW(z+1,w+1)
NEIGHBOR_COUPLINGS = {
    (-1, 0): (Dir2.W, 0, 0),
    (1, 0): (Dir2.W, 1, 0),
    (0, -1): (Dir2.S, 0, 0),
    (0, 1): (Dir2.S, 0, 1),
    (-1, -1): (Dir2.SW, 0, 0),
    (1, -1): (Dir2.NW, 1, 0),
    (-1, 1): (Dir2.NW, 0, 1),
    (1, 1): (Dir2.SW, 1, 1),
}


def offsets_for(kind: StencilKind):
    if kind == StencilKind.five_pt:
        return [(-1, 0), (1, 0), (0, -1), (0, 1)]
    return list(NEIGHBOR_COUPLINGS.keys())


def coupling(so: torch.Tensor, off, periodic=(False, False)) -> torch.Tensor:
    """Positive coupling magnitude of each point to its ``off`` neighbor."""
    plane, sz, sw = NEIGHBOR_COUPLINGS[off]
    p = so[plane]
    if sz or sw:
        p = shift2(p, sz, sw, periodic)
    return p


def full_offsets(so: torch.Tensor, kind: StencilKind,
                 periodic=(False, False)):
    """Row-form full stencil: dict ``(dz,dw) -> A[(z,w),(z+dz,w+dw)]``.

    Off-diagonal entries carry their TRUE (negative of stored) sign;
    the center entry is ``+O``.
    """
    out = {(0, 0): so[Dir2.O]}
    for off in offsets_for(kind):
        out[off] = -coupling(so, off, periodic)
    return out


def offdiag_apply(so: torch.Tensor, q: torch.Tensor, kind: StencilKind,
                  periodic=(False, False)) -> torch.Tensor:
    """``Σ_offdiag so_d(z,w) · q(neighbor)`` with positive-stored couplings,
    summed in :func:`offsets_for` order (the sweep kernel keeps it)."""
    acc = None
    for off in offsets_for(kind):
        term = (coupling(so, off, periodic)
                * shift2(q, off[0], off[1], periodic))
        acc = term if acc is None else acc + term
    return acc


def matvec(so: torch.Tensor, q: torch.Tensor, kind: StencilKind,
           periodic=(False, False)) -> torch.Tensor:
    """``A q`` (reference: BMG2_SymStd_UTILS_matvec.f90)."""
    return so[Dir2.O] * q - offdiag_apply(so, q, kind, periodic)


def residual(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
             kind: StencilKind, periodic=(False, False)) -> torch.Tensor:
    """``b - A q`` (reference: BMG2_SymStd_residual.f90:85-119)."""
    return b + offdiag_apply(so, q, kind, periodic) - so[Dir2.O] * q
