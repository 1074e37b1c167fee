"""3D stencil application primitives (7/27-point): matvec, residual,
full-offset views.

PyTorch counterpart of :mod:`cedar_tpu.ops.stencil3` (reference:
BMG3_SymStd_residual.f90, BMG3_SymStd_UTILS_matvec.f90).  On an axis
marked in ``periodic`` the shifts wrap around (a neighbour at -1 is the last
point, and an up-shifted coupling at the last point reads the first;
cedar_tpu/ops/stencil3.py:75-103).

Symmetric storage (reference: 3d/base_types.h): plane directions
pw/ps/psw/pnw behave like the 2D w/s/sw/nw within each z-plane; the b*
planes couple (x,y,z) to the 9 points of the plane below (z-1):

  B(i,j,k)    couples (i,j,k)     <-> (i,j,k-1)
  BW(i,j,k)   couples (i,j,k)     <-> (i-1,j,k-1)
  BE(i,j,k)   couples (i-1,j,k)   <-> (i,j,k-1)
  BS(i,j,k)   couples (i,j,k)     <-> (i,j-1,k-1)
  BN(i,j,k)   couples (i,j-1,k)   <-> (i,j,k-1)
  BSW(i,j,k)  couples (i,j,k)     <-> (i-1,j-1,k-1)
  BSE(i,j,k)  couples (i-1,j,k)   <-> (i,j-1,k-1)
  BNW(i,j,k)  couples (i,j-1,k)   <-> (i-1,j,k-1)
  BNE(i,j,k)  couples (i-1,j-1,k) <-> (i,j,k-1)

Off-diagonals are stored positive: ``res = b + Σ offdiag·q_nb - P·q``.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.shift import shift3
from cedar_tpu_torch.core.types import Dir3, StencilKind

# (dz, dw, dv) -> (plane, shift applied to the plane); the "upper" half
# (dv = +1 and the in-plane uppers) are shifted reads of the stored lower
# half.  The sweep kernel (csrc/sweep3.cu) sums in this order.
NEIGHBOR_COUPLINGS_27 = {
    # in-plane (dv = 0), same as 2D
    (-1, 0, 0): (Dir3.PW, (0, 0, 0)),
    (1, 0, 0): (Dir3.PW, (1, 0, 0)),
    (0, -1, 0): (Dir3.PS, (0, 0, 0)),
    (0, 1, 0): (Dir3.PS, (0, 1, 0)),
    (-1, -1, 0): (Dir3.PSW, (0, 0, 0)),
    (1, -1, 0): (Dir3.PNW, (1, 0, 0)),
    (-1, 1, 0): (Dir3.PNW, (0, 1, 0)),
    (1, 1, 0): (Dir3.PSW, (1, 1, 0)),
    # plane below (dv = -1): BMG3_SymStd_residual.f90:80-89
    (0, 0, -1): (Dir3.B, (0, 0, 0)),
    (-1, 0, -1): (Dir3.BW, (0, 0, 0)),
    (1, 0, -1): (Dir3.BE, (1, 0, 0)),
    (0, -1, -1): (Dir3.BS, (0, 0, 0)),
    (0, 1, -1): (Dir3.BN, (0, 1, 0)),
    (-1, -1, -1): (Dir3.BSW, (0, 0, 0)),
    (1, -1, -1): (Dir3.BSE, (1, 0, 0)),
    (-1, 1, -1): (Dir3.BNW, (0, 1, 0)),
    (1, 1, -1): (Dir3.BNE, (1, 1, 0)),
    # plane above (dv = +1): BMG3_SymStd_residual.f90:90-98
    (0, 0, 1): (Dir3.B, (0, 0, 1)),
    (1, 0, 1): (Dir3.BW, (1, 0, 1)),
    (-1, 0, 1): (Dir3.BE, (0, 0, 1)),
    (0, 1, 1): (Dir3.BS, (0, 1, 1)),
    (0, -1, 1): (Dir3.BN, (0, 0, 1)),
    (1, 1, 1): (Dir3.BSW, (1, 1, 1)),
    (-1, 1, 1): (Dir3.BSE, (0, 1, 1)),
    (1, -1, 1): (Dir3.BNW, (1, 0, 1)),
    (-1, -1, 1): (Dir3.BNE, (0, 0, 1)),
}

SEVEN_OFFSETS = [
    (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1),
]


def offsets_for(kind: StencilKind):
    if kind == StencilKind.seven_pt:
        return list(SEVEN_OFFSETS)
    return list(NEIGHBOR_COUPLINGS_27.keys())


def coupling(so: torch.Tensor, off,
             periodic=(False, False, False)) -> torch.Tensor:
    """Positive coupling magnitude of each point to its ``off`` neighbor."""
    plane, sh = NEIGHBOR_COUPLINGS_27[off]
    p = so[plane]
    if any(sh):
        p = shift3(p, *sh, periodic=periodic)
    return p


def full_offsets(so: torch.Tensor, kind: StencilKind,
                 periodic=(False, False, False)):
    """Row-form full stencil: dict ``off -> A[pt, pt+off]`` (off-diagonals
    with their TRUE, negative sign; the centre entry is ``+P``)."""
    out = {(0, 0, 0): so[Dir3.P]}
    for off in offsets_for(kind):
        out[off] = -coupling(so, off, periodic)
    return out


def offdiag_apply(so: torch.Tensor, q: torch.Tensor, kind: StencilKind,
                  periodic=(False, False, False)) -> torch.Tensor:
    """``Σ_offdiag so_d · q(neighbor)``, summed in :func:`offsets_for`
    order (the sweep kernel keeps it)."""
    acc = None
    for off in offsets_for(kind):
        term = (coupling(so, off, periodic)
                * shift3(q, *off, periodic=periodic))
        acc = term if acc is None else acc + term
    return acc


def matvec(so: torch.Tensor, q: torch.Tensor, kind: StencilKind,
           periodic=(False, False, False)) -> torch.Tensor:
    """``A q`` (reference: BMG3_SymStd_UTILS_matvec.f90)."""
    return so[Dir3.P] * q - offdiag_apply(so, q, kind, periodic)


def residual(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
             kind: StencilKind,
             periodic=(False, False, False)) -> torch.Tensor:
    """``b - A q`` (reference: BMG3_SymStd_residual.f90)."""
    return b + offdiag_apply(so, q, kind, periodic) - so[Dir3.P] * q
