"""Stencil type system and direction conventions.

The reference stores symmetric stencils with only the center + "lower"
off-diagonal directions, all off-diagonals stored with POSITIVE sign
(A = diag - offdiag); the "upper" directions are recovered by shifted reads
of the lower ones (e.g. north coupling of (i,j) = KS entry of (i,j+1)).
Reference: include/cedar/2d/base_types.h:4-14, include/cedar/3d/base_types.h:5-19,
usage in src/2d/ftn/BMG2_SymStd_residual.f90:91-100.

Unlike the reference's ghost-padded Fortran arrays, all arrays in this
framework are INTERIOR-ONLY:

* a 2D grid function on an ``nx × ny`` grid is an array of shape ``(nx, ny)``
  with 0-based indices ``z ∈ [0, nx)``, ``w ∈ [0, ny)``;
* a stencil operator is ``(ndir, nx, ny)``;
* Dirichlet ghosts are implicit zeros supplied by the shift helpers
  (:mod:`cedar_tpu_torch.core.shift`), periodic ghosts are wrap-around shifts.

Coarsening keeps EVEN interior indices: coarse point ``zc`` is coincident
with fine point ``2*zc``; ``nxc = (nx-1)//2 + 1`` (reference:
include/cedar/2d/solver.h:75-116).
"""

from __future__ import annotations

import enum


class StencilKind(enum.Enum):
    five_pt = "five_pt"
    nine_pt = "nine_pt"
    seven_pt = "seven_pt"
    twenty_seven_pt = "twenty_seven_pt"

    @property
    def ndim(self) -> int:
        return 2 if self in (StencilKind.five_pt, StencilKind.nine_pt) else 3

    @property
    def ndirs(self) -> int:
        return {
            StencilKind.five_pt: 3,
            StencilKind.nine_pt: 5,
            StencilKind.seven_pt: 4,
            StencilKind.twenty_seven_pt: 14,
        }[self]

    @property
    def full(self) -> "StencilKind":
        """The stencil kind of a Galerkin-coarsened operator of this kind."""
        return (
            StencilKind.nine_pt
            if self.ndim == 2
            else StencilKind.twenty_seven_pt
        )


FivePt = StencilKind.five_pt
NinePt = StencilKind.nine_pt
SevenPt = StencilKind.seven_pt
TwentySevenPt = StencilKind.twenty_seven_pt


class Dir2:
    """2D symmetric stencil plane indices (reference: bmg2_dir, ko..knw).

    ``W(z, w)`` couples ``(z, w) ↔ (z-1, w)``; ``S(z, w)`` couples
    ``(z, w) ↔ (z, w-1)``; ``SW(z, w)`` couples ``(z, w) ↔ (z-1, w-1)``;
    ``NW(z, w)`` couples ``(z, w-1) ↔ (z-1, w)`` (the anti-diagonal of the
    cell whose upper-right corner is ``(z, w)``).
    """

    O = 0
    W = 1
    S = 2
    SW = 3  # nine_pt only
    NW = 4  # nine_pt only


class InterpDir2:
    """2D interpolation weight plane indices.

    Same semantics as the reference's CI array (LL..LSE,
    src/2d/ftn/BMG_stencils_f90.h) but with the low ghost trimmed: our
    ``CI[d, k, m]`` equals the reference's ``CI(k+1, m+1, d+1)``.

    Stored on a ``(nxc+1, nyc+1)`` grid (one extra high row/column holds the
    weights of fine points east/north of the last coarse point, which the
    reference keeps in its CI ghost ring).  With coarse point ``(k, m)``
    coincident with fine ``(2k, 2m)``:

    * ``LL/LR[k, m]``: weights of fine x-line point ``(2k-1, 2m)`` to its
      left ``(k-1, m)`` / right ``(k, m)`` coarse neighbors;
    * ``LA/LB[k, m]``: weights of fine y-line point ``(2k, 2m-1)`` to its
      above ``(k, m)`` / below ``(k, m-1)`` coarse neighbors;
    * ``LSW/LNW/LNE/LSE[k, m]``: weights of fine cell-center point
      ``(2k-1, 2m-1)`` to coarse ``(k-1, m-1)`` / ``(k-1, m)`` / ``(k, m)``
      / ``(k, m-1)``.

    Verified against the reference's restriction and interpolation loops
    (src/2d/ftn/BMG2_SymStd_restrict.f90:76-92,
    src/2d/ftn/BMG2_SymStd_interp_add.f90:111-137).
    """

    LL = 0
    LR = 1
    LA = 2
    LB = 3
    LSW = 4
    LNW = 5
    LNE = 6
    LSE = 7


class InterpDir3:
    """3D interpolation weight plane indices.

    Same semantics as the reference's 26-plane CI array (l* constants in
    src/3d/ftn/BMG_stencils_f90.h, 0-based here), with the low ghost trimmed:
    our ``CI[d, k, m, n]`` equals the reference's ``CI(k+1, m+1, n+1, d+1)``.
    Stored on an ``(nxc+1, nyc+1, nzc+1)`` grid (extra high entries hold the
    weights of fine points beyond the last coarse point, which the reference
    keeps in its CI ghost ring).

    Weight-plane semantics, written as the fine→coarse displacement δ the
    plane interpolates across (δ = coarse position − fine position, in fine
    index units; verified against BMG3_SymStd_restrict.f90:115-145):

    * x-edge points (odd x):    XYL δ=(-1,0,0), XYR δ=(+1,0,0)
    * y-edge points (odd y):    XYA δ=(0,+1,0), XYB δ=(0,-1,0)
    * z-edge points (odd z):    XZA δ=(0,0,+1), XZB δ=(0,0,-1)
    * xy-face centers:          XYNE δ=(+1,+1,0), XYSE δ=(+1,-1,0),
                                XYSW δ=(-1,-1,0), XYNW δ=(-1,+1,0)
    * xz-face centers:          XZSW δ=(-1,0,-1), XZNW δ=(-1,0,+1),
                                XZNE δ=(+1,0,+1), XZSE δ=(+1,0,-1)
    * yz-face centers:          YZSW δ=(0,+1,-1), YZNW δ=(0,+1,+1),
                                YZNE δ=(0,-1,+1), YZSE δ=(0,-1,-1)
    * cell centers (all odd):   BSW δ=(-1,-1,-1), BNW δ=(-1,+1,-1),
                                BNE δ=(+1,+1,-1), BSE δ=(+1,-1,-1),
                                TSW δ=(-1,-1,+1), TNW δ=(-1,+1,+1),
                                TNE δ=(+1,+1,+1), TSE δ=(+1,-1,+1)
    """

    XYL = 0
    XYR = 1
    XYA = 2
    XYB = 3
    XZA = 4
    XZB = 5
    XYNE = 6
    XYSE = 7
    XYSW = 8
    XYNW = 9
    XZSW = 10
    XZNW = 11
    XZNE = 12
    XZSE = 13
    YZSW = 14
    YZNW = 15
    YZNE = 16
    YZSE = 17
    BSW = 18
    BNW = 19
    BNE = 20
    BSE = 21
    TSW = 22
    TNW = 23
    TNE = 24
    TSE = 25


class Dir3:
    """3D symmetric stencil plane indices (reference: cdr3_dir, kp..kbsw).

    Order matches the reference (3d/base_types.h): p, pw, ps, b, psw, pnw,
    bw, bnw, bn, bne, be, bse, bs, bsw.  ``p*`` directions live in the same
    z-plane, ``b*`` couple to the plane below (w3 - 1).
    """

    P = 0
    PW = 1
    PS = 2
    B = 3
    PSW = 4
    PNW = 5
    BW = 6
    BNW = 7
    BN = 8
    BNE = 9
    BE = 10
    BSE = 11
    BS = 12
    BSW = 13
