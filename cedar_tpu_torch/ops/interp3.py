"""3D operator-induced (BoxMG) interpolation: setup, apply, restrict.

PyTorch counterpart of :mod:`cedar_tpu.ops.interp3`:

* :func:`setup_interp` — BMG3_SymStd_SETUP_interp_OI.f90 as dense passes:
  edge points collapse onto their line, face points collapse the
  out-of-plane axis into 8 column sums and combine them with the edge
  weights around them, cell centres weigh each of the 8 coarse corners;
  every collapse carries the reference's indefiniteness guard.  The
  7-point branch is the 27-point math with zero corner/face couplings.
* :func:`restrict` — BMG3_SymStd_restrict.f90 (R = Pᵀ).
* :func:`interp_add` — BMG3_SymStd_interp_add.f90 (``Q += P·Qc`` at
  coincident points, ``Q += res/diag + P·Qc`` elsewhere).
* :func:`interp` — ``X = P·Qc``, the F-cycle's level entry
  (cedar_tpu/solver/cycle3.py:405-426).

:func:`restrict`, :func:`interp_add` and :func:`interp` dispatch by device
and ``kernels.backend`` (:mod:`cedar_tpu_torch.ops.backend`: under
``xla`` every tensor takes the plain version):
CUDA tensors go to the transfer kernels
(:mod:`cedar_tpu_torch.ops.cuda_transfer3`), CPU tensors to their plain
versions, which run :func:`restrict_torch`, :func:`interp_add_torch` and
:func:`interp_torch`.

Weight storage: 26 CI planes of shape ``(nxc+1, nyc+1, nzc+1)`` — see
:class:`cedar_tpu_torch.core.types.InterpDir3` for the plane/δ layout.

On a periodic axis (``periodic``) fine point -1 is fine point n-1: the
couplings wrap around, the weights at CI index 0 of the planes stored at odd
parity along that axis mirror the last ones (cedar_tpu/ops/interp3.py:
278-292; even extents are the standard periodic-coarsening compatibility,
and odd ones take the same mirror, as the JAX package does), the
restriction samples the fine grid with wrap-around (:func:`coarse_sample`),
and coarse index nxc (nyc, nzc) reads coarse index 0.
"""

from __future__ import annotations

import itertools

import torch

from cedar_tpu_torch.ops import backend
from cedar_tpu_torch.core.parity import (
    deinterleave3, interleave3, subgrid_sample_nd,
)
from cedar_tpu_torch.core.shift import coarse_sample, shift3
from cedar_tpu_torch.core.types import Dir3, InterpDir3 as L, StencilKind
from cedar_tpu_torch.ops.stencil3 import (
    NEIGHBOR_COUPLINGS_27, coupling, offsets_for,
)


def _gate(d, zeps):
    return torch.clamp(d, min=0.0) / (torch.abs(d) + zeps)


# CI plane -> fine->coarse displacement δ (see InterpDir3); the transfer
# kernels (csrc/transfer3.cu CEDAR_DELTA3) hold the same table.
DELTA = {
    L.XYL: (-1, 0, 0), L.XYR: (1, 0, 0),
    L.XYA: (0, 1, 0), L.XYB: (0, -1, 0),
    L.XZA: (0, 0, 1), L.XZB: (0, 0, -1),
    L.XYNE: (1, 1, 0), L.XYSE: (1, -1, 0),
    L.XYSW: (-1, -1, 0), L.XYNW: (-1, 1, 0),
    L.XZSW: (-1, 0, -1), L.XZNW: (-1, 0, 1),
    L.XZNE: (1, 0, 1), L.XZSE: (1, 0, -1),
    L.YZSW: (0, 1, -1), L.YZNW: (0, 1, 1),
    L.YZNE: (0, -1, 1), L.YZSE: (0, -1, -1),
    L.BSW: (-1, -1, -1), L.BNW: (-1, 1, -1),
    L.BNE: (1, 1, -1), L.BSE: (1, -1, -1),
    L.TSW: (-1, -1, 1), L.TNW: (-1, 1, 1),
    L.TNE: (1, 1, 1), L.TSE: (1, -1, 1),
}

# Per-coarse-point interpolation footprint: fine offset -> (plane, CI
# shift), off = -δ, shift = max(off, 0) per axis
# (BMG3_SymStd_restrict.f90:115-145).  Restriction sums in this order.
PW3_TABLE = {
    tuple(-d for d in delta): (plane, tuple(max(-d, 0) for d in delta))
    for plane, delta in DELTA.items()
}

_PLANE_OF = {delta: plane for plane, delta in DELTA.items()}

# fine-point parity classes other than the coincident one, in the
# reference's order
_CATEGORIES = [(1, 0, 0), (0, 1, 0), (0, 0, 1),
               (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1)]


def _category(delta) -> tuple:
    return tuple(1 if d else 0 for d in delta)


def setup_interp(so: torch.Tensor, kind: StencilKind,
                 periodic=(False, False, False)) -> torch.Tensor:
    """Build the 26-plane CI interpolation weights from the fine stencil."""
    P = so[Dir3.P]
    zeps = float(torch.finfo(so.dtype).eps)
    nx, ny, nz = so.shape[1], so.shape[2], so.shape[3]
    nxc = (nx - 1) // 2 + 1
    nyc = (ny - 1) // 2 + 1
    nzc = (nz - 1) // 2 + 1
    kx, my, lz = nx // 2, ny // 2, nz // 2

    present = set(offsets_for(kind))
    cpl = {off: (coupling(so, off, periodic) if off in present else None)
           for off in NEIGHBOR_COUPLINGS_27}

    def csum(offs):
        acc = None
        for off in offs:
            c = cpl[off]
            if c is None:
                continue
            acc = c if acc is None else acc + c
        return torch.zeros_like(P) if acc is None else acc

    def sh(arr, d0, d1, d2):
        return shift3(arr, d0, d1, d2, periodic)

    all_offs = list(NEIGHBOR_COUPLINGS_27.keys())

    # -- edge points: collapse onto the line through the two coarse
    #    neighbours (reference :127-232) ------------------------------------
    def edge(axis):
        a = csum([o for o in all_offs if o[axis] == -1])  # toward lower
        b = csum([o for o in all_offs if o[axis] == 1])   # toward upper
        lat = csum([o for o in all_offs if o[axis] == 0])
        ctot = a + b + lat
        ep = torch.minimum(torch.abs(a / P), torch.abs(b / P))
        den = a + b + (P - ctot) * _gate(P - (1.0 + ep) * ctot, zeps)
        return a / den, b / den  # (weight to lower, weight to upper)

    xyl_d, xyr_d = edge(0)
    xyb_d, xya_d = edge(1)
    xzb_d, xza_d = edge(2)

    # -- face points: collapse the out-of-plane axis into 8 column sums,
    #    combine with the surrounding edge weights (reference :234-383) -----
    def face(ax1, ax2, axc):
        """Column sums d[(e1, e2)] and the guarded inverse denominator."""
        d = {}
        for e1 in (-1, 0, 1):
            for e2 in (-1, 0, 1):
                if e1 == 0 and e2 == 0:
                    continue
                offs = []
                for e3 in (-1, 0, 1):
                    o = [0, 0, 0]
                    o[ax1], o[ax2], o[axc] = e1, e2, e3
                    offs.append(tuple(o))
                d[(e1, e2)] = csum(offs)
        dp = sum(d.values())
        sides = [
            d[(-1, -1)] + d[(-1, 0)] + d[(-1, 1)],
            d[(-1, 1)] + d[(0, 1)] + d[(1, 1)],
            d[(1, 1)] + d[(1, 0)] + d[(1, -1)],
            d[(1, -1)] + d[(0, -1)] + d[(-1, -1)],
        ]
        ep = None
        for s_ in sides:
            e = torch.abs(s_ / P)
            ep = e if ep is None else torch.minimum(ep, e)
        oc = [0, 0, 0]
        oc[axc] = 1
        out_lo = cpl[tuple(-c for c in oc)]
        out_hi = cpl[tuple(oc)]
        sumv = P
        if out_lo is not None:
            sumv = sumv - out_lo
        if out_hi is not None:
            sumv = sumv - out_hi
        den = dp + (sumv - dp) * _gate(sumv - (1.0 + ep) * dp, zeps)
        return d, 1.0 / den

    # xy faces (collapse z; reference :234-283)
    d, s = face(0, 1, 2)
    xynw_d = s * (d[(-1, 1)] + sh(xya_d, -1, 0, 0) * d[(-1, 0)]
                  + sh(xyl_d, 0, 1, 0) * d[(0, 1)])
    xyne_d = s * (d[(1, 1)] + sh(xyr_d, 0, 1, 0) * d[(0, 1)]
                  + sh(xya_d, 1, 0, 0) * d[(1, 0)])
    xyse_d = s * (d[(1, -1)] + sh(xyb_d, 1, 0, 0) * d[(1, 0)]
                  + sh(xyr_d, 0, -1, 0) * d[(0, -1)])
    xysw_d = s * (d[(-1, -1)] + sh(xyl_d, 0, -1, 0) * d[(0, -1)]
                  + sh(xyb_d, -1, 0, 0) * d[(-1, 0)])

    # xz faces (collapse y; reference :285-332; "north" = +z)
    d, s = face(0, 2, 1)
    xznw_d = s * (d[(-1, 1)] + sh(xza_d, -1, 0, 0) * d[(-1, 0)]
                  + sh(xyl_d, 0, 0, 1) * d[(0, 1)])
    xzne_d = s * (d[(1, 1)] + sh(xyr_d, 0, 0, 1) * d[(0, 1)]
                  + sh(xza_d, 1, 0, 0) * d[(1, 0)])
    xzse_d = s * (d[(1, -1)] + sh(xzb_d, 1, 0, 0) * d[(1, 0)]
                  + sh(xyr_d, 0, 0, -1) * d[(0, -1)])
    xzsw_d = s * (d[(-1, -1)] + sh(xyl_d, 0, 0, -1) * d[(0, -1)]
                  + sh(xzb_d, -1, 0, 0) * d[(-1, 0)])

    # yz faces (collapse x; reference :334-382; "west" = +y, "north" = +z)
    d, s = face(1, 2, 0)
    yznw_d = s * (d[(1, 1)] + sh(xza_d, 0, 1, 0) * d[(1, 0)]
                  + sh(xya_d, 0, 0, 1) * d[(0, 1)])
    yzne_d = s * (d[(-1, 1)] + sh(xyb_d, 0, 0, 1) * d[(0, 1)]
                  + sh(xza_d, 0, -1, 0) * d[(-1, 0)])
    yzse_d = s * (d[(-1, -1)] + sh(xzb_d, 0, -1, 0) * d[(-1, 0)]
                  + sh(xyb_d, 0, 0, -1) * d[(0, -1)])
    yzsw_d = s * (d[(1, -1)] + sh(xya_d, 0, 0, -1) * d[(0, -1)]
                  + sh(xzb_d, 0, 1, 0) * d[(1, 0)])
    del d, s

    # -- cell centres (reference :384-536) ---------------------------------
    total = csum(all_offs)
    ep = None
    for axis in range(3):
        for sgn in (-1, 1):
            fsum = csum([o for o in all_offs if o[axis] == sgn])
            e = torch.abs(fsum / P)
            ep = e if ep is None else torch.minimum(ep, e)
    s_c = 1.0 / (total + (P - total) * _gate(P - (1.0 + ep) * total, zeps))
    del total, ep

    fine_wt = {
        # category (which δ components are nonzero) -> weight array by δ
        (1, 0, 0): {(-1, 0, 0): xyl_d, (1, 0, 0): xyr_d},
        (0, 1, 0): {(0, 1, 0): xya_d, (0, -1, 0): xyb_d},
        (0, 0, 1): {(0, 0, 1): xza_d, (0, 0, -1): xzb_d},
        (1, 1, 0): {(1, 1, 0): xyne_d, (1, -1, 0): xyse_d,
                    (-1, -1, 0): xysw_d, (-1, 1, 0): xynw_d},
        (1, 0, 1): {(-1, 0, -1): xzsw_d, (-1, 0, 1): xznw_d,
                    (1, 0, 1): xzne_d, (1, 0, -1): xzse_d},
        (0, 1, 1): {(0, 1, -1): yzsw_d, (0, 1, 1): yznw_d,
                    (0, -1, 1): yzne_d, (0, -1, -1): yzse_d},
    }

    def corner(delta):
        """Weight of cell-centre G toward the coarse corner at G + δ."""
        acc = cpl[delta]
        acc = torch.zeros_like(P) if acc is None else acc
        # the 6 other vertices v = G + m⊙δ of the octant [G, G+δ]
        for m in itertools.product((0, 1), repeat=3):
            if m == (0, 0, 0) or m == (1, 1, 1):
                continue
            voff = tuple(mi * di for mi, di in zip(m, delta))
            c = cpl[voff]
            if c is None:
                continue
            vdelta = tuple((1 - mi) * di for mi, di in zip(m, delta))
            w = fine_wt[_category(vdelta)][vdelta]
            acc = acc + sh(w, *voff) * c
        return s_c * acc

    # -- gather the valid parities into CI ---------------------------------
    ci = so.new_zeros((26, nxc + 1, nyc + 1, nzc + 1))
    windows = {
        (1, 0, 0): (slice(1, 1 + kx), slice(0, nyc), slice(0, nzc)),
        (0, 1, 0): (slice(0, nxc), slice(1, 1 + my), slice(0, nzc)),
        (0, 0, 1): (slice(0, nxc), slice(0, nyc), slice(1, 1 + lz)),
        (1, 1, 0): (slice(1, 1 + kx), slice(1, 1 + my), slice(0, nzc)),
        (1, 0, 1): (slice(1, 1 + kx), slice(0, nyc), slice(1, 1 + lz)),
        (0, 1, 1): (slice(0, nxc), slice(1, 1 + my), slice(1, 1 + lz)),
        (1, 1, 1): (slice(1, 1 + kx), slice(1, 1 + my), slice(1, 1 + lz)),
    }

    def par(arr, cat):
        return arr[cat[0]::2, cat[1]::2, cat[2]::2]

    for cat, table in fine_wt.items():
        for delta, arr in table.items():
            ci[(_PLANE_OF[delta],) + windows[cat]] = par(arr, cat)
    # the corners one at a time: each is a fine-grid temporary
    for delta in itertools.product((-1, 1), repeat=3):
        ci[(_PLANE_OF[delta],) + windows[(1, 1, 1)]] = par(corner(delta),
                                                            (1, 1, 1))

    # periodic wrap: fine point -1 is n-1, so index 0 of the planes stored
    # at odd parity along a periodic axis mirrors the high entry (kx, my,
    # lz), axis by axis in the JAX package's order
    his = (kx, my, lz)
    for plane, delta in DELTA.items():
        for ax in range(3):
            if periodic[ax] and delta[ax]:
                lo = [slice(None)] * 3
                hi = [slice(None)] * 3
                lo[ax], hi[ax] = 0, his[ax]
                ci[(plane,) + tuple(lo)] = ci[(plane,) + tuple(hi)]
    return ci


def pw_weights(ci: torch.Tensor):
    """Per-coarse-point interpolation footprint: dict ``(du, dv, dw) ->
    (nxc, nyc, nzc)`` weight from coarse point c to fine point 2c + off
    (coincident weight identically 1)."""
    nxc, nyc, nzc = ci.shape[1] - 1, ci.shape[2] - 1, ci.shape[3] - 1
    out = {(0, 0, 0): ci.new_ones((nxc, nyc, nzc))}
    for off, (plane, sht) in PW3_TABLE.items():
        out[off] = ci[plane, sht[0]:sht[0] + nxc, sht[1]:sht[1] + nyc,
                      sht[2]:sht[2] + nzc]
    return out


def parity_sample(parts: dict, off, nc):
    """``q[2c + off]`` on the coarse grid, from fine parity subgrids."""
    p = tuple(o % 2 for o in off)
    sht = tuple((o - pi) // 2 for o, pi in zip(off, p))
    return subgrid_sample_nd(parts[p], sht, nc)


def restrict_torch(ci: torch.Tensor, q: torch.Tensor,
                   periodic=(False, False, False)) -> torch.Tensor:
    """``qc = Pᵀ q`` in torch ops, terms in :data:`PW3_TABLE` order; on
    periodic grids the fine samples wrap around."""
    nc = (ci.shape[1] - 1, ci.shape[2] - 1, ci.shape[3] - 1)
    pw = pw_weights(ci)
    if any(periodic):
        def sample(off):
            return coarse_sample(q, off, nc, periodic)
    else:
        parts = deinterleave3(q)

        def sample(off):
            return parity_sample(parts, off, nc)
    qc = sample((0, 0, 0))
    for off, wgt in pw.items():
        if off != (0, 0, 0):
            qc = qc + wgt * sample(off)
    return qc


def _interp_parts(ci, qc, fine_shape, r2p=None,
                  periodic=(False, False, False)) -> dict:
    """The parity parts of ``P qc`` on the fine grid; with ``r2p`` (the
    parity parts of res/diag) each fine-only class starts from it."""
    nx, ny, nz = fine_shape
    nxc, nyc, nzc = qc.shape
    kx, my, lz = nx // 2, ny // 2, nz // 2
    # index nc reads 0, or wraps to coarse index 0 (periodic), axis by axis
    qcp = torch.nn.functional.pad(qc, (0, 1, 0, 1, 0, 1))
    if periodic[0]:
        qcp[nxc] = qcp[0]
    if periodic[1]:
        qcp[:, nyc] = qcp[:, 0]
    if periodic[2]:
        qcp[:, :, nzc] = qcp[:, :, 0]
    # coarse-solution slices per axis by δ component, and weight slices by
    # the category's parity (reference interp_add.f90 loop bounds)
    csl = {
        0: {-1: slice(0, kx), 1: slice(1, 1 + kx), 0: slice(0, nxc)},
        1: {-1: slice(0, my), 1: slice(1, 1 + my), 0: slice(0, nyc)},
        2: {-1: slice(0, lz), 1: slice(1, 1 + lz), 0: slice(0, nzc)},
    }
    wsl = {
        0: {1: slice(1, 1 + kx), 0: slice(0, nxc)},
        1: {1: slice(1, 1 + my), 0: slice(0, nyc)},
        2: {1: slice(1, 1 + lz), 0: slice(0, nzc)},
    }
    parts = {(0, 0, 0): qc}
    for cat in _CATEGORIES:
        wwin = tuple(wsl[ax][cat[ax]] for ax in range(3))
        acc = None if r2p is None else r2p[cat]
        for plane, delta in DELTA.items():
            if _category(delta) != cat:
                continue
            qsl = tuple(csl[ax][delta[ax]] for ax in range(3))
            term = ci[(plane,) + wwin] * qcp[qsl]
            acc = term if acc is None else acc + term
        parts[cat] = acc
    return parts


def interp_add_torch(ci, so, qc, res, q,
                     periodic=(False, False, False)) -> torch.Tensor:
    """``q + P qc (+ res/diag at fine-only points)`` in torch ops; returns a
    new tensor."""
    r2p = deinterleave3(res / so[Dir3.P])
    return q + interleave3(_interp_parts(ci, qc, q.shape, r2p, periodic),
                           *q.shape)


def interp_torch(ci, qc, fine_shape,
                 periodic=(False, False, False)) -> torch.Tensor:
    """``P qc`` on the fine grid in torch ops (the F-cycle's level entry:
    :func:`interp_add_torch` with zero residual and zero addend, to the
    sign of a zero); returns a new tensor."""
    return interleave3(_interp_parts(ci, qc, fine_shape, periodic=periodic),
                       *fine_shape)


def restrict(ci: torch.Tensor, q: torch.Tensor,
             periodic=(False, False, False)) -> torch.Tensor:
    """``qc = Pᵀ q`` (reference: BMG3_SymStd_restrict.f90:115-145)."""
    from cedar_tpu_torch.ops import cuda_transfer3

    if backend.kernels(q, "restrict"):
        return cuda_transfer3.restrict(ci, q, periodic)
    return cuda_transfer3.restrict_plain(ci, q, periodic)


def interp_add(ci, so, qc, res, q,
               periodic=(False, False, False)) -> torch.Tensor:
    """``q += P qc  (+ res/diag at fine-only points)``, IN PLACE on ``q``.

    Reference: BMG3_SymStd_interp_add.f90:88-242.  ``res`` is the residual
    computed before restriction, divided by the FINE diagonal.  Returns
    ``q``; callers that still need the incoming ``q`` clone it first.
    """
    from cedar_tpu_torch.ops import cuda_transfer3

    if backend.kernels(q, "interp_add"):
        return cuda_transfer3.interp_add(ci, so, qc, res, q, periodic)
    return cuda_transfer3.interp_add_plain(ci, so, qc, res, q, periodic)


def interp(ci: torch.Tensor, qc: torch.Tensor, fine_shape,
           periodic=(False, False, False)) -> torch.Tensor:
    """``x = P qc``, a new fine-grid tensor of ``fine_shape``: the F-cycle's
    level entry (reference: fcycle.h:66-72)."""
    from cedar_tpu_torch.ops import cuda_transfer3

    if backend.kernels(qc, "interp"):
        return cuda_transfer3.interp(ci, qc, fine_shape, periodic)
    return cuda_transfer3.interp_plain(ci, qc, fine_shape, periodic)
