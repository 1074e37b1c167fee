"""2D operator-induced (BoxMG) interpolation: setup, apply, restrict.

PyTorch counterpart of :mod:`cedar_tpu.ops.interp2`:

* :func:`setup_interp` — BMG2_SymStd_SETUP_interp_OI.f90:105-256, with the
  indefiniteness guard ``SUM + (c-SUM)·max(c-(1+EP)SUM,0)/(|c-(1+EP)SUM|+ZEPS)``.
* :func:`restrict` — BMG2_SymStd_restrict.f90:76-92 (R = Pᵀ).
* :func:`interp_add` — BMG2_SymStd_interp_add.f90:101-137
  (``Q += P·Qc`` at coincident points, ``Q += P·Qc + res/diag`` elsewhere).
* :func:`interp` — ``X = P·Qc``, the F-cycle's level entry (fcycle.h:66-72).

:func:`restrict`, :func:`interp_add` and :func:`interp` dispatch by device
and ``kernels.backend`` (:mod:`cedar_tpu_torch.ops.backend`: under
``xla`` every tensor takes the plain version):
CUDA tensors go to the transfer kernels
(:mod:`cedar_tpu_torch.ops.cuda_transfer2`), CPU tensors to their plain
versions, which run :func:`restrict_torch`, :func:`interp_add_torch` and
:func:`interp_torch`.

Weight storage: CI planes of shape ``(nxc+1, nyc+1)`` — see
:class:`cedar_tpu_torch.core.types.InterpDir2`.

On a periodic axis (``periodic``) fine point -1 is fine point nx-1: the
weights at CI index 0 mirror the last ones (even extents, the standard
periodic-coarsening compatibility; cedar_tpu/ops/interp2.py:162-171), the
restriction samples the fine grid with wrap-around, and coarse index nxc
(nyc) reads coarse index 0.

Every function also takes a batch of independent planes (plane
relaxation's embedded 2D hierarchies): grid arrays ``(B, nx, ny)``, the
stencil ``(ndir, B, nx, ny)`` and CI ``(8, B, nxc+1, nyc+1)``, the batch
axis after the direction axis.  An unbatched call computes exactly what it
did before.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.ops import backend
from cedar_tpu_torch.core.parity import (
    deinterleave2, interleave2, subgrid_sample,
)
from cedar_tpu_torch.core.shift import coarse_sample, shift2
from cedar_tpu_torch.core.types import Dir2, InterpDir2 as L, StencilKind


def _guarded_den(c, a, b, sum0, zeps):
    """The BoxMG indefiniteness-guarded collapse denominator
    ``A + B + (c - SUM)·gate`` (SETUP_interp_OI.f90:116-126)."""
    ep = torch.minimum(torch.abs(a / c), torch.abs(b / c))
    d = c - (1.0 + ep) * sum0
    gate = torch.clamp(d, min=0.0) / (torch.abs(d) + zeps)
    return a + b + (c - sum0) * gate


def _guarded_den_corner(c, sum0, groups, zeps):
    """Corner variant: ``SUM + (c-SUM)·gate``, EP over the 4 group sums."""
    ep = None
    for g in groups:
        e = torch.abs(g / c)
        ep = e if ep is None else torch.minimum(ep, e)
    d = c - (1.0 + ep) * sum0
    gate = torch.clamp(d, min=0.0) / (torch.abs(d) + zeps)
    return sum0 + (c - sum0) * gate


def setup_interp(so: torch.Tensor, kind: StencilKind,
                 periodic=(False, False)) -> torch.Tensor:
    """Build the 8-plane CI interpolation weights from the fine stencil."""
    O, W, S = so[Dir2.O], so[Dir2.W], so[Dir2.S]
    nine = kind != StencilKind.five_pt
    if nine:
        SW, NW = so[Dir2.SW], so[Dir2.NW]
    zeps = float(torch.finfo(so.dtype).eps)

    def sh(p, dz, dw):
        return shift2(p, dz, dw, periodic)

    nx, ny = so.shape[-2], so.shape[-1]
    nxc = (nx - 1) // 2 + 1
    nyc = (ny - 1) // 2 + 1

    # --- x-line fine points (z odd, w even): collapse E/W ------------------
    if nine:
        a_x = sh(W, 1, 0) + sh(NW, 1, 0) + sh(SW, 1, 1)  # east couplings
        b_x = W + SW + sh(NW, 0, 1)                      # west couplings
    else:
        a_x = sh(W, 1, 0)
        b_x = W
    sum_x = a_x + b_x + S + sh(S, 0, 1)
    den_x = _guarded_den(O, a_x, b_x, sum_x, zeps)
    lr_d = a_x / den_x
    ll_d = b_x / den_x

    # --- y-line fine points (z even, w odd): collapse N/S ------------------
    if nine:
        a_y = sh(S, 0, 1) + sh(NW, 0, 1) + sh(SW, 1, 1)  # north couplings
        b_y = S + SW + sh(NW, 1, 0)                      # south couplings
    else:
        a_y = sh(S, 0, 1)
        b_y = S
    sum_y = a_y + b_y + W + sh(W, 1, 0)
    den_y = _guarded_den(O, a_y, b_y, sum_y, zeps)
    la_d = a_y / den_y
    lb_d = b_y / den_y

    # --- cell-center fine points (z odd, w odd) ----------------------------
    # group sums enter only EP's min; the collapse SUM counts each of the 8
    # couplings once (SETUP_interp_OI.f90:152-154)
    g_w = W + (SW + sh(NW, 0, 1) if nine else 0.0)
    g_n = sh(S, 0, 1) + (sh(NW, 0, 1) + sh(SW, 1, 1) if nine else 0.0)
    g_e = sh(W, 1, 0) + (sh(SW, 1, 1) + sh(NW, 1, 0) if nine else 0.0)
    g_s = S + (SW + sh(NW, 1, 0) if nine else 0.0)
    sum_c = W + sh(W, 1, 0) + S + sh(S, 0, 1)
    if nine:
        sum_c = sum_c + SW + sh(SW, 1, 1) + sh(NW, 0, 1) + sh(NW, 1, 0)
    den_c = _guarded_den_corner(O, sum_c, (g_w, g_n, g_e, g_s), zeps)
    s_c = 1.0 / den_c

    # corner weights reuse the edge weights of the four surrounding line
    # points (SETUP_interp_OI.f90:168-179)
    ll_s = sh(ll_d, 0, -1)
    lr_s = sh(lr_d, 0, -1)
    ll_n = sh(ll_d, 0, 1)
    lr_n = sh(lr_d, 0, 1)
    lb_w = sh(lb_d, -1, 0)
    la_w = sh(la_d, -1, 0)
    lb_e = sh(lb_d, 1, 0)
    la_e = sh(la_d, 1, 0)
    E = sh(W, 1, 0)
    N = sh(S, 0, 1)
    if nine:
        lsw_d = (S * ll_s + W * lb_w + SW) * s_c
        lse_d = (S * lr_s + E * lb_e + sh(NW, 1, 0)) * s_c
        lnw_d = (W * la_w + N * ll_n + sh(NW, 0, 1)) * s_c
        lne_d = (N * lr_n + E * la_e + sh(SW, 1, 1)) * s_c
    else:
        lsw_d = (S * ll_s + W * lb_w) * s_c
        lse_d = (S * lr_s + E * lb_e) * s_c
        lnw_d = (W * la_w + N * ll_n) * s_c
        lne_d = (N * lr_n + E * la_e) * s_c

    # --- gather the valid parities into CI ---------------------------------
    ci = so.new_zeros((8,) + tuple(so.shape[1:-2]) + (nxc + 1, nyc + 1))
    kx = nx // 2   # number of x-line points per coarse row
    my = ny // 2   # number of y-line points per coarse column
    ci[L.LL, ..., 1:1 + kx, 0:nyc] = ll_d[..., 1::2, 0::2]
    ci[L.LR, ..., 1:1 + kx, 0:nyc] = lr_d[..., 1::2, 0::2]
    ci[L.LA, ..., 0:nxc, 1:1 + my] = la_d[..., 0::2, 1::2]
    ci[L.LB, ..., 0:nxc, 1:1 + my] = lb_d[..., 0::2, 1::2]
    ci[L.LSW, ..., 1:1 + kx, 1:1 + my] = lsw_d[..., 1::2, 1::2]
    ci[L.LSE, ..., 1:1 + kx, 1:1 + my] = lse_d[..., 1::2, 1::2]
    ci[L.LNW, ..., 1:1 + kx, 1:1 + my] = lnw_d[..., 1::2, 1::2]
    ci[L.LNE, ..., 1:1 + kx, 1:1 + my] = lne_d[..., 1::2, 1::2]

    # periodic wrap: fine point -1 is nx-1, so index 0 of the planes stored
    # at odd x-parity mirrors the high entry kx; likewise in y
    if periodic[0]:
        for p in (L.LL, L.LR, L.LSW, L.LNW, L.LNE, L.LSE):
            ci[p, ..., 0, :] = ci[p, ..., kx, :]
    if periodic[1]:
        for p in (L.LA, L.LB, L.LSW, L.LNW, L.LNE, L.LSE):
            ci[p, ..., :, 0] = ci[p, ..., :, my]
    return ci


# Restriction weights around coarse point (zc, wc): the fine neighbor at
# offset (du, dv) contributes with the CI plane and CI slice offset below
# (BMG2_SymStd_restrict.f90:82-90).
#   (du, dv) -> (plane, kshift, mshift): weight = CI[plane][zc+kshift, wc+mshift]
PW_TABLE = {
    (-1, 0): (L.LR, 0, 0),
    (1, 0): (L.LL, 1, 0),
    (0, -1): (L.LA, 0, 0),
    (0, 1): (L.LB, 0, 1),
    (-1, -1): (L.LNE, 0, 0),
    (1, -1): (L.LNW, 1, 0),
    (-1, 1): (L.LSE, 0, 1),
    (1, 1): (L.LSW, 1, 1),
}


def pw_weights(ci: torch.Tensor):
    """Per-coarse-point interpolation footprint: dict ``(du, dv) -> (nxc,
    nyc)`` weight from coarse ``(zc, wc)`` to fine ``(2zc+du, 2wc+dv)``
    (coincident weight identically 1)."""
    nxc = ci.shape[-2] - 1
    nyc = ci.shape[-1] - 1
    out = {(0, 0): ci.new_ones(tuple(ci.shape[1:-2]) + (nxc, nyc))}
    for off, (plane, ks, ms) in PW_TABLE.items():
        out[off] = ci[plane, ..., ks:ks + nxc, ms:ms + nyc]
    return out


def parity_sample(parts: dict, du: int, dv: int, nc):
    """``q[2zc+du, 2wc+dv]`` on the coarse grid, from parity subgrids."""
    pz, pw_ = du % 2, dv % 2
    return subgrid_sample(parts[(pz, pw_)], (du - pz) // 2, (dv - pw_) // 2,
                          nc)


def restrict_torch(ci: torch.Tensor, q: torch.Tensor,
                   periodic=(False, False)) -> torch.Tensor:
    """``qc = Pᵀ q`` in torch ops, terms in :data:`PW_TABLE` order; on
    periodic grids the fine samples wrap around."""
    nc = (ci.shape[-2] - 1, ci.shape[-1] - 1)
    pw = pw_weights(ci)
    if any(periodic):
        def sample(du, dv):
            return coarse_sample(q, (du, dv), nc, periodic)
    else:
        parts = deinterleave2(q)

        def sample(du, dv):
            return parity_sample(parts, du, dv, nc)
    qc = sample(0, 0)
    for off, wgt in pw.items():
        if off != (0, 0):
            qc = qc + wgt * sample(*off)
    return qc


def _interp_parts(ci, qc, nx: int, ny: int, r2p=None,
                  periodic=(False, False)) -> dict:
    """The parity parts of ``P qc`` on the fine grid (plus ``r2p``, the
    parity parts of res/diag, at the fine-only points when given)."""
    nxc, nyc = qc.shape[-2:]
    kx = nx // 2
    my = ny // 2
    # index nxc/nyc reads 0, or wraps to coarse index 0 (periodic)
    qcp = torch.nn.functional.pad(qc, (0, 1, 0, 1))
    if periodic[0]:
        qcp[..., nxc, :] = qcp[..., 0, :]
    if periodic[1]:
        qcp[..., :, nyc] = qcp[..., :, 0]

    def plus_res(part, key):
        return part if r2p is None else part + r2p[key]

    parts = {(0, 0): qc}
    # x-line points (2k-1, 2m), k in 1..kx, m in 0..nyc-1
    parts[(1, 0)] = plus_res(
        ci[L.LR, ..., 1:1 + kx, 0:nyc] * qcp[..., 1:1 + kx, 0:nyc]
        + ci[L.LL, ..., 1:1 + kx, 0:nyc] * qcp[..., 0:kx, 0:nyc], (1, 0))
    # y-line points (2k, 2m-1), k in 0..nxc-1, m in 1..my
    parts[(0, 1)] = plus_res(
        ci[L.LA, ..., 0:nxc, 1:1 + my] * qcp[..., 0:nxc, 1:1 + my]
        + ci[L.LB, ..., 0:nxc, 1:1 + my] * qcp[..., 0:nxc, 0:my], (0, 1))
    # cell centers (2k-1, 2m-1), k in 1..kx, m in 1..my
    parts[(1, 1)] = plus_res(
        ci[L.LSW, ..., 1:1 + kx, 1:1 + my] * qcp[..., 0:kx, 0:my]
        + ci[L.LNW, ..., 1:1 + kx, 1:1 + my] * qcp[..., 0:kx, 1:1 + my]
        + ci[L.LNE, ..., 1:1 + kx, 1:1 + my] * qcp[..., 1:1 + kx, 1:1 + my]
        + ci[L.LSE, ..., 1:1 + kx, 1:1 + my] * qcp[..., 1:1 + kx, 0:my],
        (1, 1))
    return parts


def interp_add_torch(ci, so, qc, res, q,
                     periodic=(False, False)) -> torch.Tensor:
    """``q + P qc (+ res/diag at fine-only points)`` in torch ops; returns a
    new tensor."""
    nx, ny = q.shape[-2:]
    r2p = deinterleave2(res / so[Dir2.O])
    return q + interleave2(_interp_parts(ci, qc, nx, ny, r2p, periodic),
                           nx, ny)


def interp_torch(ci, qc, fine_shape, periodic=(False, False)) -> torch.Tensor:
    """``P qc`` on the fine grid in torch ops (the F-cycle's level entry:
    :func:`interp_add_torch` with zero residual and zero addend, exactly;
    ``fine_shape`` ``(nx, ny)`` or a batch ``(B, nx, ny)``); returns a new
    tensor."""
    nx, ny = fine_shape[-2:]
    return interleave2(_interp_parts(ci, qc, nx, ny, periodic=periodic),
                       nx, ny)


def restrict(ci: torch.Tensor, q: torch.Tensor,
             periodic=(False, False)) -> torch.Tensor:
    """``qc = Pᵀ q`` (reference: BMG2_SymStd_restrict.f90:76-92)."""
    from cedar_tpu_torch.ops import cuda_transfer2

    if backend.kernels(q, "restrict"):
        return cuda_transfer2.restrict(ci, q, periodic)
    return cuda_transfer2.restrict_plain(ci, q, periodic)


def interp_add(ci, so, qc, res, q, periodic=(False, False)) -> torch.Tensor:
    """``q += P qc  (+ res/diag at fine-only points)``, IN PLACE on ``q``.

    Reference: BMG2_SymStd_interp_add.f90:101-137.  ``res`` is the residual
    computed before restriction, divided by the FINE diagonal.  Returns
    ``q``; callers that still need the incoming ``q`` clone it first.
    """
    from cedar_tpu_torch.ops import cuda_transfer2

    if backend.kernels(q, "interp_add"):
        return cuda_transfer2.interp_add(ci, so, qc, res, q, periodic)
    return cuda_transfer2.interp_add_plain(ci, so, qc, res, q, periodic)


def interp(ci: torch.Tensor, qc: torch.Tensor, fine_shape,
           periodic=(False, False)) -> torch.Tensor:
    """``x = P qc``, a new fine-grid tensor of ``fine_shape``: the F-cycle's
    level entry (reference: fcycle.h:66-72)."""
    from cedar_tpu_torch.ops import cuda_transfer2

    if backend.kernels(qc, "interp"):
        return cuda_transfer2.interp(ci, qc, fine_shape, periodic)
    return cuda_transfer2.interp_plain(ci, qc, fine_shape, periodic)
