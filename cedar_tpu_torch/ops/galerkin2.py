"""Galerkin (variational) coarse-operator product A_c = Pᵀ A P, 2D.

PyTorch counterpart of :mod:`cedar_tpu.ops.galerkin2`.  Non-periodic grids
take mod-3 comb-basis probing: the probes run through this package's
:func:`~cedar_tpu_torch.ops.interp2.interp_add`,
:func:`~cedar_tpu_torch.ops.interp2.restrict` and
:func:`~cedar_tpu_torch.ops.stencil2.matvec`, so on the card the setup goes
through the transfer kernels too.  Periodic grids take the explicit
two-stage product (:func:`coarsen_op_explicit`), in torch ops on both
devices, as the JAX package does.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.shift import coarse_sample, shift2
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops.interp2 import interp_add, pw_weights, restrict
from cedar_tpu_torch.ops.stencil2 import full_offsets, matvec


def coarsen_op(ci: torch.Tensor, so: torch.Tensor, kind: StencilKind,
               periodic=(False, False)) -> torch.Tensor:
    """Galerkin coarse stencil (always nine_pt) from fine stencil + CI;
    a batch of planes (``so`` ``(ndir, B, nx, ny)``, ``ci`` ``(8, B, …)``)
    gives ``(5, B, nxc, nyc)``.  Periodic grids take
    :func:`coarsen_op_explicit` (cedar_tpu/ops/galerkin2.py:33-46)."""
    if any(periodic):
        return coarsen_op_explicit(ci, so, kind, periodic)
    return coarsen_op_comb(ci, so, kind)


def coarsen_op_comb(ci: torch.Tensor, so: torch.Tensor,
                    kind: StencilKind) -> torch.Tensor:
    """A_c = Pᵀ A P by comb-basis probing: the 9 coarse-stencil offsets are
    distinct mod 3, so applying Pᵀ A P to the 9 mod-3 indicator combs
    recovers every row entry exactly."""
    nc = (ci.shape[-2] - 1, ci.shape[-1] - 1)
    nf = (so.shape[-2], so.shape[-1])
    batch = tuple(so.shape[1:-2])
    dev = so.device

    iz = (torch.arange(nc[0], device=dev) % 3)[:, None]
    iw = (torch.arange(nc[1], device=dev) % 3)[None, :]
    cls = iz * 3 + iw
    zf = so.new_zeros(batch + nf)  # the probes' residual: res/diag vanishes

    results = []
    for c in range(9):
        qc = (cls == c).to(so.dtype).expand(batch + nc).contiguous()
        # interp_add writes its q in place: a fresh zero q per probe
        xf = interp_add(ci, so, qc, zf, so.new_zeros(batch + nf))
        results.append(restrict(ci, matvec(so, xf, kind)))
    results = torch.stack(results)  # (9, *batch, *nc)

    def entry(di, dj):
        j = ((iz + di) % 3 * 3 + (iw + dj) % 3).expand(batch + nc)
        return torch.gather(results, 0, j[None])[0]

    o = entry(0, 0)
    w_ = -entry(-1, 0)
    s_ = -entry(0, -1)
    sw = -entry(-1, -1)
    # stored NW(a,b) couples (a,b-1) <-> (a-1,b): row-form (-1,+1) at (a,b-1)
    nw = -shift2(entry(-1, 1), 0, -1)
    return torch.stack([o, w_, s_, sw, nw])


def coarsen_op_explicit(ci: torch.Tensor, so: torch.Tensor,
                        kind: StencilKind,
                        periodic=(False, False)) -> torch.Tensor:
    """A_c = Pᵀ A P as the explicit two-stage shifted-window product (any
    boundary conditions; cedar_tpu/ops/galerkin2.py:94):

    1. ``AP[(p,q)](zc,wc) = Σ_(du,dv) A_full[2zc+p, 2wc+q, (du-p, dv-q)] ·
       PW[(du,dv)](zc,wc)``, the 5×5 fine patch of A·P around each coarse
       point;
    2. ``A_c[(di,dj)](zc,wc) = Σ_(p,q) PW[(p-2di, q-2dj)](zc+di, wc+dj) ·
       AP[(p,q)](zc,wc)``.
    """
    nc = (ci.shape[-2] - 1, ci.shape[-1] - 1)
    af = full_offsets(so, kind, periodic)   # (dz,dw) -> fine, true sign
    pw = pw_weights(ci)                      # (du,dv) -> coarse

    ap = {}
    for p in range(-2, 3):
        for q in range(-2, 3):
            acc = None
            for (du, dv), w in pw.items():
                off = (du - p, dv - q)
                if off not in af:
                    continue
                term = coarse_sample(af[off], (p, q), nc, periodic) * w
                acc = term if acc is None else acc + term
            if acc is not None:
                ap[(p, q)] = acc

    def ac_entry(di, dj):
        acc = None
        for (p, q), patch in ap.items():
            woff = (p - 2 * di, q - 2 * dj)
            if woff not in pw:
                continue
            term = shift2(pw[woff], di, dj, periodic) * patch
            acc = term if acc is None else acc + term
        return acc

    o = ac_entry(0, 0)
    w_ = -ac_entry(-1, 0)
    s_ = -ac_entry(0, -1)
    sw = -ac_entry(-1, -1)
    # stored NW(a,b) couples (a,b-1) <-> (a-1,b): row-form (-1,+1) at (a,b-1)
    nw = -shift2(ac_entry(-1, 1), 0, -1, periodic)
    return torch.stack([o, w_, s_, sw, nw])
