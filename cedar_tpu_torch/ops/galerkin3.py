"""Galerkin (variational) coarse-operator product A_c = Pᵀ A P, 3D.

PyTorch counterpart of :mod:`cedar_tpu.ops.galerkin3`.  Non-periodic grids
take mod-3 comb-basis probing: the probes run through this package's
:func:`~cedar_tpu_torch.ops.interp3.interp_add`,
:func:`~cedar_tpu_torch.ops.interp3.restrict` and
:func:`~cedar_tpu_torch.ops.stencil3.matvec`, so on the card the setup goes
through the transfer kernels too.  Periodic grids take the explicit
two-stage product (:func:`coarsen_op_explicit`), in torch ops on both
devices, as the JAX package does (mod-3 combs misalign under wrap-around
unless the extents divide by 3).
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.shift import coarse_sample, shift3
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops.interp3 import interp_add, pw_weights, restrict
from cedar_tpu_torch.ops.stencil3 import (
    NEIGHBOR_COUPLINGS_27, full_offsets, matvec,
)


def coarsen_op(ci: torch.Tensor, so: torch.Tensor, kind: StencilKind,
               periodic=(False, False, False)) -> torch.Tensor:
    """Galerkin coarse stencil (always 27-point) from fine stencil + CI.
    Periodic grids take :func:`coarsen_op_explicit`
    (cedar_tpu/ops/galerkin3.py:30-46)."""
    if any(periodic):
        return coarsen_op_explicit(ci, so, kind, periodic)
    return coarsen_op_comb(ci, so, kind)


def _canonical_planes():
    """Stored plane -> (row-form offset, plane shift) with the smallest
    shift: the offset whose coupling the plane stores at the row point."""
    canonical = {}
    for off, (plane, sht) in NEIGHBOR_COUPLINGS_27.items():
        if plane not in canonical or sum(sht) < sum(canonical[plane][1]):
            canonical[plane] = (off, sht)
    return canonical


def coarsen_op_comb(ci: torch.Tensor, so: torch.Tensor,
                    kind: StencilKind) -> torch.Tensor:
    """A_c = Pᵀ A P by comb-basis probing: the 27 coarse-stencil offsets
    are distinct mod 3, so applying Pᵀ A P to the 27 mod-3 indicator combs
    recovers every row entry exactly.  The probes run one after another,
    so only one fine-grid probe is live at a time."""
    nc = (ci.shape[1] - 1, ci.shape[2] - 1, ci.shape[3] - 1)
    nf = tuple(so.shape[1:])
    dev = so.device

    iz = (torch.arange(nc[0], device=dev) % 3)[:, None, None]
    iw = (torch.arange(nc[1], device=dev) % 3)[None, :, None]
    iv = (torch.arange(nc[2], device=dev) % 3)[None, None, :]
    cls = iz * 9 + iw * 3 + iv
    zf = so.new_zeros(nf)  # the probes' residual: res/diag vanishes

    results = []
    for c in range(27):
        qc = (cls == c).to(so.dtype)
        # interp_add writes its q in place: a fresh zero q per probe
        xf = interp_add(ci, so, qc, zf, so.new_zeros(nf))
        results.append(restrict(ci, matvec(so, xf, kind)))
        del xf
    results = torch.stack(results)  # (27, *nc)

    def entry(delta):
        j = ((iz + delta[0]) % 3 * 9 + (iw + delta[1]) % 3 * 3
             + (iv + delta[2]) % 3).expand(nc)
        return torch.gather(results, 0, j[None])[0]

    canonical = _canonical_planes()
    planes = [entry((0, 0, 0))]
    for plane in range(1, 14):
        off, sht = canonical[plane]
        ent = -entry(off)
        if any(sht):
            ent = shift3(ent, -sht[0], -sht[1], -sht[2])
        planes.append(ent)
    return torch.stack(planes)


def coarsen_op_explicit(ci: torch.Tensor, so: torch.Tensor,
                        kind: StencilKind,
                        periodic=(False, False, False)) -> torch.Tensor:
    """A_c = Pᵀ A P as the explicit two-stage shifted-window product (any
    boundary conditions; cedar_tpu/ops/galerkin3.py:119-179):

    1. ``AP[(p,q,r)](c) = Σ_off A_full[2c+(p,q,r), off-(p,q,r)] ·
       PW[off](c)``, the 5×5×5 fine patch of A·P around each coarse point;
    2. ``A_c[δ](c) = Σ_(p,q,r) PW[(p,q,r)-2δ](c+δ) · AP[(p,q,r)](c)``,

    stored in the reference's 14-plane symmetric convention.  The fine
    samples wrap around the periodic axes (:func:`coarse_sample`)."""
    nc = (ci.shape[1] - 1, ci.shape[2] - 1, ci.shape[3] - 1)
    af = full_offsets(so, kind, periodic)  # off -> fine, true sign
    pw = pw_weights(ci)                    # off -> coarse

    ap = {}
    for p in range(-2, 3):
        for q in range(-2, 3):
            for r in range(-2, 3):
                acc = None
                for (du, dv, dw), w in pw.items():
                    off = (du - p, dv - q, dw - r)
                    if off not in af:
                        continue
                    term = coarse_sample(af[off], (p, q, r), nc,
                                         periodic) * w
                    acc = term if acc is None else acc + term
                if acc is not None:
                    ap[(p, q, r)] = acc

    def ac_entry(di, dj, dk):
        acc = None
        for (p, q, r), patch in ap.items():
            woff = (p - 2 * di, q - 2 * dj, r - 2 * dk)
            if woff not in pw:
                continue
            term = shift3(pw[woff], di, dj, dk, periodic) * patch
            acc = term if acc is None else acc + term
        return acc

    canonical = _canonical_planes()
    planes = [ac_entry(0, 0, 0)]
    for plane in range(1, 14):
        off, sht = canonical[plane]
        ent = -ac_entry(*off)
        if any(sht):
            ent = shift3(ent, -sht[0], -sht[1], -sht[2], periodic)
        planes.append(ent)
    return torch.stack(planes)
