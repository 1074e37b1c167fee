"""The fused fine-level ops of the 2D V-cycle: sweep (+ residual or norm
partials), sweep + residual + restriction, interp-add + sweep.

PyTorch counterpart of :func:`cedar_tpu.ops.pallas2_split.point_relax_split`
and of the fused half of :mod:`cedar_tpu.ops.pallas_transfer2`
(``sweep_restrict_split``, ``interp_sweep_split``, ``interp_add_split``),
under the JAX names so that a reader finds the counterpart.  "split" is the
JAX package's name only: it stores the fine level lane-parity split
because Mosaic cannot reshape lanes in a kernel.  These functions compute
the same values on the dense ``(nx, ny)`` grid, non-periodic, one plane.

Each function dispatches by device and backend, as
:func:`relax2.point_relax` does:
CUDA tensors go to the fused kernels (:mod:`cedar_tpu_torch.ops.cuda_fused2`:
K11-K13; K3 for :func:`interp_add_split`), CPU tensors to the plain
versions below, which compose the plain versions of the dense ops
(:func:`relax2.sweep_torch`, :func:`stencil2.residual`,
:func:`interp2.restrict_torch`, :func:`interp2.interp_add_torch`).

Unlike interp-add, :func:`point_relax_split`, :func:`sweep_restrict_split`
and :func:`interp_sweep_split` leave ``q`` alone and return a new iterate
(the kernels read ``q`` over a halo that other blocks would be writing).  ``partials`` is a 1-D tensor whose sum is
``‖b − A q_new‖²``: one partial sum per kernel block on the card, a single
element in the plain version.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.ops import backend
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import interp2
from cedar_tpu_torch.ops.relax2 import sweep_torch
from cedar_tpu_torch.ops.stencil2 import residual


def _norm_partials(res: torch.Tensor) -> torch.Tensor:
    """``‖res‖²`` as a one-element partials tensor."""
    return torch.sum(res * res).reshape(1)


def _epilogue(so, q, b, kind: StencilKind, fuse_residual: bool,
              fuse_norm: bool):
    if fuse_norm:
        return q, _norm_partials(residual(so, q, b, kind))
    if fuse_residual:
        return q, residual(so, q, b, kind)
    return q


def sweep_split_torch(so, q, b, kind: StencilKind, updown: str,
                      fuse_residual: bool = False, origin=(0, 0),
                      fuse_norm: bool = False):
    """:func:`point_relax_split` in torch ops; returns new tensors."""
    return _epilogue(so, sweep_torch(so, q, b, None, kind, updown,
                                     origin=origin),
                     b, kind, fuse_residual, fuse_norm)


def sweep_restrict_torch(so, q, b, ci_c, kind: StencilKind, updown: str,
                         emit_res: bool = True):
    """:func:`sweep_restrict_split` in torch ops; returns new tensors."""
    q, res = sweep_torch(so, q, b, None, kind, updown, fuse_residual=True)
    return q, (res if emit_res else None), interp2.restrict_torch(ci_c, res)


def interp_sweep_torch(ci_c, qc, so, b, q_pre, kind: StencilKind,
                       updown: str, fuse_residual: bool = False,
                       fuse_norm: bool = False):
    """:func:`interp_sweep_split` in torch ops; returns new tensors."""
    res = residual(so, q_pre, b, kind)
    q = interp2.interp_add_torch(ci_c, so, qc, res, q_pre)
    return _epilogue(so, sweep_torch(so, q, b, None, kind, updown), b, kind,
                     fuse_residual, fuse_norm)


def point_relax_split(so, q, b, kind: StencilKind, updown: str,
                      fuse_residual: bool = False, origin=(0, 0),
                      fuse_norm: bool = False):
    """One whole multicolour GS sweep (kernel K11 on the card).

    Counterpart of ``cedar_tpu.ops.pallas2_split.point_relax_split``, on
    the dense ``(nx, ny)`` grid.  Returns the new iterate ``q_new`` (``q``
    is not modified); with ``fuse_residual`` ``(q_new, b - A q_new)``; with
    ``fuse_norm`` ``(q_new, partials)``, the residual never stored.
    Colours anchor to ``(z + origin[0], w + origin[1])``."""
    from cedar_tpu_torch.ops import cuda_fused2

    if backend.kernels(q, "point_relax_split"):
        return cuda_fused2.sweep(so, q, b, kind, updown, fuse_residual,
                                 origin, fuse_norm)
    return cuda_fused2.sweep_plain(so, q, b, kind, updown, fuse_residual,
                                   origin, fuse_norm)


def sweep_restrict_split(so, q, b, ci_c, kind: StencilKind, updown: str,
                         emit_res: bool = True):
    """The last pre-sweep, its residual and the coarse rhs in one pass
    (kernel K12 on the card).

    Counterpart of ``cedar_tpu.ops.pallas_transfer2.sweep_restrict_split``,
    on the dense ``(nx, ny)`` grid; ``ci_c`` is the coarse level's CI.
    Returns ``(q_new, res, cb)``, ``res`` None unless ``emit_res``: the
    sweep with ``fuse_residual``, then ``cb = Pᵀ res``.  ``q`` is not
    modified."""
    from cedar_tpu_torch.ops import cuda_fused2

    if backend.kernels(q, "sweep_restrict_split"):
        return cuda_fused2.sweep_restrict(so, q, b, ci_c, kind, updown,
                                          emit_res)
    return cuda_fused2.sweep_restrict_plain(so, q, b, ci_c, kind, updown,
                                            emit_res)


def interp_sweep_split(ci_c, qc, so, b, q_pre, kind: StencilKind,
                       updown: str, fuse_residual: bool = False,
                       fuse_norm: bool = False):
    """Interp-add, then the first post-sweep, in one pass (kernel K13 on the
    card).

    Counterpart of ``cedar_tpu.ops.pallas_transfer2.interp_sweep_split``,
    on the dense ``(nx, ny)`` grid.  ``q_pre`` must be the pre-smoothed
    iterate whose residual was restricted (the cycle's invariant): the
    residual ``b - A q_pre`` is recomputed, then ``q = q_pre + P qc +
    res/diag`` (:func:`interp2.interp_add`'s expression) and one sweep.
    Returns ``q_new`` (plus ``b - A q_new`` with ``fuse_residual``, or the
    partials with ``fuse_norm``); ``q_pre`` is not modified."""
    from cedar_tpu_torch.ops import cuda_fused2

    if backend.kernels(q_pre, "interp_sweep_split"):
        return cuda_fused2.interp_sweep(ci_c, qc, so, b, q_pre, kind, updown,
                                        fuse_residual, fuse_norm)
    return cuda_fused2.interp_sweep_plain(ci_c, qc, so, b, q_pre, kind,
                                          updown, fuse_residual, fuse_norm)


def interp_add_split(ci_c, so, qc, res, q):
    """``q += P qc + res/diag``, IN PLACE on ``q``; returns ``q``.

    Counterpart of ``cedar_tpu.ops.pallas_transfer2.interp_add_split``
    (the cycle's branch without post-sweeps).  In the dense layout it is
    exactly :func:`interp2.interp_add` (kernel K3 on the card): the split
    kernel's only extra work was the in-kernel lane/row interleave."""
    return interp2.interp_add(ci_c, so, qc, res, q)
