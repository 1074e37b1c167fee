"""The fused fine-level ops of the 3D V-cycle: sweep (+ residual or norm
partials), sweep + residual + restriction, interp-add + sweep.

PyTorch counterpart of :mod:`cedar_tpu.ops.pallas3_split`
(``point_relax_split3``, ``sweep_restrict_split3``, ``interp_sweep_split3``)
and of their wavefront versions in :mod:`cedar_tpu.ops.pallas3_stream`
(``point_relax_stream3``, ``sweep_restrict_stream3``,
``interp_sweep_stream3``), under the JAX names so that a reader finds the
counterpart.  "split" is the JAX package's name only: it stores the fine
level in octants because Mosaic cannot reshape lanes in a kernel.  These
functions compute the same values on the dense ``(nx, ny, nz)`` grid,
non-periodic, with the unpadded CI ``(26, nxc+1, nyc+1, nzc+1)`` and a
dense ``qc``: no ``split4``/``merge4``, no ``pw4``, no padding.

Each function dispatches by device and backend, as
:func:`relax3.point_relax` does:
CUDA tensors go to the fused kernels (:mod:`cedar_tpu_torch.ops.cuda_fused3`:
K14-K16), CPU tensors to the plain versions below, which compose the plain
versions of the dense ops (:func:`relax3.sweep3_torch`,
:func:`stencil3.residual`, :func:`interp3.restrict_torch`,
:func:`interp3.interp_add_torch`).

Unlike the dense sweep and interp-add, these leave ``q`` alone and return
a new iterate (the kernels read ``q`` over a halo that other blocks would
be writing).  ``partials`` is a 1-D tensor whose sum is ``‖b − A q_new‖²``:
one partial sum per kernel block on the card, a single element in the
plain version.
"""

from __future__ import annotations

from cedar_tpu_torch.ops import backend
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import interp3
from cedar_tpu_torch.ops.fused2 import _norm_partials
from cedar_tpu_torch.ops.relax3 import sweep3_torch
from cedar_tpu_torch.ops.stencil3 import residual


def _epilogue(so, q, b, kind: StencilKind, fuse_residual: bool,
              fuse_norm: bool):
    if fuse_norm:
        return q, _norm_partials(residual(so, q, b, kind))
    if fuse_residual:
        return q, residual(so, q, b, kind)
    return q


def sweep_split3_torch(so, q, b, kind: StencilKind, updown: str,
                       fuse_residual: bool = False, origin=(0, 0, 0),
                       fuse_norm: bool = False):
    """:func:`point_relax_split3` in torch ops; returns new tensors."""
    return _epilogue(so, sweep3_torch(so, q, b, None, kind, updown,
                                      origin=origin),
                     b, kind, fuse_residual, fuse_norm)


def sweep_restrict3_torch(so, q, b, ci_c, kind: StencilKind, updown: str,
                          emit_res: bool = True):
    """:func:`sweep_restrict_split3` in torch ops; returns new tensors."""
    q, res = sweep3_torch(so, q, b, None, kind, updown, fuse_residual=True)
    return q, (res if emit_res else None), interp3.restrict_torch(ci_c, res)


def interp_sweep3_torch(ci_c, qc, so, b, q_pre, kind: StencilKind,
                        updown: str, fuse_residual: bool = False,
                        fuse_norm: bool = False):
    """:func:`interp_sweep_split3` in torch ops; returns new tensors."""
    res = residual(so, q_pre, b, kind)
    q = interp3.interp_add_torch(ci_c, so, qc, res, q_pre)
    return _epilogue(so, sweep3_torch(so, q, b, None, kind, updown), b, kind,
                     fuse_residual, fuse_norm)


def point_relax_split3(so, q, b, kind: StencilKind, updown: str,
                       fuse_residual: bool = False, origin=(0, 0, 0),
                       fuse_norm: bool = False):
    """One whole multicolour GS sweep (kernel K14 on the card).

    Counterpart of ``cedar_tpu.ops.pallas3_split.point_relax_split3`` and
    ``pallas3_stream.point_relax_stream3``, on the dense ``(nx, ny, nz)``
    grid.  Returns the new iterate ``q_new`` (``q`` is not modified); with
    ``fuse_residual`` ``(q_new, b - A q_new)``; with ``fuse_norm``
    ``(q_new, partials)``, the residual never stored.  Colours anchor to
    ``(x + origin[0], y + origin[1], z + origin[2])``."""
    from cedar_tpu_torch.ops import cuda_fused3

    if backend.kernels(q, "point_relax_split3"):
        return cuda_fused3.sweep(so, q, b, kind, updown, fuse_residual,
                                 origin, fuse_norm)
    return cuda_fused3.sweep_plain(so, q, b, kind, updown, fuse_residual,
                                   origin, fuse_norm)


def sweep_restrict_split3(so, q, b, ci_c, kind: StencilKind, updown: str,
                          emit_res: bool = True):
    """The last pre-sweep, its residual and the coarse rhs in one pass
    (kernel K15 on the card).

    Counterpart of ``cedar_tpu.ops.pallas3_split.sweep_restrict_split3``
    and ``pallas3_stream.sweep_restrict_stream3``, on the dense grid;
    ``ci_c`` is the coarse level's CI.  Returns ``(q_new, res, cb)``,
    ``res`` None unless ``emit_res``: the sweep with ``fuse_residual``,
    then ``cb = Pᵀ res``.  ``q`` is not modified."""
    from cedar_tpu_torch.ops import cuda_fused3

    if backend.kernels(q, "sweep_restrict_split3"):
        return cuda_fused3.sweep_restrict(so, q, b, ci_c, kind, updown,
                                          emit_res)
    return cuda_fused3.sweep_restrict_plain(so, q, b, ci_c, kind, updown,
                                            emit_res)


def interp_sweep_split3(ci_c, qc, so, b, q_pre, kind: StencilKind,
                        updown: str, fuse_residual: bool = False,
                        fuse_norm: bool = False):
    """Interp-add, then the first post-sweep, in one pass (kernel K16 on
    the card).

    Counterpart of ``cedar_tpu.ops.pallas3_split.interp_sweep_split3`` and
    ``pallas3_stream.interp_sweep_stream3``, on the dense grid.  ``q_pre``
    must be the pre-smoothed iterate whose residual was restricted (the
    cycle's invariant): the residual ``b - A q_pre`` is recomputed, then
    ``q = q_pre + res/diag + P qc`` (:func:`interp3.interp_add`'s
    expression) and one sweep.  Returns ``q_new`` (plus ``b - A q_new``
    with ``fuse_residual``, or the partials with ``fuse_norm``); ``q_pre``
    is not modified."""
    from cedar_tpu_torch.ops import cuda_fused3

    if backend.kernels(q_pre, "interp_sweep_split3"):
        return cuda_fused3.interp_sweep(ci_c, qc, so, b, q_pre, kind, updown,
                                        fuse_residual, fuse_norm)
    return cuda_fused3.interp_sweep_plain(ci_c, qc, so, b, q_pre, kind,
                                          updown, fuse_residual, fuse_norm)
