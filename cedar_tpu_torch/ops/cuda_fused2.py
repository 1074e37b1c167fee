"""K11 (fused sweep), K12 (sweep + residual + restriction) and K13
(interp-add + sweep): the fused 2D fine-level kernels (CUDA) and their
plain versions.

Counterpart of :mod:`cedar_tpu.ops.pallas2_split` (``point_relax_split``)
and of the fused half of :mod:`cedar_tpu.ops.pallas_transfer2`
(``sweep_restrict_split``, ``interp_sweep_split``).  :func:`sweep`,
:func:`sweep_restrict` and :func:`interp_sweep` launch ``csrc/fused2.cu``
once each on the tensors' current stream; :func:`sweep_plain`,
:func:`sweep_restrict_plain` and :func:`interp_sweep_plain` compute the
same functions in torch ops (:mod:`cedar_tpu_torch.ops.fused2`), which
picks one by device.

All of them read ``q`` and return a new iterate: a kernel block reads
``q`` over its tile and a halo while other blocks write theirs, so the
kernels work out of place.  ``*_launches`` count kernel launches,
``*_plain_calls`` plain-version calls.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_build, fused2, relax2
from cedar_tpu_torch.ops.cuda_transfer2 import _coarse_shape

sweep_launches = 0
sweep_restrict_launches = 0
interp_sweep_launches = 0
sweep_plain_calls = 0
sweep_restrict_plain_calls = 0
interp_sweep_plain_calls = 0

# output modes of K11 and K13 (csrc/fused2.cu)
_NONE, _RES, _NORM = 0, 1, 2


def _check(so, q, b, kind: StencilKind) -> None:
    if kind not in (StencilKind.five_pt, StencilKind.nine_pt):
        raise ValueError(f"fused sweep takes 2D five_pt or nine_pt, not "
                         f"{kind}")
    if q.ndim != 2 or b.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} and b {tuple(b.shape)}")
    if tuple(so.shape) != (kind.ndirs, *q.shape):
        raise ValueError(
            f"so {tuple(so.shape)} does not fit {kind} on {tuple(q.shape)}"
        )


def _check_qc(ci, qc, fine_shape) -> tuple[int, int]:
    nc = _coarse_shape(ci, fine_shape)
    if tuple(qc.shape) != nc:
        raise ValueError(f"qc {tuple(qc.shape)}, expected {nc}")
    return nc


def _colors(kind: StencilKind, updown: str) -> tuple[int, int]:
    """The colour codes of :func:`relax2.color_order`, packed 4 bits each
    in sweep order (5-point parity; 9-point ``2 cw + cz``), and their
    count."""
    order = relax2.color_order(kind, updown)
    codes = [2 * c[0] + c[1] if kind == StencilKind.nine_pt else c
             for c in order]
    return sum(code << (4 * k) for k, code in enumerate(codes)), len(codes)


def _mode(fuse_residual: bool, fuse_norm: bool) -> int:
    return _NORM if fuse_norm else (_RES if fuse_residual else _NONE)


def _outputs(lib, q: torch.Tensor, kind: StencilKind, mode: int,
             interp: bool):
    """``q_out`` and the residual or partials buffer of ``mode`` (passed to
    the kernel as both its res and its partials pointer: it writes the one
    its mode names); ``interp`` for K13, whose halo and so whose block
    count differ from K11's."""
    nx, ny = q.shape
    extra = None
    if mode == _RES:
        extra = torch.empty_like(q)
    elif mode == _NORM:
        extra = q.new_empty(lib.cedar_fused2_partials(
            int(interp), int(kind == StencilKind.nine_pt), nx, ny))
    return torch.empty_like(q), extra


def _result(q_out, extra, mode: int):
    return q_out if mode == _NONE else (q_out, extra)


def _ptr(t):
    return None if t is None else t.data_ptr()


def sweep(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
          kind: StencilKind, updown: str, fuse_residual: bool = False,
          origin=(0, 0), fuse_norm: bool = False):
    """K11: one whole multicolour sweep on the card, out of place.

    Returns ``q_new``, ``(q_new, res)`` with ``fuse_residual`` or
    ``(q_new, partials)`` with ``fuse_norm``."""
    global sweep_launches
    _check(so, q, b, kind)
    dt = cuda_build.check_operands(so, q, b)
    lib = cuda_build.load("fused2")
    mode = _mode(fuse_residual, fuse_norm)
    q_out, extra = _outputs(lib, q, kind, mode, interp=False)
    colors, ncolors = _colors(kind, updown)
    oz, ow = (int(o) for o in origin)
    nx, ny = q.shape
    cuda_build.check(
        lib.cedar_sweep2_fused(dt, so.data_ptr(), q.data_ptr(), b.data_ptr(),
                               q_out.data_ptr(), _ptr(extra), _ptr(extra),
                               nx, ny, int(kind == StencilKind.nine_pt),
                               colors, ncolors, oz, ow, mode,
                               cuda_build.stream_of(q)),
        "sweep2_fused",
    )
    sweep_launches += 1
    return _result(q_out, extra, mode)


def sweep_restrict(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
                   ci: torch.Tensor, kind: StencilKind, updown: str,
                   emit_res: bool = True):
    """K12: the sweep, its residual and ``cb = Pᵀ res`` on the card; returns
    ``(q_new, res or None, cb)``."""
    global sweep_restrict_launches
    _check(so, q, b, kind)
    nxc, nyc = _coarse_shape(ci, q.shape)
    dt = cuda_build.check_operands(so, q, b, ci)
    lib = cuda_build.load("fused2")
    q_out = torch.empty_like(q)
    res = torch.empty_like(q) if emit_res else None
    cb = q.new_empty((nxc, nyc))
    colors, ncolors = _colors(kind, updown)
    nx, ny = q.shape
    cuda_build.check(
        lib.cedar_sweep_restrict2(dt, so.data_ptr(), q.data_ptr(),
                                  b.data_ptr(), ci.data_ptr(),
                                  q_out.data_ptr(), _ptr(res), cb.data_ptr(),
                                  nx, ny, nxc, nyc,
                                  int(kind == StencilKind.nine_pt), colors,
                                  ncolors, int(emit_res),
                                  cuda_build.stream_of(q)),
        "sweep_restrict2",
    )
    sweep_restrict_launches += 1
    return q_out, res, cb


def interp_sweep(ci: torch.Tensor, qc: torch.Tensor, so: torch.Tensor,
                 b: torch.Tensor, q_pre: torch.Tensor, kind: StencilKind,
                 updown: str, fuse_residual: bool = False,
                 fuse_norm: bool = False):
    """K13: ``q_pre + P qc + (b - A q_pre)/diag``, then one sweep, on the
    card; returns ``q_new`` (plus ``res`` or ``partials``)."""
    global interp_sweep_launches
    _check(so, q_pre, b, kind)
    nxc, nyc = _check_qc(ci, qc, q_pre.shape)
    dt = cuda_build.check_operands(ci, qc, so, b, q_pre)
    lib = cuda_build.load("fused2")
    mode = _mode(fuse_residual, fuse_norm)
    q_out, extra = _outputs(lib, q_pre, kind, mode, interp=True)
    colors, ncolors = _colors(kind, updown)
    nx, ny = q_pre.shape
    cuda_build.check(
        lib.cedar_interp_sweep2(dt, ci.data_ptr(), qc.data_ptr(),
                                so.data_ptr(), b.data_ptr(),
                                q_pre.data_ptr(), q_out.data_ptr(),
                                _ptr(extra), _ptr(extra), nx, ny, nxc, nyc,
                                int(kind == StencilKind.nine_pt), colors,
                                ncolors, mode, cuda_build.stream_of(q_pre)),
        "interp_sweep2",
    )
    interp_sweep_launches += 1
    return _result(q_out, extra, mode)


def sweep_plain(so, q, b, kind: StencilKind, updown: str,
                fuse_residual: bool = False, origin=(0, 0),
                fuse_norm: bool = False):
    """:func:`sweep` in torch ops, on any device."""
    global sweep_plain_calls
    sweep_plain_calls += 1
    _check(so, q, b, kind)
    return fused2.sweep_split_torch(so, q, b, kind, updown, fuse_residual,
                                    origin, fuse_norm)


def sweep_restrict_plain(so, q, b, ci, kind: StencilKind, updown: str,
                         emit_res: bool = True):
    """:func:`sweep_restrict` in torch ops, on any device."""
    global sweep_restrict_plain_calls
    sweep_restrict_plain_calls += 1
    _check(so, q, b, kind)
    _coarse_shape(ci, q.shape)
    return fused2.sweep_restrict_torch(so, q, b, ci, kind, updown, emit_res)


def interp_sweep_plain(ci, qc, so, b, q_pre, kind: StencilKind, updown: str,
                       fuse_residual: bool = False, fuse_norm: bool = False):
    """:func:`interp_sweep` in torch ops, on any device."""
    global interp_sweep_plain_calls
    interp_sweep_plain_calls += 1
    _check(so, q_pre, b, kind)
    _check_qc(ci, qc, q_pre.shape)
    return fused2.interp_sweep_torch(ci, qc, so, b, q_pre, kind, updown,
                                     fuse_residual, fuse_norm)
