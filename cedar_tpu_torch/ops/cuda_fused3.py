"""K14 (fused sweep), K15 (sweep + residual + restriction) and K16
(interp-add + sweep): the fused 3D fine-level kernels (CUDA) and their
plain versions.

Counterpart of :mod:`cedar_tpu.ops.pallas3_split` (``point_relax_split3``,
``sweep_restrict_split3``, ``interp_sweep_split3``) and of the wavefront
kernels of :mod:`cedar_tpu.ops.pallas3_stream`.  :func:`sweep`,
:func:`sweep_restrict` and :func:`interp_sweep` launch ``csrc/fused3.cu``
on the tensors' current stream; :func:`sweep_plain`,
:func:`sweep_restrict_plain` and :func:`interp_sweep_plain` compute the
same functions in torch ops (:mod:`cedar_tpu_torch.ops.fused3`), which
picks one by device.

A kernel launch runs one pass: both colours of a 7-point sweep, or
``cedar_fused3_colors(1)`` of the eight 27-point colours (one: a 27-point
sweep is eight launches, K14 for all but the last of a pre-sweep, which is
K15, and all but the first of a post-sweep, which is K16).  Each launch
adds one to the count of the kernel it launches (``*_launches``);
``*_plain_calls`` count plain-version calls.

All of them read ``q`` and return a new iterate: a kernel block reads
``q`` over its region and a halo while other blocks write theirs, so the
kernels work out of place.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_build, fused3, relax3
from cedar_tpu_torch.ops.cuda3 import _check_sweep as _check
from cedar_tpu_torch.ops.cuda_transfer3 import _check_qc, _coarse_shape

sweep_launches = 0
sweep_restrict_launches = 0
interp_sweep_launches = 0
sweep_plain_calls = 0
sweep_restrict_plain_calls = 0
interp_sweep_plain_calls = 0

# output modes of K14 and K16 (csrc/fused3.cu)
_NONE, _RES, _NORM = 0, 1, 2


def _passes(lib, kind: StencilKind, updown: str) -> list[int]:
    """The colour codes of :func:`relax3.color_order` in sweep order, packed
    4 bits each, one int per launch (``cedar_fused3_colors`` colours a
    launch)."""
    order = relax3.color_order(kind, updown)
    n = lib.cedar_fused3_colors(int(kind == StencilKind.twenty_seven_pt))
    return [sum(c << (4 * k) for k, c in enumerate(order[i:i + n]))
            for i in range(0, len(order), n)]


def _mode(fuse_residual: bool, fuse_norm: bool) -> int:
    return _NORM if fuse_norm else (_RES if fuse_residual else _NONE)


def _extra(lib, q: torch.Tensor, kind: StencilKind, mode: int,
           interp: bool):
    """The residual or partials buffer of ``mode`` for a K14 (or, with
    ``interp``, K16) launch, passed as both its res and its partials
    pointer: the kernel writes the one its mode names."""
    if mode == _RES:
        return torch.empty_like(q)
    if mode == _NORM:
        return q.new_empty(lib.cedar_fused3_partials(
            int(interp), int(kind == StencilKind.twenty_seven_pt),
            *q.shape))
    return None


def _result(q_out, extra, mode: int):
    return q_out if mode == _NONE else (q_out, extra)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _sweep_pass(lib, dt: int, so, q_in, b, kind: StencilKind, colors: int,
                origin, mode: int):
    """One K14 launch; returns ``(q_out, res or partials or None)``."""
    global sweep_launches
    q_out = torch.empty_like(q_in)
    extra = _extra(lib, q_in, kind, mode, interp=False)
    ox, oy, oz = (int(o) for o in origin)
    cuda_build.check(
        lib.cedar_sweep3_fused(dt, so.data_ptr(), q_in.data_ptr(),
                               b.data_ptr(), q_out.data_ptr(), _ptr(extra),
                               _ptr(extra), *q_in.shape,
                               int(kind == StencilKind.twenty_seven_pt),
                               colors, ox, oy, oz, mode,
                               cuda_build.stream_of(q_in)),
        "sweep3_fused",
    )
    sweep_launches += 1
    return q_out, extra


def sweep(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
          kind: StencilKind, updown: str, fuse_residual: bool = False,
          origin=(0, 0, 0), fuse_norm: bool = False):
    """K14: one whole multicolour sweep on the card, out of place (one
    launch 7-point, one a pass 27-point).

    Returns ``q_new``, ``(q_new, res)`` with ``fuse_residual`` or
    ``(q_new, partials)`` with ``fuse_norm``."""
    _check(so, q, b, kind)
    dt = cuda_build.check_operands(so, q, b)
    lib = cuda_build.load("fused3")
    mode = _mode(fuse_residual, fuse_norm)
    *first, last = _passes(lib, kind, updown)
    for colors in first:
        q, _ = _sweep_pass(lib, dt, so, q, b, kind, colors, origin, _NONE)
    q_out, extra = _sweep_pass(lib, dt, so, q, b, kind, last, origin, mode)
    return _result(q_out, extra, mode)


def sweep_restrict(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
                   ci: torch.Tensor, kind: StencilKind, updown: str,
                   emit_res: bool = True):
    """K15: the sweep, its residual and ``cb = Pᵀ res`` on the card (a
    27-point sweep's passes before the last by K14); returns ``(q_new, res
    or None, cb)``."""
    global sweep_restrict_launches
    _check(so, q, b, kind)
    nxc, nyc, nzc = _coarse_shape(ci, q.shape)
    dt = cuda_build.check_operands(so, q, b, ci)
    lib = cuda_build.load("fused3")
    *first, last = _passes(lib, kind, updown)
    for colors in first:
        q, _ = _sweep_pass(lib, dt, so, q, b, kind, colors, (0, 0, 0), _NONE)
    q_out = torch.empty_like(q)
    res = torch.empty_like(q) if emit_res else None
    cb = q.new_empty((nxc, nyc, nzc))
    cuda_build.check(
        lib.cedar_sweep_restrict3(dt, so.data_ptr(), q.data_ptr(),
                                  b.data_ptr(), ci.data_ptr(),
                                  q_out.data_ptr(), _ptr(res), cb.data_ptr(),
                                  *q.shape, nxc, nyc, nzc,
                                  int(kind == StencilKind.twenty_seven_pt),
                                  last, int(emit_res),
                                  cuda_build.stream_of(q)),
        "sweep_restrict3",
    )
    sweep_restrict_launches += 1
    return q_out, res, cb


def interp_sweep(ci: torch.Tensor, qc: torch.Tensor, so: torch.Tensor,
                 b: torch.Tensor, q_pre: torch.Tensor, kind: StencilKind,
                 updown: str, fuse_residual: bool = False,
                 fuse_norm: bool = False):
    """K16: ``q_pre + (b - A q_pre)/diag + P qc``, then one sweep, on the
    card (a 27-point sweep's passes after the first by K14); returns
    ``q_new`` (plus ``res`` or ``partials``)."""
    global interp_sweep_launches
    _check(so, q_pre, b, kind)
    nxc, nyc, nzc = _coarse_shape(ci, q_pre.shape)
    _check_qc(qc, (nxc, nyc, nzc))
    dt = cuda_build.check_operands(ci, qc, so, b, q_pre)
    lib = cuda_build.load("fused3")
    mode = _mode(fuse_residual, fuse_norm)
    first, *rest = _passes(lib, kind, updown)
    mode16 = _NONE if rest else mode
    q_out = torch.empty_like(q_pre)
    extra = _extra(lib, q_pre, kind, mode16, interp=True)
    cuda_build.check(
        lib.cedar_interp_sweep3(dt, ci.data_ptr(), qc.data_ptr(),
                                so.data_ptr(), b.data_ptr(),
                                q_pre.data_ptr(), q_out.data_ptr(),
                                _ptr(extra), _ptr(extra), *q_pre.shape,
                                nxc, nyc, nzc,
                                int(kind == StencilKind.twenty_seven_pt),
                                first, mode16, cuda_build.stream_of(q_pre)),
        "interp_sweep3",
    )
    interp_sweep_launches += 1
    for k, colors in enumerate(rest, 1):
        q_out, extra = _sweep_pass(lib, dt, so, q_out, b, kind, colors,
                                   (0, 0, 0), mode if k == len(rest) else _NONE)
    return _result(q_out, extra, mode)


def sweep_plain(so, q, b, kind: StencilKind, updown: str,
                fuse_residual: bool = False, origin=(0, 0, 0),
                fuse_norm: bool = False):
    """:func:`sweep` in torch ops, on any device."""
    global sweep_plain_calls
    sweep_plain_calls += 1
    _check(so, q, b, kind)
    return fused3.sweep_split3_torch(so, q, b, kind, updown, fuse_residual,
                                     origin, fuse_norm)


def sweep_restrict_plain(so, q, b, ci, kind: StencilKind, updown: str,
                         emit_res: bool = True):
    """:func:`sweep_restrict` in torch ops, on any device."""
    global sweep_restrict_plain_calls
    sweep_restrict_plain_calls += 1
    _check(so, q, b, kind)
    _coarse_shape(ci, q.shape)
    return fused3.sweep_restrict3_torch(so, q, b, ci, kind, updown, emit_res)


def interp_sweep_plain(ci, qc, so, b, q_pre, kind: StencilKind, updown: str,
                       fuse_residual: bool = False, fuse_norm: bool = False):
    """:func:`interp_sweep` in torch ops, on any device."""
    global interp_sweep_plain_calls
    interp_sweep_plain_calls += 1
    _check(so, q_pre, b, kind)
    _check_qc(qc, _coarse_shape(ci, q_pre.shape))
    return fused3.interp_sweep3_torch(ci, qc, so, b, q_pre, kind, updown,
                                      fuse_residual, fuse_norm)
