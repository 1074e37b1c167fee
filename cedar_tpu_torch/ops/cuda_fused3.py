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

K15 and K16 launch on a :func:`plan` that this module computes from the
shapes and the card's SM count and passes to the kernel: tile rows, x
chunk, grid and shared-memory bytes (the launch checks them against the
kernel's own), and so the number of norm partials.  7-point K15 and K16
run the ring design (copies by cp.async into rings of planes), 27-point
ones the window design of K14 (csrc/fused3.cu's header note).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

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

# output modes of K14 and K16, and K15's (csrc/fused3.cu)
_NONE, _RES, _NORM, _RESTRICT = 0, 1, 2, 3

#: a block's most shared memory on an H100 (227 KB), less 1 KB for the
#: kernels' static shared memory
BLOCK_SMEM = 232448 - 1024
#: an SM's shared memory (228 KB), of which each resident block takes 1 KB
SM_SMEM = 233472
#: region columns (z) of K14-K16 (csrc/fused3.cu ``kRW``)
RW = 64
#: 7-point K15's and K16's tile rows built (csrc/fused3.cu
#: ``kRingRows``) by itemsize, of which :func:`plan` takes one
RING_ROWS = {4: (12, 10), 8: (4, 2)}
#: 27-point K15's and K16's tile rows and the blocks a launch aims at
#: (csrc/fused3.cu ``kTileRows``, ``kTargetBlocks``), their warps and
#: resident blocks an SM (``kWarps27``, ``kMinBlocks27``)
WINDOW_ROWS, TARGET_BLOCKS = 16, 528
WINDOW_WARPS, WINDOW_BLOCKS = 8, 4


def _stages(ts: bool, interp: bool, mode: int) -> tuple[int, int, int]:
    """(stage of the last colour phase, of the epilogue, halo H) of a pass
    (csrc/fused3.cu ``last_phase``, ``epi_stage``, ``halo``)."""
    sp = int(interp) + (1 if ts else 2)
    se = sp + (mode != _NONE)
    return sp, se, se + (mode == _RESTRICT)


def is_ring(ts: bool) -> bool:
    """Whether K15 and K16 run the ring design (7-point) rather than the
    window design (27-point; csrc/fused3.cu ``ring3``, ``fused3``)."""
    return not ts


def _rnd4(w: int) -> int:
    return (w + 3) & ~3


def ring_words(itemsize: int, interp: bool, mode: int, ty: int) -> int:
    """Shared-memory words of a 7-point K15 (``interp`` false) or K16
    block with tiles of ``ty`` rows: csrc/fused3.cu ``Ring<...>::WORDS``
    (copies one step ahead): slots of q, of K16's q_pre, of b (and in f32
    the stencil planes 0-3); K15's two CI planes and four residual
    planes."""
    _, se, h = _stages(False, interp, mode)
    pl, tz = (ty + 2 * h) * RW, RW - 2 * h
    nsb = 5 if itemsize == 4 else 1
    words = (_rnd4((se + 1 if interp else se + 3) * pl)
             + _rnd4((4 if interp else 0) * pl) + _rnd4((se + 2) * nsb * pl))
    if not interp:
        words += (_rnd4(2 * 26 * (ty // 2 + 1) * (tz // 2 + 1))
                  + 4 * (ty + 1) * (tz + 1))
    return words


def window_words(interp: bool, mode: int) -> int:
    """Shared-memory words of a 27-point K15 or K16 block (the window
    design, csrc/fused3.cu ``smem_words``): the q window, K16's q_pre
    window, K15's residual window."""
    _, se, h = _stages(True, interp, mode)
    ty, tz = WINDOW_ROWS, RW - 2 * h
    pl = (ty + 2 * h) * RW
    return ((se + (1 if interp else 2)) * pl + (3 * pl if interp else 0)
            + (3 * (ty + 1) * (tz + 1) if mode == _RESTRICT else 0))


@dataclass(frozen=True)
class Plan:
    """A K15/K16 launch: tiles of ``ty`` x ``tz`` owned points in a region
    with a halo of ``h``, x chunks of ``cx`` planes, a ``(gz, gy, gc)``
    grid of blocks of ``warps`` warps and ``smem`` bytes, ``per_sm``
    blocks resident an SM; ``ring``: the ring design."""
    ty: int
    tz: int
    h: int
    cx: int
    gz: int
    gy: int
    gc: int
    smem: int
    warps: int
    per_sm: int
    ring: bool

    @property
    def blocks(self) -> int:
        """The blocks of the launch, and the norm partials it writes."""
        return self.gz * self.gy * self.gc


@functools.lru_cache(maxsize=256)
def plan(itemsize: int, ts: bool, interp: bool, mode: int, shape,
         n_sm: int = 132, ty: int | None = None) -> Plan:
    """The launch of K15 (``interp`` false, ``mode`` _RESTRICT) or K16 on
    an ``(nx, ny, nz)`` grid for a card of ``n_sm`` SMs.

    7-point (the ring design): the tile rows ``ty``, or the largest
    :data:`RING_ROWS` option that fits a block, then the x chunk whose grid
    runs in the fewest steps a resident block slot (whole waves of
    ``n_sm`` blocks), of an even length.  27-point (the window design):
    16-row tiles, and chunks of an even length that give the card about
    :data:`TARGET_BLOCKS` blocks and are at least 2H planes long.  Tiles
    and chunks start at even indices, as K15's restriction needs."""
    nx, ny, nz = shape
    _, _, h = _stages(ts, interp, mode)
    tz = RW - 2 * h
    if not is_ring(ts):
        if ty not in (None, WINDOW_ROWS):
            raise ValueError(f"27-point K15 and K16 take {WINDOW_ROWS} "
                             f"tile rows, not {ty}")
        gz, gy = -(-nz // tz), -(-ny // WINDOW_ROWS)
        chunks = -(-TARGET_BLOCKS // (gz * gy))
        cx = -(-nx // chunks)
        cx = max(cx + (cx & 1), 2 * h)
        smem = window_words(interp, mode) * itemsize
        return Plan(WINDOW_ROWS, tz, h, cx, gz, gy, -(-nx // cx), smem,
                    WINDOW_WARPS,
                    min(WINDOW_BLOCKS, SM_SMEM // (smem + 1024)), False)
    options = RING_ROWS[itemsize]
    size = {t: ring_words(itemsize, interp, mode, t) * itemsize
            for t in options}
    if ty is None:
        fit = [t for t in options if size[t] <= BLOCK_SMEM]
        if not fit:
            raise ValueError(f"no built tile rows {options} fit a block")
        ty = max(fit)
    if ty not in size or size[ty] > BLOCK_SMEM:
        raise ValueError(f"no 7-point K15/K16 variant with {ty} tile rows")
    gz, gy = -(-nz // tz), -(-ny // ty)
    tiles = gz * gy
    best = None
    for waves in range(1, 17):
        cx = max(2, -(-nx // max(1, waves * n_sm // tiles)))
        cx += cx & 1
        gc = -(-nx // cx)
        steps = -(-(tiles * gc) // n_sm) * (min(cx, nx) + 2 * h)
        if best is None or steps < best[0]:
            best = (steps, cx, gc)
    return Plan(ty, tz, h, best[1], gz, gy, best[2], size[ty], ty + 2 * h,
                1, True)


@functools.lru_cache(maxsize=None)
def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def _extra(q: torch.Tensor, mode: int, partials: int):
    """The residual or partials buffer of ``mode`` for a K14 or K16
    launch (``partials`` entries), passed as both its res and its partials
    pointer: the kernel writes the one its mode names."""
    if mode == _RES:
        return torch.empty_like(q)
    if mode == _NORM:
        return q.new_empty(partials)
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
    ts = int(kind == StencilKind.twenty_seven_pt)
    extra = _extra(q_in, mode, lib.cedar_fused3_partials(ts, *q_in.shape))
    ox, oy, oz = (int(o) for o in origin)
    cuda_build.check(
        lib.cedar_sweep3_fused(dt, so.data_ptr(), q_in.data_ptr(),
                               b.data_ptr(), q_out.data_ptr(), _ptr(extra),
                               _ptr(extra), *q_in.shape, ts,
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


def _plan_args(p: Plan):
    return (p.ty, p.cx, p.gz, p.gy, p.gc, p.smem)


def sweep_restrict(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
                   ci: torch.Tensor, kind: StencilKind, updown: str,
                   emit_res: bool = True):
    """K15: the sweep, its residual and ``cb = Pᵀ res`` on the card (a
    27-point sweep's passes before the last by K14); returns ``(q_new, res
    or None, cb)``."""
    return _sweep_restrict(None, None, so, q, b, ci, kind, updown,
                           emit_res)


def _sweep_restrict(lib, ty, so, q, b, ci, kind, updown, emit_res):
    """:func:`sweep_restrict` with the library ``lib`` (a build of
    csrc/fused3.cu; None: the default one) and the tile rows ``ty`` (None:
    the plan's), as tools/tune_fused3.py times them."""
    global sweep_restrict_launches
    _check(so, q, b, kind)
    nxc, nyc, nzc = _coarse_shape(ci, q.shape)
    dt = cuda_build.check_operands(so, q, b, ci)
    lib = lib or cuda_build.load("fused3")
    *first, last = _passes(lib, kind, updown)
    for colors in first:
        q, _ = _sweep_pass(lib, dt, so, q, b, kind, colors, (0, 0, 0), _NONE)
    q_out = torch.empty_like(q)
    res = torch.empty_like(q) if emit_res else None
    cb = q.new_empty((nxc, nyc, nzc))
    ts = kind == StencilKind.twenty_seven_pt
    p = plan(q.element_size(), ts, False, _RESTRICT, tuple(q.shape),
             _n_sm(q.device), ty)
    cuda_build.check(
        lib.cedar_sweep_restrict3(dt, so.data_ptr(), q.data_ptr(),
                                  b.data_ptr(), ci.data_ptr(),
                                  q_out.data_ptr(), _ptr(res), cb.data_ptr(),
                                  *q.shape, nxc, nyc, nzc, int(ts), last,
                                  int(emit_res), *_plan_args(p),
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
    return _interp_sweep(None, None, ci, qc, so, b, q_pre, kind, updown,
                         fuse_residual, fuse_norm)


def _interp_sweep(lib, ty, ci, qc, so, b, q_pre, kind, updown,
                  fuse_residual, fuse_norm):
    """:func:`interp_sweep` with ``lib`` and ``ty`` as in
    :func:`_sweep_restrict`."""
    global interp_sweep_launches
    _check(so, q_pre, b, kind)
    nxc, nyc, nzc = _coarse_shape(ci, q_pre.shape)
    _check_qc(qc, (nxc, nyc, nzc))
    dt = cuda_build.check_operands(ci, qc, so, b, q_pre)
    lib = lib or cuda_build.load("fused3")
    mode = _mode(fuse_residual, fuse_norm)
    first, *rest = _passes(lib, kind, updown)
    mode16 = _NONE if rest else mode
    ts = kind == StencilKind.twenty_seven_pt
    p = plan(q_pre.element_size(), ts, True, mode16, tuple(q_pre.shape),
             _n_sm(q_pre.device), ty)
    q_out = torch.empty_like(q_pre)
    extra = _extra(q_pre, mode16, p.blocks)
    cuda_build.check(
        lib.cedar_interp_sweep3(dt, ci.data_ptr(), qc.data_ptr(),
                                so.data_ptr(), b.data_ptr(),
                                q_pre.data_ptr(), q_out.data_ptr(),
                                _ptr(extra), _ptr(extra), *q_pre.shape,
                                nxc, nyc, nzc, int(ts), first, mode16,
                                *_plan_args(p),
                                cuda_build.stream_of(q_pre)),
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
