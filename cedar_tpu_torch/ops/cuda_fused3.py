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

A kernel launch runs one pass: both colours of a 7-point sweep (with its
epilogue); a 27-point K15 or K16 one of the eight 27-point colours (the
last of a pre-sweep, the first of a post-sweep), a 27-point K14 a march of
up to :data:`PASS27_STAGES` of them (``cedar_fused3_pass27_stages``: a
27-point sweep is four K14 launches), in groups aligned to the colour
order, so that the colours of a march share their y and z parities.  A
27-point sweep whose residual or norm is asked for runs its last colour as
a one-colour K14 of the window design, whose epilogue computes it
(:func:`passes`).  The 3D sweep K6 (:mod:`cedar_tpu_torch.ops.cuda3`)
runs its largest levels on these K14 launches too, through
:func:`launch_sweep`.  Each launch
adds one to the count of the kernel it launches (``*_launches``);
``*_plain_calls`` count plain-version calls.

All of them read ``q`` and return a new iterate: a kernel block reads
``q`` over its region and a halo while other blocks write theirs, so the
kernels work out of place.

K15, K16 and the 7-point K14 launch on a :func:`plan`, the 27-point K14
on a :func:`pass27_plan`, that this module computes from the shapes and
the card's SM count and passes to the kernel: tile rows, x chunk, grid
and shared-memory bytes (the launch checks them against the kernel's
own), and so the number of norm partials.  7-point K14, K15 and K16 run
the ring design (copies by cp.async into rings of planes), 27-point K15
and K16 the window design, the 27-point K14 its march of several colours
(csrc/fused3.cu's header note).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_build, fused3, relax3
from cedar_tpu_torch.ops.cuda_build import BLOCK_SMEM, SM_SMEM
from cedar_tpu_torch.ops.cuda_transfer3 import _check_qc, _coarse_shape

sweep_launches = 0
sweep_restrict_launches = 0
interp_sweep_launches = 0
sweep_plain_calls = 0
sweep_restrict_plain_calls = 0
interp_sweep_plain_calls = 0

# output modes of K14 and K16, and K15's (csrc/fused3.cu)
_NONE, _RES, _NORM, _RESTRICT = 0, 1, 2, 3

#: region columns (z) of K14-K16 (csrc/fused3.cu ``kRW``)
RW = 64
#: 7-point K15's and K16's tile rows built (csrc/fused3.cu
#: ``kRingRows``) by itemsize, of which :func:`plan` takes one; the 7-point
#: K14's, one a dtype (``kRingRows14``; a build with ``-DCEDAR_K14_ROWS=t``
#: takes t in float32, ``cedar_fused3_ring14_rows``)
RING_ROWS = {4: (12, 10), 8: (4, 2)}
RING14_ROWS = {4: 20, 8: 8}
#: the blocks an SM the 7-point K14's registers are capped for
#: (csrc/fused3.cu ``kMinBlocks14``)
RING14_BLOCKS = 2
#: 27-point K15's and K16's tile rows and the blocks a launch aims at
#: (csrc/fused3.cu ``kTileRows``, ``kTargetBlocks``), their warps and
#: resident blocks an SM (``kWarps27``, ``kMinBlocks27``)
WINDOW_ROWS, TARGET_BLOCKS = 16, 528
WINDOW_WARPS, WINDOW_BLOCKS = 8, 4
#: colours a 27-point K14 march (and launch) takes (csrc/fused3.cu
#: ``kStages27``; a build with ``-DCEDAR_K14_STAGES=m`` takes m), the
#: values a point's stencil slots hold (``kVals``) and the colour code that
#: names no colour (``kNoColor``)
PASS27_STAGES, PASS27_VALS, NO_COLOR = 2, 28, 15


def pass27_warps(stages: int = PASS27_STAGES) -> int:
    """The most warps a 27-point K14 block takes (csrc/fused3.cu
    ``kMaxWarps27``): 12 where each thread gathers its stencil values for
    3 or 4 colour stages (170 registers a thread), else 16."""
    return 12 if 3 <= stages <= 4 else 16


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


def is_k14(interp: bool, mode: int) -> bool:
    """Whether a 7-point ring variant is K14 (the colour stages and an
    epilogue) rather than K15 or K16."""
    return not interp and mode != _RESTRICT


def ring_words(itemsize: int, interp: bool, mode: int, ty: int) -> int:
    """Shared-memory words of a 7-point K14 (``interp`` false, ``mode``
    not ``_RESTRICT``), K15 (``_RESTRICT``) or K16 block with tiles of
    ``ty`` rows: csrc/fused3.cu ``Ring<...>::WORDS`` (copies one step
    ahead): slots of q, of K16's q_pre, of b (and in f32 the stencil planes
    0-3); K15's two CI planes and four residual planes."""
    _, se, h = _stages(False, interp, mode)
    pl, tz = (ty + 2 * h) * RW, RW - 2 * h
    nsb = 5 if itemsize == 4 else 1
    words = (_rnd4((se + 1 if interp else se + 3) * pl)
             + _rnd4((4 if interp else 0) * pl) + _rnd4((se + 2) * nsb * pl))
    if mode == _RESTRICT:
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


def pass27_words(itemsize: int, ty: int, stages: int = PASS27_STAGES) -> int:
    """Shared-memory words of a 27-point K14 block with tiles of ``ty``
    rows (csrc/fused3.cu ``Pass27<...>::words``): the ring of q planes
    (planes p - H - 1 .. p + 2, H = the stages of a march) and, in float32
    with at most 4 stages, each thread's stencil values and b for each
    colour stage."""
    h = stages
    ry = ty + 2 * h
    staged = itemsize == 4 and stages <= 4
    return ((h + 4) * ry * RW
            + (stages * PASS27_VALS * 16 * ry if staged else 0))


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
         n_sm: int = 132, ty: int | None = None,
         blocks14: int = RING14_BLOCKS) -> Plan:
    """The launch of K15 (``interp`` false, ``mode`` _RESTRICT), K16 or
    the 7-point K14 (``interp`` false, another mode) on an ``(nx, ny,
    nz)`` grid for a card of ``n_sm`` SMs.

    7-point (the ring design): the tile rows ``ty``, or the largest
    :data:`RING_ROWS` option that fits a block (K14: its build's, by
    default :data:`RING14_ROWS`), then the x chunk whose grid runs in the fewest steps a resident block
    slot (K14: as many blocks an SM as fit, at most the ``blocks14`` its
    build caps its registers for), of an even length.  27-point (the
    window design): 16-row tiles, and chunks of an even length that give
    the card about :data:`TARGET_BLOCKS` blocks and are at least 2H planes
    long.  Tiles and chunks start at even indices, as K15's restriction
    needs."""
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
    k14 = is_k14(interp, mode)
    blocks = blocks14 if k14 else 1
    options = ((ty or RING14_ROWS[itemsize],) if k14
               else RING_ROWS[itemsize])
    size = {t: ring_words(itemsize, interp, mode, t) * itemsize
            for t in options}

    def per_sm(t):
        return min(blocks, SM_SMEM // (size[t] + 1024),
                   2048 // (32 * (t + 2 * h)))

    if ty is None:
        fit = [t for t in options if size[t] <= BLOCK_SMEM]
        if not fit:
            raise ValueError(f"no built tile rows {options} fit a block")
        ty = max(fit)
    if ty not in size or size[ty] > BLOCK_SMEM:
        raise ValueError(f"no 7-point ring variant with {ty} tile rows")
    gz, gy = -(-nz // tz), -(-ny // ty)
    cx, gc = cuda_build.chunk(nx, gz * gy, n_sm * per_sm(ty), h)
    return Plan(ty, tz, h, cx, gz, gy, gc, size[ty], ty + 2 * h, per_sm(ty),
                True)


@functools.lru_cache(maxsize=256)
def pass27_plan(itemsize: int, shape, n_sm: int = 132,
                stages: int = PASS27_STAGES) -> Plan:
    """The launch of a 27-point K14 march of ``stages`` colours at most on
    an ``(nx, ny, nz)`` grid: the most tile rows (even, a warp for each
    pair of region rows, at most :func:`pass27_warps`) whose block fits,
    then the x chunk whose grid runs in the fewest steps a block slot."""
    nx, ny, nz = shape
    h = stages
    tz = RW - 2 * h
    ty = next((t for t in range(2 * pass27_warps(stages) - 2 * h, 1, -2)
               if pass27_words(itemsize, t, stages) * itemsize
               <= BLOCK_SMEM), None)
    if ty is None:
        raise ValueError("no 27-point K14 tile fits a block")
    smem = pass27_words(itemsize, ty, stages) * itemsize
    warps = (ty + 2 * h) // 2
    gz, gy = -(-nz // tz), -(-ny // ty)
    per_sm = min(2048 // (32 * warps), SM_SMEM // (smem + 1024))
    cx, gc = cuda_build.chunk(nx, gz * gy, n_sm * per_sm, h)
    return Plan(ty, tz, h, cx, gz, gy, gc, smem, warps, per_sm, True)


@functools.lru_cache(maxsize=None)
def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _pack(codes, slots: int = 0) -> int:
    """Colour codes packed 4 bits each in order, :data:`NO_COLOR` in the
    slots past them up to ``slots``."""
    codes = list(codes) + [NO_COLOR] * (slots - len(codes))
    return sum(c << (4 * k) for k, c in enumerate(codes))


@functools.lru_cache(maxsize=None)
def _stages_of(lib) -> int:
    """The colours a 27-point K14 march of build ``lib`` takes, read once."""
    return lib.cedar_fused3_pass27_stages()


@functools.lru_cache(maxsize=None)
def _ring14_of(lib) -> tuple[dict[int, int], int]:
    """The 7-point K14's tile rows by itemsize and the blocks an SM its
    registers are capped for, in build ``lib``, read once."""
    rows = {4: lib.cedar_fused3_ring14_rows(0),
            8: lib.cedar_fused3_ring14_rows(1)}
    return rows, lib.cedar_fused3_ring14_blocks()


@functools.lru_cache(maxsize=None)
def passes(stages: int, kind: StencilKind, updown: str, role: str = "sweep",
            mode: int = _NONE) -> tuple[tuple[str, tuple[int, ...]], ...]:
    """The launches of one sweep in order, each ``(kernel, colours)`` in
    :func:`relax3.color_order`'s codes: 7-point one launch of both colours
    (the ring K14, K15 or K16 by ``role``: "sweep", "restrict" or
    "interp": "ring", "K15", "K16");
    27-point K16 on the first colour ("interp"), K15 on the last
    ("restrict"), a K14 march ("pass27") for each block of ``stages``
    positions of the colour order that holds any of the others, but the
    last colour of a sweep with an epilogue ``mode``, which a one-colour
    K14 of the window design ("K14") runs."""
    order = tuple(relax3.color_order(kind, updown))
    if kind != StencilKind.twenty_seven_pt:
        return (({"sweep": "ring", "restrict": "K15", "interp": "K16"}[role],
                 order),)
    lo = int(role == "interp")
    hi = 8 - (role == "restrict" or mode != _NONE)
    marches = tuple(("pass27", order[max(j, lo):min(j + stages, hi)])
                    for j in range(lo - lo % stages, hi, stages))
    head = (("K16", order[:1]),) if role == "interp" else ()
    tail = ((("K15", order[-1:]),) if role == "restrict"
            else (("K14", order[-1:]),) if mode != _NONE else ())
    return head + marches + tail


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


def _window_pass(lib, dt: int, so, q_in, b, colors, origin, mode: int):
    """One 27-point K14 launch of the window design on one colour with
    epilogue ``mode``; returns ``(q_out, res or partials)``."""
    global sweep_launches
    q_out = torch.empty_like(q_in)
    extra = _extra(q_in, mode, lib.cedar_fused3_partials(*q_in.shape))
    ox, oy, oz = (int(o) for o in origin)
    cuda_build.check(
        lib.cedar_sweep3_fused(dt, so.data_ptr(), q_in.data_ptr(),
                               b.data_ptr(), q_out.data_ptr(), _ptr(extra),
                               _ptr(extra), *q_in.shape, _pack(colors),
                               ox, oy, oz, mode, cuda_build.stream_of(q_in)),
        "sweep3_fused",
    )
    sweep_launches += 1
    return q_out, extra


def _ring_pass(lib, dt: int, so, q_in, b, colors, origin, mode: int):
    """One 7-point K14 launch of the ring design: the whole sweep
    (``colors``) with epilogue ``mode``, on :func:`plan` for the build
    ``lib``; returns ``(q_out, res or partials or None)``."""
    global sweep_launches
    rows, blocks = _ring14_of(lib)
    itemsize = q_in.element_size()
    p = plan(itemsize, False, False, mode, tuple(q_in.shape),
             _n_sm(q_in.device), rows[itemsize], blocks)
    q_out = torch.empty_like(q_in)
    extra = _extra(q_in, mode, p.blocks)
    ox, oy, oz = (int(o) for o in origin)
    cuda_build.check(
        lib.cedar_sweep3_ring(dt, so.data_ptr(), q_in.data_ptr(),
                              b.data_ptr(), q_out.data_ptr(), _ptr(extra),
                              _ptr(extra), *q_in.shape, _pack(colors), ox,
                              oy, oz, mode, *_plan_args(p),
                              cuda_build.stream_of(q_in)),
        "sweep3_ring",
    )
    sweep_launches += 1
    return q_out, extra


def _run(lib, dt: int, so, q, b, kind: StencilKind, launches, origin,
         mode: int):
    """The K14 launches of ``launches`` (:func:`passes`: a 7-point ring
    launch, or 27-point marches and a window-design K14) in turn from
    ``q``, the last with epilogue ``mode``; returns ``(q_out, res or
    partials or None)``.  The marches write two buffers in turn (a march
    reads the other one), never ``q``."""
    global sweep_launches
    extra = spare = None
    owned = False  # q is a buffer of this call's
    ox, oy, oz = (int(o) for o in origin)
    for kernel, colors in launches:
        if kernel == "ring":
            q, extra = _ring_pass(lib, dt, so, q, b, colors, origin, mode)
            continue
        if kernel == "K14":
            q, extra = _window_pass(lib, dt, so, q, b, colors, origin, mode)
            continue
        m = _stages_of(lib)
        p = pass27_plan(q.element_size(), tuple(q.shape), _n_sm(q.device),
                        m)
        q_out = torch.empty_like(q) if spare is None else spare
        cuda_build.check(
            lib.cedar_pass27(dt, so.data_ptr(), q.data_ptr(), b.data_ptr(),
                             q_out.data_ptr(), *q.shape, _pack(colors, m),
                             ox, oy, oz, *_plan_args(p),
                             cuda_build.stream_of(q)),
            "pass27",
        )
        sweep_launches += 1
        spare = q if owned else None
        q, owned = q_out, True
    return q, extra


def sweep(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
          kind: StencilKind, updown: str, fuse_residual: bool = False,
          origin=(0, 0, 0), fuse_norm: bool = False):
    """K14: one whole multicolour sweep on the card, out of place (one
    ring launch 7-point; 27-point a march of :data:`PASS27_STAGES` colours
    a launch, the last colour by itself where ``mode`` asks for an
    epilogue).

    Returns ``q_new``, ``(q_new, res)`` with ``fuse_residual`` or
    ``(q_new, partials)`` with ``fuse_norm``."""
    return _sweep(None, so, q, b, kind, updown, fuse_residual, origin,
                  fuse_norm)


def _sweep(lib, so, q, b, kind, updown, fuse_residual=False,
           origin=(0, 0, 0), fuse_norm=False):
    """:func:`sweep` with the library ``lib`` (a build of csrc/fused3.cu;
    None: the default one), as tools/tune_fused3.py times them."""
    relax3.check_sweep(so, q, b, kind)
    dt = cuda_build.check_operands(so, q, b)
    return launch_sweep(dt, so, q, b, kind, updown, fuse_residual, origin,
                        fuse_norm, lib)


def launch_sweep(dt: int, so, q, b, kind: StencilKind, updown: str,
                 fuse_residual: bool = False, origin=(0, 0, 0),
                 fuse_norm: bool = False, lib=None):
    """The launches of :func:`sweep` on operands already checked
    (:func:`relax3.check_sweep`, :func:`cuda_build.check_operands`, whose
    dtype code is ``dt``), with the build ``lib`` (None: the default one):
    the entry of K6's levels that run on K14 (:mod:`cuda3`)."""
    lib = lib or cuda_build.load("fused3")
    mode = _mode(fuse_residual, fuse_norm)
    launches = passes(_stages_of(lib), kind, updown, "sweep", mode)
    return _result(*_run(lib, dt, so, q, b, kind, launches, origin, mode),
                   mode)


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
    relax3.check_sweep(so, q, b, kind)
    nxc, nyc, nzc = _coarse_shape(ci, q.shape)
    dt = cuda_build.check_operands(so, q, b, ci)
    lib = lib or cuda_build.load("fused3")
    ts = kind == StencilKind.twenty_seven_pt
    *first, (_, last) = passes(_stages_of(lib), kind, updown, "restrict")
    q, _ = _run(lib, dt, so, q, b, kind, first, (0, 0, 0), _NONE)
    q_out = torch.empty_like(q)
    res = torch.empty_like(q) if emit_res else None
    cb = q.new_empty((nxc, nyc, nzc))
    p = plan(q.element_size(), ts, False, _RESTRICT, tuple(q.shape),
             _n_sm(q.device), ty)
    cuda_build.check(
        lib.cedar_sweep_restrict3(dt, so.data_ptr(), q.data_ptr(),
                                  b.data_ptr(), ci.data_ptr(),
                                  q_out.data_ptr(), _ptr(res), cb.data_ptr(),
                                  *q.shape, nxc, nyc, nzc, int(ts),
                                  _pack(last), int(emit_res),
                                  *_plan_args(p),
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
    relax3.check_sweep(so, q_pre, b, kind)
    nxc, nyc, nzc = _coarse_shape(ci, q_pre.shape)
    _check_qc(qc, (nxc, nyc, nzc))
    dt = cuda_build.check_operands(ci, qc, so, b, q_pre)
    lib = lib or cuda_build.load("fused3")
    mode = _mode(fuse_residual, fuse_norm)
    ts = kind == StencilKind.twenty_seven_pt
    (_, first), *rest = passes(_stages_of(lib), kind, updown, "interp",
                                mode)
    mode16 = _NONE if rest else mode
    p = plan(q_pre.element_size(), ts, True, mode16, tuple(q_pre.shape),
             _n_sm(q_pre.device), ty)
    q_out = torch.empty_like(q_pre)
    extra = _extra(q_pre, mode16, p.blocks)
    cuda_build.check(
        lib.cedar_interp_sweep3(dt, ci.data_ptr(), qc.data_ptr(),
                                so.data_ptr(), b.data_ptr(),
                                q_pre.data_ptr(), q_out.data_ptr(),
                                _ptr(extra), _ptr(extra), *q_pre.shape,
                                nxc, nyc, nzc, int(ts), _pack(first),
                                mode16,
                                *_plan_args(p),
                                cuda_build.stream_of(q_pre)),
        "interp_sweep3",
    )
    interp_sweep_launches += 1
    if rest:
        q_out, extra = _run(lib, dt, so, q_out, b, kind, rest, (0, 0, 0),
                            mode)
    return _result(q_out, extra, mode)


def sweep_plain(so, q, b, kind: StencilKind, updown: str,
                fuse_residual: bool = False, origin=(0, 0, 0),
                fuse_norm: bool = False):
    """:func:`sweep` in torch ops, on any device."""
    global sweep_plain_calls
    sweep_plain_calls += 1
    relax3.check_sweep(so, q, b, kind)
    return fused3.sweep_split3_torch(so, q, b, kind, updown, fuse_residual,
                                     origin, fuse_norm)


def sweep_restrict_plain(so, q, b, ci, kind: StencilKind, updown: str,
                         emit_res: bool = True):
    """:func:`sweep_restrict` in torch ops, on any device."""
    global sweep_restrict_plain_calls
    sweep_restrict_plain_calls += 1
    relax3.check_sweep(so, q, b, kind)
    _coarse_shape(ci, q.shape)
    return fused3.sweep_restrict3_torch(so, q, b, ci, kind, updown, emit_res)


def interp_sweep_plain(ci, qc, so, b, q_pre, kind: StencilKind, updown: str,
                       fuse_residual: bool = False, fuse_norm: bool = False):
    """:func:`interp_sweep` in torch ops, on any device."""
    global interp_sweep_plain_calls
    interp_sweep_plain_calls += 1
    relax3.check_sweep(so, q_pre, b, kind)
    _check_qc(qc, _coarse_shape(ci, q_pre.shape))
    return fused3.interp_sweep3_torch(ci, qc, so, b, q_pre, kind, updown,
                                      fuse_residual, fuse_norm)
