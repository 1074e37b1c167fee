"""K14 (fused sweep), K15 (sweep + residual + restriction) and K16
(interp-add + sweep): the fused 3D fine-level kernels (CUDA) and their
plain versions.

Counterpart of :mod:`cedar_tpu.ops.pallas3_split` (``point_relax_split3``,
``sweep_restrict_split3``, ``interp_sweep_split3``) and of the wavefront
kernels of :mod:`cedar_tpu.ops.pallas3_stream`.  :func:`sweep`,
:func:`sweep_restrict` and :func:`interp_sweep` launch ``csrc/fused3.cu``
and ``csrc/edge3.cu`` on the tensors' current stream;
:func:`sweep_plain`, :func:`sweep_restrict_plain` and
:func:`interp_sweep_plain` compute the same functions in torch ops
(:mod:`cedar_tpu_torch.ops.fused3`, which picks one by device).

7-point: a kernel launch runs one pass, both colours of a sweep with its
epilogue (the ring design: K14, K15, K16).  27-point: the sweep runs on
K6's route (:func:`cedar_tpu_torch.ops.cuda3.launch`: resident, a launch a
colour, or K14's marches of up to :data:`PASS27_STAGES` colours a launch,
``cedar_fused3_pass27_stages``, in groups aligned to the colour order, so
that the colours of a march share their y and z parities), and the rest
of K15 and K16 is a launch of the edge kernel (:func:`edge`): K15 the
sweep, then the residual and its restriction; K16 the interpolation of
the recomputed residual, then the sweep; a sweep whose norm is asked for
is followed by an edge launch in mode norm, one whose residual is asked
for takes K6's.  :func:`launch_list` lists the launches of each.  K6
(:mod:`cedar_tpu_torch.ops.cuda3`) runs its largest levels on K14's
launches through :func:`launch_sweep`.  Each launch adds one to the count
of the kernel it launches (``*_launches``; the sweeps of a 27-point K15
or K16 count as K6's); ``*_plain_calls`` count plain-version calls.

All of them read ``q`` and return a new iterate: a kernel block reads
``q`` over its region and a halo while other blocks write theirs, so the
kernels work out of place.

The 7-point K14-K16 launch on a :func:`plan`, the 27-point K14 on a
:func:`pass27_plan`, the edge kernel on an :func:`edge_plan`, that this
module computes from the shapes and the card's SM count and passes to the
kernel: tile rows, x chunk, grid and shared-memory bytes (the launch
checks them against the kernel's own), and so the number of norm
partials (csrc/fused3.cu's and csrc/edge3.cu's header notes).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda3, cuda_build, fused3, interp3, relax3
from cedar_tpu_torch.ops.cuda_build import BLOCK_SMEM, SM_SMEM
from cedar_tpu_torch.ops.cuda_transfer3 import _check_qc, _coarse_shape
from cedar_tpu_torch.ops.stencil3 import residual

sweep_launches = 0
sweep_restrict_launches = 0
interp_sweep_launches = 0
edge_launches = 0
sweep_plain_calls = 0
sweep_restrict_plain_calls = 0
interp_sweep_plain_calls = 0
edge_plain_calls = 0

# output modes of K14 and K16, K15's, and the edge kernel's interpolation
# (csrc/fused3.cu, csrc/edge3.cu)
_NONE, _RES, _NORM, _RESTRICT, _INTERP = 0, 1, 2, 3, 4
#: the edge kernel's modes by name (:func:`edge`)
EDGE_MODES = {"restrict": _RESTRICT, "res": _RES, "norm": _NORM,
              "interp": _INTERP}

#: region columns (z) of the 7-point K14-K16 and the 27-point K14
#: (csrc/fused3.cu ``kRW``)
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
#: colours a 27-point K14 march (and launch) takes (csrc/fused3.cu
#: ``kStages27``; a build with ``-DCEDAR_K14_STAGES=m`` takes m), the
#: values a point's stencil slots hold (``kVals``) and the colour code that
#: names no colour (``kNoColor``)
PASS27_STAGES, PASS27_VALS, NO_COLOR = 2, 28, 15
#: the edge kernel's threads a block and own tile columns in float32 and
#: float64 (csrc/edge3.cu ``kThreads``, ``Edge::TZ``; :func:`_edge_of`
#: reads a build's)
EDGE_BUILD = (512, 64, 32)


def pass27_warps(stages: int = PASS27_STAGES) -> int:
    """The most warps a 27-point K14 block takes (csrc/fused3.cu
    ``kMaxWarps27``): 12 where each thread gathers its stencil values for
    3 or 4 colour stages (170 registers a thread), else 16."""
    return 12 if 3 <= stages <= 4 else 16


def _stages(interp: bool, mode: int) -> tuple[int, int, int]:
    """(stage of the last colour phase, of the epilogue, halo H) of a
    7-point pass (csrc/fused3.cu ``last_phase``, ``epi_stage``,
    ``halo``)."""
    sp = int(interp) + 2
    se = sp + (mode != _NONE)
    return sp, se, se + (mode == _RESTRICT)


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
    _, se, h = _stages(interp, mode)
    pl, tz = (ty + 2 * h) * RW, RW - 2 * h
    nsb = 5 if itemsize == 4 else 1
    words = (_rnd4((se + 1 if interp else se + 3) * pl)
             + _rnd4((4 if interp else 0) * pl) + _rnd4((se + 2) * nsb * pl))
    if mode == _RESTRICT:
        words += (_rnd4(2 * 26 * (ty // 2 + 1) * (tz // 2 + 1))
                  + 4 * (ty + 1) * (tz + 1))
    return words


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


def edge_words(itemsize: int, mode: int, ty: int, tz: int) -> int:
    """Shared-memory words of an edge block in ``mode`` with tiles of
    ``ty`` x ``tz`` points (csrc/edge3.cu ``Edge<...>::words``): over the
    residual window (the tile, and for ``_RESTRICT`` its low ring), four q
    planes with a ring of halo and three x-planes of the 14 stencil arrays
    with a high ring, in rows of ``tz`` + 32 bytes (the tile's columns
    between 16-byte margins), and for ``_RESTRICT`` four residual planes."""
    lo = int(mode == _RESTRICT)
    rr, rc, pw = ty + lo, tz + lo, tz + 2 * (16 // itemsize)
    return 4 * (rr + 2) * pw + 3 * 14 * (rr + 1) * pw + 4 * lo * rr * rc


@dataclass(frozen=True)
class Plan:
    """A launch of the 7-point K14-K16 or the 27-point K14: tiles of
    ``ty`` x ``tz`` owned points in a region with a halo of ``h``, x
    chunks of ``cx`` planes, a ``(gz, gy, gc)`` grid of blocks of
    ``warps`` warps and ``smem`` bytes, ``per_sm`` blocks resident an
    SM."""
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

    @property
    def blocks(self) -> int:
        """The blocks of the launch, and the norm partials it writes."""
        return self.gz * self.gy * self.gc


@functools.lru_cache(maxsize=256)
def plan(itemsize: int, interp: bool, mode: int, shape, n_sm: int = 132,
         ty: int | None = None, blocks14: int = RING14_BLOCKS) -> Plan:
    """The launch of the 7-point K15 (``interp`` false, ``mode``
    _RESTRICT), K16 or K14 (``interp`` false, another mode) on an ``(nx,
    ny, nz)`` grid for a card of ``n_sm`` SMs (the ring design): the tile
    rows ``ty``, or the largest :data:`RING_ROWS` option that fits a block
    (K14: its build's, by default :data:`RING14_ROWS`), then the x chunk
    whose grid runs in the fewest steps a resident block slot (K14: as many
    blocks an SM as fit, at most the ``blocks14`` its build caps its
    registers for), of an even length.  Tiles and chunks start at even
    indices, as K15's restriction needs."""
    nx, ny, nz = shape
    _, _, h = _stages(interp, mode)
    tz = RW - 2 * h
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
    return Plan(ty, tz, h, cx, gz, gy, gc, size[ty], ty + 2 * h, per_sm(ty))


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
    return Plan(ty, tz, h, cx, gz, gy, gc, smem, warps, per_sm)


@dataclass(frozen=True)
class EdgePlan:
    """An edge launch: tiles of ``ty`` x ``tz`` owned points, x chunks of
    ``cx`` planes, a ``(gz, gy, gc)`` grid of blocks of ``threads``
    threads and ``smem`` bytes, ``per_sm`` blocks resident an SM."""
    ty: int
    tz: int
    cx: int
    gz: int
    gy: int
    gc: int
    smem: int
    threads: int
    per_sm: int

    @property
    def blocks(self) -> int:
        """The blocks of the launch, and the norm partials it writes."""
        return self.gz * self.gy * self.gc


@functools.lru_cache(maxsize=256)
def edge_plan(itemsize: int, mode: int, shape, n_sm: int = 132,
              build: tuple[int, int, int] = EDGE_BUILD) -> EdgePlan:
    """The edge launch in ``mode`` on an ``(nx, ny, nz)`` grid for a card
    of ``n_sm`` SMs and the kernel ``build`` (its threads a block and own
    tile columns in float32 and float64, :func:`_edge_of`): the fewest
    tiles along y whose rows (even, at most the most whose block fits and
    whose window holds at most two points a thread) cover the grid, those
    rows as few as do it, then the x chunk whose grid
    runs in the fewest steps a resident block slot (a block steps through
    its chunk and 2 (``_RESTRICT``) or 1 halo steps at each end).  Tiles
    and chunks start at even indices, as the restriction needs."""
    nx, ny, nz = shape
    threads, tz = build[0], build[1 if itemsize == 4 else 2]
    lo = int(mode == _RESTRICT)
    fit = [t for t in range(2, 129, 2)
           if edge_words(itemsize, mode, t, tz) * itemsize <= BLOCK_SMEM
           and (t + lo) * (tz + lo) <= 2 * threads]
    if not fit:
        raise ValueError("no edge tile fits a block")
    ty = -(-ny // -(-ny // max(fit)))
    ty += ty & 1
    gz, gy = -(-nz // tz), -(-ny // ty)
    smem = edge_words(itemsize, mode, ty, tz) * itemsize
    per_sm = min(SM_SMEM // (smem + 1024), 2048 // threads)
    cx, gc = cuda_build.chunk(nx, gz * gy, n_sm * per_sm,
                              2 if mode == _RESTRICT else 1)
    return EdgePlan(ty, tz, cx, gz, gy, gc, smem, threads, per_sm)



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
def _edge_of(lib) -> tuple[int, int, int]:
    """The edge kernel's threads a block and own tile columns in float32
    and float64 in build ``lib`` (:data:`EDGE_BUILD`), read once."""
    return (lib.cedar_edge3_threads(), lib.cedar_edge3_cols(0),
            lib.cedar_edge3_cols(1))


@functools.lru_cache(maxsize=None)
def passes(stages: int, kind: StencilKind, updown: str,
           role: str = "sweep") -> tuple[tuple[str, tuple[int, ...]], ...]:
    """The K14-K16 launches of one sweep in order, each ``(kernel,
    colours)`` in :func:`relax3.color_order`'s codes: 7-point one launch of
    both colours (the ring K14, K15 or K16 by ``role``: "sweep",
    "restrict" or "interp": "ring", "K15", "K16"); 27-point a K14 march
    ("pass27") for each block of ``stages`` positions of the colour order,
    whatever the role (a 27-point K15 or K16 sweeps on K6's route,
    :func:`launch_list`, which runs these marches where its plan is
    ``pass27``)."""
    order = tuple(relax3.color_order(kind, updown))
    if kind != StencilKind.twenty_seven_pt:
        return (({"sweep": "ring", "restrict": "K15", "interp": "K16"}[role],
                 order),)
    return tuple(("pass27", order[j:j + stages])
                 for j in range(0, len(order), stages))


def launch_list(itemsize: int, kind: StencilKind, shape, updown: str,
                role: str = "sweep", mode: int = _NONE,
                stages: int = PASS27_STAGES,
                build: tuple[int, int] | None = None):
    """The kernel launches of one K14 (``role`` "sweep", with the epilogue
    ``mode``), K15 ("restrict") or K16 ("interp", with ``mode``) call on an
    ``(nx, ny, nz)`` grid, in order, each ``(kernel, what)`` by the name
    of the count it adds to (chip_smoke.py's kernel table): 7-point one
    ring launch (K14 "sweep3_fused", K15 "sweep_restrict3", K16
    "interp_sweep3"); 27-point K16's interpolation ("edge27"), the sweep on
    K6's route (:func:`cuda3.launch_list` on :func:`cuda3.plan` for the K6
    ``build``, default its own, with K6's residual for ``_RES``), then
    K15's restriction or the norm ("edge27")."""
    if kind != StencilKind.twenty_seven_pt:
        name = {"sweep": "sweep3_fused", "restrict": "sweep_restrict3",
                "interp": "interp_sweep3"}[role]
        return ((name, "ring"),)
    p = cuda3.plan(itemsize, True, tuple(shape),
                   *(() if build is None else (build,)))
    head = (("edge27", "interp"),) if role == "interp" else ()
    body = cuda3.launch_list(p, kind, updown,
                             mode == _RES and role != "restrict", stages)
    tail = ((("edge27", "restrict"),) if role == "restrict" else
            (("edge27", "norm"),) if mode == _NORM else ())
    return head + body + tail


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


def _plan_args(p):
    return (p.ty, p.cx, p.gz, p.gy, p.gc, p.smem)


def _ring_pass(lib, dt: int, so, q_in, b, colors, origin, mode: int):
    """One 7-point K14 launch of the ring design: the whole sweep
    (``colors``) with epilogue ``mode``, on :func:`plan` for the build
    ``lib``; returns ``(q_out, res or partials or None)``."""
    global sweep_launches
    rows, blocks = _ring14_of(lib)
    itemsize = q_in.element_size()
    p = plan(itemsize, False, mode, tuple(q_in.shape),
             cuda_build.n_sm(q_in.device),
             rows[itemsize], blocks)
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


def _marches(lib, dt: int, so, q, b, launches, origin):
    """The 27-point K14 marches of ``launches`` (:func:`passes`) in turn
    from ``q``; returns the new iterate.  The marches write two buffers in
    turn (a march reads the other one), never ``q``."""
    global sweep_launches
    spare = None
    owned = False  # q is a buffer of this call's
    ox, oy, oz = (int(o) for o in origin)
    m = _stages_of(lib)
    p = pass27_plan(q.element_size(), tuple(q.shape),
                    cuda_build.n_sm(q.device), m)
    for _, colors in launches:
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
    return q


def sweep(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
          kind: StencilKind, updown: str, fuse_residual: bool = False,
          origin=(0, 0, 0), fuse_norm: bool = False):
    """K14: one whole multicolour sweep on the card, out of place: 7-point
    one ring launch with its epilogue; 27-point the sweep on K6's route
    (with K6's residual for ``fuse_residual``), then an edge launch for
    ``fuse_norm``.

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
    mode = _mode(fuse_residual, fuse_norm)
    if kind == StencilKind.twenty_seven_pt:
        return _sweep27(dt, so, q, b, kind, updown, mode, origin, lib)
    return launch_sweep(dt, so, q, b, kind, updown, fuse_residual, origin,
                        fuse_norm, lib)


def _sweep27(dt: int, so, q, b, kind, updown, mode: int, origin=(0, 0, 0),
             lib=None):
    """A 27-point sweep on K6's route (with K6's residual for ``_RES``),
    then the edge kernel's norm for ``_NORM`` (:func:`launch_list`)."""
    out = cuda3.launch(dt, so, q, b, kind, updown, mode == _RES, origin, lib)
    if mode == _NORM:
        return out, launch_edge(dt, _NORM, so, out, b)
    return out


def launch_sweep(dt: int, so, q, b, kind: StencilKind, updown: str,
                 fuse_residual: bool = False, origin=(0, 0, 0),
                 fuse_norm: bool = False, lib=None):
    """K14's own launches on operands already checked
    (:func:`relax3.check_sweep`, :func:`cuda_build.check_operands`, whose
    dtype code is ``dt``), with the build ``lib`` (None: the default one):
    7-point the ring with its epilogue, 27-point the marches of
    :func:`passes`, which take no epilogue.  The entry of K6's levels that
    run on K14 (:mod:`cuda3`)."""
    lib = lib or cuda_build.load("fused3")
    mode = _mode(fuse_residual, fuse_norm)
    if kind != StencilKind.twenty_seven_pt:
        return _result(*_ring_pass(lib, dt, so, q, b,
                                   relax3.color_order(kind, updown), origin,
                                   mode), mode)
    if mode != _NONE:
        raise ValueError("a 27-point K14 march takes no epilogue")
    return _marches(lib, dt, so, q, b,
                    passes(_stages_of(lib), kind, updown), origin)


def sweep_restrict(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
                   ci: torch.Tensor, kind: StencilKind, updown: str,
                   emit_res: bool = True):
    """K15: the sweep, its residual and ``cb = Pᵀ res`` on the card
    (7-point one ring launch; 27-point the sweep on K6's route, then the
    edge kernel's restriction); returns ``(q_new, res or None, cb)``."""
    return _sweep_restrict(None, None, so, q, b, ci, kind, updown,
                           emit_res)


def _sweep_restrict(lib, ty, so, q, b, ci, kind, updown, emit_res):
    """:func:`sweep_restrict` with the library ``lib`` (a build of
    csrc/fused3.cu; None: the default one) and the 7-point tile rows ``ty``
    (None: the plan's), as tools/tune_fused3.py times them."""
    global sweep_restrict_launches
    relax3.check_sweep(so, q, b, kind)
    nxc, nyc, nzc = _coarse_shape(ci, q.shape)
    dt = cuda_build.check_operands(so, q, b, ci)
    if kind == StencilKind.twenty_seven_pt:
        q_out = cuda3.launch(dt, so, q, b, kind, updown)
        res, cb = launch_edge(dt, _RESTRICT, so, q_out, b, ci,
                              emit_res=emit_res)
        return q_out, res, cb
    lib = lib or cuda_build.load("fused3")
    q_out = torch.empty_like(q)
    res = torch.empty_like(q) if emit_res else None
    cb = q.new_empty((nxc, nyc, nzc))
    p = plan(q.element_size(), False, _RESTRICT, tuple(q.shape),
             cuda_build.n_sm(q.device), ty)
    cuda_build.check(
        lib.cedar_sweep_restrict3(dt, so.data_ptr(), q.data_ptr(),
                                  b.data_ptr(), ci.data_ptr(),
                                  q_out.data_ptr(), _ptr(res), cb.data_ptr(),
                                  *q.shape, nxc, nyc, nzc,
                                  relax3.pack_colors(kind, updown),
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
    card (7-point one ring launch; 27-point the edge kernel's
    interpolation, then the sweep as :func:`sweep` runs it); returns
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
    mode = _mode(fuse_residual, fuse_norm)
    if kind == StencilKind.twenty_seven_pt:
        q = launch_edge(dt, _INTERP, so, q_pre, b, ci, qc)
        return _sweep27(dt, so, q, b, kind, updown, mode)
    lib = lib or cuda_build.load("fused3")
    p = plan(q_pre.element_size(), True, mode, tuple(q_pre.shape),
             cuda_build.n_sm(q_pre.device), ty)
    q_out = torch.empty_like(q_pre)
    extra = _extra(q_pre, mode, p.blocks)
    cuda_build.check(
        lib.cedar_interp_sweep3(dt, ci.data_ptr(), qc.data_ptr(),
                                so.data_ptr(), b.data_ptr(),
                                q_pre.data_ptr(), q_out.data_ptr(),
                                _ptr(extra), _ptr(extra), *q_pre.shape,
                                nxc, nyc, nzc,
                                relax3.pack_colors(kind, updown), mode,
                                *_plan_args(p),
                                cuda_build.stream_of(q_pre)),
        "interp_sweep3",
    )
    interp_sweep_launches += 1
    return _result(q_out, extra, mode)


def edge(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor, mode: str,
         ci: torch.Tensor | None = None, qc: torch.Tensor | None = None,
         emit_res: bool = False):
    """The edge kernel on a 27-point level, one launch (csrc/edge3.cu), by
    ``mode`` (:data:`EDGE_MODES`): "restrict" ``(b - A q or None, cb = Pᵀ
    (b - A q))``, the residual written with ``emit_res``; "res" ``b - A
    q``; "norm" the partials, whose sum is ``‖b - A q‖²``; "interp" ``q +
    (b - A q)/diag + P qc`` (``q`` is the pre-smoothed iterate).  ``ci`` is
    the coarse level's CI (restrict, interp), ``qc`` the coarse values
    (interp).  Returns new tensors."""
    m = EDGE_MODES[mode]
    relax3.check_sweep(so, q, b, StencilKind.twenty_seven_pt)
    coarse = ()
    if m in (_RESTRICT, _INTERP):
        nc = _coarse_shape(ci, q.shape)
        coarse = (ci,)
        if m == _INTERP:
            _check_qc(qc, nc)
            coarse = (ci, qc)
    dt = cuda_build.check_operands(so, q, b, *coarse)
    return launch_edge(dt, m, so, q, b, ci, qc, emit_res)


def launch_edge(dt: int, mode: int, so, q, b, ci=None, qc=None,
                emit_res: bool = False, lib=None):
    """An edge launch in ``mode`` (``_RESTRICT``, ``_RES``, ``_NORM``,
    ``_INTERP``) on operands already checked (as :func:`edge` checks them;
    dtype code ``dt``), on :func:`edge_plan` for the build ``lib`` (None:
    the default one): the entry of K6's 27-point residual
    (:mod:`cuda3`).  Returns what :func:`edge` does."""
    global edge_launches
    lib = lib or cuda_build.load("edge3")
    p = edge_plan(q.element_size(), mode, tuple(q.shape),
                  cuda_build.n_sm(q.device), _edge_of(lib))
    res, nc = None, (0, 0, 0)
    if mode == _RESTRICT:
        nc = _coarse_shape(ci, q.shape)
        out = q.new_empty(nc)
        res = torch.empty_like(q) if emit_res else None
    elif mode == _NORM:
        out = q.new_empty(p.blocks)
    else:
        out = torch.empty_like(q)
        if mode == _INTERP:
            nc = tuple(qc.shape)
    cuda_build.check(
        lib.cedar_edge3(dt, mode, so.data_ptr(), q.data_ptr(), b.data_ptr(),
                        _ptr(ci), _ptr(qc), out.data_ptr(), _ptr(res),
                        *q.shape, *nc, int(emit_res), *_plan_args(p),
                        cuda_build.stream_of(q)),
        "edge3",
    )
    edge_launches += 1
    return (res, out) if mode == _RESTRICT else out


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


def edge_plain(so, q, b, mode: str, ci=None, qc=None,
               emit_res: bool = False):
    """:func:`edge` in torch ops (:func:`stencil3.residual`,
    :func:`interp3.restrict_torch`, :func:`interp3.interp_add_torch`), on
    any device."""
    global edge_plain_calls
    edge_plain_calls += 1
    m = EDGE_MODES[mode]
    kind = StencilKind.twenty_seven_pt
    relax3.check_sweep(so, q, b, kind)
    if m in (_RESTRICT, _INTERP):
        nc = _coarse_shape(ci, q.shape)
        if m == _INTERP:
            _check_qc(qc, nc)
    r = residual(so, q, b, kind)
    if m == _RESTRICT:
        return (r if emit_res else None), interp3.restrict_torch(ci, r)
    if m == _RES:
        return r
    if m == _NORM:
        return torch.sum(r * r).reshape(1)
    return interp3.interp_add_torch(ci, so, qc, r, q)
