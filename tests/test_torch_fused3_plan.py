"""The launch plans of the fused 3D kernels: ``cuda_fused3.plan`` (the
7-point K15, K16 and K14, the ring design), ``pass27_plan`` (the 27-point
K14's marches) and ``edge_plan`` (the 27-point edge kernel of K15 and
K16), which the wrappers compute and pass to the kernels (csrc/fused3.cu
and csrc/edge3.cu check them against their own layouts at launch); and
the launches of a 27-point K14, K15 and K16 call (``launch_list``).  Pure
Python, no card: for both dtypes and every output mode, at the paths'
shapes and at shapes that hit the tiling's edges, the shared memory fits
as many blocks an SM as are planned, the blocks' own points cover the
grid exactly once, K15's coarse points have one owner each, and the norm
partials are one a block.
"""

import itertools

import numpy as np
import pytest

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda3, relax3
from cedar_tpu_torch.ops import cuda_fused3 as cf

# (interp, mode): K15, K16 with each output mode, the 7-point K14 with
# each output mode
VARIANTS = [(False, cf._RESTRICT), (True, cf._NONE), (True, cf._RES),
            (True, cf._NORM), (False, cf._NONE), (False, cf._RES),
            (False, cf._NORM)]
# the paths' shapes (256³ 7-point, 128³ 27-point, the f64 gates) and edge
# shapes: nz not a multiple of 4, nx not a multiple of the chunk, ny
# smaller than one tile, more work items than resident blocks
SHAPES = [(256, 256, 256), (128, 128, 128), (33, 21, 17), (65, 65, 65),
          (5, 4, 3), (97, 45, 131), (67, 33, 45), (70, 13, 67), (9, 3, 30),
          (200, 200, 200)]
N_SM = 132
# one block's most shared memory (227 KB) and an SM's (228 KB)
BLOCK_MAX, SM_MAX = 232448, 233472


# the 7-point ring variants by itemsize
CASES = [(itemsize, interp, mode) for itemsize, (interp, mode)
         in itertools.product((4, 8), VARIANTS)]


def _ids(c):
    itemsize, interp, mode = c
    name = ("K16" if interp else "K15" if mode == cf._RESTRICT
            else "K14")
    return f"{'f32' if itemsize == 4 else 'f64'}-7pt-{name}-m{mode}"


def _coarse(n):
    return (n + 1) // 2


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_shared_memory_fits(case):
    """The plan's block fits an SM as many times as it plans: one block of
    a warp a region row, its tile the largest built option that fits."""
    itemsize, interp, mode = case
    p = cf.plan(itemsize, interp, mode, (64, 64, 64), N_SM)
    assert p.smem + 1024 <= BLOCK_MAX
    assert p.per_sm * (p.smem + 1024) <= SM_MAX
    assert p.warps * 32 * p.per_sm <= 2048
    k14 = cf.is_k14(interp, mode)
    rows = ((cf.RING14_ROWS[itemsize],) if k14
            else cf.RING_ROWS[itemsize])
    sizes = {t: cf.ring_words(itemsize, interp, mode, t) * itemsize
             for t in rows}
    assert p.smem == sizes[p.ty]
    assert p.ty == max(t for t, s in sizes.items() if s <= cf.BLOCK_SMEM)
    assert p.warps == p.ty + 2 * p.h
    assert p.per_sm == (min(cf.RING14_BLOCKS, SM_MAX // (p.smem + 1024),
                            2048 // (32 * p.warps)) if k14 else 1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_owned_points_cover_the_grid_once(case, shape):
    """The blocks' own boxes (tile ty x tz, chunk cx, clipped to the grid)
    tile the grid: disjoint, and their volumes add up to it; tiles and
    chunks start at even indices; the grid's blocks are the partials."""
    itemsize, interp, mode = case
    nx, ny, nz = shape
    p = cf.plan(itemsize, interp, mode, shape, N_SM)
    assert p.tz == cf.RW - 2 * p.h and p.h >= 1
    assert p.ty % 2 == 0 and p.tz % 2 == 0 and p.cx % 2 == 0
    assert (p.gz - 1) * p.tz < nz <= p.gz * p.tz
    assert (p.gy - 1) * p.ty < ny <= p.gy * p.ty
    assert (p.gc - 1) * p.cx < nx <= p.gc * p.cx
    own = [min(p.cx, nx - c * p.cx) * min(p.ty, ny - y * p.ty)
           * min(p.tz, nz - z * p.tz)
           for c in range(p.gc) for y in range(p.gy) for z in range(p.gz)]
    assert min(own) > 0 and sum(own) == nx * ny * nz
    assert p.blocks == len(own)


@pytest.mark.parametrize("shape", [(9, 7, 5), (5, 4, 3), (33, 21, 17),
                                   (20, 3, 130), (67, 33, 45)])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_every_point_has_one_owner(case, shape):
    """Point by point at small shapes: each fine point lies in exactly one
    block's own box, and for K15 each coarse point (2i, 2j, 2k) too, so
    that it has exactly one owner of its restriction."""
    itemsize, interp, mode = case
    nx, ny, nz = shape
    p = cf.plan(itemsize, interp, mode, shape, n_sm=4)
    fine = np.zeros(shape, dtype=int)
    coarse = np.zeros((_coarse(nx), _coarse(ny), _coarse(nz)), dtype=int)
    for c, y, z in itertools.product(range(p.gc), range(p.gy),
                                     range(p.gz)):
        xt, yt, zt = c * p.cx, y * p.ty, z * p.tz
        fine[xt:xt + p.cx, yt:yt + p.ty, zt:zt + p.tz] += 1
        # K15: the block's coarse points, as the kernel walks them
        for xc in range(xt // 2, (min(xt + p.cx, nx) + 1) // 2):
            coarse[xc, yt // 2:yt // 2 + p.ty // 2,
                   zt // 2:zt // 2 + p.tz // 2] += 1
    assert (fine == 1).all()
    if mode == cf._RESTRICT:
        assert (coarse == 1).all()


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_grid_runs_in_few_waves(case):
    """At the path's size the plan's grid is no more waves of resident
    blocks than one chunk a tile would take, and a card with more SMs
    never gets more waves."""
    itemsize, interp, mode = case
    shape = (256,) * 3
    p = cf.plan(itemsize, interp, mode, shape, N_SM)
    slots = N_SM * p.per_sm
    waves = -(-p.blocks // slots)
    one_chunk = -(-(p.gz * p.gy) // slots)
    assert waves * (p.cx + 2 * p.h) <= one_chunk * (shape[0] + 2 * p.h)
    q = cf.plan(itemsize, interp, mode, shape, 2 * N_SM)
    assert -(-q.blocks // (2 * slots)) <= waves


def test_plan_takes_a_tile_override():
    """tools/tune_fused3.py times each built tile-row option of 7-point
    K15 and K16 and builds of the 7-point K14 with other tile rows
    (``-DCEDAR_K14_ROWS``): the plan takes each built K15/K16 option (each
    fits a block) and refuses one that is not built; it takes K14's rows
    where its block fits and refuses them where it does not."""
    for itemsize, (interp, mode) in itertools.product((4, 8), VARIANTS):
        k14 = cf.is_k14(interp, mode)
        for ty in ((cf.RING14_ROWS[itemsize], 12, 4) if k14
                   else cf.RING_ROWS[itemsize]):
            size = cf.ring_words(itemsize, interp, mode, ty) * itemsize
            assert size <= cf.BLOCK_SMEM
            assert cf.plan(itemsize, interp, mode, (64,) * 3,
                           ty=ty).ty == ty
        with pytest.raises(ValueError):
            cf.plan(itemsize, interp, mode, (64,) * 3,
                    ty=64 if k14 else 14)


def test_layouts_by_hand():
    """The shared-memory words against layouts worked out by hand (copies
    one step ahead): 7-point K16 f32 with the norm, 8 tile rows; 7-point
    K15 f32, 8 rows (q, b and stencil slots, two CI planes, four residual
    planes)."""
    h, ry = 4, 16
    pl = ry * 64
    q, pre, sb = 5 * pl, 4 * pl, 6 * 5 * pl
    assert cf.ring_words(4, True, cf._NORM, 8) == q + pre + sb
    assert cf.plan(4, True, cf._NORM, (256,) * 3).ty == 12
    assert h == cf._stages(True, cf._NORM)[2]
    tz = 56
    ci = 2 * 26 * 5 * 29
    words = 6 * pl + 5 * 5 * pl + ci + (-ci) % 4 + 4 * 9 * (tz + 1)
    assert cf.ring_words(4, False, cf._RESTRICT, 8) == words


def test_k14_ring_layout_by_hand():
    """The 7-point K14 (the ring design with the colour stages only, H = 2,
    copies one step ahead) against a layout worked out by hand: f32, 20
    tile rows, 24 region rows (24 warps): 5 q slots and 4 slots of b and
    the 4 stencil planes, 25 planes of 24 x 64 words (150 KB, one block an
    SM); with the residual H = 3, 26 region rows and 31 planes (201 KB);
    a build on 12 tile rows two blocks an SM (100 KB each), as many as its
    registers are capped for; float64 8 rows, the stencil from device
    memory."""
    assert cf.RING14_BLOCKS == 2
    assert cf._stages(False, cf._NONE) == (2, 2, 2)
    assert cf.ring_words(4, False, cf._NONE, 20) == 25 * 24 * 64
    p = cf.plan(4, False, cf._NONE, (256,) * 3)
    assert (p.ty, p.h, p.warps, p.per_sm, p.gz, p.gy) == (20, 2, 24, 1, 5,
                                                          13)
    assert p.smem == 25 * 24 * 64 * 4
    p = cf.plan(4, False, cf._RES, (256,) * 3)
    assert (p.ty, p.h, p.smem) == (20, 3, 31 * 26 * 64 * 4)
    p = cf.plan(4, False, cf._NONE, (256,) * 3, ty=12)
    assert (p.ty, p.per_sm, p.smem) == (12, 2, 25 * 16 * 64 * 4)
    p = cf.plan(8, False, cf._NORM, (200,) * 3)
    assert (p.ty, p.h, p.smem) == (8, 3, (6 + 5) * 14 * 64 * 8)


# the 27-point K14 (`pass27`): every dtype, with the built colours a march
# and builds of other stages (tools/tune_fused3.py)
K14_CASES = list(itertools.product((4, 8), (cf.PASS27_STAGES, 1, 4)))


def _k14_ids(c):
    return f"{'f32' if c[0] == 4 else 'f64'}-K14-s{c[1]}"


@pytest.mark.parametrize("shape", [(128, 128, 128), (64, 512, 512)])
@pytest.mark.parametrize("case", K14_CASES, ids=_k14_ids)
def test_k14_shared_memory_fits(case, shape):
    """A 27-point K14 block fits an SM as many times as planned, with a
    warp for each pair of region rows (at most pass27_warps()), its tile
    the most even rows that fit; a march's halo is its colour stages; it
    stages the stencil (each thread's values and b a colour stage) in
    float32 only."""
    itemsize, stages = case
    p = cf.pass27_plan(itemsize, shape, N_SM, stages)
    h = stages
    assert p.h == h and p.tz == cf.RW - 2 * h
    assert p.smem == cf.pass27_words(itemsize, p.ty, stages) * itemsize
    assert p.smem + 1024 <= BLOCK_MAX
    assert p.per_sm >= 1 and p.per_sm * (p.smem + 1024) <= SM_MAX
    assert p.warps * 32 * p.per_sm <= 2048
    mw = cf.pass27_warps(stages)
    assert mw == (12 if stages == 4 else 16)
    assert 2 * p.warps == p.ty + 2 * h <= 2 * mw
    bigger = p.ty + 2
    assert (bigger + 2 * h > 2 * mw or
            cf.pass27_words(itemsize, bigger, stages) * itemsize
            > cf.BLOCK_SMEM)
    ring = (h + 4) * (p.ty + 2 * h) * cf.RW  # the q ring's words
    assert (cf.pass27_words(itemsize, p.ty, stages) > ring) == (
        itemsize == 4)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", K14_CASES, ids=_k14_ids)
def test_k14_owned_points_cover_the_grid_once(case, shape):
    """The 27-point K14 blocks' own boxes tile the grid, in whole waves of
    the resident blocks no longer than one chunk a tile would take."""
    itemsize, stages = case
    nx, ny, nz = shape
    p = cf.pass27_plan(itemsize, shape, N_SM, stages)
    assert p.ty % 2 == 0 and p.cx % 2 == 0
    assert (p.gz - 1) * p.tz < nz <= p.gz * p.tz
    assert (p.gy - 1) * p.ty < ny <= p.gy * p.ty
    assert (p.gc - 1) * p.cx < nx <= p.gc * p.cx
    own = [min(p.cx, nx - c * p.cx) * min(p.ty, ny - y * p.ty)
           * min(p.tz, nz - z * p.tz)
           for c in range(p.gc) for y in range(p.gy) for z in range(p.gz)]
    assert min(own) > 0 and sum(own) == nx * ny * nz
    assert p.blocks == len(own)
    slots = N_SM * p.per_sm
    waves = -(-p.blocks // slots)
    one_chunk = -(-(p.gz * p.gy) // slots)
    assert waves * (p.cx + 2 * p.h) <= one_chunk * (nx + 2 * p.h)


def test_k14_plan_takes_a_tile_override():
    """The 27-point K14 plan of a build with other stages a march (as
    tools/tune_fused3.py builds them) takes that build's halo, warps and
    staging: 4 stages, halo 4 and 12 warps; 8 stages, the stencil from
    device memory; and it refuses a build none of whose tiles fits."""
    p = cf.pass27_plan(4, (128,) * 3, stages=4)
    assert p.h == 4 and p.ty == 16 and p.warps == 12
    p = cf.pass27_plan(4, (128,) * 3, stages=8)
    assert p.h == 8 and p.smem == 12 * (p.ty + 16) * cf.RW * 4
    with pytest.raises(ValueError):
        cf.pass27_plan(4, (128,) * 3, stages=16)


def test_k14_layout_by_hand():
    """The 27-point K14 words against a layout worked out by hand: f32, 28
    tile rows, marches of 2 colours: H = 2, 32 region rows, 16 warps; a
    ring of 6 q planes of 32 x 64 and 2 x 28 values for each of 512
    threads (160 KB, one block an SM), and its 128³ grid of 120 blocks in
    one wave."""
    assert cf.PASS27_STAGES == 2
    assert cf.pass27_words(4, 28) == 6 * 32 * 64 + 2 * 28 * 512
    p = cf.pass27_plan(4, (128,) * 3)
    assert (p.ty, p.warps, p.per_sm, p.gz, p.gy, p.gc) == (
        28, 16, 1, 3, 5, 8)
    assert p.blocks == 120 <= N_SM


# the 27-point edge kernel: every mode, both dtypes
EDGE_CASES = list(itertools.product(
    (4, 8), (cf._RESTRICT, cf._RES, cf._NORM, cf._INTERP)))
# the 27-point levels of the 3D paths (256³'s and 128³'s: 128³ .. 8³; the
# 200³ float64 gate's: 100³ .. 7³), the odd gate shapes, and the fused
# kernels' edge shapes (chip_smoke.py EDGE3)
EDGE_SHAPES = [(128, 128, 128), (64, 64, 64), (32, 32, 32), (16, 16, 16),
               (8, 8, 8), (100, 100, 100), (50, 50, 50), (25, 25, 25),
               (13, 13, 13), (7, 7, 7), (5, 4, 3), (97, 45, 131),
               (67, 33, 45), (40, 30, 37), (50, 5, 70), (33, 200, 300),
               (7, 700, 250), (5, 600, 700)]


def _edge_ids(c):
    name = {cf._RESTRICT: "restrict", cf._RES: "res", cf._NORM: "norm",
            cf._INTERP: "interp"}[c[1]]
    return f"{'f32' if c[0] == 4 else 'f64'}-edge-{name}"


def _edge_fit(itemsize, mode, tz):
    lo = int(mode == cf._RESTRICT)
    return max(t for t in range(2, 129, 2)
               if cf.edge_words(itemsize, mode, t, tz) * itemsize
               <= cf.BLOCK_SMEM and (t + lo) * (tz + lo) <= 2 * 512)


@pytest.mark.parametrize("shape", [(128, 128, 128), (16, 16, 16)])
@pytest.mark.parametrize("case", EDGE_CASES, ids=_edge_ids)
def test_edge_shared_memory_fits(case, shape):
    """An edge block fits an SM as many times as planned, at most four
    blocks of 512 threads; its tile rows are even, at most the most whose
    block fits and whose window holds two points a thread at most, and as
    few as cover the grid in the fewest tiles; its own columns are 64 in
    float32 and 32 in float64."""
    itemsize, mode = case
    p = cf.edge_plan(itemsize, mode, shape, N_SM)
    assert (p.threads, p.tz) == (512, 64 if itemsize == 4 else 32)
    assert p.smem == cf.edge_words(itemsize, mode, p.ty, p.tz) * itemsize
    assert p.smem + 1024 <= BLOCK_MAX
    assert p.per_sm >= 1 and p.per_sm * (p.smem + 1024) <= SM_MAX
    assert p.threads * p.per_sm <= 2048
    fit = _edge_fit(itemsize, mode, p.tz)
    assert fit == (14 if mode == cf._RESTRICT else 16)
    assert p.ty % 2 == 0 and 2 <= p.ty <= fit
    assert p.gy == -(-shape[1] // fit)
    assert p.ty == 2 or -(-shape[1] // (p.ty - 2)) > p.gy


@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("case", EDGE_CASES, ids=_edge_ids)
def test_edge_owned_points_cover_the_grid_once(case, shape):
    """The edge blocks' own boxes tile the grid, starting at even indices,
    in whole waves of the resident blocks no longer than one chunk a tile
    would take; the grid's blocks are the norm partials."""
    itemsize, mode = case
    nx, ny, nz = shape
    p = cf.edge_plan(itemsize, mode, shape, N_SM)
    assert p.ty % 2 == 0 and p.tz % 2 == 0 and p.cx % 2 == 0
    assert (p.gz - 1) * p.tz < nz <= p.gz * p.tz
    assert (p.gy - 1) * p.ty < ny <= p.gy * p.ty
    assert (p.gc - 1) * p.cx < nx <= p.gc * p.cx
    own = [min(p.cx, nx - c * p.cx) * min(p.ty, ny - y * p.ty)
           * min(p.tz, nz - z * p.tz)
           for c in range(p.gc) for y in range(p.gy) for z in range(p.gz)]
    assert min(own) > 0 and sum(own) == nx * ny * nz
    assert p.blocks == len(own)
    h = 2 if mode == cf._RESTRICT else 1
    slots = N_SM * p.per_sm
    waves = -(-p.blocks // slots)
    one_chunk = -(-(p.gz * p.gy) // slots)
    assert waves * (min(p.cx, nx) + 2 * h) <= one_chunk * (nx + 2 * h)


@pytest.mark.parametrize("shape", [(9, 7, 5), (5, 4, 3), (33, 21, 17),
                                   (20, 3, 130), (67, 33, 45)])
@pytest.mark.parametrize("case", EDGE_CASES, ids=_edge_ids)
def test_edge_every_point_has_one_owner(case, shape):
    """Point by point at small shapes: each fine point lies in exactly one
    edge block's own box, and in mode restrict each coarse point (2i, 2j,
    2k) is restricted by exactly one block, as the kernel walks them."""
    itemsize, mode = case
    nx, ny, nz = shape
    p = cf.edge_plan(itemsize, mode, shape, n_sm=4)
    fine = np.zeros(shape, dtype=int)
    coarse = np.zeros((_coarse(nx), _coarse(ny), _coarse(nz)), dtype=int)
    for c, y, z in itertools.product(range(p.gc), range(p.gy),
                                     range(p.gz)):
        xt, yt, zt = c * p.cx, y * p.ty, z * p.tz
        fine[xt:xt + p.cx, yt:yt + p.ty, zt:zt + p.tz] += 1
        for xr in range(xt, min(xt + p.cx, nx), 2):
            coarse[xr // 2, yt // 2:yt // 2 + p.ty // 2,
                   zt // 2:zt // 2 + p.tz // 2] += 1
    assert (fine == 1).all()
    if mode == cf._RESTRICT:
        assert (coarse == 1).all()


def test_edge_layout_by_hand():
    """The edge words against layouts worked out by hand: float32
    restrict, 14 tile rows: a residual window of 15 x 65 points (the tile
    and its low ring), four q planes of 17 rows and three x-planes of the
    14 stencil arrays of 16 rows, rows of 72 words (the 64 tile columns
    between margins of 4), four residual planes of 15 x 65 (223 KB, one
    block an SM); its 128³ grid of 2 x 10 tiles and 6 chunks of 22 planes
    (120 blocks, one wave); mode res, 16 rows over 128³ in 8 chunks of 16;
    float64 restrict, 14 rows of 32 columns in rows of 36 words."""
    assert cf.edge_words(4, cf._RESTRICT, 14, 64) == (
        4 * 17 * 72 + 42 * 16 * 72 + 4 * 15 * 65)
    p = cf.edge_plan(4, cf._RESTRICT, (128,) * 3)
    assert (p.ty, p.gz, p.gy, p.cx, p.gc, p.per_sm) == (14, 2, 10, 22, 6, 1)
    assert p.smem == 57180 * 4 and p.blocks == 120 <= N_SM
    assert cf.edge_words(4, cf._RES, 16, 64) == (
        4 * 18 * 72 + 42 * 17 * 72)
    p = cf.edge_plan(4, cf._RES, (128,) * 3)
    assert (p.ty, p.gy, p.cx, p.gc) == (16, 8, 16, 8)
    p = cf.edge_plan(8, cf._RESTRICT, (128,) * 3)
    assert (p.ty, p.tz, p.gz, p.smem) == (14, 32, 4, 28620 * 8)


LIST_SHAPES = [(128,) * 3, (96,) * 3, (64,) * 3, (32,) * 3, (16,) * 3,
               (8,) * 3, (13,) * 3, (5, 4, 3), (97, 45, 131)]


@pytest.mark.parametrize("shape", LIST_SHAPES)
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("stages", [1, 2, 4])
def test_no_one_colour_27pt_pass(itemsize, stages, shape):
    """No 27-point K14, K15 or K16 call launches a one-colour pass of the
    fused kernels at any shape: its sweep runs on K6's route (resident, a
    launch a colour phase of K6, or K14 marches of ``stages`` colours that
    cover the colour order in order), and the rest of K15 and K16 is one
    edge launch (K16's interpolation first, K15's restriction or a norm
    last); ``passes`` gives 27-point marches only."""
    kind = StencilKind.twenty_seven_pt
    route = cuda3.plan(itemsize, True, shape).route
    for updown, role, mode in itertools.product(
            ("down", "up"), ("sweep", "restrict", "interp"),
            (cf._NONE, cf._RES, cf._NORM)):
        if role == "restrict" and mode != cf._NONE:
            continue
        order = relax3.color_order(kind, updown)
        marches = cf.passes(stages, kind, updown, role)
        assert all(k == "pass27" and len(g) == min(stages, 8)
                   for k, g in marches)
        assert [c for _, g in marches for c in g] == order
        got = cf.launch_list(itemsize, kind, shape, updown, role, mode,
                             stages)
        names = [k for k, _ in got]
        assert not {"sweep_restrict3", "interp_sweep3"} & set(names)
        assert names[0] == ("edge27" if role == "interp" else names[0])
        assert got[-1] == (("edge27", "restrict") if role == "restrict" else
                           ("edge27", "norm") if mode == cf._NORM
                           else got[-1])
        assert names.count("edge27") == (
            (role != "sweep") + (mode == cf._NORM)
            + (mode == cf._RES and route in cuda3.EDGE_RESIDUAL))
        sweep = [w for k, w in got if k != "edge27" and w != "residual"]
        if route == "resident":
            assert sweep == ["sweep"]
        elif route == "pass27":
            assert sweep == [g for _, g in marches]
        else:
            assert sweep == order


@pytest.mark.parametrize("role", ["sweep", "restrict", "interp"])
def test_7pt_calls_are_one_ring_launch(role):
    """A 7-point K14, K15 or K16 call is one launch of the ring design."""
    for shape in LIST_SHAPES:
        got = cf.launch_list(4, StencilKind.seven_pt, shape, "down", role,
                             cf._NORM if role == "interp" else cf._NONE)
        assert got == (({"sweep": "sweep3_fused",
                         "restrict": "sweep_restrict3",
                         "interp": "interp_sweep3"}[role], "ring"),)
