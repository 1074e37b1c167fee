"""The launch plan of the fused 2D kernels K12 (sweep + residual +
restriction) and K13 (interp-add + sweep), the row march:
``cuda_fused2.plan``, which the wrapper computes and passes to the kernel
(csrc/fused2.cu checks it against its own layout at launch).  Pure
Python, no card: for both stencil kinds, both dtypes, every K13 output
mode and K12, at the 2D paths' shapes and at shapes that hit the edges of
the strips and chunks, the shared memory fits as many blocks an SM as are
planned, the blocks' own points cover the grid exactly once, there is one
norm partial a block, K12's strips and chunks start at even indices so
that its blocks' coarse points cover the coarse grid exactly once, and the
strip of a build with other threads a block (tools/tune_fused2.py) is
honoured.
"""

import itertools

import numpy as np
import pytest

from cedar_tpu_torch.ops import cuda_fused2 as cf

CASES = list(itertools.product((4, 8), (False, True),
                               (cf._NONE, cf._RES, cf._NORM, cf._RESTRICT)))
# the 2D paths' shapes (4096² and its 9-point levels, the f64 gates) and
# edge shapes: widths not a multiple of the strip, rows not a multiple of
# the chunk, fewer rows than the halo, a few points
SHAPES = [(4096, 4096), (2048, 2048), (2049, 2049), (400, 400), (1025, 771),
          (5, 4), (300, 997), (3, 1000), (1031, 250), (2, 3), (777, 513),
          (1024, 1024), (512, 512)]
N_SM = 132
# one block's most shared memory (227 KB) and an SM's (228 KB)
BLOCK_MAX, SM_MAX = 232448, 233472


def _ids(c):
    itemsize, nine, mode = c
    what = "k12" if mode == cf._RESTRICT else f"m{mode}"
    return f"{'f32' if itemsize == 4 else 'f64'}-{'9' if nine else '5'}pt-{what}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_shared_memory_fits(case):
    """The plan's block fits an SM as many times as it plans, within the
    SM's threads and resident blocks; its size is the kernel's layout."""
    itemsize, nine, mode = case
    p = cf.plan(itemsize, nine, mode, (4096, 4096), N_SM)
    assert p.smem == cf.ring_words(nine, mode) * itemsize
    assert p.smem + 1024 <= BLOCK_MAX
    assert p.per_sm >= 1 and p.per_sm * (p.smem + 1024) <= SM_MAX
    assert p.nt * p.per_sm <= 2048 and p.per_sm <= 32
    assert p.nt == cf.THREADS == 128
    phases = 4 if nine else 2
    if mode == cf._RESTRICT:
        # the phases, the residual and the restriction's low row / column
        assert p.h == phases + 2
    else:
        assert p.h == 1 + phases + (mode != cf._NONE)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_owned_points_cover_the_grid_once(case, shape):
    """The blocks' own boxes (a strip of tw columns, a chunk of cz rows,
    clipped to the grid) tile the grid; one norm partial a block."""
    itemsize, nine, mode = case
    nx, ny = shape
    p = cf.plan(itemsize, nine, mode, shape, N_SM)
    assert p.tw == 2 * p.nt - 2 * p.h
    assert (p.gw - 1) * p.tw < ny <= p.gw * p.tw
    assert (p.gc - 1) * p.cz < nx <= p.gc * p.cz
    own = [min(p.cz, nx - c * p.cz) * min(p.tw, ny - w * p.tw)
           for c in range(p.gc) for w in range(p.gw)]
    assert min(own) > 0 and sum(own) == nx * ny
    assert p.blocks == len(own) == p.gw * p.gc


@pytest.mark.parametrize("shape", [(5, 4), (2, 3), (40, 300), (9, 130)])
@pytest.mark.parametrize("nt", [64, cf.THREADS])
def test_every_point_has_one_owner(nt, shape):
    """Point by point at small shapes, with the built block width and a
    tool build's: each point lies in exactly one block's own box."""
    nx, ny = shape
    p = cf.plan(4, True, cf._NORM, shape, n_sm=4, build=(nt, cf.AHEAD))
    own = np.zeros(shape, dtype=int)
    for c, w in itertools.product(range(p.gc), range(p.gw)):
        own[c * p.cz:(c + 1) * p.cz, w * p.tw:(w + 1) * p.tw] += 1
    assert (own == 1).all()


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_grid_runs_in_whole_waves(case):
    """At 4096² the planned grid is no more waves of resident blocks than
    one chunk a strip would take, and a card with more SMs never gets
    more waves."""
    itemsize, nine, mode = case
    p = cf.plan(itemsize, nine, mode, (4096, 4096), N_SM)
    slots = N_SM * p.per_sm
    waves = -(-p.blocks // slots)
    assert waves * (p.cz + 2 * p.h) <= -(-p.gw // slots) * (4096 + 2 * p.h)
    q = cf.plan(itemsize, nine, mode, (4096, 4096), 2 * N_SM)
    assert -(-q.blocks // (2 * slots)) <= waves


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plan_takes_an_override(case):
    """tools/tune_fused2.py builds K13 with other threads a block and
    steps ahead: the plan of such a build takes its strip, its shared
    memory and the resident blocks it leaves, and refuses a build whose
    block does not fit."""
    itemsize, nine, mode = case
    for nt, ahead in ((64, 1), (64, 2), (256, 1), (cf.THREADS, 2)):
        size = cf.ring_words(nine, mode, nt, ahead) * itemsize
        if size > cf.BLOCK_SMEM:
            with pytest.raises(ValueError):
                cf.plan(itemsize, nine, mode, (512, 700), build=(nt, ahead))
            continue
        p = cf.plan(itemsize, nine, mode, (512, 700), build=(nt, ahead))
        assert (p.nt, p.smem) == (nt, size)
        assert p.tw == 2 * nt - 2 * p.h and p.gw == -(-700 // p.tw)
        assert p.per_sm == min(2048 // nt, 32, SM_MAX // (size + 1024))
        assert (p.gc - 1) * p.cz < 512 <= p.gc * p.cz
    with pytest.raises(ValueError):
        cf.plan(itemsize, nine, mode, (512, 512), build=(1024, 2))


def test_layouts_by_hand():
    """The shared-memory words against layouts worked out by hand (copies
    one step ahead): 5-point with the norm, 128 threads (H = 4: rings of 5
    swept q rows, 4 q_pre rows, 6 slots of 3 stencil rows and b, 256
    columns; CI 2 x 8 and qc 3 coarse rows of 130 columns), and its 4096²
    grid; two steps ahead, one more q_pre row and stencil slot."""
    assert (cf.THREADS, cf.AHEAD) == (128, 1)
    assert cf.ring_words(False, cf._NORM) == (
        256 * (5 + 4 + 6 * 4) + (16 + 3) * 130)
    assert cf.ring_words(False, cf._NORM, 128, ahead=2) == (
        256 * (5 + 5 + 7 * 4) + (16 + 3) * 130)
    # 9-point, no epilogue, 64 threads: H = 5
    assert cf.ring_words(True, cf._NONE, 64) == (
        128 * (6 + 4 + 7 * 6) + 19 * 66)
    # K12, 5-point, 128 threads: H = 4, the residual at stage 3; rings of 6
    # q rows, 5 slots of 3 stencil rows and b, 4 residual rows; CI 3 x 8
    # coarse rows of 130 columns
    assert cf.ring_words(False, cf._RESTRICT) == (
        256 * (6 + 5 * 4 + 4) + 24 * 130)
    # 9-point, two steps ahead: H = 6, 9 q rows, 8 slots of 6 rows
    assert cf.ring_words(True, cf._RESTRICT, 128, ahead=2) == (
        256 * (9 + 8 * 6 + 4) + 24 * 130)
    k12 = cf.plan(4, False, cf._RESTRICT, (4096, 4096))
    assert (k12.nt, k12.tw, k12.gw, k12.per_sm) == (128, 248, 17, 5)
    p = cf.plan(4, False, cf._NORM, (4096, 4096))
    assert (p.nt, p.tw, p.gw, p.per_sm) == (128, 248, 17, 5)
    assert p.gw * p.gc <= N_SM * p.per_sm


K12 = [c for c in CASES if c[2] == cf._RESTRICT]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", K12, ids=_ids)
def test_k12_coarse_points_have_one_owner(case, shape):
    """K12's strips and chunks start at even fine indices (an even strip
    width and chunk), so the coarse points (2k, 2m) of the blocks' own
    boxes cover the coarse grid exactly once."""
    itemsize, nine, mode = case
    nx, ny = shape
    p = cf.plan(itemsize, nine, mode, shape, N_SM)
    assert p.tw % 2 == 0 and p.cz % 2 == 0
    nxc, nyc = (nx + 1) // 2, (ny + 1) // 2
    own = np.zeros((nxc, nyc), dtype=int)
    for c, w in itertools.product(range(p.gc), range(p.gw)):
        z0, w0 = c * p.cz, w * p.tw
        assert z0 % 2 == 0 and w0 % 2 == 0
        own[z0 // 2:min(z0 + p.cz, nx + 1) // 2,
            w0 // 2:min(w0 + p.tw, ny + 1) // 2] += 1
    assert (own == 1).all()
