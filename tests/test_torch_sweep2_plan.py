"""The launch plan of the 2D sweep kernel K1: ``cuda2.plan``, which the
wrapper computes and passes to the kernel (csrc/sweep2.cu checks it at
launch).  Pure Python, no card: which regime each shape takes (resident in
one block's shared memory, or streamed by the tile kernel), that a
resident block's arrays fit the 227 KB a block may take, in float32 and
float64, both stencil kinds, at the main path's dense levels, the 400²
gate's levels and edge shapes.
"""

import itertools

import pytest

from cedar_tpu_torch.ops import cuda2
from cedar_tpu_torch.ops.cuda_build import BLOCK_SMEM

# one block's most shared memory on an H100 (227 KB)
BLOCK_MAX = 232448
# the 4096² main path's dense levels (9-point), the 400² f64 gate's levels
MAIN_DENSE = [(256, 256), (128, 128), (64, 64), (32, 32), (16, 16), (8, 8)]
GATE = [(400, 400), (200, 200), (100, 100), (50, 50), (25, 25), (13, 13),
        (7, 7)]
EDGES = [(5, 4), (2, 3), (65, 65), (1025, 771)]
KINDS = list(itertools.product((4, 8), (False, True)))


def _ids(c):
    itemsize, nine = c
    return f"{'f32' if itemsize == 4 else 'f64'}-{'9' if nine else '5'}pt"


def _fits(itemsize, nine, nx, ny):
    return (5 if nine else 3) + 2 <= BLOCK_SMEM // (nx * ny * itemsize)


@pytest.mark.parametrize("shape", MAIN_DENSE + GATE + EDGES)
@pytest.mark.parametrize("case", KINDS, ids=_ids)
def test_regime_and_resident_bytes(case, shape):
    """A level is resident exactly when its stencil planes, q and b fit one
    block; its bytes are those arrays' and within a block's 227 KB."""
    itemsize, nine = case
    nx, ny = shape
    p = cuda2.plan(itemsize, nine, shape)
    assert p.resident == _fits(itemsize, nine, nx, ny)
    if p.resident:
        assert p.smem == ((5 if nine else 3) + 2) * nx * ny * itemsize
        assert p.smem <= BLOCK_SMEM < BLOCK_MAX
    else:
        assert p.smem == 0


def test_main_path_regimes():
    """The main path's dense levels, 9-point float32: 256² and 128² are
    streamed, 64² down to 8² resident (64²: 7 arrays of 16 KB); the 400²
    float64 gate's dense levels are resident (9-point float64 fits up to
    64²)."""
    got = [cuda2.plan(4, True, s).resident for s in MAIN_DENSE]
    assert got == [False, False, True, True, True, True]
    assert cuda2.plan(4, True, (64, 64)).smem == 7 * 64 * 64 * 4
    assert [cuda2.plan(8, True, s).resident for s in GATE] == [
        False, False, False, True, True, True, True]


@pytest.mark.parametrize("nine, itemsize, largest", [
    (True, 4, 90), (False, 4, 107), (True, 8, 64), (False, 8, 76)])
def test_largest_resident_square(nine, itemsize, largest):
    """The edge of the resident regime on square levels."""
    assert cuda2.plan(itemsize, nine, (largest, largest)).resident
    assert not cuda2.plan(itemsize, nine, (largest + 1, largest + 1)).resident


@pytest.mark.parametrize("case", KINDS, ids=_ids)
def test_resident_bytes_by_hand(case):
    """A resident block's bytes: 3 or 5 stencil planes, q and b, each nx x
    ny words; 9-point float32 at 64² is 7 x 16 KB."""
    itemsize, nine = case
    assert cuda2.resident_bytes(itemsize, nine, (13, 7)) == (
        (7 if nine else 5) * 13 * 7 * itemsize)
    if (itemsize, nine) == (4, True):
        assert cuda2.plan(4, True, (64, 64)) == cuda2.Plan(7 * 16384)
