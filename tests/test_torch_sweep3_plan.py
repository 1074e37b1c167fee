"""The plan of the 3D sweep K6: ``cuda3.plan``, which the wrapper computes
and passes to the kernels (csrc/sweep3.cu checks a resident plan at
launch).  Pure Python, no card: which regime each shape takes (resident in
one block's shared memory, the ring or the 27-point marches of K14, or one
launch a colour phase), that a resident block fits the 227 KB a block may
take, and the launches of a sweep, in float32 and float64, both stencil
kinds, at every level of the four 3D paths (the 256³ and 128³ hierarchies,
the 200³ float64 gate) and on both sides of each regime's edge.
"""

import itertools
import math

import pytest

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda3, cuda_fused3
from cedar_tpu_torch.ops.cuda_build import BLOCK_SMEM

# one block's most shared memory on an H100 (227 KB)
BLOCK_MAX = 232448
# the levels of 3d_poisson_7pt_256 (and its F-cycle), 3d_fe_27pt_128 and
# Cedar's 200³ float64 test
H256 = [(256,) * 3, (128,) * 3, (64,) * 3, (32,) * 3, (16,) * 3, (8,) * 3,
        (4,) * 3]
H128 = [(128,) * 3, (64,) * 3, (32,) * 3, (16,) * 3, (8,) * 3, (4,) * 3]
H200 = [(200,) * 3, (100,) * 3, (50,) * 3, (25,) * 3, (13,) * 3, (7,) * 3]
# both sides of each edge: resident 27-point up to 512 points an octant
# (float32 16³, (52, 38, 2) but not (54, 38, 2)) and 231424 bytes (float64
# 12³), the ring from 200³, the 27-point marches from 96³; shapes that are
# not cubes
EDGES = [(16, 16, 17), (17, 16, 16), (52, 38, 2), (54, 38, 2), (95, 96, 96),
         (96,) * 3, (199, 200, 200), (33, 21, 17), (5, 4, 3), (2, 3, 1),
         (40, 30, 24), (1, 64, 64), (11, 12, 12)]
SHAPES = sorted(set(H256 + H128 + H200 + EDGES))
KINDS = list(itertools.product((4, 8), (False, True)))


def _ids(c):
    itemsize, ts = c
    return f"{'f32' if itemsize == 4 else 'f64'}-{'27' if ts else '7'}pt"


def _octant(shape):
    return math.prod((n + 1) // 2 for n in shape)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", KINDS, ids=_ids)
def test_regime(case, shape):
    """Resident: a 27-point level of at most 512 points an octant (a point
    a thread of each colour) whose q and 13 off-diagonal stencil planes fit
    a block; above it the ring from 200³ points (7-point), the marches from
    96³ points (27-point float32), else one launch a colour phase."""
    itemsize, ts = case
    n, h = math.prod(shape), _octant(shape)
    p = cuda3.plan(itemsize, ts, shape)
    if ts and h <= 512 and 14 * 8 * h * itemsize <= BLOCK_SMEM:
        want = "resident"
    elif not ts and n >= cuda3.RING_POINTS == 200 ** 3:
        want = "ring"
    elif ts and itemsize == 4 and n >= cuda3.PASS27_POINTS == 96 ** 3:
        want = "pass27"
    else:
        want = "phases"
    assert p.route == want and p.resident == (want == "resident")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", KINDS, ids=_ids)
def test_resident_bytes(case, shape):
    """A resident block holds q and the 13 off-diagonal stencil planes,
    each in 8 octants of half the grid's extents (rounded up), within a
    block's 227 KB, on the kernel's threads; the other regimes take
    none."""
    itemsize, ts = case
    p = cuda3.plan(itemsize, ts, shape)
    if not p.resident:
        assert (p.smem, p.threads) == (0, 0)
        return
    m = 8 * _octant(shape)
    assert m == cuda3.octant_words(shape) >= math.prod(shape)
    assert p.smem == 14 * m * itemsize <= BLOCK_SMEM < BLOCK_MAX
    assert m <= 8 * p.threads
    assert p.threads == cuda3.THREADS == 512


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", KINDS, ids=_ids)
@pytest.mark.parametrize("fuse", [False, True])
def test_launches_a_sweep(case, shape, fuse):
    """One launch a resident or ring sweep (the ring's epilogue computes
    the residual); one a colour phase (2 or 8) or four two-colour marches,
    and one more for the residual."""
    itemsize, ts = case
    kind = StencilKind.twenty_seven_pt if ts else StencilKind.seven_pt
    p = cuda3.plan(itemsize, ts, shape)
    want = {"resident": 1, "ring": 1, "pass27": 4 + fuse,
            "phases": (8 if ts else 2) + fuse}[p.route]
    assert cuda3.launches_of(p, kind, fuse) == want
    if p.route == "pass27":
        assert len(cuda_fused3.passes(cuda_fused3.PASS27_STAGES, kind,
                                       "up", "sweep")) == 4


def test_paths_regimes():
    """The paths' dense levels: 256³ 7-point on the ring, its 27-point
    levels 128³ on the marches, 64³ and 32³ a launch a colour, 16³ and 8³
    resident (16³ float32: 14 arrays of 16 KB); the fe3 128³ hierarchy the
    same; the 200³ float64 gate's 12³-sized levels and below resident (7³
    in octants of 4³), 13³ .. 100³ a launch a colour, 200³ on the ring;
    7-point levels never resident."""
    routes = [cuda3.plan(4, n[0] < 256, n).route for n in H256[:-1]]
    assert routes == ["ring", "pass27", "phases", "phases", "resident",
                      "resident"]
    assert [cuda3.plan(4, True, n).route for n in H128[:-1]] == [
        "pass27", "phases", "phases", "resident", "resident"]
    assert [cuda3.plan(8, n[0] < 200, n).route for n in H200] == [
        "ring", "phases", "phases", "phases", "phases", "resident"]
    assert cuda3.plan(4, True, (16,) * 3) == cuda3.Plan(
        "resident", 14 * 16384, 512)
    assert cuda3.plan(8, True, (7,) * 3) == cuda3.Plan(
        "resident", 14 * 512 * 8, 512)
    assert cuda3.plan(8, True, (12,) * 3).resident
    assert not cuda3.plan(4, False, (8,) * 3).resident


def test_plan_follows_the_build():
    """The plan takes the build's threads and shared-memory limit (read
    from the library on the card): fewer threads or a smaller limit leave a
    level to the per-colour launches."""
    assert cuda3.plan(4, True, (16,) * 3, (256, BLOCK_SMEM)).route == (
        "phases")
    assert cuda3.plan(4, True, (16,) * 3, (512, 200000)).route == "phases"
    assert cuda3.plan(4, True, (8,) * 3, (64, 28672)) == cuda3.Plan(
        "resident", 28672, 64)
