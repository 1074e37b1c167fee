"""The 2D transfers K2 (restrict) and K3 (interp-add) on batches of planes,
and their launch plan.

The plain versions on ``(B, nx, ny)`` batches (plane relaxation's embedded
2D cycles) against cedar_tpu.ops.interp2 applied plane by plane, float64;
then ``cuda_transfer2.plan``, pure Python: the regime and block geometry
it gives every batch of planes of the plane-xy cycle and the edge shapes,
checked as csrc/transfer2.cu checks it, every coarse point (K2) and cell
(K3) owned by exactly one thread, and every fine point written by exactly
one of K3's threads, as the kernel maps them, at both row parities.

The CUDA kernels themselves run only on the card; chip_smoke.py holds them
bit for bit against the plain versions checked here.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import interp2 as jinterp2

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_transfer2, interp2
from cedar_tpu_torch.tools.tune_fused2 import plane_transfer_shapes

torch.set_num_threads(2)

SIZES = [(9, 7), (10, 12), (33, 17), (16, 16), (2, 3), (5, 1)]


def _batch(seed, nb, nx, ny, nine):
    from test_kernels_2d import random_so

    rng = np.random.default_rng(seed)
    so = np.stack([random_so(rng, nx, ny, nine) for _ in range(nb)], axis=1)
    nxc, nyc = (nx - 1) // 2 + 1, (ny - 1) // 2 + 1
    res = rng.standard_normal((nb, nx, ny))
    q = rng.standard_normal((nb, nx, ny))
    qc = rng.standard_normal((nb, nxc, nyc))
    return so, res, q, qc


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("nine", [False, True], ids=["5pt", "9pt"])
@pytest.mark.parametrize("nx,ny", SIZES)
def test_batched_plain_versions_match_jax_per_plane(nx, ny, nine, nb):
    """restrict_plain and interp_add_plain on a batch equal cedar_tpu's
    restrict and interp_add on each plane (float64, rtol 1e-12)."""
    so, res, q, qc = _batch(11 + nx + 3 * ny + nine, nb, nx, ny, nine)
    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    jkind = JKind.nine_pt if nine else JKind.five_pt
    ci = interp2.setup_interp(torch.tensor(so), kind)
    assert tuple(ci.shape) == (8, nb, (nx - 1) // 2 + 2, (ny - 1) // 2 + 2)
    cb = cuda_transfer2.restrict_plain(ci, torch.tensor(res))
    tq = torch.tensor(q)
    got = cuda_transfer2.interp_add_plain(ci, torch.tensor(so),
                                          torch.tensor(qc),
                                          torch.tensor(res), tq)
    assert got is tq
    for b in range(nb):
        jci = jinterp2.setup_interp(jnp.asarray(so[:, b]), jkind)
        np.testing.assert_allclose(ci[:, b].numpy(), np.asarray(jci),
                                   rtol=1e-12, atol=0)
        want = jinterp2.restrict(jci, jnp.asarray(res[b]))
        np.testing.assert_allclose(cb[b].numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-14)
        want = jinterp2.interp_add(jci, jnp.asarray(so[:, b]),
                                   jnp.asarray(qc[b]), jnp.asarray(res[b]),
                                   jnp.asarray(q[b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-14)


PLANE_XY = plane_transfer_shapes(128)
# the edges: odd and even sizes, a row or a column of one point, rows of
# more than a warp's coarse columns, the unbatched 4096² path and 400²
# gate levels
EDGES = [(3, 129, 65), (5, 33, 17), (7, 2, 3), (1, 65, 63), (2, 1, 9),
         (4, 9, 1), (1, 1, 1), (2, 66, 130), (1, 4096, 4096), (1, 2049, 2049),
         (1, 400, 400), (1, 25, 25), (1, 13, 13), (1, 7, 7), (1000, 5, 5)]
KERNELS = ("restrict", "interp_add")


def test_plane_xy_launch_breakdown():
    """The plane-xy cycle at 128³ runs 60 K2 launches (and 60 K3): 4 on
    (64, 128²), 8 on 64² planes, 12 on 32² planes and 36 on 16² and 8²
    planes, B = 4 .. 64."""
    assert sum(PLANE_XY.values()) == 60
    by_n = {}
    for (nb, nx, ny), k in PLANE_XY.items():
        assert nx == ny and 4 <= nb <= 64
        by_n[nx] = by_n.get(nx, 0) + k
    assert by_n == {128: 4, 64: 8, 32: 12, 16: 16, 8: 20}
    assert PLANE_XY[(64, 128, 128)] == 4


def _nc(shape):
    nb, nx, ny = shape
    return nb, nx, ny, (nx - 1) // 2 + 1, (ny - 1) // 2 + 1


def _plan_ok(p, rows, nyc):
    """csrc/transfer2.cu plan_ok."""
    return (p.seg in (1, 2, 4, 8, 16, 32) and p.threads % 32 == 0
            and p.threads <= 1024 and p.nseg >= 1
            and p.seg * p.nseg >= nyc > p.seg * (p.nseg - 1)
            and 1 <= p.gy <= 65535
            and p.gy * (p.threads // p.seg) >= rows
            > (p.gy - 1) * (p.threads // p.seg))


def _threads(p):
    """(row, lane's column) of every thread of the launch ``p``: block
    (seg, threads / seg), grid (nseg, gy)."""
    rows_a_block = p.threads // p.seg
    by, bx, ty, tx = np.meshgrid(np.arange(p.gy), np.arange(p.nseg),
                                 np.arange(rows_a_block), np.arange(p.seg),
                                 indexing="ij")
    return (by * rows_a_block + ty).ravel(), (bx * p.seg + tx).ravel()


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", [*PLANE_XY, *EDGES], ids=str)
def test_plan_geometry_and_cover(shape, kernel):
    """The plan's regime and block geometry, checked as the kernel checks
    it, and every coarse cell of every plane owned by exactly one live
    thread: K2's (p, zc, wc), K3's cells (p, k, m), k in [0, nxc]."""
    nb, nx, ny, nxc, nyc = _nc(shape)
    p = cuda_transfer2.plan(kernel, shape)
    rows = nb * (nxc if kernel == "restrict" else nxc + 1)
    assert p.rows == rows and _plan_ok(p, rows, nyc)
    assert p.seg == min(32, 1 << (nyc - 1).bit_length())
    assert p.regime == ("packed" if nyc <= 16 else "strip")
    # the most threads a block whose grid still has a block an SM
    assert p.threads == 64 or p.blocks >= cuda_transfer2.N_SM
    r, c = _threads(p)
    live = (r < rows) & (c < nyc)
    owned = np.zeros((rows, nyc), dtype=int)
    np.add.at(owned, (r[live], c[live]), 1)
    assert (owned == 1).all()


def _fine_points(shape, par):
    """How often K3 writes each fine point, as interp_add_kernel maps its
    threads (cell (k, m) -> fine rows 2k-1, 2k; in a row at element offset
    ``off``, the aligned pair a = 2m - (par + off) % 2 and, in a row at an
    odd address, the last cell's column 2m+1), with q starting at element
    parity ``par``."""
    nb, nx, ny, nxc, nyc = _nc(shape)
    count = np.zeros((nb, nx, ny), dtype=int)
    for p, k, m in itertools.product(range(nb), range(nxc + 1), range(nyc)):
        for z in (2 * k - 1, 2 * k):
            if not 0 <= z < nx:
                continue
            odd = (par + p * nx * ny + z * ny) % 2
            a = 2 * m - odd
            cols = [a, a + 1] + ([a + 2] if odd and m == nyc - 1 else [])
            for w in cols:
                if 0 <= w < ny:
                    count[p, z, w] += 1
    return count


@pytest.mark.parametrize("par", [0, 1])
@pytest.mark.parametrize("shape", [(3, 9, 7), (2, 10, 12), (5, 33, 17),
                                   (7, 2, 3), (2, 1, 9), (3, 8, 8),
                                   (1, 65, 63), (2, 6, 1)], ids=str)
def test_interp_add_writes_every_fine_point_once(shape, par):
    """K3's cells cover each fine point exactly once at both row parities
    (q at an even or odd element address; odd ny alternates them)."""
    assert (_fine_points(shape, par) == 1).all()


def test_plan_refuses_other_kernels_and_is_cached():
    with pytest.raises(ValueError):
        cuda_transfer2.plan("interp", (1, 9, 9))
    assert (cuda_transfer2.plan("restrict", (64, 128, 128))
            is cuda_transfer2.plan("restrict", (64, 128, 128)))


@pytest.mark.parametrize("shape,kernel,want", [
    # (64, 128²): 64 coarse columns, two warps a row, 256 threads a block
    ((64, 128, 128), "restrict", (32, 2, 256, 512)),
    ((64, 128, 128), "interp_add", (32, 2, 256, 520)),
    # 8² planes: 4 coarse columns, 8 rows a warp, 64 threads a block
    ((64, 8, 8), "restrict", (4, 1, 64, 16)),
    ((4, 8, 8), "interp_add", (4, 1, 64, 2)),
    # 4096² -> 2048²
    ((1, 4096, 4096), "restrict", (32, 64, 256, 256)),
    ((1, 4096, 4096), "interp_add", (32, 64, 256, 257)),
])
def test_plan_by_hand(shape, kernel, want):
    p = cuda_transfer2.plan(kernel, shape)
    assert (p.seg, p.nseg, p.threads, p.gy) == want
