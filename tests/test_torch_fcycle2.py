"""The port's F-cycle: the level-entry interpolation ``x = P qc`` (plain
version of kernel K5) against cedar_tpu's interp_add with zero residual
and addend in float64 and against the Pallas split kernel in interpret
mode in float32, the whole F-cycle solve against cedar_tpu's Solver2, and
the solve loop's fusion gate.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against the plain version checked here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu import Solver2 as JSolver2
from cedar_tpu import gallery as jgallery
from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import interp2 as jinterp2
from cedar_tpu.ops import pallas2_split as ps
from cedar_tpu.ops import pallas_transfer2 as pt

from cedar_tpu_torch import Config, FivePt, Solver2, gallery
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_transfer2, interp2
from cedar_tpu_torch.settings import MLSettings
from cedar_tpu_torch.solver import cycle2

torch.set_num_threads(2)


def _problem(seed, nx, ny, nine, dtype=np.float64):
    from test_kernels_2d import random_so

    rng = np.random.default_rng(seed)
    so = random_so(rng, nx, ny, nine).astype(dtype)
    nxc, nyc = (nx - 1) // 2 + 1, (ny - 1) // 2 + 1
    qc = rng.standard_normal((nxc, nyc)).astype(dtype)
    return so, qc


def _kinds(nine):
    return ((StencilKind.nine_pt, JKind.nine_pt) if nine
            else (StencilKind.five_pt, JKind.five_pt))


@pytest.mark.parametrize("nine,nx,ny", [
    (False, 256, 256), (True, 129, 257), (False, 200, 300), (True, 125, 93),
    (False, 9, 7), (True, 10, 12)])
def test_interp_matches_jax_f64(nine, nx, ny):
    so, qc = _problem(61 + nx + nine, nx, ny, nine)
    kind, jkind = _kinds(nine)
    jso = jnp.asarray(so)
    jci = jinterp2.setup_interp(jso, jkind)
    zero = jnp.zeros((nx, ny))
    # the JAX F-cycle's dense level entry (cycle2.py:483-491)
    want = np.asarray(jinterp2.interp_add(jci, jso, jnp.asarray(qc), zero,
                                          zero))
    ci = interp2.setup_interp(torch.tensor(so), kind)
    got = interp2.interp(ci, torch.tensor(qc), (nx, ny))
    assert got.shape == (nx, ny)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("nine,nx,ny", [(False, 256, 256), (True, 129, 257),
                                        (False, 200, 300)])
def test_interp_matches_pallas_interpret_f32(nine, nx, ny, monkeypatch):
    monkeypatch.setattr(pt, "INTERPRET", True)
    so, qc = _problem(71 + nx, nx, ny, nine, np.float32)
    kind, jkind = _kinds(nine)
    jci = jinterp2.setup_interp(jnp.asarray(so), jkind)
    nxp, W, _ = ps.split_dims(nx, ny)
    x2 = pt.interp_split_nores(pt.pad_ci(jci, nx, ny), jnp.asarray(qc), nxp,
                               W)
    want = ps.lane_merge(x2, nx, ny)
    ci = interp2.setup_interp(torch.tensor(so), kind)
    got = interp2.interp(ci, torch.tensor(qc), (nx, ny))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-6,
                               atol=3e-6)


def test_interp_equals_interp_add_from_zero():
    """K5's plain version is K3's with zero residual and zero addend."""
    so, qc = _problem(81, 17, 22, True)
    t = torch.tensor(so)
    ci = interp2.setup_interp(t, StencilKind.nine_pt)
    zero = torch.zeros(17, 22, dtype=torch.float64)
    want = interp2.interp_add_torch(ci, t, torch.tensor(qc), zero, zero)
    got = interp2.interp_torch(ci, torch.tensor(qc), (17, 22))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_interp_dispatch_and_checks():
    so, qc = _problem(82, 9, 11, False)
    ci = interp2.setup_interp(torch.tensor(so), StencilKind.five_pt)
    tqc = torch.tensor(qc)
    launches = cuda_transfer2.interp2_launches
    plain = cuda_transfer2.interp2_plain_calls
    interp2.interp(ci, tqc, (9, 11))
    assert cuda_transfer2.interp2_plain_calls == plain + 1
    assert cuda_transfer2.interp2_launches == launches
    with pytest.raises(ValueError, match="not on CUDA"):
        cuda_transfer2.interp(ci, tqc, (9, 11))
    with pytest.raises(ValueError, match="does not interpolate"):
        cuda_transfer2.interp_plain(ci, tqc, (9, 13))
    with pytest.raises(ValueError, match="qc"):
        cuda_transfer2.interp_plain(ci, tqc[:, :3], (9, 11))


# --- the F-cycle solve ------------------------------------------------------

FCONF = {"log": [], "solver": {"cycle": {"type": "f"}, "tol": 1e-8,
                               "max-iter": 8}}


@pytest.fixture(scope="module")
def fpair():
    n = 128
    so = np.asarray(jgallery.poisson(n, n))
    b = np.asarray(jgallery.poisson_rhs(n, n))
    js = JSolver2(jnp.asarray(so), JKind.five_pt, FCONF)
    jx = np.asarray(js.solve(jnp.asarray(b)))
    s = Solver2(torch.tensor(so), FivePt, FCONF)
    return dict(b=b, js=js, jx=jx, s=s, n=n)


def test_fcycle_solve_matches_jax(fpair):
    s, js = fpair["s"], fpair["js"]
    x = s.solve(torch.tensor(fpair["b"]))
    assert len(s.history) == len(js.history) == 8
    np.testing.assert_allclose(s.history, js.history, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(s.res0, js.res0, rtol=1e-12)
    jx = fpair["jx"]
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-9,
                               atol=1e-12 * float(np.abs(jx).max()))
    n = fpair["n"]
    err = float((x - gallery.poisson_solution(n, n, device="cpu")).abs().max())
    assert err < 1e-3   # discretisation accuracy after one F-cycle


def test_fcycle_history_is_constant(fpair):
    """The F-cycle starts from b alone and ignores the iterate (as the JAX
    package's does), so every iteration recomputes the same x."""
    s = fpair["s"]
    b = torch.tensor(fpair["b"])
    s.solve(b)
    assert len(set(s.history)) == 1
    x1 = s.vcycle(torch.zeros_like(b), b)
    x2 = s.vcycle(torch.randn(b.shape, dtype=b.dtype), b)
    np.testing.assert_array_equal(x1.numpy(), x2.numpy())


def _conf(**solver):
    return MLSettings.from_config(Config({"solver": solver}))


@pytest.mark.parametrize("solver,fuse", [
    ({}, True),
    ({"cycle": {"type": "f"}}, False),
    ({"relaxation": "line-x"}, False),
    ({"relaxation": "line-xy"}, False),
    ({"cycle": {"nrelax-post": 0}}, False),
])
def test_fuse_final_ok(solver, fuse):
    settings = _conf(**solver)
    assert cycle2.fuse_final_ok((None, None), settings) is fuse
    assert not cycle2.fuse_final_ok((None,), settings)


@pytest.mark.parametrize("solver,fuse", [
    ({}, True), ({"relaxation": "line-y"}, False),
    ({"cycle": {"type": "f"}}, False),
    ({"relaxation": "line-xy", "cycle": {"type": "f"}}, False)])
def test_solve_fuses_residual_only_under_the_gate(solver, fuse, monkeypatch):
    """Line relaxation and F-cycles compute the convergence residual after
    the cycle; only the point V-cycle fuses it into the last post-sweep."""
    fused = []
    ncycle = cycle2.ncycle

    def spy(*args, fuse_final_residual=False, **kw):
        fused.append(fuse_final_residual)
        return ncycle(*args, fuse_final_residual=fuse_final_residual, **kw)

    monkeypatch.setattr(cycle2, "ncycle", spy)
    s = Solver2(gallery.poisson(33, 33, device="cpu"), FivePt,
                {"log": [], "solver": dict(solver, **{"max-iter": 2})})
    b = gallery.poisson_rhs(33, 33, device="cpu")
    x = s.solve(b)
    assert fused and any(fused) is fuse
    r = torch.sqrt(torch.sum(
        cycle2.residual(s.levels[0].so, x, b, FivePt) ** 2))
    np.testing.assert_allclose(s.history[-1], float(r) / s.res0, rtol=1e-12)
