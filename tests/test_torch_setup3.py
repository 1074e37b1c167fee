"""The port's 3D BoxMG setup against cedar_tpu in float64: Galerkin
coarsening (comb probing through the transfer ops), the dimension-generic
dense coarse inverse, and the whole 3D level hierarchy; and the 2D coarse
solve unchanged by the generalisation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu import gallery as jgallery
from cedar_tpu.config import Config as JConfig
from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import cg as jcg
from cedar_tpu.ops.galerkin3 import coarsen_op as jcoarsen_op
from cedar_tpu.ops.interp3 import setup_interp as jsetup_interp
from cedar_tpu.settings import MLSettings as JMLSettings
from cedar_tpu.solver import solver3 as jsolver3

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cg
from cedar_tpu_torch.ops.galerkin3 import coarsen_op
from cedar_tpu_torch.ops.interp3 import setup_interp
from cedar_tpu_torch.solver import solver3

torch.set_num_threads(2)


def _kinds(ts):
    return ((StencilKind.twenty_seven_pt, JKind.twenty_seven_pt) if ts
            else (StencilKind.seven_pt, JKind.seven_pt))


def _random_so(seed, shape, ts):
    from test_kernels_3d import random_so

    return random_so(np.random.default_rng(seed), *shape, ts)


def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=1e-13 * float(np.abs(want).max()))


@pytest.mark.parametrize("ts,shape", [(False, (9, 7, 6)), (True, (9, 7, 6)),
                                      (False, (16, 16, 16)),
                                      (True, (13, 10, 12))])
def test_coarsen_op_matches_jax(ts, shape):
    so = _random_so(31 + shape[0], shape, ts)
    kind, jkind = _kinds(ts)
    jso = jnp.asarray(so)
    want = jcoarsen_op(jsetup_interp(jso, jkind), jso, jkind)
    tso = torch.tensor(so)
    got = coarsen_op(setup_interp(tso, kind), tso, kind)
    assert got.shape == (14,) + tuple((n - 1) // 2 + 1 for n in shape)
    _close(got, want)


@pytest.mark.parametrize("ts,shape", [(False, (4, 4, 4)), (True, (5, 6, 4)),
                                      (True, (3, 3, 3))])
@pytest.mark.parametrize("indefinite", [False, True])
def test_cg_lu_3d_matches_jax(ts, shape, indefinite):
    so = _random_so(41 + shape[1], shape, ts)
    kind, jkind = _kinds(ts)
    b = np.random.default_rng(7).standard_normal(shape)
    per = (False, False, False)
    jmat = jcg.assemble_dense(jnp.asarray(so), jkind, per)
    mat = cg.assemble_dense(torch.tensor(so), kind)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))
    jainv = jcg.setup_cg_lu(jnp.asarray(so), jkind, per, indefinite)
    ainv = cg.setup_cg_lu(torch.tensor(so), kind, indefinite)
    np.testing.assert_allclose(ainv.numpy(), np.asarray(jainv), rtol=1e-10,
                               atol=1e-12 * float(np.abs(jainv).max()))
    want = jcg.solve_cg(jainv, jnp.asarray(b))
    got = cg.solve_cg(ainv, torch.tensor(b))
    assert got.shape == shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12 * float(np.abs(want).max()))
    # the port's inverse applied by the JAX package's flattening
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jcg.solve_cg(jnp.asarray(ainv.numpy()), jnp.asarray(b))),
        rtol=1e-13, atol=1e-14 * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", [(4, 4), (5, 3), (7, 6)])
def test_solve_cg_2d_unchanged(shape):
    """The dimension-generic solve_cg gives the 2D results bit for bit:
    the permute-based flattening is the old transpose-based one."""
    rng = np.random.default_rng(11 + shape[0])
    n = shape[0] * shape[1]
    ainv = torch.tensor(rng.standard_normal((n, n)))
    b = torch.tensor(rng.standard_normal(shape))
    old = (ainv @ b.T.reshape(-1)).reshape(shape[1], shape[0]).T
    np.testing.assert_array_equal(cg.solve_cg(ainv, b).numpy(), old.numpy())


def test_solve_cg_3d_is_x_fastest():
    """Unknown k of the dense system is point (x, y, z) with
    k = x + nx (y + ny z), the reference's KK ordering."""
    shape = (3, 4, 2)
    n = 24
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    ainv = torch.eye(n, dtype=torch.float64)[perm]
    b = torch.arange(n, dtype=torch.float64).reshape(shape)
    x = cg.solve_cg(ainv, b)
    flat = b.permute(2, 1, 0).reshape(-1)
    for i in range(shape[0]):
        for j in range(shape[1]):
            for k in range(shape[2]):
                assert x[i, j, k] == flat[perm[i + 3 * (j + 4 * k)]]


@pytest.mark.parametrize("case", ["poisson3-17", "fe3-9x12x10"])
def test_setup_hierarchy_3d_matches_jax(case):
    if case == "poisson3-17":
        so, ts = np.asarray(jgallery.poisson3(17, 17, 17)), False
    else:
        so, ts = np.asarray(jgallery.fe3(9, 12, 10)), True
    kind, jkind = _kinds(ts)
    shape = so.shape[1:]
    nlevels = solver3.compute_num_levels(*shape, 3)
    assert nlevels == jsolver3.compute_num_levels(*shape, 3)
    assert (solver3.level_shapes(*shape, nlevels)
            == [tuple(s) for s in jsolver3.level_shapes(*shape, nlevels)])
    settings = JMLSettings.from_config(JConfig({}))
    want = jsolver3.setup_hierarchy(jnp.asarray(so), jkind, nlevels,
                                    settings)
    got = solver3.setup_hierarchy(torch.tensor(so), kind, nlevels)
    assert len(got) == len(want) == nlevels
    for lvl, (g, w) in enumerate(zip(got, want)):
        for field in ("so", "recip", "ci", "ainv"):
            gv, wv = getattr(g, field), getattr(w, field)
            assert (gv is None) == (wv is None), (lvl, field)
            if gv is not None:
                _close(gv, wv, rtol=1e-10 if field == "ainv" else 1e-12)
