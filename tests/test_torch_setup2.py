"""The port's BoxMG setup against cedar_tpu in float64: Galerkin coarsening,
the dense coarse inverse and the whole level hierarchy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu import gallery as jgallery
from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import cg as jcg
from cedar_tpu.ops.galerkin2 import coarsen_op as jcoarsen_op
from cedar_tpu.ops.interp2 import setup_interp as jsetup_interp
from cedar_tpu.settings import MLSettings as JMLSettings
from cedar_tpu.config import Config as JConfig
from cedar_tpu.solver import solver2 as jsolver2

from cedar_tpu_torch import gallery
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cg
from cedar_tpu_torch.ops.galerkin2 import coarsen_op
from cedar_tpu_torch.ops.interp2 import setup_interp
from cedar_tpu_torch.solver import solver2

torch.set_num_threads(2)


def _kinds(nine):
    return ((StencilKind.nine_pt, JKind.nine_pt) if nine
            else (StencilKind.five_pt, JKind.five_pt))


def _random_so(seed, nx, ny, nine):
    from test_kernels_2d import random_so

    return random_so(np.random.default_rng(seed), nx, ny, nine)


@pytest.mark.parametrize("nine,nx,ny", [(False, 16, 16), (True, 17, 13),
                                        (False, 25, 31), (True, 40, 33)])
def test_coarsen_op_matches_jax(nine, nx, ny):
    so = _random_so(31 + nx, nx, ny, nine)
    kind, jkind = _kinds(nine)
    jso = jnp.asarray(so)
    want = jcoarsen_op(jsetup_interp(jso, jkind), jso, jkind)
    tso = torch.tensor(so)
    got = coarsen_op(setup_interp(tso, kind), tso, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11,
                               atol=1e-13 * float(np.abs(want).max()))


@pytest.mark.parametrize("nine,shape", [(False, (4, 4)), (True, (7, 7)),
                                        (True, (5, 3))])
@pytest.mark.parametrize("indefinite", [False, True])
def test_cg_lu_matches_jax(nine, shape, indefinite):
    so = _random_so(41 + shape[0], *shape, nine)
    kind, jkind = _kinds(nine)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(shape)
    jmat = jcg.assemble_dense(jnp.asarray(so), jkind, (False, False))
    mat = cg.assemble_dense(torch.tensor(so), kind)
    np.testing.assert_allclose(mat.numpy(), np.asarray(jmat), rtol=1e-15)
    jainv = jcg.setup_cg_lu(jnp.asarray(so), jkind, (False, False),
                            indefinite)
    ainv = cg.setup_cg_lu(torch.tensor(so), kind, indefinite)
    np.testing.assert_allclose(ainv.numpy(), np.asarray(jainv), rtol=1e-10,
                               atol=1e-12 * float(np.abs(jainv).max()))
    want = jcg.solve_cg(jainv, jnp.asarray(b))
    got = cg.solve_cg(ainv, torch.tensor(b))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12 * float(np.abs(want).max()))


def _jax_levels(so, jkind, nlevels):
    settings = JMLSettings.from_config(JConfig({}))
    return jsolver2.setup_hierarchy(jnp.asarray(so), jkind, nlevels, settings)


@pytest.mark.parametrize("case", ["poisson-125x93", "fe-64"])
def test_setup_hierarchy_matches_jax(case):
    if case == "fe-64":
        so, nine = np.asarray(jgallery.fe(64, 64)), True
    else:
        so, nine = np.asarray(jgallery.poisson(125, 93)), False
    kind, jkind = _kinds(nine)
    nlevels = solver2.compute_num_levels(*so.shape[1:], 3)
    assert nlevels == jsolver2.compute_num_levels(*so.shape[1:], 3)
    assert (solver2.level_shapes(*so.shape[1:], nlevels)
            == jsolver2.level_shapes(*so.shape[1:], nlevels))
    want = _jax_levels(so, jkind, nlevels)
    got = solver2.setup_hierarchy(torch.tensor(so), kind, nlevels)
    assert len(got) == len(want) == nlevels
    for lvl, (g, w) in enumerate(zip(got, want)):
        for field in ("so", "recip", "ci", "ainv"):
            gv, wv = getattr(g, field), getattr(w, field)
            assert (gv is None) == (wv is None), (lvl, field)
            if gv is None:
                continue
            wv = np.asarray(wv)
            np.testing.assert_allclose(
                gv.numpy(), wv, rtol=1e-11,
                atol=1e-13 * float(np.abs(wv).max()),
                err_msg=f"level {lvl} {field}")


def test_gallery_fe_hierarchy_is_symmetric():
    """Galerkin coarse operators of a symmetric operator stay symmetric:
    the coarsest dense matrix equals its transpose."""
    levels = solver2.setup_hierarchy(gallery.fe(33, 33, device="cpu"),
                                     StencilKind.nine_pt, 4)
    mat = cg.assemble_dense(levels[-1].so, StencilKind.nine_pt)
    np.testing.assert_allclose(mat.numpy(), mat.T.numpy(), rtol=1e-12,
                               atol=1e-14)
