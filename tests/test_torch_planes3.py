"""The port's 3D plane relaxation (ops/planes3.py) against cedar_tpu.

* ``slice_so`` and ``out_of_plane_apply`` against cedar_tpu.ops.planes3,
  exactly, in float64;
* one zebra plane sweep (``plane_relax``) against cedar_tpu's on the same
  operator, in float64, at (10, 8, 7): xy planes (7, an odd count) and yz
  planes (10, even), 7- and 27-point, DOWN and UP, with the default
  plane-config (one embedded V(2,1) line-xy cycle) and a deep one (20
  embedded cycles);
* the deep sweep against the exact-plane-solve oracle of
  tests/test_planes_3d.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu.config import Config as JConfig
from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import planes3 as jplanes3
from cedar_tpu.ops.relax3 import setup_recip as jsetup_recip
from cedar_tpu.settings import MLSettings as JMLSettings
from cedar_tpu.solver.level import Level as JLevel

from cedar_tpu_torch.config import Config
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import planes3
from cedar_tpu_torch.settings import MLSettings
from cedar_tpu_torch.solver.level import Level

torch.set_num_threads(2)

SHAPE = (10, 8, 7)
# plane-xyz builds the hierarchies of all three orientations
PLANE_CONFS = {
    "default": {"log": [], "solver": {"relaxation": "plane-xyz"}},
    "deep": {"log": [], "solver": {"relaxation": "plane-xyz"},
             "plane-config": {"solver": {"relaxation": "line-xy",
                                         "max-iter": 20, "tol": 1e-14}}},
}


def _kinds(ts):
    return ((StencilKind.twenty_seven_pt, JKind.twenty_seven_pt) if ts
            else (StencilKind.seven_pt, JKind.seven_pt))


def _problem(ts, seed=42):
    from test_kernels_3d import random_so

    rng = np.random.default_rng(seed + ts)
    so = random_so(rng, *SHAPE, ts)
    return so, rng.standard_normal(SHAPE), rng.standard_normal(SHAPE)


@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("orient", ["xy", "xz", "yz"])
def test_slice_and_out_of_plane_match_jax(ts, orient):
    so, x, _ = _problem(ts)
    kind, jkind = _kinds(ts)
    want = np.asarray(jplanes3.slice_so(jnp.asarray(so), jkind, orient))
    got = planes3.slice_so(torch.tensor(so), kind, orient)
    np.testing.assert_array_equal(got.numpy(), np.swapaxes(want, 0, 1))
    assert got.shape[0] == planes3.plane_kind2(kind).ndirs
    axis = planes3.PLANE_SPECS[orient][0]
    want = np.asarray(jplanes3.out_of_plane_apply(
        jnp.asarray(so), jnp.asarray(x), jkind, axis))
    got = planes3.out_of_plane_apply(torch.tensor(so), torch.tensor(x), kind,
                                     axis)
    np.testing.assert_array_equal(got.numpy(), want)


_SETUPS = {}


def _setups(ts, pconf):
    """Both packages' plane hierarchies of one operator (cached: the JAX
    package's vmapped setup compiles slowly on the CPU)."""
    key = (ts, pconf)
    if key not in _SETUPS:
        so, _, _ = _problem(ts)
        kind, jkind = _kinds(ts)
        conf = PLANE_CONFS[pconf]
        jconf = JConfig(conf)
        jsettings = JMLSettings.from_config(jconf)
        jlev = JLevel(so=jnp.asarray(so), recip=jsetup_recip(jnp.asarray(so)))
        jlevels = jplanes3.setup_planes((jlev, jlev), [jkind, jkind],
                                        jsettings, jconf)
        settings = MLSettings.from_config(Config(conf))
        lev = Level(so=torch.tensor(so))
        levels = planes3.setup_planes((lev, lev), [kind, kind], settings)
        _SETUPS[key] = (jlevels[0], jsettings, levels[0], settings)
    return _SETUPS[key]


@pytest.mark.parametrize("pconf", ["default", "deep"])
@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("orient", ["xy", "yz"])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_plane_relax_matches_jax(pconf, ts, orient, updown):
    so, x0, b = _problem(ts)
    kind, jkind = _kinds(ts)
    jlev, jsettings, lev, settings = _setups(ts, pconf)
    want = np.asarray(jplanes3.plane_relax(
        jlev, jkind, jnp.asarray(x0), jnp.asarray(b), orient, updown,
        jsettings))
    tx = torch.tensor(x0)
    got = planes3.plane_relax(lev, kind, tx, torch.tensor(b), orient,
                              updown, settings)
    assert got is tx   # in place
    # JAX's line solves take SPIKE factors on lines of 16+ points and
    # vmapped XLA kernels: another rounding than the port's LDLᵀ sweeps
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                               atol=1e-12 * float(np.abs(want).max()))


@pytest.mark.parametrize("orient", ["xy", "yz"])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_deep_plane_relax_matches_exact_oracle(orient, updown):
    """Deep embedded solves ≈ exact plane solves (tests/test_planes_3d.py's
    oracle: each plane solved by scipy's sparse direct solver)."""
    from test_planes_3d import oracle_plane_sweep

    so, x0, b = _problem(True)
    kind, jkind = _kinds(True)
    _, _, lev, settings = _setups(True, "deep")
    got = planes3.plane_relax(lev, kind, torch.tensor(x0), torch.tensor(b),
                              orient, updown, settings)
    want = oracle_plane_sweep(so, jkind, x0, b, orient, updown)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-11)


def test_colour_hierarchies_are_contiguous_batches():
    """Each orientation holds one hierarchy per zebra colour, over the
    planes c::2, contiguous, with the plane count split as the zebra
    does (7 xy planes: 4 + 3; 10 yz planes: 5 + 5)."""
    _, _, lev, _ = _setups(False, "default")
    for orient, counts in (("xy", (4, 3)), ("yz", (5, 5)), ("xz", (4, 4))):
        for c, hier in enumerate(lev.planes[orient]):
            assert hier[0].so.shape[1] == counts[c]
            for plev in hier:
                assert plev.so.is_contiguous()
                assert plev.ci is None or plev.ci.is_contiguous()
            assert hier[-1].ainv.shape[0] == counts[c]
