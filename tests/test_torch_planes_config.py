"""Plane-config beyond line-xy V-cycles: the port against cedar_tpu.

* The batched plain versions of the kernels these configurations add
  (K1's batched sweep, K4's batched x- and y-line sweeps, which K10's
  one-direction mode runs on the card, and K5's batched interpolation):
  every plane of a batch equals the unbatched plain version bit for bit,
  and cedar_tpu's XLA functions under ``jax.vmap`` to 1e-12 relative
  (float64): odd and even plane counts, one-row planes, lines of 63-65
  points (the line sweeps against cedar_tpu's at two of them).
* One zebra plane sweep (``plane_relax``) against cedar_tpu's with
  plane-config point, line-x and line-y relaxation, the F-cycle and
  ``cg-solver: cedar`` (an inner multigrid solve on every plane's
  coarsest grid), xy planes (7 or 9, odd counts) and yz planes (10,
  even), 7- and 27-point, at (10, 8, 7) ((10, 10, 9) for the inner solve).
* Whole solves against cedar_tpu's ``Solver3`` (histories rtol 1e-9,
  atol 1e-14; x to 1e-10 of max |x|): plane-xy, plane-yz and plane-xyz,
  odd and even plane counts, 7- and 27-point, each new plane-config.
* A JAX plane hierarchy with inner hierarchies carried across
  (``levels_from_numpy``): the port's cycle on it equals the port's cycle
  on its own setup to 1e-12.

The CUDA kernels run only on the card; chip_smoke.py holds them against
the plain versions checked here.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu import Solver3 as JSolver3
from cedar_tpu import gallery as jgallery
from cedar_tpu.config import Config as JConfig
from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import interp2 as jinterp2
from cedar_tpu.ops import lines2 as jlines2
from cedar_tpu.ops import planes3 as jplanes3
from cedar_tpu.ops import relax2 as jrelax2
from cedar_tpu.ops.relax3 import setup_recip as jsetup_recip
from cedar_tpu.ops.stencil2 import residual as jresidual
from cedar_tpu.settings import MLSettings as JMLSettings
from cedar_tpu.solver.level import Level as JLevel

from cedar_tpu_torch import SevenPt, Solver3, TwentySevenPt
from cedar_tpu_torch.config import Config
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import (
    cuda2, cuda_lines2, cuda_planes2, cuda_transfer2, interp2, planes3,
    stencil2,
)
from cedar_tpu_torch.settings import MLSettings
from cedar_tpu_torch.solver import cycle2
from cedar_tpu_torch.solver.level import Level, levels_from_numpy

torch.set_num_threads(2)


def _batch(seed, B, nx, ny, nine):
    """B random diagonally dominant planes, float64: so (ndir, B, nx, ny),
    q, b (B, nx, ny)."""
    from test_kernels_2d import random_so

    rng = np.random.default_rng(seed)
    so = np.stack([random_so(rng, nx, ny, nine) for _ in range(B)], axis=1)
    return so, rng.standard_normal((B, nx, ny)), rng.standard_normal(
        (B, nx, ny))


def _kinds2(nine):
    return ((StencilKind.nine_pt, JKind.nine_pt) if nine
            else (StencilKind.five_pt, JKind.five_pt))


def _close(got, want):
    """1e-12 relative to the largest value."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * float(np.abs(want).max()))


def _planes(t, i):
    """Plane i of a batched tensor: axis 1 of a stencil or CI, else 0."""
    return (t[:, i] if t.ndim == 4 else t[i]).contiguous()


# (B, nx, ny): an odd and an even plane count, one-row planes, lines of
# 63 and 65 points (the LDLᵀ recurrence and PCR)
BATCHES = [(3, 9, 7), (4, 8, 8), (3, 1, 6), (2, 65, 9), (2, 7, 63)]
# the batches the line sweeps are also held to cedar_tpu's at (its zebra
# sweeps compile per shape)
LINES_JAX = [(3, 9, 7), (2, 65, 9)]


@pytest.mark.parametrize("shape", BATCHES)
@pytest.mark.parametrize("nine", [False, True])
def test_batched_sweep(shape, nine):
    """K1's plain version on a batch: DOWN and UP, with and without the
    residual; plane by plane bit for bit, and cedar_tpu's sweep (and
    residual) under vmap."""
    kind, jkind = _kinds2(nine)
    so, q, b = _batch(11 + shape[1] + nine, *shape, nine)
    tso, tq, tb = (torch.tensor(a) for a in (so, q, b))
    jso = jnp.asarray(np.swapaxes(so, 0, 1))
    for updown in ("down", "up"):
        for fuse in (False, True):
            got = cuda2.sweep_plain(tso, tq, tb, kind, updown, fuse)
            got = got if fuse else (got,)
            for i in range(shape[0]):
                one = cuda2.sweep_plain(_planes(tso, i), _planes(tq, i),
                                        _planes(tb, i), kind, updown, fuse)
                for g, w in zip(got, one if fuse else (one,)):
                    assert torch.equal(g[i], w)

            def ref(s, qq, bb):
                x = jrelax2.point_relax(s, qq, bb, 1.0 / s[0], jkind, updown)
                return x, jresidual(s, x, bb, jkind)

            wx, wres = jax.jit(jax.vmap(ref))(jso, jnp.asarray(q),
                                              jnp.asarray(b))
            _close(got[0].numpy(), wx)
            if fuse:
                _close(got[1].numpy(), wres)
    np.testing.assert_array_equal(tq.numpy(), q)


@pytest.mark.parametrize("shape", BATCHES)
@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("axis", ["x", "y"])
def test_batched_line_sweeps(shape, nine, axis):
    """K4's batched plain versions (``line_x_plain`` / ``line_y_plain`` on
    a batch, and K10's one-direction plain version, 2 sweeps and the
    residual): plane by plane bit for bit, and cedar_tpu's zebra sweep
    under vmap."""
    kind, jkind = _kinds2(nine)
    so, q, b = _batch(23 + shape[1] + nine, *shape, nine)
    tso, tb = torch.tensor(so), torch.tensor(b)
    plain = (cuda_lines2.line_x_plain if axis == "x"
             else cuda_lines2.line_y_plain)
    jrelax = jlines2.line_relax_x if axis == "x" else jlines2.line_relax_y
    for updown in ("down", "up"):
        got = plain(tso, torch.tensor(q), tb, kind, updown)
        for i in range(shape[0]):
            one = plain(_planes(tso, i), torch.tensor(q[i]), _planes(tb, i),
                        kind, updown)
            assert torch.equal(got[i], one)

        def ref(s, qq, bb):
            return jrelax(s, qq, bb, jlines2.setup_lines(s, jkind, axis),
                          jkind, updown)

        if shape in LINES_JAX:
            want = jax.jit(jax.vmap(ref))(
                jnp.asarray(np.swapaxes(so, 0, 1)), jnp.asarray(q),
                jnp.asarray(b))
            _close(got.numpy(), want)
        # K10's one-direction plain version: the same sweeps, then the
        # residual
        tq2 = torch.tensor(q)
        two, res = cuda_planes2.smooth_plain(tso, tq2, tb, kind, updown, 2,
                                             True, axes=axis)
        assert two is tq2
        again = plain(tso, plain(tso, torch.tensor(q), tb, kind, updown),
                      tb, kind, updown)
        assert torch.equal(two, again)
        assert torch.equal(res, stencil2.residual(tso, again, tb, kind))


@pytest.mark.parametrize("shape", BATCHES)
@pytest.mark.parametrize("nine", [False, True])
def test_batched_interp(shape, nine):
    """K5's batched plain version: plane by plane bit for bit, and
    cedar_tpu's interpolation (``interp_add`` of zero residual onto zero,
    its F-cycle's level entry) under vmap."""
    kind, jkind = _kinds2(nine)
    so, _, _ = _batch(37 + shape[1] + nine, *shape, nine)
    tso = torch.tensor(so)
    ci = interp2.setup_interp(tso, kind)
    nc = (ci.shape[-2] - 1, ci.shape[-1] - 1)
    qc = torch.tensor(np.random.default_rng(5).standard_normal(
        (shape[0], *nc)))
    got = cuda_transfer2.interp_plain(ci, qc, shape)
    for i in range(shape[0]):
        assert torch.equal(got[i], cuda_transfer2.interp_plain(
            _planes(ci, i), qc[i], shape[1:]))
    zero = jnp.zeros(shape[1:])
    want = jax.jit(jax.vmap(lambda c, s, qq: jinterp2.interp_add(
        c, s, qq, zero, zero)))(jnp.asarray(np.swapaxes(ci.numpy(), 0, 1)),
                                jnp.asarray(np.swapaxes(so, 0, 1)),
                                jnp.asarray(qc.numpy()))
    _close(got.numpy(), want)


def test_batched_ops_check_operands():
    """A batch of planes is never periodic; K4 itself takes one plane."""
    so, q, b = (torch.tensor(a) for a in _batch(1, 2, 6, 5, False))
    kind = StencilKind.five_pt
    with pytest.raises(ValueError, match="never periodic"):
        cuda2.sweep_plain(so, q, b, kind, "down", periodic=(True, False))
    with pytest.raises(ValueError, match="never periodic"):
        cuda_lines2.line_x_plain(so, q, b, kind, "down",
                                 periodic=(False, True))
    with pytest.raises(ValueError, match="axes"):
        cuda_planes2.smooth_plain(so, q, b, kind, "down", axes="z")
    with pytest.raises(ValueError, match="qc"):
        cuda_transfer2.interp_plain(interp2.setup_interp(so, kind), q,
                                    (2, 6, 5))


# --- one zebra plane sweep ---------------------------------------------

SHAPE = (10, 8, 7)
# plane-config name -> its config
PCONFS = {
    "point": {"solver": {"relaxation": "point"}},
    "line-x": {"solver": {"relaxation": "line-x"}},
    "line-y": {"solver": {"relaxation": "line-y", "max-iter": 2}},
    "fcycle": {"solver": {"relaxation": "line-xy", "cycle": {"type": "f"}}},
    # plane hierarchies take every level to min-coarse (cedar_tpu/ops/
    # planes3.py): 5 stops them at 5²-7², whose inner solvers have 2
    # levels
    "cedar": {"solver": {"relaxation": "point", "cg-solver": "cedar",
                         "min-coarse": 5},
              "cg-config": {"solver": {"tol": 1e-3, "max-iter": 4,
                                       "relaxation": "line-x"}}},
}
# (plane-config, 27-point, orientation, sweep order)
SWEEPS = [("point", False, "xy", "down"), ("line-x", True, "yz", "down"),
          ("line-y", False, "xy", "up"), ("fcycle", True, "xy", "up"),
          ("cedar", True, "yz", "down")]


def _kinds3(ts):
    return ((StencilKind.twenty_seven_pt, JKind.twenty_seven_pt) if ts
            else (StencilKind.seven_pt, JKind.seven_pt))


def _shape(pconf):
    """(10, 8, 7), or for the inner solve (10, 10, 9): planes of 9² and
    more keep a level above their min-coarse 5."""
    return (10, 10, 9) if pconf == "cedar" else SHAPE


def _problem3(ts, shape=SHAPE, seed=42):
    from test_kernels_3d import random_so

    rng = np.random.default_rng(seed + ts)
    so = random_so(rng, *shape, ts)
    return so, rng.standard_normal(shape), rng.standard_normal(shape)


_SETUPS = {}


def _setups(ts, pconf):
    """Both packages' plane hierarchies of one operator (cached: the JAX
    package's vmapped setup compiles slowly on the CPU)."""
    key = (ts, pconf)
    if key not in _SETUPS:
        so, _, _ = _problem3(ts, _shape(pconf))
        kind, jkind = _kinds3(ts)
        conf = {"log": [], "solver": {"relaxation": "plane-xyz"},
                "plane-config": PCONFS[pconf]}
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


@pytest.mark.parametrize("pconf, ts, orient, updown", SWEEPS)
def test_plane_relax_matches_jax(pconf, ts, orient, updown):
    so, x0, b = _problem3(ts, _shape(pconf))
    kind, jkind = _kinds3(ts)
    jlev, jsettings, lev, settings = _setups(ts, pconf)
    if pconf == "cedar":
        # every plane's coarsest level holds a batched inner hierarchy
        hier = lev.planes[orient][0]
        assert hier[-1].inner is not None and hier[-1].ainv is None
        assert hier[-1].inner[0].so.shape == hier[-1].so.shape
        assert len(hier[-1].inner) == 2
    want = np.asarray(jplanes3.plane_relax(
        jlev, jkind, jnp.asarray(x0), jnp.asarray(b), orient, updown,
        jsettings))
    tx = torch.tensor(x0)
    got = planes3.plane_relax(lev, kind, tx, torch.tensor(b), orient,
                              updown, settings)
    assert got is tx   # in place
    # JAX's line solves take SPIKE factors on lines of 16+ points: another
    # rounding than the port's LDLᵀ sweeps
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                               atol=1e-12 * float(np.abs(want).max()))


# --- whole solves ----------------------------------------------------------


def _aniso3(nx, ny, nz):
    return jgallery.diag_diffusion3(nx, ny, nz, 1.0, 1.0, 1e-3)


def _aniso_x(nx, ny, nz):
    return jgallery.diag_diffusion3(nx, ny, nz, 1e-3, 1.0, 1.0)


# name -> (JAX operator, port kind, JAX kind, shape, relaxation, plane-config)
SOLVES = {
    "xy-point-7pt-odd": (_aniso3, SevenPt, JKind.seven_pt, (8, 8, 7),
                         "plane-xy", PCONFS["point"]),
    "yz-line-x-27pt-even": (jgallery.fe3, TwentySevenPt,
                            JKind.twenty_seven_pt, (8, 7, 6), "plane-yz",
                            PCONFS["line-x"]),
    "xyz-line-y-7pt-odd": (jgallery.poisson3, SevenPt, JKind.seven_pt,
                           (7, 7, 7), "plane-xyz", PCONFS["line-y"]),
    "xy-fcycle-point-27pt-even": (
        jgallery.fe3, TwentySevenPt, JKind.twenty_seven_pt, (7, 7, 8),
        "plane-xy", {"solver": {"relaxation": "point",
                                "cycle": {"type": "f"}}}),
    "yz-fcycle-7pt-odd": (_aniso_x, SevenPt, JKind.seven_pt, (9, 8, 8),
                          "plane-yz", PCONFS["fcycle"]),
    "xy-cedar-7pt-odd": (_aniso3, SevenPt, JKind.seven_pt, (10, 10, 7),
                         "plane-xy", {
                             "solver": {"relaxation": "line-xy",
                                        "cg-solver": "cedar",
                                        "min-coarse": 5},
                             "cg-config": {"solver": {"tol": 1e-3,
                                                      "max-iter": 3}}}),
    "yz-cedar-27pt-even": (jgallery.fe3, TwentySevenPt,
                           JKind.twenty_seven_pt, (8, 10, 10), "plane-yz",
                           PCONFS["cedar"]),
}

_SOLVED = {}


def solved(name):
    """cedar_tpu's solve of the case and the port's solver (cached)."""
    if name not in _SOLVED:
        make, kind, jkind, shape, relax, pconf = SOLVES[name]
        so = np.asarray(make(*shape))
        b = np.asarray(jgallery.poisson3_rhs(*shape))
        conf = {"log": [], "solver": {"relaxation": relax, "tol": 1e-9,
                                      "max-iter": 8},
                "plane-config": pconf}
        js = JSolver3(jnp.asarray(so), jkind, conf)
        jx = np.asarray(js.solve(jnp.asarray(b)))
        _SOLVED[name] = (js, jx, so, b, Solver3(torch.tensor(so), kind, conf))
    return _SOLVED[name]


@pytest.mark.parametrize("name", list(SOLVES))
def test_plane_config_solve_matches_jax(name):
    js, jx, so, b, s = solved(name)
    x = s.solve(torch.tensor(b))
    print(f"{name}: {len(s.history)} cycles, {s.history}")
    assert s.nlevels == js.nlevels
    assert len(s.history) == len(js.history)
    np.testing.assert_allclose(s.history, js.history, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0,
                               atol=1e-10 * float(np.abs(jx).max()))


def test_carried_inner_plane_hierarchy():
    """A JAX plane hierarchy whose plane solvers hold inner hierarchies
    (plane-config ``cg-solver: cedar``) carried across: each colour's
    coarsest plane level holds the batched inner hierarchy of its planes,
    and the port's cycle on it equals the port's cycle on its own setup to
    1e-12."""
    js, _, so, b, s = solved("yz-cedar-27pt-even")
    levels = levels_from_numpy(
        [{k: v for k, v in lev._asdict().items() if v is not None}
         for lev in js.levels], dtype=torch.float64)
    for c, hier in enumerate(levels[0].planes["yz"]):
        own = s.levels[0].planes["yz"][c]
        assert hier[-1].inner is not None and hier[-1].ainv is None
        assert len(hier[-1].inner) == len(own[-1].inner)
        for a, o in zip(hier[-1].inner, own[-1].inner):
            assert a.so.shape == o.so.shape
    x0 = torch.tensor(np.random.default_rng(3).standard_normal(b.shape))
    tb = torch.tensor(b)
    mine = s.vcycle(x0, tb)
    t = copy.copy(s)
    t.levels = levels
    got = t.vcycle(x0, tb)
    np.testing.assert_allclose(got.numpy(), mine.numpy(), rtol=0,
                               atol=1e-12 * float(mine.abs().max()))
    # and one embedded plane cycle with its inner solve, on the carried
    # colour hierarchy against the port's own
    hier, own = levels[0].planes["yz"][1], s.levels[0].planes["yz"][1]
    kinds = [StencilKind.nine_pt] * len(own)
    ps = s.settings.plane_settings
    q = torch.tensor(np.random.default_rng(4).standard_normal(
        tuple(own[0].so.shape[1:])))
    rhs = torch.tensor(np.random.default_rng(5).standard_normal(
        tuple(own[0].so.shape[1:])))
    a = cycle2.run_cycle(hier, kinds, q.clone(), rhs, ps)
    w = cycle2.run_cycle(own, kinds, q.clone(), rhs, ps)
    np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0,
                               atol=1e-12 * float(w.abs().max()))
