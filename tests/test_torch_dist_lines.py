"""The port's distributed line relaxation and periodic axes
(``cedar_tpu_torch.parallel``) in one world of 4 gloo processes on the CPU,
float64, against the port's serial ops and solver and cedar_tpu's
``DistSolver2``.

One world (:func:`_world`, module fixture ``world``) runs every case and
returns its numbers; the rank functions import neither jax nor cedar_tpu,
and the test process computes cedar_tpu's references on
``jax.devices("cpu")[:4]`` while the world runs.

* the gathered line sweep (x and y, DOWN and UP, 5- and 9-point, on the
  (2, 2), (4, 1) and (1, 4) meshes) equals the serial line sweep bit for
  bit, on random operators whose boundary rows store couplings across the
  boundary; one sweep by the distributed SPIKE solve equals it to 1e-12;
* the periodic ops on a (2, 2) mesh (x-, y- and doubly periodic, and an
  odd periodic extent that the level replicates) equal the serial
  periodic ops bit for bit: the sweep with and without the residual, the
  residual, the restriction, the interp-add, the interpolation, the line
  sweeps across and along the wrap, and the setup of a level;
* the solves of cedar_tpu's tests/test_dist.py:205-277 (line-x 9-point
  ``fe``, line-xy ``diag_diffusion`` with the SPIKE workspace on level 0
  for both axes, ml-relax line-x with none, doubly periodic Poisson with
  level 0 partitioned) against cedar_tpu's ``DistSolver2`` at its own
  tolerances (1e-10, 1e-11), and where the gather or the wrap halos run
  (no SPIKE) bit for bit against the serial port; also x-periodic line-x
  (cyclic lines through the gather), ml-relax line-xy V- and W-cycles
  and line-y F-cycles, and line-x on a (1, 4) mesh (lines whole on the
  rank).
"""

import copy
import time

import numpy as np
import pytest
import torch

from cedar_tpu_torch import FivePt, NinePt, Solver2, gallery
from cedar_tpu_torch.ops import interp2, lines2, relax2, stencil2
from cedar_tpu_torch.parallel import DistSolver2, comm, make_mesh, policy
from cedar_tpu_torch.parallel.dist import layouts, local_levels, \
    periodic_specs
from cedar_tpu_torch.parallel.halo import DistContext, _cut
from cedar_tpu_torch.parallel.launch import start
from cedar_tpu_torch.solver import cycle2, solver2

MESHES = ((2, 2), (4, 1), (1, 4))
# name -> (periodic axes, shape, line axes); "odd": x-blocks of 19, so
# the periodic x axis is replicated and level 1's 19 points take K1's
# odd-extent Jacobi phases (a y-line sweep there would meet 19 lines
# across the wrap, which cedar_tpu refuses)
PERIODIC = {"x": ((True, False), (40, 36), ("x", "y")),
            "y": ((False, True), (40, 36), ("x", "y")),
            "xy": ((True, True), (40, 36), ("x", "y")),
            "odd": ((True, False), (38, 36), ("x",))}


def random_so(rng, nx, ny, nine):
    """A diagonally dominant stencil whose every entry, boundary rows
    included, is set (the boundary couplings point outside the domain)."""
    so = np.zeros((5 if nine else 3, nx, ny))
    so[1:] = rng.uniform(0.1, 1.0, so[1:].shape)
    so[0] = 2.0 * so[1:].sum(0) + rng.uniform(0.5, 1.0, (nx, ny))
    return torch.tensor(so)


def _context(levels, kinds, shapes, mesh, periodic=None, spike=False,
             axes=("x", "y")):
    specs = policy.level_specs(shapes, mesh)
    specs[-1] = (None, None)
    specs = periodic_specs(specs, shapes, mesh, periodic)
    lays = layouts(shapes, specs, mesh, periodic)
    ctx = DistContext(local_levels(levels, mesh, specs, periodic), lays,
                      mesh, kinds, axes, spike)
    return ctx, lays, specs


def _line_ops(mesh, rng):
    """max |distributed - serial| of the line sweeps (the gather), and of
    one SPIKE sweep on the (2, 2) mesh."""
    errs = {}
    for nine in (False, True):
        kind = NinePt if nine else FivePt
        so = random_so(rng, 40, 36, nine)
        shapes = solver2.level_shapes(40, 36, 2)
        levels = solver2.setup_hierarchy(so, kind, 2)
        kinds = [kind, NinePt]
        ctx, lays, _ = _context(levels, kinds, shapes, mesh)
        X, B = (torch.tensor(rng.standard_normal(shapes[0]))
                for _ in range(2))

        def cut(a):
            return _cut(a, lays[0].lo, lays[0].hi).contiguous()

        for axis in ("x", "y"):
            sweep = lines2.line_relax_x if axis == "x" else \
                lines2.line_relax_y
            for ud in ("down", "up"):
                want = sweep(so, X.clone(), B, None, kind, ud)
                got = ctx.line_relax(0, axis, kind, cut(X), cut(B), ud)
                errs[f"line-{axis}-{ud}-{kind.name}"] = float(
                    (got - cut(want)).abs().max())
        if mesh.dims == (2, 2):
            sctx, _, _ = _context(levels, kinds, shapes, mesh, spike=True)
            for axis in ("x", "y"):
                assert (0, axis) in sctx.spike
                sweep = lines2.line_relax_x if axis == "x" else \
                    lines2.line_relax_y
                want = sweep(so, X.clone(), B, None, kind, "down")
                got = sctx.line_relax(0, axis, kind, cut(X), cut(B), "down")
                errs[f"spike-{axis}-{kind.name}"] = float(
                    (got - cut(want)).abs().max())
    return errs


def _periodic_ops(mesh, rng):
    """max |distributed - serial| of the periodic ops and setup."""
    out = {}
    for name, (per, (nx, ny), axes) in PERIODIC.items():
        errs = out[name] = {}
        nine = name != "x"
        kind = NinePt if nine else FivePt
        so = random_so(rng, nx, ny, nine)
        shapes = solver2.level_shapes(nx, ny, 3)
        kinds = [kind, NinePt, NinePt]
        levels = solver2.setup_hierarchy(so, kind, 3, periodic=per)
        ctx, lays, specs = _context(levels, kinds, shapes, mesh, per,
                                    axes=axes)
        errs["specs"] = specs
        d = DistSolver2(so, kind, {"log": [], "grid": {"periodic": list(per)},
                                   "solver": {"num-levels": 3}}, mesh)
        e = 0.0
        for a, b in zip(d.levels, local_levels(levels, mesh, specs, per)):
            e = max(e, float((a.so - b.so).abs().max()))
            if b.ci is not None:
                e = max(e, float((a.ci - b.ci).abs().max()))
        errs["setup"] = e
        for lvl in range(2):
            lev, k = levels[lvl], kinds[lvl]
            X, B, R = (torch.tensor(rng.standard_normal(shapes[lvl]))
                       for _ in range(3))
            CX = torch.tensor(rng.standard_normal(shapes[lvl + 1]))
            ci = levels[lvl + 1].ci

            def cut(a, lv=lvl):
                return _cut(a, lays[lv].lo, lays[lv].hi).contiguous()

            tag = f"l{lvl}"
            for ud in ("down", "up"):
                for fuse in (False, True):
                    want = relax2.point_relax(lev.so, X, B, None, k, ud,
                                              fuse_residual=fuse,
                                              periodic=per)
                    got = ctx.relax(lvl, k, cut(X), cut(B), ud, fuse)
                    if not fuse:
                        want, got = (want,), (got,)
                    errs[f"relax-{ud}-{fuse}-{tag}"] = max(
                        float((g - cut(w)).abs().max())
                        for g, w in zip(got, want))
            errs[f"residual-{tag}"] = float((ctx.residual(
                lvl, k, cut(X), cut(B)) - cut(stencil2.residual(
                    lev.so, X, B, k, per))).abs().max())
            errs[f"restrict-{tag}"] = float((ctx.restrict(
                lvl, cut(R)) - cut(interp2.restrict(ci, R, per),
                                   lvl + 1)).abs().max())
            errs[f"interp_add-{tag}"] = float((ctx.interp_add(
                lvl, cut(CX, lvl + 1), cut(R), cut(X)) - cut(
                    interp2.interp_add(ci, lev.so, CX, R, X.clone(),
                                       per))).abs().max())
            errs[f"interp-{tag}"] = float((ctx.interp(
                lvl, cut(CX, lvl + 1)) - cut(interp2.interp(
                    ci, CX, shapes[lvl], per))).abs().max())
            for axis in axes:
                sweep = lines2.line_relax_x if axis == "x" else \
                    lines2.line_relax_y
                want = sweep(lev.so, X.clone(), B, None, k, "down", per)
                got = ctx.line_relax(lvl, axis, k, cut(X), cut(B), "down")
                errs[f"line-{axis}-{tag}"] = float(
                    (got - cut(want)).abs().max())
    return out


CONF_LX = {"log": [], "solver": {"relaxation": "line-x", "tol": 1e-8,
                                 "max-iter": 20}}
CONF_LXY = {"log": [], "solver": {"relaxation": "line-xy", "tol": 1e-8,
                                  "max-iter": 25}}
CONF_ML = {"log": [], "solver": {"relaxation": "line-x", "tol": 1e-8,
                                 "max-iter": 20,
                                 "ml-relax": {"enabled": True}}}
CONF_PER = {"log": [], "solver": {"tol": 1e-8, "max-iter": 20},
            "grid": {"periodic": [True, True]}}
CONF_PERLX = {"log": [], "solver": {"relaxation": "line-x", "tol": 1e-8,
                                    "max-iter": 20},
              "grid": {"periodic": [True, False]}}
CONF_MLXY = {"log": [], "solver": {"relaxation": "line-xy", "tol": 1e-30,
                                   "max-iter": 3,
                                   "ml-relax": {"enabled": True}}}
CONF_MLF = {"log": [], "solver": {"relaxation": "line-y", "tol": 1e-30,
                                  "max-iter": 3, "cycle": {"type": "f"},
                                  "ml-relax": {"enabled": True}}}
N = 64


def _operator(which):
    if which == "fe":
        return gallery.fe(N, N, device="cpu")
    if which == "dd":
        return gallery.diag_diffusion(N, N, 50.0, 1.0, device="cpu")
    return gallery.poisson(N, N, device="cpu")


# key -> (operator, kind, conf, mesh)
SOLVES = {
    "lx_fe": ("fe", NinePt, CONF_LX, (2, 2)),
    "lxy_dd": ("dd", FivePt, CONF_LXY, (2, 2)),
    "ml_fe": ("fe", NinePt, CONF_ML, (2, 2)),
    "per_p": ("p", FivePt, CONF_PER, (2, 2)),
    "perlx_p": ("p", FivePt, CONF_PERLX, (2, 2)),
    "mlxy_fe": ("fe", NinePt, CONF_MLXY, (2, 2)),
    "mlf_dd": ("dd", FivePt, CONF_MLF, (2, 2)),
    "lx_fe_14": ("fe", NinePt, CONF_LX, (1, 4)),
}


def _world(rank):
    """Every case on this rank; returns its numbers and seconds."""
    t0 = time.perf_counter()
    out = {"ops": {}}
    meshes = {shape: make_mesh(2, shape=shape, device="cpu")
              for shape in MESHES}
    for shape, mesh in meshes.items():
        out["ops"][shape] = _line_ops(mesh, np.random.default_rng(3))
    out["periodic"] = _periodic_ops(meshes[(2, 2)],
                                    np.random.default_rng(5))
    b = gallery.poisson_rhs(N, N, device="cpu")
    for key, (which, kind, conf, shape) in SOLVES.items():
        so = _operator(which)
        s = DistSolver2(so, kind, copy.deepcopy(conf), meshes[shape])
        x = s.solve(b)
        r = {"x": x, "hist": s.history, "specs": s.specs,
             "spike": sorted(s.dist.spike)}
        # one counted cycle (a new b block, as the first of a solve)
        comm.reset()
        cycle2.cycle_residual(s.levels, s.kinds, s._block(x),
                              s._block(b), s.settings, s.periodic,
                              dist=s.dist)
        r["comm"] = comm.counts()
        if rank == 0:
            ser = Solver2(so, kind, copy.deepcopy(conf))
            r["x_ser"], r["hist_ser"] = ser.solve(b), ser.history
        out[key] = r
        if key == "mlxy_fe":
            # a W-cycle (n = 2) from a random iterate
            x0 = torch.tensor(np.random.default_rng(3).standard_normal(
                (N, N)))
            xb = cycle2.ncycle(s.levels, s.kinds, 0, s._block(x0),
                               s._block(b), s.settings, n=2, dist=s.dist)
            out["w_" + key] = {"x": s.dist.gather(xb)}
            if rank == 0:
                out["w_" + key]["x_ser"] = cycle2.ncycle(
                    ser.levels, ser.kinds, 0, x0.clone(), b, ser.settings,
                    n=2)
    out["seconds"] = time.perf_counter() - t0
    return out


# the solves held to cedar_tpu: its DistSolver2 where the world's solve
# runs no SPIKE, its serial Solver2 (which its tests/test_dist.py:205-241
# hold its DistSolver2 to at atol 1e-10) where it does, whose distributed
# SPIKE setup alone compiles for minutes on the CPU; the choice of SPIKE
# per level and axis is held to cedar_tpu's dist_spike_eligible instead
JAX_SOLVES = {"lx_fe": ("serial", 1e-10), "lxy_dd": ("serial", 1e-10),
              "ml_fe": ("dist", 1e-10), "per_p": ("dist", 1e-11)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's results and cedar_tpu's references, computed by the
    test process while the world runs."""
    import jax

    from cedar_tpu import Solver2 as JSolver2
    from cedar_tpu import gallery as jgallery
    from cedar_tpu.core.types import StencilKind as JKind
    from cedar_tpu.parallel import DistSolver2 as JDist2, make_mesh as jmesh

    w = start(_world, 4, timeout=400,
              init_dir=str(tmp_path_factory.mktemp("world")))
    want = {}
    try:
        m = jmesh(2, devices=jax.devices("cpu")[:4], shape=(2, 2))
        jops = {"fe": jgallery.fe(N, N),
                "dd": jgallery.diag_diffusion(N, N, 50.0, 1.0),
                "p": jgallery.poisson(N, N)}
        b = jgallery.poisson_rhs(N, N)
        for key, (how, _) in JAX_SOLVES.items():
            which, kind, conf, _ = SOLVES[key]
            jkind = JKind.nine_pt if kind == NinePt else JKind.five_pt
            if how == "dist":
                js = JDist2(jops[which], jkind, copy.deepcopy(conf), m)
            else:
                js = JSolver2(jops[which], jkind, copy.deepcopy(conf))
            want[key] = np.asarray(js.solve(b))
    finally:
        got = w.join()
    return got, want


def test_world_seconds(world):
    got, _ = world
    assert got[0]["seconds"] < 300


@pytest.mark.parametrize("shape", MESHES)
def test_line_sweep_bit_for_bit(world, shape):
    got, _ = world
    for g in got:
        errs = g["ops"][shape]
        keys = [k for k in errs if k.startswith("line-")]
        assert len(keys) == 8
        for key in keys:
            assert errs[key] == 0.0, (shape, key, errs[key])


def test_spike_sweep_matches_serial(world):
    got, _ = world
    for g in got:
        errs = g["ops"][(2, 2)]
        keys = [k for k in errs if k.startswith("spike-")]
        assert len(keys) == 4
        for key in keys:
            assert errs[key] < 1e-12, (key, errs[key])


@pytest.mark.parametrize("name", list(PERIODIC))
def test_periodic_ops_bit_for_bit(world, name):
    got, _ = world
    for g in got:
        errs = dict(g["periodic"][name])
        specs = errs.pop("specs")
        assert len(errs) >= 19
        for key, e in errs.items():
            assert e == 0.0, (key, e)
    if name == "odd":
        # 42 / 2 = 21: an odd block on a periodic axis is replicated
        assert specs[0] == (None, "y")
    else:
        assert specs[0] == ("x", "y")


@pytest.mark.parametrize("key", ["ml_fe", "per_p", "perlx_p", "mlxy_fe",
                                 "mlf_dd", "lx_fe_14"])
def test_solves_equal_serial_port(world, key):
    got, _ = world
    r = got[0][key]
    assert r["spike"] == []
    assert torch.equal(r["x"], r["x_ser"])
    assert len(r["hist"]) == len(r["hist_ser"])
    np.testing.assert_allclose(r["hist"], r["hist_ser"], rtol=1e-12)
    for g in got[1:]:
        assert torch.equal(g[key]["x"], r["x"])


def test_w_cycle_equals_serial(world):
    r = world[0][0]["w_mlxy_fe"]
    assert torch.equal(r["x"], r["x_ser"])


@pytest.mark.parametrize("key", ["lx_fe", "lxy_dd"])
def test_spike_solves_match_serial_port(world, key):
    got, _ = world
    r = got[0][key]
    assert (0, "x") in r["spike"]
    assert float((r["x"] - r["x_ser"]).abs().max()) < 1e-10
    assert len(r["hist"]) == len(r["hist_ser"])


@pytest.mark.parametrize("key", list(JAX_SOLVES))
def test_solves_match_cedar_tpu(world, key):
    got, want = world
    r = got[0][key]
    np.testing.assert_allclose(r["x"].numpy(), want[key],
                               atol=JAX_SOLVES[key][1])
    if key == "per_p":
        assert r["specs"][0] == ("x", "y")


@pytest.mark.parametrize("key", ["lx_fe", "lxy_dd", "lx_fe_14"])
def test_spike_choice_matches_cedar_tpu(world, key):
    """SPIKE on the levels and axes where cedar_tpu's DistSolver2 takes
    it (cedar_tpu/parallel/dist.py:292-322); line-xy on the (2, 2) mesh
    takes it on level 0 for both axes."""
    import jax
    from cedar_tpu.ops.lines2 import dist_spike_eligible
    from jax.sharding import Mesh as JMesh

    got, _ = world
    r = got[0][key]
    _, _, conf, shape = SOLVES[key]
    mesh = JMesh(np.asarray(jax.devices("cpu")[:4]).reshape(shape),
                 ("x", "y"))
    shapes = solver2.level_shapes(N, N, len(r["specs"]))
    axes = {"line-x": ("x",), "line-xy": ("x", "y")}[
        conf["solver"]["relaxation"]]
    want = sorted((lvl, axis) for lvl in range(len(shapes) - 1)
                  for axis in axes
                  if dist_spike_eligible(shapes[lvl], r["specs"][lvl], mesh,
                                         (False, False), axis))
    assert r["spike"] == want
    if key == "lxy_dd":
        assert (0, "x") in want and (0, "y") in want


@pytest.mark.parametrize("key", [k for k in SOLVES if k != "mlf_dd"])
def test_communication_as_predicted(world, key):
    """A cycle's exchanges, bytes, gathers and reductions on rank 0 (the
    mesh's corner) are tools/dist_comm.py's prediction from the layouts."""
    from cedar_tpu_torch.tools.dist_comm import predict

    got, _ = world
    r = got[0][key]
    _, kind, conf, shape = SOLVES[key]
    st = conf["solver"]
    shapes = solver2.level_shapes(N, N, len(r["specs"]))
    want = predict(shapes, r["specs"], shape, 8,
                   st.get("cycle", {}).get("nrelax-pre", 2),
                   st.get("cycle", {}).get("nrelax-post", 1),
                   4 if kind == NinePt else 2, 4,
                   st.get("relaxation", "point"),
                   st.get("ml-relax", {}).get("enabled", False),
                   conf.get("grid", {}).get("periodic"))
    for k in ("exchanges", "exchange_bytes", "wrap_exchanges", "gathers",
              "line_gathers", "spike_gathers", "reductions"):
        assert r["comm"][k] == want[k], (k, r["comm"][k], want[k])
