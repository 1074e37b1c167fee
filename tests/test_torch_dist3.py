"""The port's distributed 3D path in one world of 8 gloo processes on the
CPU, a (2, 2, 2) mesh, float64, against the port's serial Solver3 and
cedar_tpu's.

* the distributed ops equal the serial ops bit for bit: the sweep DOWN
  and UP with and without the residual (the 27-point sweep's eight
  colours take the residual after the sweep, from a halo of one), the
  residual, the restriction, the interp-add and the interpolation, 7-
  and 27-point, on random operators that store couplings across the
  boundary;
* 7- and 27-point solves at 16³ and at the odd 17³ (padded to 20³, the
  level count the true extents give): x bit for bit with the serial
  port's, the history to rtol 1e-12; the 7-point x against cedar_tpu's
  serial Solver3 at its tests/test_dist.py tolerances (< 1e-12, padded
  < 1e-9; the port's serial 27-point solve is held to cedar_tpu's in
  tests/test_torch_solver3.py);
* periodic axes: x-periodic and triply periodic indefinite
  (``solver.definite: false``, a mean-free b) 7-point solves at 16³, the
  wrap in the halos of the partitioned axes: x bit for bit with the
  serial port's, and against cedar_tpu's serial Solver3 to 1e-11.

The rank function imports neither jax nor cedar_tpu; the test process
computes the references while the world runs.
"""

import copy

import numpy as np
import pytest
import torch

from cedar_tpu_torch import SevenPt, Solver3, TwentySevenPt, gallery
from cedar_tpu_torch.ops import interp3, relax3, stencil3
from cedar_tpu_torch.parallel import DistSolver3, make_mesh, policy
from cedar_tpu_torch.parallel.dist import layouts, local_levels
from cedar_tpu_torch.parallel.halo import DistContext, _cut
from cedar_tpu_torch.parallel.launch import start
from cedar_tpu_torch.solver import solver3

CONF = {"log": [], "solver": {"tol": 1e-9, "max-iter": 12}}
CASES = [("p16", 16, False), ("fe16", 16, True), ("p17", 17, False),
         ("fe17", 17, True)]
# name -> periodic axes (triply periodic: indefinite, b mean-free)
PERIODIC_CASES = {"px16": (True, False, False), "pxyz16": (True, True, True)}


def _periodic_case(per):
    so = gallery.periodic3(gallery.poisson3(16, 16, 16, device="cpu"), per)
    b = gallery.poisson3_rhs(16, 16, 16, device="cpu")
    if all(per):
        b = b - b.mean()
    conf = {"log": [], "grid": {"periodic": list(per)},
            "solver": {"tol": 1e-9, "max-iter": 12,
                       "definite": not all(per)}}
    return so, b, conf


def random_so3(rng, n, full):
    so = np.zeros((14 if full else 4, n, n, n))
    so[1:] = rng.uniform(0.05, 0.5, so[1:].shape)
    so[0] = 4.0 * so[1:].sum(0) + rng.uniform(0.5, 1.0, (n, n, n))
    return torch.tensor(so)


def _ops(mesh, rng):
    errs = {}
    for full in (False, True):
        kind = TwentySevenPt if full else SevenPt
        so = random_so3(rng, 24, full)
        shapes = solver3.level_shapes(24, 24, 24, 3)
        kinds = [kind, TwentySevenPt, TwentySevenPt]
        levels = solver3.setup_hierarchy(so, kind, 3)
        specs = policy.level_specs(shapes, mesh)
        specs[-1] = (None,) * 3
        lays = layouts(shapes, specs, mesh)
        ctx = DistContext(local_levels(levels, mesh, specs), lays, mesh)
        d = DistSolver3(so, kind, {"log": [], "solver": {"num-levels": 3}},
                        mesh)
        e = 0.0
        for a, b in zip(d.levels, local_levels(levels, mesh, specs)):
            e = max(e, float((a.so - b.so).abs().max()))
            if b.ci is not None:
                e = max(e, float((a.ci - b.ci).abs().max()))
        errs[f"setup-{kind.name}"] = e

        def cut(a, lvl):
            return _cut(a, lays[lvl].lo, lays[lvl].hi).contiguous()

        lvl, lev, k = 0, levels[0], kinds[0]
        X, B, R = (torch.tensor(rng.standard_normal(shapes[0]))
                   for _ in range(3))
        CX = torch.tensor(rng.standard_normal(shapes[1]))
        ci = levels[1].ci
        for ud in ("down", "up"):
            for fuse in (False, True):
                want = relax3.point_relax(lev.so, X, B, None, k, ud,
                                          fuse_residual=fuse)
                got = ctx.relax(lvl, k, cut(X, 0), cut(B, 0), ud, fuse)
                if not fuse:
                    want, got = (want,), (got,)
                errs[f"relax-{ud}-{fuse}-{kind.name}"] = max(
                    float((g - cut(w, 0)).abs().max())
                    for g, w in zip(got, want))
        errs[f"residual-{kind.name}"] = float((ctx.residual(
            0, k, cut(X, 0), cut(B, 0)) - cut(stencil3.residual(
                lev.so, X, B, k), 0)).abs().max())
        errs[f"restrict-{kind.name}"] = float((ctx.restrict(
            0, cut(R, 0)) - cut(interp3.restrict(ci, R), 1)).abs().max())
        errs[f"interp_add-{kind.name}"] = float((ctx.interp_add(
            0, cut(CX, 1), cut(R, 0), cut(X, 0)) - cut(interp3.interp_add(
                ci, lev.so, CX, R, X.clone()), 0)).abs().max())
        errs[f"interp-{kind.name}"] = float((ctx.interp(
            0, cut(CX, 1)) - cut(interp3.interp(ci, CX, shapes[0]),
                                 0)).abs().max())
    return errs


def _world(rank):
    mesh = make_mesh(3, shape=(2, 2, 2), device="cpu")
    out = {"ops": _ops(mesh, np.random.default_rng(5))}
    for name, n, full in CASES:
        so = (gallery.fe3(n, n, n, device="cpu") if full
              else gallery.poisson3(n, n, n, device="cpu"))
        kind = TwentySevenPt if full else SevenPt
        b = gallery.poisson3_rhs(n, n, n, device="cpu")
        s = DistSolver3(so, kind, copy.deepcopy(CONF), mesh)
        r = {"x": s.solve(b), "hist": s.history, "specs": s.specs,
             "shape0": s.shapes[0], "nlevels": s.nlevels}
        if rank == 0:
            ser = Solver3(so, kind, copy.deepcopy(CONF))
            r["x_ser"], r["hist_ser"] = ser.solve(b), ser.history
            r["nlevels_ser"] = ser.nlevels
        out[name] = r
    for name, per in PERIODIC_CASES.items():
        so, b, conf = _periodic_case(per)
        s = DistSolver3(so, SevenPt, copy.deepcopy(conf), mesh)
        r = {"x": s.solve(b), "hist": s.history, "specs": s.specs}
        if rank == 0:
            ser = Solver3(so, SevenPt, copy.deepcopy(conf))
            r["x_ser"], r["hist_ser"] = ser.solve(b), ser.history
        out[name] = r
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax.numpy as jnp

    from cedar_tpu import Solver3 as JSolver3
    from cedar_tpu import gallery as jgallery
    from cedar_tpu.core.types import StencilKind as JKind

    w = start(_world, 8, timeout=400,
              init_dir=str(tmp_path_factory.mktemp("world")))
    want = {}
    try:
        for name, n, full in CASES:
            if full:
                continue
            want[name] = np.asarray(JSolver3(
                jgallery.poisson3(n, n, n), JKind.seven_pt,
                copy.deepcopy(CONF)).solve(jgallery.poisson3_rhs(n, n, n)))
        for name, per in PERIODIC_CASES.items():
            so, b, conf = _periodic_case(per)
            want[name] = np.asarray(JSolver3(
                jnp.asarray(so.numpy()), JKind.seven_pt, conf).solve(
                    jnp.asarray(b.numpy())))
    finally:
        got = w.join()
    return got, want


def test_ops_bit_for_bit(world):
    got, _ = world
    for g in got:
        for key, e in g["ops"].items():
            assert e == 0.0, (key, e)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_solve_equals_serial_port(world, name):
    got, _ = world
    r = got[0][name]
    assert r["specs"][0] == ("x", "y", "z")
    assert r["nlevels"] == r["nlevels_ser"]
    if name.endswith("17"):
        assert r["shape0"] == (20, 20, 20) and r["x"].shape == (17, 17, 17)
    assert torch.equal(r["x"], r["x_ser"])
    assert len(r["hist"]) == len(r["hist_ser"])
    np.testing.assert_allclose(r["hist"], r["hist_ser"], rtol=1e-12)
    for g in got[1:]:
        assert torch.equal(g[name]["x"], r["x"])


@pytest.mark.parametrize("name,tol", [("p16", 1e-12), ("p17", 1e-9)])
def test_solve_matches_cedar_tpu(world, name, tol):
    got, want = world
    r = got[0][name]
    assert float(np.abs(r["x"].numpy() - want[name]).max()) < tol


@pytest.mark.parametrize("name", list(PERIODIC_CASES))
def test_periodic_solve_equals_serial_port(world, name):
    got, want = world
    r = got[0][name]
    assert r["specs"][0] == ("x", "y", "z")
    assert torch.equal(r["x"], r["x_ser"])
    assert len(r["hist"]) == len(r["hist_ser"])
    np.testing.assert_allclose(r["hist"], r["hist_ser"], rtol=1e-12)
    for g in got[1:]:
        assert torch.equal(g[name]["x"], r["x"])
    assert float(np.abs(r["x"].numpy() - want[name]).max()) < 1e-11
