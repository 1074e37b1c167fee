"""The port's distributed 2D path (``cedar_tpu_torch.parallel``) in one
world of 4 gloo processes on the CPU, float64, against the port's serial
solver and cedar_tpu.

One world (:func:`_world`, module fixture ``world``) runs every case and
returns its numbers; the tests compare them.  The rank functions import
neither jax nor cedar_tpu: the references come from the test process,
which computes them while the world runs.

* every distributed op on a (2, 2) mesh equals the serial op on the whole
  array, bit for bit: the sweep DOWN and UP, with and without the fused
  residual, the residual, the restriction, the interp-add and the
  interpolation, 5- and 9-point, on random operators whose boundary rows
  store couplings across the boundary, at a level with an odd block (its
  restriction gathered onto a replicated level); a level's distributed
  setup (CI and the coarse stencil) equals the serial setup's blocks;
* V-, W- and F-cycle solves, 5- and 9-point (the F-cycle both), and the
  128² ``cg-solver: redist`` solve: x bit for bit with the serial port's,
  the history to rtol 1e-12 with the same cycle count, and
  x against cedar_tpu's serial Solver2 at the tolerances of its own
  tests/test_dist.py (96² < 1e-12 and the padded 65² < 1e-9, solved to
  tol 1e-9; meshes (4, 1), (1, 4), (2, 2) < 1e-11 and the manual path <
  1e-10, its specs cedar_tpu's, after four cycles in both packages);
* agglomeration equivalence (``redist.min-local`` 10**9) and ``redist``
  against LU (< 1e-10, tests/test_cgsolve.py);
* one distributed cycle over cedar_tpu's own hierarchy (cut by
  ``local_levels``) against cedar_tpu's ``DistSolver2.vcycle``;
* ``capi`` with ``mesh=`` (float64, x to 1e-12 of max |x|) and
  ``examples/basic_2d_dist`` (float32: the printed error norms to rtol
  1e-3, as tests/test_torch_examples.py holds the serial ones) against
  cedar_tpu's;
* without a card ``make_mesh`` raises unless given a CPU device.
"""

import copy
import os
import re
import runpy
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cedar_tpu_torch import FivePt, NinePt, Solver2, gallery
from cedar_tpu_torch.ops import interp2, relax2, stencil2
from cedar_tpu_torch.parallel import DistSolver2, make_mesh, policy
from cedar_tpu_torch.parallel.dist import layouts, local_levels
from cedar_tpu_torch.parallel.halo import DistContext, _cut
from cedar_tpu_torch.parallel.launch import start
from cedar_tpu_torch.solver import cycle2, solver2
from cedar_tpu_torch.solver.level import levels_from_numpy

CONF = {"log": [], "solver": {"tol": 1e-9, "max-iter": 30}}
# four cycles, whatever the residual: the cases compared cycle for cycle
# (both packages run the same four)
CONF4 = {"log": [], "solver": {"tol": 1e-30, "max-iter": 4}}
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def random_so(rng, nx, ny, nine):
    """A diagonally dominant stencil whose every entry, boundary rows
    included, is set (the boundary couplings point outside the domain)."""
    so = np.zeros((5 if nine else 3, nx, ny))
    so[1:] = rng.uniform(0.1, 1.0, so[1:].shape)
    so[0] = 2.0 * so[1:].sum(0) + rng.uniform(0.5, 1.0, (nx, ny))
    return torch.tensor(so)


def _ops(mesh, rng):
    """max |distributed - serial| of every op and of the setup."""
    errs = {}
    for nine in (False, True):
        kind = NinePt if nine else FivePt
        so = random_so(rng, 40, 36, nine)
        shapes = solver2.level_shapes(40, 36, 3)
        kinds = [kind, NinePt, NinePt]
        levels = solver2.setup_hierarchy(so, kind, 3)
        specs = policy.level_specs(shapes, mesh)
        specs[-1] = (None, None)
        lays = layouts(shapes, specs, mesh)
        ctx = DistContext(local_levels(levels, mesh, specs), lays, mesh)
        d = DistSolver2(so, kind, {"log": [], "solver": {"num-levels": 3}},
                        mesh)
        mine = local_levels(levels, mesh, specs)
        e = 0.0
        for a, b in zip(d.levels, mine):
            e = max(e, float((a.so - b.so).abs().max()))
            if b.ci is not None:
                e = max(e, float((a.ci - b.ci).abs().max()))
        errs[f"setup-{kind.name}"] = e
        errs[f"specs-{kind.name}"] = specs

        def cut(a, lvl):
            return _cut(a, lays[lvl].lo, lays[lvl].hi).contiguous()

        for lvl in range(2):
            lev, k = levels[lvl], kinds[lvl]
            X, B, R = (torch.tensor(rng.standard_normal(shapes[lvl]))
                       for _ in range(3))
            CX = torch.tensor(rng.standard_normal(shapes[lvl + 1]))
            ci = levels[lvl + 1].ci
            tag = f"{kind.name}-l{lvl}"
            for ud in ("down", "up"):
                for fuse in (False, True):
                    want = relax2.point_relax(lev.so, X, B, None, k, ud,
                                              fuse_residual=fuse)
                    got = ctx.relax(lvl, k, cut(X, lvl), cut(B, lvl), ud,
                                    fuse)
                    if not fuse:
                        want, got = (want,), (got,)
                    errs[f"relax-{ud}-{fuse}-{tag}"] = max(
                        float((g - cut(w, lvl)).abs().max())
                        for g, w in zip(got, want))
            errs[f"residual-{tag}"] = float((ctx.residual(
                lvl, k, cut(X, lvl), cut(B, lvl)) - cut(stencil2.residual(
                    lev.so, X, B, k), lvl)).abs().max())
            errs[f"restrict-{tag}"] = float((ctx.restrict(
                lvl, cut(R, lvl)) - cut(interp2.restrict(ci, R),
                                        lvl + 1)).abs().max())
            errs[f"interp_add-{tag}"] = float((ctx.interp_add(
                lvl, cut(CX, lvl + 1), cut(R, lvl), cut(X, lvl)) - cut(
                    interp2.interp_add(ci, lev.so, CX, R, X.clone()),
                    lvl)).abs().max())
            errs[f"interp-{tag}"] = float((ctx.interp(
                lvl, cut(CX, lvl + 1)) - cut(interp2.interp(
                    ci, CX, shapes[lvl]), lvl)).abs().max())
    return errs


def _solve(mesh, so, kind, conf, b, rank, serial=True):
    s = DistSolver2(so, kind, copy.deepcopy(conf), mesh)
    x = s.solve(b)
    out = {"x": x, "hist": s.history, "specs": s.specs,
           "shape0": s.shapes[0]}
    if serial and rank == 0:
        ser = Solver2(so, kind, copy.deepcopy(conf))
        out["x_ser"] = ser.solve(b)
        out["hist_ser"] = ser.history
    return out


def _world(rank, ref):
    """Every distributed 2D case on this rank; returns its numbers."""
    from cedar_tpu_torch import capi
    from cedar_tpu_torch.examples import basic_2d_dist

    out = {}
    if not torch.cuda.is_available():
        try:
            make_mesh(2)
            out["nodevice"] = "no error"
        except RuntimeError as e:
            out["nodevice"] = str(e)
    mesh = make_mesh(2, shape=(2, 2), device="cpu")
    out["mesh"] = (mesh.dims, mesh.coords, mesh.backend, mesh.staged)
    out["ops"] = _ops(mesh, np.random.default_rng(7))

    p96, b96 = gallery.poisson(96, 96, device="cpu"), \
        gallery.poisson_rhs(96, 96, device="cpu")
    p64, b64 = gallery.poisson(64, 64, device="cpu"), \
        gallery.poisson_rhs(64, 64, device="cpu")
    fe64 = gallery.fe(64, 64, device="cpu")
    out["v5_96"] = _solve(mesh, p96, FivePt, CONF, b96, rank)
    out["v9_64"] = _solve(mesh, fe64, NinePt, CONF4, b64, rank)
    fconf = {"log": [], "solver": {"cycle": {"type": "f"}, "max-iter": 3}}
    out["f5_64"] = _solve(mesh, p64, FivePt, fconf, b64, rank)
    out["f9_64"] = _solve(mesh, fe64, NinePt, fconf, b64, rank)
    p65, b65 = gallery.poisson(65, 65, device="cpu"), \
        gallery.poisson_rhs(65, 65, device="cpu")
    out["pad65"] = _solve(mesh, p65, FivePt, CONF, b65, rank)
    lazy = {**CONF4, "redist": {"min-local": 10**9}}
    out["lazy64"] = _solve(mesh, p64, FivePt, lazy, b64, rank)
    out["eager64"] = _solve(mesh, p64, FivePt, CONF4, b64, rank)
    manual = {**CONF4, "redist": {"search": {
        "strategy": "manual", "path": [[2, 2], [1, 2], [1, 1]]}}}
    out["manual64"] = _solve(mesh, p64, FivePt, manual, b64, rank)
    # redist against LU (tests/test_cgsolve.py): the inner hierarchy on
    # the replicated 32² coarsest level
    redist = {"log": [], "solver": {"tol": 1e-10, "max-iter": 30,
                                    "num-levels": 2, "cg-solver": "redist"}}
    lu = {"log": [], "solver": {"tol": 1e-10, "max-iter": 30,
                                "num-levels": 2}}
    out["redist64"] = _solve(mesh, p64, FivePt, redist, b64, rank,
                             serial=False)
    out["lu64"] = _solve(mesh, p64, FivePt, lu, b64, rank, serial=False)
    # redist at 128²: the inner hierarchy (32² .. 4²) on the replicated
    # 32² coarsest level, against the serial port's (redist there is the
    # same inner solve)
    out["redist128"] = _solve(
        mesh, gallery.poisson(128, 128, device="cpu"), FivePt,
        {"log": [], "solver": {"tol": 1e-10, "max-iter": 30,
                               "num-levels": 3, "cg-solver": "redist"}},
        gallery.poisson_rhs(128, 128, device="cpu"), rank)
    for shape in ((4, 1), (1, 4)):
        m = make_mesh(2, shape=shape, device="cpu")
        out[f"mesh{shape}"] = _solve(m, p64, FivePt, CONF4, b64, rank)

    # a W-cycle (n = 2) from a random iterate, against the serial cycle
    d = DistSolver2(fe64, NinePt, copy.deepcopy(CONF), mesh)
    x0 = torch.tensor(np.random.default_rng(3).standard_normal((64, 64)))
    xb = cycle2.ncycle(d.levels, d.kinds, 0, d._block(x0), d._block(b64),
                       d.settings, n=2, dist=d.dist)
    out["w9_64"] = {"x": d.dist.gather(xb)}
    if rank == 0:
        ser = Solver2(fe64, NinePt, copy.deepcopy(CONF))
        out["w9_64"]["x_ser"] = cycle2.ncycle(ser.levels, ser.kinds, 0,
                                              x0.clone(), b64, ser.settings,
                                              n=2)

    # one cycle over cedar_tpu's hierarchy, cut into this rank's blocks;
    # the test process writes it while this world runs
    d = DistSolver2(p64, FivePt, copy.deepcopy(CONF), mesh)
    d.levels = local_levels(levels_from_numpy(_wait_load(ref["jlevels"])),
                            mesh, d.specs)
    out["jvcycle"] = d.vcycle(torch.tensor(ref["x0"]), b64)

    # the handle API on the mesh, and the distributed example
    topo = capi.bmg2_topo_create(32, 32, mesh=mesh)
    op = capi.bmg2_operator_create(topo)
    capi.bmg2_operator_set_full(
        op, gallery.poisson(32, 32, device="cpu").numpy())
    slv = capi.bmg2_solver_create(op, copy.deepcopy(CONF))
    x = np.zeros((32, 32))
    out["capi"] = capi.bmg2_solver_run(
        slv, x, gallery.poisson_rhs(32, 32, device="cpu").numpy())
    out["capi_inplace"] = x.copy()
    out["capi_type"] = type(capi._get(slv)).__name__
    out["example"] = basic_2d_dist.run(rank, 32, 32, "cpu")
    return out


def _wait_load(path, timeout=300.0):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} not written")
        time.sleep(0.2)
    return torch.load(path, weights_only=False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's results and cedar_tpu's references, computed by the
    test process while the world runs."""
    import jax
    import jax.numpy as jnp

    import cedar_tpu.capi as jcapi
    from cedar_tpu import FivePt as JFive, Solver2 as JSolver2
    from cedar_tpu import gallery as jgallery
    from cedar_tpu.parallel import DistSolver2 as JDist2, make_mesh as jmesh

    tmp = tmp_path_factory.mktemp("world")
    x0 = np.random.default_rng(11).standard_normal((64, 64))
    ref = {"jlevels": str(tmp / "jlevels.pt"), "x0": x0}
    w = start(_world, 4, ref, timeout=400, init_dir=str(tmp))
    want = {}
    try:
        m = jmesh(2, devices=jax.devices("cpu")[:4], shape=(2, 2))
        js = JDist2(jgallery.poisson(64, 64), JFive, copy.deepcopy(CONF), m)
        levels = [{k: np.asarray(v) for k, v in lev._asdict().items()
                   if k in ("so", "ci", "ainv") and v is not None}
                  for lev in js.levels]
        torch.save(levels, str(tmp / "jlevels.tmp"))
        os.replace(tmp / "jlevels.tmp", tmp / "jlevels.pt")
        want["jvcycle"] = np.asarray(js.vcycle(
            jnp.asarray(x0), jgallery.poisson_rhs(64, 64)))
        for name, n, conf in (("v5_96", 96, CONF), ("pad65", 65, CONF),
                              ("p64", 64, CONF4)):
            want[name] = np.asarray(
                JSolver2(jgallery.poisson(n, n), JFive, copy.deepcopy(conf))
                .solve(jgallery.poisson_rhs(n, n)))
        op = jcapi.bmg2_operator_create(jcapi.bmg2_topo_create(32, 32))
        jcapi.bmg2_operator_set_full(op, np.asarray(jgallery.poisson(32,
                                                                     32)))
        slv = jcapi.bmg2_solver_create(op, copy.deepcopy(CONF))
        want["capi"] = np.asarray(jcapi.bmg2_solver_run(
            slv, np.zeros((32, 32)), np.asarray(jgallery.poisson_rhs(32,
                                                                     32))))
    finally:
        got = w.join()
    return got, want


def test_world_ranks_agree(world):
    got, _ = world
    assert [g["mesh"][1] for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert got[0]["mesh"][0] == (2, 2) and got[0]["mesh"][2] == "gloo"
    assert not got[0]["mesh"][3]          # CPU tensors: nothing staged
    for g in got[1:]:
        for key in ("v5_96", "v9_64", "pad65", "mesh(4, 1)"):
            assert torch.equal(g[key]["x"], got[0][key]["x"])
            assert g[key]["hist"] == got[0][key]["hist"]


def test_ops_bit_for_bit(world):
    got, _ = world
    for g in got:
        errs = g["ops"]
        for key, e in errs.items():
            if key.startswith("specs"):
                continue
            assert e == 0.0, (key, e)
    specs = got[0]["ops"]["specs-five_pt"]
    # the odd block (level 1's y: 18 / 2 = 9) is gathered onto level 2
    assert specs == [("x", "y"), ("x", "y"), (None, None)]


@pytest.mark.parametrize("key", ["v5_96", "v9_64", "f5_64", "f9_64",
                                 "pad65", "eager64", "lazy64", "manual64",
                                 "redist128", "mesh(4, 1)", "mesh(1, 4)"])
def test_solves_equal_serial_port(world, key):
    r = world[0][0][key]
    assert torch.equal(r["x"], r["x_ser"])
    assert len(r["hist"]) == len(r["hist_ser"])
    np.testing.assert_allclose(r["hist"], r["hist_ser"], rtol=1e-12)


def test_w_cycle_equals_serial(world):
    r = world[0][0]["w9_64"]
    assert torch.equal(r["x"], r["x_ser"])


@pytest.mark.parametrize("key,ref,tol", [
    ("v5_96", "v5_96", 1e-12),
    ("mesh(4, 1)", "p64", 1e-11), ("mesh(1, 4)", "p64", 1e-11),
    ("eager64", "p64", 1e-11), ("pad65", "pad65", 1e-9),
    ("manual64", "p64", 1e-10),
])
def test_solves_match_cedar_tpu(world, key, ref, tol):
    got, want = world
    assert float(np.abs(got[0][key]["x"].numpy() - want[ref]).max()) < tol


def test_padding_and_agglomeration(world):
    got, _ = world
    r = got[0]
    assert r["pad65"]["shape0"] == (72, 72)
    assert r["pad65"]["x"].shape == (65, 65)
    assert r["lazy64"]["specs"][0] == (None, None)
    assert r["eager64"]["specs"][0] == ("x", "y")
    assert float((r["lazy64"]["x"] - r["eager64"]["x"]).abs().max()) < 1e-10
    assert r["redist64"]["specs"][-1] == (None, None)
    assert float((r["redist64"]["x"] - r["lu64"]["x"]).abs().max()) < 1e-10


def test_manual_specs_match_cedar_tpu(world):
    import jax
    from cedar_tpu.parallel.policy import level_specs as jspecs
    from jax.sharding import Mesh as JMesh

    got, _ = world
    r = got[0]["manual64"]
    mesh = JMesh(np.asarray(jax.devices("cpu")[:4]).reshape(2, 2),
                 ("x", "y"))
    shapes = solver2.level_shapes(64, 64, len(r["specs"]))
    want = jspecs(shapes, mesh, strategy="manual",
                  path=[[2, 2], [1, 2], [1, 1]])
    assert r["specs"] == [tuple(tuple(s) + (None,) * (2 - len(tuple(s))))
                          for s in want]
    assert r["specs"][1] == (None, "y")


def test_cycle_over_cedar_tpu_hierarchy(world):
    got, want = world
    w = want["jvcycle"]
    np.testing.assert_allclose(got[0]["jvcycle"].numpy(), w, rtol=0,
                               atol=1e-12 * float(np.abs(w).max()))


def test_no_card_needs_a_cpu_device(world):
    if torch.cuda.is_available():
        pytest.skip("a card is present: make_mesh's default is the card")
    assert "no CUDA device" in world[0][0]["nodevice"]


def test_capi_mesh_matches_cedar_tpu(world):
    got, want = world
    for g in got:
        assert g["capi_type"] == "DistSolver2"
        np.testing.assert_array_equal(g["capi"], g["capi_inplace"])
        np.testing.assert_allclose(g["capi"], want["capi"], rtol=0,
                                   atol=1e-12 * float(np.abs(
                                       want["capi"]).max()))


def test_example_matches_cedar_tpu(world, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["basic_2d_dist.py", "32"])
    capsys.readouterr()
    runpy.run_path(str(EXAMPLES / "basic_2d_dist.py"), run_name="__main__")
    jout = [ln for ln in capsys.readouterr().out.splitlines()
            if not ln.startswith("Iteration")]
    got, _ = world
    mine = got[0]["example"]
    assert mine[0] == "mesh: {'x': 2, 'y': 2}"
    assert mine[1].startswith("per-level placement: ['PartitionSpec(")
    assert jout[1].startswith("per-level placement: ['PartitionSpec(")
    assert mine[-1] == jout[-1] == "Finished Test"

    def norm(lines):
        return float(re.search(r"Solution norm: (\S+)",
                               "\n".join(lines)).group(1))

    np.testing.assert_allclose(norm(mine), norm(jout), rtol=1e-3)
    assert all(g["example"] == mine for g in got)
