"""The port's distributed plane relaxation (``cedar_tpu_torch.parallel.
planes``) in one world of 8 gloo processes on the CPU, a (2, 2, 2) mesh,
float64, against the port's serial Solver3 and cedar_tpu.

* one plane sweep, bit for bit: ``DistContext.plane_relax`` equals
  ``planes3.plane_relax`` on the block, xy, xz and yz, DOWN and UP, 7- and
  27-point, on random operators that store couplings across the boundary,
  at a level with even blocks, a partitioned 27-point coarse level and a
  level whose blocks start at an odd index (9 of 18); the rank's colour
  hierarchies equal the serial ones cut to its planes, and their batched
  coarse solve the serial one at the rank's batch size;
* cedar_tpu's own case (tests/test_dist.py: ``diag_diffusion3(16, 16, 16,
  1, 1, 1e-3)`` plane-xy, tol 1e-9): x bit for bit the serial port's and
  within 1e-12 of cedar_tpu's serial Solver3;
* 16³ solves bit for bit the serial port's: plane-xyz Poisson, 27-point
  ``fe3`` plane-xy, a ``point`` plane-config with ``cg-solver: cedar`` on
  the planes, an F-cycle, z-periodic plane-xy;
* a padded 17³ plane-xy: bit for bit the serial port on the padded
  operator, within 1e-9 of cedar_tpu's DistSolver3 on its 8-device CPU
  mesh;
* a cycle over cedar_tpu's serial plane-xy hierarchy carried across with
  its planes (``levels_from_numpy`` -> ``local_levels``): bit for bit the
  serial port's cycle over it, and cedar_tpu's to its serial tolerance
  (tests/test_torch_solver3_planes.py);
* a cycle's ``comm.counts()`` exactly ``tools/dist_comm.py``'s prediction;
* a ``capi`` 3D handle with ``mesh=`` and plane-xy.

The rank function imports neither jax nor cedar_tpu; the test process
computes the references while the world runs.
"""

import copy
import os
import time

import numpy as np
import pytest
import torch

from cedar_tpu_torch import SevenPt, Solver3, TwentySevenPt, gallery
from cedar_tpu_torch.config import Config
from cedar_tpu_torch.ops import backend, cg, planes3
from cedar_tpu_torch.parallel import DistSolver3, comm, make_mesh
from cedar_tpu_torch.parallel import planes as dplanes
from cedar_tpu_torch.parallel.dist import layouts, local_levels, pad_operator
from cedar_tpu_torch.parallel.halo import DistContext, _cut
from cedar_tpu_torch.parallel.launch import start
from cedar_tpu_torch.settings import MLSettings
from cedar_tpu_torch.solver import cycle3, solver3
from cedar_tpu_torch.solver.level import levels_from_numpy
from cedar_tpu_torch.tools import dist_comm

CEDAR = {"log": [], "solver": {"relaxation": "plane-xy", "tol": 1e-9,
                               "max-iter": 10}}
# a point plane-config whose planes end at 8² with an inner multigrid
# solve there (8², 4²)
POINT_CEDAR = {"solver": {"relaxation": "point", "max-iter": 1,
                          "cg-solver": "cedar", "min-coarse": 8},
               "cg-config": {"solver": {"tol": 1e-4, "max-iter": 10}}}
Z = (False, False, True)
# name -> (operator, kind, conf): solved at 16³, x bit for bit the serial
# port's
SOLVES = {
    "xy": ("aniso", SevenPt, CEDAR),
    "xyz": ("poisson", SevenPt, {"log": [], "solver": {
        "relaxation": "plane-xyz", "tol": 1e-9, "max-iter": 10}}),
    "fe_xy": ("fe", TwentySevenPt, CEDAR),
    "point_cedar": ("aniso", SevenPt, {**CEDAR, "plane-config": POINT_CEDAR}),
    "fcycle": ("aniso", SevenPt, {"log": [], "solver": {
        "relaxation": "plane-xy", "cycle": {"type": "f"}, "max-iter": 3}}),
    "zper": ("zper", SevenPt, {**CEDAR, "grid": {"periodic": list(Z)}}),
}
# the cycles counted against tools/dist_comm.py: name -> (operator, kind,
# n, relaxation); 32³ partitions level 1 too
COUNTED = {"c_xy32": ("aniso", SevenPt, 32, "plane-xy"),
           "c_fe_xyz": ("fe", TwentySevenPt, 16, "plane-xyz")}


def _operator(name, n):
    if name == "aniso":
        return gallery.diag_diffusion3(n, n, n, 1.0, 1.0, 1e-3, device="cpu")
    if name == "poisson":
        return gallery.poisson3(n, n, n, device="cpu")
    if name == "fe":
        return gallery.fe3(n, n, n, device="cpu")
    return gallery.periodic3(gallery.diag_diffusion3(
        n, n, n, 1.0, 1.0, 1e-3, device="cpu"), Z)


def random_so3(rng, n, full):
    so = np.zeros((14 if full else 4, n, n, n))
    so[1:] = rng.uniform(0.05, 0.5, so[1:].shape)
    so[0] = 4.0 * so[1:].sum(0) + rng.uniform(0.5, 1.0, (n, n, n))
    return torch.tensor(so)


def _same(a, b) -> bool:
    """Two colour hierarchies (or inner hierarchies) equal, field by
    field."""
    if (a is None) != (b is None):
        return False
    if a is None:
        return True
    for la, lb in zip(a, b):
        for k in ("so", "recip", "ci", "sor_x", "sor_y", "ainv"):
            fa, fb = getattr(la, k), getattr(lb, k)
            if (fa is None) != (fb is None) or (
                    fa is not None and not torch.equal(fa, fb)):
                return False
        if not _same(la.inner, lb.inner):
            return False
    return len(a) == len(b)


def _sweeps(mesh, rng):
    """Per case the largest difference of a distributed plane sweep from
    the serial one, of the colour hierarchies and of their coarse solve."""
    conf = Config({"solver": {"relaxation": "plane-xyz"}})
    settings = MLSettings.from_config(conf)
    backend.resolve(settings, conf, False)
    errs = {}
    # (n, levels, specs): 24³ with its 12³ level partitioned (27-point),
    # 18³ whose blocks of 9 start at the odd index 9 on every axis
    for n, nlev, specs in ((24, 3, [("x", "y", "z")] * 2 + [(None,) * 3]),
                           (18, 2, [("x", "y", "z"), (None,) * 3])):
        for full in (False, True):
            kind = TwentySevenPt if full else SevenPt
            so = random_so3(rng, n, full)
            kinds = [kind] + [TwentySevenPt] * (nlev - 1)
            levels = planes3.setup_planes(
                solver3.setup_hierarchy(so, kind, nlev, settings), kinds,
                settings)
            shapes = solver3.level_shapes(n, n, n, nlev)
            lays = layouts(shapes, specs, mesh)
            bare = [lev._replace(planes=None)
                    for lev in local_levels(levels, mesh, specs)]
            ctx = DistContext(bare, lays, mesh, kinds,
                              plane_orients=("xy", "xz", "yz"),
                              plane_settings=settings.plane_settings)
            for lvl in range(nlev - 1):
                lay, k = lays[lvl], kinds[lvl]
                tag = f"{n}-{kind.name}-l{lvl}"
                X, B = (torch.tensor(rng.standard_normal(shapes[lvl]))
                        for _ in range(2))
                for orient in ("xy", "xz", "yz"):
                    p = planes3.PLANE_SPECS[orient][0]
                    ws = ctx.planes[(lvl, orient)]
                    want = dplanes.cut_colours(levels[lvl].planes[orient],
                                               lay.lo[p], lay.hi[p])
                    errs[f"colours-{tag}-{orient}"] = float(not all(
                        _same(a, b) for a, b in zip(ws.colours, want)))
                    for hr, hs, c in zip(ws.colours,
                                         levels[lvl].planes[orient], (0, 1)):
                        if hr is None:
                            continue
                        first = lay.lo[p] + planes3.colour_start(c,
                                                                 lay.lo[p])
                        nb = hr[-1].ainv.shape[0]
                        cb = torch.tensor(rng.standard_normal(
                            (hs[-1].ainv.shape[0],) + hs[-1].so.shape[-2:]))
                        part = cb[(first - c) // 2:(first - c) // 2 + nb]
                        errs[f"coarse-{tag}-{orient}-{c}"] = float((
                            cg.solve_cg(hr[-1].ainv, part.contiguous())
                            - cg.solve_cg(hs[-1].ainv, cb)[
                                (first - c) // 2:(first - c) // 2 + nb]
                        ).abs().max())
                    for ud in ("down", "up"):
                        w = planes3.plane_relax(levels[lvl], k, X.clone(), B,
                                                orient, ud, settings)
                        g = ctx.plane_relax(lvl, k,
                                            _cut(X, lay.lo, lay.hi),
                                            _cut(B, lay.lo, lay.hi),
                                            orient, ud, settings)
                        errs[f"sweep-{tag}-{orient}-{ud}"] = float(
                            (g - _cut(w, lay.lo, lay.hi)).abs().max())
            errs[f"odd-{n}"] = float(any(lo % 2 for lo in lays[0].lo))
    return errs


def _wait_load(path, timeout=300.0):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} not written")
        time.sleep(0.2)
    return torch.load(path, weights_only=False)


def _world(rank, ref):
    from cedar_tpu_torch import capi

    mesh = make_mesh(3, shape=(2, 2, 2), device="cpu")
    out = {"sweeps": _sweeps(mesh, np.random.default_rng(9))}
    b16 = gallery.poisson3_rhs(16, 16, 16, device="cpu")
    for name, (op, kind, conf) in SOLVES.items():
        so = _operator(op, 16)
        s = DistSolver3(so, kind, copy.deepcopy(conf), mesh)
        r = {"x": s.solve(b16), "hist": s.history, "specs": s.specs}
        if rank == 0:
            ser = Solver3(so, kind, copy.deepcopy(conf))
            r["x_ser"], r["hist_ser"] = ser.solve(b16), ser.history
        out[name] = r

    # padded 17³: the serial port on the padded operator, the level count
    # of the true extents
    so = _operator("aniso", 17)
    b = gallery.poisson3_rhs(17, 17, 17, device="cpu")
    s = DistSolver3(so, SevenPt, copy.deepcopy(CEDAR), mesh)
    r = {"x": s.solve(b), "hist": s.history, "shape0": s.shapes[0]}
    if rank == 0:
        sop, pads = pad_operator(so, mesh.dims)
        conf = copy.deepcopy(CEDAR)
        conf["solver"]["num-levels"] = s.nlevels
        ser = Solver3(sop, SevenPt, conf)
        bp = torch.nn.functional.pad(b, [0, pads[2], 0, pads[1], 0, pads[0]])
        r["x_ser"], r["hist_ser"] = ser.solve(bp)[:17, :17, :17], ser.history
    out["pad17"] = r

    # one cycle over cedar_tpu's hierarchy, carried across with its
    # planes; the test process writes it while this world runs
    so = _operator("aniso", 16)
    x0 = torch.tensor(ref["x0"])
    carried = levels_from_numpy(_wait_load(ref["jlevels"]))
    d = DistSolver3(so, SevenPt, copy.deepcopy(CEDAR), mesh)
    d.levels = local_levels(carried, mesh, d.specs)
    out["jvcycle"] = {"x": d.vcycle(x0, b16), "x0": torch.equal(
        x0, torch.tensor(ref["x0"]))}
    if rank == 0:
        ser = Solver3(so, SevenPt, copy.deepcopy(CEDAR))
        ser.levels = carried
        out["jvcycle"]["x_ser"] = ser.vcycle(x0, b16)

    # one counted cycle of each COUNTED case on this rank
    for name, (op, kind, n, relax) in COUNTED.items():
        so = _operator(op, n)
        conf = {"log": [], "solver": {"relaxation": relax,
                                      "cycle": {"nrelax-pre": 1,
                                                "nrelax-post": 1}}}
        d = DistSolver3(so, kind, conf, mesh)
        bb = d._block(gallery.poisson3_rhs(n, n, n, device="cpu"))
        comm.reset()
        cycle3.cycle_residual(d.levels, d.kinds, torch.zeros_like(bb), bb,
                              d.settings, d.periodic, dist=d.dist)
        out[name] = {"counts": comm.counts(), "specs": d.specs,
                     "shapes": d.shapes}

    # the handle API on the mesh
    topo = capi.bmg3_topo_create(16, 16, 16, mesh=mesh)
    op = capi.bmg3_operator_create(topo)
    capi.bmg3_operator_set_full(op, _operator("aniso", 16).numpy())
    slv = capi.bmg3_solver_create(op, copy.deepcopy(CEDAR))
    x = np.zeros((16, 16, 16))
    out["capi"] = capi.bmg3_solver_run(slv, x, b16.numpy())
    out["capi_inplace"] = x.copy()
    out["capi_type"] = type(capi._get(slv)).__name__
    return out


def _np_levels(levels) -> list:
    """A JAX hierarchy as dicts of numpy arrays, its plane and inner
    hierarchies too (fields that are not arrays left out)."""
    out = []
    for lev in levels:
        d = {}
        for k, v in lev._asdict().items():
            if k == "planes" and v is not None:
                d[k] = {o: _np_levels(h) for o, h in v.items()}
            elif k == "inner" and v is not None:
                d[k] = _np_levels(v)
            elif hasattr(v, "shape") and hasattr(v, "dtype"):
                d[k] = np.asarray(v)
        out.append(d)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's results and cedar_tpu's references, computed by the test
    process while the world runs."""
    import jax
    import jax.numpy as jnp

    from cedar_tpu import Solver3 as JSolver3
    from cedar_tpu import gallery as jgallery
    from cedar_tpu.config import Config as JConfig
    from cedar_tpu.core.types import StencilKind as JKind
    from cedar_tpu.parallel import DistSolver3 as JDist3, make_mesh as jmesh

    tmp = tmp_path_factory.mktemp("world")
    x0 = np.random.default_rng(13).standard_normal((16, 16, 16))
    ref = {"jlevels": str(tmp / "jlevels.pt"), "x0": x0}
    w = start(_world, 8, ref, timeout=400, init_dir=str(tmp))
    want = {}
    try:
        js = JSolver3(jgallery.diag_diffusion3(16, 16, 16, 1.0, 1.0, 1e-3),
                      JKind.seven_pt, JConfig(copy.deepcopy(CEDAR)))
        torch.save(_np_levels(js.levels), str(tmp / "jlevels.tmp"))
        os.replace(tmp / "jlevels.tmp", tmp / "jlevels.pt")
        b16 = jgallery.poisson3_rhs(16, 16, 16)
        want["xy"] = np.asarray(js.solve(b16))
        want["jvcycle"] = np.asarray(js.vcycle(jnp.asarray(x0), b16))
        m = jmesh(3, devices=jax.devices("cpu")[:8], shape=(2, 2, 2))
        jd = JDist3(jgallery.diag_diffusion3(17, 17, 17, 1.0, 1.0, 1e-3),
                    JKind.seven_pt, JConfig(copy.deepcopy(CEDAR)), m)
        want["pad17"] = np.asarray(jd.solve(jgallery.poisson3_rhs(17, 17,
                                                                   17)))
    finally:
        got = w.join()
    return got, want


def test_plane_sweep_bit_for_bit(world):
    got, _ = world
    for g in got:
        errs = g["sweeps"]
        assert len([k for k in errs if k.startswith("sweep")]) == 36
        for key, e in errs.items():
            if key.startswith("odd"):
                continue
            assert e == 0.0, (key, e)
    # the 18³ level's blocks start at 9 on the ranks of coordinate 1
    assert any(g["sweeps"]["odd-18"] for g in got)
    assert not any(g["sweeps"]["odd-24"] for g in got)


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_equals_serial_port(world, name):
    got, _ = world
    r = got[0][name]
    assert r["specs"][0] == ("x", "y", "z")
    assert torch.equal(r["x"], r["x_ser"])
    assert len(r["hist"]) == len(r["hist_ser"])
    np.testing.assert_allclose(r["hist"], r["hist_ser"], rtol=1e-12)
    if name != "fcycle":
        assert r["hist"][-1] < 1e-9
    for g in got[1:]:
        assert torch.equal(g[name]["x"], r["x"])


def test_cedar_tpu_case(world):
    """tests/test_dist.py's plane-xy case: < 1e-12 off cedar_tpu's serial
    Solver3."""
    got, want = world
    assert float(np.abs(got[0]["xy"]["x"].numpy() - want["xy"]).max()) < 1e-12


def test_padded_solve(world):
    got, want = world
    r = got[0]["pad17"]
    assert r["shape0"] == (20, 20, 20) and r["x"].shape == (17, 17, 17)
    assert torch.equal(r["x"], r["x_ser"])
    np.testing.assert_allclose(r["hist"], r["hist_ser"], rtol=1e-12)
    assert float(np.abs(r["x"].numpy() - want["pad17"]).max()) < 1e-9


def test_cycle_over_cedar_tpu_hierarchy(world):
    got, want = world
    r = got[0]["jvcycle"]
    assert r["x0"]
    assert torch.equal(r["x"], r["x_ser"])
    w = want["jvcycle"]
    # cedar_tpu's lines of 16 points take SPIKE factors: rtol 1e-9
    np.testing.assert_allclose(r["x"].numpy(), w, rtol=1e-9,
                               atol=1e-12 * float(np.abs(w).max()))


@pytest.mark.parametrize("name", list(COUNTED))
def test_cycle_comm_matches_model(world, name):
    got, _ = world
    op, kind, n, relax = COUNTED[name]
    r = got[0][name]
    model = dist_comm.predict(r["shapes"], r["specs"], (2, 2, 2), 8, 1, 1,
                              8 if kind == TwentySevenPt else 2, 8, relax)
    for key in ("exchanges", "exchange_bytes", "wrap_exchanges", "gathers",
                "line_gathers", "spike_gathers", "plane_gathers",
                "reductions"):
        assert r["counts"][key] == model[key], key
    assert r["counts"]["plane_gathers"] > 0
    if name == "c_xy32":
        assert r["specs"][1] == ("x", "y", "z")


def test_capi_handle_on_a_mesh(world):
    got, want = world
    for g in got:
        assert g["capi_type"] == "DistSolver3"
        np.testing.assert_array_equal(g["capi"], g["capi_inplace"])
        np.testing.assert_array_equal(g["capi"], got[0]["xy"]["x"].numpy())


@pytest.mark.parametrize("m", [4, 5, 16])
def test_batched_coarse_solve_is_batch_invariant(m):
    """Each plane's coarse solve is the same whatever batch holds it (a
    rank holds fewer planes than the serial batch), and it is the product
    ``ainv @ b`` to rounding."""
    rng = np.random.default_rng(m)
    a = rng.standard_normal((9, m * m, m * m))
    ainv = torch.tensor(a @ a.transpose(0, 2, 1) + m * m * np.eye(m * m))
    b = torch.tensor(rng.standard_normal((9, m, m)))
    full = cg.solve_cg(ainv, b)
    for lo, hi in ((0, 4), (3, 8), (8, 9)):
        assert torch.equal(full[lo:hi], cg.solve_cg(
            ainv[lo:hi].contiguous(), b[lo:hi].contiguous()))
    want = torch.bmm(ainv, b.transpose(-1, -2).reshape(9, -1, 1)).reshape(
        9, m, m).transpose(-1, -2)
    np.testing.assert_allclose(full.numpy(), want.numpy(), rtol=1e-13,
                               atol=1e-13 * float(want.abs().max()))
