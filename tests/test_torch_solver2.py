"""The port's whole 2D solve: Cedar's published 400² history, the solve
against cedar_tpu's Solver2, one V-cycle on a hierarchy carried across
from JAX, the configurations outside the port, and the import boundary."""

import copy
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu import Solver2 as JSolver2
from cedar_tpu import gallery as jgallery
from cedar_tpu.core.types import StencilKind as JKind

from cedar_tpu_torch import Config, FivePt, NinePt, Solver2, gallery
from cedar_tpu_torch.ops.stencil2 import residual
from cedar_tpu_torch.solver.level import levels_from_numpy

torch.set_num_threads(2)

# Published per-iteration relative l2 norms (reference README.md:51-61),
# produced by a 7-level hierarchy on the 400x400 problem with V(1,1).
CEDAR_HISTORY = [
    0.388629, 0.0443548, 0.00494131, 0.000513399, 5.44908e-05,
    5.60612e-06, 5.86933e-07, 6.04942e-08, 6.30975e-09, 6.52713e-10,
]
CEDAR_CONF = {
    "log": [],
    "solver": {"num-levels": 7, "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
               "tol": 1e-10, "max-iter": 10},
}


def test_cedar_history_400():
    so = gallery.poisson(400, 400, device="cpu")
    b = gallery.poisson_rhs(400, 400, device="cpu")
    s = Solver2(so, FivePt, Config(CEDAR_CONF))
    x = s.solve(b)
    assert len(s.history) == 10
    np.testing.assert_allclose(s.history, CEDAR_HISTORY, rtol=2e-5)
    err = float((x - gallery.poisson_solution(400, 400, device="cpu"))
                .abs().max())
    # reference README.md:62 "Solution norm: 2.04592e-05"
    np.testing.assert_allclose(err, 2.04592e-05, rtol=1e-4)


CASES = {
    "poisson-125x93": (lambda: np.asarray(jgallery.poisson(125, 93)),
                       FivePt, JKind.five_pt),
    "fe-64": (lambda: np.asarray(jgallery.fe(64, 64)), NinePt, JKind.nine_pt),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    """The same problem solved by both packages (tol 1e-9, max-iter 30)."""
    make, kind, jkind = CASES[request.param]
    so = make()
    nx, ny = so.shape[1:]
    b = np.asarray(jgallery.poisson_rhs(nx, ny))
    conf = {"log": [], "solver": {"tol": 1e-9, "max-iter": 30}}
    js = JSolver2(jnp.asarray(so), jkind, conf)
    jx = np.asarray(js.solve(jnp.asarray(b)))
    s = Solver2(torch.tensor(so), kind, conf)
    return dict(so=so, b=b, kind=kind, js=js, jx=jx, s=s)


def test_solve_matches_jax(pair):
    s, js = pair["s"], pair["js"]
    b = torch.tensor(pair["b"])
    x = s.solve(b)
    assert len(s.history) == len(js.history) <= 12
    # rtol 1e-9 holds while the residual is well above its rounding floor;
    # near 1e-10 relative, b - A x loses all but a few digits to
    # cancellation in either package (differences of ~7e-16 seen), hence
    # the absolute floor of 1e-14 in relative-residual units
    np.testing.assert_allclose(s.history, js.history, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(s.res0, js.res0, rtol=1e-12)
    jx = pair["jx"]
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-9,
                               atol=1e-12 * float(np.abs(jx).max()))
    r = residual(s.levels[0].so, x, b, pair["kind"])
    assert float(r.norm() / b.norm()) < 1e-9


def test_vcycle_on_jax_hierarchy(pair):
    """The JAX hierarchy carried across: one port V-cycle equals one JAX
    V-cycle, and neither argument is modified."""
    js = pair["js"]
    levels_np = [
        {k: np.asarray(v) for k, v in lev._asdict().items() if v is not None}
        for lev in js.levels
    ]
    levels = levels_from_numpy(levels_np, dtype=torch.float64)
    assert len(levels) == len(js.levels)
    s = copy.copy(pair["s"])
    s.levels = levels
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal(pair["b"].shape)
    want = np.asarray(js.vcycle(jnp.asarray(x0), jnp.asarray(pair["b"])))
    tx0 = torch.tensor(x0)
    b = torch.tensor(pair["b"])
    got = s.vcycle(tx0, b)
    np.testing.assert_array_equal(tx0.numpy(), x0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-13 * float(np.abs(want).max()))


def test_solve_keeps_x0_and_logs_cedar_lines(capsys):
    so = gallery.poisson(33, 33, device="cpu")
    b = gallery.poisson_rhs(33, 33, device="cpu")
    x0 = torch.full_like(b, 0.5)
    s = Solver2(so, FivePt, {"log": ["status", "info"],
                             "solver": {"max-iter": 3, "tol": 1e-30}})
    s.solve(b, x0)
    assert torch.equal(x0, torch.full_like(b, 0.5))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"Initial residual l2 norm: {s.res0:g}"
    assert out[1:] == [f"Iteration {i} relative l2 norm: {h:g}"
                       for i, h in enumerate(s.history)]
    assert len(s.history) == 3


def test_save_timings(tmp_path):
    s = Solver2(gallery.poisson(17, 17, device="cpu"), FivePt, {"log": []})
    s.solve(gallery.poisson_rhs(17, 17, device="cpu"))
    s.save_timings(str(tmp_path / "timings.json"))
    import json

    d = json.loads((tmp_path / "timings.json").read_text())
    assert set(d["level-0"]) == {"setup", "solve"}


def test_single_level_and_post_free_cycles():
    b = gallery.poisson_rhs(5, 5, device="cpu")
    s = Solver2(gallery.poisson(5, 5, device="cpu"), FivePt,
                {"log": [], "solver": {"num-levels": 1, "max-iter": 2}})
    x = s.solve(b)
    assert s.history[0] < 1e-12
    assert float(residual(s.levels[0].so, x, b, FivePt).abs().max()) < 1e-12
    s = Solver2(gallery.poisson(31, 31, device="cpu"), FivePt, {
        "log": [], "solver": {"cycle": {"nrelax-pre": 2, "nrelax-post": 0},
                              "max-iter": 4, "tol": 1e-30}})
    s.solve(gallery.poisson_rhs(31, 31, device="cpu"))
    # without post-smoothing the first cycle raises the residual (1.457,
    # as cedar_tpu gives); later cycles converge
    assert s.history[-1] < 1e-3 * s.history[0]


# each refused configuration with what its message names: the ROADMAP
# item (queue 1) that ports it, or the reason it is not ported; the ids
# are those the list had before its periodic entries were ported
UNPORTED = [
    ("conf3", {"solver": {"relaxation": "plane-xy"}}, "use Solver3"),
    ("conf8", {"kernels": {"backend": "xla"}}, "the device decides"),
]


@pytest.mark.parametrize("conf,names", [
    pytest.param(conf, names, id=i) for i, conf, names in UNPORTED])
def test_unported_options_raise(conf, names):
    with pytest.raises(NotImplementedError, match="cedar_tpu_torch") as e:
        Solver2(gallery.poisson(16, 16, device="cpu"), FivePt, conf)
    assert re.search(names, str(e.value)), str(e.value)


# the 2D periodic configurations that test_unported_options_raise held
# refused until they were ported (its conf1, conf4 and conf7)
PERIODIC_PORTED = [
    ("conf1", {"solver": {"relaxation": "line-y"},
               "grid": {"periodic": [True, True]}}),
    ("conf4", {"grid": {"periodic": [True, False]}}),
    ("conf7", {"kernels": {"fine-split": True},
               "grid": {"periodic": [False, True]}}),
]


@pytest.mark.parametrize("conf", [
    pytest.param(conf, id=i) for i, conf in PERIODIC_PORTED])
def test_periodic_options_solve(conf):
    """The same configurations build and solve: gallery.poisson stores no
    coupling across its edges, so its periodic operator is definite and
    every right-hand side is compatible; the residual of the solution,
    with the wrap, falls below the tolerance (the fused cycle stays off on
    periodic grids, as in cedar_tpu)."""
    from cedar_tpu_torch.solver import cycle2

    conf = {**conf, "log": [], "solver": {
        **conf.get("solver", {}), "tol": 1e-9, "max-iter": 30}}
    so = gallery.poisson(16, 16, device="cpu")
    b = gallery.poisson_rhs(16, 16, device="cpu")
    s = Solver2(so, FivePt, conf)
    per = tuple(conf["grid"]["periodic"])
    assert s.periodic == per
    assert not cycle2.fine_split_ok(s.levels, s.settings, s.periodic)
    x = s.solve(b)
    assert s.history[-1] < 1e-9
    r = residual(so, x, b, FivePt, per)
    assert float(r.norm() / b.norm()) < 1e-9


# the serial cg-solver redist and grid.np, which test_unported_options_raise
# held refused until they were ported (its conf2, conf6 and conf9):
# cedar_tpu runs redist on a serial grid as the inner multigrid solve and
# ignores grid.np
REDIST_PORTED = [
    ("conf2", {"solver": {"relaxation": "line-xy", "cg-solver": "redist"}}),
    ("conf6", {"solver": {"cg-solver": "redist"}}),
    ("conf9", {"grid": {"np": [2, 2]}}),
]


@pytest.mark.parametrize("conf", [
    pytest.param(conf, id=i) for i, conf in REDIST_PORTED])
def test_redist_and_np_options_solve(conf):
    """The same configurations solve as cedar_tpu's Solver2 does (f64 16²,
    its default tol and max-iter): the same cycle count, the histories to
    rtol 1e-9, x to 1e-10 of max |x|; under redist the coarsest level
    holds the inner hierarchy."""
    conf = {**conf, "log": []}
    so = np.asarray(jgallery.poisson(16, 16))
    b = np.asarray(jgallery.poisson_rhs(16, 16))
    js = JSolver2(jnp.asarray(so), JKind.five_pt, copy.deepcopy(conf))
    jx = np.asarray(js.solve(jnp.asarray(b)))
    s = Solver2(torch.tensor(so), FivePt, copy.deepcopy(conf))
    redist = conf.get("solver", {}).get("cg-solver") == "redist"
    assert (s.levels[-1].inner is not None) == redist
    x = s.solve(torch.tensor(b))
    assert len(s.history) == len(js.history)
    np.testing.assert_allclose(s.history, js.history, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0,
                               atol=1e-10 * float(np.abs(jx).max()))


# the inner multigrid coarse solve, which test_unported_options_raise held
# refused until it was ported (its conf5)
CEDAR_PORTED = [
    ("conf5", {"solver": {"cg-solver": "cedar"}}),
]


@pytest.mark.parametrize("conf", [
    pytest.param(conf, id=i) for i, conf in CEDAR_PORTED])
def test_cedar_options_solve(conf):
    """The same configuration builds and solves: the coarsest level holds
    the inner solver's hierarchy (its cg-config inherited from the outer
    config with an LU coarse solve, as in cedar_tpu), and the solve
    reaches the tolerance."""
    conf = {**conf, "log": [], "solver": {
        **conf["solver"], "tol": 1e-9, "max-iter": 30}}
    so = gallery.poisson(16, 16, device="cpu")
    b = gallery.poisson_rhs(16, 16, device="cpu")
    s = Solver2(so, FivePt, conf)
    inner = s.levels[-1].inner
    assert inner is not None and s.levels[-1].ainv is None
    assert inner[-1].ainv is not None and inner[-1].inner is None
    x = s.solve(b)
    assert s.history[-1] < 1e-9
    assert float(residual(so, x, b, FivePt).norm() / b.norm()) < 1e-9


# solver.ml-relax.enabled, which test_unported_options_raise held refused
# until it was ported (its conf0)
ML_PORTED = [
    ("conf0", {"solver": {"relaxation": "line-x",
                          "ml-relax": {"enabled": True}}}),
]


@pytest.mark.parametrize("conf", [
    pytest.param(conf, id=i) for i, conf in ML_PORTED])
def test_ml_relax_options_solve(conf):
    """The same configuration builds and solves as cedar_tpu's does: its
    80-point x-lines by the full-length PCR (histories to rtol 1e-9, atol
    1e-14 near the rounding floor; x to 1e-9 of max |x|)."""
    conf = {**conf, "log": [], "solver": {
        **conf["solver"], "tol": 1e-9, "max-iter": 12}}
    so = np.asarray(jgallery.poisson(80, 16))
    b = np.asarray(jgallery.poisson_rhs(80, 16))
    js = JSolver2(jnp.asarray(so), JKind.five_pt, conf)
    jx = np.asarray(js.solve(jnp.asarray(b)))
    s = Solver2(torch.tensor(so), FivePt, conf)
    assert s.settings.ml_relax_enabled
    x = s.solve(torch.tensor(b))
    assert len(s.history) == len(js.history) and s.history[-1] < 1e-9
    np.testing.assert_allclose(s.history, js.history, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-9,
                               atol=1e-9 * float(np.abs(jx).max()))


def test_3d_raises():
    from cedar_tpu_torch.core.types import SevenPt

    with pytest.raises(NotImplementedError, match="3D"):
        Solver2(torch.zeros(4, 8, 8, 8), SevenPt, {})


def test_dense_pallas_config_accepted():
    """The configuration this package ports: dense kernels, no split."""
    s = Solver2(gallery.poisson(16, 16, device="cpu"), FivePt, {
        "log": [], "kernels": {"backend": "pallas", "fine-split": False}})
    s.solve(gallery.poisson_rhs(16, 16, device="cpu"))
    assert s.history[-1] < 1e-8


def test_import_without_jax():
    """Every module of the port imports without JAX and without cedar_tpu
    (the machine with the card has no JAX)."""
    code = (
        "import importlib, pkgutil, sys, cedar_tpu_torch\n"
        "for m in pkgutil.walk_packages(cedar_tpu_torch.__path__,\n"
        "                               'cedar_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m == 'cedar_tpu' or m.startswith('cedar_tpu.')\n"
        "               for m in sys.modules), 'cedar_tpu imported'\n"
        "assert 'cedar_tpu_torch.ops.cuda_transfer2' in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])
