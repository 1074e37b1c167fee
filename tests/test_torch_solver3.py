"""The port's whole 3D solve against cedar_tpu's Solver3 (7-point and
27-point V-cycles, the F-cycle), a V- and a W-cycle on a hierarchy carried
across from JAX, the configurations outside the port, and the import
boundary of chip_smoke.py."""

import copy
import json
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu import Solver3 as JSolver3
from cedar_tpu import gallery as jgallery
from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.solver import cycle3 as jcycle3

from cedar_tpu_torch import (
    Config, SevenPt, Solver2, Solver3, TwentySevenPt, gallery,
)
from cedar_tpu_torch.ops.stencil3 import residual
from cedar_tpu_torch.solver import cycle3
from cedar_tpu_torch.solver.level import levels_from_numpy

torch.set_num_threads(2)

CONF = {"log": [], "solver": {"tol": 1e-9, "max-iter": 30}}
# the problems of tests/test_poisson_3d.py
CASES = {
    "poisson3-32": (lambda: jgallery.poisson3(32, 32, 32), SevenPt,
                    JKind.seven_pt, CONF),
    "poisson3-21x13x17": (lambda: jgallery.poisson3(21, 13, 17), SevenPt,
                          JKind.seven_pt, CONF),
    "fe3-16": (lambda: jgallery.fe3(16, 16, 16), TwentySevenPt,
               JKind.twenty_seven_pt, CONF),
    "fcycle-32": (lambda: jgallery.poisson3(32, 32, 32), SevenPt,
                  JKind.seven_pt,
                  {"log": [], "solver": {"cycle": {"type": "f"},
                                         "tol": 1e-8, "max-iter": 8}}),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    """The same problem solved by both packages."""
    make, kind, jkind, conf = CASES[request.param]
    so = np.asarray(make())
    b = np.asarray(jgallery.poisson3_rhs(*so.shape[1:]))
    js = JSolver3(jnp.asarray(so), jkind, conf)
    jx = np.asarray(js.solve(jnp.asarray(b)))
    s = Solver3(torch.tensor(so), kind, conf)
    return dict(name=request.param, so=so, b=b, kind=kind, js=js, jx=jx,
                s=s)


def test_solve_matches_jax(pair):
    s, js = pair["s"], pair["js"]
    b = torch.tensor(pair["b"])
    x = s.solve(b)
    assert s.nlevels == js.nlevels
    assert len(s.history) == len(js.history)
    # rtol 1e-9 while the residual is well above its rounding floor; near
    # 1e-10 relative, b - A x keeps a few digits in either package, hence
    # the absolute floor of 1e-14 in relative-residual units
    np.testing.assert_allclose(s.history, js.history, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(s.res0, js.res0, rtol=1e-12)
    jx = pair["jx"]
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-9,
                               atol=1e-12 * float(np.abs(jx).max()))
    if pair["name"].startswith("fcycle"):
        # cedar_tpu's F-cycle ignores the iterate: a constant history
        assert len(set(s.history)) == 1
        err = float((x - gallery.poisson3_solution(32, 32, 32, device="cpu"))
                    .abs().max())
        assert err < 6e-3
    else:
        assert s.history[-1] < 1e-9
        assert len(s.history) <= 12


@pytest.fixture(scope="module")
def carried():
    """A JAX Solver3 hierarchy (21x13x17 Poisson) as numpy, the port's
    levels made from it, and a port solver of the same problem."""
    so = np.asarray(jgallery.poisson3(21, 13, 17))
    b = np.asarray(jgallery.poisson3_rhs(21, 13, 17))
    js = JSolver3(jnp.asarray(so), JKind.seven_pt, CONF)
    levels_np = [
        {k: np.asarray(v) for k, v in lev._asdict().items()
         if v is not None and not isinstance(v, tuple)}
        for lev in js.levels
    ]
    levels = levels_from_numpy(levels_np, dtype=torch.float64)
    return dict(js=js, b=b, levels=levels,
                s=Solver3(torch.tensor(so), SevenPt, CONF))


@pytest.mark.parametrize("n", [1, 2])
def test_cycles_on_jax_hierarchy(carried, n):
    """The JAX hierarchy carried across: one port V-cycle (n=1) or
    W-cycle (n=2) equals the JAX package's on the same levels."""
    js, levels, b = carried["js"], carried["levels"], carried["b"]
    assert len(levels) == len(js.levels)
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal(b.shape)
    jb = jnp.asarray(b)
    if n == 1:
        want = np.asarray(js.vcycle(jnp.asarray(x0), jb))
        s = copy.copy(carried["s"])
        s.levels = levels
        tx0 = torch.tensor(x0)
        got = s.vcycle(tx0, torch.tensor(b))
        np.testing.assert_array_equal(tx0.numpy(), x0)
    else:
        want = np.asarray(jcycle3.ncycle(js.levels, js.kinds, 0,
                                         jnp.asarray(x0), jb, js.settings,
                                         (False, False, False), 2))
        s = carried["s"]
        got = cycle3.ncycle(levels, s.kinds, 0, torch.tensor(x0),
                            torch.tensor(b), s.settings, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-13 * float(np.abs(want).max()))


def test_solve_keeps_x0_and_logs_cedar_lines(capsys, tmp_path):
    so = gallery.poisson3(9, 9, 9, device="cpu")
    b = gallery.poisson3_rhs(9, 9, 9, device="cpu")
    x0 = torch.full_like(b, 0.5)
    s = Solver3(so, SevenPt, {"log": ["status", "info"],
                              "solver": {"max-iter": 3, "tol": 1e-30}})
    s.solve(b, x0)
    assert torch.equal(x0, torch.full_like(b, 0.5))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"Initial residual l2 norm: {s.res0:g}"
    assert out[1:] == [f"Iteration {i} relative l2 norm: {h:g}"
                       for i, h in enumerate(s.history)]
    assert len(s.history) == 3
    s.save_timings(str(tmp_path / "timings.json"))
    d = json.loads((tmp_path / "timings.json").read_text())
    assert set(d["level-0"]) == {"setup", "solve"}
    assert s.coarse_shape == s.shapes[-1] == (3, 3, 3)


def test_single_level_solve():
    b = gallery.poisson3_rhs(4, 3, 5, device="cpu")
    s = Solver3(gallery.poisson3(4, 3, 5, device="cpu"), SevenPt,
                {"log": [], "solver": {"num-levels": 1, "max-iter": 2}})
    x = s.solve(b)
    assert s.history[0] < 1e-12
    assert float(residual(s.levels[0].so, x, b, SevenPt).abs().max()) < 1e-12
    with pytest.raises(ValueError, match="too many levels"):
        Solver3(gallery.poisson3(4, 4, 4, device="cpu"), SevenPt,
                {"solver": {"num-levels": 5}})


# each refused configuration with what its message names: the ROADMAP
# item (queue 1) that ports it, or the reason it is not ported; the ids
# are those the list had before its plane-config and cg-solver entries
# were ported
UNPORTED = [
    ("conf2", {"solver": {"relaxation": "line-x"}}, "points or planes"),
    ("conf7", {"kernels": {"backend": "xla"}}, "the device decides"),
]


@pytest.mark.parametrize("conf,names", [
    pytest.param(conf, names, id=i) for i, conf, names in UNPORTED])
def test_unported_options_raise(conf, names):
    with pytest.raises(NotImplementedError, match="cedar_tpu_torch") as e:
        Solver3(gallery.poisson3(8, 8, 8, device="cpu"), SevenPt, conf)
    assert re.search(names, str(e.value)), str(e.value)


# the serial cg-solver redist and grid.np, which test_unported_options_raise
# held refused until they were ported (its conf5 and conf8): cedar_tpu runs
# redist on a serial grid as the inner multigrid solve and ignores grid.np
REDIST_PORTED = [
    ("conf5", {"solver": {"cg-solver": "redist"}}),
    ("conf8", {"grid": {"np": [2, 1, 1]}}),
]


@pytest.mark.parametrize("conf", [
    pytest.param(conf, id=i) for i, conf in REDIST_PORTED])
def test_redist_and_np_options_solve(conf):
    """The same configurations solve as cedar_tpu's Solver3 does (f64 8³,
    b = 1, its default tol and max-iter): the same cycle count, the
    histories to rtol 1e-9 (atol 1e-14 near the rounding floor), x to 1e-10 of max |x|."""
    conf = {**conf, "log": []}
    so = np.asarray(jgallery.poisson3(8, 8, 8))
    b = np.ones((8, 8, 8))
    js = JSolver3(jnp.asarray(so), JKind.seven_pt, copy.deepcopy(conf))
    jx = np.asarray(js.solve(jnp.asarray(b)))
    s = Solver3(torch.tensor(so), SevenPt, copy.deepcopy(conf))
    redist = conf.get("solver", {}).get("cg-solver") == "redist"
    assert (s.levels[-1].inner is not None) == redist
    x = s.solve(torch.tensor(b))
    assert len(s.history) == len(js.history)
    np.testing.assert_allclose(s.history, js.history, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0,
                               atol=1e-10 * float(np.abs(jx).max()))


# the plane-config (ROADMAP queue 1, item 6) and cg-solver cedar (item 5)
# configurations that test_unported_options_raise held refused until they
# were ported (its conf0, conf1, conf3, conf4 and conf6)
ITEMS56_PORTED = [
    ("conf0", {"solver": {"relaxation": "plane-xy"},
               "plane-config": {"solver": {"relaxation": "point"}}}),
    ("conf1", {"solver": {"relaxation": "plane-xyz"},
               "plane-config": {"solver": {"relaxation": "line-xy",
                                           "cycle": {"type": "f"}}}}),
    ("conf3", {"grid": {"periodic": [True, False, False]},
               "solver": {"cg-solver": "cedar"}}),
    ("conf4", {"solver": {"cg-solver": "cedar"}}),
    ("conf6", {"solver": {"relaxation": "plane-yz"},
               "plane-config": {"solver": {"relaxation": "line-xy",
                                           "cg-solver": "cedar"}}}),
]


@pytest.mark.parametrize("conf", [
    pytest.param(conf, id=i) for i, conf in ITEMS56_PORTED])
def test_items56_options_solve(conf):
    """The same configurations build and solve on the CPU: an inner
    hierarchy on the coarsest level (of the outer solve, or of every
    plane solver's), and the residual of the solution, with the wrap
    where x is periodic, below the tolerance (gallery.poisson3 stores no
    coupling across its edges: its periodic operator is definite); with
    embedded F-cycles, which start each plane solve from its rhs alone
    (as cedar_tpu's do), the solve stalls at their accuracy (8.9e-6
    here)."""
    stall = conf.get("plane-config", {}).get("solver", {}).get(
        "cycle", {}).get("type") == "f"
    conf = {**conf, "log": [], "solver": {
        **conf["solver"], "tol": 1e-9, "max-iter": 4 if stall else 30}}
    so = gallery.poisson3(8, 8, 8, device="cpu")
    b = gallery.poisson3_rhs(8, 8, 8, device="cpu")
    s = Solver3(so, SevenPt, conf)
    if s.settings.coarse_solver.value == "cedar":
        assert s.levels[-1].inner is not None and s.levels[-1].ainv is None
    if s.settings.plane_settings is not None:
        ps = s.settings.plane_settings
        for hiers in s.levels[0].planes.values():
            for h in hiers:
                assert (h[-1].inner is not None) == (
                    ps.coarse_solver.value == "cedar" and len(h) > 1)
    x = s.solve(b)
    per = tuple(conf.get("grid", {}).get("periodic", [False] * 3))
    r = float(residual(so, x, b, SevenPt, per).norm() / b.norm())
    want = 1e-5 if stall else 1e-9
    assert s.history[-1] < want and r < want


def test_dimension_mismatch_raises():
    with pytest.raises(NotImplementedError, match="Solver2"):
        Solver3(gallery.poisson(8, 8, device="cpu"), SevenPt, {})
    with pytest.raises(NotImplementedError, match="Solver3"):
        Solver2(gallery.poisson3(8, 8, 8, device="cpu"), SevenPt, {})


def test_dense_pallas_config_accepted():
    """The configuration this package ports: dense kernels, no split."""
    s = Solver3(gallery.poisson3(9, 9, 9, device="cpu"), SevenPt, Config({
        "log": [], "kernels": {"backend": "pallas", "fine-split": False}}))
    s.solve(gallery.poisson3_rhs(9, 9, 9, device="cpu"))
    assert s.history[-1] < 1e-8


def test_chip_smoke_imports_without_jax():
    """chip_smoke.py imports neither JAX nor cedar_tpu (the machine with
    the card has no JAX)."""
    code = (
        "import sys, chip_smoke\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m == 'cedar_tpu' or m.startswith('cedar_tpu.')\n"
        "               for m in sys.modules), 'cedar_tpu imported'\n"
        "assert 'cedar_tpu_torch.ops.cuda_transfer3' in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])
