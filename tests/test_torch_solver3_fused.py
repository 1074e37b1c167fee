"""The port's fused 3D fine-level V-cycle (``kernels.fine-split``): whole
solves against cedar_tpu's split-resident Solver3 (its Pallas kernels in
interpret mode, float32, on the setups and at the tolerances of
tests/test_pallas3_split.py), against cedar_tpu's dense Solver3 in float64
where the JAX split path does not run (27-point, odd shapes; ROADMAP
queue 3), against the port's own dense cycle on the CPU (bit for bit: the
plain versions compose the same torch ops), a JAX split hierarchy carried
across, the launch pattern and the resolution of the settings.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu import Solver3 as JSolver3
from cedar_tpu import gallery as jgallery
from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import pallas3, pallas3_split, pallas3_stream
from cedar_tpu.ops import pallas_transfer3

from cedar_tpu_torch import Config, SevenPt, Solver3, TwentySevenPt, gallery
from cedar_tpu_torch.ops import cuda_fused3, cuda_transfer3
from cedar_tpu_torch.settings import MLSettings
from cedar_tpu_torch.solver import cycle3
from cedar_tpu_torch.solver.level import levels_from_numpy

torch.set_num_threads(2)

# name -> (shape, cycle settings, max-iter, atol on x) of the solves held
# against cedar_tpu's split-resident solve (tests/test_pallas3_split.py:
# 218-279): history to rtol 1e-3
JAX_CASES = {
    "V11-64x64x32": ((64, 64, 32), {}, 3, 1e-5),
    "F-64": ((64, 64, 64), {"type": "f"}, 2, 2e-5),
}


def _conf(cycle, max_iter, **kernels):
    return {"log": [], "solver": {"tol": 1e-5, "max-iter": max_iter,
                                  "cycle": cycle},
            "kernels": {"backend": "pallas", "fine-split": True, **kernels}}


@pytest.fixture(scope="module", params=list(JAX_CASES))
def jax_split(request):
    """cedar_tpu's split-resident solve of one case, its Pallas kernels in
    interpret mode."""
    mp = pytest.MonkeyPatch()
    for mod in (pallas3, pallas3_split, pallas3_stream, pallas_transfer3):
        mp.setattr(mod, "INTERPRET", True)
    shape, cycle, max_iter, atol = JAX_CASES[request.param]
    so = np.asarray(jgallery.poisson3(*shape), np.float32)
    b = np.asarray(jgallery.poisson3_rhs(*shape), np.float32)
    conf = _conf(cycle, max_iter)
    js = JSolver3(jnp.asarray(so), JKind.seven_pt, conf)
    assert js.levels[0].so2 is not None and js.levels[1].pw4 is not None
    jx = np.asarray(js.solve(jnp.asarray(b)))
    mp.undo()
    return dict(js=js, jx=jx, so=so, b=b, conf=conf, atol=atol)


def _counts():
    return (cuda_fused3.sweep_restrict_plain_calls,
            cuda_fused3.interp_sweep_plain_calls,
            cuda_fused3.sweep_plain_calls)


def test_fused_solve_matches_jax_split_f32(jax_split):
    s = Solver3(torch.tensor(jax_split["so"]), SevenPt, jax_split["conf"])
    assert s.settings.fine_split and s.settings.split_levels == 4
    before = _counts()
    x = s.solve(torch.tensor(jax_split["b"]))
    assert all(a > c for a, c in zip(_counts()[:2], before[:2]))
    js = jax_split["js"]
    assert len(s.history) == len(js.history)
    np.testing.assert_allclose(s.history, js.history, rtol=1e-3)
    np.testing.assert_allclose(x.numpy(), jax_split["jx"],
                               atol=jax_split["atol"])


def test_levels_from_jax_split_hierarchy(jax_split):
    """A JAX split hierarchy (with its cip, so2 and pw4) carried across
    gives the same solve as the same hierarchy without those TPU layouts,
    which the port ignores, and agrees with the JAX solve."""
    js = jax_split["js"]
    levels_np = [
        {k: np.asarray(v) for k, v in lev._asdict().items()
         if v is not None and not isinstance(v, tuple)}
        for lev in js.levels
    ]
    tpu = {"so2", "pw4", "cip"}
    assert {"so2", "pw4"} <= set(levels_np[0]) | set(levels_np[1])
    so, b = torch.tensor(jax_split["so"]), torch.tensor(jax_split["b"])
    solves = []
    for hier in (levels_np,
                 [{k: v for k, v in lev.items() if k not in tpu}
                  for lev in levels_np]):
        s = Solver3(so, SevenPt, jax_split["conf"])
        s.levels = levels_from_numpy(hier, dtype=torch.float32)
        solves.append((s.solve(b), s.history))
    (x, hist), (x_dense, hist_dense) = solves
    assert hist == hist_dense and torch.equal(x, x_dense)
    np.testing.assert_allclose(x.numpy(), jax_split["jx"],
                               atol=jax_split["atol"])
    np.testing.assert_allclose(hist, js.history, rtol=1e-3)


# where cedar_tpu's split path does not run (27-point, odd extents, f64),
# the port's fused solve against its dense solve, at the f64 tolerance of
# tests/test_torch_solver3.py
DENSE_JAX_CASES = {
    "fe3-16": (jgallery.fe3, (16, 16, 16), TwentySevenPt,
               JKind.twenty_seven_pt, {}),
    "poisson3-21x13x17-V22": (jgallery.poisson3, (21, 13, 17), SevenPt,
                              JKind.seven_pt,
                              {"nrelax-pre": 2, "nrelax-post": 2}),
}


@pytest.mark.parametrize("case", list(DENSE_JAX_CASES))
def test_fused_solve_matches_jax_dense_f64(case):
    make, shape, kind, jkind, cycle = DENSE_JAX_CASES[case]
    so = np.asarray(make(*shape))
    b = np.asarray(jgallery.poisson3_rhs(*shape))
    solver = {"tol": 1e-9, "max-iter": 30, "cycle": cycle}
    js = JSolver3(jnp.asarray(so), jkind, {"log": [], "solver": solver})
    jx = np.asarray(js.solve(jnp.asarray(b)))
    s = Solver3(torch.tensor(so), kind, {"log": [], "solver": solver,
                                        "kernels": {"fine-split": True}})
    before = _counts()
    x = s.solve(torch.tensor(b))
    assert _counts()[0] > before[0]
    assert len(s.history) == len(js.history) and s.history[-1] < 1e-9
    np.testing.assert_allclose(s.history, js.history, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-9,
                               atol=1e-12 * float(np.abs(jx).max()))


# the fused cycle against the dense one on the CPU: bit for bit
DENSE_CASES = {
    "poisson-V11": ("poisson3", SevenPt, (17, 15, 13), {}, {}),
    "poisson-V21-split1": ("poisson3", SevenPt, (20, 18, 22),
                           {"nrelax-pre": 2}, {"split-levels": 1}),
    "fe-V22-split2": ("fe3", TwentySevenPt, (16, 16, 16),
                      {"nrelax-pre": 2, "nrelax-post": 2},
                      {"split-levels": 2}),
    "fe-V12-nonsym": ("fe3", TwentySevenPt, (13, 12, 11),
                      {"nrelax-post": 2}, {}),
    "poisson-F-split2": ("poisson3", SevenPt, (17, 17, 17), {"type": "f"},
                         {"split-levels": 2}),
    "fe-F21": ("fe3", TwentySevenPt, (12, 14, 10),
               {"type": "f", "nrelax-pre": 2}, {}),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_fused_equals_dense_on_cpu(case):
    """The plain versions of K14-K16 compose the torch ops of the dense
    cycle's plain versions, so the fused solve's history and iterate equal
    the dense ones exactly (the recomputed residual included)."""
    make, kind, shape, cycle, kernels = DENSE_CASES[case]
    so = getattr(gallery, make)(*shape, torch.float64, "cpu")
    b = gallery.poisson3_rhs(*shape, torch.float64, "cpu")
    solver = {"tol": 1e-12, "max-iter": 4, "cycle": cycle}
    if case.endswith("nonsym"):
        solver["relax-symmetric"] = False
    dense = Solver3(so, kind, {"log": [], "solver": solver,
                               "kernels": {"fine-split": False}})
    fused = Solver3(so, kind, {"log": [], "solver": solver,
                               "kernels": {"fine-split": True, **kernels}})
    assert fused.settings.fine_split and not dense.settings.fine_split
    before = _counts()
    xf = fused.solve(b)
    assert _counts()[0] > before[0]
    xd = dense.solve(b)
    assert fused.history == dense.history
    assert torch.equal(xf, xd)
    x0 = torch.rand(shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    assert torch.equal(fused.vcycle(x0, b), dense.vcycle(x0, b))


@pytest.mark.parametrize("pre,post,split_levels,want", [
    (1, 1, 4, (4, 4, 0)),
    (2, 1, 4, (4, 4, 4)),
    (2, 2, 2, (2, 2, 4)),
    (1, 3, 1, (1, 1, 2)),
    (1, 1, 20, (5, 5, 0)),
])
def test_fused_launch_pattern(pre, post, split_levels, want):
    """Per cycle: K15 and K16 once on each fused level, K14 for the other
    sweeps (the last post-sweep of the top level with the norm); the
    levels below split-levels run the dense cycle.  (These count the ops;
    on the card a 27-point op is K6's sweep and an edge launch,
    ``cuda_fused3.launch_list``.)"""
    so = gallery.poisson3(65, 65, 65, torch.float64, "cpu")
    b = gallery.poisson3_rhs(65, 65, 65, torch.float64, "cpu")
    cycle = {"nrelax-pre": pre, "nrelax-post": post}
    s = Solver3(so, SevenPt, {"log": [], "solver": {"cycle": cycle},
                              "kernels": {"fine-split": True,
                                          "split-levels": split_levels}})
    assert s.nlevels == 6
    k8 = cuda_transfer3.interp_add_plain_calls
    before = _counts()
    cycle3.cycle_residual(s.levels, s.kinds, torch.zeros_like(b), b,
                          s.settings)
    assert tuple(a - c for a, c in zip(_counts(), before)) == want
    # K8 (interp-add) runs on the dense levels below the fused ones
    assert cuda_transfer3.interp_add_plain_calls - k8 == 5 - want[0]


@pytest.mark.parametrize("kernels,fused,split_levels", [
    ({}, False, 4),
    ({"fine-split": True}, True, 4),
    ({"fine-split": False}, False, 4),
    ({"fine-split": True, "split-levels": 2}, True, 2),
    ({"backend": "pallas"}, False, 4),
    ({"split-levels": 3}, False, 3),
    ({"fine-split": True, "split-levels": 3}, True, 3),
])
def test_fine_split_settings(kernels, fused, split_levels):
    """The cycle stays dense unless the config asks for the fused one (on
    the card too: there the fused 3D cycle measured slower than the dense
    one, PERF.md §6, where cedar_tpu/solver/solver3.py:234-236 turns
    it on with its kernels); an explicit ``fine-split: true`` selects it;
    split-levels is honoured."""
    s = Solver3(gallery.poisson3(17, 17, 17, device="cpu"), SevenPt,
                {"log": [], "kernels": kernels})
    assert s.settings.fine_split is fused
    assert s.settings.split_levels == split_levels
    assert cycle3.fine_split_ok(s.levels, s.settings) is fused
    fused_at = [cycle3._split_ok_at(s.levels, lvl, s.settings)
                for lvl in range(s.nlevels)]
    assert fused_at == [fused and lvl < min(split_levels, s.nlevels - 1)
                        for lvl in range(s.nlevels)]


@pytest.mark.parametrize("solver,ok", [
    ({}, True),
    ({"cycle": {"type": "f"}}, False),
    ({"relaxation": "plane-xy"}, False),
    ({"cycle": {"nrelax-pre": 0}}, False),
    ({"cycle": {"nrelax-post": 0}}, False),
])
def test_fine_split_ok(solver, ok):
    """cedar_tpu's gate (cycle3.py:124): V-cycle, point relaxation, a pre-
    and a post-sweep, two levels or more, fine-split on."""
    settings = MLSettings.from_config(Config({"solver": solver}))
    settings.fine_split = True
    assert cycle3.fine_split_ok((None, None), settings) is ok
    assert not cycle3.fine_split_ok((None,), settings)
    settings.fine_split = False
    assert not cycle3.fine_split_ok((None, None), settings)
