"""The port's fused fine-level V-cycle (``kernels.fine-split``): the whole
solve against cedar_tpu's split-resident Solver2 (its Pallas kernels in
interpret mode, float32, at the tolerances of tests/test_pallas2_split.py),
against the port's own dense cycle on the CPU (bit for bit: the plain
versions compose the same torch ops), Cedar's 400² float64 history, a JAX
split hierarchy carried across, and the resolution of the settings.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu import Solver2 as JSolver2
from cedar_tpu import gallery as jgallery
from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import pallas2, pallas2_split, pallas_transfer2

from cedar_tpu_torch import Config, FivePt, NinePt, Solver2, gallery
from cedar_tpu_torch.ops import cuda_fused2, cuda_transfer2
from cedar_tpu_torch.settings import MLSettings
from cedar_tpu_torch.solver import cycle2
from cedar_tpu_torch.solver.level import levels_from_numpy

torch.set_num_threads(2)

CEDAR_HISTORY = [
    0.388629, 0.0443548, 0.00494131, 0.000513399, 5.44908e-05,
    5.60612e-06, 5.86933e-07, 6.04942e-08, 6.30975e-09, 6.52713e-10,
]

# name -> (split-levels, cycle settings, cycles) of the solves held against
# JAX.  The V-cycles stop at 3, above the float32 floor of |b - A x| / |b|
# at 256²: the fourth cycle, near 3e-4, parts by up to 3e-3 relative between
# cedar_tpu's own split-levels 1 and 2 (and by 1.9e-3 between the two
# packages at V(2,2)), so rtol 1e-3 holds only above it
JAX_CASES = {
    "split1-V11": (1, {"nrelax-pre": 1, "nrelax-post": 1}, 3),
    "split2-V11": (2, {"nrelax-pre": 1, "nrelax-post": 1}, 3),
    "split2-V22": (2, {"nrelax-pre": 2, "nrelax-post": 2}, 3),
    "split2-F": (2, {"type": "f"}, 4),
}
N = 256


def _conf(split_levels, cycle, max_iter):
    return {"log": [], "solver": {"tol": 1e-5, "max-iter": max_iter,
                                  "cycle": cycle},
            "kernels": {"backend": "pallas", "fine-split": True,
                        "split-levels": split_levels}}


@pytest.fixture(scope="module")
def poisson256():
    so = np.asarray(jgallery.poisson(N, N), np.float32)
    b = np.asarray(jgallery.poisson_rhs(N, N), np.float32)
    return so, b


@pytest.fixture(scope="module", params=list(JAX_CASES))
def jax_split(request, poisson256):
    """cedar_tpu's split-resident solve of one case, its Pallas kernels in
    interpret mode."""
    mp = pytest.MonkeyPatch()
    for mod in (pallas2, pallas2_split, pallas_transfer2):
        mp.setattr(mod, "INTERPRET", True)
    so, b = poisson256
    sl, cycle, cycles = JAX_CASES[request.param]
    js = JSolver2(jnp.asarray(so), JKind.five_pt, _conf(sl, cycle, cycles))
    assert js.levels[0].so2 is not None
    assert (js.levels[1].so2 is not None) == (sl >= 2)
    jx = np.asarray(js.solve(jnp.asarray(b)))
    mp.undo()
    return dict(js=js, jx=jx, conf=_conf(sl, cycle, cycles))


def _counts():
    return (cuda_fused2.sweep_restrict_plain_calls,
            cuda_fused2.interp_sweep_plain_calls,
            cuda_fused2.sweep_plain_calls)


def test_fused_solve_matches_jax_split_f32(jax_split, poisson256):
    so, b = poisson256
    s = Solver2(torch.tensor(so), FivePt, jax_split["conf"])
    before = _counts()
    x = s.solve(torch.tensor(b))
    assert all(a > c for a, c in zip(_counts()[:2], before[:2]))
    js = jax_split["js"]
    assert len(s.history) == len(js.history)
    np.testing.assert_allclose(s.history, js.history, rtol=1e-3)
    np.testing.assert_allclose(x.numpy(), jax_split["jx"], atol=2e-5)


def test_levels_from_jax_split_hierarchy(jax_split, poisson256):
    """A JAX split hierarchy (with its cip, rec2 and so2) carried across
    gives the same solve as the same hierarchy without those TPU layouts,
    which the port ignores, and agrees with the JAX solve."""
    js = jax_split["js"]
    levels_np = [
        {k: np.asarray(v) for k, v in lev._asdict().items()
         if v is not None and not isinstance(v, tuple)}
        for lev in js.levels
    ]
    tpu = {"so2", "cip", "rec2"}
    assert tpu <= set(levels_np[0]) | set(levels_np[1])
    so, b = poisson256
    solves = []
    for hier in (levels_np,
                 [{k: v for k, v in lev.items() if k not in tpu}
                  for lev in levels_np]):
        s = Solver2(torch.tensor(so), FivePt, jax_split["conf"])
        s.levels = levels_from_numpy(hier, dtype=torch.float32)
        solves.append((s.solve(torch.tensor(b)), s.history))
    (x, hist), (x_dense, hist_dense) = solves
    assert hist == hist_dense and torch.equal(x, x_dense)
    np.testing.assert_allclose(x.numpy(), jax_split["jx"], atol=2e-5)
    np.testing.assert_allclose(hist, js.history, rtol=1e-3)


# the fused cycle against the dense one on the CPU: bit for bit
DENSE_CASES = {
    "poisson-V11": ("poisson", FivePt, (97, 80), {}, {}),
    "poisson-V21-split3": ("poisson", FivePt, (65, 70),
                           {"nrelax-pre": 2}, {"split-levels": 3}),
    "fe-V12-split10": ("fe", NinePt, (64, 64),
                       {"nrelax-post": 2}, {"split-levels": 10}),
    "fe-V22-nonsym": ("fe", NinePt, (50, 41),
                      {"nrelax-pre": 2, "nrelax-post": 2},
                      {"split-levels": 2}),
    "poisson-F": ("poisson", FivePt, (81, 81), {"type": "f"},
                  {"split-levels": 2}),
    "fe-F21-split0": ("fe", NinePt, (45, 60),
                      {"type": "f", "nrelax-pre": 2}, {"split-levels": 0}),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_fused_equals_dense_on_cpu(case):
    """The plain versions of K11-K13 compose the torch ops of the dense
    cycle's plain versions, so the fused solve's history and iterate equal
    the dense ones exactly (the recomputed residual included)."""
    make, kind, shape, cycle, kernels = DENSE_CASES[case]
    so = getattr(gallery, make)(*shape, torch.float64, "cpu")
    b = gallery.poisson_rhs(*shape, torch.float64, "cpu")
    solver = {"tol": 1e-12, "max-iter": 6, "cycle": cycle}
    if case.endswith("nonsym"):
        solver["relax-symmetric"] = False
    dense = Solver2(so, kind, {"log": [], "solver": solver,
                               "kernels": {"fine-split": False}})
    fused = Solver2(so, kind, {"log": [], "solver": solver,
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


def test_cedar_history_400_fused():
    so = gallery.poisson(400, 400, device="cpu")
    b = gallery.poisson_rhs(400, 400, device="cpu")
    s = Solver2(so, FivePt, {"log": [], "kernels": {"fine-split": True},
                             "solver": {"num-levels": 7,
                                        "cycle": {"nrelax-pre": 1,
                                                  "nrelax-post": 1},
                                        "tol": 1e-10, "max-iter": 10}})
    before = _counts()
    x = s.solve(b)
    # 10 cycles, 4 fused levels each: K12 and K13 40 times, K11 never
    assert [a - c for a, c in zip(_counts(), before)] == [40, 40, 0]
    np.testing.assert_allclose(s.history, CEDAR_HISTORY, rtol=2e-5)
    err = float((x - gallery.poisson_solution(400, 400, device="cpu"))
                .abs().max())
    np.testing.assert_allclose(err, 2.04592e-05, rtol=1e-4)


@pytest.mark.parametrize("pre,post,split_levels,want", [
    (1, 1, 4, (4, 4, 0)),
    (2, 1, 4, (4, 4, 4)),
    (2, 2, 2, (2, 2, 4)),
    (1, 3, 1, (1, 1, 2)),
    (1, 1, 20, (6, 6, 0)),
])
def test_fused_launch_pattern(pre, post, split_levels, want):
    """Per cycle: K12 and K13 once on each fused level, K11 for the other
    sweeps (the last post-sweep of the top level with the norm); the
    levels below split-levels run the dense cycle."""
    so = gallery.poisson(129, 129, torch.float64, "cpu")
    b = gallery.poisson_rhs(129, 129, torch.float64, "cpu")
    cycle = {"nrelax-pre": pre, "nrelax-post": post}
    s = Solver2(so, FivePt, {"log": [], "solver": {"cycle": cycle},
                             "kernels": {"fine-split": True,
                                         "split-levels": split_levels}})
    assert s.nlevels == 7
    k3 = cuda_transfer2.interp_plain_calls
    before = _counts()
    cycle2.cycle_residual(s.levels, s.kinds, torch.zeros_like(b), b,
                          s.settings)
    assert tuple(a - c for a, c in zip(_counts(), before)) == want
    # K3 (interp-add) runs on the dense levels below the fused ones
    assert cuda_transfer2.interp_plain_calls - k3 == 6 - want[0]


def test_post_free_split_branch_equals_dense():
    """``nrelax-post 0`` never runs fused from the solver (fine_split_ok
    needs a post-sweep); ncycle_split's branch to interp_add_split, mirrored
    from cedar_tpu, still equals the dense cycle."""
    so = gallery.poisson(33, 40, torch.float64, "cpu")
    b = gallery.poisson_rhs(33, 40, torch.float64, "cpu")
    s = Solver2(so, FivePt, {"log": [], "kernels": {"fine-split": True},
                             "solver": {"cycle": {"nrelax-pre": 2,
                                                  "nrelax-post": 0}}})
    assert not cycle2.fine_split_ok(s.levels, s.settings)
    x0 = torch.rand(b.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(6))
    got, none = cycle2.ncycle_split(s.levels, s.kinds, x0, b, s.settings)
    assert none is None
    want = cycle2.ncycle(s.levels, s.kinds, 0, x0.clone(), b, s.settings)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernels,fused,split_levels", [
    ({}, False, 4),
    ({"fine-split": True}, True, 4),
    ({"fine-split": False}, False, 4),
    ({"fine-split": True, "split-levels": 2}, True, 2),
    ({"backend": "pallas"}, False, 4),
])
def test_fine_split_settings(kernels, fused, split_levels):
    """On the CPU the cycle stays dense unless the config asks for the
    fused one; split-levels is honoured (cedar_tpu/solver/solver2.py:
    277-282, with "the kernels run" meaning the operator is on the card)."""
    s = Solver2(gallery.poisson(33, 33, device="cpu"), FivePt,
                {"log": [], "kernels": kernels})
    assert s.settings.fine_split is fused
    assert s.settings.split_levels == split_levels
    assert cycle2.fine_split_ok(s.levels, s.settings) is fused
    fused_at = [cycle2._split_ok_at(s.levels, lvl, s.settings)
                for lvl in range(s.nlevels)]
    assert fused_at == [fused and lvl < min(split_levels, s.nlevels - 1)
                        for lvl in range(s.nlevels)]


@pytest.mark.parametrize("solver,ok", [
    ({}, True),
    ({"cycle": {"type": "f"}}, False),
    ({"relaxation": "line-xy"}, False),
    ({"cycle": {"nrelax-pre": 0}}, False),
    ({"cycle": {"nrelax-post": 0}}, False),
])
def test_fine_split_ok(solver, ok):
    """cedar_tpu's gate (cycle2.py:170): V-cycle, point relaxation, a pre-
    and a post-sweep, two levels or more, fine-split on."""
    settings = MLSettings.from_config(Config({"solver": solver}))
    settings.fine_split = True
    assert cycle2.fine_split_ok((None, None), settings) is ok
    assert not cycle2.fine_split_ok((None,), settings)
    settings.fine_split = False
    assert not cycle2.fine_split_ok((None, None), settings)
