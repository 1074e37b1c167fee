"""The port's inner multigrid coarse solve (``cg-solver: cedar``) against
cedar_tpu, float64.

* tests/test_cgsolve.py's cases (2D 128², 3D 24³, nested to depth 2):
  the port's solve equals its LU solve to 1e-10, as cedar_tpu's does;
* those and the F-cycle, the fused 2D and 3D cycles (``kernels.
  fine-split``) with ``cedar`` on their coarsest level, an x-periodic grid
  and the doubly periodic indefinite case, each against cedar_tpu's
  ``Solver2`` / ``Solver3`` of the same configuration: histories to rtol
  1e-9 (atol 1e-14 near the rounding floor), x to 1e-10 of max |x|;
* the masked loop of ``max-iter`` steps (solver/inner.py) against a plain
  Python while loop over the port's own cycle, bit for bit, with each exit
  (by tol, by max-iter), on one grid; on a batch of planes each plane
  stops on its own;
* a nested cedar_tpu hierarchy carried across (``levels_from_numpy``):
  the port's cycle on it equals the port's cycle on its own setup;
* the configurations that stay refused: plane relaxation inside a 3D
  ``cg-config`` (cedar_tpu fails on it too), ``ml-relax`` and ``redist``
  anywhere in the chain.
"""

import copy
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu import Solver2 as JSolver2
from cedar_tpu import Solver3 as JSolver3
from cedar_tpu import gallery as jgallery
from cedar_tpu.core.types import StencilKind as JKind

from cedar_tpu_torch import (
    FivePt, SevenPt, Solver2, Solver3, TwentySevenPt, gallery,
)
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import stencil2, stencil3
from cedar_tpu_torch.solver import cycle2, cycle3, inner
from cedar_tpu_torch.solver.level import levels_from_numpy

torch.set_num_threads(2)


def _cedar(levels, cg, **solver):
    """A solver config with the inner coarse solve: ``num-levels`` outer
    levels, ``cg`` the cg-config's solver section."""
    return {"log": [], "solver": {"tol": 1e-10, "max-iter": 30,
                                  "num-levels": levels, "cg-solver": "cedar",
                                  **solver},
            "cg-config": {"solver": cg}}


def periodic_poisson(nx, ny, per):
    """5-point Poisson whose couplings wrap on the periodic axes."""
    so = np.zeros((3, nx, ny))
    so[1, 0 if per[0] else 1:, :] = 1.0
    so[2, :, 0 if per[1] else 1:] = 1.0
    so[0] = 4.0
    return so


# tests/test_cgsolve.py's cg-configs; the nested levels and the 3D one with
# fewer steps (12 and 10 for its 20), of which at most 11 and 7 are active
# (they reach tol 1e-12 before): the same solves, at a fraction of the
# masked loop's cost on the CPU
NESTED = {"solver": {"tol": 1e-12, "max-iter": 12, "num-levels": 2,
                     "cg-solver": "cedar"},
          "cg-config": {"solver": {"tol": 1e-12, "max-iter": 12}}}
INNER = {"tol": 1e-12, "max-iter": 20}
INNER3 = {"tol": 1e-12, "max-iter": 10}

# name -> (JAX operator, port kind, JAX kind, shape, conf, mean-free b)
CASES = {
    # tests/test_cgsolve.py
    "2d-128": (lambda: jgallery.poisson(128, 128), FivePt, JKind.five_pt,
               (128, 128), _cedar(3, INNER), False),
    "3d-24": (lambda: jgallery.poisson3(24, 24, 24), SevenPt,
              JKind.seven_pt, (24, 24, 24), _cedar(2, INNER3), False),
    "2d-128-nested": (lambda: jgallery.poisson(128, 128), FivePt,
                      JKind.five_pt, (128, 128),
                      {**_cedar(2, NESTED["solver"]),
                       "cg-config": NESTED}, False),
    # the other cycles and grids
    "2d-fcycle": (lambda: jgallery.poisson(65, 49), FivePt, JKind.five_pt,
                  (65, 49), _cedar(3, {"tol": 1e-10, "max-iter": 8},
                                   cycle={"type": "f"}, **{"max-iter": 3}),
                  False),
    "2d-fused": (lambda: jgallery.poisson(65, 65), FivePt, JKind.five_pt,
                 (65, 65), {**_cedar(4, {"tol": 1e-11, "max-iter": 12}),
                            "kernels": {"fine-split": True,
                                        "split-levels": 2}}, False),
    "3d-fused-27pt": (lambda: jgallery.fe3(17, 17, 17), TwentySevenPt,
                      JKind.twenty_seven_pt, (17, 17, 17),
                      {**_cedar(3, {"tol": 1e-11, "max-iter": 8}),
                       "kernels": {"fine-split": True}}, False),
    "2d-periodic-x": (lambda: jnp.asarray(periodic_poisson(64, 48,
                                                           (True, False))),
                      FivePt, JKind.five_pt, (64, 48),
                      {**_cedar(3, {"tol": 1e-11, "max-iter": 10}),
                       "grid": {"periodic": [True, False]}}, False),
    "2d-periodic-indefinite": (
        lambda: jnp.asarray(periodic_poisson(32, 32, (True, True))),
        FivePt, JKind.five_pt, (32, 32),
        {**_cedar(2, {"tol": 1e-11, "max-iter": 10}, definite=False,
                  **{"max-iter": 12}),
         "grid": {"periodic": [True, True]}}, True),
}

_SOLVED = {}


def solved(name):
    """cedar_tpu's solve of the case, its b, and the port's solver and
    solution (cached)."""
    if name not in _SOLVED:
        make, kind, jkind, shape, conf, mean_free = CASES[name]
        so = np.asarray(make())
        rhs = jgallery.poisson_rhs if len(shape) == 2 else \
            jgallery.poisson3_rhs
        b = np.asarray(rhs(*shape))
        if mean_free:
            b = b - b.mean()
        jcls, cls = (JSolver2, Solver2) if len(shape) == 2 else \
            (JSolver3, Solver3)
        js = jcls(jnp.asarray(so), jkind, conf)
        jx = np.asarray(js.solve(jnp.asarray(b)))
        s = cls(torch.tensor(so), kind, conf)
        x = s.solve(torch.tensor(b))
        _SOLVED[name] = (js, jx, so, b, s, x)
    return _SOLVED[name]


@pytest.mark.parametrize("name", list(CASES))
def test_cedar_solve_matches_jax(name):
    js, jx, _, _, s, x = solved(name)
    print(f"{name}: {len(s.history)} cycles, {s.history}")
    assert s.levels[-1].inner is not None and s.levels[-1].ainv is None
    assert js.levels[-1].inner is not None
    assert len(s.levels[-1].inner) == len(js.levels[-1].inner)
    assert len(s.history) == len(js.history)
    np.testing.assert_allclose(s.history, js.history, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0,
                               atol=1e-10 * float(np.abs(jx).max()))
    if name.endswith("fcycle"):   # the F-cycle ignores its iterate
        assert len(set(s.history)) == 1


@pytest.mark.parametrize("name", ["2d-128", "3d-24", "2d-128-nested"])
def test_cedar_equals_lu(name):
    """tests/test_cgsolve.py's check: the inner multigrid coarse solve
    gives the LU solve's x to 1e-10; at depth 2 the inner coarsest level
    holds an inner hierarchy of its own."""
    _, _, so, b, s, x = solved(name)
    cls, kind = (Solver2, FivePt) if so.ndim == 3 else (Solver3, SevenPt)
    xa = cls(torch.tensor(so), kind, {
        "log": [], "solver": {"tol": 1e-10, "max-iter": 30}}).solve(
            torch.tensor(b))
    assert float((xa - x).abs().max()) < 1e-10
    if name.endswith("nested"):
        assert s.levels[-1].inner[-1].inner is not None


def _while_loop(cycle, residual, kind, coarse, cb, settings, ndim):
    """cedar_tpu's loop over the port's own cycle: ``while i < max-iter and
    rel >= tol``, reading rel back each step.  Returns x and the count."""
    ist = settings.cg_settings
    kinds = [kind] * len(coarse.inner)
    dims = tuple(range(-ndim, 0))
    r0 = max(float(torch.sqrt(torch.sum(cb * cb, dim=dims))), 1e-300)
    x, rel, i = torch.zeros_like(cb), math.inf, 0
    while i < ist.maxiter and rel >= ist.tol:
        x = cycle.run_cycle(coarse.inner, kinds, x, cb, ist)
        r = residual(coarse.inner[0].so, x, cb, kinds[0])
        rel = float(torch.sqrt(torch.sum(r * r, dim=dims))) / r0
        i += 1
    return x, i


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("exit_by", ["tol", "max-iter"])
def test_masked_loop_equals_while_loop(dim, exit_by):
    """The masked loop of ``max-iter`` inner cycles equals the while loop
    bit for bit; the while loop stops by tol in some of the steps, or runs
    them all (tol 1e-30).  tol 1e-7 lies more than a factor 2 from every
    inner rel of these solves."""
    tol = 1e-7 if exit_by == "tol" else 1e-30
    if dim == 2:
        so, kind, cycle, res = (gallery.poisson(33, 29, device="cpu"),
                                FivePt, cycle2, stencil2.residual)
        ckind = StencilKind.nine_pt
    else:
        so, kind, cycle, res = (gallery.poisson3(17, 15, 13, device="cpu"),
                                SevenPt, cycle3, stencil3.residual)
        ckind = StencilKind.twenty_seven_pt
    cls = Solver2 if dim == 2 else Solver3
    s = cls(so, kind, _cedar(2, {"tol": tol, "max-iter": 12}))
    coarse = s.levels[-1]
    cb = torch.tensor(np.random.default_rng(dim).standard_normal(
        tuple(coarse.so.shape[1:])))
    want, count = _while_loop(cycle, res, ckind, coarse, cb, s.settings,
                              dim)
    inner.record_active = steps = []
    try:
        got = cycle.coarse_solve(coarse, cb, s.settings)
    finally:
        inner.record_active = None
    active = sum(bool(a.all()) for a in steps)
    print(f"{dim}D exit by {exit_by}: {count} of 12 steps active")
    assert torch.equal(got, want)
    assert active == count and len(steps) == 12
    assert (count < 12) if exit_by == "tol" else (count == 12)


def test_masked_loop_stops_each_plane():
    """A batch of planes (plane relaxation's inner solve): each plane runs
    as many steps as its own while loop, and gets its x."""
    conf = {"log": [], "solver": {"relaxation": "plane-xy"},
            "plane-config": {
                "solver": {"relaxation": "point", "min-coarse": 5,
                           "cg-solver": "cedar"},
                "cg-config": {"solver": {"tol": 1e-9, "max-iter": 12}}}}
    s = Solver3(gallery.poisson3(12, 12, 5, device="cpu"), SevenPt, conf)
    # the planes' hierarchies stop at 6² (plane-config min-coarse 5: plane
    # hierarchies take all their levels, cedar_tpu/ops/planes3.py), whose
    # inner solvers have two levels
    hier = s.levels[0].planes["xy"][0]
    coarse, ps = hier[-1], s.settings.plane_settings
    assert len(coarse.inner) == 2
    nb = coarse.so.shape[1]
    # a random rhs, a constant one and zero (rel 0 after one step): other
    # step counts
    cb = torch.tensor(np.random.default_rng(9).standard_normal(
        (nb, *coarse.so.shape[2:])))
    cb[1] = 1.0
    cb[2] = 0.0
    inner.record_active = steps = []
    try:
        got = cycle2.coarse_solve(coarse, cb, ps)
    finally:
        inner.record_active = None
    counts = torch.stack(steps).reshape(len(steps), nb).sum(0).tolist()
    for p in range(nb):
        one = coarse._replace(inner=tuple(
            lev._replace(**{k: getattr(lev, k)[:, p:p + 1]
                            if getattr(lev, k).ndim == 4
                            else getattr(lev, k)[p:p + 1]
                            for k in ("so", "recip", "ci", "ainv")
                            if getattr(lev, k) is not None})
            for lev in coarse.inner))
        want, count = _while_loop(cycle2, stencil2.residual,
                                  StencilKind.nine_pt, one, cb[p:p + 1], ps,
                                  2)
        assert counts[p] == count
        np.testing.assert_allclose(got[p].numpy(), want[0].numpy(), rtol=0,
                                   atol=1e-13 * float(want.abs().max()))
    print(f"steps a plane: {counts}")
    assert len(set(counts)) > 1


def test_carried_nested_hierarchy():
    """A nested cedar_tpu hierarchy (depth 2) carried across: every inner
    level comes along, and the port's cycle on it equals the port's cycle
    on its own setup to 1e-12."""
    js, _, so, b, s, _ = solved("2d-128-nested")
    levels = levels_from_numpy(
        [{k: v for k, v in lev._asdict().items() if v is not None}
         for lev in js.levels], dtype=torch.float64)
    assert levels[-1].inner is not None
    assert levels[-1].inner[-1].inner is not None
    assert levels[-1].inner[-1].inner[-1].ainv is not None
    x0 = torch.tensor(np.random.default_rng(3).standard_normal(b.shape))
    tb = torch.tensor(b)
    mine = s.vcycle(x0, tb)
    t = copy.copy(s)
    t.levels = levels
    got = t.vcycle(x0, tb)
    np.testing.assert_allclose(got.numpy(), mine.numpy(), rtol=0,
                               atol=1e-12 * float(mine.abs().max()))


def test_plane_relaxation_in_3d_cg_config_refused():
    """cedar_tpu builds no plane solvers for an inner hierarchy
    (setup_planes runs on the outer levels only) and fails on plane
    relaxation inside cg-config; the port refuses it, unless the inner
    solver is a lone LU level, which both run."""
    so = np.asarray(jgallery.poisson3(16, 16, 16))
    conf = _cedar(2, {"relaxation": "plane-xy", "max-iter": 2},
                  **{"max-iter": 2})
    js = JSolver3(jnp.asarray(so), JKind.seven_pt, conf)
    with pytest.raises(TypeError):
        js.solve(jnp.asarray(np.ones(so.shape[1:])))
    with pytest.raises(NotImplementedError,
                       match="cedar_tpu_torch: cg-config relaxation plane-xy"):
        Solver3(torch.tensor(so), SevenPt, conf)
    # a one-level inner solver relaxes nothing: both packages run it
    conf = _cedar(3, {"relaxation": "plane-xy", "max-iter": 2},
                  **{"max-iter": 2})
    s = Solver3(torch.tensor(np.asarray(jgallery.poisson3(9, 9, 9))),
                SevenPt, conf)
    assert len(s.levels[-1].inner) == 1
    s.solve(torch.ones(9, 9, 9, dtype=torch.float64))


@pytest.mark.parametrize("conf, names", [
    (_cedar(2, {"cg-solver": "redist"}), r"cg-config cg-solver redist.*"
     r"item 9\b"),
    (_cedar(2, {"ml-relax": {"enabled": True}, "relaxation": "line-x"}),
     r"cg-config solver.ml-relax.*item 7\b"),
    ({**_cedar(2, {"relaxation": "plane-xy"})}, "2D inner solver"),
])
def test_refused_inner_configs(conf, names):
    with pytest.raises(NotImplementedError, match="cedar_tpu_torch") as e:
        Solver2(gallery.poisson(33, 33, device="cpu"), FivePt, conf)
    assert re.search(names, str(e.value)), str(e.value)
