"""The port's 3D plane-relaxation solve against cedar_tpu's Solver3.

* whole solves, histories and iterates: 16³ ``diag_diffusion3(1, 1,
  1e-3)`` plane-xy, 8³ ``poisson3`` plane-xyz, an 8³ ``fe3`` 27-point
  plane-yz, and outer F-cycles with plane-xy;
* a JAX plane hierarchy carried across (``levels_from_numpy``): one port
  cycle on it equals cedar_tpu's own cycle;
* the plane-configs outside the port raise, those it ports build and
  solve, and ``Solver2`` refuses plane relaxation.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu import Solver3 as JSolver3
from cedar_tpu import gallery as jgallery
from cedar_tpu.core.types import StencilKind as JKind

from cedar_tpu_torch import (
    NinePt, SevenPt, Solver2, Solver3, TwentySevenPt, gallery,
)
from cedar_tpu_torch.ops import planes3
from cedar_tpu_torch.ops.stencil3 import residual
from cedar_tpu_torch.solver.level import levels_from_numpy

torch.set_num_threads(2)


def _conf(relax, **solver):
    return {"log": [], "solver": {"relaxation": relax, "tol": 1e-9,
                                  "max-iter": 20, **solver}}


# the problems of tests/test_planes_3d.py, a 27-point one, and F-cycles
CASES = {
    "aniso16-xy": (lambda: jgallery.diag_diffusion3(16, 16, 16, 1.0, 1.0,
                                                    1e-3),
                   SevenPt, JKind.seven_pt, _conf("plane-xy")),
    "poisson8-xyz": (lambda: jgallery.poisson3(8, 8, 8), SevenPt,
                     JKind.seven_pt, _conf("plane-xyz")),
    "fe8-yz": (lambda: jgallery.fe3(8, 8, 8), TwentySevenPt,
               JKind.twenty_seven_pt, _conf("plane-yz")),
    "aniso8-xy-fcycle": (lambda: jgallery.diag_diffusion3(8, 8, 8, 1.0, 1.0,
                                                          1e-3),
                         SevenPt, JKind.seven_pt,
                         _conf("plane-xy", cycle={"type": "f"},
                               **{"max-iter": 2})),
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


def test_plane_solve_matches_jax(pair):
    s, js = pair["s"], pair["js"]
    b = torch.tensor(pair["b"])
    x = s.solve(b)
    assert s.nlevels == js.nlevels
    assert len(s.history) == len(js.history)
    # as tests/test_torch_solver3.py: rtol 1e-9 above the rounding floor,
    # an absolute floor of 1e-14 in relative-residual units near it
    np.testing.assert_allclose(s.history, js.history, rtol=1e-9, atol=1e-14)
    jx = pair["jx"]
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-9,
                               atol=1e-12 * float(np.abs(jx).max()))
    if pair["name"].endswith("fcycle"):
        assert len(set(s.history)) == 1
        return
    # tests/test_planes_3d.py's gates: near-direct on plane-aligned
    # anisotropy, and the true relative residual below the tolerance
    assert len(s.history) <= (5 if pair["name"].startswith("aniso") else 6)
    r = residual(s.levels[0].so, x, b, pair["kind"])
    assert float(r.norm() / b.norm()) < 1e-9


def test_plane_levels_are_batched_per_colour(pair):
    """Every non-coarsest level carries, per orientation, two contiguous
    batched 2D hierarchies (the zebra colours); the coarsest none."""
    s = pair["s"]
    for lev in s.levels[:-1]:
        assert set(lev.planes) == set(planes3.ORIENTS_OF[s.settings.relaxation])
        for orient, hiers in lev.planes.items():
            npl = lev.so.shape[1 + planes3.PLANE_SPECS[orient][0]]
            sizes = [0 if h is None else h[0].so.shape[1] for h in hiers]
            assert sizes == [(npl + 1) // 2, npl // 2]
            assert all(h is None or h[0].so.is_contiguous() for h in hiers)
        assert lev.recip is None
    assert s.levels[-1].planes is None


@pytest.fixture(scope="module")
def carried():
    """A JAX plane-xy Solver3 hierarchy (10x8x7 random 27-point operator:
    an odd count of xy planes) as numpy, the port's levels made from it,
    and a port solver of the same problem."""
    from test_kernels_3d import random_so

    so = random_so(np.random.default_rng(21), 10, 8, 7, True)
    b = np.random.default_rng(22).standard_normal(so.shape[1:])
    conf = _conf("plane-xy", **{"num-levels": 2})
    js = JSolver3(jnp.asarray(so), JKind.twenty_seven_pt, conf)
    levels_np = [
        {k: v for k, v in lev._asdict().items() if v is not None}
        for lev in js.levels
    ]
    levels = levels_from_numpy(levels_np, dtype=torch.float64)
    return dict(js=js, b=b, levels=levels,
                s=Solver3(torch.tensor(so), TwentySevenPt, conf))


def test_cycle_on_jax_plane_hierarchy(carried):
    """One port V-cycle on the carried JAX plane hierarchy equals the JAX
    package's V-cycle on its own levels."""
    js, levels, b = carried["js"], carried["levels"], carried["b"]
    assert len(levels) == len(js.levels)
    for orient, (h0, h1) in levels[0].planes.items():
        jh = js.levels[0].planes[orient]
        assert len(h0) == len(jh)
        assert h0[0].so.shape[1] + h1[0].so.shape[1] == jh[0].so.shape[0]
    x0 = np.random.default_rng(3).standard_normal(b.shape)
    want = np.asarray(js.vcycle(jnp.asarray(x0), jnp.asarray(b)))
    s = copy.copy(carried["s"])
    s.levels = levels
    tx0 = torch.tensor(x0)
    got = s.vcycle(tx0, torch.tensor(b))
    np.testing.assert_array_equal(tx0.numpy(), x0)
    # JAX's lines of 16 points and more take SPIKE factors: rtol 1e-9
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                               atol=1e-12 * float(np.abs(want).max()))
    # and the port's own hierarchy gives the same cycle
    mine = carried["s"].vcycle(torch.tensor(x0), torch.tensor(b))
    np.testing.assert_allclose(mine.numpy(), want, rtol=1e-9,
                               atol=1e-12 * float(np.abs(want).max()))


@pytest.mark.parametrize("pconf, match", [
    pytest.param({"solver": {"relaxation": "line-xy",
                             "cg-solver": "redist"}},
                 "cg-solver", id="pconf4-cg-solver"),
    pytest.param({"solver": {"relaxation": "line-xy",
                             "ml-relax": {"enabled": True}}},
                 "ml-relax", id="pconf6-ml-relax"),
])
def test_unported_plane_configs_raise(pconf, match):
    conf = {"solver": {"relaxation": "plane-xy"}, "plane-config": pconf}
    with pytest.raises(NotImplementedError, match=f"cedar_tpu_torch.*{match}"):
        Solver3(gallery.poisson3(8, 8, 8, device="cpu"), SevenPt, conf)


# the plane-configs that test_unported_plane_configs_raise held refused
# until they were ported, under its ids
PLANE_PORTED = [
    pytest.param({"solver": {"relaxation": "point"}},
                 id="pconf0-relaxation point"),
    pytest.param({"solver": {"relaxation": "line-x"}},
                 id="pconf1-relaxation line-x"),
    pytest.param({"solver": {"relaxation": "line-y"}},
                 id="pconf2-relaxation line-y"),
    pytest.param({"solver": {"relaxation": "line-xy",
                             "cycle": {"type": "f"}}}, id="pconf3-F-cycle"),
    # the plane-config's grid.periodic is accepted and ignored, as in
    # cedar_tpu
    pytest.param({"solver": {"relaxation": "line-xy",
                             "cycle": {"type": "f"}},
                  "grid": {"periodic": [True, False, False]}},
                 id="pconf5-periodic"),
]


@pytest.mark.parametrize("pconf", PLANE_PORTED)
def test_ported_plane_configs_solve(pconf):
    """The same plane-configs build and solve: the embedded solvers run
    the configured relaxation and cycle, their hierarchies non-periodic,
    and the solve reaches the tolerance; with F-cycles, which start each
    plane solve from its rhs alone (as cedar_tpu's do), the plane solves
    are as inexact at every outer cycle and the solve stalls at their
    accuracy (4.51e-4 here, the first cycle's)."""
    fcycle = pconf["solver"].get("cycle", {}).get("type") == "f"
    conf = {"log": [], "solver": {"relaxation": "plane-xy", "tol": 1e-9,
                                  "max-iter": 4 if fcycle else 20},
            "plane-config": pconf}
    so = gallery.diag_diffusion3(8, 8, 8, 1.0, 1.0, 1e-3, device="cpu")
    b = gallery.poisson3_rhs(8, 8, 8, device="cpu")
    s = Solver3(so, SevenPt, conf)
    ps = s.settings.plane_settings
    assert ps.relaxation.value == pconf["solver"]["relaxation"]
    x = s.solve(b)
    r = float(residual(s.levels[0].so, x, b, SevenPt).norm() / b.norm())
    if fcycle:
        assert len(s.history) == 4 and s.history[-1] < 5e-4
        assert r < 5e-4
    else:
        assert s.history[-1] < 1e-9 and r < 1e-9


def test_solver2_refuses_plane_relaxation():
    with pytest.raises(NotImplementedError, match="plane relaxation is 3D"):
        Solver2(gallery.fe(9, 9, device="cpu"), NinePt,
                {"solver": {"relaxation": "plane-xy"}})
