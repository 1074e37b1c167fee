"""The port's captured solve (cedar_tpu_torch.solver.graph) on the CPU.

* Capture safety: one iteration of every configuration the port runs
  (``cycle_residual`` and ``run_cycle``; 2D point V, F and W cycles fused
  and dense, line-x, -y and -xy; 3D 7- and 27-point V, F and W cycles
  fused and dense, plane-xy, -xz, -yz and -xyz; float32 and float64) runs
  no op that reads a device value back to the host and builds no tensor
  from host data, either of which would break or freeze a CUDA graph.
  The 2D periodic configurations (point V and F, line-x, -y and -xy,
  the doubly periodic indefinite case, fine-split asked for) and the 3D
  ones (7-point V at even and odd periodic extents, the 27-point triply
  periodic indefinite case, F, plane-yz and plane-xy, fine-split asked
  for) too; the inner multigrid coarse solve (``cg-solver: cedar``: 2D
  V, F, fused, nested and doubly periodic indefinite, 3D V and fused) and
  the plane-configs of point, line-x and line-y relaxation, the F-cycle
  and the inner solve.
* The graph runner's bookkeeping, with a stand-in backend that records
  the captured callable and replays it eagerly: its ``solve`` equals the
  solver's eager loop bit for bit (history, ``x``, iteration count at a
  ``tol``, ``max-iter`` and NaN stop), leaves ``x0`` and ``b`` alone and
  returns results a later call does not overwrite; its ``solve`` against
  cedar_tpu's.
* A solver given another hierarchy (``s.levels = ...``, one carried
  across from cedar_tpu with ``levels_from_numpy``) drops its graphs, and
  the graph path's ``solve`` and ``vcycle`` then follow the new hierarchy,
  bit for bit equal to the eager loop over it.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cedar_tpu import Solver2 as JSolver2
from cedar_tpu import Solver3 as JSolver3
from cedar_tpu import gallery as jgallery
from cedar_tpu.core.types import StencilKind as JKind

from cedar_tpu_torch import (
    FivePt, NinePt, SevenPt, Solver2, Solver3, TwentySevenPt, gallery,
)
from cedar_tpu_torch.solver import cycle2, cycle3, graph
from cedar_tpu_torch.solver.level import levels_from_numpy

torch.set_num_threads(2)

CPU = torch.device("cpu")
FUSED2 = {"kernels": {"fine-split": True, "split-levels": 2}}
FUSED3 = {"kernels": {"fine-split": True}}


def _aniso3(nx, ny, nz, dtype, device):
    return gallery.diag_diffusion3(nx, ny, nz, 1.0, 1.0, 1e-3, dtype, device)


def _plane(relax):
    return {"solver": {"relaxation": relax}}


def _periodic3(make, per):
    """``make``'s 3D operator with its couplings kept across the periodic
    axes ``per`` (gallery.periodic3)."""
    def periodic(nx, ny, nz, dtype, device):
        return gallery.periodic3(make(nx, ny, nz, dtype, device), per)
    return periodic


def _grid3(per, **solver):
    return {"grid": {"periodic": list(per)}, "solver": solver}


def _cedar(levels, cg=None, **solver):
    """The inner multigrid coarse solve below ``levels`` outer levels,
    a cg-config of 3 steps (``cg``: more of its solver section)."""
    return {"solver": {"num-levels": levels, "cg-solver": "cedar",
                       **solver},
            "cg-config": {"solver": {"tol": 1e-6, "max-iter": 3,
                                     **(cg or {})}}}


def _plane_config(relax, **psolver):
    """``relax`` plane relaxation with the plane-config solver section
    ``psolver`` (an inner solve: a cg-config of 3 steps)."""
    return {"solver": {"relaxation": relax},
            "plane-config": {"solver": psolver,
                             "cg-config": {"solver": {"tol": 1e-6,
                                                      "max-iter": 3}}}}


# name -> (gallery operator, kind, shape, conf); 2-4 levels each
CONFIGS = {
    "2d-point-v-dense": (gallery.poisson, FivePt, (17, 13), {}),
    "2d-point-v-fused": (gallery.poisson, FivePt, (17, 13), FUSED2),
    "2d-point-v22-fused": (gallery.poisson, FivePt, (17, 13), {
        **FUSED2, "solver": {"cycle": {"nrelax-pre": 2, "nrelax-post": 2}}}),
    "2d-point-f-dense": (gallery.poisson, FivePt, (17, 13),
                         {"solver": {"cycle": {"type": "f"}}}),
    "2d-point-f-fused": (gallery.poisson, FivePt, (17, 13), {
        **FUSED2, "solver": {"cycle": {"type": "f"}}}),
    "2d-line-x": (gallery.fe, NinePt, (17, 13),
                  {"solver": {"relaxation": "line-x"}}),
    "2d-line-y": (gallery.fe, NinePt, (17, 13),
                  {"solver": {"relaxation": "line-y"}}),
    "2d-line-xy": (gallery.fe, NinePt, (17, 13),
                   {"solver": {"relaxation": "line-xy"}}),
    "3d-7pt-v-dense": (gallery.poisson3, SevenPt, (9, 9, 9), {}),
    "3d-7pt-v-fused": (gallery.poisson3, SevenPt, (9, 9, 9), FUSED3),
    "3d-7pt-v22-fused": (gallery.poisson3, SevenPt, (9, 9, 9), {
        **FUSED3, "solver": {"cycle": {"nrelax-pre": 2, "nrelax-post": 2}}}),
    "3d-7pt-f-dense": (gallery.poisson3, SevenPt, (9, 9, 9),
                       {"solver": {"cycle": {"type": "f"}}}),
    "3d-7pt-f-fused": (gallery.poisson3, SevenPt, (9, 9, 9), {
        **FUSED3, "solver": {"cycle": {"type": "f"}}}),
    "3d-27pt-v-dense": (gallery.fe3, TwentySevenPt, (9, 9, 9), {}),
    "3d-27pt-v-fused": (gallery.fe3, TwentySevenPt, (9, 9, 9), FUSED3),
    "3d-27pt-f-fused": (gallery.fe3, TwentySevenPt, (9, 9, 9), {
        **FUSED3, "solver": {"cycle": {"type": "f"}}}),
    "3d-plane-xy": (_aniso3, SevenPt, (8, 8, 8), _plane("plane-xy")),
    "3d-plane-xz": (_aniso3, SevenPt, (8, 7, 6), _plane("plane-xz")),
    "3d-plane-yz": (gallery.fe3, TwentySevenPt, (6, 7, 8),
                    _plane("plane-yz")),
    "3d-plane-xyz": (gallery.poisson3, SevenPt, (8, 8, 8),
                     _plane("plane-xyz")),
    "2d-periodic-point-v": (gallery.poisson, FivePt, (16, 12),
                            {"grid": {"periodic": [True, False]}}),
    "2d-periodic-point-f": (gallery.poisson, FivePt, (16, 12), {
        "grid": {"periodic": [False, True]},
        "solver": {"cycle": {"type": "f"}}}),
    "2d-periodic-fine-split": (gallery.poisson, FivePt, (16, 12), {
        **FUSED2, "grid": {"periodic": [True, True]}}),
    "2d-periodic-line-x": (gallery.fe, NinePt, (16, 12), {
        "grid": {"periodic": [True, False]},
        "solver": {"relaxation": "line-x"}}),
    "2d-periodic-line-y": (gallery.fe, NinePt, (16, 12), {
        "grid": {"periodic": [False, True]},
        "solver": {"relaxation": "line-y"}}),
    "2d-periodic-line-xy-indefinite": (gallery.poisson, FivePt, (16, 12), {
        "grid": {"periodic": [True, True]},
        "solver": {"relaxation": "line-xy", "definite": False}}),
    "3d-periodic-7pt-v": (_periodic3(gallery.poisson3, (True, False, False)),
                          SevenPt, (10, 8, 8),
                          _grid3((True, False, False))),
    "3d-periodic-7pt-v-odd": (_periodic3(gallery.poisson3,
                                         (False, True, False)),
                              SevenPt, (8, 11, 8),
                              _grid3((False, True, False))),
    "3d-periodic-27pt-v-indefinite": (
        _periodic3(gallery.fe3, (True, True, True)), TwentySevenPt,
        (8, 8, 8), _grid3((True, True, True), definite=False)),
    "3d-periodic-f": (_periodic3(gallery.poisson3, (False, False, True)),
                      SevenPt, (8, 8, 10),
                      _grid3((False, False, True), cycle={"type": "f"})),
    "3d-periodic-fine-split": (
        _periodic3(gallery.poisson3, (True, False, False)), SevenPt,
        (10, 8, 8), {**FUSED3, **_grid3((True, False, False))}),
    "3d-periodic-plane-yz": (
        _periodic3(gallery.poisson3, (True, False, False)), SevenPt,
        (8, 8, 8), _grid3((True, False, False), relaxation="plane-yz")),
    "3d-periodic-plane-xy": (
        _periodic3(_aniso3, (False, False, True)), SevenPt, (8, 8, 8),
        _grid3((False, False, True), relaxation="plane-xy")),
    # the inner multigrid coarse solve (a masked loop of max-iter inner
    # cycles) and the plane-configs beyond line-xy V-cycles
    "2d-cedar-v": (gallery.poisson, FivePt, (33, 29), _cedar(2)),
    "2d-cedar-nested": (gallery.poisson, FivePt, (33, 29), {
        **_cedar(2, {"num-levels": 2, "cg-solver": "cedar"}),
        "cg-config": {"solver": {"max-iter": 3, "num-levels": 2,
                                 "cg-solver": "cedar"},
                      "cg-config": {"solver": {"max-iter": 3}}}}),
    "2d-cedar-f": (gallery.poisson, FivePt, (33, 29),
                   _cedar(2, cycle={"type": "f"})),
    "2d-cedar-fused": (gallery.poisson, FivePt, (33, 29),
                       {**FUSED2, **_cedar(3)}),
    "2d-cedar-periodic-indefinite": (
        gallery.poisson, FivePt, (32, 24), {
            **_cedar(2, definite=False),
            "grid": {"periodic": [True, True]}}),
    "3d-cedar-v": (gallery.poisson3, SevenPt, (9, 9, 9), _cedar(2)),
    "3d-cedar-fused": (gallery.fe3, TwentySevenPt, (17, 17, 17),
                       {**FUSED3, **_cedar(3)}),
    "3d-plane-point": (_aniso3, SevenPt, (8, 8, 7),
                       _plane_config("plane-xy", relaxation="point")),
    "3d-plane-line-x": (gallery.fe3, TwentySevenPt, (8, 7, 6),
                        _plane_config("plane-yz", relaxation="line-x")),
    "3d-plane-line-y": (gallery.poisson3, SevenPt, (7, 7, 7),
                        _plane_config("plane-xyz", relaxation="line-y")),
    "3d-plane-f": (_aniso3, SevenPt, (8, 8, 8),
                   _plane_config("plane-xy", cycle={"type": "f"},
                                 **{"max-iter": 1})),
    "3d-plane-cedar": (_aniso3, SevenPt, (10, 10, 5),
                       _plane_config("plane-xy", **{
                           "cg-solver": "cedar", "min-coarse": 5})),
}
DTYPES = {"f32": torch.float32, "f64": torch.float64}

_solvers = {}


def solver_of(name: str, dtype):
    """The configuration's solver on the CPU (built once) and its rhs."""
    key = (name, dtype)
    if key not in _solvers:
        make, kind, shape, conf = CONFIGS[name]
        cls, rhs = ((Solver2, gallery.poisson_rhs) if len(shape) == 2
                    else (Solver3, gallery.poisson3_rhs))
        s = cls(make(*shape, dtype, CPU), kind, {"log": [], **conf})
        _solvers[key] = (s, rhs(*shape, dtype, CPU))
    return _solvers[key]


# aten ops that read a device value back to the host (each synchronises
# the stream, which a capture refuses)
SYNCING = {"_local_scalar_dense", "item", "nonzero", "nonzero_static",
           "is_nonzero", "equal", "masked_select", "allclose"}


class NoHostSync(TorchDispatchMode):
    """Raises on every op of :data:`SYNCING` and every ``unique`` op."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in SYNCING or name.lstrip("_").startswith("unique"):
            raise AssertionError(f"host-syncing op {func} in a cycle")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def capture_safe(monkeypatch):
    """No host-syncing op and no tensor built from host data inside."""
    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"torch.{name} in a cycle")
        return f

    with monkeypatch.context() as m:
        for name in ("tensor", "as_tensor", "from_numpy"):
            m.setattr(torch, name, refuse(name))
        with NoHostSync():
            yield


def test_no_host_sync_catches_readbacks(monkeypatch):
    """The guard itself: a readback, a branch on a value and a tensor from
    host data all raise inside it."""
    t = torch.ones(3)
    for bad in (lambda: float(t.sum()), lambda: bool(t[0] > 0),
                lambda: t.nonzero(), lambda: torch.unique(t),
                lambda: torch.tensor([1.0]), lambda: torch.equal(t, t)):
        with pytest.raises(AssertionError):
            with capture_safe(monkeypatch):
                bad()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fn", ["cycle_residual", "run_cycle"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_cycle_is_capture_safe(name, fn, dtype, monkeypatch):
    s, b = solver_of(name, DTYPES[dtype])
    cycle = cycle2 if b.ndim == 2 else cycle3
    x = torch.zeros_like(b)
    with capture_safe(monkeypatch):
        out = getattr(cycle, fn)(s.levels, s.kinds, x, b, s.settings,
                                 **s.graphs.cycle_kw)
    x_new = out[0] if fn == "cycle_residual" else out
    assert x_new.shape == b.shape and torch.isfinite(x_new).all()
    if fn == "cycle_residual":
        assert out[1].ndim == 0 and out[1].dtype == b.dtype


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["2d-point-v-dense", "2d-line-xy",
                                  "3d-7pt-v-dense", "3d-27pt-v-dense",
                                  "2d-periodic-line-x",
                                  "3d-periodic-27pt-v-indefinite"])
def test_w_cycle_is_capture_safe(name, dtype, monkeypatch):
    """The W-cycle (``ncycle`` with n = 2)."""
    s, b = solver_of(name, DTYPES[dtype])
    cycle = cycle2 if b.ndim == 2 else cycle3
    with capture_safe(monkeypatch):
        x = cycle.ncycle(s.levels, s.kinds, 0, torch.zeros_like(b), b,
                         s.settings, n=2, **s.graphs.cycle_kw)
    assert torch.isfinite(x).all()


class EagerGraphs:
    """Stand-in backend: records the captured callable (without running
    it) and replays it eagerly."""

    def __init__(self):
        self.warmed = self.captured = self.replays = 0

    def warm(self, fn):
        self.warmed += 1
        fn()

    def capture(self, fn):
        self.captured += 1
        return fn

    def replay(self, fn):
        self.replays += 1
        fn()


def runner_of(s, b):
    return graph.CycleGraphs(cycle2 if b.ndim == 2 else cycle3, s.levels,
                             s.kinds, s.settings, EagerGraphs(),
                             **s.graphs.cycle_kw)


# name -> (gallery operator, kind, shape, conf) of the runner's solves
SOLVES = {
    "2d-fused": (gallery.poisson, FivePt, (33, 29), FUSED2),
    "2d-cedar": (gallery.poisson, FivePt, (33, 29), _cedar(2)),
    "2d-line-xy": (gallery.fe, NinePt, (33, 29),
                   {"solver": {"relaxation": "line-xy"}}),
    "3d-7pt": (gallery.poisson3, SevenPt, (17, 15, 13), {}),
    "3d-plane-xy": (_aniso3, SevenPt, (8, 8, 8), _plane("plane-xy")),
}
# stop -> (solver settings, x0 of the solve)
STOPS = {
    "tol": ({"tol": 1e-8, "max-iter": 30}, "zeros"),
    "max-iter": ({"tol": 1e-30, "max-iter": 3}, "random"),
    "nan": ({"tol": 1e-8, "max-iter": 30}, "nan"),
}


def solve_case(name, stop):
    make, kind, shape, conf = SOLVES[name]
    solver, start = STOPS[stop]
    conf = {**conf, "log": [],
            "solver": {**conf.get("solver", {}), **solver}}
    cls, rhs = ((Solver2, gallery.poisson_rhs) if len(shape) == 2
                else (Solver3, gallery.poisson3_rhs))
    s = cls(make(*shape, torch.float64, CPU), kind, conf)
    b = rhs(*shape, torch.float64, CPU)
    rng = np.random.default_rng(5)
    x0 = torch.tensor(rng.standard_normal(shape))
    if start == "zeros":
        x0.zero_()
    elif start == "nan":
        x0[(1,) * len(shape)] = float("nan")
    return s, b, x0


@pytest.mark.parametrize("stop", list(STOPS))
@pytest.mark.parametrize("name", list(SOLVES))
def test_runner_solve_equals_eager_loop(name, stop):
    s, b, x0 = solve_case(name, stop)
    x0_in, b_in = x0.clone(), b.clone()
    x_eager = s.solve(b, x0)
    hist = list(s.history)
    r = runner_of(s, b)
    x, hist_g = r.solve(x0, b, s.res0)
    np.testing.assert_array_equal(hist_g, hist)
    np.testing.assert_array_equal(x.numpy(), x_eager.numpy())
    if stop == "tol":
        assert 1 < len(hist) < 30 and hist[-1] < 1e-8
    elif stop == "max-iter":
        assert len(hist) == 3
    else:
        assert len(hist) == 1 and np.isnan(hist[0])
    np.testing.assert_array_equal(x0.numpy(), x0_in.numpy())
    assert torch.equal(b, b_in)
    # one capture, after one warm-up; one replay a cycle
    assert (r.backend.warmed, r.backend.captured) == (1, 1)
    assert r.backend.replays == len(hist)

    # a second solve, from another start, replays the same graph and
    # leaves the first result as it was
    x_first = x.clone()
    x2, hist2 = r.solve(torch.zeros_like(b), b, s.res0)
    assert (r.backend.warmed, r.backend.captured) == (1, 1)
    np.testing.assert_array_equal(x.numpy(), x_first.numpy())
    assert x2.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("name", list(SOLVES))
def test_runner_vcycle_equals_run_cycle(name):
    s, b, x0 = solve_case(name, "max-iter")
    x0_in, b_in = x0.clone(), b.clone()
    r = runner_of(s, b)
    got = r.vcycle(x0, b)
    want = s.vcycle(x0, b)
    assert torch.equal(got, want)
    assert torch.equal(x0, x0_in) and torch.equal(b, b_in)
    # a second cycle from another start leaves the first result alone;
    # its graph is the vcycle one, kept beside the solve's
    first = got.clone()
    again = r.vcycle(torch.zeros_like(b), b)
    assert torch.equal(got, first) and not torch.equal(again, got)
    r.solve(x0, b, 1.0)
    assert r.backend.captured == 2 and len(r.graphs) == 2


def test_capture_needs_a_warm_up():
    s, b, _ = solve_case("2d-fused", "tol")
    g = runner_of(s, b).graph("solve", b)
    with pytest.raises(RuntimeError, match="warm"):
        g.capture()
    with pytest.raises(ValueError, match="solve"):
        graph.CycleGraph(EagerGraphs(), "cycle", cycle2, s.levels, s.kinds,
                         s.settings, b)


def test_cpu_solve_runs_eagerly():
    """On the CPU the solver's own solve and vcycle capture nothing."""
    s, b, x0 = solve_case("3d-7pt", "max-iter")
    s.solve(b, x0)
    s.vcycle(x0, b)
    assert s.graphs.graphs == {} and s.graphs.backend is None


def _jax_levels(js):
    return levels_from_numpy(
        [{k: np.asarray(v) for k, v in lev._asdict().items()
          if v is not None} for lev in js.levels], dtype=torch.float64)


# name -> (port operator of the solver, cedar_tpu operator whose hierarchy
# replaces its own, port kind, JAX kind, conf): the same shapes, another
# operator
REPLACED = {
    "2d": (lambda: gallery.poisson(33, 29, device=CPU),
           lambda: jgallery.diag_diffusion(33, 29, 1.0, 0.1),
           FivePt, JKind.five_pt, {}),
    "2d-periodic": (lambda: gallery.poisson(32, 24, device=CPU),
                    lambda: jnp.asarray(_periodic_x(32, 24)),
                    FivePt, JKind.five_pt,
                    {"grid": {"periodic": [True, False]}}),
    "3d": (lambda: gallery.poisson3(13, 11, 9, device=CPU),
           lambda: jgallery.diag_diffusion3(13, 11, 9, 1.0, 0.5, 0.1),
           SevenPt, JKind.seven_pt, {}),
}


def _periodic_x(nx, ny):
    """5-point Poisson periodic in x: W couples row 0 to row nx-1."""
    so = np.zeros((3, nx, ny))
    so[1] = 1.0
    so[2, :, 1:] = 1.0
    so[0] = 4.0
    return so


@pytest.mark.parametrize("name", list(REPLACED))
def test_graphs_follow_replaced_levels(name):
    """``s.levels = other`` drops the graphs captured over the old
    hierarchy; the graph path's solve and vcycle (the stand-in backend)
    then run the new one: bit for bit the eager loop over it, and its
    vcycle that of cedar_tpu over the same hierarchy."""
    make, jmake, kind, jkind, conf = REPLACED[name]
    conf = {"log": [], **conf, "solver": {"tol": 1e-30, "max-iter": 3}}
    so = make()
    cls, jcls = (Solver2, JSolver2) if so.ndim == 3 else (Solver3, JSolver3)
    s = cls(so, kind, conf)
    rng = np.random.default_rng(8)
    b = torch.tensor(rng.standard_normal(tuple(so.shape[1:])))
    x0 = torch.tensor(rng.standard_normal(tuple(so.shape[1:])))
    # a capture over the setup hierarchy
    s.graphs.backend = EagerGraphs()
    x_old, _ = s.graphs.solve(x0, b, 1.0)
    old = s.graphs
    assert len(old.graphs) == 1

    js = jcls(jmake(), jkind, conf)
    s.levels = _jax_levels(js)
    assert s.graphs is not old and s.graphs.levels is s.levels
    assert s.graphs.graphs == {} and s.graphs.backend is None
    assert s.graphs.cycle_kw == old.cycle_kw
    s.graphs.backend = EagerGraphs()

    x_eager = s.solve(b, x0)   # the CPU's eager loop over s.levels
    x_graph, hist = s.graphs.solve(x0, b, s.res0)
    np.testing.assert_array_equal(hist, s.history)
    assert torch.equal(x_graph, x_eager)
    assert not torch.equal(x_graph, x_old)
    assert s.graphs.backend.captured == 1

    got = s.graphs.vcycle(x0, b)
    assert torch.equal(got, s.vcycle(x0, b))
    want = np.asarray(js.vcycle(jnp.asarray(x0.numpy()),
                                jnp.asarray(b.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-13 * float(np.abs(want).max()))


# name -> (JAX gallery operator, port kind, JAX kind, shape)
JAX_CASES = {
    "poisson-45x37": (jgallery.poisson, FivePt, JKind.five_pt, (45, 37)),
    "fe3-12": (jgallery.fe3, TwentySevenPt, JKind.twenty_seven_pt,
               (12, 12, 12)),
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_runner_solve_matches_jax(name):
    """The runner's solve against cedar_tpu's solve (the tolerances of
    tests/test_torch_solver2.py and test_torch_solver3.py)."""
    make, kind, jkind, shape = JAX_CASES[name]
    so = np.asarray(make(*shape))
    conf = {"log": [], "solver": {"tol": 1e-9, "max-iter": 30}}
    if len(shape) == 2:
        b = np.asarray(jgallery.poisson_rhs(*shape))
        js = JSolver2(jnp.asarray(so), jkind, conf)
        s = Solver2(torch.tensor(so), kind, conf)
    else:
        b = np.asarray(jgallery.poisson3_rhs(*shape))
        js = JSolver3(jnp.asarray(so), jkind, conf)
        s = Solver3(torch.tensor(so), kind, conf)
    jx = np.asarray(js.solve(jnp.asarray(b)))
    tb = torch.tensor(b)
    s.solve(tb)   # the eager loop: res0
    x, hist = runner_of(s, tb).solve(torch.zeros_like(tb), tb, s.res0)
    assert len(hist) == len(js.history) <= 12
    # rtol 1e-9 while the residual is well above its rounding floor; near
    # 1e-10 relative, b - A x keeps only a few digits in either package
    np.testing.assert_allclose(hist, js.history, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-9,
                               atol=1e-12 * float(np.abs(jx).max()))
