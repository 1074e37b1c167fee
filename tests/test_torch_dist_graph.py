"""The port's recorded distributed iteration (``cedar_tpu_torch.solver.
graph.RecordedIteration`` over ``cedar_tpu_torch.parallel.comm``'s one
choke point) in one world of 4 gloo processes on the CPU, float64, against
the eager distributed loop and cedar_tpu's ``DistSolver2``.

The card captures the iteration as CUDA graphs; here a stand-in backend
(:class:`Emulated`) records each segment's ops, their outputs at fixed
tensors as a graph's are at fixed addresses, and a replay runs them again
into those tensors.  Inside a segment it refuses every op that reads a
device value back and every tensor built from host data (the check of
tests/test_torch_graph.py), so every recording is also a capture-safety
check: outside the choke point no op of a distributed iteration does
either.  The world's meshes are marked staged (gloo on CUDA tensors, each
message copied through the host), so the calls take the staging path.

* capture safety and segments: the solve's iteration of 2D point, line-x,
  line-xy with SPIKE, line-x and line-xy with the gather (ml-relax), the
  doubly and the x-periodic cases, line-x on a (1, 4) mesh, 3D 7- and
  27-point point relaxation, plane-xy (32³ and 16³) and 27-point
  plane-xyz on a (2, 2, 1) mesh: cut exactly at its collective calls,
  one segment more than tools/dist_comm.py predicts (exchanges, gathers,
  reductions), the counts those of the capture;
* bookkeeping: the solver's graphs (``s.graphs`` with the stand-in)
  ``solve`` equal the eager loop bit for bit (history, x, the stop at
  ``tol``, at ``max-iter`` and on NaN: 2D point; SPIKE line-xy and
  plane-xy at ``max-iter``) and ``vcycle`` equals ``run_cycle``, x0 and b
  left alone; ``s.levels = local_levels(...)``
  drops the graphs, and the next solve follows the new hierarchy;
* one recorded solve against cedar_tpu's ``DistSolver2`` (64², (2, 2),
  four cycles) within 1e-11, the tolerance tests/test_torch_dist.py holds
  four-cycle mesh solves to;
* without a world: the capture rule is a table by backend (gloo none,
  NCCL all, another refused), and a recorded iteration of a toy cycle is
  one segment where every call is capturable and a segment a call more
  otherwise, its replay equal to the eager iteration.

The rank function imports neither jax nor cedar_tpu.
"""

import contextlib
import copy
import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from cedar_tpu_torch import (
    FivePt, NinePt, SevenPt, Solver2, TwentySevenPt, gallery,
)
from cedar_tpu_torch.parallel import DistSolver2, DistSolver3, comm, make_mesh
from cedar_tpu_torch.parallel.dist import local_levels
from cedar_tpu_torch.parallel.launch import start
from cedar_tpu_torch.parallel.topo import Mesh
from cedar_tpu_torch.settings import MLSettings
from cedar_tpu_torch.solver import cycle2, cycle3, graph
from cedar_tpu_torch.tools import dist_comm

# aten ops that read a device value back to the host (each synchronises
# the stream, which a capture refuses)
SYNCING = {"_local_scalar_dense", "item", "nonzero", "nonzero_static",
           "is_nonzero", "equal", "masked_select", "allclose"}
# ops a CUDA graph holds no kernel for: a replay leaves their memory alone
EMPTY = {"empty", "empty_like", "new_empty", "empty_strided",
         "new_empty_strided"}


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


class _Record(NoHostSync):
    """A segment's ops: ``(func, args, kwargs, out)`` in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self.ops.append((func, args, kwargs or {}, out))
        return out


def _aliases(a, b) -> bool:
    return (a.untyped_storage().data_ptr()
            == b.untyped_storage().data_ptr())


class Emulated:
    """Stand-in backend of a recorded iteration on the CPU: a segment is
    the list of ops recorded between :meth:`begin` and :meth:`end` under
    :func:`capture_safe`'s check; :meth:`replay` runs them again on the
    recorded tensors and writes each result into the recorded output (a
    view or an in-place op's result is that output already; an ``empty``
    is left alone, as a graph leaves it).  ``warm``, ``capture`` and
    ``replay`` of a one-graph iteration as tests/test_torch_graph.py's
    stand-in."""

    def __init__(self):
        self.warmed = self.segments = self.replays = 0
        self._stack = None

    def warm(self, fn):
        self.warmed += 1
        fn()

    @contextlib.contextmanager
    def capturing(self):
        yield

    def begin(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(capture_safe(pytest.MonkeyPatch()))
        mode = self._stack.enter_context(_Record())
        self._mode = mode

    def end(self):
        self._stack.close()
        self.segments += 1
        return self._mode.ops

    def replay(self, ops):
        self.replays += 1
        for func, args, kwargs, out in ops:
            if func.overloadpacket.__name__ in EMPTY:
                continue
            res = func(*args, **kwargs)
            for o, r in zip(pytree.tree_leaves(out),
                            pytree.tree_leaves(res)):
                if isinstance(o, torch.Tensor) and not _aliases(o, r):
                    o.copy_(r)


@dataclasses.dataclass
class StagedMesh(Mesh):
    """A mesh whose calls take the staging path (gloo on CUDA tensors:
    each message copied through the host), on CPU tensors."""

    @property
    def staged(self) -> bool:
        return True


def staged(mesh: Mesh) -> StagedMesh:
    return StagedMesh(**{f.name: getattr(mesh, f.name)
                         for f in dataclasses.fields(mesh)})


def _aniso3(n):
    return gallery.diag_diffusion3(n, n, n, 1.0, 1.0, 1e-3, device="cpu")


def _op2(which, n):
    if which == "fe":
        return gallery.fe(n, n, device="cpu")
    if which == "dd":
        return gallery.diag_diffusion(n, n, 50.0, 1.0, device="cpu")
    return gallery.poisson(n, n, device="cpu")


def _op3(which, n):
    if which == "aniso":
        return _aniso3(n)
    if which == "fe":
        return gallery.fe3(n, n, n, device="cpu")
    return gallery.poisson3(n, n, n, device="cpu")


def _conf(relax="point", periodic=None, ml=False, **solver):
    conf = {"log": [], "solver": {"relaxation": relax, "tol": 1e-8,
                                  "max-iter": 20, **solver}}
    if ml:
        conf["solver"]["ml-relax"] = {"enabled": True}
    if periodic:
        conf["grid"] = {"periodic": list(periodic)}
    return conf


# name -> (ndim, operator, kind, n, conf, mesh): the iterations recorded
# and counted; lx_fe .. lx_fe_14 are tests/test_torch_dist_lines.py's
# counted solves, c_xy32 and c_fe_xyz tests/test_torch_dist_planes.py's
# (on a (2, 2, 1) mesh here)
CASES = {
    "p2": (2, "p", FivePt, 64, _conf(), (2, 2)),
    "lx_fe": (2, "fe", NinePt, 64, _conf("line-x"), (2, 2)),
    "lxy_dd": (2, "dd", FivePt, 64, _conf("line-xy", **{"max-iter": 25}),
               (2, 2)),
    "ml_fe": (2, "fe", NinePt, 64, _conf("line-x", ml=True), (2, 2)),
    "per_p": (2, "p", FivePt, 64, _conf(periodic=(True, True)), (2, 2)),
    "perlx_p": (2, "p", FivePt, 64, _conf("line-x", (True, False)), (2, 2)),
    "mlxy_fe": (2, "fe", NinePt, 64, _conf("line-xy", ml=True, tol=1e-30,
                                           **{"max-iter": 3}), (2, 2)),
    "lx_fe_14": (2, "fe", NinePt, 64, _conf("line-x"), (1, 4)),
    "p7": (3, "p", SevenPt, 16, _conf(), (2, 2, 1)),
    "fe27": (3, "fe", TwentySevenPt, 16, _conf(), (2, 2, 1)),
    "c_xy32": (3, "aniso", SevenPt, 32, _conf("plane-xy", cycle={
        "nrelax-pre": 1, "nrelax-post": 1}), (2, 2, 1)),
    "c_fe_xyz": (3, "fe", TwentySevenPt, 16, _conf("plane-xyz", cycle={
        "nrelax-pre": 1, "nrelax-post": 1}), (2, 2, 1)),
    "pxy16": (3, "aniso", SevenPt, 16, _conf("plane-xy"), (2, 2, 1)),
}
# the configurations the capture-safety test names
SAFETY = {"2d point": "p2", "line-xy SPIKE": "lxy_dd",
          "line-xy gather": "mlxy_fe", "3d 7-point": "p7",
          "3d 27-point": "fe27", "plane-xy": "c_xy32",
          "x-periodic": "perlx_p"}
# (case, stop) -> (solver settings, x0): the bookkeeping solves
STOPS = {"tol": ({"tol": 1e-8, "max-iter": 30}, "zeros"),
         "max-iter": ({"tol": 1e-30, "max-iter": 3}, "random"),
         "nan": ({"tol": 1e-8, "max-iter": 30}, "nan")}
BOOKS = [("p2", "tol"), ("p2", "max-iter"), ("p2", "nan"),
         ("lxy_dd", "max-iter"), ("pxy16", "max-iter")]
# four cycles of 64² Poisson on (2, 2): held to cedar_tpu's DistSolver2
CONF4 = {"log": [], "solver": {"tol": 1e-30, "max-iter": 4}}


def _solver(name, meshes, conf=None):
    ndim, which, kind, n, c, shape = CASES[name]
    so = (_op2 if ndim == 2 else _op3)(which, n)
    cls = DistSolver2 if ndim == 2 else DistSolver3
    s = cls(so, kind, copy.deepcopy(conf or c), meshes[shape])
    rhs = (gallery.poisson_rhs(n, n, device="cpu") if ndim == 2
           else gallery.poisson3_rhs(n, n, n, device="cpu"))
    return s, so, rhs


def _record(s, b):
    """The solve's iteration of ``s`` recorded with the stand-in; its
    segments, calls, counts and ``held`` tensors."""
    r = graph.CycleGraphs(cycle2 if s._ndim == 2 else cycle3, s.levels,
                          s.kinds, s.settings, Emulated(),
                          periodic=s.periodic, dist=s.dist)
    g = r.graph("solve", s._block(b))
    g.warm()
    comm.reset()
    g.capture()
    return {"segments": len(g.segments), "emulated": r.backend.segments,
            "calls": len(g.calls), "comm": comm.counts(),
            "held": len(g.held), "specs": s.specs, "shapes": s.shapes,
            "spike": sorted(s.dist.spike)}


def _x0(shape, start):
    x0 = torch.tensor(np.random.default_rng(5).standard_normal(shape))
    if start == "zeros":
        x0.zero_()
    elif start == "nan":
        x0[(1,) * len(shape)] = float("nan")
    return x0


def _book(s, b, x0):
    """The eager solve and the solver's graphs' solve (the stand-in) from
    ``x0``: both global x and histories, and what the graph path left."""
    x0_in, b_in = x0.clone(), b.clone()
    x_eager = s.solve(b, x0)
    hist = list(s.history)
    s.graphs.backend = Emulated()
    xb, hist_g = s.graphs.solve(s._block(x0), s._block(b), s.res0)
    x_graph = s._unpad_func(s.dist.gather(xb))
    g = s.graphs.graphs[next(iter(s.graphs.graphs))]
    out = {"x": x_eager, "hist": hist, "x_g": x_graph, "hist_g": hist_g,
           "untouched": torch.equal(x0.nan_to_num(7.0),
                                    x0_in.nan_to_num(7.0))
           and torch.equal(b, b_in),
           "segments": len(g.segments), "calls": len(g.calls),
           "emulated": s.graphs.backend.segments,
           "replays": s.graphs.backend.replays,
           "warmed": s.graphs.backend.warmed}
    # a second solve from zeros replays the same recording and leaves the
    # first result alone
    first = xb.clone()
    xb2, _ = s.graphs.solve(torch.zeros_like(xb), s._block(b), s.res0)
    out["second"] = (torch.equal(xb, first) and xb2.data_ptr()
                     != xb.data_ptr()
                     and s.graphs.backend.warmed == out["warmed"])
    return out


def _world(rank):
    t0 = time.perf_counter()
    meshes = {shape: staged(make_mesh(len(shape), shape=shape,
                                      device="cpu"))
              for shape in ((2, 2), (1, 4), (2, 2, 1))}
    out = {"staged": meshes[(2, 2)].staged}
    for name in CASES:
        s, _, b = _solver(name, meshes)
        out[name] = _record(s, b)
    for name, stop in BOOKS:
        solver, start_ = STOPS[stop]
        conf = copy.deepcopy(CASES[name][4])
        conf["solver"].update(solver)
        s, _, b = _solver(name, meshes, conf)
        out[(name, stop)] = _book(s, b, _x0(tuple(b.shape), start_))

    # vcycle: the graphs' against run_cycle (the eager vcycle)
    s, so, b = _solver("lxy_dd", meshes)
    x0 = _x0(tuple(b.shape), "random")
    x0_in = x0.clone()
    want = s.vcycle(x0, b)
    s.graphs.backend = Emulated()
    got = s._unpad_func(s.dist.gather(s.graphs.vcycle(s._block(x0),
                                                       s._block(b))))
    again = s._unpad_func(s.dist.gather(s.graphs.vcycle(
        s._block(torch.zeros_like(x0)), s._block(b))))
    out["vcycle"] = {"equal": torch.equal(got, want),
                     "untouched": torch.equal(x0, x0_in),
                     "second_differs": not torch.equal(again, got),
                     "graphs": len(s.graphs.graphs)}

    # four cycles of 64² Poisson through the recorded iteration, against
    # cedar_tpu's DistSolver2 (the test process computes it)
    s, _, b = _solver("p2", meshes, CONF4)
    out["p64"] = _book(s, b, torch.zeros_like(b))

    # another hierarchy: a serial solver's on another operator, cut to the
    # blocks; the graphs are dropped and the next solve follows it
    old = s.graphs
    other = Solver2(_op2("dd", 64), FivePt, copy.deepcopy(CONF4))
    s.levels = local_levels(other.levels, s.mesh, s.specs)
    dropped = s.graphs is not old and not s.graphs.graphs
    r = _book(s, b, torch.zeros_like(b))
    r["dropped"] = dropped
    r["x_ser"] = other.solve(b) if rank == 0 else None
    out["relevel"] = r
    out["seconds"] = time.perf_counter() - t0
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's results and cedar_tpu's DistSolver2 solve, computed by
    the test process while the world runs."""
    import jax

    from cedar_tpu import FivePt as JFive
    from cedar_tpu import gallery as jgallery
    from cedar_tpu.parallel import DistSolver2 as JDist2, make_mesh as jmesh

    w = start(_world, 4, timeout=400,
              init_dir=str(tmp_path_factory.mktemp("world")))
    try:
        m = jmesh(2, devices=jax.devices("cpu")[:4], shape=(2, 2))
        js = JDist2(jgallery.poisson(64, 64), JFive, copy.deepcopy(CONF4),
                    m)
        want = np.asarray(js.solve(jgallery.poisson_rhs(64, 64)))
    finally:
        got = w.join()
    return got, want


def _predict(r, name):
    ndim, _, kind, n, conf, shape = CASES[name]
    st = conf["solver"]
    pts = {FivePt: 5, NinePt: 9, SevenPt: 7, TwentySevenPt: 27}[kind]
    return dist_comm.predict(
        r["shapes"], r["specs"], shape, 8,
        st.get("cycle", {}).get("nrelax-pre", 2),
        st.get("cycle", {}).get("nrelax-post", 1),
        {5: 2, 7: 2, 9: 4, 27: 8}[pts], 4 if ndim == 2 else 8,
        st.get("relaxation", "point"),
        st.get("ml-relax", {}).get("enabled", False),
        conf.get("grid", {}).get("periodic"))


def test_world_is_staged(world):
    got, _ = world
    assert all(g["staged"] for g in got)


@pytest.mark.parametrize("what", list(SAFETY))
def test_iteration_is_capture_safe(world, what):
    """The recording ran every segment under the host-sync check (a
    refused op raises in the rank), on every rank, cut at its calls."""
    got, _ = world
    for g in got:
        r = g[SAFETY[what]]
        assert r["calls"] > 0 and r["emulated"] == r["segments"]


@pytest.mark.parametrize("name", list(CASES))
def test_segments_as_predicted(world, name):
    """Rank 0's recorded iteration: one segment a call more, the calls
    those the capture counted and tools/dist_comm.py predicts."""
    got, _ = world
    r = got[0][name]
    c, want = r["comm"], _predict(r, name)
    for k in ("exchanges", "exchange_bytes", "wrap_exchanges", "gathers",
              "line_gathers", "spike_gathers", "plane_gathers",
              "reductions"):
        assert c[k] == want[k], (k, c[k], want[k])
    calls = want["exchanges"] + want["gathers"] + want["reductions"]
    assert r["calls"] == calls
    assert r["segments"] == calls + 1
    assert r["held"] > 0
    assert c["staged_bytes"] > 0
    if name == "lxy_dd":
        assert (0, "x") in r["spike"] and (0, "y") in r["spike"]
    if name.startswith("c_"):
        assert c["plane_gathers"] > 0


@pytest.mark.parametrize("name,stop", BOOKS)
def test_graph_solve_equals_eager_loop(world, name, stop):
    got, _ = world
    for g in got:
        r = g[(name, stop)]
        assert torch.equal(r["x_g"].nan_to_num(7.0), r["x"].nan_to_num(7.0))
        np.testing.assert_array_equal(r["hist_g"], r["hist"])
        assert r["untouched"] and r["second"]
        assert r["warmed"] == 1 and r["emulated"] == r["segments"]
        assert r["replays"] == r["segments"] * len(r["hist"])
    hist = got[0][(name, stop)]["hist"]
    if stop == "tol":
        assert 1 < len(hist) < 30 and hist[-1] < 1e-8
    elif stop == "max-iter":
        assert len(hist) == 3
    else:
        assert len(hist) == 1 and np.isnan(hist[0])


def test_graph_vcycle_equals_run_cycle(world):
    got, _ = world
    for g in got:
        v = g["vcycle"]
        assert v["equal"] and v["untouched"] and v["second_differs"]
        assert v["graphs"] == 1


def test_levels_drop_the_graphs(world):
    got, _ = world
    for g in got:
        r = g["relevel"]
        assert r["dropped"]
        assert torch.equal(r["x_g"], r["x"])
        np.testing.assert_array_equal(r["hist_g"], r["hist"])
    r = got[0]["relevel"]
    # the new hierarchy is diag_diffusion's: its cycles are the serial
    # diag_diffusion solver's, not Poisson's
    assert torch.equal(r["x"], r["x_ser"])


def test_recorded_solve_matches_cedar_tpu(world):
    got, want = world
    r = got[0]["p64"]
    assert torch.equal(r["x_g"], r["x"])
    assert float(np.abs(r["x_g"].numpy() - want).max()) < 1e-11
    assert got[0]["seconds"] < 300


# -- without a world


def test_capture_rule_is_a_table():
    for kind in ("exchange", "all_gather", "all_reduce"):
        assert not comm.capturable(_FakeMesh("gloo"), kind)
        assert comm.capturable(_FakeMesh("nccl"), kind)
        with pytest.raises(NotImplementedError):
            comm.capturable(_FakeMesh("mpi"), kind)


@dataclasses.dataclass
class _FakeMesh:
    backend: str


class _ToyCycle:
    """A cycle module whose iteration doubles x through ``comm.run``
    calls, ``capturable`` or not: x + b, then a call that writes
    ``2 (x + b)`` into a tensor allocated before it, then one more op."""

    def __init__(self, capturable: bool, ncalls: int):
        self.capturable, self.ncalls = capturable, ncalls

    def _call(self, t):
        out = torch.empty_like(t)

        def fn(ins, outs):
            outs[0].copy_(ins[0] * 2)

        comm.run(fn, [t], [out], self.capturable)
        return out

    def run_cycle(self, levels, kinds, x, b, settings, dist=None):
        y = x + b
        for _ in range(self.ncalls):
            y = self._call(y) - 1.0
        return y

    def cycle_residual(self, levels, kinds, x, b, settings, dist=None):
        y = self.run_cycle(levels, kinds, x, b, settings)
        return y, (b - y).norm()


@pytest.mark.parametrize("capturable", [False, True])
def test_recorded_toy_iteration(capturable):
    """A call that a capture may hold stays in its segment (one graph);
    any other cuts the capture, and a replay runs it between the segments
    on the recorded tensors."""
    toy = _ToyCycle(capturable, 3)
    settings = MLSettings()
    b = torch.arange(6, dtype=torch.float64)
    r = graph.CycleGraphs(toy, (), (), settings, Emulated(), dist=object())
    g = r.graph("vcycle", b)
    g.prepare()
    assert isinstance(g, graph.RecordedIteration)
    if capturable:
        assert len(g.segments) == 1 and g.calls == []
        return   # the stand-in records no collective inside a segment
    assert len(g.segments) == 4 and len(g.calls) == 3
    x = torch.ones(6, dtype=torch.float64)
    want = toy.run_cycle((), (), x, b, settings)
    assert torch.equal(r.vcycle(x, b), want)
    assert torch.equal(r.vcycle(want, b), toy.run_cycle((), (), want, b,
                                                         settings))
    assert r.backend.replays == 8


def test_failed_capture_raises():
    """A capture that fails raises, and leaves no segment open."""
    class Broken(_ToyCycle):
        def run_cycle(self, levels, kinds, x, b, settings, dist=None):
            y = self._call(x + b)
            float(y.sum())        # a readback: refused in a segment
            return y

    b = torch.ones(4, dtype=torch.float64)
    backend = Emulated()
    g = graph.CycleGraphs(Broken(False, 1), (), (), MLSettings(), backend,
                          dist=object()).graph("vcycle", b)
    g.warm()
    with pytest.raises(AssertionError, match="host-syncing"):
        g.capture()
    assert not g._open and g.graph is None
