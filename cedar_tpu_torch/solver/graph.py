"""One captured CUDA graph per cycle: the port's compiled solve.

The JAX package compiles its whole solve and its single cycle
(``jax.jit`` of ``_solve_impl`` and ``_cycle_impl``,
cedar_tpu/solver/solver2.py:311-312, solver3.py:294-295); its solve runs
every cycle, the convergence norm and the history inside one XLA program,
under ``lax.while_loop``.  Here one iteration of that loop, the cycle and
its norm (:func:`cedar_tpu_torch.solver.cycle2.cycle_residual` or
``cycle3``'s), is captured once as a CUDA graph over static buffers and
replayed once a cycle; the host reads the norm back after each replay,
the loop's ``cond`` (:func:`iterate`).  A solver's ``vcycle`` replays a
graph of ``run_cycle`` of its own.

* :class:`CycleGraphs` keeps a solver's graphs, one per use ("solve",
  "vcycle") and per shape, dtype and device of ``b``, in one memory pool.
  A graph reads and writes its static ``x``, ``b`` (and ``norm``): the
  caller's tensors are copied in, and a clone of ``x`` is handed back, so
  that a later solve cannot overwrite an earlier result.
* Before its capture, a graph runs the same iteration once eagerly on
  scratch copies of its buffers, on the capture's side stream: that is
  where the kernels are built and their libraries loaded, CUDA loads the
  kernels' modules, cuBLAS makes its handle and workspace, and the launch
  plans are computed and cached, all outside the capture.
* The hierarchy's tensors (the levels' stencils, interpolation weights,
  inverses) are captured by address.  A solver that is given another
  hierarchy (its ``levels`` assigned) makes a new :class:`CycleGraphs`
  over it, which captures anew; the old one, its graphs and its memory
  pool are dropped.
* The kernel wrappers' launch counters are Python integers: they count at
  capture (and in the warm-up), never at a replay.

A distributed solver's iteration (cedar_tpu compiles its distributed
solve and cycle the same way, cedar_tpu/parallel/dist.py:289-290) is a
:class:`RecordedIteration`: an ordered list of captured segments, with
the communication calls that a capture may not hold between them
(:mod:`cedar_tpu_torch.parallel.comm`, whose :func:`~cedar_tpu_torch.
parallel.comm.run` hands each call to the recording).  Under NCCL every
call is captured and the list is one graph; under gloo (each message
staged through the host) the capture is cut at every call, and a replay
runs each call eagerly between its segments, on the tensors recorded.

On the card ``solve`` and ``vcycle`` always replay a graph; a capture or a
replay that fails raises.  The CPU runs the same iteration eagerly
(:func:`iterate` over ``cycle_residual``), the plain version of the
graph.  :class:`CudaGraphs` is the one place that touches
``torch.cuda.CUDAGraph``; a stand-in with its methods (``warm``,
``capture``, ``replay``; ``capturing``, ``begin`` and ``end`` for a
recorded iteration) runs the same bookkeeping on the CPU.
"""

from __future__ import annotations

import contextlib
import warnings
import weakref

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import _disable_current_modes

from cedar_tpu_torch.settings import MLSettings


def iterate(step, res0: float, settings: MLSettings) -> list[float]:
    """The solve loop (reference: multilevel.h:278-298): ``step()`` runs
    one iteration and returns ``‖b - A x‖₂`` as a 0-d tensor, read back
    once a cycle; stops below ``tol``, on NaN (like the JAX loop), or
    after ``max-iter`` cycles.  Returns the relative norms."""
    hist = []
    while len(hist) < settings.maxiter:
        rel = float(step()) / res0   # the one readback of the cycle
        hist.append(rel)
        if not rel >= settings.tol:   # stops on NaN, like the JAX loop
            break
    return hist


class CudaGraphs:
    """Capture and replay on the card: a side stream for the warm-up and
    the captures, one memory pool for all of a solver's graphs
    (``torch.cuda.graph_pool_handle``), torch's default capture mode."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def warm(self, fn) -> None:
        """Run ``fn`` eagerly on the side stream and wait for it."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            fn()
        cur.wait_stream(self.stream)
        torch.cuda.synchronize(self.device)

    def capture(self, fn) -> torch.cuda.CUDAGraph:
        """``fn`` captured, not run."""
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self.pool, stream=self.stream):
            fn()
        return g

    @contextlib.contextmanager
    def capturing(self):
        """The side stream for a capture in segments (:meth:`begin`,
        :meth:`end`), the card synchronised first as ``torch.cuda.graph``
        does, without its garbage collection and cache release before
        each capture: an iteration staged through the host has a segment
        a call."""
        torch.cuda.synchronize(self.device)
        with torch.cuda.stream(self.stream):
            yield
        torch.cuda.synchronize(self.device)

    def begin(self) -> None:
        """Open a segment's capture on the current (side) stream, in the
        solver's pool."""
        self._open = torch.cuda.CUDAGraph()
        self._open.capture_begin(pool=self.pool)

    def end(self) -> torch.cuda.CUDAGraph:
        """Close the open segment's capture; returns its graph.  A segment
        between two calls may hold no kernel: its graph is empty."""
        g, self._open = self._open, None
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            g.capture_end()
        return g

    @staticmethod
    def replay(g: torch.cuda.CUDAGraph) -> None:
        """Launch ``g`` on the current stream."""
        g.replay()


class CycleGraph:
    """One captured iteration over static buffers ``x``, ``b`` and
    ``norm``: ``what`` "solve" (the cycle and ``‖b - A x‖₂``,
    ``cycle.cycle_residual``) or "vcycle" (the cycle alone,
    ``cycle.run_cycle``) over the hierarchy ``levels``, captured by
    ``backend``.

    :meth:`warm` and :meth:`capture` run once, in that order (a caller
    that counts the captured launches resets the counters between them);
    :meth:`replay` runs them first where they have not run."""

    def __init__(self, backend, what: str, cycle, levels, kinds,
                 settings: MLSettings, b: torch.Tensor, cycle_kw=None):
        if what not in ("solve", "vcycle"):
            raise ValueError(f"a cycle graph is 'solve' or 'vcycle', not "
                             f"{what!r}")
        self.backend, self.what, self.cycle = backend, what, cycle
        self.levels, self.kinds, self.settings = levels, kinds, settings
        self.cycle_kw = cycle_kw or {}
        self.x = torch.zeros_like(b)
        self.b = torch.zeros_like(b)
        self.norm = b.new_zeros(())
        self.graph = None
        self._warmed = False

    def _step(self, x: torch.Tensor, b: torch.Tensor,
              norm: torch.Tensor) -> None:
        """One iteration on the buffers given: ``x`` becomes the new
        iterate, ``norm`` its residual norm ("solve")."""
        args = (self.levels, self.kinds, x, b, self.settings)
        if self.what == "solve":
            x_new, rnorm = self.cycle.cycle_residual(*args, **self.cycle_kw)
            norm.copy_(rnorm)
        else:
            x_new = self.cycle.run_cycle(*args, **self.cycle_kw)
        x.copy_(x_new)

    def warm(self) -> None:
        """The iteration once, eagerly, on scratch copies of the buffers."""
        x, b, norm = self.x.clone(), self.b.clone(), self.norm.clone()
        self.backend.warm(lambda: self._step(x, b, norm))
        self._warmed = True

    def capture(self) -> None:
        """The iteration captured over the static buffers."""
        if not self._warmed:
            raise RuntimeError("warm the iteration before capturing it")
        self.graph = self.backend.capture(
            lambda: self._step(self.x, self.b, self.norm))

    def prepare(self) -> None:
        """:meth:`warm` and :meth:`capture` where they have not run."""
        if self.graph is None:
            self.warm()
            self.capture()

    def replay(self) -> torch.Tensor:
        """One iteration; returns the static ``norm`` (no readback)."""
        self.prepare()
        self.backend.replay(self.graph)
        return self.norm


class _Live(TorchFunctionMode):
    """Weak references to the tensors that the torch calls inside return,
    taken (those still alive) by :meth:`take`.  A function mode: the
    first dispatch mode of a process imports torch's symbolic machinery,
    seconds on a host shared by a world's ranks."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.refs += [weakref.ref(t) for t in pytree.tree_leaves(out)
                      if isinstance(t, torch.Tensor)]
        return out

    def take(self) -> list:
        alive = [t for t in (r() for r in self.refs) if t is not None]
        self.refs = []
        return alive


class RecordedIteration(CycleGraph):
    """A distributed :class:`CycleGraph` (``cycle_kw`` holds ``dist``):
    the iteration captured as ``segments``, cut at each communication
    call that a capture may not hold; ``calls[i]`` runs between
    ``segments[i]`` and ``segments[i + 1]``.  Under NCCL it is one
    segment; under gloo one more than the iteration has calls.

    The capture runs the iteration's Python once, with the communication
    handed here (:func:`cedar_tpu_torch.parallel.comm.recording`): a call
    that a capture may hold is captured where it stands; at any other the
    open segment closes, the call runs (on the capture's data, which no
    kernel has computed yet: its values do not matter, only that every
    rank makes the same calls), and the next segment opens, captured
    reading the call's outputs.  A replay walks the list in order: a
    segment, then the next call on its recorded input tensors, writing its
    recorded outputs.  The iteration holds, for as long as it lives, every
    call with its inputs and outputs (``calls``) and every tensor alive at
    a cut (``held``: whatever crosses a segment boundary, found by weak
    references to what the torch calls of the capture return), so that no
    other capture in the pool reuses their memory.  All segments are captured in
    the solver's one pool and replayed in the order of their capture."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.segments, self.calls, self.held = [], [], []
        self._live, self._open = None, False

    def capture(self) -> None:
        """The iteration recorded over the static buffers."""
        from cedar_tpu_torch.parallel import comm

        if not self._warmed:
            raise RuntimeError("warm the iteration before capturing it")
        self.segments, self.calls, self.held = [], [], []
        self._live = _Live()
        with self.backend.capturing(), self._live, comm.recording(self):
            self._begin()
            try:
                self._step(self.x, self.b, self.norm)
            except BaseException:
                if self._open:   # leave the stream out of capture mode
                    self._open = False
                    with contextlib.suppress(Exception):
                        self.backend.end()
                raise
            self._end()
        self._live = None
        self.graph = self.segments

    def _begin(self) -> None:
        self.backend.begin()
        self._open = True

    def _end(self) -> None:
        self._open = False
        self.segments.append(self.backend.end())

    def call(self, fn, inputs: list, outputs: list,
             capturable: bool) -> None:
        """A communication call met in the capture
        (:func:`cedar_tpu_torch.parallel.comm.run`)."""
        if capturable:
            with _disable_current_modes():
                fn(inputs, outputs)
            return
        self._end()
        self.held += self._live.take()
        with _disable_current_modes():
            fn(inputs, outputs)
        self.calls.append((fn, inputs, outputs))
        self._begin()

    def replay(self) -> torch.Tensor:
        """One iteration: each segment, then the call after it; returns
        the static ``norm`` (no readback)."""
        self.prepare()
        for i, seg in enumerate(self.segments):
            self.backend.replay(seg)
            if i < len(self.calls):
                fn, inputs, outputs = self.calls[i]
                fn(inputs, outputs)
        return self.norm


class CycleGraphs:
    """A solver's captured iterations over its hierarchy ``levels``
    (``kinds``, ``settings``; ``cycle`` the cycle module of its dimension,
    :mod:`cycle2` or :mod:`cycle3`; ``periodic``, where given, the periodic
    axes that its cycles take; ``dist``, a distributed solver's
    :class:`~cedar_tpu_torch.parallel.halo.DistContext`, whose iterations
    are :class:`RecordedIteration` s over this rank's blocks).

    ``backend`` does the capturing: by default :class:`CudaGraphs` on the
    device of the first ``b``, made with the first graph."""

    def __init__(self, cycle, levels, kinds, settings: MLSettings,
                 backend=None, periodic=None, dist=None):
        self.cycle, self.levels, self.kinds = cycle, levels, kinds
        self.settings = settings
        self.backend = backend
        self.cycle_kw = {} if periodic is None else {"periodic": periodic}
        if dist is not None:
            self.cycle_kw["dist"] = dist
        self.graphs: dict[tuple, CycleGraph] = {}

    def graph(self, what: str, b: torch.Tensor) -> CycleGraph:
        """The graph of ``what`` for a ``b`` of this shape, dtype and
        device, made (not yet captured) at the first call."""
        key = (what, tuple(b.shape), b.dtype, b.device)
        g = self.graphs.get(key)
        if g is None:
            if self.backend is None:
                self.backend = CudaGraphs(b.device)
            kind = (RecordedIteration if "dist" in self.cycle_kw
                    else CycleGraph)
            g = self.graphs[key] = kind(
                self.backend, what, self.cycle, self.levels, self.kinds,
                self.settings, b, self.cycle_kw)
        return g

    def solve(self, x: torch.Tensor, b: torch.Tensor, res0: float):
        """Cycles from ``x`` until :func:`iterate` stops, one replay a
        cycle; returns ``(x, history)``, ``x`` a new tensor.  ``x`` and
        ``b`` are not modified."""
        g = self.graph("solve", b)
        g.prepare()   # captured before the copy-in: the capture reads no value
        g.x.copy_(x)
        g.b.copy_(b)
        hist = iterate(g.replay, res0, self.settings)
        return g.x.clone(), hist

    def vcycle(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """One cycle from ``x`` as a new tensor; ``x`` and ``b`` are not
        modified."""
        g = self.graph("vcycle", b)
        g.prepare()
        g.x.copy_(x)
        g.b.copy_(b)
        g.replay()
        return g.x.clone()
