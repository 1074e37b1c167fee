"""One cell of ``BENCHMARK.json``, run end to end.

A cell names a configuration (``configs/<name>.json``, through the
``file`` of its entry in ``configs``) and a traffic mix
(``traffic/<name>.json``); each of its metrics is read by
``metrics/<name>.py``.  All of them are found by name, so a new cell,
mix, configuration or metric is new files and entries, not an edit here.

A run (:func:`run`):

1. set-up: the operator made on the device by the configuration's plain
   reference (``reference/<operator>.py``); the port's solver over it (its
   setup); the solve graph's warm-up and capture; the mix's warm solves,
   on right-hand sides that the window never sends;
2. the window: the mix's loop (:data:`MIX` lists every key of a mix and
   the values that the generator implements; a mix with another key or
   value is refused before anything runs): a closed loop of one caller,
   each solve on a new right-hand side made on the device from
   ``(seed, index)`` just before the call, from ``x0 = 0`` to the
   configuration's tolerance, timed from the call until its ``x`` is ready
   on the device; with ``--trace 1`` the profiler then records
   ``trace_solves`` more solves, after the window's close;
3. after the window: the solver freed, and a sample of the window's
   answers, drawn from the seed, judged against the reference
   (:mod:`benchmark.judge`).  The device's peak memory leaves out the
   answers kept for that check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import record_function

from benchmark import judge, profile_reader, reference

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC = ROOT / "BENCHMARK.json"

#: top-level module names that no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "cedar_tpu")

#: every key of a traffic mix, with the values that the generator
#: implements (None: any whole number of at least 0, or, for ``name`` and
#: ``why``, any text)
MIX = {
    "name": None, "why": None,
    #: one caller that sends its next solve when the last has returned
    "loop": ("closed",),
    "clients": (1,),
    #: i.i.d. standard normal values ...
    "rhs": ("normal",),
    #: ... times the product of the mesh widths, as the gallery scales
    #: its sources
    "rhs_scale": ("mesh_widths",),
    #: every solve starts from zero
    "x0": ("zero",),
    #: solves of set-up, on right-hand sides that the window never sends
    "warm_solves": None,
    #: the answers kept for the check: at most this many, of at most this
    #: many bytes together
    "check_solves": None, "check_bytes": None,
    #: the window's first solves that a ``--trace 1`` run profiles
    "trace_solves": None,
}


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads``, with its configuration, its mix and the
    metric entries that apply to it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def check_mix(mix: dict) -> dict:
    """``mix`` if the generator implements every key and value of it;
    raises ValueError naming the first that it does not."""
    for key in sorted(set(MIX) | set(mix)):
        if key not in MIX:
            raise ValueError(f"traffic {mix.get('name')!r}: no key {key!r} "
                             f"in a mix (the keys: {', '.join(MIX)})")
        if key not in mix:
            raise ValueError(f"traffic {mix.get('name')!r} lacks {key!r}")
        value, allowed = mix[key], MIX[key]
        if key in ("name", "why"):
            ok = isinstance(value, str) and value
        elif allowed is None:
            ok = isinstance(value, int) and not isinstance(value, bool) \
                and value >= 0
        else:
            ok = value in allowed
        if not ok:
            raise ValueError(
                f"traffic {mix.get('name')!r}: {key} = {value!r} is not "
                f"implemented (the generator takes "
                f"{'a whole number >= 0' if allowed is None else allowed})")
    return mix


def load_cell(name: str, spec_path: Path = SPEC) -> Cell:
    """The cell ``name`` of the benchmark's specification."""
    spec = json.loads(Path(spec_path).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {spec_path} "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = check_mix(json.loads(
        (BENCH / "traffic" / f"{w['traffic']}.json").read_text()))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, name)])


def load_metric(name: str):
    """The reader module of the metric ``name``: ``metrics/<name>.py``,
    where each ``.`` of the name is a ``/`` (``dispatch_ms.train``:
    ``metrics/dispatch_ms/train.py``)."""
    return importlib.import_module(f"benchmark.metrics.{name}")


def stream_seed(seed: int, index) -> int:
    """A 63-bit generator seed for the ``index``-th item drawn from
    ``seed`` (any whole numbers)."""
    digest = hashlib.sha256(f"{int(seed)}:{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Problem:
    """The configuration's operator and right-hand sides, made by its
    plain reference on ``device``."""

    def __init__(self, config: dict, device: torch.device):
        self.config = config
        self.ref = reference.load(config["operator"])
        self.grid = tuple(int(n) for n in config["grid"])
        self.dtype = getattr(torch, config["dtype"])
        self.device = device
        self.scale = self.ref.rhs_scale(self.grid)

    def operator(self, dtype=None) -> torch.Tensor:
        return self.ref.build(self.config["coefficients"], self.grid,
                              self.device, dtype or self.dtype)

    def rhs(self, seed: int, index) -> torch.Tensor:
        """The right-hand side ``index`` of ``seed``: i.i.d. standard normal
        values times the product of the mesh widths, in the configuration's
        precision, made on the device."""
        g = torch.Generator(device=self.device)
        g.manual_seed(stream_seed(seed, index))
        b = torch.randn(self.grid, generator=g, device=self.device,
                        dtype=self.dtype)
        return b.mul_(self.scale)


class Session:
    """The port's solver over the configuration's operator, in ``dtype``
    (default: the configuration's precision; another one only for the
    control of :mod:`benchmark.calibrate`)."""

    def __init__(self, problem: Problem, dtype=None):
        import cedar_tpu_torch as ct
        from cedar_tpu_torch.core.types import StencilKind

        config = problem.config
        self.problem = problem
        self.dtype = dtype or problem.dtype
        self.tol = float(config["solver"]["solver"]["tol"])
        kind = StencilKind(config["stencil"])
        cls = ct.Solver2 if kind.ndim == 2 else ct.Solver3
        so = problem.operator(self.dtype)
        self.solver = cls(so, kind, ct.Config(json.loads(json.dumps(
            config["solver"]))))
        self.setup_s = self.solver.timelog.ltimes[0]["setup"]

    def prepare(self, b: torch.Tensor) -> None:
        """The solve graph's warm-up and capture (on the card)."""
        if b.is_cuda:
            self.solver.graphs.graph("solve", b.to(self.dtype)).prepare()

    def solve(self, b: torch.Tensor):
        """``(x, history)`` of one solve of ``b`` from zero."""
        x = self.solver.solve(b.to(self.dtype))
        return x, list(self.solver.history)

    def close(self) -> None:
        """Free the solver, its hierarchy and its graphs."""
        self.solver = None
        gc.collect()
        if self.problem.device.type == "cuda":
            torch.cuda.empty_cache()


@dataclasses.dataclass
class Solve:
    seconds: float
    cycles: int
    converged: bool


@dataclasses.dataclass
class Window:
    solves: list
    seconds: float
    #: ``(index, x, history)`` of the solves drawn for the check
    sample: list
    #: the solves profiled after the window's close
    traced: list = dataclasses.field(default_factory=list)
    prof: object = None
    #: the device's peak of allocated bytes, less the answers kept for
    #: the check (None off the card)
    memory_peak_bytes: int | None = None


def _allocated_peak(device: torch.device, held: int, peak):
    """The device's peak of allocated bytes since its last reset, less the
    ``held`` bytes of the answers kept for the check, against ``peak``;
    then a new reset."""
    if device.type != "cuda":
        return None
    out = max(peak or 0, torch.cuda.max_memory_allocated(device) - held)
    torch.cuda.reset_peak_memory_stats(device)
    return out


def run_window(session: Session, seed: int, seconds: float,
               sample_size: int, trace_solves: int = 0,
               max_solves: int | None = None) -> Window:
    """Solves in a closed loop until ``seconds`` have passed (or
    ``max_solves`` are done); the last one started before the close ends
    the window.  Then, with ``trace_solves``, that many more solves under
    the profiler: after the window, because once the profiler has run,
    CUPTI slows every later launch of a graph of thousands of kernels.
    Keeps a sample of ``sample_size`` answers drawn from the seed
    (reservoir sampling) out of all of them.

    The device's peak memory is read between solves, with the bytes of
    the answers kept at the time left out: they are the check's, not the
    program's."""
    problem = session.problem
    device = problem.device
    rng = random.Random(stream_seed(seed, "sample"))
    out = Window(solves=[], seconds=0.0, sample=[])
    # set-up's peak (nothing kept yet)
    out.memory_peak_bytes = _allocated_peak(device, 0, None)

    def one(i: int, solves: list) -> None:
        with record_function("bench.make_b"):
            b = problem.rhs(seed, i)
            sync(device)
        with record_function("bench.solve"):
            t = time.perf_counter()
            x, hist = session.solve(b)
            sync(device)
            dt = time.perf_counter() - t
        solves.append(Solve(dt, len(hist), bool(hist[-1] < session.tol)))
        del b
        held = sum(k.nbytes for _, k, _ in out.sample)
        out.memory_peak_bytes = _allocated_peak(device, held,
                                                out.memory_peak_bytes)
        if len(out.sample) < sample_size:
            out.sample.append((i, x, hist))
        else:
            j = rng.randrange(i + 1)
            if j < sample_size:
                out.sample[j] = (i, x, hist)

    sync(device)
    start = time.perf_counter()
    deadline = start + seconds
    while time.perf_counter() < deadline and (max_solves is None
                                              or len(out.solves)
                                              < max_solves):
        one(len(out.solves), out.solves)
    out.seconds = time.perf_counter() - start
    if trace_solves:
        out.prof = profile_reader.profiler(device)
        out.prof.start()
        for _ in range(trace_solves):
            one(len(out.solves) + len(out.traced), out.traced)
        out.prof.stop()
    return out


def sample_size(traffic: dict, problem: Problem) -> int:
    """How many answers a run keeps for the check: ``check_solves``, at
    most ``check_bytes`` of them, at least one."""
    nbytes = problem.dtype.itemsize
    for n in problem.grid:
        nbytes *= n
    return max(1, min(int(traffic["check_solves"]),
                      int(traffic["check_bytes"]) // nbytes))


@dataclasses.dataclass
class RunRecord:
    """What a metric reader reads (``metrics/<name>.py``: ``read(run)``)."""

    cell: Cell
    device: dict
    setup_s: float
    #: the benchmark's own spans of set-up, seconds, by name ("start",
    #: "solver", "capture", "warm")
    spans: dict
    solver_setup_s: float
    solves: list
    window_s: float
    #: the solves that the profiler recorded, after the window
    traced: list
    #: :class:`benchmark.profile_reader.Trace` of a ``--trace 1`` run
    trace: object = None


def device_info(device: torch.device, chips: int, peak) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": peak}
    return {"platform": device.type, "kind": device.type, "count": 1,
            "memory_peak_bytes": None}


def power_limit(device: torch.device) -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


@contextlib.contextmanager
def span(spans: dict, name: str, device: torch.device):
    """A synchronised span of the benchmark, seconds into ``spans``."""
    sync(device)
    t = time.perf_counter()
    yield
    sync(device)
    spans[name] = time.perf_counter() - t


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole (``cedar_tpu_torch`` is not
    ``cedar_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t0: float) -> dict:
    """One run of ``cell`` on ``device``; returns the result (the keys of
    the result line, ``checks`` last).  ``t0``: the process's start on
    ``time.perf_counter``'s clock."""
    traffic = cell.traffic
    # the process's start, its imports and the device's context
    spans = {"start": time.perf_counter() - t0}
    problem = Problem(cell.config, device)
    with span(spans, "solver", device):
        session = Session(problem)
    b = problem.rhs(seed, "warm-0")
    with span(spans, "capture", device):
        session.prepare(b)
    if device.type != "cuda":
        del spans["capture"]
    with span(spans, "warm", device):
        for i in range(int(traffic["warm_solves"])):
            session.solve(problem.rhs(seed, f"warm-{i}"))
        del b
    setup_s = time.perf_counter() - t0
    print(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in spans.items()), file=sys.stderr)

    win = run_window(session, seed, seconds, sample_size(traffic, problem),
                     trace_solves=int(traffic["trace_solves"]) if trace
                     else 0)
    dev = device_info(device, cell.chips, win.memory_peak_bytes)
    solver_setup_s = session.setup_s
    session.close()
    checks, bad = judge.judge(problem, seed, win.sample, cell.config)
    win.sample = None
    unconverged = [i for i, s in enumerate(win.solves + win.traced)
                   if not s.converged]
    checks = {"unconverged": {"value": len(unconverged), "limit": 0},
              **checks}

    record = RunRecord(cell=cell, device=dev, setup_s=setup_s, spans=spans,
                       solver_setup_s=solver_setup_s, solves=win.solves,
                       window_s=win.seconds, traced=win.traced)
    result = {}
    if trace:
        record.trace = profile_reader.read(win.prof)
        win.prof = None
        print(f"trace of {len(win.traced)} solves: events "
              f"{record.trace.counts}, "
              f"{len(record.trace.graph_launches)} graph launches",
              file=sys.stderr)
        dev["busy_s"] = record.trace.busy_s()
        dev["window_s"] = record.trace.window_s()
        dev["power_limit"] = power_limit(device)
        result["breakdown"] = record.trace.breakdown()
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_metric(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = bool(win.solves) and judge.passed(checks)
    return {"correct": correct,
            "attempted": len(win.solves) + len(win.traced),
            "failed": len(set(unconverged) | set(bad)), "metrics": metrics,
            "device": dev, **result, "checks": checks}
