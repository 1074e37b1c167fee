"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

The harness profiles a few solves after the window's close (CPU and
CUDA activity; CUPTI sees the kernels inside CUDA graph replays) with its
own spans ``bench.make_b`` and ``bench.solve`` around each right-hand
side and each solve.  :func:`read` keeps, on the profiler's one clock:

* the device's activities: kernels, copies and fills, with the
  correlation id of the host call that launched each;
* the host's CPU ops and runtime calls (``cudaGraphLaunch`` among them);
* the benchmark's spans, whose first start and last end bound the traced
  window.

The device is busy where any activity runs: the union of their
intervals, so that kernels that overlap count once (the repository's
``tools/profile_cycle.py`` sums kernel times, which counts an overlap
twice).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

#: the profiler's activity types that occupy the device
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."


def profiler(device: torch.device):
    """A profiler of the host and, on the card, of the device (not yet
    started)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def union(intervals) -> list:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def clip(intervals, lo: int, hi: int) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def total(intervals) -> int:
    return sum(e - s for s, e in intervals)


@dataclasses.dataclass
class Trace:
    """Events in nanoseconds: ``device`` ``(start, end, name, corr)``,
    ``host`` ``(start, end, name, corr, activity)``, ``spans`` ``(start,
    end, name)``; ``graph_launches`` the correlation ids of the
    ``cudaGraphLaunch`` calls."""

    device: list
    host: list
    spans: list
    graph_launches: set
    counts: dict

    @property
    def window(self) -> tuple:
        if not self.spans:
            return (0, 0)
        return (min(s for s, _, _ in self.spans),
                max(e for _, e, _ in self.spans))

    def busy(self) -> list:
        """The union of the device's activity inside the window."""
        lo, hi = self.window
        return clip(union((s, e) for s, e, _, _ in self.device), lo, hi)

    def busy_s(self) -> float:
        return total(self.busy()) * 1e-9

    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) * 1e-9

    def replay_busy_s(self) -> float | None:
        """Seconds in which the device ran what the graph replays launched
        (the union of those activities), or None where no activity is
        tied to a replay."""
        ivs = [(s, e) for s, e, _, c in self.device
               if c in self.graph_launches]
        if not ivs:
            return None
        return total(union(ivs)) * 1e-9

    def _launcher(self) -> dict:
        """correlation id -> what on the host launched it: the innermost
        CPU op around the runtime call, else the runtime call's name."""
        ops = sorted((s, e, n) for s, e, n, _, a in self.host
                     if a == "cpu_op")
        starts = [s for s, _, _ in ops]
        out = {}
        for s, _, name, corr, act in self.host:
            if act == "cpu_op":
                continue
            label = name
            k = bisect.bisect_right(starts, s) - 1
            for j in range(k, max(k - 64, -1), -1):
                if ops[j][0] <= s <= ops[j][1]:
                    label = ops[j][2]
                    break
            out[corr] = label
        return out

    def gaps(self) -> list:
        """``(seconds, name)`` of each idle interval inside the window,
        named by the benchmark span the host was in and by what launched
        the device work before and after it."""
        busy = self.busy()
        lo, hi = self.window
        launcher = self._launcher()
        ends = sorted((e, c) for _, e, _, c in self.device)
        starts = sorted((s, c) for s, _, _, c in self.device)
        spans = sorted(self.spans)
        out = []
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            i = bisect.bisect_right(ends, (a, float("inf"))) - 1
            j = bisect.bisect_left(starts, (b, -1))
            before = launcher.get(ends[i][1], "start") if i >= 0 else "start"
            after = (launcher.get(starts[j][1], "end") if j < len(starts)
                     else "end")
            where = "outside the spans"
            k = bisect.bisect_right(spans, (a, float("inf"), "")) - 1
            if k >= 0 and spans[k][0] <= a < spans[k][1]:
                where = spans[k][2]
            out.append(((b - a) * 1e-9, f"{where}: {before} -> {after}"))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time (summed by name)
        and the idle time by what the host was doing, ``top`` each."""
        ops = defaultdict(float)
        for s, e, name, _ in self.device:
            ops[name[:160]] += (e - s) * 1e-9
        idle = defaultdict(float)
        count = defaultdict(int)
        for sec, name in self.gaps():
            idle[name] += sec
            count[name] += 1
        return {
            "device_ops": [[n, v] for n, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[f"{n} (x{count[n]})", v] for n, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]],
        }


def read(prof) -> Trace:
    """The :class:`Trace` of a stopped profiler, from its Chrome trace
    (``export_chrome_trace``: the format that stays across PyTorch
    releases), written to a temporary file and read back."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    device, host, spans, launches = [], [], [], set()
    counts = defaultdict(int)
    for e in events:
        if e.get("ph") != "X":
            continue
        act = e.get("cat", "")
        counts[act] += 1
        start = round(float(e["ts"]) * 1e3)
        end = start + round(float(e.get("dur", 0)) * 1e3)
        name = e.get("name", "")
        corr = e.get("args", {}).get("correlation", -1)
        if act in DEVICE_ACTIVITIES:
            device.append((start, end, name, corr))
        elif act == "user_annotation":
            if name.startswith(SPAN_PREFIX):
                spans.append((start, end, name))
        elif act in ("cpu_op", "cuda_runtime", "cuda_driver"):
            host.append((start, end, name, corr, act))
            if "GraphLaunch" in name:
                launches.add(corr)
    return Trace(device=device, host=host, spans=spans,
                 graph_launches=launches, counts=dict(counts))
