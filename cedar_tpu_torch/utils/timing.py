"""Hierarchical solver timers (reference: include/cedar/util/time_log.h).

PyTorch counterpart of :mod:`cedar_tpu.utils.timing`:

* :class:`TimeLog` — host-side phase timers (setup / solve) with the
  reference's per-level bucket structure and `timings.json` output format.
  CUDA work is asynchronous: ``end(label, force=x)`` synchronizes the card
  before it reads the clock (any non-``None`` ``force`` does).
* :func:`scope` — a ``torch.profiler.record_function`` range, so profiler
  traces attribute time to "relaxation"/"restrict"/… like the reference's
  labels.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import torch


def _block() -> None:
    """Wait for queued CUDA work (no-op when CUDA was never used)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class TimeLog:
    """Label → elapsed seconds, bucketed per MG level (time_log.h:21-68)."""

    def __init__(self):
        self.lvl = 0
        self.stacks: list[tuple[str, float]] = []
        self.ltimes: dict[int, dict[str, float]] = defaultdict(
            lambda: defaultdict(float)
        )
        self.counts: dict[int, dict[str, int]] = defaultdict(
            lambda: defaultdict(int)
        )
        self._paused = False

    # -- reference API --------------------------------------------------------
    def begin(self, label: str) -> None:
        if self._paused:
            return
        self.stacks.append((label, time.perf_counter()))

    def end(self, label: str, force=None) -> None:
        if self._paused:
            return
        if force is not None:
            _block()
        name, t0 = self.stacks.pop()
        if name != label:
            raise RuntimeError(f"timer mismatch: {name} != {label}")
        self.ltimes[self.lvl][label] += time.perf_counter() - t0
        self.counts[self.lvl][label] += 1

    def up(self) -> None:
        self.lvl -= 1

    def down(self) -> None:
        self.lvl += 1

    def pause(self) -> None:
        """reference: timer_pause around redistributed solves."""
        self._paused = True

    def play(self) -> None:
        self._paused = False

    @contextlib.contextmanager
    def timing(self, label: str, force_out=False):
        self.begin(label)
        out = []
        try:
            yield out
        finally:
            self.end(label, force=out[0] if (force_out and out) else None)

    # -- reporting -------------------------------------------------------------
    def todict(self) -> dict:
        """The reference's timings.json structure (single-rank: min=max=avg)."""
        out = {}
        for lvl in sorted(self.ltimes):
            blk = {}
            for label, t in sorted(self.ltimes[lvl].items()):
                blk[label] = {
                    "min": t, "max": t, "ratio": 1.0, "avg": t,
                    "count": self.counts[lvl][label],
                }
            out[f"level-{lvl}"] = blk
        return out

    def save(self, fname: str = "timings.json") -> None:
        with open(fname, "w") as f:
            json.dump(self.todict(), f, indent=2)


def scope(name: str):
    """Stage annotation for profiler traces (e.g. 'relaxation')."""
    return torch.profiler.record_function(name)
