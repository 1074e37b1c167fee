"""``correct``: sound runs pass; the control (the port's float32 path in
place of the float64 one) and the faults of the timed path fail.  The
runs drive the whole harness past its look for a card, on the CPU (the
port's plain versions) and, marked ``card``, on the card."""

import pytest
import torch

from benchmark import harness, judge
from benchmark.tests.helpers import TINY, run_tiny, tiny_cell
from cedar_tpu_torch.solver import cycle2, cycle3, solver2, solver3

CELLS = sorted(TINY)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == {"unconverged", "residual", "history_gap"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_sound_trace_run_is_correct(cell):
    out = run_tiny(cell, trace=True)
    assert out["correct"], out["checks"]
    assert "cycles_per_solve" in out["metrics"]
    assert "breakdown" in out


def control(cell: str, device, seeds=(1, 2, 3), solves=2):
    """The control's checks on ``seeds``: the port in float32."""
    c = tiny_cell(cell)
    problem = harness.Problem(c.config, device)
    session = harness.Session(problem, torch.float32)
    out = []
    for seed in seeds:
        win = harness.run_window(session, seed, 1e9, solves,
                                 max_solves=solves)
        checks, bad = judge.judge(problem, seed, win.sample, c.config)
        out.append((checks, bad, win))
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    for checks, bad, win in control(cell, torch.device("cpu")):
        assert not judge.passed(checks)
        assert checks["residual"]["value"] > checks["residual"]["limit"]
        assert bad


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, card):
    for checks, bad, win in control(cell, card):
        assert not judge.passed(checks) and bad


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_on_the_card(cell, card):
    out = run_tiny(cell, device=card, trace=True)
    assert out["correct"], out["checks"]
    assert "cycle_ms" in out["metrics"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_memory_peak_leaves_out_the_kept_answers(cell, card):
    """The peak is the same whether the window keeps one answer for the
    check or all eight (the allocator rounds each block up to 512 bytes,
    which the kept answers' own bytes leave out)."""
    c = tiny_cell(cell)
    problem = harness.Problem(c.config, card)
    session = harness.Session(problem)
    x, _ = session.solve(problem.rhs(0, "warm-0"))
    peaks = []
    for keep in (1, 8, 1):
        # the last window's answers are freed: start its successor's peak
        torch.cuda.reset_peak_memory_stats(card)
        peaks.append(harness.run_window(session, 5, 1e9, keep, max_solves=8)
                     .memory_peak_bytes)
    assert peaks[0] > 0
    assert max(peaks) - min(peaks) <= 8 * 512 < 7 * x.nbytes


def _cycle_module(cell):
    return cycle2 if cell.startswith("poisson2d") else cycle3


def _solver_class(cell):
    return solver2.Solver2 if cell.startswith("poisson2d") else solver3.Solver3


@pytest.mark.parametrize("cell", CELLS)
def test_fault_state_unchanged(cell, monkeypatch):
    """Each cycle returns its iterate unchanged (with its true norm)."""
    mod = _cycle_module(cell)

    def stuck(levels, kinds, x, b, settings, *args, **kwargs):
        # x stays at x0 = 0, so the residual that the cycle reports is b
        return x, torch.linalg.vector_norm(b)

    monkeypatch.setattr(mod, "cycle_residual", stuck)
    out = run_tiny(cell)
    assert not out["correct"]
    assert out["checks"]["unconverged"]["value"] == out["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_fault_answer_altered(cell, monkeypatch):
    """The answer is altered where it is produced: one value of x off by a
    part in a million of the largest."""
    cls = _solver_class(cell)
    real = cls.solve

    def altered(self, b, x0=None):
        x = real(self, b, x0)
        x.view(-1)[x.numel() // 2] += 1e-6 * float(x.abs().max())
        return x

    monkeypatch.setattr(cls, "solve", altered)
    out = run_tiny(cell)
    assert not out["correct"]
    assert out["checks"]["residual"]["value"] > 1e-8
    assert out["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_fault_history_altered(cell, monkeypatch):
    """The solve loop reports a history that its answer does not have."""
    cls = _solver_class(cell)
    real = cls.solve

    def misreported(self, b, x0=None):
        x = real(self, b, x0)
        self.history = [h * 0.5 for h in self.history]
        return x

    monkeypatch.setattr(cls, "solve", misreported)
    out = run_tiny(cell)
    assert not out["correct"]
    assert out["checks"]["history_gap"]["value"] > 0.1


def test_fault_half_the_planes_left_out(monkeypatch):
    """Plane relaxation smooths the first half of each batch of planes
    and leaves the rest as they were."""
    real = cycle2.run_cycle

    def half(levels, kinds, x, b, settings, *args, **kwargs):
        before = x.clone()
        out = real(levels, kinds, x, b, settings, *args, **kwargs).clone()
        if out.dim() == 3:   # a batch of planes
            out[out.shape[0] // 2:] = before[out.shape[0] // 2:]
        return out

    monkeypatch.setattr(cycle2, "run_cycle", half)
    out = run_tiny("planexy-128.rhs")
    assert not out["correct"]
