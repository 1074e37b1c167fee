"""What decides ``correct``: the window's answers against the plain
reference.

Each answer sampled from the window (its ``x`` and the relative residual
norms that the solve loop reported, ``history``) is judged once the
window has closed and the solver is freed.  The reference makes the
operator and the right-hand side again from the configuration and the
seed (nothing that the solver derived) and computes, in float64,

* ``residual``: ``‖b − A x‖₂ / ‖b‖₂``, the relative residual of the
  returned ``x`` (``x0 = 0``, so ``‖b‖₂`` is the initial residual); the
  limit is the configuration's own tolerance;
* ``history_gap``: ``|h − r| / r`` between the last relative norm ``h``
  that the solve loop reported and that residual ``r``; the limit is the
  configuration's ``limits.history_gap``, set from readings
  (``calibrate.py``; ``PERF.md`` gives them).

The harness adds ``unconverged``: the window's solves whose own history
ended at or above the tolerance (stopped by ``max-iter``), limit 0.
"""

from __future__ import annotations

import math

import torch


def relative_residual(ref, so: torch.Tensor, x: torch.Tensor,
                      b: torch.Tensor) -> float:
    """``‖b − A x‖₂ / ‖b‖₂`` in float64 by the reference module ``ref``."""
    x = x.to(torch.float64)
    r = b - ref.apply(so, x)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def judge(problem, seed: int, sample: list, config: dict):
    """``(checks, bad)``: the compared numbers of the ``sample`` of
    ``(index, x, history)`` (each ``{"value", "limit"}``) and the indices
    of the sampled solves whose residual is over the tolerance."""
    ref = problem.ref
    so = problem.operator(torch.float64)
    tol = float(config["solver"]["solver"]["tol"])
    worst_res, worst_gap, bad = 0.0, 0.0, []
    for index, x, hist in sample:
        b = problem.rhs(seed, index).to(torch.float64)
        res = relative_residual(ref, so, x, b)
        gap = abs(hist[-1] - res) / res if res > 0 else math.inf
        if not res <= tol:
            bad.append(index)
        worst_res, worst_gap = _worse(worst_res, res), _worse(worst_gap, gap)
    if not sample:
        worst_res = worst_gap = math.nan
    checks = {
        "residual": {"value": worst_res, "limit": tol},
        "history_gap": {"value": worst_gap,
                        "limit": float(config["limits"]["history_gap"])},
    }
    return checks, bad


def _worse(a: float, b: float) -> float:
    """The larger reading; a NaN is the worst."""
    return a if math.isnan(a) else b if math.isnan(b) else max(a, b)


def passed(checks: dict) -> bool:
    """Every compared number within its limit (NaN is not)."""
    return all(c["value"] <= c["limit"] for c in checks.values())
