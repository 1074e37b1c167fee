"""The readings that the correctness limits of a cell are set from.

    python3 benchmark/calibrate.py --workload NAME [--seeds 12]
        [--first-seed N] [--control-seeds 3] [--solves K] [--out FILE]

In one process on the card: the port in the configuration's precision on
``--seeds`` seeds, then the control, the port's own path one precision
below it (float32 for float64), on ``--control-seeds`` other seeds.  Each
seed runs ``--solves`` solves of the cell's traffic (default: as many as
a run of the cell judges) through the window's own loop and judges every
one of them by :mod:`benchmark.judge`.  Prints each seed's compared
numbers, the lower reading (the largest of the sound runs) and the upper
one (the smallest of the control), and writes them as JSON to ``--out``.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness, judge  # noqa: E402

#: the control's precision: the nearest one below the configuration's
LOWER = {"float64": "float32"}


def readings(problem, session, seed, solves):
    """The compared numbers of ``solves`` solves of ``seed``, every one
    judged."""
    win = harness.run_window(session, seed, math.inf, solves,
                             max_solves=solves)
    checks, bad = judge.judge(problem, seed, win.sample, problem.config)
    out = {name: c["value"] for name, c in checks.items()}
    out["unconverged"] = sum(not s.converged for s in win.solves)
    out["cycles"] = sorted({s.cycles for s in win.solves})
    out["solve_ms"] = 1e3 * win.seconds / len(win.solves)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--solves", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    problem = harness.Problem(cell.config, device)
    solves = args.solves or harness.sample_size(cell.traffic, problem)
    seeds = [args.first_seed + i for i in range(args.seeds)]
    cseeds = [args.first_seed + args.seeds + i
              for i in range(args.control_seeds)]
    report = {"workload": cell.name, "solves": solves,
              "device": torch.cuda.get_device_name(device),
              "power_limit": harness.power_limit(device),
              "program": {}, "control": {}}
    runs = [("program", None, seeds),
            ("control", getattr(torch, LOWER[cell.config["dtype"]]), cseeds)]
    for side, dtype, side_seeds in runs:
        t = time.perf_counter()
        session = harness.Session(problem, dtype)
        b = problem.rhs(0, "warm-0")
        session.prepare(b)
        session.solve(b)
        del b
        print(f"[{side}] {session.dtype} set up in "
              f"{time.perf_counter() - t:.2f} s", flush=True)
        for seed in side_seeds:
            r = readings(problem, session, seed, solves)
            report[side][seed] = r
            print(f"[{side}] seed {seed}: " + ", ".join(
                f"{k} {v!r}" for k, v in r.items()), flush=True)
        session.close()
    for name in ("residual", "history_gap", "unconverged"):
        lower = max(r[name] for r in report["program"].values())
        upper = min(r[name] for r in report["control"].values())
        report.setdefault("summary", {})[name] = {"lower": lower,
                                                  "upper": upper}
        print(f"{name}: lower {lower!r} (the program's largest), upper "
              f"{upper!r} (the control's smallest)")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
