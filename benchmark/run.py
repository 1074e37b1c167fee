"""Run one cell of the benchmark of ``cedar_tpu_torch`` on the card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with as many CUDA devices as the
cell asks for.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, the device's busy and window seconds
and the trace's breakdown.  Standard error ends with each number that the
correctness check compared, beside its limit; standard output ends with
the result, one JSON object.

Exits 2 without a result when CUDA is unavailable or has fewer devices
than the cell asks for (the run never falls back to the CPU), and 3 when
a module of JAX or of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _finite(v):
    """A JSON number, or None for NaN and infinities."""
    return v if not isinstance(v, float) or math.isfinite(v) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package were loaded: "
              f"{', '.join(loaded)}", file=sys.stderr)
        return 3
    dev = result["device"]
    print(f"{cell.name} seed {args.seed}: {result['attempted']} solves, "
          f"{result['failed']} failed; {dev['kind']} x{dev['count']}, "
          f"power limit {dev.get('power_limit', 'not read')}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result["checks"] = {k: {"value": _finite(c["value"]),
                            "limit": c["limit"]}
                        for k, c in result["checks"].items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
