"""2D Poisson solve (reference: examples/basic-2d-ser/poisson.cc).

Builds the 5-point Poisson operator on an nx x ny grid, solves with BoxMG
in float32, reports the error against the analytic sin(2pi x) sin(2pi y)
solution and writes the solver's timers to ``timings.json``; the
counterpart of cedar_tpu's ``examples/basic_2d_ser.py``.
Run:  python -m cedar_tpu_torch.examples.basic_2d_ser [nx ny] [--device D]
"""

from __future__ import annotations

import argparse

import torch

from cedar_tpu_torch import FivePt, Solver2, gallery
from cedar_tpu_torch.config import Config


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("nx", nargs="?", type=int, default=400)
    p.add_argument("ny", nargs="?", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    nx = args.nx
    ny = nx if args.ny is None else args.ny
    dev = args.device

    so = gallery.poisson(nx, ny, dtype=torch.float32, device=dev)
    b = gallery.poisson_rhs(nx, ny, dtype=torch.float32, device=dev)

    conf = Config({
        "solver": {
            "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
            "tol": 1e-6, "max-iter": 10,
        },
    })
    bmg = Solver2(so, FivePt, conf)
    x = bmg.solve(b)

    err = float((x - gallery.poisson_solution(
        nx, ny, dtype=torch.float32, device=dev)).abs().max())
    out = [f"Solution norm: {err:g}"]
    print(out[-1])
    bmg.save_timings("timings.json")
    out.append("Finished Test")
    print(out[-1])
    return out


if __name__ == "__main__":
    main()
