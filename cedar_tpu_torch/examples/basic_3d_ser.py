"""3D Poisson solve (reference: examples/basic-3d-ser/poisson.cc).

The 7-point Poisson operator on an n³ grid, solved with BoxMG in float32;
the error against the analytic solution.  The counterpart of cedar_tpu's
``examples/basic_3d_ser.py``.
Run:  python -m cedar_tpu_torch.examples.basic_3d_ser [n] [--device D]
"""

from __future__ import annotations

import argparse

import torch

from cedar_tpu_torch import SevenPt, Solver3, gallery
from cedar_tpu_torch.config import Config


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=64)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    n, dev = args.n, args.device

    so = gallery.poisson3(n, n, n, dtype=torch.float32, device=dev)
    b = gallery.poisson3_rhs(n, n, n, dtype=torch.float32, device=dev)
    bmg = Solver3(so, SevenPt, Config({
        "solver": {"tol": 1e-6, "max-iter": 12},
    }))
    x = bmg.solve(b)
    err = float((x - gallery.poisson3_solution(
        n, n, n, dtype=torch.float32, device=dev)).abs().max())
    out = [f"Solution norm: {err:g}", "Finished Test"]
    for line in out:
        print(line)
    return out


if __name__ == "__main__":
    main()
