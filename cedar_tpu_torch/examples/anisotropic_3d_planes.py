"""Plane relaxation on a plane-aligned anisotropic 3D problem
(reference: test/3d/test_planes.cc + config plane-config).

With dz << dx, dy point relaxation stalls; zebra xy-plane relaxation
(each plane smoothed by an embedded batched 2D BoxMG cycle) restores
textbook convergence.  The counterpart of cedar_tpu's
``examples/anisotropic_3d_planes.py``, in float32.
Run:  python -m cedar_tpu_torch.examples.anisotropic_3d_planes [n]
      [--device D]
"""

from __future__ import annotations

import argparse

import torch

from cedar_tpu_torch import SevenPt, Solver3, gallery
from cedar_tpu_torch.config import Config


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=32)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    n, dev = args.n, args.device

    so = gallery.diag_diffusion3(n, n, n, 1.0, 1.0, 1e-4,
                                 dtype=torch.float32, device=dev)
    b = gallery.poisson3_rhs(n, n, n, dtype=torch.float32, device=dev)
    # NB: float32 residual evaluation floors around 1e-4 relative at this
    # size (catastrophic cancellation in b - A x); the gate reflects that.
    bmg = Solver3(so, SevenPt, Config({
        "solver": {"relaxation": "plane-xy", "tol": 5e-4, "max-iter": 20},
        "plane-config": {"solver": {"relaxation": "line-xy",
                                    "max-iter": 1}},
    }))
    bmg.solve(b)
    out = [f"converged in {len(bmg.history)} cycles "
           f"(first-cycle reduction {bmg.history[0]:.2e})", "Finished Test"]
    for line in out:
        print(line)
    return out


if __name__ == "__main__":
    main()
