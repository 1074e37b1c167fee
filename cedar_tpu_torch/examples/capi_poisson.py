"""Handle-based procedural API demo (reference: the C API,
include/cedar/capi.h used from a host application).

Assembles the 128 x 128 5-point Poisson operator entry by entry through
:mod:`cedar_tpu_torch.capi`, solves in float64 and reports the error
against the analytic solution.  The counterpart of cedar_tpu's
``examples/capi_poisson.py``.
Run:  python -m cedar_tpu_torch.examples.capi_poisson [--device D]
"""

from __future__ import annotations

import argparse

import numpy as np

import cedar_tpu_torch.capi as capi


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    n = 128
    topo = capi.bmg2_topo_create(n, n, device=args.device)
    op = capi.bmg2_operator_create(topo)

    # assemble the 5-point Poisson operator through the entry interface
    h = 1.0 / (n + 1)
    coords, vals = [], []
    for i in range(n):
        for j in range(n):
            coords.append((i, j, capi.BMG2_O))
            vals.append(4.0)
            if i > 0:
                coords.append((i, j, capi.BMG2_W))
                vals.append(1.0)
            if j > 0:
                coords.append((i, j, capi.BMG2_S))
                vals.append(1.0)
    capi.bmg2_operator_set(op, coords, vals)

    xg = (np.arange(n) + 1) * h
    xx, yy = np.meshgrid(xg, xg, indexing="ij")
    b = (8 * np.pi**2 * np.sin(2 * np.pi * xx) * np.sin(2 * np.pi * yy)
         * h * h).astype(np.float64)

    slv = capi.bmg2_solver_create(op, {"solver": {"tol": 1e-8,
                                                  "max-iter": 20}})
    x = np.zeros_like(b)
    capi.bmg2_solver_run(slv, x, b)

    exact = np.sin(2 * np.pi * xx) * np.sin(2 * np.pi * yy)
    out = [f"Solution norm: {np.abs(x - exact).max():g}"]
    print(out[-1])
    capi.bmg2_solver_destroy(slv)
    capi.bmg2_operator_destroy(op)
    out.append("Finished Test")
    print(out[-1])
    return out


if __name__ == "__main__":
    main()
