"""Cedar's 2D diffusion operator ``-(dx u_xx + dy u_yy)``, 5-point,
h²-scaled (upstream ``src/2d/gallery.cc:42-73``; Poisson is ``dx = dy =
1``, ``gallery.cc:7-39``), on an ``nx × ny`` interior grid with Dirichlet
boundaries.

Stencil planes ``(3, nx, ny)``: ``O`` the diagonal, ``W[i, j]`` the
coupling of ``(i, j)`` to ``(i-1, j)``, ``S[i, j]`` that to ``(i, j-1)``,
both stored positive (``A = diag - offdiag``); the east and north
couplings are the west and south ones of the neighbour.
"""

from __future__ import annotations

import torch

O, W, S = 0, 1, 2


def _widths(grid):
    nx, ny = grid
    return 1.0 / (nx + 1), 1.0 / (ny + 1)


def build(coefficients: dict, grid, device, dtype) -> torch.Tensor:
    """The stencil ``(3, nx, ny)``, computed as the gallery computes it (in
    double precision on the host, then stored in ``dtype``)."""
    nx, ny = grid
    hx, hy = _widths(grid)
    dx, dy = float(coefficients["dx"]), float(coefficients["dy"])
    xh, yh = hy / hx, hx / hy
    so = torch.zeros((3, nx, ny), dtype=dtype, device=device)
    so[S, :, 1:] = dy * yh
    so[W, 1:, :] = dx * xh
    so[O] = 2 * dx * xh + 2 * dy * yh
    return so


def apply(so: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A x``."""
    y = so[O] * x
    y[1:, :] -= so[W, 1:, :] * x[:-1, :]
    y[:-1, :] -= so[W, 1:, :] * x[1:, :]
    y[:, 1:] -= so[S, :, 1:] * x[:, :-1]
    y[:, :-1] -= so[S, :, 1:] * x[:, 1:]
    return y


def rhs_scale(grid) -> float:
    hx, hy = _widths(grid)
    return hx * hy
