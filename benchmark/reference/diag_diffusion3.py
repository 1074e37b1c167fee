"""Cedar's 3D diffusion operator ``-(dx u_xx + dy u_yy + dz u_zz)``,
7-point, h²-scaled (upstream ``src/3d/gallery.cc`` ``diag_diffusion``),
on an ``nx × ny × nz`` interior grid with Dirichlet boundaries.

Stencil planes ``(4, nx, ny, nz)``: ``P`` the diagonal, ``PW``, ``PS``
and ``B`` the couplings to ``(i-1, j, k)``, ``(i, j-1, k)`` and
``(i, j, k-1)``, stored positive (``A = diag - offdiag``); the others are
those of the neighbour.
"""

from __future__ import annotations

import torch

P, PW, PS, B = 0, 1, 2, 3


def _widths(grid):
    return tuple(1.0 / (n + 1) for n in grid)


def build(coefficients: dict, grid, device, dtype) -> torch.Tensor:
    """The stencil ``(4, nx, ny, nz)``, computed as the gallery computes it
    (in double precision on the host, then stored in ``dtype``)."""
    nx, ny, nz = grid
    hx, hy, hz = _widths(grid)
    dx, dy, dz = (float(coefficients[k]) for k in ("dx", "dy", "dz"))
    xh, yh, zh = hy * hz / hx, hx * hz / hy, hx * hy / hz
    so = torch.zeros((4, nx, ny, nz), dtype=dtype, device=device)
    so[PW, 1:, :, :] = dx * xh
    so[PS, :, 1:, :] = dy * yh
    so[B, :, :, 1:] = dz * zh
    so[P] = 2 * (dx * xh + dy * yh + dz * zh)
    return so


def apply(so: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A x``."""
    y = so[P] * x
    y[1:] -= so[PW, 1:] * x[:-1]
    y[:-1] -= so[PW, 1:] * x[1:]
    y[:, 1:] -= so[PS, :, 1:] * x[:, :-1]
    y[:, :-1] -= so[PS, :, 1:] * x[:, 1:]
    y[:, :, 1:] -= so[B, :, :, 1:] * x[:, :, :-1]
    y[:, :, :-1] -= so[B, :, :, 1:] * x[:, :, 1:]
    return y


def rhs_scale(grid) -> float:
    hx, hy, hz = _widths(grid)
    return hx * hy * hz
