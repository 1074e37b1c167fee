"""2D problem galleries (reference: src/2d/gallery.cc).

PyTorch counterpart of the 2D half of :mod:`cedar_tpu.gallery`.  Arrays are
built in numpy exactly as the JAX package builds them, then cast, so both
packages get identical values.  Every function takes ``dtype`` (default
float64) and ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from cedar_tpu_torch.core.types import Dir2


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype or torch.float64, device=device)


def poisson(nx: int, ny: int, dtype=None, device=None) -> torch.Tensor:
    """5-point Poisson, h²-scaled (reference: 2d/gallery.cc:7-39)."""
    return diag_diffusion(nx, ny, 1.0, 1.0, dtype, device)


def diag_diffusion(nx: int, ny: int, dx: float, dy: float, dtype=None,
                   device=None) -> torch.Tensor:
    """Anisotropic diffusion -(dx u_xx + dy u_yy) (2d/gallery.cc:42-73)."""
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    xh = hy / hx
    yh = hx / hy
    so = np.zeros((3, nx, ny))
    so[Dir2.S, :, 1:] = dy * yh
    so[Dir2.W, 1:, :] = dx * xh
    so[Dir2.O] = 2 * dx * xh + 2 * dy * yh
    return _tensor(so, dtype, device)


def fe(nx: int, ny: int, dtype=None, device=None) -> torch.Tensor:
    """9-point finite-element Laplacian (reference: 2d/gallery.cc:77-110)."""
    so = np.zeros((5, nx, ny))
    so[Dir2.S, :, 1:] = 1.0
    so[Dir2.W, 1:, :] = 1.0
    so[Dir2.SW, 1:, 1:] = 1.0
    so[Dir2.NW, 1:, 1:] = 1.0
    so[Dir2.O] = 8.0
    return _tensor(so, dtype, device)


def _grid(nx: int, ny: int):
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    x = (np.arange(nx) + 1) * hx
    y = (np.arange(ny) + 1) * hy
    xx, yy = np.meshgrid(x, y, indexing="ij")
    return hx, hy, xx, yy


def poisson_rhs(nx: int, ny: int, dtype=None, device=None) -> torch.Tensor:
    """RHS 8π²·sin(2πx)sin(2πy)·hx·hy (examples/basic-2d-ser/poisson.cc)."""
    hx, hy, xx, yy = _grid(nx, ny)
    b = 8 * np.pi**2 * np.sin(2 * np.pi * xx) * np.sin(2 * np.pi * yy)
    return _tensor(b * hx * hy, dtype, device)


def poisson_solution(nx: int, ny: int, dtype=None,
                     device=None) -> torch.Tensor:
    """Exact solution sin(2πx)sin(2πy) at interior points."""
    _, _, xx, yy = _grid(nx, ny)
    return _tensor(np.sin(2 * np.pi * xx) * np.sin(2 * np.pi * yy), dtype,
                   device)
