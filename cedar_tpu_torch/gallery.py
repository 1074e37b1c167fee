"""2D and 3D problem galleries (reference: src/2d/gallery.cc,
src/3d/gallery.cc).

PyTorch counterpart of :mod:`cedar_tpu.gallery`.  Arrays are built in numpy
exactly as the JAX package builds them, then cast, so both packages get
identical values.  Every function takes ``dtype`` (default float64) and
``device`` (default the card, ``cuda``: the port's entry points run on the
card unless the caller asks for the CPU; without a card the default
raises, as torch does).
"""

from __future__ import annotations

import numpy as np
import torch

from cedar_tpu_torch.core.types import Dir2, Dir3


def default_device(device=None) -> torch.device:
    """The device a gallery array lands on: ``device``, or the card."""
    return torch.device("cuda" if device is None else device)


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype or torch.float64,
                           device=default_device(device))


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


# ---------------------------------------------------------------------------
# 3D
# ---------------------------------------------------------------------------

def poisson3(nx: int, ny: int, nz: int, dtype=None,
             device=None) -> torch.Tensor:
    """7-point Poisson, h²-scaled (reference: 3d/gallery.cc)."""
    return diag_diffusion3(nx, ny, nz, 1.0, 1.0, 1.0, dtype, device)


def diag_diffusion3(nx: int, ny: int, nz: int, dx: float, dy: float,
                    dz: float, dtype=None, device=None) -> torch.Tensor:
    """Anisotropic diffusion -(dx u_xx + dy u_yy + dz u_zz)
    (reference: 3d/gallery.cc diag_diffusion)."""
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    hz = 1.0 / (nz + 1)
    xh = hy * hz / hx
    yh = hx * hz / hy
    zh = hx * hy / hz
    so = np.zeros((4, nx, ny, nz))
    so[Dir3.PW, 1:, :, :] = dx * xh
    so[Dir3.PS, :, 1:, :] = dy * yh
    so[Dir3.B, :, :, 1:] = dz * zh
    so[Dir3.P] = 2 * (dx * xh + dy * yh + dz * zh)
    return _tensor(so, dtype, device)


def _grid3(nx: int, ny: int, nz: int):
    hs = [1.0 / (n + 1) for n in (nx, ny, nz)]
    grids = [(np.arange(n) + 1) * h for n, h in zip((nx, ny, nz), hs)]
    return hs, np.meshgrid(*grids, indexing="ij")


def poisson3_rhs(nx: int, ny: int, nz: int, dtype=None,
                 device=None) -> torch.Tensor:
    """RHS 12π²·sin(2πx)sin(2πy)sin(2πz)·hx·hy·hz (examples/basic-3d-*)."""
    hs, (xx, yy, zz) = _grid3(nx, ny, nz)
    b = (12 * np.pi**2 * np.sin(2 * np.pi * xx) * np.sin(2 * np.pi * yy)
         * np.sin(2 * np.pi * zz))
    return _tensor(b * hs[0] * hs[1] * hs[2], dtype, device)


def poisson3_solution(nx: int, ny: int, nz: int, dtype=None,
                      device=None) -> torch.Tensor:
    """Exact solution sin(2πx)sin(2πy)sin(2πz) at interior points."""
    _, (xx, yy, zz) = _grid3(nx, ny, nz)
    return _tensor(np.sin(2 * np.pi * xx) * np.sin(2 * np.pi * yy)
                   * np.sin(2 * np.pi * zz), dtype, device)


def fe3(nx: int, ny: int, nz: int, dtype=None, device=None) -> torch.Tensor:
    """27-point finite-element operator (reference: 3d/gallery.cc fe)."""
    so = np.zeros((14, nx, ny, nz))
    # same-plane couplings
    so[Dir3.PW, 1:, :, :] = 1.0
    so[Dir3.PS, :, 1:, :] = 1.0
    so[Dir3.PSW, 1:, 1:, :] = 1.0
    so[Dir3.PNW, 1:, 1:, :] = 1.0
    # below-plane couplings
    so[Dir3.B, :, :, 1:] = 1.0
    so[Dir3.BW, 1:, :, 1:] = 1.0
    so[Dir3.BE, 1:, :, 1:] = 1.0
    so[Dir3.BS, :, 1:, 1:] = 1.0
    so[Dir3.BN, :, 1:, 1:] = 1.0
    so[Dir3.BSW, 1:, 1:, 1:] = 1.0
    so[Dir3.BNW, 1:, 1:, 1:] = 1.0
    so[Dir3.BNE, 1:, 1:, 1:] = 1.0
    so[Dir3.BSE, 1:, 1:, 1:] = 1.0
    so[Dir3.P] = 26.0
    return _tensor(so, dtype, device)


# the stored 3D planes whose entries at index 0 of each axis couple across
# it (3d/base_types.h: every plane with a W, S or B in its name reaches one
# point down x, y or z)
_ACROSS3 = (
    (Dir3.PW, Dir3.PSW, Dir3.PNW, Dir3.BW, Dir3.BE, Dir3.BSW, Dir3.BSE,
     Dir3.BNW, Dir3.BNE),
    (Dir3.PS, Dir3.PSW, Dir3.PNW, Dir3.BS, Dir3.BN, Dir3.BSW, Dir3.BSE,
     Dir3.BNW, Dir3.BNE),
    (Dir3.B, Dir3.BW, Dir3.BE, Dir3.BS, Dir3.BN, Dir3.BSW, Dir3.BSE,
     Dir3.BNW, Dir3.BNE),
)


def periodic3(so: torch.Tensor, periodic) -> torch.Tensor:
    """A 3D operator (``poisson3``, ``diag_diffusion3``, ``fe3``) on a grid
    periodic along the axes marked in ``periodic``: on each such axis the
    couplings at index 0 of the planes that couple across it (the entries
    the wrap reads, zero in the Dirichlet operator) copied from index 1,
    axis by axis.  The gallery's interiors are the same at every point, so
    every coupling is kept across the wrap; the diagonal is unchanged.
    Returns a new tensor; with every axis periodic the operator is singular
    (its rows sum to zero: ``solver.definite: false``)."""
    out = so.clone()
    for ax, per in enumerate(periodic):
        if not per:
            continue
        planes = [int(d) for d in _ACROSS3[ax] if int(d) < so.shape[0]]
        dst = [planes] + [slice(None)] * 3
        src = [planes] + [slice(None)] * 3
        dst[1 + ax], src[1 + ax] = 0, 1
        out[tuple(dst)] = out[tuple(src)]
    return out
