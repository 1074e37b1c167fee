"""The plain references: the gallery's operators, a dense solve, and the
judge's residual."""

import numpy as np
import pytest
import torch

from benchmark import judge, reference
from cedar_tpu_torch import gallery
from cedar_tpu_torch.ops import stencil2, stencil3
from cedar_tpu_torch.core.types import FivePt, SevenPt

CPU = torch.device("cpu")


def _tridiag(n, c):
    return c * (2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1))


def dense2(nx, ny, dx, dy):
    """The 5-point operator as a dense matrix, by Kronecker products (row
    index i * ny + j of point (i, j))."""
    hx, hy = 1 / (nx + 1), 1 / (ny + 1)
    return (np.kron(_tridiag(nx, dx * hy / hx), np.eye(ny))
            + np.kron(np.eye(nx), _tridiag(ny, dy * hx / hy)))


def dense3(nx, ny, nz, dx, dy, dz):
    hx, hy, hz = 1 / (nx + 1), 1 / (ny + 1), 1 / (nz + 1)
    ix, iy, iz = np.eye(nx), np.eye(ny), np.eye(nz)
    return (np.kron(np.kron(_tridiag(nx, dx * hy * hz / hx), iy), iz)
            + np.kron(np.kron(ix, _tridiag(ny, dy * hx * hz / hy)), iz)
            + np.kron(np.kron(ix, iy), _tridiag(nz, dz * hx * hy / hz)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_operators_equal_the_gallery(dtype):
    r2 = reference.load("diag_diffusion2")
    so = r2.build({"dx": 1.0, "dy": 1.0}, (9, 7), CPU, dtype)
    assert torch.equal(so, gallery.poisson(9, 7, dtype=dtype, device=CPU))
    r3 = reference.load("diag_diffusion3")
    so3 = r3.build({"dx": 1.0, "dy": 1.0, "dz": 1e-3}, (6, 5, 7), CPU, dtype)
    assert torch.equal(so3, gallery.diag_diffusion3(
        6, 5, 7, 1.0, 1.0, 1e-3, dtype=dtype, device=CPU))


@pytest.mark.parametrize("grid,coef", [((9, 7), {"dx": 1.0, "dy": 1.0}),
                                       ((8, 8), {"dx": 1.0, "dy": 0.01})])
def test_reference2_agrees_with_a_dense_solve(grid, coef):
    ref = reference.load("diag_diffusion2")
    so = ref.build(coef, grid, CPU, torch.float64)
    a = dense2(*grid, coef["dx"], coef["dy"])
    rng = np.random.default_rng(1)
    b = rng.standard_normal(a.shape[0]) * ref.rhs_scale(grid)
    x = np.linalg.solve(a, b)
    xt = torch.from_numpy(x.reshape(grid))
    bt = torch.from_numpy(b.reshape(grid))
    assert torch.allclose(ref.apply(so, xt), bt, rtol=0, atol=1e-15)
    assert judge.relative_residual(ref, so, xt, bt) < 1e-12
    # a wrong answer reads as one
    assert judge.relative_residual(ref, so, xt * (1 + 1e-6), bt) > 1e-8


def test_reference3_agrees_with_a_dense_solve():
    ref = reference.load("diag_diffusion3")
    grid, coef = (5, 6, 4), {"dx": 1.0, "dy": 1.0, "dz": 1e-3}
    so = ref.build(coef, grid, CPU, torch.float64)
    a = dense3(*grid, coef["dx"], coef["dy"], coef["dz"])
    rng = np.random.default_rng(2)
    b = rng.standard_normal(a.shape[0]) * ref.rhs_scale(grid)
    x = np.linalg.solve(a, b)
    xt = torch.from_numpy(x.reshape(grid))
    bt = torch.from_numpy(b.reshape(grid))
    assert torch.allclose(ref.apply(so, xt), bt, rtol=0, atol=1e-15)
    assert judge.relative_residual(ref, so, xt, bt) < 1e-12


def test_apply_equals_the_ports_residual():
    """The reference's ``b - A x`` is the port's plain residual."""
    g = torch.Generator().manual_seed(3)
    r2 = reference.load("diag_diffusion2")
    so = r2.build({"dx": 1.0, "dy": 0.5}, (11, 9), CPU, torch.float64)
    x, b = (torch.randn(11, 9, generator=g, dtype=torch.float64)
            for _ in range(2))
    assert torch.allclose(b - r2.apply(so, x),
                          stencil2.residual(so, x, b, FivePt),
                          rtol=1e-14, atol=1e-14)
    r3 = reference.load("diag_diffusion3")
    so3 = r3.build({"dx": 1.0, "dy": 1.0, "dz": 1e-3}, (6, 7, 5), CPU,
                   torch.float64)
    x3, b3 = (torch.randn(6, 7, 5, generator=g, dtype=torch.float64)
              for _ in range(2))
    assert torch.allclose(b3 - r3.apply(so3, x3),
                          stencil3.residual(so3, x3, b3, SevenPt),
                          rtol=1e-14, atol=1e-14)
