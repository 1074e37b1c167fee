"""The port's 2D periodic solves against cedar_tpu's Solver2 and a sparse
direct solve, float64: point V(1,1) x-periodic, line-x on an x-periodic
anisotropic operator, line-y y-periodic, line-xy and the doubly periodic
indefinite case (``solver.definite: false``, b with its mean removed),
9-point x-periodic and the F-cycle; and a periodic cedar_tpu hierarchy
carried across unchanged by ``levels_from_numpy``.

Histories match to rtol 1e-8 with the absolute floor of 1e-14 in
relative-residual units that the port's other float64 gates use: deep in
a solve, b - A x keeps only a few digits in either package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from cedar_tpu import Solver2 as JSolver2
from cedar_tpu.core.types import StencilKind as JKind

from cedar_tpu_torch import FivePt, NinePt, Solver2
from cedar_tpu_torch.core.types import InterpDir2 as L
from cedar_tpu_torch.ops.stencil2 import full_offsets, residual
from cedar_tpu_torch.solver.level import levels_from_numpy
from cedar_tpu_torch.solver.solver2 import setup_hierarchy

torch.set_num_threads(2)


def periodic_poisson(nx, ny, per, shift=0.0):
    """5-point Poisson whose couplings wrap on the periodic axes (W row 0,
    S column 0), diagonal 4 + shift."""
    so = np.zeros((3, nx, ny))
    so[1, 0 if per[0] else 1:, :] = 1.0
    so[2, :, 0 if per[1] else 1:] = 1.0
    so[0] = 4.0 + shift
    return so


def periodic_x_aniso(nx, ny, eps=0.1):
    """Strong x coupling, periodic in x (tests/test_periodic_2d.py)."""
    so = np.zeros((3, nx, ny))
    so[1] = 1.0
    so[2, :, 1:] = eps
    so[0] = 2.0 + 2.0 * eps
    return so


def periodic_y_aniso(nx, ny):
    so = np.zeros((3, nx, ny))
    so[2] = 1.0
    so[1, 1:, :] = 0.1
    so[0] = 2.2
    return so


def periodic_fe_x(nx, ny):
    """9-point finite-element Laplacian, periodic in x."""
    so = np.zeros((5, nx, ny))
    so[1] = 1.0
    so[2, :, 1:] = 1.0
    so[3, :, 1:] = 1.0
    so[4, :, 1:] = 1.0
    so[0] = 8.0
    return so


# name -> (operator, port kind, JAX kind, periodic, solver settings)
CONFIGS = {
    "point-x": (periodic_poisson(48, 48, (True, False)), FivePt,
                JKind.five_pt, (True, False), {}),
    "line-x": (periodic_x_aniso(48, 32), FivePt, JKind.five_pt,
               (True, False), {"relaxation": "line-x"}),
    "line-y": (periodic_y_aniso(32, 48), FivePt, JKind.five_pt,
               (False, True), {"relaxation": "line-y"}),
    "line-xy": (periodic_poisson(32, 32, (True, True), 0.1), FivePt,
                JKind.five_pt, (True, True), {"relaxation": "line-xy"}),
    "nine-x": (periodic_fe_x(40, 40), NinePt, JKind.nine_pt, (True, False),
               {}),
    "f-cycle-x": (periodic_poisson(48, 48, (True, False)), FivePt,
                  JKind.five_pt, (True, False), {"cycle": {"type": "f"}}),
    "indefinite": (periodic_poisson(64, 64, (True, True)), FivePt,
                   JKind.five_pt, (True, True), {"definite": False}),
}


def conf_of(name, tol):
    so, _, _, per, solver = CONFIGS[name]
    return {"log": [], "grid": {"periodic": list(per)},
            "solver": {"tol": tol, "max-iter": 12, **solver}}


def rhs_of(name):
    so, _, _, per, _ = CONFIGS[name]
    b = np.random.default_rng(1).standard_normal(so.shape[1:])
    if all(per):
        b -= b.mean()   # compatible with the null space of constants
    return b


def sparse_of(so, kind, per):
    """The operator as a scipy matrix, row-major unknowns."""
    af = full_offsets(torch.tensor(so), kind, per)
    nx, ny = so.shape[1:]
    idx = np.arange(nx * ny).reshape(nx, ny)
    rows, cols, vals = [], [], []
    for (dz, dw), field in af.items():
        z, w = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        z2, w2 = z + dz, w + dw
        if per[0]:
            z2 %= nx
        if per[1]:
            w2 %= ny
        ok = (z2 >= 0) & (z2 < nx) & (w2 >= 0) & (w2 < ny)
        rows.append(idx[ok])
        cols.append(idx[z2[ok], w2[ok]])
        vals.append(field.numpy()[ok])
    return sp.csr_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(nx * ny, nx * ny))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_periodic_solve_matches_cedar_tpu(name):
    so, kind, jkind, per, _ = CONFIGS[name]
    conf = conf_of(name, 1e-8)
    b = rhs_of(name)
    js = JSolver2(jnp.asarray(so), jkind, conf)
    jx = np.asarray(js.solve(jnp.asarray(b)))
    s = Solver2(torch.tensor(so), kind, conf)
    assert s.periodic == per
    x = s.solve(torch.tensor(b))
    assert len(s.history) == len(js.history)
    np.testing.assert_allclose(s.history, js.history, rtol=1e-8,
                               atol=1e-14)
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-8,
                               atol=1e-10 * float(np.abs(jx).max()))
    if name == "f-cycle-x":
        assert len(set(s.history)) == 1   # ignores its iterate, by design
    else:
        assert s.history[-1] < 1e-8


@pytest.mark.parametrize("name", ["point-x", "line-x", "line-y",
                                  "nine-x", "indefinite"])
def test_periodic_solve_vs_sparse(name):
    """x against a sparse direct solve (atol 1e-8); the doubly periodic
    singular system against its minimum-norm solution, which the solve
    reaches up to a constant."""
    so, kind, _, per, _ = CONFIGS[name]
    conf = conf_of(name, 1e-11)
    conf["solver"]["max-iter"] = 40
    b = rhs_of(name)
    s = Solver2(torch.tensor(so), kind, conf)
    x = s.solve(torch.tensor(b)).numpy()
    A = sparse_of(so, kind, per)
    if all(per):
        r = residual(torch.tensor(so), torch.tensor(x), torch.tensor(b),
                     kind, per)
        assert float(r.norm()) / np.linalg.norm(b) < 1e-10
        want = spla.lsqr(A, b.reshape(-1), atol=1e-14, btol=1e-14,
                         iter_lim=20000)[0].reshape(b.shape)
        x = x - x.mean() + want.mean()
    else:
        want = spla.spsolve(A.tocsc(), b.reshape(-1)).reshape(b.shape)
    np.testing.assert_allclose(x, want, atol=1e-8)


def test_levels_from_numpy_carries_periodic_hierarchy():
    """A cedar_tpu hierarchy of a doubly periodic problem comes across
    unchanged (CI with its wrap entries), equals the port's own periodic
    setup to 1e-12, and solves as the port's (the graph path with such a
    hierarchy: tests/test_torch_graph.py)."""
    so, kind, jkind, per, _ = CONFIGS["line-xy"]
    conf = conf_of("line-xy", 1e-8)
    js = JSolver2(jnp.asarray(so), jkind, conf)
    levels = levels_from_numpy(
        [{k: np.asarray(v) for k, v in lev._asdict().items()
          if v is not None} for lev in js.levels], dtype=torch.float64)
    s = Solver2(torch.tensor(so), kind, conf)
    own = setup_hierarchy(torch.tensor(so), kind, s.nlevels, s.settings,
                          False, per)
    assert len(levels) == len(own) == len(js.levels)
    for lev, mine, jlev in zip(levels, own, js.levels):
        np.testing.assert_array_equal(lev.so.numpy(), np.asarray(jlev.so))
        np.testing.assert_allclose(lev.so.numpy(), mine.so.numpy(),
                                   rtol=1e-12, atol=1e-12)
        if jlev.ci is None:
            continue
        ci = lev.ci
        np.testing.assert_array_equal(ci.numpy(), np.asarray(jlev.ci))
        np.testing.assert_allclose(ci.numpy(), mine.ci.numpy(), rtol=1e-12,
                                   atol=1e-12)
        kx, my = ci.shape[1] - 1, ci.shape[2] - 1
        assert torch.equal(ci[L.LR, 0], ci[L.LR, kx])
        assert torch.equal(ci[L.LB, :, 0], ci[L.LB, :, my])
    b = torch.tensor(rhs_of("line-xy"))
    x_own = s.solve(b)
    hist = list(s.history)
    s.levels = levels
    x = s.solve(b)
    np.testing.assert_allclose(s.history, hist, rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(x.numpy(), x_own.numpy(), rtol=1e-9,
                               atol=1e-12)
