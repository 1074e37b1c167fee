"""The port's 3D periodic solves against cedar_tpu's Solver3 and a sparse
direct solve, float64, at the configurations cedar_tpu runs on periodic 3D
grids, cut to 8³-22x16x16: 7-point x-periodic V(1,1) (even and odd
periodic extents at the swept levels: 22 -> 11 -> 6), the triply periodic
singular 7- and 27-point solves (``solver.definite: false``, b with its
mean removed), the 27-point F-cycle, plane-yz with the periodic axis
normal to the planes, and plane-xy with it inside the planes, where
cedar_tpu's non-periodic plane solvers stall (the port copies it: held to
cedar_tpu's history, not to convergence).  A W-cycle and a V-cycle on a
periodic cedar_tpu hierarchy carried across by ``levels_from_numpy``;
``kernels.fine-split: true`` on a periodic grid runs the dense cycle.
The other plane orientations are held to a sparse direct solve (their ops
op by op in tests/test_torch_periodic3.py).

Histories match to rtol 1e-8 with the absolute floor of 1e-14 in
relative-residual units that the port's other float64 gates use.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from cedar_tpu import Solver3 as JSolver3
from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.solver import cycle3 as jcycle3

from cedar_tpu_torch import SevenPt, Solver3, TwentySevenPt, gallery
from cedar_tpu_torch.core.types import InterpDir3 as L
from cedar_tpu_torch.ops.stencil3 import residual
from cedar_tpu_torch.solver import cycle3
from cedar_tpu_torch.solver.level import levels_from_numpy
from cedar_tpu_torch.solver.solver3 import setup_hierarchy

from test_torch_periodic3 import sparse_of

torch.set_num_threads(2)

X, Y, Z = (True, False, False), (False, True, False), (False, False, True)
XYZ = (True, True, True)


def op(make, shape, per):
    return gallery.periodic3(make(*shape, device="cpu"), per).numpy()


def aniso(dx, dy, dz):
    def make(nx, ny, nz, device=None):
        return gallery.diag_diffusion3(nx, ny, nz, dx, dy, dz,
                                       device=device)
    return make


# name -> (operator, port kind, JAX kind, periodic, solver settings)
CONFIGS = {
    "7pt-x": (op(gallery.poisson3, (16, 8, 8), X), SevenPt, JKind.seven_pt,
              X, {}),
    "7pt-x-odd": (op(gallery.poisson3, (22, 16, 16), X), SevenPt,
                  JKind.seven_pt, X, {}),
    "7pt-xyz-indefinite": (op(gallery.poisson3, (8, 8, 8), XYZ), SevenPt,
                           JKind.seven_pt, XYZ, {"definite": False}),
    "27pt-xyz-indefinite": (op(gallery.fe3, (8, 8, 8), XYZ), TwentySevenPt,
                            JKind.twenty_seven_pt, XYZ,
                            {"definite": False}),
    "27pt-xyz-odd": (op(gallery.fe3, (22, 16, 16), XYZ), TwentySevenPt,
                     JKind.twenty_seven_pt, XYZ, {"definite": False}),
    "27pt-xyz-fcycle": (op(gallery.fe3, (8, 8, 8), XYZ), TwentySevenPt,
                        JKind.twenty_seven_pt, XYZ,
                        {"definite": False, "cycle": {"type": "f"},
                         "max-iter": 3}),
    # the periodic axis normal to the planes: the out-of-plane couplings
    # wrap, and the plane solves converge
    "plane-yz-x": (op(aniso(1e-3, 1.0, 1.0), (8, 8, 8), X), SevenPt,
                   JKind.seven_pt, X, {"relaxation": "plane-yz"}),
    # the periodic axis inside the planes: the plane solvers are not
    # periodic (cedar_tpu/ops/planes3.py:131-176), the solve stalls
    "plane-xy-x-inplane": (op(aniso(1.0, 1.0, 1e-3), (8, 8, 8), X),
                           SevenPt, JKind.seven_pt, X,
                           {"relaxation": "plane-xy", "max-iter": 6}),
}


def conf_of(name, tol=1e-10):
    so, _, _, per, solver = CONFIGS[name]
    return {"log": [], "grid": {"periodic": list(per)},
            "solver": {"tol": tol, "max-iter": 30, **solver}}


def rhs_of(shape, per):
    b = np.random.default_rng(1).standard_normal(shape)
    if all(per):
        b -= b.mean()   # compatible with the null space of constants
    return b


def check_vs_sparse(so, kind, per, x, b):
    """x against a sparse direct solve (atol 1e-8); a triply periodic
    singular system against its least-squares solution, which the solve
    reaches up to a constant."""
    A = sparse_of(so, kind, per)
    if all(per):
        r = residual(torch.tensor(so), torch.tensor(x), torch.tensor(b),
                     kind, per)
        assert float(r.norm()) / np.linalg.norm(b) < 1e-9
        want = spla.lsqr(A, b.reshape(-1), atol=1e-14, btol=1e-14,
                         iter_lim=20000)[0].reshape(b.shape)
        x = x - x.mean() + want.mean()
    else:
        want = spla.spsolve(A.tocsc(), b.reshape(-1)).reshape(b.shape)
    np.testing.assert_allclose(x, want, atol=1e-8)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_periodic_solve_matches_cedar_tpu(name):
    so, kind, jkind, per, _ = CONFIGS[name]
    conf = conf_of(name)
    b = rhs_of(so.shape[1:], per)
    js = JSolver3(jnp.asarray(so), jkind, conf)
    jx = np.asarray(js.solve(jnp.asarray(b)))
    s = Solver3(torch.tensor(so), kind, conf)
    assert s.periodic == per
    assert s.nlevels == js.nlevels
    x = s.solve(torch.tensor(b))
    assert len(s.history) == len(js.history)
    np.testing.assert_allclose(s.history, js.history, rtol=1e-8,
                               atol=1e-14)
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-8,
                               atol=1e-10 * float(np.abs(jx).max()))
    if name.endswith("fcycle"):
        assert len(set(s.history)) == 1   # ignores its iterate, by design
    elif name.endswith("inplane"):
        assert s.history[-1] > 1e-3       # cedar_tpu's plane solves stall
    else:
        assert s.history[-1] < 1e-10
        check_vs_sparse(so, kind, per, x.numpy(), b)


# the plane path's other orientations and grids, against the sparse solve
PLANE_ONLY = {
    "plane-xy-z": (op(aniso(1.0, 1.0, 1e-3), (16, 16, 16), Z), Z,
                   "plane-xy"),
    "plane-xz-y": (op(aniso(1.0, 1e-3, 1.0), (8, 8, 8), Y), Y, "plane-xz"),
    "plane-xy-z-27pt": (op(gallery.fe3, (8, 8, 8), Z), Z, "plane-xy"),
}


@pytest.mark.parametrize("name", list(PLANE_ONLY))
def test_periodic_plane_solve_vs_sparse(name):
    """plane-xy z-periodic and plane-xz y-periodic (normal to the
    planes), 7-point, and 27-point plane-xy z-periodic: to 1e-10 and x
    against the sparse direct solve."""
    so, per, relax = PLANE_ONLY[name]
    kind = TwentySevenPt if so.shape[0] == 14 else SevenPt
    solver = {"tol": 1e-10, "max-iter": 40, "relaxation": relax}
    if all(per):
        solver["definite"] = False
    s = Solver3(torch.tensor(so), kind,
                {"log": [], "grid": {"periodic": list(per)},
                 "solver": solver})
    b = rhs_of(so.shape[1:], per)
    x = s.solve(torch.tensor(b)).numpy()
    assert s.history[-1] < 1e-10
    check_vs_sparse(so, kind, per, x, b)


def test_plane_config_periodic_is_ignored():
    """The plane-config's own grid.periodic is accepted and ignored, as
    cedar_tpu ignores it: the same history as without it."""
    so, _, _, per, _ = CONFIGS["plane-yz-x"]
    b = torch.tensor(rhs_of(so.shape[1:], per))
    hist = []
    for pgrid in ({}, {"grid": {"periodic": [True, True]}}):
        conf = conf_of("plane-yz-x")
        conf["plane-config"] = {"solver": {"relaxation": "line-xy"},
                                **pgrid}
        s = Solver3(torch.tensor(so), SevenPt, conf)
        s.solve(b)
        hist.append(s.history)
    assert hist[0] == hist[1]


def test_fine_split_periodic_runs_dense(monkeypatch):
    """kernels.fine-split: true on a periodic grid runs the dense cycle,
    as cedar_tpu does (its split workspaces need every axis non-periodic):
    the same history, and the fused cycle is never entered."""
    so, kind, _, per, _ = CONFIGS["7pt-x"]
    b = torch.tensor(rhs_of(so.shape[1:], per))
    dense = Solver3(torch.tensor(so), kind, conf_of("7pt-x"))
    dense.solve(b)
    conf = conf_of("7pt-x")
    conf["kernels"] = {"fine-split": True, "split-levels": 2}
    fused = Solver3(torch.tensor(so), kind, conf)
    assert not cycle3.fine_split_ok(fused.levels, fused.settings, per)
    assert cycle3.fine_split_ok(fused.levels, fused.settings)

    def refuse(*a, **k):
        raise AssertionError("the fused cycle ran on a periodic grid")

    monkeypatch.setattr(cycle3, "ncycle_split", refuse)
    fused.solve(b)
    assert fused.history == dense.history
    conf["solver"]["cycle"] = {"type": "f"}
    Solver3(torch.tensor(so), kind, conf).solve(b)


@pytest.fixture(scope="module")
def carried():
    """A cedar_tpu hierarchy of the odd 27-point triply periodic problem
    as numpy, the port's levels made from it, and a port solver."""
    so, kind, jkind, per, _ = CONFIGS["27pt-xyz-odd"]
    conf = conf_of("27pt-xyz-odd")
    js = JSolver3(jnp.asarray(so), jkind, conf)
    levels = levels_from_numpy(
        [{k: np.asarray(v) for k, v in lev._asdict().items()
          if v is not None and not isinstance(v, tuple)}
         for lev in js.levels], dtype=torch.float64)
    return dict(js=js, so=so, per=per, conf=conf, levels=levels,
                s=Solver3(torch.tensor(so), kind, conf))


def test_levels_from_numpy_carries_periodic_hierarchy(carried):
    """A cedar_tpu periodic hierarchy comes across unchanged (CI with its
    mirrored wrap entries) and equals the port's own periodic setup to
    1e-12; a port V-cycle on it equals cedar_tpu's."""
    js, levels, s = carried["js"], carried["levels"], carried["s"]
    own = setup_hierarchy(torch.tensor(carried["so"]), TwentySevenPt,
                          s.nlevels, s.settings, True, carried["per"])
    assert len(levels) == len(own) == len(js.levels)
    for lvl, (lev, mine, jlev) in enumerate(zip(levels, own, js.levels)):
        np.testing.assert_array_equal(lev.so.numpy(), np.asarray(jlev.so))
        np.testing.assert_allclose(lev.so.numpy(), mine.so.numpy(),
                                   rtol=1e-12, atol=1e-12)
        if jlev.ci is None:
            continue
        ci = lev.ci
        np.testing.assert_array_equal(ci.numpy(), np.asarray(jlev.ci))
        np.testing.assert_allclose(ci.numpy(), mine.ci.numpy(), rtol=1e-12,
                                   atol=1e-12)
        # the x-edge weights' wrap entry: fine point -1 is the last one
        kx = levels[lvl - 1].so.shape[1] // 2
        assert torch.equal(ci[L.XYR, 0], ci[L.XYR, kx])
    np.testing.assert_allclose(levels[-1].ainv.numpy(),
                               own[-1].ainv.numpy(), rtol=1e-9, atol=1e-12)
    b = rhs_of(carried["so"].shape[1:], carried["per"])
    x0 = np.random.default_rng(3).standard_normal(b.shape)
    want = np.asarray(js.vcycle(jnp.asarray(x0), jnp.asarray(b)))
    s2 = copy.copy(s)
    s2.levels = levels
    got = s2.vcycle(torch.tensor(x0), torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * float(np.abs(want).max()))


def test_w_cycle_on_jax_periodic_hierarchy(carried):
    """One port W-cycle (n=2) on the carried hierarchy equals cedar_tpu's
    ncycle(n=2) with the wrap."""
    js, levels, s, per = (carried["js"], carried["levels"], carried["s"],
                          carried["per"])
    b = rhs_of(carried["so"].shape[1:], per)
    x0 = np.random.default_rng(4).standard_normal(b.shape)
    want = np.asarray(jcycle3.ncycle(js.levels, js.kinds, 0,
                                     jnp.asarray(x0), jnp.asarray(b),
                                     js.settings, per, 2))
    got = cycle3.ncycle(levels, s.kinds, 0, torch.tensor(x0),
                        torch.tensor(b), s.settings, 2, periodic=per)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * float(np.abs(want).max()))
