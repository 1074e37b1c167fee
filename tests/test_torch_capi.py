"""The port's handle API (``cedar_tpu_torch.capi``) against cedar_tpu's
(``cedar_tpu.capi``), float64 on the CPU: tests/test_capi.py's 2D and 3D
round trips, ``operator_apply`` against cedar_tpu's (atol 1e-13), per-entry
``operator_set`` against ``set_full``, ``solver_run``'s x and history
against cedar_tpu's on the same numpy operator (rtol 1e-9), ``dump`` and
``destroy``, and a mesh that is not the port's refused."""

import numpy as np
import pytest
import torch

import cedar_tpu.capi as jcapi
from cedar_tpu import gallery as jgallery

import cedar_tpu_torch.capi as capi
from cedar_tpu_torch import gallery

torch.set_num_threads(2)

CONF = {"log": [], "solver": {"tol": 1e-9, "max-iter": 30}}


def test_capi_2d_roundtrip():
    n = 64
    topo = capi.bmg2_topo_create(n, n, device="cpu")
    op = capi.bmg2_operator_create(topo)
    so = gallery.poisson(n, n, device="cpu").numpy()
    capi.bmg2_operator_set_full(op, so)
    b = gallery.poisson_rhs(n, n, device="cpu").numpy()
    slv = capi.bmg2_solver_create(op, CONF)
    x = np.zeros((n, n))
    out = capi.bmg2_solver_run(slv, x, b)
    assert np.array_equal(out, x)
    err = np.abs(x - gallery.poisson_solution(n, n, device="cpu").numpy())
    assert err.max() < 1e-3
    capi.bmg2_solver_destroy(slv)
    capi.bmg2_operator_destroy(op)


def test_capi_3d_roundtrip():
    n = 16
    topo = capi.bmg3_topo_create(n, n, n, device="cpu")
    op = capi.bmg3_operator_create(topo)
    capi.bmg3_operator_set_full(op, gallery.poisson3(n, n, n,
                                                     device="cpu").numpy())
    b = gallery.poisson3_rhs(n, n, n, device="cpu").numpy()
    slv = capi.bmg3_solver_create(op, CONF)
    x = np.zeros((n, n, n))
    capi.bmg3_solver_run(slv, x, b)
    err = np.abs(x - gallery.poisson3_solution(n, n, n, device="cpu").numpy())
    assert err.max() < 2e-2
    capi.bmg3_solver_destroy(slv)


def _pair(ndim: int, so: np.ndarray):
    """The same operator behind both packages' handles: (port op, JAX op)."""
    shape = so.shape[1:]
    if ndim == 2:
        ops = (capi.bmg2_operator_create(capi.bmg2_topo_create(
                   *shape, device="cpu")),
               jcapi.bmg2_operator_create(jcapi.bmg2_topo_create(*shape)))
    else:
        ops = (capi.bmg3_operator_create(capi.bmg3_topo_create(
                   *shape, device="cpu")),
               jcapi.bmg3_operator_create(jcapi.bmg3_topo_create(*shape)))
    capi.bmg2_operator_set_full(ops[0], so)
    jcapi.bmg2_operator_set_full(ops[1], so)
    return ops


# name -> (dimension, the numpy operator)
OPERATORS = {
    "2d-5pt": (2, lambda: np.asarray(jgallery.poisson(40, 33))),
    "2d-9pt": (2, lambda: np.asarray(jgallery.fe(33, 40))),
    "3d-7pt": (3, lambda: np.asarray(jgallery.poisson3(12, 10, 9))),
    "3d-27pt": (3, lambda: np.asarray(jgallery.fe3(9, 10, 12))),
}


@pytest.mark.parametrize("name", list(OPERATORS))
def test_operator_apply_matches_cedar_tpu(name):
    ndim, make = OPERATORS[name]
    so = make()
    op, jop = _pair(ndim, so)
    x = np.random.default_rng(0).standard_normal(so.shape[1:])
    got = capi.bmg2_operator_apply(op, x)
    want = jcapi.bmg2_operator_apply(jop, x)
    assert got.dtype == np.float64 and got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("name", list(OPERATORS))
def test_solver_run_matches_cedar_tpu(name):
    """x and the history of a handle solve from a random initial guess,
    against cedar_tpu's handle solve of the same numpy operator."""
    ndim, make = OPERATORS[name]
    so = make()
    op, jop = _pair(ndim, so)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(so.shape[1:])
    x0 = rng.standard_normal(so.shape[1:])
    create = capi.bmg2_solver_create if ndim == 2 else capi.bmg3_solver_create
    jcreate = (jcapi.bmg2_solver_create if ndim == 2
               else jcapi.bmg3_solver_create)
    slv, jslv = create(op, CONF), jcreate(jop, CONF)
    x, jx = x0.copy(), x0.copy()
    capi.bmg3_solver_run(slv, x, b)
    jcapi.bmg3_solver_run(jslv, jx, b)
    s, js = capi._get(slv), jcapi._get(jslv)
    assert len(s.history) == len(js.history)
    np.testing.assert_allclose(s.history, js.history, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x, jx, rtol=1e-9,
                               atol=1e-9 * float(np.abs(jx).max()))
    capi.bmg2_solver_destroy(slv)
    jcapi.bmg2_solver_destroy(jslv)


def test_operator_set_matches_set_full():
    """Entry by entry (0-based interior (i, j, dir) triples) gives the
    stencil ``set_full`` stores, and the same solver."""
    n = 12
    so = np.asarray(jgallery.fe(n, n))
    full = capi.bmg2_operator_create(capi.bmg2_topo_create(n, n,
                                                           device="cpu"))
    capi.bmg2_operator_set_full(full, so)
    op = capi.bmg2_operator_create(capi.bmg2_topo_create(n, n, device="cpu"))
    coords = [(i, j, d) for d in range(so.shape[0]) for i in range(n)
              for j in range(n) if so[d, i, j] != 0]
    capi.bmg2_operator_set(op, coords, [so[d, i, j] for i, j, d in coords])
    assert np.array_equal(capi.bmg2_operator_dump(op),
                          capi.bmg2_operator_dump(full))
    x = np.random.default_rng(2).standard_normal((n, n))
    assert np.array_equal(capi.bmg2_operator_apply(op, x),
                          capi.bmg2_operator_apply(full, x))
    so3 = np.asarray(jgallery.poisson3(4, 5, 3))
    op3 = capi.bmg3_operator_create(capi.bmg3_topo_create(4, 5, 3,
                                                          device="cpu"))
    coords3 = [(i, j, k, d) for d in range(4) for i in range(4)
               for j in range(5) for k in range(3)]
    capi.bmg3_operator_set(op3, coords3,
                           [so3[d, i, j, k] for i, j, k, d in coords3])
    dump = capi.bmg3_operator_dump(op3)
    assert dump.shape == (14, 4, 5, 3) and np.array_equal(dump[:4], so3)
    assert not dump[4:].any()


def test_dump_and_destroy():
    n = 6
    op = capi.bmg2_operator_create(capi.bmg2_topo_create(n, n, device="cpu"))
    so = np.asarray(jgallery.poisson(n, n))
    capi.bmg2_operator_set_full(op, so)
    dump = capi.bmg2_operator_dump(op)
    # float64, the stencil's five planes, the 5-point ones as set; a copy
    assert dump.dtype == np.float64 and dump.shape == (5, n, n)
    assert np.array_equal(dump[:3], so) and not dump[3:].any()
    dump[0] = 0.0
    assert np.array_equal(capi.bmg2_operator_dump(op)[:3], so)
    slv = capi.bmg2_solver_create(op, CONF)
    capi.bmg2_solver_destroy(slv)
    capi.bmg2_operator_destroy(op)
    for h in (slv, op):
        assert h not in capi._handles
        with pytest.raises(KeyError):
            capi.bmg2_operator_dump(h)
    capi.bmg2_operator_destroy(op)   # a second destroy is harmless


def test_mesh_and_missing_card_refused():
    for create, shape in ((capi.bmg2_topo_create, (8, 8)),
                          (capi.bmg3_topo_create, (8, 8, 8))):
        # a mesh is the port's own (tests/test_torch_dist.py solves on
        # one); anything else is refused
        with pytest.raises(TypeError, match="Mesh"):
            create(*shape, mesh=object(), device="cpu")
        if not torch.cuda.is_available():
            # the default device is the card: no fallback to the CPU
            with pytest.raises(RuntimeError, match="no CUDA device"):
                create(*shape)
