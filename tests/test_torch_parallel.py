"""The port's distribution helpers against cedar_tpu's, pure Python (no
process world, but for one world of one process): the mesh factorization and block partition, the per-level
partition policy (coarsen, manual, astar) against cedar_tpu's
``level_specs`` on virtual JAX meshes of the same shapes (nothing is
compiled), the performance model (native and Python, under equal
explicit machine parameters) against cedar_tpu's, the inert padding
against cedar_tpu's on numpy, and the configurations refused until line
relaxation, periodic axes and plane relaxation were ported, solved in a
world of one process."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from cedar_tpu.config import Config as JConfig
from cedar_tpu.parallel import dist as jdist
from cedar_tpu.parallel import policy as jpolicy
from cedar_tpu.parallel import topo as jtopo
import cedar_tpu.perf as jperf

from cedar_tpu_torch import FivePt, NinePt, SevenPt, gallery
from cedar_tpu_torch import perf
from cedar_tpu_torch.parallel import DistSolver2, DistSolver3, policy, topo
from cedar_tpu_torch.parallel.dist import pad_operator
from cedar_tpu_torch.solver.solver2 import level_shapes
from cedar_tpu_torch.solver.solver3 import level_shapes as level_shapes3


def test_balanced_dims_and_blocks():
    for n in range(1, 65):
        for ndim in (2, 3):
            assert topo.balanced_dims(n, ndim) == jtopo.balanced_dims(n, ndim)
    for n in (7, 16, 33, 100):
        for nb in (1, 2, 3, 4, 5, 8):
            for i in range(nb):
                assert topo.block_low(i, nb, n) == jtopo.block_low(i, nb, n)
                assert topo.block_size(i, nb, n) == jtopo.block_size(i, nb,
                                                                     n)
            for g in range(n):
                assert topo.block_owner(g, nb, n) == jtopo.block_owner(g, nb,
                                                                       n)


def _jmesh(shape):
    axes = ("x", "y", "z")[:len(shape)]
    devs = np.asarray(jax.devices("cpu")[:int(np.prod(shape))])
    return JMesh(devs.reshape(shape), axes)


def _jspecs(specs, ndim):
    return [tuple(tuple(s) + (None,) * (ndim - len(tuple(s))))
            for s in specs]


MACHINE = dict(hbm_bw=1.2e12, ici_bw=9e10, ici_lat=3e-6, flop_rate=4e13,
               op_overhead=4e-6)

SPEC_CASES = [
    (level_shapes(96, 96, 6), (2, 2)),
    (level_shapes(400, 400, 7), (2, 2)),
    (level_shapes(144, 144, 7), (4, 2)),
    (level_shapes(64, 64, 5), (4, 1)),
    (level_shapes(64, 48, 5), (1, 4)),
    (level_shapes(4096, 4096, 11), (2, 2)),
    (level_shapes3(32, 32, 32, 4), (2, 2, 2)),
    (level_shapes3(256, 256, 256, 7), (2, 2, 2)),
]


@pytest.mark.parametrize("shapes,mesh", SPEC_CASES)
@pytest.mark.parametrize("strategy,kw", [
    ("coarsen", {}),
    ("coarsen", {"min_local": 4}),
    ("coarsen", {"min_local": 10**9}),
    ("manual", {"path": [[4, 2], [1, 2], [1, 1]]}),
    ("manual", {"path": [[2, 2, 2], [2, 1, 2], [1, 1, 1]]}),
    ("astar", {}),
])
def test_level_specs_match_cedar_tpu(shapes, mesh, strategy, kw):
    ndim = len(mesh)
    kw = dict(kw)
    jkw = dict(kw)
    if strategy == "astar":
        kw["machine_params"] = perf.MachineParams(**MACHINE)
        jkw["machine_params"] = jperf.MachineParams(**MACHINE)
    mine = policy.level_specs(shapes, mesh, strategy=strategy, **kw)
    want = jpolicy.level_specs(shapes, _jmesh(mesh), strategy=strategy,
                               **jkw)
    assert mine == _jspecs(want, ndim)


@pytest.mark.parametrize("shapes,mesh", SPEC_CASES)
def test_perf_model_matches_cedar_tpu(shapes, mesh):
    ndim = len(mesh)
    m, jm = perf.MachineParams(**MACHINE), jperf.MachineParams(**MACHINE)
    allowed = [(1 << ndim) - 1] * len(shapes)
    st = (5, 9) if ndim == 2 else (7, 27)
    masks, cost = perf.search_schedule(shapes, list(mesh), allowed, m, *st)
    pmasks, pcost = perf.search_schedule(shapes, list(mesh), allowed, m,
                                         *st, native=False)
    jmasks, jcost = jperf.search_schedule(shapes, list(mesh), allowed, jm,
                                          *st)
    assert masks == pmasks == list(jmasks)
    assert cost == pytest.approx(pcost, rel=1e-12)
    assert cost == pytest.approx(jcost, rel=1e-12)
    for mk in range(1 << ndim):
        sched = [mk] * (len(shapes) - 1) + [0]
        t = perf.cycle_time(shapes, list(mesh), sched, m, *st)
        assert t == pytest.approx(perf.cycle_time(
            shapes, list(mesh), sched, m, *st, native=False), rel=1e-12)
        assert t == pytest.approx(jperf.cycle_time(
            shapes, list(mesh), sched, jm, *st), rel=1e-12)
    # the port's halo bytes are cedar_tpu's
    for mk in range(1 << ndim):
        assert perf._halo_bytes(shapes[0], list(mesh), mk, 8) == \
            jperf._halo_bytes(shapes[0], list(mesh), mk, 8)


def test_machine_params_defaults_are_the_h100():
    m = perf.MachineParams()
    assert (m.hbm_bw, m.ici_bw, m.flop_rate) == (3.35e12, 450e9, 67e12)
    c = perf.MachineParams.from_config(JConfig({"machine": {
        "bandwidth": 1e9, "latency": 2e-6, "fp_perf": 1e-12}}))
    assert (c.ici_bw, c.ici_lat, c.flop_rate) == (1e9, 2e-6, 1e12)


class _Fake:
    def __init__(self, ndim):
        self._ndim = ndim


@pytest.mark.parametrize("dims,mesh,min_local", [
    ((65, 65), (2, 2), 8), ((75, 64), (4, 2), 8), ((129, 129), (2, 2), 8),
    ((17, 17, 17), (2, 2, 2), 8), ((33, 20, 9), (2, 2, 2), 4),
    ((64, 64), (2, 2), 8),
])
def test_pad_operator_matches_cedar_tpu(dims, mesh, min_local):
    rng = np.random.default_rng(len(dims) * 100 + dims[0])
    so = rng.standard_normal((3 if len(dims) == 2 else 4,) + dims)
    conf = JConfig({"redist": {"min-local": min_local}})
    want = np.asarray(jdist._DistMixin._pad_operator(
        _Fake(len(dims)), jnp.asarray(so), conf, _jmesh(mesh)))
    got, pads = pad_operator(torch.tensor(so), mesh, min_local)
    assert tuple(n + p for n, p in zip(dims, pads)) == want.shape[1:]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dims,mesh,periodic", [
    ((65, 65), (2, 2), (True, False)), ((17, 17, 17), (2, 2, 2),
                                        (False, True, True)),
])
def test_pad_operator_periodic_matches_cedar_tpu(dims, mesh, periodic):
    """A periodic axis takes no pad (cedar_tpu/parallel/dist.py:181-198)."""
    rng = np.random.default_rng(dims[0])
    so = rng.standard_normal((3 if len(dims) == 2 else 4,) + dims)
    conf = JConfig({"grid": {"periodic": list(periodic)}})
    want = np.asarray(jdist._DistMixin._pad_operator(
        _Fake(len(dims)), jnp.asarray(so), conf, _jmesh(mesh)))
    got, pads = pad_operator(torch.tensor(so), mesh, 8, periodic)
    assert [p for p, per in zip(pads, periodic) if per] == [0] * sum(periodic)
    np.testing.assert_array_equal(got.numpy(), want)


# the configurations that DistSolver2 and DistSolver3 refused until line
# relaxation, periodic axes and plane relaxation were ported
# (test_dist2_refusals_name_item9's three cases and
# test_dist3_refusals_name_item9's periodic one and two plane ones): each
# solves in a world of one (mesh (1, 1)[, 1]), x bit for bit the serial
# port's
FORMERLY_REFUSED = {
    "line-x": (2, "poisson", {"solver": {"relaxation": "line-x"}}),
    "line-x-9pt": (2, "fe", {"solver": {"relaxation": "line-x"}}),
    "line-xy": (2, "fe", {"solver": {"relaxation": "line-xy"}}),
    "periodic-2d": (2, "poisson", {"grid": {"periodic": [True, False]}}),
    "periodic-3d": (3, "poisson3", {"grid": {"periodic": [False, False,
                                                          True]}}),
    "plane-xy": (3, "poisson3", {"solver": {"relaxation": "plane-xy"}}),
    "plane-xyz": (3, "poisson3", {"solver": {"relaxation": "plane-xyz"}}),
}


def _world_of_one(rank):
    from cedar_tpu_torch import Solver2, Solver3

    out = {}
    meshes = {2: topo.make_mesh(2, device="cpu"),
              3: topo.make_mesh(3, device="cpu")}
    for key, (ndim, op, conf) in FORMERLY_REFUSED.items():
        conf = {**conf, "log": [], "solver": {
            **conf.get("solver", {}), "tol": 1e-9, "max-iter": 20}}
        n = 16 if ndim == 2 else 8
        so = getattr(gallery, op)(*(n,) * ndim, device="cpu")
        b = (gallery.poisson_rhs(n, n, device="cpu") if ndim == 2
             else gallery.poisson3_rhs(n, n, n, device="cpu"))
        kind = {"poisson": FivePt, "fe": NinePt, "poisson3": SevenPt}[op]
        dcls, scls = ((DistSolver2, Solver2) if ndim == 2
                      else (DistSolver3, Solver3))
        d = dcls(so, kind, conf, meshes[ndim])
        s = scls(so, kind, conf)
        out[key] = (d.solve(b), d.history, s.solve(b), s.history)
    return out


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    from cedar_tpu_torch.parallel.launch import spawn

    return spawn(_world_of_one, 1, timeout=300,
                 init_dir=str(tmp_path_factory.mktemp("world")))[0]


@pytest.mark.parametrize("key", list(FORMERLY_REFUSED))
def test_formerly_refused_configurations_solve(world_of_one, key):
    x, hist, x_ser, hist_ser = world_of_one[key]
    assert hist[-1] < 1e-9
    assert torch.equal(x, x_ser)
    assert len(hist) == len(hist_ser)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialised"):
        topo.make_mesh(2, device="cpu")
