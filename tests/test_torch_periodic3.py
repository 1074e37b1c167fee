"""The port's 3D periodic operations (the plain versions of the periodic
modes of K6-K9) against cedar_tpu, in float64 to 1e-12 relative, on x-,
y-, z- and triply periodic grids, 7- and 27-point, at even and odd
extents: stencil3 (residual, matvec, full offsets, and matvec against a
scipy sparse matrix), relax3 (the point sweep DOWN and UP, with and
without the residual, with an origin), interp3 (setup with the wrap mirror
of CI, restrict, interp-add, interp), galerkin3 (the explicit product), cg
(the periodic dense matrix, the indefinite shift) and planes3 (the
out-of-plane couplings).  The kernels' plain versions (cuda3.sweep_plain,
cuda_transfer3.*_plain) are held to the same functions, and K6's launch
plan and Jacobi rule to the periodic cases.

The JAX package runs none of these on its Pallas kernels (its periodic
cycles take the XLA path, cedar_tpu/solver/cycle3.py:24-25), so its XLA
functions are the reference.  The CUDA kernels themselves run only on the
card; chip_smoke.py holds them against the plain versions checked here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import cg as jcg
from cedar_tpu.ops import galerkin3 as jgalerkin3
from cedar_tpu.ops import interp3 as jinterp3
from cedar_tpu.ops import planes3 as jplanes3
from cedar_tpu.ops import relax3 as jrelax3
from cedar_tpu.ops import stencil3 as jstencil3

from cedar_tpu_torch import gallery
from cedar_tpu_torch.core.shift import coarse_sample
from cedar_tpu_torch.core.types import InterpDir3 as L, StencilKind
from cedar_tpu_torch.ops import (
    cg, cuda3, cuda_transfer3, galerkin3, interp3, planes3, relax3, stencil3,
)

torch.set_num_threads(2)

PERIODIC = [(True, False, False), (False, True, False), (False, False, True),
            (True, True, True)]
PER_IDS = ["x", "y", "z", "xyz"]
# even extents (the standard periodic coarsening) and odd ones on every
# axis (22 -> 11 -> 6: there the wrap couples points of one colour)
SHAPES = [(12, 10, 8), (11, 9, 7)]
RTOL = 1e-12


def random_so(rng, shape, ts, per):
    """A random diagonally dominant stencil: every coupling drawn, those
    across a non-periodic boundary (index 0 of the planes that reach one
    point down that axis) zeroed, the diagonal the wrapped row sum plus a
    margin."""
    ndir = 14 if ts else 4
    so = rng.uniform(0.5, 1.5, (ndir,) + tuple(shape))
    if ts:
        so[4:] *= 0.3
    for ax, p in enumerate(per):
        if not p:
            planes = [int(d) for d in gallery._ACROSS3[ax] if int(d) < ndir]
            idx = [planes] + [slice(None)] * 3
            idx[1 + ax] = 0
            so[tuple(idx)] = 0.0
    kind = StencilKind.twenty_seven_pt if ts else StencilKind.seven_pt
    rows = stencil3.offdiag_apply(torch.tensor(so),
                                  torch.ones(shape, dtype=torch.float64),
                                  kind, per)
    so[0] = rows.numpy() + rng.uniform(0.05, 0.2, shape)
    return so


def kinds(ts):
    return ((StencilKind.twenty_seven_pt, JKind.twenty_seven_pt) if ts
            else (StencilKind.seven_pt, JKind.seven_pt))


def close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def case(shape, ts, per, seed=0):
    rng = np.random.default_rng(seed)
    so = random_so(rng, shape, ts, per)
    q = rng.standard_normal(shape)
    b = rng.standard_normal(shape)
    return so, q, b


GRID = pytest.mark.parametrize("per", PERIODIC, ids=PER_IDS)
TS = pytest.mark.parametrize("ts", [False, True], ids=["7pt", "27pt"])
SHAPE = pytest.mark.parametrize("shape", SHAPES, ids=["even", "odd"])


def sparse_of(so, kind, per):
    """The operator as a scipy matrix, row-major unknowns, from its
    row-form offsets with the neighbour index wrapped by hand."""
    af = stencil3.full_offsets(torch.tensor(so), kind, per)
    shape = so.shape[1:]
    idx = np.arange(np.prod(shape)).reshape(shape)
    grids = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    rows, cols, vals = [], [], []
    for off, field in af.items():
        nb = [g + d for g, d in zip(grids, off)]
        ok = np.ones(shape, bool)
        for ax in range(3):
            if per[ax]:
                nb[ax] %= shape[ax]
            else:
                ok &= (nb[ax] >= 0) & (nb[ax] < shape[ax])
        rows.append(idx[ok])
        cols.append(idx[nb[0][ok], nb[1][ok], nb[2][ok]])
        vals.append(field.numpy()[ok])
    n = idx.size
    return sp.csr_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))


@SHAPE
@TS
@GRID
def test_stencil_periodic(shape, ts, per):
    """residual, matvec and the row-form offsets against cedar_tpu's, and
    matvec against the sparse matrix of the wrapped operator."""
    so, q, b = case(shape, ts, per)
    k, jk = kinds(ts)
    tso, tq, tb = (torch.tensor(a) for a in (so, q, b))
    jso, jq, jb = (jnp.asarray(a) for a in (so, q, b))
    close(stencil3.residual(tso, tq, tb, k, per),
          jstencil3.residual(jso, jq, jb, jk, per))
    mv = stencil3.matvec(tso, tq, k, per)
    close(mv, jstencil3.matvec(jso, jq, jk, per))
    close(mv, (sparse_of(so, k, per) @ q.reshape(-1)).reshape(shape))
    full = stencil3.full_offsets(tso, k, per)
    jfull = jstencil3.full_offsets(jso, jk, per)
    assert set(full) == set(jfull)
    for off in full:
        close(full[off], jfull[off])


@SHAPE
@TS
@GRID
def test_point_relax_periodic(shape, ts, per):
    """The plain K6 with the wrap (colour phases from the values before
    the phase, odd extents included), DOWN and UP, with and without the
    residual; with an origin that flips every colour's parity (7-point
    (1, 0, 0), 27-point (1, 1, 1)) DOWN runs UP's colour order."""
    so, q, b = case(shape, ts, per, 1)
    k, jk = kinds(ts)
    tso, tq, tb = (torch.tensor(a) for a in (so, q, b))
    jso, jq, jb = (jnp.asarray(a) for a in (so, q, b))
    recip = jrelax3.setup_recip(jso)
    for updown in ("down", "up"):
        want = jrelax3.point_relax(jso, jq, jb, recip, jk, updown, per)
        close(relax3.point_relax(tso, tq, tb, None, k, updown,
                                 periodic=per), want)
        got, res = relax3.point_relax(tso, tq, tb, None, k, updown,
                                      fuse_residual=True, periodic=per)
        close(got, want)
        close(res, jstencil3.residual(jso, want, jb, jk, per))
    origin = (1, 1, 1) if ts else (1, 0, 0)
    want = jrelax3.point_relax(jso, jq, jb, recip, jk, "up", per)
    close(relax3.point_relax(tso, tq, tb, None, k, "down", origin=origin,
                             periodic=per), want)
    np.testing.assert_array_equal(tq.numpy(), q)


@SHAPE
@TS
@GRID
def test_transfers_periodic(shape, ts, per):
    """setup_interp (the wrap mirror of the index-0 CI entries), restrict,
    interp-add and interp with the coarse-sample and padded-qc wraps."""
    so, q, b = case(shape, ts, per, 2)
    k, jk = kinds(ts)
    tso = torch.tensor(so)
    ci = interp3.setup_interp(tso, k, per)
    jci = jinterp3.setup_interp(jnp.asarray(so), jk, per)
    close(ci, jci)
    his = [n // 2 for n in shape]
    for plane, delta in interp3.DELTA.items():
        for ax in range(3):
            if per[ax] and delta[ax]:
                lo = [slice(None)] * 3
                hi = [slice(None)] * 3
                lo[ax], hi[ax] = 0, his[ax]
                # the mirror ran axis by axis: the later axes' mirrors
                # may have rewritten the entry since
                if not any(per[a] and delta[a] for a in range(ax + 1, 3)):
                    assert torch.equal(ci[(plane,) + tuple(lo)],
                                       ci[(plane,) + tuple(hi)])
    close(interp3.restrict(ci, torch.tensor(b), per),
          jinterp3.restrict(jci, jnp.asarray(b), per))
    nc = tuple(ci.shape[1:] - np.ones(3, int))
    qc = np.random.default_rng(3).standard_normal(nc)
    tq = torch.tensor(q)
    got = interp3.interp_add(ci, tso, torch.tensor(qc), torch.tensor(b), tq,
                             per)
    assert got is tq   # in place
    close(got, jinterp3.interp_add(jci, jnp.asarray(so), jnp.asarray(qc),
                                   jnp.asarray(b), jnp.asarray(q), per))
    zero = jnp.zeros(shape)
    close(interp3.interp(ci, torch.tensor(qc), shape, per),
          jinterp3.interp_add(jci, jnp.asarray(so), jnp.asarray(qc), zero,
                              zero, per))


@pytest.mark.parametrize("shape", SHAPES + [(5, 4, 6)],
                         ids=["even", "odd", "small"])
@GRID
def test_coarse_sample_periodic(shape, per):
    """coarse_sample (the restriction's fine samples) against cedar_tpu's
    at every offset of the 5x5x5 patch, even and odd extents."""
    from cedar_tpu.core.shift import coarse_sample as jcoarse_sample

    a = np.random.default_rng(4).standard_normal(shape)
    nc = tuple((n - 1) // 2 + 1 for n in shape)
    for off in [(-2, 1, 0), (1, -1, 2), (2, 2, -2), (-1, 0, 1), (0, 0, 0)]:
        close(coarse_sample(torch.tensor(a), off, nc, per),
              jcoarse_sample(jnp.asarray(a), off, nc, per))


@SHAPE
@TS
@pytest.mark.parametrize("per", [PERIODIC[0], PERIODIC[3]], ids=["x", "xyz"])
def test_coarsen_op_periodic(shape, ts, per):
    """The explicit Galerkin product, which coarsen_op takes on periodic
    grids, against cedar_tpu's (on the port's CI)."""
    so, _, _ = case(shape, ts, per, 5)
    k, jk = kinds(ts)
    ci = interp3.setup_interp(torch.tensor(so), k, per)
    got = galerkin3.coarsen_op(ci, torch.tensor(so), k, per)
    assert torch.equal(got, galerkin3.coarsen_op_explicit(
        ci, torch.tensor(so), k, per))
    close(got, jgalerkin3.coarsen_op(jnp.asarray(ci.numpy()),
                                     jnp.asarray(so), jk, per))


@pytest.mark.parametrize("per", [PERIODIC[1], PERIODIC[2]], ids=["y", "z"])
def test_coarsen_op_periodic_yz(per):
    """The explicit product wrapped along y and z alone, 27-point."""
    so, _, _ = case(SHAPES[0], True, per, 6)
    k, jk = kinds(True)
    ci = interp3.setup_interp(torch.tensor(so), k, per)
    close(galerkin3.coarsen_op(ci, torch.tensor(so), k, per),
          jgalerkin3.coarsen_op(jnp.asarray(ci.numpy()), jnp.asarray(so),
                                jk, per))


@TS
def test_explicit_product_equals_comb_without_wrap(ts):
    """Without a periodic axis the explicit product is the comb probing's
    A_c = Pᵀ A P, term for term up to rounding."""
    so, _, _ = case((11, 10, 7), ts, (False,) * 3, 7)
    k, _ = kinds(ts)
    tso = torch.tensor(so)
    ci = interp3.setup_interp(tso, k)
    close(galerkin3.coarsen_op_explicit(ci, tso, k),
          galerkin3.coarsen_op_comb(ci, tso, k).numpy(), rtol=1e-13)


@TS
@GRID
def test_coarse_solve_periodic(ts, per):
    """The periodic dense matrix, its inverse with and without the
    indefinite shift (a triply periodic singular operator too), and the
    coarse solve."""
    so, _, b = case((4, 3, 4), ts, per, 8)
    k, jk = kinds(ts)
    tso, jso = torch.tensor(so), jnp.asarray(so)
    close(cg.assemble_dense(tso, k, per), jcg.assemble_dense(jso, jk, per))
    for indefinite in (False, True):
        ainv = cg.setup_cg_lu(tso, k, indefinite, per)
        jainv = jcg.setup_cg_lu(jso, jk, per, indefinite)
        close(ainv, jainv, rtol=1e-10)
        close(cg.solve_cg(ainv, torch.tensor(b)),
              jcg.solve_cg(jainv, jnp.asarray(b)), rtol=1e-10)
    if all(per):
        # the gallery's triply periodic operator is singular; the shift
        # makes it factorable
        sing = gallery.periodic3(
            (gallery.fe3 if ts else gallery.poisson3)(4, 4, 4,
                                                      device="cpu"), per)
        close(cg.setup_cg_lu(sing, k, True, per),
              jcg.setup_cg_lu(jnp.asarray(sing.numpy()), jk, per, True),
              rtol=1e-9)


@SHAPE
@TS
@GRID
def test_out_of_plane_apply_periodic(shape, ts, per):
    """The plane relaxation's out-of-plane couplings (the only part of the
    plane path that wraps) for each plane axis."""
    so, q, _ = case(shape, ts, per, 9)
    k, jk = kinds(ts)
    for axis in range(3):
        close(planes3.out_of_plane_apply(torch.tensor(so), torch.tensor(q),
                                         k, axis, per),
              jplanes3.out_of_plane_apply(jnp.asarray(so), jnp.asarray(q),
                                          jk, axis, per))


@SHAPE
@TS
@GRID
def test_plain_kernels_periodic(shape, ts, per):
    """The plain versions of K6-K9's periodic modes are the port's periodic
    ops: K6 (cuda3.sweep_plain, with the residual and an origin), K7, K8 and
    K9 (cuda_transfer3.*_plain), bit for bit."""
    so, q, b = case(shape, ts, per, 10)
    k, _ = kinds(ts)
    tso, tq, tb = (torch.tensor(a) for a in (so, q, b))
    for updown, origin in (("down", (0, 0, 0)), ("up", (1, 0, 1))):
        got = cuda3.sweep_plain(tso, tq, tb, k, updown, True, origin, per)
        want = relax3.sweep3_torch(tso, tq, tb, None, k, updown, True,
                                   origin, per)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    ci = interp3.setup_interp(tso, k, per)
    nc = tuple(n - 1 for n in ci.shape[1:])
    qc = torch.tensor(np.random.default_rng(11).standard_normal(nc))
    assert torch.equal(cuda_transfer3.restrict_plain(ci, tb, per),
                       interp3.restrict_torch(ci, tb, per))
    assert torch.equal(
        cuda_transfer3.interp_add_plain(ci, tso, qc, tb, tq.clone(), per),
        interp3.interp_add_torch(ci, tso, qc, tb, tq, per))
    assert torch.equal(cuda_transfer3.interp_plain(ci, qc, shape, per),
                       interp3.interp_torch(ci, qc, shape, per))


def test_sweep_plan_periodic():
    """K6's periodic plan: the resident kernel where it fits, else the
    per-colour launches, never K14's ring or marches; Jacobi phases only
    where an extent along a periodic axis is odd."""
    assert cuda3.plan(4, False, (256,) * 3).route == "ring"
    assert cuda3.plan(4, False, (256,) * 3, periodic=True).route == "phases"
    assert cuda3.plan(4, True, (128,) * 3).route == "pass27"
    assert cuda3.plan(4, True, (128,) * 3, periodic=True).route == "phases"
    assert cuda3.plan(4, True, (16,) * 3, periodic=True).resident
    assert cuda3.plan(8, True, (12,) * 3, periodic=True).resident
    assert cuda3.plan(4, False, (16,) * 3, periodic=True).route == "phases"
    assert not cuda3.odd_wrap((22, 16, 16), (True, False, False))
    assert cuda3.odd_wrap((11, 8, 8), (True, False, False))
    assert not cuda3.odd_wrap((11, 8, 8), (False, True, True))
    assert cuda3.odd_wrap((8, 8, 65), (False, False, True))
    # K14's routes have no periodic mode: refused before any launch
    so, q, b = (torch.tensor(a) for a in case((4, 4, 4), False,
                                                (True, False, False)))
    for route in ("ring", "pass27"):
        with pytest.raises(ValueError, match="no periodic mode"):
            cuda3._launch(cuda3.Plan(route), 1, so, q, b,
                          StencilKind.seven_pt, "down", False, (0, 0, 0),
                          periodic=(True, False, False))


def test_periodic3_gallery():
    """gallery.periodic3 keeps every coupling across the wrap: the
    triply periodic Poisson and fe3 rows sum to zero, and an x-periodic
    Poisson operator equals the shift-invariant stencil on an x-ring."""
    per = (True, True, True)
    for make, kind in ((gallery.poisson3, StencilKind.seven_pt),
                       (gallery.fe3, StencilKind.twenty_seven_pt)):
        so = gallery.periodic3(make(6, 5, 4, device="cpu"), per)
        ones = torch.ones(6, 5, 4, dtype=torch.float64)
        assert float(stencil3.matvec(so, ones, kind, per).abs().max()) < 1e-12
    so = gallery.periodic3(gallery.poisson3(6, 5, 4, device="cpu"),
                           (True, False, False))
    assert torch.equal(so[1, 0], so[1, 3])
    assert float(so[2, :, 0].abs().max()) == 0.0
    q = torch.tensor(np.random.default_rng(12).standard_normal((6, 5, 4)))
    rolled = stencil3.matvec(so, torch.roll(q, 1, 0), StencilKind.seven_pt,
                             (True, False, False))
    close(rolled, torch.roll(stencil3.matvec(so, q, StencilKind.seven_pt,
                                             (True, False, False)), 1, 0))
