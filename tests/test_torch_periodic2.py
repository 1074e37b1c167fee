"""The port's 2D periodic operations (plain versions of the periodic modes
of K1-K5) against cedar_tpu, in float64 to 1e-12 relative, on x-, y- and
doubly periodic grids, 5- and 9-point, at even and odd extents:
stencil2 (residual, matvec, full offsets), relax2 (the point sweep, with
and without the residual), interp2 (setup with the wrap mirror of CI,
restrict, interp-add, interp), galerkin2 (the explicit product), cg (the
periodic dense matrix, the indefinite shift, the mean subtraction) and
lines2 (the cyclic Sherman–Morrison line solve, the wrapped right-hand
side, the odd-lines error).  The plain K1 periodic sweep is also held
against the Pallas sweep's periodic mode in interpret mode, float32.

The CUDA kernels themselves run only on the card; chip_smoke.py holds them
against the plain versions checked here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import cg as jcg
from cedar_tpu.ops import galerkin2 as jgalerkin2
from cedar_tpu.ops import interp2 as jinterp2
from cedar_tpu.ops import lines2 as jlines2
from cedar_tpu.ops import relax2 as jrelax2
from cedar_tpu.ops import stencil2 as jstencil2

from cedar_tpu_torch.core.types import InterpDir2 as L, StencilKind
from cedar_tpu_torch.ops import (
    cg, cuda2, cuda_lines2, galerkin2, interp2, lines2, relax2, stencil2,
)

torch.set_num_threads(2)

PERIODIC = [(True, False), (False, True), (True, True)]
# even extents (the standard periodic coarsening) and odd ones (a 400²
# grid coarsens to 25²: there the wrap couples points of one colour)
SHAPES = [(16, 12), (13, 11)]
RTOL = 1e-12


def periodic_so(rng, nx, ny, nine, per):
    """A random diagonally dominant stencil whose couplings across the
    periodic axes (row or column 0 of the planes, which the wrap reads)
    are nonzero; zero there on non-periodic axes."""
    so = np.zeros((5 if nine else 3, nx, ny))
    x0 = 0 if per[0] else 1
    y0 = 0 if per[1] else 1
    so[1, x0:, :] = rng.uniform(0.5, 1.5, (nx - x0, ny))
    so[2, :, y0:] = rng.uniform(0.5, 1.5, (nx, ny - y0))
    if nine:
        so[3, x0:, y0:] = rng.uniform(0.1, 0.5, (nx - x0, ny - y0))
        so[4, x0:, y0:] = rng.uniform(0.1, 0.5, (nx - x0, ny - y0))
    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    rows = stencil2.offdiag_apply(torch.tensor(so),
                                  torch.ones(nx, ny, dtype=torch.float64),
                                  kind, per)
    so[0] = rows.numpy() + rng.uniform(0.05, 0.2, (nx, ny))
    return so


def kinds(nine):
    return ((StencilKind.nine_pt, JKind.nine_pt) if nine
            else (StencilKind.five_pt, JKind.five_pt))


def close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def case(shape, nine, per, seed=0):
    rng = np.random.default_rng(seed)
    so = periodic_so(rng, *shape, nine, per)
    q = rng.standard_normal(shape)
    b = rng.standard_normal(shape)
    return so, q, b


GRID = pytest.mark.parametrize("per", PERIODIC, ids=["x", "y", "xy"])
NINE = pytest.mark.parametrize("nine", [False, True], ids=["5pt", "9pt"])
SHAPE = pytest.mark.parametrize("shape", SHAPES, ids=["even", "odd"])


@SHAPE
@NINE
@GRID
def test_stencil_periodic(shape, nine, per):
    so, q, b = case(shape, nine, per)
    k, jk = kinds(nine)
    tso, tq, tb = (torch.tensor(a) for a in (so, q, b))
    jso, jq, jb = (jnp.asarray(a) for a in (so, q, b))
    close(stencil2.residual(tso, tq, tb, k, per),
          jstencil2.residual(jso, jq, jb, jk, per))
    close(stencil2.matvec(tso, tq, k, per),
          jstencil2.matvec(jso, jq, jk, per))
    full = stencil2.full_offsets(tso, k, per)
    jfull = jstencil2.full_offsets(jso, jk, per)
    assert set(full) == set(jfull)
    for off in full:
        close(full[off], jfull[off])


@SHAPE
@NINE
@GRID
def test_point_relax_periodic(shape, nine, per):
    """The plain K1 with the wrap (colour phases from the values before
    the phase, odd extents included), with and without the residual."""
    so, q, b = case(shape, nine, per, 1)
    k, jk = kinds(nine)
    tso, tq, tb = (torch.tensor(a) for a in (so, q, b))
    jso, jq, jb = (jnp.asarray(a) for a in (so, q, b))
    recip = jrelax2.setup_recip(jso)
    for updown in ("down", "up"):
        want = jrelax2.point_relax(jso, jq, jb, recip, jk, updown, per)
        close(relax2.point_relax(tso, tq, tb, None, k, updown,
                                 periodic=per), want)
        got, res = relax2.point_relax(tso, tq, tb, None, k, updown,
                                      fuse_residual=True, periodic=per)
        close(got, want)
        close(res, jstencil2.residual(jso, want, jb, jk, per))
    np.testing.assert_array_equal(tq.numpy(), q)


@SHAPE
@NINE
@GRID
def test_transfers_periodic(shape, nine, per):
    """setup_interp (the wrap mirror of the index-0 CI entries), restrict,
    interp-add and interp with the coarse-sample and padded-qc wraps."""
    so, q, b = case(shape, nine, per, 2)
    k, jk = kinds(nine)
    tso = torch.tensor(so)
    ci = interp2.setup_interp(tso, k, per)
    jci = jinterp2.setup_interp(jnp.asarray(so), jk, per)
    close(ci, jci)
    kx, my = shape[0] // 2, shape[1] // 2
    if per[0]:
        assert torch.equal(ci[L.LL, 0], ci[L.LL, kx])
    if per[1]:
        assert torch.equal(ci[L.LA, :, 0], ci[L.LA, :, my])
    close(interp2.restrict(ci, torch.tensor(b), per),
          jinterp2.restrict(jci, jnp.asarray(b), per))
    nc = (ci.shape[1] - 1, ci.shape[2] - 1)
    qc = np.random.default_rng(3).standard_normal(nc)
    tq = torch.tensor(q)
    got = interp2.interp_add(ci, tso, torch.tensor(qc), torch.tensor(b), tq,
                             per)
    assert got is tq   # in place
    close(got, jinterp2.interp_add(jci, jnp.asarray(so), jnp.asarray(qc),
                                   jnp.asarray(b), jnp.asarray(q), per))
    zero = jnp.zeros(shape)
    close(interp2.interp(ci, torch.tensor(qc), shape, per),
          jinterp2.interp_add(jci, jnp.asarray(so), jnp.asarray(qc), zero,
                              zero, per))


@SHAPE
@NINE
@GRID
def test_coarsen_op_periodic(shape, nine, per):
    """The explicit Galerkin product, which coarsen_op takes on periodic
    grids, against cedar_tpu's."""
    so, _, _ = case(shape, nine, per, 4)
    k, jk = kinds(nine)
    ci = interp2.setup_interp(torch.tensor(so), k, per)
    got = galerkin2.coarsen_op(ci, torch.tensor(so), k, per)
    assert torch.equal(got, galerkin2.coarsen_op_explicit(
        ci, torch.tensor(so), k, per))
    close(got, jgalerkin2.coarsen_op(jnp.asarray(ci.numpy()),
                                     jnp.asarray(so), jk, per))


def test_explicit_product_equals_comb_without_wrap():
    """Without a periodic axis the explicit product is the comb probing's
    A_c = Pᵀ A P, term for term up to rounding."""
    so, _, _ = case((13, 11), True, (False, False), 5)
    tso = torch.tensor(so)
    ci = interp2.setup_interp(tso, StencilKind.nine_pt)
    close(galerkin2.coarsen_op_explicit(ci, tso, StencilKind.nine_pt),
          galerkin2.coarsen_op_comb(ci, tso, StencilKind.nine_pt).numpy(),
          rtol=1e-13)


@NINE
@GRID
def test_coarse_solve_periodic(nine, per):
    """The periodic dense matrix, its inverse with and without the
    indefinite shift, and solve_cg's mean subtraction."""
    so, _, b = case((6, 4), nine, per, 6)
    k, jk = kinds(nine)
    tso, jso = torch.tensor(so), jnp.asarray(so)
    close(cg.assemble_dense(tso, k, per), jcg.assemble_dense(jso, jk, per))
    for indefinite in (False, True):
        ainv = cg.setup_cg_lu(tso, k, indefinite, per)
        jainv = jcg.setup_cg_lu(jso, jk, per, indefinite)
        close(ainv, jainv, rtol=1e-10)
        for mean in (False, True):
            close(cg.solve_cg(ainv, torch.tensor(b), mean),
                  jcg.solve_cg(jainv, jnp.asarray(b), mean), rtol=1e-10)
    x = cg.solve_cg(ainv, torch.tensor(b), subtract_mean=True)
    assert abs(float(x.mean())) < 1e-13


def test_solve_cg_subtract_mean_batched():
    """A batch of planes: each plane's mean removed."""
    rng = np.random.default_rng(7)
    ainv = torch.tensor(rng.standard_normal((3, 12, 12)))
    b = torch.tensor(rng.standard_normal((3, 4, 3)))
    x = cg.solve_cg(ainv, b, subtract_mean=True)
    want = cg.solve_cg(ainv, b)
    want = want - want.mean(dim=(-2, -1), keepdim=True)
    assert torch.equal(x, want)
    assert float(x.mean(dim=(-2, -1)).abs().max()) < 1e-14


# lines of 13 and 12 points (LDLᵀ), 70, 66 and 65 (PCR), odd and even;
# where a line count across a periodic axis is odd, the sweep raises
LINE_SHAPES = [(13, 12), (70, 66), (10, 65)]


@pytest.mark.parametrize("shape", LINE_SHAPES,
                         ids=["-".join(map(str, s)) for s in LINE_SHAPES])
@NINE
@GRID
def test_lines_periodic(shape, nine, per):
    """Zebra x- and y-line sweeps: cyclic along a periodic axis (the
    Sherman–Morrison solve on the length rule's solver), the rhs wrapped
    across one; lines across an odd periodic extent raise."""
    so, q, b = case(shape, nine, per, 8)
    k, jk = kinds(nine)
    jso = jnp.asarray(so)
    for axis, across, n in (("x", per[1], shape[1]), ("y", per[0], shape[0])):
        relax = lines2.line_relax_x if axis == "x" else lines2.line_relax_y
        jrelax = jlines2.line_relax_x if axis == "x" else jlines2.line_relax_y
        if across and n % 2:
            with pytest.raises(ValueError, match="even number of lines"):
                relax(torch.tensor(so), torch.tensor(q), torch.tensor(b),
                      None, k, "down", per)
            continue
        sor = jlines2.setup_lines(jso, jk, axis)
        for updown in ("down", "up"):
            got = relax(torch.tensor(so), torch.tensor(q), torch.tensor(b),
                        None, k, updown, per)
            close(got, jrelax(jso, jnp.asarray(q), jnp.asarray(b), sor, jk,
                              updown, per))


def test_cyclic_solve_is_exact():
    """Each cyclic system solved by cyclic_solve (both length rules): the
    cyclic matrix times the solution gives the rhs back."""
    rng = np.random.default_rng(9)
    for n in (16, 70):
        lo = -torch.tensor(rng.uniform(0.5, 1.5, (n, 5)))
        dg = torch.tensor(rng.uniform(3.0, 4.0, (n, 5)))
        r = torch.tensor(rng.standard_normal((n, 5)))
        wrap = lo[0].clone()
        lo_in = lo.clone()
        lo_in[0] = 0.0
        up = torch.zeros_like(lo)
        up[:-1] = lo[1:]
        x = lines2.cyclic_solve(lo_in, dg, up, wrap, r)
        ax = dg * x + lo_in * torch.roll(x, 1, 0) + up * torch.roll(x, -1, 0)
        ax[0] += wrap * x[-1]
        ax[-1] += wrap * x[0]
        np.testing.assert_allclose(ax.numpy(), r.numpy(), atol=1e-12)


def test_odd_lines_raise_before_launch():
    """The kernel wrappers refuse an odd line count across a periodic axis
    before they check or launch anything, the plain versions too."""
    so, q, b = case((16, 9), False, (False, True), 10)
    tso, tq, tb = (torch.tensor(a) for a in (so, q, b))
    for fn in (cuda_lines2.line_x, cuda_lines2.line_x_plain):
        with pytest.raises(ValueError, match="even number of lines"):
            fn(tso, tq, tb, StencilKind.five_pt, "down", periodic=(True, True))
    so, q, b = case((9, 16), False, (True, False), 10)
    tso, tq, tb = (torch.tensor(a) for a in (so, q, b))
    for fn in (cuda_lines2.line_y, cuda_lines2.line_y_plain):
        with pytest.raises(ValueError, match="even number of lines"):
            fn(tso, tq, tb, StencilKind.five_pt, "up", periodic=(True, False))
    assert torch.equal(tq, torch.tensor(q))


def test_plain_k1_against_pallas_periodic(monkeypatch):
    """The plain K1 in its periodic mode against the Pallas sweep's
    periodic mode in interpret mode, float32, rtol 1e-5 (the tolerance of
    tests/test_periodic_2d.py:231, which holds the Pallas sweep against
    XLA), at 64x256, 5- and 9-point, x-, y- and doubly periodic, DOWN and
    UP and with the residual."""
    from cedar_tpu.ops import pallas2

    monkeypatch.setattr(pallas2, "INTERPRET", True)
    nx, ny = 64, 256
    for nine in (False, True):
        k, jk = kinds(nine)
        for i, per in enumerate(PERIODIC):
            so, q, b = (a.astype(np.float32)
                        for a in case((nx, ny), nine, per, 20 + i))
            jso = jnp.asarray(so)
            recip = jrelax2.setup_recip(jso)
            tso, tq, tb = (torch.tensor(a) for a in (so, q, b))
            for updown in ("down", "up"):
                want = pallas2.point_relax(jso, jnp.asarray(q),
                                           jnp.asarray(b), recip, jk, updown,
                                           periodic=per)
                got = cuda2.sweep_plain(tso, tq, tb, k, updown,
                                        periodic=per)
                close(got, want, rtol=1e-5)
            want, wres = pallas2.point_relax(
                jso, jnp.asarray(q), jnp.asarray(b), recip, jk, "down",
                fuse_residual=True, periodic=per)
            got, res = cuda2.sweep_plain(tso, tq, tb, k, "down", True,
                                         periodic=per)
            close(got, want, rtol=1e-5)
            close(res, wres, rtol=1e-5)
