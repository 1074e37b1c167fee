"""The batched 2D ops of plane relaxation and the plain version of kernel
K10 (the batched whole line-xy smooth).

* Every 2D op on a batch of planes (stencil ``(ndir, B, nx, ny)``, grids
  ``(B, nx, ny)``, CI ``(8, B, …)``) equals the unbatched op applied plane
  by plane, bit for bit, and a batch of one equals the unbatched call.
* K10's plain version against cedar_tpu's composed zebra line sweeps per
  plane plus ``stencil2.residual`` in float64, and against the Pallas
  kernel (``pallas_planes2``) in interpret mode in float32, batched and
  vmapped (the tolerances of tests/test_pallas_planes2.py).

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against the plain version checked here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import lines2 as jlines2
from cedar_tpu.ops import pallas_lines2 as pla
from cedar_tpu.ops import pallas_planes2 as pp
from cedar_tpu.ops.stencil2 import residual as jresidual

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import (
    cg, cuda_planes2, galerkin2, interp2, lines2, planes2, stencil2,
)
from cedar_tpu_torch.solver import solver2
from cedar_tpu_torch.settings import MLSettings, RelaxType

torch.set_num_threads(2)

# Torch inputs are copies (torch.tensor): the port writes q in place, and
# JAX on the CPU may share the numpy buffer and read it asynchronously.


def _batch(seed, B, nx, ny, nine, dtype=np.float64):
    """B random diagonally dominant planes: so (ndir, B, nx, ny), q, b."""
    from test_kernels_2d import random_so

    rng = np.random.default_rng(seed)
    so = np.stack([random_so(rng, nx, ny, nine) for _ in range(B)], axis=1)
    q = rng.standard_normal((B, nx, ny))
    b = rng.standard_normal((B, nx, ny))
    return so.astype(dtype), q.astype(dtype), b.astype(dtype)


def _kinds(nine):
    return ((StencilKind.nine_pt, JKind.nine_pt) if nine
            else (StencilKind.five_pt, JKind.five_pt))


def _per_plane(fn, *batched):
    """``fn`` applied plane by plane to batched tensors; plane index axis:
    1 for stencils / CI / factors (ndim 4), 0 for grids."""
    B = next(t.shape[1] if t.ndim == 4 else t.shape[0] for t in batched)
    outs = []
    for i in range(B):
        args = [t[:, i] if t.ndim == 4 else t[i] for t in batched]
        outs.append(fn(*[a.contiguous() for a in args]))
    return outs


SHAPES = [(3, 11, 9), (2, 10, 12), (3, 4, 3)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("nine", [False, True])
def test_batched_ops_equal_plane_by_plane(shape, nine):
    B, nx, ny = shape
    kind = _kinds(nine)[0]
    so, q, b = (torch.tensor(a) for a in _batch(7 + nx + nine, B, nx, ny,
                                                 nine))
    checks = {}
    checks["residual"] = (stencil2.residual(so, q, b, kind), _per_plane(
        lambda s, qq, bb: stencil2.residual(s, qq, bb, kind), so, q, b))
    ci = interp2.setup_interp(so, kind)
    checks["setup_interp"] = (ci, _per_plane(
        lambda s: interp2.setup_interp(s, kind), so))
    checks["restrict"] = (interp2.restrict(ci, b), _per_plane(
        interp2.restrict, ci, b))
    rng = np.random.default_rng(5)
    qc = torch.tensor(rng.standard_normal((B, ci.shape[2] - 1,
                                           ci.shape[3] - 1)))
    checks["interp_add"] = (
        interp2.interp_add(ci, so, qc, b, q.clone()),
        _per_plane(lambda c, s, qq, rr, x: interp2.interp_add(c, s, qq, rr, x),
                   ci, so, qc, b, q.clone()))
    cso = galerkin2.coarsen_op(ci, so, kind)
    checks["coarsen_op"] = (cso, _per_plane(
        lambda c, s: galerkin2.coarsen_op(c, s, kind), ci, so))
    ainv = cg.setup_cg_lu(cso, StencilKind.nine_pt)
    ainv_planes = _per_plane(
        lambda s: cg.setup_cg_lu(s, StencilKind.nine_pt), cso)
    assert torch.equal(ainv, torch.stack(ainv_planes))
    cb = checks["restrict"][0]
    got = cg.solve_cg(ainv, cb)
    want = torch.stack([cg.solve_cg(ainv_planes[i], cb[i].contiguous())
                        for i in range(B)])
    # a batched product (bmm) against a matrix-vector product (mv): two
    # library calls that sum in their own orders, so equal to rounding
    torch.testing.assert_close(got, want, rtol=1e-13,
                               atol=1e-15 * float(want.abs().max()))
    for axis in ("x", "y"):
        sor = lines2.setup_lines(so, kind, axis)
        checks[f"setup_lines {axis}"] = (sor, _per_plane(
            lambda s: lines2.setup_lines(s, kind, axis), so))
        sweep = lines2.sweep_x_torch if axis == "x" else lines2.sweep_y_torch
        for updown in ("down", "up"):
            checks[f"sweep {axis} {updown}"] = (
                sweep(so, q.clone(), b, sor, kind, updown),
                _per_plane(lambda s, qq, bb, f: sweep(s, qq, bb, f, kind,
                                                      updown),
                           so, q.clone(), b, sor))
    for name, (got, planes) in checks.items():
        want = torch.stack(planes, dim=1 if got.ndim == 4 else 0)
        assert torch.equal(got, want), name


@pytest.mark.parametrize("nine", [False, True])
def test_batch_of_one_equals_unbatched(nine):
    """A batch of one plane computes exactly the unbatched op."""
    kind = _kinds(nine)[0]
    so, q, b = (torch.tensor(a) for a in _batch(3 + nine, 1, 13, 10, nine))
    so1, q1, b1 = so[:, 0].contiguous(), q[0].clone(), b[0].clone()
    ci, ci1 = interp2.setup_interp(so, kind), interp2.setup_interp(so1, kind)
    assert torch.equal(ci[:, 0], ci1)
    assert torch.equal(interp2.restrict(ci, b)[0], interp2.restrict(ci1, b1))
    cso = galerkin2.coarsen_op(ci, so, kind)
    cso1 = galerkin2.coarsen_op(ci1, so1, kind)
    assert torch.equal(cso[:, 0], cso1)
    assert torch.equal(cg.setup_cg_lu(cso, StencilKind.nine_pt)[0],
                       cg.setup_cg_lu(cso1, StencilKind.nine_pt))
    settings = MLSettings()
    settings.relaxation = RelaxType.line_xy
    hier = solver2.setup_hierarchy(so, kind, 3, settings)
    hier1 = solver2.setup_hierarchy(so1, kind, 3, settings)
    for lev, lev1 in zip(hier, hier1):
        for field in ("so", "ci", "sor_x", "sor_y"):
            a, a1 = getattr(lev, field), getattr(lev1, field)
            assert (a is None) == (a1 is None)
            if a is not None:
                idx = (slice(None), 0) if a.ndim == a1.ndim + 1 else 0
                assert torch.equal(a[idx], a1), field
    got = planes2.line_xy_nsmooth_res(so, q.clone(), b, kind, "down", 2)
    q2 = q1.clone()
    for _ in range(2):
        lines2.sweep_x_torch(so1, q2, b1, None, kind, "down")
        lines2.sweep_y_torch(so1, q2, b1, None, kind, "down")
    assert torch.equal(got[0][0], q2)
    assert torch.equal(got[1][0], stencil2.residual(so1, q2, b1, kind))


def _ref_smooth(so, q, b, kind, updown):
    """cedar_tpu's composed zebra line sweeps (tests/test_pallas_planes2)."""
    sx = jlines2.setup_lines(so, kind, "x")
    sy = jlines2.setup_lines(so, kind, "y")
    if updown == "down":
        q = jlines2.line_relax_x(so, q, b, sx, kind, updown)
        return jlines2.line_relax_y(so, q, b, sy, kind, updown)
    q = jlines2.line_relax_y(so, q, b, sy, kind, updown)
    return jlines2.line_relax_x(so, q, b, sx, kind, updown)


@pytest.mark.parametrize("shape", [(2, 12, 9), (2, 9, 14), (2, 5, 3)])
@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_plain_smooth_matches_jax_lines_f64(shape, nine, updown):
    """One and two smooths (+ the residual) against cedar_tpu's zebra line
    sweeps composed plane by plane, then its ``stencil2.residual``."""
    B, nx, ny = shape
    kind, jkind = _kinds(nine)
    so, q, b = _batch(11 + nx + nine, B, nx, ny, nine)
    ref = jax.jit(_ref_smooth, static_argnums=(3, 4))
    wants = [[jnp.asarray(q[i])] for i in range(B)]
    for i in range(B):
        for _ in range(2):
            wants[i].append(ref(jnp.asarray(so[:, i]), wants[i][-1],
                                jnp.asarray(b[i]), jkind, updown))
    for nsweeps in (1, 2):
        tq = torch.tensor(q)
        before = cuda_planes2.plain_calls
        got, res = planes2.line_xy_nsmooth_res(torch.tensor(so), tq,
                                               torch.tensor(b), kind, updown,
                                               nsweeps)
        assert got is tq and cuda_planes2.plain_calls == before + 1
        for i in range(B):
            want = np.asarray(wants[i][nsweeps])
            wres = np.asarray(jresidual(jnp.asarray(so[:, i]),
                                        jnp.asarray(want),
                                        jnp.asarray(b[i]), jkind))
            np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-12,
                                       atol=1e-14 * float(np.abs(want).max()))
            np.testing.assert_allclose(res[i].numpy(), wres, rtol=1e-12,
                                       atol=1e-12 * float(np.abs(wres).max()))
        # line_xy_smooth is the same smooth without the residual
        tq2 = torch.tensor(q)
        planes2.line_xy_smooth(torch.tensor(so), tq2, torch.tensor(b), kind,
                               updown, nsweeps)
        assert torch.equal(tq2, got)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pp, "INTERPRET", True)
    monkeypatch.setattr(pla, "INTERPRET", True)


@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_plain_smooth_matches_pallas_batched_f32(interpret, nine, updown):
    """Against ``pallas_planes2.line_xy_smooth_batched`` (interpret mode),
    one smooth of a (4, 24, 21) float32 batch."""
    B, nx, ny = 4, 24, 21
    kind, jkind = _kinds(nine)
    so, q, b = _batch(43 + nine, B, nx, ny, nine, np.float32)
    want = np.asarray(pp.line_xy_smooth_batched(
        jnp.asarray(np.swapaxes(so, 0, 1)), jnp.asarray(q), jnp.asarray(b),
        jkind, updown))
    got = planes2.line_xy_smooth(torch.tensor(so), torch.tensor(q),
                                 torch.tensor(b), kind, updown)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("nine, updown", [(False, "down"), (True, "up")])
def test_plain_nsmooth_res_matches_pallas_vmapped_f32(interpret, nine,
                                                      updown):
    """Against the vmapped ``pallas_planes2.line_xy_nsmooth_res``
    (interpret mode): two smooths and the residual of a (3, 32, 128)
    float32 batch."""
    B, nx, ny = 3, 32, 128
    kind, jkind = _kinds(nine)
    so, q, b = _batch(57 + nine, B, nx, ny, nine, np.float32)
    wq, wres = jax.vmap(
        lambda s, qq, bb: pp.line_xy_nsmooth_res(s, qq, bb, jkind, updown, 2)
    )(jnp.asarray(np.swapaxes(so, 0, 1)), jnp.asarray(q), jnp.asarray(b))
    got, res = planes2.line_xy_nsmooth_res(torch.tensor(so), torch.tensor(q),
                                           torch.tensor(b), kind, updown, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(wq), atol=3e-4,
                               rtol=3e-4)
    np.testing.assert_allclose(res.numpy(), np.asarray(wres), atol=3e-4,
                               rtol=3e-4)


def test_smooth_checks_operands():
    kind = StencilKind.five_pt
    so, q, b = (torch.tensor(a) for a in _batch(1, 2, 6, 5, False))
    with pytest.raises(ValueError, match="batch"):
        planes2.line_xy_smooth(so[:, 0], q[0], b[0], kind, "down")
    with pytest.raises(ValueError, match="does not fit"):
        planes2.line_xy_smooth(so[:2], q, b, kind, "down")
    with pytest.raises(ValueError, match="share storage"):
        planes2.line_xy_smooth(so, b, b, kind, "down")
    with pytest.raises(ValueError, match="seven_pt"):
        planes2.line_xy_smooth(so, q, b, StencilKind.seven_pt, "down")
