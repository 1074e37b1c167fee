"""The port's zebra line relaxation (plain versions of kernel K4) against
cedar_tpu: the PCR-then-Thomas line solve against the Pallas kernels'
solves (pure jnp) in float64, with the residual of the tridiagonal system
as an independent witness; ops.lines2 with its LDLᵀ factors in float64,
the Pallas line kernel in interpret mode in float32 (the tolerances of
tests/test_pallas_lines2.py), an independent witness (the full-stencil
residual vanishes on the lines relaxed last), and whole line-relaxation
solves against cedar_tpu's Solver2.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against the plain versions checked here.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu import Solver2 as JSolver2
from cedar_tpu import gallery as jgallery
from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import lines2 as jlines2
from cedar_tpu.ops import pallas_lines2 as pla
from cedar_tpu.ops import pallas_planes2 as pp

from cedar_tpu_torch import NinePt, FivePt, Solver2
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_lines2, lines2
from cedar_tpu_torch.ops.stencil2 import residual
from cedar_tpu_torch.solver.level import levels_from_numpy

torch.set_num_threads(2)

# Torch inputs are copies (torch.tensor): the port writes q in place, and
# JAX on the CPU may share the numpy buffer and read it asynchronously.


def _problem(seed, shape, nine, dtype=np.float64):
    from test_kernels_2d import random_so

    rng = np.random.default_rng(seed)
    so = random_so(rng, *shape, nine).astype(dtype)
    q = rng.standard_normal(shape).astype(dtype)
    b = rng.standard_normal(shape).astype(dtype)
    return so, q, b


def _kinds(nine):
    return ((StencilKind.nine_pt, JKind.nine_pt) if nine
            else (StencilKind.five_pt, JKind.five_pt))


def _relax(axis):
    return lines2.line_relax_x if axis == "x" else lines2.line_relax_y


def _tridiag(n, m, seed):
    """m random diagonally dominant tridiagonal systems of n rows along
    axis 0, in random_so's ranges: lo[i] couples row i to i-1 (lo[0] = 0),
    up[i] to i+1 (up[n-1] = 0)."""
    rng = np.random.default_rng(seed)
    e = -rng.uniform(0.5, 1.5, (n, m))
    lo, up = e.copy(), np.zeros_like(e)
    lo[0] = 0.0
    up[:-1] = e[1:]
    dg = -(lo + up) + rng.uniform(0.05, 0.2, (n, m))
    return lo, dg, up, rng.standard_normal((n, m))


def _pad_rows(h, lo, dg, up, r):
    """Pad axis 0 to a multiple of h with identity rows."""
    pad = -len(r) % h
    return [np.concatenate([a, np.full((pad,) + a.shape[1:], v)])
            for a, v in ((lo, 0.0), (dg, 1.0), (up, 0.0), (r, 0.0))]


def _shy_jnp(a, s, fill=0.0):
    """pallas_planes2._shy (a lane roll, Mosaic-only) as a plain shift."""
    return jnp.swapaxes(pp._shx(jnp.swapaxes(a, -1, -2), s, fill), -1, -2)


@pytest.mark.parametrize("n", [64, 65, 130, 256])
@pytest.mark.parametrize("ref", ["_solve_all_lines", "_solve_x", "_solve_y"])
def test_pcr_solve_matches_jax_f64(n, ref, monkeypatch):
    """lines2.pcr_solve at the port's stride against the Pallas kernels'
    PCR-then-Thomas solves (pallas_lines2._solve_all_lines along axis 0,
    pallas_planes2._solve_x / _solve_y along the last two axes, with
    _solve_y's lane roll replaced by the same shift in jnp); witness: the
    residual of the systems."""
    h = lines2.pcr_stride(n)
    assert h > 0
    lo, dg, up, r = _tridiag(n, 5, n)
    got = lines2.pcr_solve(*(torch.tensor(a) for a in (lo, dg, up, r)),
                           h).numpy()
    if ref == "_solve_all_lines":
        want = np.asarray(pla._solve_all_lines(
            *(jnp.asarray(a) for a in (lo, dg, up, r)), h))
    elif ref == "_solve_x":
        want = np.asarray(pp._solve_x(
            *(jnp.asarray(a) for a in _pad_rows(h, lo, dg, up, r)), h))[:n]
    else:
        monkeypatch.setattr(pp, "_shy", _shy_jnp)
        want = np.asarray(pp._solve_y(
            *(jnp.asarray(a.T) for a in _pad_rows(h, lo, dg, up, r)),
            h)).T[:n]
    np.testing.assert_allclose(got, want, rtol=1e-13)
    tx = dg * got
    tx[1:] += lo[1:] * got[:-1]
    tx[:-1] += up[:-1] * got[1:]
    assert np.linalg.norm(tx - r) / np.linalg.norm(r) < 1e-13


@pytest.mark.parametrize("shape", [(12, 9), (10, 13), (40, 130)])
@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("axis", ["x", "y"])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_line_relax_matches_jax_f64(shape, nine, axis, updown):
    so, q, b = _problem(31 + shape[0] + nine, shape, nine)
    kind, jkind = _kinds(nine)
    jso = jnp.asarray(so)
    jsor = jlines2.setup_lines(jso, jkind, axis)
    jrelax = jlines2.line_relax_x if axis == "x" else jlines2.line_relax_y
    want = np.asarray(jrelax(jso, jnp.asarray(q), jnp.asarray(b), jsor,
                             jkind, updown))
    tso = torch.tensor(so)
    sor = lines2.setup_lines(tso, kind, axis)
    np.testing.assert_allclose(sor.numpy(), np.asarray(jsor), rtol=1e-14)
    tq = torch.tensor(q)
    got = _relax(axis)(tso, tq, torch.tensor(b), sor, kind, updown)
    assert got is tq   # in place
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-14 * float(np.abs(want).max()))


@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("axis", ["x", "y"])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_line_relax_matches_pallas_interpret_f32(nine, axis, updown,
                                                 monkeypatch):
    monkeypatch.setattr(pla, "INTERPRET", True)
    shape = (40, 130) if axis == "x" else (130, 40)
    so, q, b = _problem(5 + nine, shape, nine, np.float32)
    kind, jkind = _kinds(nine)
    prelax = pla.line_relax_x if axis == "x" else pla.line_relax_y
    want = prelax(jnp.asarray(so), jnp.asarray(q), jnp.asarray(b), jkind,
                  updown)
    got = _relax(axis)(torch.tensor(so), torch.tensor(q), torch.tensor(b),
                       None, kind, updown)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("axis", ["x", "y"])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_last_colour_lines_solve_exactly(nine, axis, updown):
    """Independent witness: after a zebra sweep the full-stencil residual
    is zero on the lines of the colour relaxed last (their tridiagonal
    solves saw the final values of the other colour), O(1) elsewhere."""
    so, q, b = _problem(41 + nine, (10, 13), nine)
    kind, _ = _kinds(nine)
    tso, tb = torch.tensor(so), torch.tensor(b)
    x = _relax(axis)(tso, torch.tensor(q), tb, None, kind, updown)
    res = residual(tso, x, tb, kind)
    last = lines2.colour_order(updown)[1]
    on = res[:, last::2] if axis == "x" else res[last::2, :]
    off = res[:, 1 - last::2] if axis == "x" else res[1 - last::2, :]
    scale = float(tb.abs().max())
    assert float(on.abs().max()) <= 1e-12 * scale
    assert float(off.abs().max()) > 1e-2 * scale


@pytest.mark.parametrize("axis", ["x", "y"])
def test_factoring_on_the_fly_equals_workspace(axis):
    """Without factors the plain version factors as setup_lines does, so
    the setup-free path (the kernel's) rounds the same."""
    so, q, b = _problem(51, (17, 11), True)
    kind = StencilKind.nine_pt
    t = [torch.tensor(a) for a in (so, q, b)]
    sor = lines2.setup_lines(t[0], kind, axis)
    with_ws = _relax(axis)(t[0], t[1].clone(), t[2], sor, kind, "down")
    fly = _relax(axis)(t[0], t[1].clone(), t[2], None, kind, "down")
    np.testing.assert_array_equal(with_ws.numpy(), fly.numpy())


def test_cpu_dispatch_uses_plain_version():
    so, q, b = _problem(52, (8, 8), False)
    t = [torch.tensor(a) for a in (so, q, b)]
    launches, plain = cuda_lines2.launches, cuda_lines2.plain_calls
    lines2.line_relax_x(t[0], t[1], t[2], None, StencilKind.five_pt, "down")
    lines2.line_relax_y(t[0], t[1], t[2], None, StencilKind.five_pt, "up")
    assert cuda_lines2.plain_calls == plain + 2
    assert cuda_lines2.launches == launches


def test_kernel_wrappers_refuse_cpu_tensors():
    so, q, b = _problem(53, (8, 8), False)
    t = [torch.tensor(a) for a in (so, q, b)]
    for line in (cuda_lines2.line_x, cuda_lines2.line_y):
        with pytest.raises(ValueError, match="not on CUDA"):
            line(*t, StencilKind.five_pt, "down")


@pytest.mark.parametrize("bad", ["kind", "shape", "alias", "alias-so",
                                 "dtype"])
def test_line_checks(bad):
    so, q, b = _problem(54, (8, 8), False)
    so, q, b = (torch.tensor(a) for a in (so, q, b))
    kind = StencilKind.five_pt
    if bad == "kind":
        kind = StencilKind.seven_pt
    elif bad == "shape":
        b = b[:, :7]
    elif bad == "alias":
        b = q
    elif bad == "alias-so":
        q = so[2]   # a plane of so, at another offset of its storage
    elif bad == "dtype":
        so, q, b = (a.to(torch.float16) for a in (so, q, b))
        with pytest.raises(TypeError, match="float32 or float64"):
            cuda_lines2.line_y(so, q, b, kind, "down")
        return
    with pytest.raises(ValueError):
        cuda_lines2.line_x_plain(so, q, b, kind, "down")


# --- whole solves against cedar_tpu's Solver2 ------------------------------

SOLVES = {
    "line-x-diag_diffusion-64": (
        lambda: np.asarray(jgallery.diag_diffusion(64, 64, 1.0, 0.01)),
        FivePt, JKind.five_pt, "line-x"),
    "line-y-poisson-50x200": (
        lambda: np.asarray(jgallery.poisson(50, 200)),
        FivePt, JKind.five_pt, "line-y"),
    "line-xy-fe-64": (lambda: np.asarray(jgallery.fe(64, 64)),
                      NinePt, JKind.nine_pt, "line-xy"),
    "line-xy-poisson-125x93": (
        lambda: np.asarray(jgallery.poisson(125, 93)),
        FivePt, JKind.five_pt, "line-xy"),
}


@pytest.fixture(scope="module", params=list(SOLVES))
def pair(request):
    """The same problem solved by both packages (tol 1e-9, max-iter 30)."""
    make, kind, jkind, relax = SOLVES[request.param]
    so = make()
    nx, ny = so.shape[1:]
    b = np.asarray(jgallery.poisson_rhs(nx, ny))
    conf = {"log": [], "solver": {"relaxation": relax, "tol": 1e-9,
                                  "max-iter": 30}}
    js = JSolver2(jnp.asarray(so), jkind, conf)
    jx = np.asarray(js.solve(jnp.asarray(b)))
    s = Solver2(torch.tensor(so), kind, conf)
    return dict(so=so, b=b, kind=kind, js=js, jx=jx, s=s)


def test_line_solve_matches_jax(pair):
    s, js = pair["s"], pair["js"]
    b = torch.tensor(pair["b"])
    x = s.solve(b)
    assert len(s.history) == len(js.history) <= 12
    # the tolerances of test_torch_solver2.test_solve_matches_jax (the JAX
    # package solves lines of 16 points or more by SPIKE, the port by
    # Thomas: same system, other rounding)
    np.testing.assert_allclose(s.history, js.history, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(s.res0, js.res0, rtol=1e-12)
    jx = pair["jx"]
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-9,
                               atol=1e-12 * float(np.abs(jx).max()))
    r = residual(s.levels[0].so, x, b, pair["kind"])
    assert float(r.norm() / b.norm()) < 1e-9


def test_vcycle_on_jax_hierarchy_with_spike_factors(pair):
    """The JAX hierarchy carried across, SPIKE line factors and all: they
    are not converted (the port factors from ``so``), and one port cycle
    equals one JAX cycle."""
    js = pair["js"]
    assert any(isinstance(getattr(lev, f), jlines2.SpikeLines)
               for lev in js.levels for f in ("sor_x", "sor_y"))
    levels = levels_from_numpy(js.levels, dtype=torch.float64)
    assert len(levels) == len(js.levels)
    for lev, jlev in zip(levels, js.levels):
        for field in ("sor_x", "sor_y"):
            jv = getattr(jlev, field)
            assert (getattr(lev, field) is None) == (
                jv is None or isinstance(jv, jlines2.SpikeLines))
    s = copy.copy(pair["s"])
    s.levels = levels
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal(pair["b"].shape)
    want = np.asarray(js.vcycle(jnp.asarray(x0), jnp.asarray(pair["b"])))
    tx0 = torch.tensor(x0)
    got = s.vcycle(tx0, torch.tensor(pair["b"]))
    np.testing.assert_array_equal(tx0.numpy(), x0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-11,
                               atol=1e-12 * float(np.abs(want).max()))
