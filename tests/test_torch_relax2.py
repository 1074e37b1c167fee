"""The port's multicolour sweep (plain version of kernel K1) against
cedar_tpu: the XLA sweep plus residual in float64, and the Pallas sweep
kernel in interpret mode in float32 (the tolerances of
tests/test_pallas_2d.py).

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against the plain version checked here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import pallas2
from cedar_tpu.ops import relax2 as jrelax2
from cedar_tpu.ops.stencil2 import residual as jresidual

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda2, relax2

torch.set_num_threads(2)

# Torch inputs are copies (torch.tensor): JAX on the CPU may share the
# numpy buffer and read it asynchronously.


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


@pytest.mark.parametrize("shape", [(16, 16), (17, 9), (10, 23)])
@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
@pytest.mark.parametrize("fuse", [False, True])
def test_point_relax_matches_jax_f64(shape, nine, updown, fuse):
    so, q, b = _problem(11 + shape[0] + nine, shape, nine)
    kind, jkind = _kinds(nine)
    jso = jnp.asarray(so)
    want = jrelax2.point_relax(jso, jnp.asarray(q), jnp.asarray(b),
                               jrelax2.setup_recip(jso), jkind, updown)
    tso, tq, tb = (torch.tensor(a) for a in (so, q, b))
    out = relax2.point_relax(tso, tq, tb, relax2.setup_recip(tso), kind,
                             updown, fuse_residual=fuse)
    got = out[0] if fuse else out
    # the sweep is returned; the plain version leaves q as it was
    np.testing.assert_array_equal(tq.numpy(), q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    if fuse:
        want_res = jresidual(jso, want, jnp.asarray(b), jkind)
        np.testing.assert_allclose(out[1].numpy(), np.asarray(want_res),
                                   rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("shape", [(8, 8), (16, 16), (5, 4)])
@pytest.mark.parametrize("fuse", [False, True])
def test_sweep_result_matches_jax_9pt_f64(shape, fuse):
    """point_relax returns the sweep (and its residual) at the small
    9-point levels that the card sweeps in one block, equal to the XLA
    sweep to rtol 1e-12; q is left as it was."""
    so, q, b = _problem(41 + shape[0], shape, True)
    kind, jkind = _kinds(True)
    jso = jnp.asarray(so)
    for updown in ("down", "up"):
        want = jrelax2.point_relax(jso, jnp.asarray(q), jnp.asarray(b),
                                   jrelax2.setup_recip(jso), jkind, updown)
        tso, tq, tb = (torch.tensor(a) for a in (so, q, b))
        out = relax2.point_relax(tso, tq, tb, relax2.setup_recip(tso), kind,
                                 updown, fuse_residual=fuse)
        got = out[0] if fuse else out
        np.testing.assert_array_equal(tq.numpy(), q)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12)
        if fuse:
            want_res = jresidual(jso, want, jnp.asarray(b), jkind)
            np.testing.assert_allclose(out[1].numpy(), np.asarray(want_res),
                                       rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("shape", [(8, 8), (16, 16), (5, 4)])
@pytest.mark.parametrize("origin", [(0, 0), (1, 2)])
@pytest.mark.parametrize("fuse", [False, True])
def test_sweep_result_matches_pallas_9pt(shape, origin, fuse, monkeypatch):
    """The same against the Pallas sweep (interpret mode, float32, the
    tolerances of the tests above), with and without an origin and the
    residual, DOWN and UP."""
    monkeypatch.setattr(pallas2, "INTERPRET", True)
    so, q, b = _problem(51 + shape[0], shape, True, np.float32)
    kind, jkind = _kinds(True)
    for updown in ("down", "up"):
        want = pallas2.point_relax(
            jnp.asarray(so), jnp.asarray(q), jnp.asarray(b), None, jkind,
            updown, fuse_residual=fuse,
            origin=jnp.asarray(origin, jnp.int32))
        tq = torch.tensor(q)
        got = relax2.point_relax(torch.tensor(so), tq, torch.tensor(b), None,
                                 kind, updown, fuse_residual=fuse,
                                 origin=origin)
        np.testing.assert_array_equal(tq.numpy(), q)
        if not fuse:
            got, want = (got,), (want,)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=1e-5)
        if fuse:
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                       atol=1e-4)


@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_color_masks_match_jax(nine, updown):
    kind, jkind = _kinds(nine)
    for shape in [(5, 7), (8, 6)]:
        want = jrelax2.color_masks(shape, jkind, updown)
        got = relax2.color_masks(shape, kind, updown)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_point_relax_matches_pallas_interpret_f32(nine, updown, monkeypatch):
    monkeypatch.setattr(pallas2, "INTERPRET", True)
    n = 256
    so, q, b = _problem(3 + nine, (n, n), nine, np.float32)
    kind, jkind = _kinds(nine)
    jso, jq, jb = jnp.asarray(so), jnp.asarray(q), jnp.asarray(b)
    want_q, want_res = pallas2.point_relax(jso, jq, jb, None, jkind, updown,
                                           fuse_residual=True)
    tq = torch.tensor(q)
    got_q, got_res = relax2.point_relax(
        torch.tensor(so), tq, torch.tensor(b), None, kind, updown,
        fuse_residual=True)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), atol=1e-5)
    np.testing.assert_allclose(got_res.numpy(), np.asarray(want_res),
                               atol=1e-4)


@pytest.mark.parametrize("nine", [False, True])
def test_origin_anchors_colours_like_pallas(nine, monkeypatch):
    """A nonzero origin shifts the colouring to global indices, as the
    Pallas sweep does for per-shard calls."""
    monkeypatch.setattr(pallas2, "INTERPRET", True)
    n = 256
    so, q, b = _problem(7 + nine, (n, n), nine, np.float32)
    kind, jkind = _kinds(nine)
    for origin in [(1, 0), (0, 3), (5, 2)]:
        want = pallas2.point_relax(
            jnp.asarray(so), jnp.asarray(q), jnp.asarray(b), None, jkind,
            "down", origin=jnp.asarray(origin, jnp.int32))
        got = relax2.point_relax(
            torch.tensor(so), torch.tensor(q), torch.tensor(b),
            None, kind, "down", origin=origin)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_origin_parity_only():
    """Only the origin's parity matters; an even shift is the identity."""
    so, q, b = _problem(21, (9, 11), True)
    kind = StencilKind.nine_pt
    t = [torch.tensor(a) for a in (so, q, b)]
    base = relax2.sweep_torch(*t, None, kind, "down")
    even = relax2.sweep_torch(*t, None, kind, "down", origin=(2, -4))
    odd = relax2.sweep_torch(*t, None, kind, "down", origin=(1, 0))
    np.testing.assert_array_equal(base.numpy(), even.numpy())
    assert not torch.equal(base, odd)


def test_cpu_dispatch_uses_plain_version():
    so, q, b = _problem(22, (8, 8), False)
    t = [torch.tensor(a) for a in (so, q, b)]
    launches, plain = cuda2.launches, cuda2.plain_calls
    resident = cuda2.resident_launches
    relax2.point_relax(t[0], t[1], t[2], None, StencilKind.five_pt, "down")
    assert cuda2.plain_calls == plain + 1
    assert cuda2.launches == launches
    assert cuda2.resident_launches == resident


def test_kernel_wrapper_refuses_cpu_tensors():
    so, q, b = _problem(23, (8, 8), False)
    t = [torch.tensor(a) for a in (so, q, b)]
    with pytest.raises(ValueError, match="not on CUDA"):
        cuda2.sweep(*t, StencilKind.five_pt, "down")


@pytest.mark.parametrize("bad", ["kind", "shape", "alias", "dtype"])
def test_sweep_checks(bad):
    so, q, b = _problem(24, (8, 8), False)
    so, q, b = (torch.tensor(a) for a in (so, q, b))
    kind = StencilKind.five_pt
    if bad == "kind":
        kind = StencilKind.seven_pt
    elif bad == "shape":
        b = b[:, :7]
    elif bad == "alias":
        b = q
    elif bad == "dtype":
        so, q, b = (a.to(torch.float16) for a in (so, q, b))
        with pytest.raises(TypeError, match="float32 or float64"):
            cuda2.sweep(so, q, b, kind, "down")
        return
    with pytest.raises(ValueError):
        cuda2.sweep_plain(so, q, b, kind, "down")
