"""The port's 3D stencil ops and multicolour sweep (plain version of kernel
K6) against cedar_tpu: the XLA sweep and residual in float64, the Pallas
sweep kernel in interpret mode in float32 (the tolerances of
tests/test_pallas_3d.py), and the Fortran transcription of
tests/oracles3.py.

The CUDA kernels themselves run only on the card; chip_smoke.py holds
them against the plain version checked here.  Both return the sweep in a
new tensor and leave q as it was.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles3 as orc
from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import pallas3
from cedar_tpu.ops import relax3 as jrelax3
from cedar_tpu.ops import stencil3 as jstencil3

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda3, cuda_fused3, relax3, stencil3

torch.set_num_threads(2)

# Torch inputs are copies (torch.tensor): JAX on the CPU may share the
# numpy buffer and read it asynchronously.


def _problem(seed, shape, ts, dtype=np.float64):
    from test_kernels_3d import random_so

    rng = np.random.default_rng(seed)
    so = random_so(rng, *shape, ts).astype(dtype)
    q = rng.standard_normal(shape).astype(dtype)
    b = rng.standard_normal(shape).astype(dtype)
    return so, q, b


def _kinds(ts):
    return ((StencilKind.twenty_seven_pt, JKind.twenty_seven_pt) if ts
            else (StencilKind.seven_pt, JKind.seven_pt))


@pytest.mark.parametrize("shape", [(8, 8, 8), (9, 7, 6)])
@pytest.mark.parametrize("ts", [False, True])
def test_stencil3_matches_jax(shape, ts):
    so, q, b = _problem(5 + ts, shape, ts)
    kind, jkind = _kinds(ts)
    jso, jq, jb = jnp.asarray(so), jnp.asarray(q), jnp.asarray(b)
    t = [torch.tensor(a) for a in (so, q, b)]
    rtol = 1e-12
    np.testing.assert_allclose(
        stencil3.residual(*t, kind).numpy(),
        np.asarray(jstencil3.residual(jso, jq, jb, jkind)), rtol=rtol)
    np.testing.assert_allclose(
        stencil3.matvec(t[0], t[1], kind).numpy(),
        np.asarray(jstencil3.matvec(jso, jq, jkind)), rtol=rtol)
    np.testing.assert_allclose(
        stencil3.offdiag_apply(t[0], t[1], kind).numpy(),
        np.asarray(jstencil3.offdiag_apply(jso, jq, jkind)), rtol=rtol)
    got = stencil3.full_offsets(t[0], kind)
    want = jstencil3.full_offsets(jso, jkind)
    assert list(got) == list(want)
    for off in want:
        np.testing.assert_array_equal(got[off].numpy(), np.asarray(want[off]))
    assert stencil3.NEIGHBOR_COUPLINGS_27 == {
        k: (int(p), s) for k, (p, s) in jstencil3.NEIGHBOR_COUPLINGS_27.items()}


@pytest.mark.parametrize("shape", [(8, 8, 8), (9, 7, 6)])
@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
@pytest.mark.parametrize("fuse", [False, True])
def test_point_relax_matches_jax_f64(shape, ts, updown, fuse):
    so, q, b = _problem(11 + shape[0] + ts, shape, ts)
    kind, jkind = _kinds(ts)
    jso = jnp.asarray(so)
    want = jrelax3.point_relax(jso, jnp.asarray(q), jnp.asarray(b),
                               jrelax3.setup_recip(jso), jkind, updown)
    tso, tq, tb = (torch.tensor(a) for a in (so, q, b))
    out = relax3.point_relax(tso, tq, tb, relax3.setup_recip(tso), kind,
                             updown, fuse_residual=fuse)
    got = out[0] if fuse else out
    assert got is not tq   # out of place
    np.testing.assert_array_equal(tq.numpy(), q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    if fuse:
        want_res = jstencil3.residual(jso, want, jnp.asarray(b), jkind)
        np.testing.assert_allclose(out[1].numpy(), np.asarray(want_res),
                                   rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("fuse", [False, True])
def test_point_relax_leaves_q_unchanged(dtype, ts, fuse, monkeypatch):
    """point_relax returns the sweep (and its residual) in new tensors and
    leaves q as it was, DOWN and UP, and equals cedar_tpu's point_relax:
    in float32 the Pallas kernel in interpret mode with an odd origin (atol
    1e-5 and 1e-4, the tolerances of the tests above), in float64 the XLA
    sweep, which takes no origin (rtol 1e-12, atol 1e-13)."""
    monkeypatch.setattr(pallas3, "INTERPRET", True)
    f32 = dtype == np.float32
    shape = ((32, 16, 40) if ts else (24, 16, 40)) if f32 else (9, 7, 6)
    so, q, b = _problem(31 + ts + 2 * fuse, shape, ts, dtype)
    kind, jkind = _kinds(ts)
    jso, jq, jb = jnp.asarray(so), jnp.asarray(q), jnp.asarray(b)
    origin = (1, 0, 1) if f32 else (0, 0, 0)
    for updown in ("down", "up"):
        tso, tq, tb = (torch.tensor(a) for a in (so, q, b))
        out = relax3.point_relax(tso, tq, tb, None, kind, updown,
                                 fuse_residual=fuse, origin=origin)
        np.testing.assert_array_equal(tq.numpy(), q)
        got_q, got_res = out if fuse else (out, None)
        assert got_q is not tq
        if f32:
            want_q, want_res = pallas3.point_relax(
                jso, jq, jb, None, updown, fuse_residual=True, kind=jkind,
                origin=jnp.asarray(origin, jnp.int32))
            np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q),
                                       atol=1e-5)
            if fuse:
                np.testing.assert_allclose(got_res.numpy(),
                                           np.asarray(want_res), atol=1e-4)
            continue
        want_q = jrelax3.point_relax(jso, jq, jb, jrelax3.setup_recip(jso),
                                     jkind, updown)
        np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q),
                                   rtol=1e-12)
        if fuse:
            np.testing.assert_allclose(
                got_res.numpy(),
                np.asarray(jstencil3.residual(jso, want_q, jb, jkind)),
                rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_color_masks_match_jax(ts, updown):
    kind, jkind = _kinds(ts)
    for shape in [(5, 7, 4), (4, 6, 3)]:
        want = jrelax3.color_masks(shape, jkind, updown)
        got = relax3.color_masks(shape, kind, updown)
        assert len(got) == len(want) == (8 if ts else 2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_point_relax_matches_pallas_interpret_f32(ts, updown, monkeypatch):
    monkeypatch.setattr(pallas3, "INTERPRET", True)
    n = (32, 16, 40) if ts else (24, 16, 40)
    so, q, b = _problem(7, n, ts, np.float32)
    kind, jkind = _kinds(ts)
    jso, jq, jb = jnp.asarray(so), jnp.asarray(q), jnp.asarray(b)
    want_q, want_res = pallas3.point_relax(jso, jq, jb, None, updown,
                                           fuse_residual=True, kind=jkind)
    got_q, got_res = relax3.point_relax(
        torch.tensor(so), torch.tensor(q), torch.tensor(b), None, kind,
        updown, fuse_residual=True)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), atol=1e-5)
    np.testing.assert_allclose(got_res.numpy(), np.asarray(want_res),
                               atol=1e-4)


@pytest.mark.parametrize("ts", [False, True])
def test_origin_anchors_colours_like_pallas(ts, monkeypatch):
    """A nonzero origin shifts the colouring to global indices, as the
    Pallas sweep does for per-shard calls."""
    monkeypatch.setattr(pallas3, "INTERPRET", True)
    n = (32, 16, 40) if ts else (24, 16, 40)
    so, q, b = _problem(9, n, ts, np.float32)
    kind, jkind = _kinds(ts)
    for origin in [(1, 2, 3), (0, 1, 0)]:
        want = pallas3.point_relax(
            jnp.asarray(so), jnp.asarray(q), jnp.asarray(b), None, "down",
            origin=jnp.asarray(origin, jnp.int32), kind=jkind)
        got = relax3.point_relax(
            torch.tensor(so), torch.tensor(q), torch.tensor(b), None, kind,
            "down", origin=origin)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_point_relax_matches_fortran_oracle(ts, updown):
    shape = (9, 7, 6)
    so, q, b = _problem(17 + ts, shape, ts)
    kind, _ = _kinds(ts)
    want = orc.relax_gs(orc.pad_ghost_so(so), orc.pad_ghost(q),
                        orc.pad_ghost(b), orc.pad_ghost(1.0 / so[orc.KP]),
                        14 if ts else 4, updown)
    got = relax3.point_relax(*(torch.tensor(a) for a in (so, q, b)), None,
                             kind, updown)
    np.testing.assert_allclose(got.numpy(), orc.unpad(want), atol=1e-12)


def test_origin_parity_only():
    """Only the origin's parity matters; an even shift is the identity."""
    so, q, b = _problem(21, (7, 6, 5), True)
    kind = StencilKind.twenty_seven_pt
    t = [torch.tensor(a) for a in (so, q, b)]
    base = relax3.sweep3_torch(*t, None, kind, "down")
    even = relax3.sweep3_torch(*t, None, kind, "down", origin=(2, -4, 6))
    odd = relax3.sweep3_torch(*t, None, kind, "down", origin=(0, 0, 1))
    np.testing.assert_array_equal(base.numpy(), even.numpy())
    assert not torch.equal(base, odd)


def test_cpu_dispatch_uses_plain_version():
    so, q, b = _problem(22, (6, 6, 6), False)
    t = [torch.tensor(a) for a in (so, q, b)]
    launches = (cuda3.launches, cuda3.resident_launches,
                cuda_fused3.sweep_launches)
    plain = cuda3.plain_calls
    relax3.point_relax(t[0], t[1], t[2], None, StencilKind.seven_pt, "down")
    assert cuda3.plain_calls == plain + 1
    assert (cuda3.launches, cuda3.resident_launches,
            cuda_fused3.sweep_launches) == launches


def test_kernel_wrapper_refuses_cpu_tensors():
    so, q, b = _problem(23, (6, 6, 6), False)
    t = [torch.tensor(a) for a in (so, q, b)]
    with pytest.raises(ValueError, match="not on CUDA"):
        cuda3.sweep(*t, StencilKind.seven_pt, "down")


@pytest.mark.parametrize("bad", ["kind", "shape", "alias", "view", "dtype"])
def test_sweep_checks(bad):
    so, q, b = _problem(24, (6, 6, 6), False)
    so, q, b = (torch.tensor(a) for a in (so, q, b))
    kind = StencilKind.seven_pt
    if bad in ("alias", "view"):
        # q sharing storage with b or so: every kernel writes a new tensor,
        # so no launch reads what it writes; the sweep equals the one of
        # copies and leaves its inputs as they were
        if bad == "alias":
            b = q
        else:
            q = so[1]
        so0, q0, b0 = so.clone(), q.clone(), b.clone()
        got = cuda3.sweep_plain(so, q, b, kind, "down", True)
        want = cuda3.sweep_plain(so0, q0.clone(), b0.clone(), kind, "down",
                                 True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert (torch.equal(so, so0) and torch.equal(q, q0)
                and torch.equal(b, b0))
        return
    if bad == "kind":
        kind = StencilKind.nine_pt
    elif bad == "shape":
        b = b[:, :, :5]
    elif bad == "dtype":
        so, q, b = (a.to(torch.float16) for a in (so, q, b))
        with pytest.raises(TypeError, match="float32 or float64"):
            cuda3.sweep(so, q, b, kind, "down")
        return
    with pytest.raises(ValueError):
        cuda3.sweep_plain(so, q, b, kind, "down")
