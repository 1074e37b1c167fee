"""The port's fused fine-level ops (plain versions of kernels K11-K13, and
K3 for ``interp_add_split``) against cedar_tpu: the Pallas split kernels
in interpret mode in float32, on the lane-split operands the JAX package
builds (``split_so``, ``lane_split``, ``pad_ci``, ``setup_rec2``) and
merged back with ``lane_merge``; and the dense XLA composition (sweep,
``residual``, ``interp2.restrict``, ``interp2.interp_add``) in float64 at
odd and tiny shapes.

The f32 tolerance, atol 2e-5 · max|ref| on q, res and cb and rtol 1e-5 on
the norm, is looser than bit-equal: the Pallas kernels multiply by 1/diag
where the port divides, and XLA:CPU contracts FMAs differently.  The CUDA
kernels themselves run only on the card; chip_smoke.py holds them against
the plain versions checked here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import interp2 as jinterp2
from cedar_tpu.ops import pallas2, pallas2_split as ps
from cedar_tpu.ops import pallas_transfer2 as pt
from cedar_tpu.ops import relax2 as jrelax2
from cedar_tpu.ops.stencil2 import residual as jresidual

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_fused2, cuda_transfer2, fused2, relax2

torch.set_num_threads(2)

# Torch inputs are copies (torch.tensor): JAX on the CPU may share a numpy
# buffer and read it asynchronously.

F32_SHAPES = [(128, 200), (256, 256)]
F64_SHAPES = [(33, 47), (65, 65), (5, 4)]


@pytest.fixture
def interpret(monkeypatch):
    for mod in (pallas2, ps, pt):
        monkeypatch.setattr(mod, "INTERPRET", True)


def _kinds(nine):
    return ((StencilKind.nine_pt, JKind.nine_pt) if nine
            else (StencilKind.five_pt, JKind.five_pt))


def _problem(seed, shape, nine, dtype):
    """so, q, b, the coarse CI (cedar_tpu's setup) and a coarse qc."""
    from test_kernels_2d import random_so

    rng = np.random.default_rng(seed)
    so = random_so(rng, *shape, nine).astype(dtype)
    q = rng.standard_normal(shape).astype(dtype)
    b = rng.standard_normal(shape).astype(dtype)
    _, jkind = _kinds(nine)
    ci = np.asarray(jinterp2.setup_interp(jnp.asarray(so), jkind)).astype(
        dtype)
    qc = rng.standard_normal((ci.shape[1] - 1, ci.shape[2] - 1)).astype(
        dtype)
    return so, q, b, ci, qc


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _close32(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))


class _Split:
    """The JAX package's split operands of one problem."""

    def __init__(self, so, q, b, ci, jkind):
        nx, ny = q.shape
        self.shape = (nx, ny)
        self.nxp, self.W, _ = ps.split_dims(nx, ny)
        self.so2 = ps.split_so(jnp.asarray(so), jkind, self.nxp, self.W)
        self.q2 = self.split(q)
        self.b2 = self.split(b)
        self.cip = pt.pad_ci(jnp.asarray(ci), nx, ny)

    def split(self, a):
        return ps.lane_split(jnp.asarray(a), self.nxp, self.W)

    def merge(self, a2):
        return np.asarray(ps.lane_merge(a2, *self.shape))


# --- float32 against the Pallas split kernels in interpret mode ------------

@pytest.mark.parametrize("shape", F32_SHAPES)
@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_point_relax_split_matches_pallas_f32(shape, nine, updown,
                                              interpret):
    so, q, b, ci, _ = _problem(41 + nine, shape, nine, np.float32)
    kind, jkind = _kinds(nine)
    sp = _Split(so, q, b, ci, jkind)
    tso, tq, tb = _t(so, q, b)
    want_q2, want_r2 = ps.point_relax_split(sp.so2, sp.q2, sp.b2, jkind,
                                            updown, fuse_residual=True)
    got_q, got_r = fused2.point_relax_split(tso, tq, tb, kind, updown,
                                            fuse_residual=True)
    _close32(got_q, sp.merge(want_q2))
    _close32(got_r, sp.merge(want_r2))
    np.testing.assert_array_equal(tq.numpy(), q)   # out of place
    _, want_p = ps.point_relax_split(sp.so2, sp.q2, sp.b2, jkind, updown,
                                     fuse_norm=True)
    got_q2, got_p = fused2.point_relax_split(tso, tq, tb, kind, updown,
                                             fuse_norm=True)
    assert torch.equal(got_q2, got_q) and got_p.shape == (1,)
    np.testing.assert_allclose(float(got_p.sum()), float(jnp.sum(want_p)),
                               rtol=1e-5)
    got = fused2.point_relax_split(tso, tq, tb, kind, updown)
    assert torch.equal(got, got_q)


@pytest.mark.parametrize("nine", [False, True])
def test_point_relax_split_origin_matches_pallas_f32(nine, interpret):
    """A nonzero origin anchors the colours to global indices (the split
    kernel takes only even column origins for 9-point)."""
    so, q, b, ci, _ = _problem(43 + nine, (128, 200), nine, np.float32)
    kind, jkind = _kinds(nine)
    sp = _Split(so, q, b, ci, jkind)
    origin = (1, 2)
    want = ps.point_relax_split(sp.so2, sp.q2, sp.b2, jkind, "down",
                                origin=jnp.asarray(origin, jnp.int32))
    got = fused2.point_relax_split(*_t(so, q, b), kind, "down",
                                   origin=origin)
    _close32(got, sp.merge(want))


@pytest.mark.parametrize("shape", F32_SHAPES)
@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_sweep_restrict_split_matches_pallas_f32(shape, nine, updown,
                                                 interpret):
    so, q, b, ci, _ = _problem(47 + nine, shape, nine, np.float32)
    kind, jkind = _kinds(nine)
    sp = _Split(so, q, b, ci, jkind)
    nc = (ci.shape[1] - 1, ci.shape[2] - 1)
    for emit in (True, False):
        wq2, wr2, wcb = pt.sweep_restrict_split(
            sp.so2, sp.q2, sp.b2, sp.cip, jkind, updown, nc, emit_res=emit)
        gq, gr, gcb = fused2.sweep_restrict_split(*_t(so, q, b, ci), kind,
                                                  updown, emit_res=emit)
        _close32(gq, sp.merge(wq2))
        _close32(gcb, wcb)
        if emit:
            _close32(gr, sp.merge(wr2))
        else:
            assert gr is None and wr2 is None


@pytest.mark.parametrize("shape", F32_SHAPES)
@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_interp_sweep_split_matches_pallas_f32(shape, nine, updown,
                                               interpret):
    so, q, b, ci, qc = _problem(53 + nine, shape, nine, np.float32)
    kind, jkind = _kinds(nine)
    sp = _Split(so, q, b, ci, jkind)
    tci, tqc, tso, tb, tq = _t(ci, qc, so, b, q)
    jqc = jnp.asarray(qc)
    want = pt.interp_sweep_split(sp.cip, jqc, sp.so2, sp.b2, sp.q2, jkind,
                                 updown)
    got = fused2.interp_sweep_split(tci, tqc, tso, tb, tq, kind, updown)
    _close32(got, sp.merge(want))
    np.testing.assert_array_equal(tq.numpy(), q)   # out of place
    wq, wr = pt.interp_sweep_split(sp.cip, jqc, sp.so2, sp.b2, sp.q2, jkind,
                                   updown, fuse_residual=True)
    gq, gr = fused2.interp_sweep_split(tci, tqc, tso, tb, tq, kind, updown,
                                       fuse_residual=True)
    assert torch.equal(gq, got)
    _close32(gr, sp.merge(wr))
    _, wp = pt.interp_sweep_split(sp.cip, jqc, sp.so2, sp.b2, sp.q2, jkind,
                                  updown, fuse_norm=True)
    gq, gp = fused2.interp_sweep_split(tci, tqc, tso, tb, tq, kind, updown,
                                       fuse_norm=True)
    assert torch.equal(gq, got)
    np.testing.assert_allclose(float(gp.sum()), float(jnp.sum(wp)),
                               rtol=1e-5)


@pytest.mark.parametrize("shape", F32_SHAPES)
@pytest.mark.parametrize("nine", [False, True])
def test_interp_add_split_matches_pallas_f32(shape, nine, interpret):
    so, q, b, ci, qc = _problem(59 + nine, shape, nine, np.float32)
    kind, jkind = _kinds(nine)
    res = b   # any fine-grid array serves as the residual here
    jso = jnp.asarray(so)
    res2 = pt.lane_split_res(jnp.asarray(res))
    nxp, W = res2.shape[1], res2.shape[2]
    want2 = pt.interp_add_split(pt.pad_ci(jnp.asarray(ci), *shape),
                                pt.setup_rec2(jso), jnp.asarray(qc), res2,
                                ps.lane_split(jnp.asarray(q), nxp, W))
    tq = torch.tensor(q)
    got = fused2.interp_add_split(*_t(ci, so, qc, res), tq)
    assert got is tq   # in place, as interp2.interp_add
    _close32(got, ps.lane_merge(want2, *shape))


# --- float64 against the dense XLA composition -----------------------------

def _dense_sweep(so, q, b, jkind, updown):
    jso = jnp.asarray(so)
    return jrelax2.point_relax(jso, jnp.asarray(q), jnp.asarray(b),
                               jrelax2.setup_recip(jso), jkind, updown)


def _close64(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-13 * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", F64_SHAPES)
@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_fused_ops_match_dense_jax_f64(shape, nine, updown):
    so, q, b, ci, qc = _problem(61 + nine + shape[0], shape, nine,
                                np.float64)
    kind, jkind = _kinds(nine)
    jso, jb = jnp.asarray(so), jnp.asarray(b)
    tso, tq, tb, tci, tqc = _t(so, q, b, ci, qc)

    # point_relax_split: the sweep, its residual, the norm
    want_q = _dense_sweep(so, q, b, jkind, updown)
    want_r = jresidual(jso, want_q, jb, jkind)
    got_q, got_r = fused2.point_relax_split(tso, tq, tb, kind, updown,
                                            fuse_residual=True)
    _close64(got_q, want_q)
    _close64(got_r, want_r)
    _, got_p = fused2.point_relax_split(tso, tq, tb, kind, updown,
                                        fuse_norm=True)
    np.testing.assert_allclose(float(got_p.sum()),
                               float(jnp.sum(want_r * want_r)), rtol=1e-12)

    # sweep_restrict_split: the sweep, its residual, cb = Pᵀ res
    gq, gr, gcb = fused2.sweep_restrict_split(tso, tq, tb, tci, kind, updown)
    _close64(gq, want_q)
    _close64(gr, want_r)
    _close64(gcb, jinterp2.restrict(jnp.asarray(ci), want_r))

    # interp_sweep_split: res of q_pre, interp_add, a sweep (+ res / norm)
    jq = jnp.asarray(q)
    mid = jinterp2.interp_add(jnp.asarray(ci), jso, jnp.asarray(qc),
                              jresidual(jso, jq, jb, jkind), jq)
    want_q = _dense_sweep(so, np.asarray(mid), b, jkind, updown)
    want_r = jresidual(jso, want_q, jb, jkind)
    gq, gr = fused2.interp_sweep_split(tci, tqc, tso, tb, tq, kind, updown,
                                       fuse_residual=True)
    _close64(gq, want_q)
    _close64(gr, want_r)
    _, gp = fused2.interp_sweep_split(tci, tqc, tso, tb, tq, kind, updown,
                                      fuse_norm=True)
    np.testing.assert_allclose(float(gp.sum()),
                               float(jnp.sum(want_r * want_r)), rtol=1e-12)

    # interp_add_split: interp2.interp_add
    want = jinterp2.interp_add(jnp.asarray(ci), jso, jnp.asarray(qc), jb, jq)
    _close64(fused2.interp_add_split(tci, tso, tqc, tb, tq.clone()), want)
    np.testing.assert_array_equal(tq.numpy(), q)


# --- dispatch, counters and checks -----------------------------------------

def test_cpu_dispatch_uses_plain_versions():
    so, q, b, ci, qc = _problem(71, (9, 11), False, np.float64)
    kind = StencilKind.five_pt
    tso, tq, tb, tci, tqc = _t(so, q, b, ci, qc)
    names = ("sweep", "sweep_restrict", "interp_sweep")
    plain = [getattr(cuda_fused2, f"{n}_plain_calls") for n in names]
    launches = [getattr(cuda_fused2, f"{n}_launches") for n in names]
    fused2.point_relax_split(tso, tq, tb, kind, "down")
    fused2.sweep_restrict_split(tso, tq, tb, tci, kind, "down")
    fused2.interp_sweep_split(tci, tqc, tso, tb, tq, kind, "up")
    for n, p, k in zip(names, plain, launches):
        assert getattr(cuda_fused2, f"{n}_plain_calls") == p + 1
        assert getattr(cuda_fused2, f"{n}_launches") == k
    k3 = cuda_transfer2.interp_plain_calls
    fused2.interp_add_split(tci, tso, tqc, tb, tq)
    assert cuda_transfer2.interp_plain_calls == k3 + 1


def test_kernel_wrappers_refuse_cpu_tensors():
    so, q, b, ci, qc = _problem(72, (9, 11), True, np.float64)
    kind = StencilKind.nine_pt
    tso, tq, tb, tci, tqc = _t(so, q, b, ci, qc)
    with pytest.raises(ValueError, match="not on CUDA"):
        cuda_fused2.sweep(tso, tq, tb, kind, "down")
    with pytest.raises(ValueError, match="not on CUDA"):
        cuda_fused2.sweep_restrict(tso, tq, tb, tci, kind, "down")
    with pytest.raises(ValueError, match="not on CUDA"):
        cuda_fused2.interp_sweep(tci, tqc, tso, tb, tq, kind, "down")


@pytest.mark.parametrize("bad", ["kind", "batch", "so", "ci", "qc"])
def test_fused_checks(bad):
    so, q, b, ci, qc = _problem(73, (9, 11), False, np.float64)
    tso, tq, tb, tci, tqc = _t(so, q, b, ci, qc)
    kind = StencilKind.five_pt
    if bad == "kind":
        kind = StencilKind.seven_pt
    elif bad == "batch":
        tq, tb = tq[None], tb[None]
    elif bad == "so":
        tso = tso[:, :, :10]
    elif bad == "ci":
        tci = tci[:, :, :4]
    elif bad == "qc":
        tqc = tqc[:, :5]
    with pytest.raises(ValueError):
        if bad == "qc":
            cuda_fused2.interp_sweep_plain(tci, tqc, tso, tb, tq, kind, "up")
        elif bad == "ci":
            cuda_fused2.sweep_restrict_plain(tso, tq, tb, tci, kind, "down")
        else:
            cuda_fused2.sweep_plain(tso, tq, tb, kind, "down")


@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_colour_codes_follow_color_order(nine, updown):
    """The kernels' packed colour sequence (relax2.pack_colors, which K1
    and K11-K13 take) is relax2.color_order's."""
    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    packed, n = relax2.pack_colors(kind, updown)
    codes = [(packed >> (4 * k)) & 15 for k in range(n)]
    want = [2 * c[0] + c[1] if nine else c
            for c in relax2.color_order(kind, updown)]
    assert codes == want
