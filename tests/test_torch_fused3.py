"""The port's fused 3D fine-level ops (plain versions of kernels K14-K16)
against cedar_tpu: the Pallas octant-split kernels (``pallas3_split``) and
their wavefront versions (``pallas3_stream``) in interpret mode in
float32, on the split operands the JAX package builds (``split_so4``,
``split4``, ``setup_pw4``) and merged back with ``merge4``; and the dense
XLA composition (sweep, ``residual``, ``interp3.restrict``,
``interp3.interp_add``) in float64 at odd and ragged shapes.  Then the
fused ops against the port's own dense ops, bit for bit, and the
wrappers' dispatch, checks and colour passes.

The f32 tolerance, rtol = atol = 1e-5 on q, res and cb, is the JAX split
tests' (tests/test_pallas3_split.py): the Pallas kernels multiply by
1/diag where the port divides, and XLA:CPU contracts FMAs differently.
The norm partials sum in another order: rtol 1e-5 on the sum, 1e-4 on
the square root for the interpolating op, as the JAX tests hold them.
The CUDA kernels themselves run only on the card; chip_smoke.py holds
them against the plain versions checked here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import interp3 as jinterp3
from cedar_tpu.ops import pallas3, pallas3_split as p3s
from cedar_tpu.ops import pallas3_stream as p3st
from cedar_tpu.ops import pallas_transfer3
from cedar_tpu.ops import relax3 as jrelax3
from cedar_tpu.ops.stencil3 import residual as jresidual

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import (
    cuda3, cuda_fused3, cuda_transfer3, fused3, interp3, relax3, stencil3,
)

torch.set_num_threads(2)

# Torch inputs are copies (torch.tensor): JAX on the CPU may share a numpy
# buffer and read it asynchronously.

N32 = 32
F64_SHAPES = [(9, 7, 5), (17, 12, 10), (5, 4, 3)]
KW32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def interpret(monkeypatch):
    for mod in (pallas3, p3s, p3st, pallas_transfer3):
        monkeypatch.setattr(mod, "INTERPRET", True)


def _kinds(ts):
    return ((StencilKind.twenty_seven_pt, JKind.twenty_seven_pt) if ts
            else (StencilKind.seven_pt, JKind.seven_pt))


def _problem(seed, shape, ts, dtype):
    """so, q, b, the coarse CI (cedar_tpu's setup) and a coarse qc."""
    from test_kernels_3d import random_so

    rng = np.random.default_rng(seed)
    so = random_so(rng, *shape, ts).astype(dtype)
    q = rng.standard_normal(shape).astype(dtype)
    b = rng.standard_normal(shape).astype(dtype)
    _, jkind = _kinds(ts)
    ci = np.asarray(jinterp3.setup_interp(jnp.asarray(so), jkind)).astype(
        dtype)
    qc = rng.standard_normal(tuple(n - 1 for n in ci.shape[1:])).astype(
        dtype)
    return so, q, b, ci, qc


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


class _Split:
    """The JAX package's octant-split operands of one problem."""

    def __init__(self, so, q, b, ci, jkind):
        self.shape = q.shape
        self.dims = p3s.split_dims3(*q.shape)
        self.nz2 = self.dims[2]
        self.so4 = p3s.split_so4(jnp.asarray(so), jkind, self.dims)
        self.q4 = p3s.split4(jnp.asarray(q), self.dims)
        self.b4 = p3s.split4(jnp.asarray(b), self.dims)
        self.pw4 = p3s.setup_pw4(jnp.asarray(ci), q.shape, jkind)
        self.nc = tuple((n - 1) // 2 + 1 for n in q.shape)

    def merge(self, a4):
        return np.asarray(p3s.merge4(a4, *self.shape))


def _close32(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KW32)


def _setup32(seed, ts):
    so, q, b, ci, qc = _problem(seed, (N32,) * 3, ts, np.float32)
    kind, jkind = _kinds(ts)
    return so, q, b, ci, qc, kind, _Split(so, q, b, ci, jkind), jkind


# --- float32 against the Pallas split and stream kernels in interpret mode -

@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_point_relax_split3_matches_pallas_f32(ts, updown, interpret):
    so, q, b, ci, _, kind, sp, jkind = _setup32(41 + ts, ts)
    tso, tq, tb = _t(so, q, b)
    got_q, got_r = fused3.point_relax_split3(tso, tq, tb, kind, updown,
                                             fuse_residual=True)
    np.testing.assert_array_equal(tq.numpy(), q)   # out of place
    _, got_p = fused3.point_relax_split3(tso, tq, tb, kind, updown,
                                         fuse_norm=True)
    assert torch.equal(fused3.point_relax_split3(tso, tq, tb, kind, updown),
                       got_q)
    for op in (p3s.point_relax_split3, p3st.point_relax_stream3):
        wq4, wr4 = op(sp.so4, sp.q4, sp.b4, jkind, updown,
                      fuse_residual=True, nz2=sp.nz2)
        _close32(got_q, sp.merge(wq4))
        _close32(got_r, sp.merge(wr4))
        _, wp = op(sp.so4, sp.q4, sp.b4, jkind, updown, fuse_norm=True,
                   nz2=sp.nz2)
        np.testing.assert_allclose(float(got_p.sum()), float(jnp.sum(wp)),
                                   rtol=1e-5)


@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_sweep_restrict_split3_matches_pallas_f32(ts, updown, interpret):
    so, q, b, ci, _, kind, sp, jkind = _setup32(47 + ts, ts)
    gq, gr, gcb = fused3.sweep_restrict_split3(*_t(so, q, b, ci), kind,
                                               updown, emit_res=True)
    gq2, none, gcb2 = fused3.sweep_restrict_split3(*_t(so, q, b, ci), kind,
                                                   updown, emit_res=False)
    assert none is None and torch.equal(gq2, gq) and torch.equal(gcb2, gcb)
    wq4, wr4, wcb = p3s.sweep_restrict_split3(sp.so4, sp.q4, sp.b4, sp.pw4,
                                              jkind, updown, sp.nc,
                                              emit_res=True, nz2=sp.nz2)
    _close32(gq, sp.merge(wq4))
    _close32(gr, sp.merge(wr4))
    _close32(gcb, wcb)
    # the wavefront route: stream sweep + the standalone restriction
    sq4, _, scb = p3st.sweep_restrict_stream3(sp.so4, sp.q4, sp.b4, sp.pw4,
                                              jkind, updown, sp.nc,
                                              nz2=sp.nz2)
    _close32(gq, sp.merge(sq4))
    _close32(gcb, scb)


@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_interp_sweep_split3_matches_pallas_f32(ts, updown, interpret):
    so, q, b, ci, qc, kind, sp, jkind = _setup32(53 + ts, ts)
    tci, tqc, tso, tb, tq = _t(ci, qc, so, b, q)
    jqc = jnp.asarray(qc)
    got = fused3.interp_sweep_split3(tci, tqc, tso, tb, tq, kind, updown)
    np.testing.assert_array_equal(tq.numpy(), q)   # out of place
    gq, gp = fused3.interp_sweep_split3(tci, tqc, tso, tb, tq, kind, updown,
                                        fuse_norm=True)
    assert torch.equal(gq, got)
    gq, gr = fused3.interp_sweep_split3(tci, tqc, tso, tb, tq, kind, updown,
                                        fuse_residual=True)
    assert torch.equal(gq, got)
    np.testing.assert_allclose(float(gp.sum()), float((gr * gr).sum()),
                               rtol=1e-5)
    want = p3s.interp_sweep_split3(sp.pw4, jqc, sp.so4, sp.b4, sp.q4, jkind,
                                   updown, nz2=sp.nz2)
    np.testing.assert_allclose(got.numpy(), sp.merge(want), rtol=1e-5,
                               atol=5e-6)
    _, wp = p3s.interp_sweep_split3(sp.pw4, jqc, sp.so4, sp.b4, sp.q4, jkind,
                                    updown, fuse_norm=True, nz2=sp.nz2)
    np.testing.assert_allclose(float(gp.sum()) ** 0.5,
                               float(jnp.sum(wp)) ** 0.5, rtol=1e-4)
    if not ts:
        # the 7-point wavefront kernel runs the interpolation as its stage
        # 0, reading the residual the pre-sweep emitted
        res4 = p3s.split4(jresidual(jnp.asarray(so), jnp.asarray(q),
                                    jnp.asarray(b), jkind), sp.dims)
        wq, wp = p3st.interp_sweep_stream3(sp.pw4, jqc, sp.so4, sp.b4, sp.q4,
                                           jkind, updown, res4,
                                           fuse_norm=True, nz2=sp.nz2)
        np.testing.assert_allclose(gq.numpy(), sp.merge(wq), rtol=1e-5,
                                   atol=5e-6)
        np.testing.assert_allclose(float(gp.sum()) ** 0.5,
                                   float(jnp.sum(wp)) ** 0.5, rtol=1e-4)


# --- float64 against the dense XLA composition -----------------------------

def _dense_sweep(so, q, b, jkind, updown):
    jso = jnp.asarray(so)
    return jrelax3.point_relax(jso, jnp.asarray(q), jnp.asarray(b),
                               jrelax3.setup_recip(jso), jkind, updown)


def _close64(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-13 * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", F64_SHAPES)
@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_fused3_ops_match_dense_jax_f64(shape, ts, updown):
    so, q, b, ci, qc = _problem(61 + ts + shape[0], shape, ts, np.float64)
    kind, jkind = _kinds(ts)
    jso, jb, jq = jnp.asarray(so), jnp.asarray(b), jnp.asarray(q)
    tso, tq, tb, tci, tqc = _t(so, q, b, ci, qc)

    # point_relax_split3: the sweep, its residual, the norm
    want_q = _dense_sweep(so, q, b, jkind, updown)
    want_r = jresidual(jso, want_q, jb, jkind)
    got_q, got_r = fused3.point_relax_split3(tso, tq, tb, kind, updown,
                                             fuse_residual=True)
    _close64(got_q, want_q)
    _close64(got_r, want_r)
    _, got_p = fused3.point_relax_split3(tso, tq, tb, kind, updown,
                                         fuse_norm=True)
    np.testing.assert_allclose(float(got_p.sum()),
                               float(jnp.sum(want_r * want_r)), rtol=1e-12)

    # sweep_restrict_split3: the sweep, its residual, cb = Pᵀ res
    gq, gr, gcb = fused3.sweep_restrict_split3(tso, tq, tb, tci, kind,
                                               updown)
    _close64(gq, want_q)
    _close64(gr, want_r)
    _close64(gcb, jinterp3.restrict(jnp.asarray(ci), want_r))

    # interp_sweep_split3: res of q_pre, interp_add, a sweep (+ res / norm)
    mid = jinterp3.interp_add(jnp.asarray(ci), jso, jnp.asarray(qc),
                              jresidual(jso, jq, jb, jkind), jq)
    want_q = _dense_sweep(so, np.asarray(mid), b, jkind, updown)
    want_r = jresidual(jso, want_q, jb, jkind)
    gq, gr = fused3.interp_sweep_split3(tci, tqc, tso, tb, tq, kind, updown,
                                        fuse_residual=True)
    _close64(gq, want_q)
    _close64(gr, want_r)
    _, gp = fused3.interp_sweep_split3(tci, tqc, tso, tb, tq, kind, updown,
                                       fuse_norm=True)
    np.testing.assert_allclose(float(gp.sum()),
                               float(jnp.sum(want_r * want_r)), rtol=1e-12)


# --- against the port's dense ops, bit for bit -----------------------------

@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_fused3_ops_equal_dense_ops(ts, updown):
    """The plain versions of K14-K16 equal the port's dense sequences (K6
    with the residual, K7; K8, K6) exactly: the kernels are held to these
    on the card."""
    so, q, b, ci, qc = _problem(67 + ts, (13, 10, 11), ts, np.float64)
    kind, _ = _kinds(ts)
    tso, tq, tb, tci, tqc = _t(so, q, b, ci, qc)
    origin = (1, 0, 3)
    dq, dr = relax3.point_relax(tso, tq.clone(), tb, None, kind, updown,
                                fuse_residual=True, origin=origin)
    gq, gr = fused3.point_relax_split3(tso, tq, tb, kind, updown,
                                       fuse_residual=True, origin=origin)
    assert torch.equal(gq, dq) and torch.equal(gr, dr)

    dq, dr = relax3.point_relax(tso, tq.clone(), tb, None, kind, updown,
                                fuse_residual=True)
    gq, gr, gcb = fused3.sweep_restrict_split3(tso, tq, tb, tci, kind,
                                               updown)
    assert torch.equal(gq, dq) and torch.equal(gr, dr)
    assert torch.equal(gcb, interp3.restrict(tci, dr))

    mid = interp3.interp_add(tci, tso, tqc, stencil3.residual(tso, tq, tb,
                                                              kind),
                             tq.clone())
    dq, dr = relax3.point_relax(tso, mid, tb, None, kind, updown,
                                fuse_residual=True)
    gq, gr = fused3.interp_sweep_split3(tci, tqc, tso, tb, tq, kind, updown,
                                        fuse_residual=True)
    assert torch.equal(gq, dq) and torch.equal(gr, dr)


# --- the edge kernel's plain version ---------------------------------------

@pytest.mark.parametrize("shape", F64_SHAPES + [(12, 9, 14)])
def test_edge_plain_matches_jax_f64(shape):
    """The edge kernel's plain version in each mode against cedar_tpu's
    dense XLA ops in float64 at odd and ragged shapes: the residual, its
    norm, cb = Pᵀ res (with and without the residual out) and the
    interp-add of the recomputed residual."""
    so, q, b, ci, qc = _problem(81 + shape[0], shape, True, np.float64)
    jkind = JKind.twenty_seven_pt
    jso, jq, jb = jnp.asarray(so), jnp.asarray(q), jnp.asarray(b)
    tso, tq, tb, tci, tqc = _t(so, q, b, ci, qc)
    want_r = jresidual(jso, jq, jb, jkind)
    _close64(cuda_fused3.edge_plain(tso, tq, tb, "res"), want_r)
    np.testing.assert_allclose(
        float(cuda_fused3.edge_plain(tso, tq, tb, "norm").sum()),
        float(jnp.sum(want_r * want_r)), rtol=1e-12)
    want_cb = jinterp3.restrict(jnp.asarray(ci), want_r)
    for emit in (False, True):
        r, cb = cuda_fused3.edge_plain(tso, tq, tb, "restrict", tci,
                                       emit_res=emit)
        _close64(cb, want_cb)
        if emit:
            _close64(r, want_r)
        else:
            assert r is None
    want_q = jinterp3.interp_add(jnp.asarray(ci), jso, jnp.asarray(qc),
                                 want_r, jq)
    got = cuda_fused3.edge_plain(tso, tq, tb, "interp", tci, tqc)
    _close64(got, want_q)
    np.testing.assert_array_equal(tq.numpy(), q)   # out of place


def test_edge_plain_composes_the_fused_ops():
    """K15's and K16's plain versions are, bit for bit, the sweep followed
    by the edge kernel's restriction and the edge kernel's interpolation
    followed by the sweep (+ the norm), as the 27-point kernels compose
    them on the card."""
    so, q, b, ci, qc = _problem(83, (13, 10, 11), True, np.float64)
    kind = StencilKind.twenty_seven_pt
    tso, tq, tb, tci, tqc = _t(so, q, b, ci, qc)
    gq, gr, gcb = cuda_fused3.sweep_restrict_plain(tso, tq, tb, tci, kind,
                                                   "down", True)
    sq = cuda3.sweep_plain(tso, tq, tb, kind, "down")
    r, cb = cuda_fused3.edge_plain(tso, sq, tb, "restrict", tci,
                                   emit_res=True)
    assert torch.equal(gq, sq) and torch.equal(gr, r)
    assert torch.equal(gcb, cb)
    gq, gp = cuda_fused3.interp_sweep_plain(tci, tqc, tso, tb, tq, kind,
                                            "up", fuse_norm=True)
    mid = cuda_fused3.edge_plain(tso, tq, tb, "interp", tci, tqc)
    sq = cuda3.sweep_plain(tso, mid, tb, kind, "up")
    assert torch.equal(gq, sq)
    assert torch.equal(gp, cuda_fused3.edge_plain(tso, sq, tb, "norm"))


@pytest.mark.parametrize("bad", ["kind", "ci", "qc", "mode"])
def test_edge_checks(bad):
    """The edge kernel takes a 27-point level, the coarse level's CI and
    the coarse values of its shape, and one of its four modes."""
    so, q, b, ci, qc = _problem(84, (9, 11, 6), True, np.float64)
    tso, tq, tb, tci, tqc = _t(so, q, b, ci, qc)
    mode = "interp"
    if bad == "kind":
        tso = tso[:4]
    elif bad == "ci":
        tci = tci[:, :, :4]
    elif bad == "qc":
        tqc = tqc[:, :5]
    with pytest.raises(KeyError if bad == "mode" else ValueError):
        cuda_fused3.edge_plain(tso, tq, tb, "sweep" if bad == "mode"
                               else mode, tci, tqc)


# --- dispatch, counters and checks -----------------------------------------

def test_cpu_dispatch_uses_plain_versions():
    names = ("sweep", "sweep_restrict", "interp_sweep")
    plain = [getattr(cuda_fused3, f"{n}_plain_calls") for n in names]
    launches = [getattr(cuda_fused3, f"{n}_launches") for n in names]
    edge = (cuda_fused3.edge_launches, cuda_fused3.edge_plain_calls)
    k6 = (cuda3.plain_calls, cuda3.launches, cuda3.resident_launches)
    k7 = cuda_transfer3.restrict_plain_calls
    for ts in (False, True):
        so, q, b, ci, qc = _problem(71, (9, 11, 6), ts, np.float64)
        kind, _ = _kinds(ts)
        tso, tq, tb, tci, tqc = _t(so, q, b, ci, qc)
        fused3.point_relax_split3(tso, tq, tb, kind, "down")
        fused3.sweep_restrict_split3(tso, tq, tb, tci, kind, "down")
        fused3.interp_sweep_split3(tci, tqc, tso, tb, tq, kind, "up")
    for n, p, k in zip(names, plain, launches):
        assert getattr(cuda_fused3, f"{n}_plain_calls") == p + 2
        assert getattr(cuda_fused3, f"{n}_launches") == k
    # no kernel launched: neither the edge kernel nor K6's; the plain
    # versions compose torch ops, not the dense wrappers or the edge
    # kernel's plain version
    assert (cuda_fused3.edge_launches, cuda_fused3.edge_plain_calls) == edge
    assert (cuda3.plain_calls, cuda3.launches,
            cuda3.resident_launches) == k6
    assert cuda_transfer3.restrict_plain_calls == k7


def test_kernel_wrappers_refuse_cpu_tensors():
    so, q, b, ci, qc = _problem(72, (9, 11, 6), True, np.float64)
    kind = StencilKind.twenty_seven_pt
    tso, tq, tb, tci, tqc = _t(so, q, b, ci, qc)
    with pytest.raises(ValueError, match="not on CUDA"):
        cuda_fused3.sweep(tso, tq, tb, kind, "down")
    with pytest.raises(ValueError, match="not on CUDA"):
        cuda_fused3.sweep_restrict(tso, tq, tb, tci, kind, "down")
    with pytest.raises(ValueError, match="not on CUDA"):
        cuda_fused3.interp_sweep(tci, tqc, tso, tb, tq, kind, "down")
    for mode in cuda_fused3.EDGE_MODES:
        with pytest.raises(ValueError, match="not on CUDA"):
            cuda_fused3.edge(tso, tq, tb, mode, tci, tqc)


@pytest.mark.parametrize("bad", ["kind", "batch", "so", "ci", "qc",
                                 "alias"])
def test_fused3_checks(bad):
    so, q, b, ci, qc = _problem(73, (9, 11, 6), False, np.float64)
    tso, tq, tb, tci, tqc = _t(so, q, b, ci, qc)
    kind = StencilKind.seven_pt
    if bad == "kind":
        kind = StencilKind.five_pt
    elif bad == "batch":
        tq, tb = tq[None], tb[None]
    elif bad == "so":
        tso = tso[:, :, :, :5]
    elif bad == "ci":
        tci = tci[:, :, :4]
    elif bad == "qc":
        tqc = tqc[:, :5]
    elif bad == "alias":
        # q sharing storage with b: the kernels write new tensors, so none
        # reads what it writes; the sweep equals the one of copies and
        # leaves q as it was
        q0 = tq.clone()
        got = cuda_fused3.sweep_plain(tso, tq, tq, kind, "down", True)
        want = cuda_fused3.sweep_plain(tso, q0.clone(), q0.clone(), kind,
                                       "down", True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(tq, q0)
        return
    with pytest.raises(ValueError):
        if bad == "qc":
            cuda_fused3.interp_sweep_plain(tci, tqc, tso, tb, tq, kind, "up")
        elif bad == "ci":
            cuda_fused3.sweep_restrict_plain(tso, tq, tb, tci, kind, "down")
        else:
            cuda_fused3.sweep_plain(tso, tq, tb, kind, "down")


@pytest.mark.parametrize("stages", [1, 2, 4, 8])
@pytest.mark.parametrize("ts", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
@pytest.mark.parametrize("mode", [cuda_fused3._NONE, cuda_fused3._NORM],
                         ids=["none", "norm"])
def test_colour_passes_follow_color_order(ts, updown, stages, mode):
    """The kernels' colour passes are relax3.color_order's, in order: two
    colours a launch for 7-point (K14, K15 or K16 on the ring design);
    27-point (DOWN sweeps colours 8..1) K14 marches, each one block of
    ``stages`` positions of the colour order, whatever the role; a march
    packs into 4-bit codes with the no-colour code past its last.  A
    27-point K14, K15 or K16 call at 128³ float32 (K6's route: the
    marches) runs exactly those marches, after K16's interpolation and
    before K15's restriction or the norm (``mode``), edge launches."""
    kind = StencilKind.twenty_seven_pt if ts else StencilKind.seven_pt
    order = relax3.color_order(kind, updown)
    for role, own in (("sweep", "ring"), ("restrict", "K15"),
                      ("interp", "K16")):
        passes = cuda_fused3.passes(stages, kind, updown, role)
        assert [c for _, g in passes for c in g] == order
        if not ts:
            assert passes == ((own, tuple(order)),)
            continue
        assert len(passes) == -(-8 // stages)
        for k, g in passes:
            assert k == "pass27" and 1 <= len(g) <= stages
            assert len({order.index(c) // stages for c in g}) == 1
            packed = cuda_fused3._pack(g, stages)
            codes = [(packed >> (4 * k)) & 15 for k in range(stages)]
            assert codes == list(g) + [cuda_fused3.NO_COLOR] * (
                stages - len(g))
        m = cuda_fused3._NONE if role == "restrict" else mode
        got = cuda_fused3.launch_list(4, kind, (128,) * 3, updown, role, m,
                                      stages)
        head = (("edge27", "interp"),) if role == "interp" else ()
        tail = ((("edge27", "restrict"),) if role == "restrict" else
                (("edge27", "norm"),) if m == cuda_fused3._NORM else ())
        assert got == head + tuple(("sweep3_fused", g)
                                   for _, g in passes) + tail
