"""The port's 3D BoxMG interpolation setup and grid transfers (plain
versions of kernels K7 restrict, K8 interp-add and K9 interp) against
cedar_tpu: the XLA ops in float64 at odd and even shapes, the Pallas
restriction kernel in interpret mode in float32 (the tolerance of
tests/test_pallas_transfer3.py), and the Fortran transcription of
tests/oracles3.py.

The CUDA kernels themselves run only on the card; chip_smoke.py holds
them against the plain versions checked here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles3 as orc
from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import interp3 as jinterp3
from cedar_tpu.ops import pallas_transfer3 as pt

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_transfer3, interp3

torch.set_num_threads(2)

SHAPES = [(21, 13, 17), (16, 16, 16)]


def _so(seed, shape, ts, dtype=np.float64):
    from test_kernels_3d import random_so

    return random_so(np.random.default_rng(seed), *shape, ts).astype(dtype)


def _kinds(ts):
    return ((StencilKind.twenty_seven_pt, JKind.twenty_seven_pt) if ts
            else (StencilKind.seven_pt, JKind.seven_pt))


def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=1e-14 * float(np.abs(want).max()))


@pytest.fixture(scope="module", params=[(s, ts) for s in SHAPES
                                        for ts in (False, True)],
                ids=lambda p: f"{'x'.join(map(str, p[0]))}-"
                              f"{'27' if p[1] else '7'}pt")
def case(request):
    """One operator with its CI from both packages and random fields."""
    shape, ts = request.param
    so = _so(3 + shape[2] + ts, shape, ts)
    kind, jkind = _kinds(ts)
    jci = np.asarray(jinterp3.setup_interp(jnp.asarray(so), jkind))
    ci = interp3.setup_interp(torch.tensor(so), kind)
    nc = tuple((n - 1) // 2 + 1 for n in shape)
    rng = np.random.default_rng(41)
    return dict(shape=shape, nc=nc, so=so, kind=kind, jci=jci, ci=ci,
                res=rng.standard_normal(shape), qc=rng.standard_normal(nc),
                q=rng.standard_normal(shape))


def test_setup_interp_matches_jax(case):
    assert case["ci"].shape == case["jci"].shape
    _close(case["ci"], case["jci"])


def test_restrict_matches_jax(case):
    want = jinterp3.restrict(jnp.asarray(case["jci"]),
                             jnp.asarray(case["res"]))
    got = interp3.restrict(torch.tensor(case["jci"]),
                           torch.tensor(case["res"]))
    assert got.shape == case["nc"]
    _close(got, want)


def test_interp_add_matches_jax(case):
    jci = jnp.asarray(case["jci"])
    want = jinterp3.interp_add(jci, jnp.asarray(case["so"]),
                               jnp.asarray(case["qc"]),
                               jnp.asarray(case["res"]),
                               jnp.asarray(case["q"]))
    tq = torch.tensor(case["q"])
    got = interp3.interp_add(torch.tensor(case["jci"]),
                             torch.tensor(case["so"]),
                             torch.tensor(case["qc"]),
                             torch.tensor(case["res"]), tq)
    assert got is tq   # in place
    _close(got, want)


def test_interp_matches_jax_interp_add_with_zeros(case):
    """x = P qc is cedar_tpu's interp_add with zero residual and addend,
    the F-cycle's level entry."""
    zero = jnp.zeros(case["shape"])
    want = jinterp3.interp_add(jnp.asarray(case["jci"]),
                               jnp.asarray(case["so"]),
                               jnp.asarray(case["qc"]), zero, zero)
    got = interp3.interp(torch.tensor(case["jci"]), torch.tensor(case["qc"]),
                         case["shape"])
    _close(got, want)


def test_interp_is_interp_add_of_zeros(case):
    """The plain K9 equals the plain K8 with zero residual and addend."""
    zero = torch.zeros(case["shape"], dtype=torch.float64)
    qc = torch.tensor(case["qc"])
    got = interp3.interp(case["ci"], qc, case["shape"])
    want = interp3.interp_add(case["ci"], torch.tensor(case["so"]), qc,
                              zero, zero.clone())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_tables_match_jax():
    assert interp3.DELTA == {int(k): v for k, v in jinterp3.DELTA.items()}
    assert interp3.PW3_TABLE == {
        k: (int(p), s) for k, (p, s) in jinterp3.PW3_TABLE.items()}
    assert list(interp3.PW3_TABLE) == list(jinterp3.PW3_TABLE)
    so = _so(5, (9, 7, 8), True)
    ci = np.asarray(jinterp3.setup_interp(jnp.asarray(so),
                                          JKind.twenty_seven_pt))
    got = interp3.pw_weights(torch.tensor(ci))
    want = jinterp3.pw_weights(jnp.asarray(ci))
    assert list(got) == list(want)
    for off in want:
        np.testing.assert_array_equal(got[off].numpy(), np.asarray(want[off]))


def test_restrict_matches_pallas_interpret_f32(monkeypatch):
    monkeypatch.setattr(pt, "INTERPRET", True)
    shape = (32, 32, 256)
    so = _so(17 + 32 + 256, shape, True, np.float32)
    jci = jinterp3.setup_interp(jnp.asarray(so), JKind.twenty_seven_pt)
    res = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    nc = tuple((n - 1) // 2 + 1 for n in shape)
    want = pt.restrict(pt.setup_pw3(jci, shape), pt.split_res(
        jnp.asarray(res)), nc)
    got = interp3.restrict(torch.tensor(np.asarray(jci)), torch.tensor(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("shape", [(9, 7, 6), (8, 8, 8)])
def test_transfers_match_fortran_oracle(shape):
    rng = np.random.default_rng(13 + shape[0])
    so = _so(19, shape, True)
    g = orc.pad_ghost_so(so)
    nc = tuple((n - 1) // 2 + 1 for n in shape)
    dims_f = tuple(n + 2 for n in shape)
    dims_c = tuple(n + 2 for n in nc)
    cio = orc.setup_interp_oi(g, *dims_f, *dims_c)
    ci = interp3.setup_interp(torch.tensor(so), StencilKind.twenty_seven_pt)
    np.testing.assert_allclose(ci.numpy(), cio[:, 1:, 1:, 1:], atol=1e-13)

    qf = rng.standard_normal(shape)
    np.testing.assert_allclose(
        interp3.restrict(ci, torch.tensor(qf)).numpy(),
        orc.unpad(orc.restrict(cio, orc.pad_ghost(qf), *dims_c)),
        atol=1e-12)

    qcg = np.zeros(dims_c)
    qcg[1:-1, 1:-1, 1:-1] = rng.standard_normal(nc)
    resg = orc.pad_ghost(rng.standard_normal(shape))
    q0 = rng.standard_normal(shape)
    want = orc.interp_add(cio, g, orc.pad_ghost(q0), qcg, resg, *dims_f,
                          *dims_c)
    got = interp3.interp_add(ci, torch.tensor(so),
                             torch.tensor(qcg[1:-1, 1:-1, 1:-1]),
                             torch.tensor(resg[1:-1, 1:-1, 1:-1]),
                             torch.tensor(q0))
    np.testing.assert_allclose(got.numpy(), orc.unpad(want), atol=1e-12)


def test_cpu_dispatch_uses_plain_versions(case):
    before = (cuda_transfer3.restrict_launches,
              cuda_transfer3.interp_add_launches,
              cuda_transfer3.interp_launches)
    plain = (cuda_transfer3.restrict_plain_calls,
             cuda_transfer3.interp_add_plain_calls,
             cuda_transfer3.interp_plain_calls)
    qc = torch.tensor(case["qc"])
    interp3.restrict(case["ci"], torch.tensor(case["res"]))
    interp3.interp_add(case["ci"], torch.tensor(case["so"]), qc,
                       torch.tensor(case["res"]), torch.tensor(case["q"]))
    interp3.interp(case["ci"], qc, case["shape"])
    assert (cuda_transfer3.restrict_plain_calls,
            cuda_transfer3.interp_add_plain_calls,
            cuda_transfer3.interp_plain_calls) == tuple(p + 1 for p in plain)
    assert (cuda_transfer3.restrict_launches,
            cuda_transfer3.interp_add_launches,
            cuda_transfer3.interp_launches) == before


def test_kernel_wrappers_check_operands():
    so = torch.tensor(_so(23, (9, 7, 6), False))
    ci = interp3.setup_interp(so, StencilKind.seven_pt)
    res = torch.zeros((9, 7, 6), dtype=torch.float64)
    qc = torch.zeros((5, 4, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="not on CUDA"):
        cuda_transfer3.restrict(ci, res)
    with pytest.raises(ValueError, match="not on CUDA"):
        cuda_transfer3.interp(ci, qc, (9, 7, 6))
    with pytest.raises(ValueError, match="does not interpolate"):
        cuda_transfer3.restrict(ci, res[:8])
    with pytest.raises(ValueError, match="qc"):
        cuda_transfer3.interp(ci, qc[:4], (9, 7, 6))
    with pytest.raises(ValueError, match="share storage"):
        cuda_transfer3.interp_add(ci, so, qc, res, res)
