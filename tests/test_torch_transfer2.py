"""The port's interpolation setup and grid transfers (plain versions of
kernels K2 and K3) against cedar_tpu: ops.interp2 in float64, and the
Pallas transfer kernels in interpret mode in float32 (the tolerances of
tests/test_pallas_transfer2.py).

The CUDA kernels themselves run only on the card; chip_smoke.py holds them
against the plain versions checked here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import interp2 as jinterp2
from cedar_tpu.ops import pallas_transfer2 as pt

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_transfer2, interp2

torch.set_num_threads(2)

# Torch inputs are copies (torch.tensor): the port writes q in place, and
# JAX on the CPU may share the numpy buffer and read it asynchronously.

SHAPES = [(False, 256, 256), (True, 129, 257), (False, 200, 300),
          (True, 125, 93), (False, 125, 93), (True, 200, 300)]


def _problem(seed, nx, ny, nine, dtype=np.float64):
    from test_kernels_2d import random_so

    rng = np.random.default_rng(seed)
    so = random_so(rng, nx, ny, nine).astype(dtype)
    nxc, nyc = (nx - 1) // 2 + 1, (ny - 1) // 2 + 1
    res = rng.standard_normal((nx, ny)).astype(dtype)
    q = rng.standard_normal((nx, ny)).astype(dtype)
    qc = rng.standard_normal((nxc, nyc)).astype(dtype)
    return so, res, q, qc


def _kinds(nine):
    return ((StencilKind.nine_pt, JKind.nine_pt) if nine
            else (StencilKind.five_pt, JKind.five_pt))


@pytest.mark.parametrize("nine,nx,ny", SHAPES)
def test_transfers_match_jax_f64(nine, nx, ny):
    so, res, q, qc = _problem(17 + nx + nine, nx, ny, nine)
    kind, jkind = _kinds(nine)
    jci = jinterp2.setup_interp(jnp.asarray(so), jkind)
    ci = interp2.setup_interp(torch.tensor(so), kind)
    np.testing.assert_allclose(ci.numpy(), np.asarray(jci), rtol=1e-12,
                               atol=0)

    want = jinterp2.restrict(jci, jnp.asarray(res))
    got = interp2.restrict(ci, torch.tensor(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-14)

    want = jinterp2.interp_add(jci, jnp.asarray(so), jnp.asarray(qc),
                               jnp.asarray(res), jnp.asarray(q))
    tq = torch.tensor(q)
    got = interp2.interp_add(ci, torch.tensor(so), torch.tensor(qc),
                             torch.tensor(res), tq)
    assert got is tq   # in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("nine,nx,ny", [(False, 256, 256), (True, 129, 257),
                                        (False, 200, 300)])
def test_transfers_match_pallas_interpret_f32(nine, nx, ny, monkeypatch):
    monkeypatch.setattr(pt, "INTERPRET", True)
    so, res, q, qc = _problem(17 + nx, nx, ny, nine, np.float32)
    kind, jkind = _kinds(nine)
    jci = jinterp2.setup_interp(jnp.asarray(so), jkind)
    ci = interp2.setup_interp(torch.tensor(so), kind)
    cip = pt.pad_ci(jci, nx, ny)
    res2 = pt.lane_split_res(jnp.asarray(res))

    want = pt.restrict(cip, res2, (ci.shape[1] - 1, ci.shape[2] - 1))
    got = interp2.restrict(ci, torch.tensor(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-6,
                               atol=3e-6)

    want = pt.interp_add(cip, pt.setup_rec2(jnp.asarray(so)),
                         jnp.asarray(qc), res2, jnp.asarray(q))
    got = interp2.interp_add(ci, torch.tensor(so), torch.tensor(qc),
                             torch.tensor(res), torch.tensor(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-6,
                               atol=3e-6)


@pytest.mark.parametrize("nine,nx,ny", [(False, 9, 7), (True, 10, 12)])
def test_pw_weights_and_parity_sample_match_jax(nine, nx, ny):
    from cedar_tpu.core.parity import deinterleave2 as jdeinterleave2
    from cedar_tpu_torch.core.parity import deinterleave2

    so, res, _, _ = _problem(5, nx, ny, nine)
    kind, jkind = _kinds(nine)
    jci = jinterp2.setup_interp(jnp.asarray(so), jkind)
    ci = interp2.setup_interp(torch.tensor(so), kind)
    want = jinterp2.pw_weights(jci)
    got = interp2.pw_weights(ci)
    assert list(got) == list(want)
    for off in want:
        np.testing.assert_allclose(got[off].numpy(), np.asarray(want[off]),
                                   rtol=1e-12)
    nc = (ci.shape[1] - 1, ci.shape[2] - 1)
    jparts = jdeinterleave2(jnp.asarray(res))
    parts = deinterleave2(torch.tensor(res))
    for du in (-1, 0, 1):
        for dv in (-1, 0, 1):
            np.testing.assert_array_equal(
                interp2.parity_sample(parts, du, dv, nc).numpy(),
                np.asarray(jinterp2.parity_sample(jparts, du, dv, nc)))


def test_cpu_dispatch_uses_plain_versions():
    so, res, q, qc = _problem(6, 9, 11, True)
    ci = interp2.setup_interp(torch.tensor(so), StencilKind.nine_pt)
    before = (cuda_transfer2.restrict_launches,
              cuda_transfer2.interp_launches,
              cuda_transfer2.restrict_plain_calls,
              cuda_transfer2.interp_plain_calls)
    interp2.restrict(ci, torch.tensor(res))
    interp2.interp_add(ci, torch.tensor(so), torch.tensor(qc),
                       torch.tensor(res), torch.tensor(q))
    after = (cuda_transfer2.restrict_launches,
             cuda_transfer2.interp_launches,
             cuda_transfer2.restrict_plain_calls,
             cuda_transfer2.interp_plain_calls)
    assert after == (before[0], before[1], before[2] + 1, before[3] + 1)


def test_kernel_wrappers_refuse_cpu_tensors():
    so, res, q, qc = _problem(7, 9, 11, False)
    t = {k: torch.tensor(v) for k, v in
         dict(so=so, res=res, q=q, qc=qc).items()}
    ci = interp2.setup_interp(t["so"], StencilKind.five_pt)
    with pytest.raises(ValueError, match="not on CUDA"):
        cuda_transfer2.restrict(ci, t["res"])
    with pytest.raises(ValueError, match="not on CUDA"):
        cuda_transfer2.interp_add(ci, t["so"], t["qc"], t["res"], t["q"])


def test_transfer_shape_checks():
    so, res, q, qc = _problem(8, 9, 11, False)
    ci = interp2.setup_interp(torch.tensor(so), StencilKind.five_pt)
    with pytest.raises(ValueError, match="does not interpolate"):
        cuda_transfer2.restrict_plain(ci, torch.tensor(res[:, :8]))
    with pytest.raises(ValueError, match="qc"):
        cuda_transfer2.interp_add(ci, torch.tensor(so),
                                  torch.tensor(qc[:, :3]),
                                  torch.tensor(res), torch.tensor(q))
    tq = torch.tensor(q)
    with pytest.raises(ValueError, match="share storage"):
        cuda_transfer2.interp_add(ci, torch.tensor(so),
                                  torch.tensor(qc), tq, tq)
