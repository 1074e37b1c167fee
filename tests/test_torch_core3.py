"""cedar_tpu_torch's 3D core against cedar_tpu: shift3, the 3D parity
splits, the 3D galleries (exact), and the galleries' default device.

Inputs come from numpy and go to both packages; float64 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu import gallery as jgallery
from cedar_tpu.core import parity as jparity
from cedar_tpu.core import shift as jshift

from cedar_tpu_torch import gallery
from cedar_tpu_torch.core import parity, shift

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(5, 6, 7), (4, 4, 3), (6, 3, 5)])
def test_shift3_matches_jax(shape):
    a = np.random.default_rng(1).standard_normal(shape)
    for d0 in (-1, 0, 1, 2):
        for d1 in (-1, 0, 1):
            for d2 in (-2, -1, 0, 1):
                _same(shift.shift3(_t(a), d0, d1, d2),
                      jshift.shift3(jnp.asarray(a), d0, d1, d2))


@pytest.mark.parametrize("shape", [(7, 9, 5), (8, 10, 6), (9, 4, 3)])
def test_coarse_sample3_matches_jax(shape):
    a = np.random.default_rng(2).standard_normal(shape)
    nc = tuple((n - 1) // 2 + 1 for n in shape)
    for off in [(0, 0, 0), (-1, 0, 1), (1, 1, 1), (0, -1, -1), (2, 1, 0)]:
        _same(shift.coarse_sample(_t(a), off, nc),
              jshift.coarse_sample(jnp.asarray(a), off, nc))


@pytest.mark.parametrize("shape", [(7, 9, 5), (8, 10, 6), (1, 3, 2),
                                   (6, 5, 4)])
def test_parity3_split_merge_matches_jax(shape):
    a = np.random.default_rng(3).standard_normal(shape)
    want = jparity.deinterleave3(jnp.asarray(a))
    got = parity.deinterleave3(_t(a))
    assert set(got) == set(want)
    for p in want:
        _same(got[p], want[p])
    _same(parity.interleave3(got, *shape), a)
    some = [(0, 1, 1), (1, 0, 0), (1, 1, 1)]
    _same(parity.interleave3({p: got[p] for p in some}, *shape),
          jparity.interleave3({p: want[p] for p in some}, *shape))


@pytest.mark.parametrize("sub_shape,out_shape", [((4, 5, 3), (4, 5, 3)),
                                                 ((3, 4, 2), (4, 5, 3)),
                                                 ((5, 6, 4), (3, 3, 2))])
def test_subgrid_sample_nd_matches_jax(sub_shape, out_shape):
    a = np.random.default_rng(4).standard_normal(sub_shape)
    for deltas in [(0, 0, 0), (-1, 1, 0), (1, -1, 1), (2, 0, -1),
                   (-1, -1, -1)]:
        _same(parity.subgrid_sample_nd(_t(a), deltas, out_shape),
              jparity.subgrid_sample_nd(jnp.asarray(a), deltas, out_shape))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gallery3_identical(dtype):
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    cpu = "cpu"
    for n in [(8, 8, 8), (7, 5, 9)]:
        pairs = [
            (gallery.poisson3(*n, tdt, cpu), jgallery.poisson3(*n, jdt)),
            (gallery.diag_diffusion3(*n, 1.0, 1e-3, 10.0, tdt, cpu),
             jgallery.diag_diffusion3(*n, 1.0, 1e-3, 10.0, jdt)),
            (gallery.fe3(*n, tdt, cpu), jgallery.fe3(*n, jdt)),
            (gallery.poisson3_rhs(*n, tdt, cpu),
             jgallery.poisson3_rhs(*n, jdt)),
            (gallery.poisson3_solution(*n, tdt, cpu),
             jgallery.poisson3_solution(*n, jdt)),
        ]
        for got, want in pairs:
            assert got.dtype == tdt and got.device.type == "cpu"
            _same(got, want)


def test_gallery_functions_default_to_the_card(monkeypatch):
    """Every gallery function, 2D and 3D, asks for the card unless given a
    device; checked by recording the device each one asks torch for (no
    allocation on any card)."""
    asked = []
    real = torch.as_tensor

    def record(a, dtype=None, device=None):
        asked.append(torch.device(device))
        return real(a, dtype=dtype)

    monkeypatch.setattr(torch, "as_tensor", record)
    calls = [
        lambda: gallery.poisson(4, 4), lambda: gallery.fe(4, 4),
        lambda: gallery.diag_diffusion(4, 4, 1.0, 2.0),
        lambda: gallery.poisson_rhs(4, 4),
        lambda: gallery.poisson_solution(4, 4),
        lambda: gallery.poisson3(3, 3, 3), lambda: gallery.fe3(3, 3, 3),
        lambda: gallery.diag_diffusion3(3, 3, 3, 1.0, 1.0, 2.0),
        lambda: gallery.poisson3_rhs(3, 3, 3),
        lambda: gallery.poisson3_solution(3, 3, 3),
    ]
    for call in calls:
        call()
    assert asked == [torch.device("cuda")] * len(calls)
    asked.clear()
    gallery.poisson3(3, 3, 3, device="cpu")
    assert asked == [torch.device("cpu")]
