"""The traffic mix: right-hand sides drawn from (seed, index)."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.helpers import tiny_cell

SEEDS = [0, 7, 2**31 + 5, 2**40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_rhs(seed):
    cell = tiny_cell("poisson2d-8192.rhs")
    a = harness.Problem(cell.config, torch.device("cpu"))
    b = harness.Problem(cell.config, torch.device("cpu"))
    for index in (0, 1, 17, "warm-0"):
        assert torch.equal(a.rhs(seed, index), b.rhs(seed, index))


def test_seeds_and_indices_differ():
    cell = tiny_cell("planexy-128.rhs")
    p = harness.Problem(cell.config, torch.device("cpu"))
    rhs = [p.rhs(s, i) for s in SEEDS for i in (0, 1, "warm-0")]
    for i, x in enumerate(rhs):
        for y in rhs[i + 1:]:
            assert not torch.equal(x, y)


def test_rhs_scale_and_precision():
    cell = tiny_cell("poisson2d-8192.rhs")
    p = harness.Problem(cell.config, torch.device("cpu"))
    b = p.rhs(3, 0)
    assert b.dtype == torch.float64 and b.shape == (31, 31)
    assert p.scale == pytest.approx(1 / 32**2)
    # i.i.d. standard normal values times hx*hy
    assert 0.5 < float(b.std()) / p.scale < 1.5


def test_stream_seed_takes_large_seeds():
    seeds = {harness.stream_seed(s, i) for s in SEEDS for i in range(4)}
    assert len(seeds) == 4 * len(SEEDS)
    assert all(0 <= s < 2**63 for s in seeds)


def test_sample_size():
    cell = tiny_cell("poisson2d-8192.rhs")
    p = harness.Problem(cell.config, torch.device("cpu"))
    assert harness.sample_size(cell.traffic, p) == cell.traffic["check_solves"]
    big = harness.load_cell("poisson2d-8192.rhs")
    pb = harness.Problem(big.config, torch.device("cpu"))
    # 8192^2 float64 answers of 512 MiB each under the mix's 4 GiB
    assert harness.sample_size(big.traffic, pb) == 8


def test_sample_is_drawn_from_the_seed():
    cell = tiny_cell("poisson2d-8192.rhs")
    p = harness.Problem(cell.config, torch.device("cpu"))
    s = harness.Session(p)
    a = harness.run_window(s, 11, 1e9, 3, max_solves=9)
    b = harness.run_window(s, 11, 1e9, 3, max_solves=9)
    idx = [sorted(i for i, _, _ in w.sample) for w in (a, b)]
    assert idx[0] == idx[1] and len(idx[0]) == 3
    assert len(a.solves) == 9
