"""``solver.ml-relax.enabled`` in the port against cedar_tpu, float64.

cedar_tpu's ml-relax solves every line of 64 points or more by its
full-length PCR (``cedar_tpu.ops.lines2._pcr_solve``) and shorter lines by
the LDLᵀ recurrence.  The port runs the same solve through
``lines2.pcr_stride(n, full=True)`` (kernels K4 and K10 on the card, their
plain versions here):

* the plain full-length ``pcr_solve`` against ``_pcr_solve`` on random
  diagonally dominant systems (rtol 1e-12);
* line-x, line-y and line-xy solves of 96×80 ``diag_diffusion(100, 1)``
  against cedar_tpu's ml-relax solves: histories to rtol 1e-9 (atol 1e-14
  near the rounding floor), x to 1e-9 of max |x|; and one whose lines are
  all shorter than 64 points, where ml-relax changes nothing in the port;
* plane-xy 64×64×6 with a plane-config ml-relax (K10's full stride);
* 256² with ``num-levels: 2`` and a ``cg-config`` line-x ml-relax (an
  inner solver's lines).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu import Solver2 as JSolver2
from cedar_tpu import Solver3 as JSolver3
from cedar_tpu import gallery as jgallery
from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops.lines2 import _pcr_solve

from cedar_tpu_torch import FivePt, SevenPt, Solver2, Solver3
from cedar_tpu_torch.ops import cuda_lines2, cuda_planes2, lines2

torch.set_num_threads(2)

ML = {"ml-relax": {"enabled": True}}


def _system(n: int, m: int, seed: int):
    """``m`` random diagonally dominant tridiagonal systems of ``n`` rows
    along axis 0: ``(lo, dg, up, d)``, lo[0] = up[n-1] = 0."""
    rng = np.random.default_rng(seed)
    lo = -rng.uniform(0.5, 1.5, (n, m))
    up = -rng.uniform(0.5, 1.5, (n, m))
    lo[0] = 0.0
    up[-1] = 0.0
    dg = np.abs(lo) + np.abs(up) + rng.uniform(0.05, 0.2, (n, m))
    return lo, dg, up, rng.standard_normal((n, m))


@pytest.mark.parametrize("n", [64, 65, 100, 128, 257])
def test_full_pcr_matches_cedar_tpu(n):
    a = _system(n, 5, n)
    want = np.asarray(_pcr_solve(*(jnp.asarray(v) for v in a)))
    h = lines2.pcr_stride(n, full=True)
    assert h >= n and h & (h - 1) == 0 and h < 2 * n
    got = lines2.pcr_solve(*(torch.tensor(v) for v in a), h)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * float(np.abs(want).max()))


def test_pcr_stride_full_rule():
    for n in (1, 2, 17, 63):
        assert lines2.pcr_stride(n, full=True) == 0 == lines2.pcr_stride(n)
    assert [lines2.pcr_stride(n, full=True)
            for n in (64, 65, 128, 129, 2048, 2049)] == [
        64, 128, 128, 256, 2048, 4096]
    # the kernels' rows a line: the next power of two, so a line of 2048
    # f32 points still fits shared memory (three to a block) and one of
    # 2049 leaves room for one
    h, lines, far = cuda_lines2.group(2048, 1024, 4, cuda_lines2.K4_ROWS,
                                      full=True)
    assert (h, lines, far) == (2048, 3, False)
    h, lines, far = cuda_lines2.group(2049, 1024, 8, cuda_lines2.K4_ROWS,
                                      full=True)
    assert (h, lines, far) == (4096, 1, True)


@pytest.mark.parametrize("updown", ["down", "up"])
@pytest.mark.parametrize("axes", ["x", "y", "xy"])
def test_plain_sweeps_full_pcr(axes, updown):
    """K4's and K10's plain versions with ``full``: each line of 64 points
    or more solved by the full-length PCR, the 48-point lines as before."""
    rng = np.random.default_rng(7)
    so = torch.tensor(np.asarray(jgallery.diag_diffusion(96, 48, 100.0,
                                                         1.0)))
    q0 = torch.tensor(rng.standard_normal((96, 48)))
    b = torch.tensor(rng.standard_normal((96, 48)))
    kind = FivePt
    got = cuda_planes2.smooth_plain(so[:, None], q0[None].clone(), b[None],
                                    kind, updown, 1, axes=axes, full=True)[0]
    want = q0.clone()
    sweeps = {"x": lambda: cuda_lines2.line_x_plain(so, want, b, kind,
                                                    updown, full=True),
              "y": lambda: cuda_lines2.line_y_plain(so, want, b, kind,
                                                    updown, full=True)}
    order = list(axes) if updown == "down" else list(axes)[::-1]
    for a in order:
        sweeps[a]()
    assert torch.equal(got, want)
    default = cuda_planes2.smooth_plain(so[:, None], q0[None].clone(),
                                        b[None], kind, updown, 1, axes=axes)
    # the y-lines (48 points) take the LDLᵀ recurrence either way
    if axes == "y":
        assert torch.equal(default[0], got)
    else:
        assert not torch.equal(default[0], got)
        np.testing.assert_allclose(default[0].numpy(), got.numpy(),
                                   rtol=1e-10, atol=1e-12)


def _both(jmake, shape, conf, solver=(JSolver2, Solver2), kind=FivePt,
          jkind=JKind.five_pt, rhs=jgallery.poisson_rhs):
    so = np.asarray(jmake())
    b = np.asarray(rhs(*shape))
    js = solver[0](jnp.asarray(so), jkind, conf)
    jx = np.asarray(js.solve(jnp.asarray(b)))
    s = solver[1](torch.tensor(so), kind, conf)
    x = s.solve(torch.tensor(b)).numpy()
    return s, js, x, jx


def _agree(s, js, x, jx):
    assert len(s.history) == len(js.history)
    np.testing.assert_allclose(s.history, js.history, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(x, jx, rtol=1e-9,
                               atol=1e-9 * float(np.abs(jx).max()))


@pytest.mark.parametrize("relax,iters", [("line-x", 6), ("line-y", 4),
                                         ("line-xy", 6)])
def test_ml_relax_solve_matches_cedar_tpu(relax, iters):
    """96-point x-lines and 80-point y-lines on the top level (the
    full-length PCR), the LDLᵀ recurrence below; 100:1 anisotropy, so the
    lines matter.  The first cycles are compared (6 cut the residual to
    about 1e-8 with line-x or line-xy; line-y relaxes across the strong
    coupling and converges slowly)."""
    conf = {"log": [], "solver": {"relaxation": relax, "tol": 1e-10,
                                  "max-iter": iters, **ML}}
    _agree(*_both(lambda: jgallery.diag_diffusion(96, 80, 100.0, 1.0),
                  (96, 80), conf))


def test_ml_relax_short_lines_unchanged():
    """On 48×40 every line is shorter than 64 points: the port's ml-relax
    solve is its default solve bit for bit (the LDLᵀ recurrence), and it
    agrees with cedar_tpu's ml-relax solve."""
    conf = {"log": [], "solver": {"relaxation": "line-xy", "tol": 1e-10,
                                  "max-iter": 5}}
    ml = {**conf, "solver": {**conf["solver"], **ML}}
    s, js, x, jx = _both(lambda: jgallery.diag_diffusion(48, 40, 100.0, 1.0),
                         (48, 40), ml)
    _agree(s, js, x, jx)
    d = Solver2(s.levels[0].so, FivePt, conf)
    xd = d.solve(torch.tensor(np.asarray(jgallery.poisson_rhs(48, 40))))
    assert d.history == s.history
    assert np.array_equal(xd.numpy(), x)


def test_plane_config_ml_relax_matches_cedar_tpu():
    """plane-xy whose embedded plane solvers relax 64-point lines by the
    full-length PCR (K10's full stride on the card)."""
    conf = {"log": [], "solver": {"relaxation": "plane-xy", "tol": 1e-10,
                                  "max-iter": 2},
            "plane-config": {"solver": {"relaxation": "line-xy",
                                        "max-iter": 1, **ML}}}
    s, js, x, jx = _both(
        lambda: jgallery.diag_diffusion3(64, 64, 6, 1.0, 1.0, 1e-3),
        (64, 64, 6), conf, (JSolver3, Solver3), SevenPt, JKind.seven_pt,
        jgallery.poisson3_rhs)
    assert s.settings.plane_settings.ml_relax_enabled
    _agree(s, js, x, jx)


def test_cg_config_ml_relax_matches_cedar_tpu():
    """An inner solver (``cg-solver: cedar``) on the 128² coarse grid that
    relaxes its 128-point x-lines by the full-length PCR."""
    conf = {"log": [], "solver": {"tol": 1e-10, "max-iter": 4,
                                  "num-levels": 2, "cg-solver": "cedar"},
            "cg-config": {"solver": {"relaxation": "line-x", "tol": 1e-8,
                                     "max-iter": 3, **ML}}}
    s, js, x, jx = _both(lambda: jgallery.poisson(256, 256), (256, 256),
                         conf)
    assert s.settings.cg_settings.ml_relax_enabled
    _agree(s, js, x, jx)
