"""cedar_tpu_torch core modules against cedar_tpu: shifts, parity splits,
the 2D gallery, stencil application, config / schema / settings copies and
the timers.

Inputs come from numpy and go to both packages; float64 on the CPU.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedar_tpu import gallery as jgallery
from cedar_tpu.config import Config as JConfig
from cedar_tpu.core import parity as jparity
from cedar_tpu.core import shift as jshift
from cedar_tpu.core.types import StencilKind as JKind
from cedar_tpu.ops import stencil2 as jstencil2
from cedar_tpu.settings import MLSettings as JMLSettings

from cedar_tpu_torch import gallery
from cedar_tpu_torch.config import Config
from cedar_tpu_torch.core import parity, shift
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import stencil2
from cedar_tpu_torch.schema import ConfigError, validate
from cedar_tpu_torch.settings import MLSettings
from cedar_tpu_torch.utils.timing import TimeLog

torch.set_num_threads(2)

RTOL = 1e-13


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=0)


@pytest.mark.parametrize("shape", [(7, 9), (8, 10), (5, 4)])
@pytest.mark.parametrize("periodic", [(False, False), (True, False),
                                      (False, True)])
def test_shift2_matches_jax(shape, periodic):
    a = np.random.default_rng(1).standard_normal(shape)
    for dz in (-2, -1, 0, 1, 2):
        for dw in (-1, 0, 1, 3):
            want = jshift.shift2(jnp.asarray(a), dz, dw, periodic)
            got = shift.shift2(_t(a), dz, dw, periodic)
            _close(got, want)


@pytest.mark.parametrize("shape", [(7, 9), (8, 10), (9, 4)])
def test_coarse_sample_matches_jax(shape):
    a = np.random.default_rng(2).standard_normal(shape)
    nc = ((shape[0] - 1) // 2 + 1, (shape[1] - 1) // 2 + 1)
    for off in [(0, 0), (-1, 0), (1, 1), (0, -1), (1, -1), (2, 1)]:
        for per in [(False, False), (True, True)]:
            want = jshift.coarse_sample(jnp.asarray(a), off, nc, per)
            got = shift.coarse_sample(_t(a), off, nc, per)
            _close(got, want)


@pytest.mark.parametrize("shape", [(7, 9), (8, 10), (1, 3), (6, 5)])
def test_parity_split_merge_matches_jax(shape):
    a = np.random.default_rng(3).standard_normal(shape)
    want = jparity.deinterleave2(jnp.asarray(a))
    got = parity.deinterleave2(_t(a))
    assert set(got) == set(want)
    for p in want:
        _close(got[p], want[p])
    merged = parity.interleave2(got, *shape)
    _close(merged, a)
    jmerged = jparity.interleave2({p: want[p] for p in [(0, 1), (1, 1)]},
                                  *shape)
    _close(parity.interleave2({p: got[p] for p in [(0, 1), (1, 1)]}, *shape),
           jmerged)
    e, o = parity._split_axis(_t(a), 1)
    je, jo = jparity._split_axis(jnp.asarray(a), 1)
    _close(e, je)
    _close(o, jo)


@pytest.mark.parametrize("sub_shape,out_shape", [((4, 5), (4, 5)),
                                                 ((3, 4), (4, 5)),
                                                 ((5, 6), (3, 3))])
def test_subgrid_sample_matches_jax(sub_shape, out_shape):
    a = np.random.default_rng(4).standard_normal(sub_shape)
    for dz in (-2, -1, 0, 1):
        for dw in (-1, 0, 1, 2):
            want = jparity.subgrid_sample(jnp.asarray(a), dz, dw, out_shape)
            got = parity.subgrid_sample(_t(a), dz, dw, out_shape)
            _close(got, want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gallery_identical(dtype):
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    for nx, ny in [(16, 16), (13, 7)]:
        pairs = [
            (gallery.poisson(nx, ny, tdt, device="cpu"),
             jgallery.poisson(nx, ny, jdt)),
            (gallery.diag_diffusion(nx, ny, 1.0, 1e-3, tdt, device="cpu"),
             jgallery.diag_diffusion(nx, ny, 1.0, 1e-3, jdt)),
            (gallery.fe(nx, ny, tdt, device="cpu"), jgallery.fe(nx, ny, jdt)),
            (gallery.poisson_rhs(nx, ny, tdt, device="cpu"),
             jgallery.poisson_rhs(nx, ny, jdt)),
            (gallery.poisson_solution(nx, ny, tdt, device="cpu"),
             jgallery.poisson_solution(nx, ny, jdt)),
        ]
        for got, want in pairs:
            assert got.dtype == tdt
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gallery_default_dtype_and_device():
    """float64 by default; the device defaults to the card (checked
    without allocating there), and the CPU is taken when asked for."""
    so = gallery.poisson(8, 8, device="cpu")
    assert so.dtype == torch.float64 and so.device.type == "cpu"
    assert gallery.fe(4, 4, device="cpu").shape == (5, 4, 4)
    assert gallery.default_device() == torch.device("cuda")
    assert gallery.default_device("cpu") == torch.device("cpu")


def _random_so(rng, nx, ny, nine):
    from test_kernels_2d import random_so

    return random_so(rng, nx, ny, nine)


@pytest.mark.parametrize("shape", [(8, 8), (9, 7), (16, 13)])
@pytest.mark.parametrize("nine", [False, True])
def test_stencil2_matches_jax(shape, nine):
    rng = np.random.default_rng(5 + nine)
    so = _random_so(rng, *shape, nine)
    q = rng.standard_normal(shape)
    b = rng.standard_normal(shape)
    kind, jkind = ((StencilKind.nine_pt, JKind.nine_pt) if nine
                   else (StencilKind.five_pt, JKind.five_pt))
    jso, jq, jb = jnp.asarray(so), jnp.asarray(q), jnp.asarray(b)
    _close(stencil2.residual(_t(so), _t(q), _t(b), kind),
           jstencil2.residual(jso, jq, jb, jkind))
    _close(stencil2.matvec(_t(so), _t(q), kind),
           jstencil2.matvec(jso, jq, jkind))
    _close(stencil2.offdiag_apply(_t(so), _t(q), kind),
           jstencil2.offdiag_apply(jso, jq, jkind))
    got = stencil2.full_offsets(_t(so), kind)
    want = jstencil2.full_offsets(jso, jkind)
    assert list(got) == list(want)
    for off in want:
        _close(got[off], want[off])


# the configurations of tests/test_schema.py, plus Cedar's example config
CONFIGS = [
    {},
    {"solver": {"cycle": {"nrelax-pre": 1, "nrelax-post": 1}, "tol": 1e-10,
                "max-iter": 10, "num-levels": 7}},
    {
        "log": ["status", "error"],
        "grid": {"periodic": [False, False]},
        "solver": {
            "relaxation": "line-xy",
            "cycle": {"type": "v", "nrelax-pre": 2, "nrelax-post": 1},
            "tol": 1e-8, "max-iter": 10, "min-coarse": 3,
            "cg-solver": "redist",
            "ml-relax": {"enabled": False, "min-gsz": 3},
        },
        "redist": {"search": {"strategy": "coarsen"}},
        "machine": {"bandwidth": 177e6, "latency": 6.5e-7,
                    "fp_perf": 4.4e-10},
        "cg-config": {"solver": {"relaxation": "point"}},
    },
    {
        "solver": {"cg-solver": "cedar"},
        "cg-config": {
            "solver": {"cg-solver": "cedar"},
            "cg-config": {"solver": {"cg-solver": "LU", "max-iter": 5}},
        },
    },
    {"solver": {"cg-solver": "cedar"}},
    {"solver": {"relax-symmetric": False, "tol": 1e-8, "max-iter": 20}},
    {"solver": {"relaxation": "plane-xy"},
     "kernels": {"backend": "pallas", "fine-split": False}},
]

INVALID = [
    {"solver": {"cycle": {"nrelax_pre": 2}}},
    {"slover": {"max-iter": 3}},
    {"solver": {"relaxation": "pointy"}},
    {"solver": {"cg-solver": "QR"}},
    {"solver": {"max-iter": "ten"}},
    {"log": ["status", "verbose"]},
    {"cg-config": {"solver": {"relaxation": "bogus"}}},
]


def _settings_dict(s):
    """Every field of an MLSettings, enums by value, nested recursively."""
    out = {}
    for k, v in vars(s).items():
        if hasattr(v, "to_dict"):
            v = v.to_dict()
        elif hasattr(v, "value"):
            v = v.value
        elif k in ("cg_settings", "plane_settings") and v is not None:
            v = _settings_dict(v)
        elif k == "rsettings" and v is not None:
            v = {kk: getattr(vv, "value", vv) for kk, vv in vars(v).items()}
        out[k] = v
    return out


@pytest.mark.parametrize("cfg", CONFIGS)
def test_settings_copy_matches_jax(cfg):
    validate(cfg)
    got = MLSettings.from_config(Config(cfg))
    want = JMLSettings.from_config(JConfig(cfg))
    assert _settings_dict(got) == _settings_dict(want)
    assert str(got) == str(want)


@pytest.mark.parametrize("cfg", INVALID)
def test_schema_copy_rejects_like_jax(cfg):
    from cedar_tpu.schema import ConfigError as JConfigError
    from cedar_tpu.schema import validate as jvalidate

    with pytest.raises(JConfigError) as jerr:
        jvalidate(cfg)
    with pytest.raises(ConfigError) as err:
        validate(cfg)
    assert str(err.value) == str(jerr.value)


def test_config_copy_paths(tmp_path):
    c = Config({"solver": {"tol": 1e-6}})
    c.set("solver.cycle.nrelax-pre", 3)
    assert c.get("solver.cycle.nrelax-pre") == 3
    assert c.getvec("log", ["status"]) == ["status"]
    assert c.getconf("solver").get("tol") == 1e-6
    fname = tmp_path / "config.json"
    c.save(str(fname))
    assert Config(str(fname)).to_dict() == c.to_dict()
    assert json.loads(fname.read_text()) == c.to_dict()


def test_timelog(tmp_path):
    tl = TimeLog()
    tl.begin("setup")
    tl.end("setup", force=torch.zeros(1))
    tl.down()
    with tl.timing("relaxation"):
        pass
    tl.up()
    d = tl.todict()
    assert set(d) == {"level-0", "level-1"}
    assert d["level-1"]["relaxation"]["count"] == 1
    tl.save(str(tmp_path / "timings.json"))
    assert json.loads((tmp_path / "timings.json").read_text()) == d
    tl.begin("a")
    with pytest.raises(RuntimeError, match="timer mismatch"):
        tl.end("b")
