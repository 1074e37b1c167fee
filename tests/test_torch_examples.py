"""The port's serial examples (``cedar_tpu_torch.examples``) against the
cedar_tpu examples of the same name (``examples/*.py``), on the CPU at a
small size.

Each port example's ``main`` runs with ``--device cpu``; the JAX example
runs through ``runpy`` with ``sys.argv`` patched and the working directory
set to ``tmp_path`` (the 2D one writes ``timings.json`` there, as the port
one does).  The printed error norms agree to rtol 1e-3 (float32 solves,
whose error is dominated by discretisation; ``capi_poisson`` solves in
float64), and the plane-relaxation example's cycle count exactly.
"""

import json
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cedar_tpu_torch.examples import (
    anisotropic_3d_planes, basic_2d_ser, basic_3d_ser, capi_poisson,
)

torch.set_num_threads(2)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _jax_example(name: str, args, tmp_path, monkeypatch, capsys) -> str:
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *map(str, args)])
    capsys.readouterr()
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


def _norm(text: str) -> float:
    return float(re.search(r"Solution norm: (\S+)", text).group(1))


# name -> (port module, size arguments)
CASES = {
    "basic_2d_ser": (basic_2d_ser, [64, 48]),
    "basic_3d_ser": (basic_3d_ser, [16]),
    "capi_poisson": (capi_poisson, []),
}


@pytest.mark.parametrize("name", list(CASES))
def test_example_matches_cedar_tpu(name, tmp_path, monkeypatch, capsys):
    mod, args = CASES[name]
    want = _norm(_jax_example(name, args, tmp_path, monkeypatch, capsys))
    out = mod.main([*map(str, args), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert out[-1] == "Finished Test" and out[0] in printed
    got = _norm(out[0])
    np.testing.assert_allclose(got, want, rtol=1e-3)
    if name == "basic_2d_ser":
        # the port's timers, in the reference's layout, beside JAX's
        mine = json.loads((tmp_path / "timings.json").read_text())
        assert set(mine["level-0"]) == {"setup", "solve"}


def test_planes_example_matches_cedar_tpu(tmp_path, monkeypatch, capsys):
    jout = _jax_example("anisotropic_3d_planes", [16], tmp_path, monkeypatch,
                        capsys)
    out = anisotropic_3d_planes.main(["16", "--device", "cpu"])
    want = re.search(r"converged in (\d+) cycles", jout).group(1)
    assert re.match(rf"converged in {want} cycles \(first-cycle reduction ",
                    out[0]), (out[0], jout)
    assert out[-1] == "Finished Test"


def test_examples_default_to_the_card():
    """Without ``--device`` an example asks for the card: on a host without
    one it raises rather than solving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for mod, size in ((basic_2d_ser, ["8"]), (basic_3d_ser, ["8"]),
                      (anisotropic_3d_planes, ["8"]), (capi_poisson, [])):
        with pytest.raises((RuntimeError, AssertionError)):
            mod.main(size)
