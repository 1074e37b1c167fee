"""``run.py`` as a checkout runs it: without a card it exits with another
code than 0 and prints no result, and so it does in a checkout that holds
only the benchmark."""

import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ARGS = ["--workload", "poisson2d-8192.rhs", "--seed", str(2**31 + 9),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is here: the run would measure")
    out = _run(harness.ROOT)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(harness.SPEC, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


def test_unknown_workload_fails():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "nope", "--seed", "1", "--seconds", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
