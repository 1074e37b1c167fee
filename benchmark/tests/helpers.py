"""Shared pieces of the benchmark's tests: the cells at a size that a test
run holds."""

import time

import torch

from benchmark import harness

#: each cell's grid in the tests
TINY = {"poisson2d-8192.rhs": [31, 31], "planexy-128.rhs": [12, 12, 12]}


def tiny_cell(name: str) -> harness.Cell:
    """The cell ``name`` of ``BENCHMARK.json`` on its test grid."""
    cell = harness.load_cell(name)
    cell.config["grid"] = list(TINY[name])
    return cell


def run_tiny(name: str, device=torch.device("cpu"), seed: int = 7,
             seconds: float = 0.3, trace: bool = False) -> dict:
    """One run of the tiny cell, past the harness's look for a card."""
    return harness.run(tiny_cell(name), seed, seconds, trace, device,
                       time.perf_counter())
