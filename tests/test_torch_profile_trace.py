"""``cedar_tpu_torch.utils.timing.profile_trace`` on the CPU: a small solve
inside it writes a Chrome-trace JSON file under the log directory, with
the solver's stage annotations (``timing.scope``) in it."""

import json

import torch

from cedar_tpu_torch import FivePt, Solver2, gallery
from cedar_tpu_torch.utils.timing import profile_trace

torch.set_num_threads(2)


def test_profile_trace_writes_json(tmp_path):
    s = Solver2(gallery.poisson(33, 33, device="cpu"), FivePt,
                {"log": [], "solver": {"max-iter": 2}})
    b = gallery.poisson_rhs(33, 33, device="cpu")
    with profile_trace(tmp_path / "trace"):
        x = s.solve(b)
    assert torch.isfinite(x).all() and len(s.history) == 2
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"relaxation-residual-fused", "restrict", "interp-add",
            "coarse-solve"} <= names


def test_profile_trace_propagates(tmp_path):
    """An exception in the block ends the trace and is not caught."""
    try:
        with profile_trace(tmp_path / "t"):
            raise KeyError("inside")
    except KeyError as e:
        assert e.args == ("inside",)
    else:
        raise AssertionError("profile_trace swallowed the exception")
