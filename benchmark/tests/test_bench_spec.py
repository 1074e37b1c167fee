"""``BENCHMARK.json`` against the benchmark's contract, and every
configuration, mix and metric found by name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

SPEC = json.loads(harness.SPEC.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(harness.SPEC.read_bytes()) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        # each key cut from the source is explained in the file
        assert set(c["reduced"]) <= set(data["assumed"])


def test_workloads():
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len(set(CELLS)) == len(CELLS)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_metrics():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert _line(m["layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.config["grid"] and c.traffic["name"]
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["end_to_end"]
                                  + SPEC["per_layer"]])
def test_metric_reader_found_by_name(name):
    assert callable(harness.load_metric(name).read)


def test_unknown_cell():
    with pytest.raises(KeyError):
        harness.load_cell("no-such.cell")


def test_a_new_cell_is_files_and_entries(tmp_path, monkeypatch):
    """A cell, mix and metric added as new files and entries run with no
    edit of the harness."""
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics"):
        (bench / sub).mkdir(parents=True)
    cfg = json.loads((harness.BENCH / "configs" /
                      "poisson2d-5pt-8192-f64.json").read_text())
    cfg["name"], cfg["grid"] = "poisson2d-5pt-15-f64", [15, 15]
    (bench / "configs" / "poisson2d-5pt-15-f64.json").write_text(
        json.dumps(cfg))
    mix = json.loads((harness.BENCH / "traffic" / "rhs.json").read_text())
    mix["name"], mix["warm_solves"] = "rhs-once", 0
    (bench / "traffic" / "rhs-once.json").write_text(json.dumps(mix))
    (bench / "metrics" / "solves_done.py").write_text(
        "def read(run):\n    return len(run.solves)\n")
    import benchmark.metrics

    monkeypatch.setattr(benchmark.metrics, "__path__",
                        [*benchmark.metrics.__path__, str(bench / "metrics")])
    spec = dict(SPEC)
    spec["configs"] = [{"name": "poisson2d-5pt-15-f64", "source": "test",
                        "file": "benchmark/configs/poisson2d-5pt-15-f64.json",
                        "reduced": [], "why": "test"}]
    spec["workloads"] = [{"name": "p15.once", "config": "poisson2d-5pt-15-f64",
                          "traffic": "rhs-once", "chips": 1, "why": "test"}]
    spec["end_to_end"] = [{"name": "solves_done", "unit": "solves",
                           "better": "higher", "bound": 0.05,
                           "source": "host_clock"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "BENCH", bench)
    cell = harness.load_cell("p15.once", tmp_path / "BENCHMARK.json")
    import time

    import torch

    out = harness.run(cell, 5, 0.05, False, torch.device("cpu"),
                      time.perf_counter())
    assert out["correct"]
    assert out["metrics"]["solves_done"]["value"] == out["attempted"] >= 1


def _mix(**change):
    mix = json.loads((harness.BENCH / "traffic" / "rhs.json").read_text())
    mix.update(change)
    return mix


@pytest.mark.parametrize("mix", SPEC["workloads"], ids=CELLS)
def test_every_mix_is_implemented(mix):
    name = mix["traffic"]
    harness.check_mix(json.loads((harness.BENCH / "traffic" /
                                  f"{name}.json").read_text()))


@pytest.mark.parametrize("change, word", [
    ({"clients": 4}, "clients"),
    ({"x0": "previous"}, "x0"),
    ({"loop": "open"}, "loop"),
    ({"rhs": "uniform"}, "rhs"),
    ({"rhs_scale": "one"}, "rhs_scale"),
    ({"warm_solves": -1}, "warm_solves"),
    ({"check_solves": 2.5}, "check_solves"),
    ({"rate_hz": 10}, "rate_hz"),
    ({"name": ""}, "name"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_a_mix_the_generator_does_not_implement_is_refused(change, word):
    """A mix with a value or a key that the generator does not act on is
    refused, never run as another mix under its name."""
    with pytest.raises(ValueError, match=word):
        harness.check_mix(_mix(**change))


def test_a_mix_without_a_key_is_refused():
    mix = _mix()
    del mix["x0"]
    with pytest.raises(ValueError, match="x0"):
        harness.check_mix(mix)


def test_a_cell_with_an_unimplemented_mix_is_refused(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    (bench / "traffic").mkdir(parents=True)
    (bench / "traffic" / "rhs4.json").write_text(json.dumps(
        _mix(name="rhs4", clients=4)))
    spec = dict(SPEC)
    spec["workloads"] = [dict(SPEC["workloads"][0], name="p.rhs4",
                              traffic="rhs4")]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "BENCH", bench)
    with pytest.raises(ValueError, match="clients"):
        harness.load_cell("p.rhs4", tmp_path / "BENCHMARK.json")


def test_layers_named_in_perf_md():
    perf = (harness.ROOT / "PERF.md").read_text()
    for m in SPEC["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_paths_hold_only_the_benchmark():
    root = harness.ROOT
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert (root / p).is_dir() and not Path(p).is_absolute()
        assert ".." not in Path(p).parts
