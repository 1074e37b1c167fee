"""The trace's arithmetic: the union of intervals, the idle gaps and the
breakdown, on a trace built by hand."""

from pytest import approx

from benchmark import harness
from benchmark import profile_reader as pr


def make_trace():
    # two spans; device work: a randn (corr 1), two graph replays (corr 2,
    # 3; their kernels overlap), a copy (corr 4)
    return pr.Trace(
        device=[(10, 20, "normal_kernel", 1), (30, 50, "k_a", 2),
                (40, 60, "k_b", 2), (70, 80, "k_a", 3),
                (90, 95, "Memcpy DtoH", 4)],
        host=[(5, 25, "aten::randn", 0, "cpu_op"),
              (6, 7, "cudaLaunchKernel", 1, "cuda_runtime"),
              (28, 29, "cudaGraphLaunch", 2, "cuda_runtime"),
              (65, 66, "cudaGraphLaunch", 3, "cuda_runtime"),
              (85, 96, "aten::_local_scalar_dense", 0, "cpu_op"),
              (86, 87, "cudaMemcpyAsync", 4, "cuda_runtime")],
        spans=[(0, 25, "bench.make_b"), (25, 100, "bench.solve")],
        graph_launches={2, 3}, counts={})


def test_union_and_busy():
    assert pr.union([(3, 5), (1, 2), (4, 8), (8, 9)]) == [(1, 2), (3, 9)]
    t = make_trace()
    assert t.window == (0, 100)
    assert t.busy() == [(10, 20), (30, 60), (70, 80), (90, 95)]
    assert t.busy_s() == approx(55e-9) and t.window_s() == approx(100e-9)
    # the replays' kernels overlap: their union, not their sum
    assert t.replay_busy_s() == approx(40e-9)


def test_gaps_are_named():
    gaps = make_trace().gaps()
    assert [round(s * 1e9) for s, _ in gaps] == [10, 10, 10, 10, 5]
    names = [n for _, n in gaps]
    assert names[0] == "bench.make_b: start -> aten::randn"
    assert names[1] == "bench.make_b: aten::randn -> cudaGraphLaunch"
    assert names[3] == ("bench.solve: cudaGraphLaunch -> "
                        "aten::_local_scalar_dense")
    assert names[4] == "bench.solve: aten::_local_scalar_dense -> end"


def test_breakdown():
    bd = make_trace().breakdown(top=2)
    assert [n for n, _ in bd["device_ops"]] == ["k_a", "k_b"]
    assert [v for _, v in bd["device_ops"]] == approx([30e-9, 20e-9])
    assert len(bd["idle_gaps"]) == 2
    assert all(v > 0 for _, v in bd["idle_gaps"])


def test_no_replay_reads_nothing():
    t = make_trace()
    t.graph_launches = set()
    assert t.replay_busy_s() is None


def _record(trace, window, traced, window_s):
    return harness.RunRecord(
        cell=None, device={}, setup_s=0.0, spans={}, solver_setup_s=0.0,
        solves=[harness.Solve(0.0, c, True) for c in window],
        window_s=window_s,
        traced=[harness.Solve(0.0, c, True) for c in traced], trace=trace)


def test_device_idle_reads_the_window_wall_time():
    """Busy a cycle from the trace (55 ns over 2 traced solves of 1 and 4
    cycles: 11 ns), wall a cycle from the window (3 solves of 5 cycles in
    200 ns: 13.33 ns)."""
    idle = harness.load_metric("device_idle")
    run = _record(make_trace(), [5, 5, 5], [1, 4], 200e-9)
    assert idle.read(run) == approx(100 * (1 - 11 / (200 / 15)))


def test_cycle_ms_reads_the_traced_solves():
    """The replays' union (40 ns) over the traced solves' 5 cycles."""
    run = _record(make_trace(), [5, 5, 5], [1, 4], 200e-9)
    assert harness.load_metric("cycle_ms").read(run) == approx(8e-6)


def test_device_idle_without_a_trace_reads_nothing():
    idle = harness.load_metric("device_idle")
    assert idle.read(_record(make_trace(), [5], [], 1.0)) is None
    assert idle.read(_record(None, [5], [1, 4], 1.0)) is None
