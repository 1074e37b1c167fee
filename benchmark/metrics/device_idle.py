"""``device_idle``: the share of the window's time in which the device was
idle, in %: one less the device's busy time a cycle (the union of its
kernels, copies and fills over the solves traced after the window, from
the first ``bench.`` span's start to the last one's end) over the
window's wall time a cycle (its seconds over its solves' cycles).

The wall time is read without the profiler, because under it the launch
of a graph of some thousands of kernels takes milliseconds (CUPTI records
each of them), which the device spends idle and an untraced window does
not.  None where the trace holds no device activity (a run off the
card)."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    traced = sum(s.cycles for s in run.traced)
    cycles = sum(s.cycles for s in run.solves)
    if not traced or not cycles:
        return None
    busy = run.trace.busy_s() / traced
    wall = run.window_s / cycles
    return 100.0 * (1.0 - busy / wall)
