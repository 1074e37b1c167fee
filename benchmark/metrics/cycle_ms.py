"""``cycle_ms``: the device time of what the graph replays of the traced
solves ran (the union of the intervals of their kernels and copies, from
``torch.profiler``'s CUDA activity), over the cycles that those solves
ran, in ms."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    busy = run.trace.replay_busy_s()
    if busy is None:
        return None
    cycles = sum(s.cycles for s in run.traced)
    return 1e3 * busy / cycles
