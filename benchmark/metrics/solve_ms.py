"""``solve_ms``: the window's time over the solves completed in it (all
the work over all the time: the right-hand sides made, the solves, the
waits), in ms; the host's clock."""


def read(run):
    if not run.solves:
        return None
    return 1e3 * run.window_s / len(run.solves)
