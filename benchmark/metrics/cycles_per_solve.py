"""``cycles_per_solve``: the cycles that the solve loop ran (the length of
the solver's ``history``), averaged over the window's solves."""


def read(run):
    if not run.solves:
        return None
    return sum(s.cycles for s in run.solves) / len(run.solves)
