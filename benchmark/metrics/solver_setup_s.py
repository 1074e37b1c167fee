"""``solver_setup_s``: the solver's own setup timer (``TimeLog`` "setup"
of ``Solver2``/``Solver3``, which synchronises the card before it reads
the clock): the hierarchy, the plane hierarchies, the coarse inverse, in
s."""


def read(run):
    return run.solver_setup_s
