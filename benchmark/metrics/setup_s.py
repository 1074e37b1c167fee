"""``setup_s``: the run's set-up, from the start of the process to the
first timed solve (imports, the kernels' load or build, the operator made
on the device, the solver's setup, the solve graph's warm-up and capture,
the warm solves), in s; the host's clock."""


def read(run):
    return run.setup_s
