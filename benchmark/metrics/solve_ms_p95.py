"""``solve_ms_p95``: the 95th percentile of the time of every solve of the
window, from the call until its ``x`` is ready on the device, in ms; the
host's clock.  Linear between the two nearest solves
(``statistics.quantiles``, inclusive)."""

import statistics


def read(run):
    times = [1e3 * s.seconds for s in run.solves]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=20, method="inclusive")[18]
