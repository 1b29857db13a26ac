"""The 95th percentile of the wall times of all sweeps in the window, each from
the call to the synchronised read of its log-evidence (Python's
``statistics.quantiles`` with n = 100, the exclusive method)."""

import statistics


def read(run):
    if len(run.times) < 20:
        return None
    return 1e3 * statistics.quantiles(run.times, n=100)[94]
