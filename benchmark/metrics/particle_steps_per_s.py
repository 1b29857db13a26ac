"""All the particle-steps of the sweeps completed in the window (C * N * T a
sweep) over the window's wall time, from a synchronised start to the
synchronised end of its last sweep."""


def read(run):
    return run.sweeps * run.particles_per_call * run.steps_per_sweep / run.window_s
