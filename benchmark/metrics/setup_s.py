"""From the harness's first line to the first timed sweep: imports, CUDA
initialisation, loading (or, in a fresh checkout, building) the kernels,
making the inputs and the warm sweeps."""


def read(run):
    return run.setup_s
