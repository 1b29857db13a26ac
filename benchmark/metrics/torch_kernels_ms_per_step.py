"""Device time of every kernel that PyTorch or its libraries launch (all but
the program's own kernels of ``csrc/``) over the window's steps, in ms."""

from benchmark.roofline import port_kernel


def read(run):
    if not run.window.kernels:
        return None
    t = sum(b - a for name, a, b in run.window.kernels if port_kernel(name) is None)
    return t / 1e3 / run.window_steps
