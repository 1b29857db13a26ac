"""The profiler's runtime and driver launch calls (``cudaLaunchKernel``,
``cudaLaunchCooperativeKernel``, ``cuLaunchKernel`` and the like, from PyTorch,
its libraries and the program's own library alike) over the window's steps
(sweeps times T, all chains of a batch together)."""


def read(run):
    if not run.window.runtime:
        return None
    return run.window.launches / run.window_steps
