"""The profiler's synchronising runtime calls (stream, device or event
synchronise, synchronous copies) over the window's sweeps: the gate's read a
step and the harness's read of each sweep's log-evidence."""


def read(run):
    if not run.window.runtime:
        return None
    return run.window.syncs / run.window_sweeps
