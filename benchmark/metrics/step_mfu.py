"""The least time the card could take for the window's steps, from the
configuration's essential work a particle-step (its ``step_work``: bytes,
float32 FLOPs, int32 operations; the kernels the program happens to launch
are not counted) at the card's peaks, over the device's busy time in the
window, in percent."""

from benchmark import manifest
from benchmark.roofline import bound_s


def read(run):
    if not run.window.busy_s:
        return None
    work = run.cell.reference.step_work(run.cell.config, run.particles_per_call)
    return 100.0 * bound_s(work, manifest.peaks()) * run.window_steps / run.window.busy_s
