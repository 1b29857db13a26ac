"""One minus the union of the device's kernel, copy and set records over the
traced window, in percent."""


def read(run):
    if not run.window.device:
        return None
    return 100.0 * (1.0 - run.window.busy_s / run.window.wall_s)
