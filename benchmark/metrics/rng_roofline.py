"""The Threefry kernels' summed bound (``kernels/``, layer ``draws``) over their
summed device time in the window, in percent."""

from benchmark.roofline import layer_share


def read(run):
    return layer_share(run, "draws")
