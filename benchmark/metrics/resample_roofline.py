"""The resampling kernels' summed bound (``kernels/``, layer ``resampling``)
over their summed device time in the window, in percent."""

from benchmark.roofline import layer_share


def read(run):
    return layer_share(run, "resampling")
