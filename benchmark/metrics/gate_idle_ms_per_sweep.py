"""The device's idle time at the ESS gate's host reads: for each ``aps.gate``
span, from the end of the records enqueued before it closes to the start of
the first record enqueued after it, summed over the window's sweeps, in ms
(``benchmark.spans``)."""

from benchmark import spans


def read(run):
    t = spans.gate_idle_us(run.window)
    return None if t is None else t / 1e3 / run.window_sweeps
