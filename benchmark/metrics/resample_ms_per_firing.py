"""Device time of the records the sweep enqueues inside its ``aps.resample``
spans (a firing's extents, decode and move, the reference's splice, the
ancestor row and the chains' ``where``) over the count of those spans in the
window, in ms; None where none fired."""

from benchmark import spans


def read(run):
    t = spans.span_ms(run.window, "aps.resample")
    return None if t is None else t / spans.counts(run.window)["aps.resample"]
