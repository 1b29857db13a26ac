"""Device time of the records the sweep enqueues inside its
``aps.propagate_score`` spans (the model's step with its keyed draws, the
weights' update and the snapshot) over the window's steps, in ms; each record
paired with the call that enqueued it (``benchmark.spans``)."""

from benchmark import spans


def read(run):
    t = spans.span_ms(run.window, "aps.propagate_score")
    return None if t is None else t / run.window_steps
