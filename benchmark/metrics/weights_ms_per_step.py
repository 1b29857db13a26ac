"""Device time of the records the sweep enqueues inside its ``aps.weights``
spans (a step's max, exponentials, sums, log-sum-exp, log-evidence and ESS)
over the window's steps, in ms; each record paired with the call that
enqueued it (``benchmark.spans``)."""

from benchmark import spans


def read(run):
    t = spans.span_ms(run.window, "aps.weights")
    return None if t is None else t / run.window_steps
