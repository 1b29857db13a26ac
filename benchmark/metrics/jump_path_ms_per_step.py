"""Device time of the records the Lévy dynamics enqueue inside their
``aps.jump_path`` spans (a step's Gamma-process jump path, its keyed draws
included, and its mean and covariance) over the window's steps, in ms.

The span nests inside ``aps.propagate_score``, where ``spans.device_us``
would give the records enqueued after it to no span.  So each record is
paired with the call that enqueued it (``benchmark.spans.pairs``) and counted
where that call lies inside an ``aps.jump_path`` interval, whatever span
holds that one.  None where the window holds no such span or no device
record, or the pairing fails."""

import bisect

from benchmark import spans

SPAN = "aps.jump_path"


def read(run):
    w = run.window
    inside = [(a, b) for a, b, name in spans.spans(w) if name == SPAN]
    if not inside or not w.device:
        return None
    paired = spans.pairs(w)
    if paired is None:
        return None
    starts = [a for a, _ in inside]
    us = 0.0
    for at, a, b in paired:
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= inside[i][1]:
            us += b - a
    return us / 1e3 / run.window_steps
