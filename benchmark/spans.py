"""The program's spans in a traced window, and the device time each holds.

The sweep marks its phases with ``aps.*`` spans (``torch.profiler.record_function``
while a profiler records).  The profiler writes them among the host's events
(``trace.Window.host``), on the clock of the host's runtime calls.

The device's records keep a clock of their own: on the H100 machine their
offset from the host's clock drifted by tens of microseconds to milliseconds
within one window, so no reader here compares a device time with a host
time.  A device record is placed by the runtime call that enqueued it.  On
the program's one stream the device runs records in the order the host
enqueued them, so the k-th record pairs with the k-th call that enqueues
one: a kernel with a launch (``trace.LAUNCH_PREFIXES``), a ``Memcpy*``
record with a ``cudaMemcpy*`` call, a ``Memset*`` record with a
``cudaMemset*`` call.  The pairing checks itself: where a kind's records and
calls differ in number, or the k-th record is of another kind than the k-th
call enqueues, it gives None and writes one line on stderr saying what
failed.  It never guesses.  A record belongs to the span whose host interval
holds its call.
"""

from __future__ import annotations

import bisect
import sys
from collections import Counter

from benchmark import trace

PREFIX = "aps."
#: Each kind of device record, by the prefix of its name, and the runtime
#: calls that enqueue it.
KINDS = (("kernel", None, trace.LAUNCH_PREFIXES),
         ("copy", "Memcpy", ("cudaMemcpy", "cuMemcpy")),
         ("set", "Memset", ("cudaMemset", "cuMemset")))


def spans(w: trace.Window) -> list:
    """The window's spans of the program, ``(start, end, name)`` in order."""
    return sorted((a, b, name) for name, a, b in w.host if name.startswith(PREFIX))


def counts(w: trace.Window) -> Counter:
    return Counter(name for name, _, _ in w.host if name.startswith(PREFIX))


def _record_kind(name: str) -> str:
    for kind, prefix, _ in KINDS[1:]:
        if name.startswith(prefix):
            return kind
    return "kernel"


def _call_kind(name: str):
    for kind, _, calls in KINDS:
        if name.startswith(calls):
            return kind
    return None


def _log(msg: str):
    print(f"spans: {msg}", file=sys.stderr, flush=True)


def pairs(w: trace.Window):
    """Every device record of the window with the call that enqueued it, in
    the order they ran: ``[(call_start, start, end)]``, the call on the
    host's clock and the record on the device's.  None where the pairing
    fails (one line on stderr)."""
    recs = sorted((a, b, _record_kind(name)) for name, a, b in w.device)
    calls = sorted((a, kind) for name, a, _ in w.runtime
                   if (kind := _call_kind(name)) is not None)
    n_recs, n_calls = Counter(k for _, _, k in recs), Counter(k for _, k in calls)
    for kind, _, _ in KINDS:
        if n_recs[kind] != n_calls[kind]:
            _log(f"{n_recs[kind]} {kind} records against {n_calls[kind]} calls "
                 "that enqueue them")
            return None
    for i, ((_, _, got), (_, want)) in enumerate(zip(recs, calls)):
        if got != want:
            _log(f"record {i} is a {got}, and call {i} enqueues a {want}")
            return None
    return [(at, a, b) for (a, b, _), (at, _) in zip(recs, calls)]


def device_us(w: trace.Window):
    """Device µs of the records enqueued in each span, by span name (``""``
    for the records enqueued outside every span); None where the window
    holds no span of the program or no device record, or the pairing fails."""
    sp = spans(w)
    if not sp or not w.device:
        return None
    paired = pairs(w)
    if paired is None:
        return None
    starts = [a for a, _, _ in sp]
    out = Counter()
    for at, a, b in paired:
        i = bisect.bisect_right(starts, at) - 1
        out[sp[i][2] if i >= 0 and at <= sp[i][1] else ""] += b - a
    return out


def span_ms(w: trace.Window, name: str):
    """Device ms of the records enqueued in the spans ``name``; None where
    the window holds no such span or no device record, or the pairing fails."""
    if not counts(w)[name]:
        return None
    t = device_us(w)
    return None if t is None else t[name] / 1e3


def gate_idle_us(w: trace.Window):
    """The device's idle µs at the gate's reads, summed: for each ``aps.gate``
    span, from the end of the records enqueued before the span closes (the
    read drains the stream) to the start of the first record enqueued after
    it, both on the device's clock.  None where the window holds no gate
    span or no device record, or the pairing fails."""
    gates = [b for _, b, name in spans(w) if name == f"{PREFIX}gate"]
    if not gates or not w.device:
        return None
    paired = pairs(w)
    if paired is None:
        return None
    at = [c for c, _, _ in paired]
    done, end = [], -float("inf")  # done[k]: the latest end of records 0..k
    for _, _, b in paired:
        end = max(end, b)
        done.append(end)
    idle = 0.0
    for close in gates:
        k = bisect.bisect_right(at, close)
        if 0 < k < len(paired):
            idle += max(0.0, paired[k][1] - done[k - 1])
    return idle
