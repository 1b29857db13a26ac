"""Spans of the sweep on the profiler's clock.

:func:`spans` gives a sweep its ``span(name)``: :func:`torch.profiler.record_function`
while a :mod:`torch.profiler` session records, and otherwise a shared no-op
context.  A sweep asks once, at its entry, so with no profiler its loop never
enters ``record_function``, whose dispatcher call costs microseconds.  There
is no switch: tracing is on exactly when a profiler records.

The sweep's spans (:func:`~advancedps_tpu_torch.engine.sweep`, one chain or a
chain batch alike; none nests in another):

* ``aps.setup``: sweep entry to the loop (the reference, ``kernel.init``, the
  buffers; for chains the key table), once a sweep;
* ``aps.weights``: a step's max, exponentials, sums, log-evidence and ESS,
  ``T − 1`` a sweep;
* ``aps.gate``: the host's read of the ESS gate, ``T − 1`` a sweep below
  threshold 1, none at 1 (the gate is not read);
* ``aps.resample``: a firing, from the reference's ancestor to the ancestor
  row's write, once a firing;
* ``aps.keep``: a step that does not fire, its identity ancestor row;
* ``aps.propagate_score``: ``kernel.step``, the weights' update and the
  snapshot, ``T − 1`` a sweep;
* ``aps.close``: the final log-sum-exp and the result, once a sweep.

So the count of ``aps.resample`` spans is the count of firings, and the count
of ``aps.gate`` spans the count of the gate's reads.

Two spans of a model nest in ``aps.propagate_score``, one after the other:
the Lévy dynamics' ``aps.jump_path`` (the Gamma-process jump path, its mean
and covariance) and ``aps.factor_draw`` (the transition's mean, the factor
and the Gaussian draw), in
:meth:`~advancedps_tpu_torch.models.levy.LevyLangevinDynamics.sample`.  It
runs under :func:`torch.func.vmap`, whose Python body runs once a call, so
each is entered once a step.  They split the model's step, which no span of
the engine sees into.  A reader that places a device record in the latest
span opened before its call (``benchmark/spans.py``) then gives
``aps.propagate_score`` only what is enqueued before the path, and no span
what follows the draw (the score, the weights' update).
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

__all__ = ["PREFIX", "spans"]

#: The prefix of every span the sweep records.
PREFIX = "aps."

_NO_SPAN = contextlib.nullcontext()


def _no_span(name: str):
    return _NO_SPAN


def spans():
    """The ``span(name)`` context maker for one sweep: ``record_function``
    while a profiler records, else one that does nothing."""
    return record_function if _autograd_profiler._is_profiler_enabled else _no_span
