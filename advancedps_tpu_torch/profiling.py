"""The port's profiles: the counterparts of the JAX system's
``profiling/profile_sweep.py``, ``profile_pgas.py``, ``profile_resample.py``
and ``bench_move_versions.py``.

    python -m advancedps_tpu_torch.profiling sweep [--reps 10] [--trace DIR]
    python -m advancedps_tpu_torch.profiling pgas [--reps 4]
    python -m advancedps_tpu_torch.profiling resample [--reps 20]
    python -m advancedps_tpu_torch.profiling moves [--reps 3]

Every subcommand takes ``--device``; without it it runs on the GPU and raises
where there is no CUDA device.  The model is :mod:`~advancedps_tpu_torch.bench`'s
LGSSM at N = 1M, T = 100, none of it cut.

Each subcommand breaks a workload into components.  A component is a function
of a key that runs one piece of the engine's path, over the steps it covers,
and reads a host value at its end.  It is called once to warm up, ``reps``
times on fresh keys, each timed by the host clock from a synchronised start to
that read, and once more under :mod:`torch.profiler` (the shortest
components first).  Its readings:

* ``device_ms``: the device time of the profiled call, its kernels, copies and
  memsets summed (on the CPU: its top-level operators' time);
* ``host_median_ms``, ``host_min_ms``, ``host_max_ms`` of the timed calls;
* ``launches``: the device-side records of the profiled call (on the CPU: its
  top-level operators), and ``launches_per_step`` over the steps it covers;
* ``busy_share``: the union of those records' intervals over the profiled
  call's wall time.

* ``sweep`` (``profile_sweep.py``): the ESS-gated sweep, the never-resampling
  sweep, the propagate + score loop (its ``StepRng`` from
  :func:`~advancedps_tpu_torch.engine.propagate_rng`, as the sweep builds it),
  the ``pos_normal`` loop, the weight-reduction loop and the dynamic-gather
  loop.  The gated sweep's ten device operations of most time and the five
  longest idle gaps of the device, each named by the host operator that
  overlaps most of it and the one the host had entered last when it began.
  ``spans``: the gated sweep's device ms and count by ``aps.*`` span
  (:mod:`~advancedps_tpu_torch.tracing`), each device record in the span that
  holds its launch (the runtime call of its correlation id; on the CPU the
  operators a span calls directly stand in), and ``span_share``, their sum
  over the sweep's device ms.  ``faithfulness``: (propagate + score + reductions) /
  the never-resampling sweep, on device time.  ``--trace DIR`` writes the
  profiled gated sweep's Chrome trace there.
* ``pgas`` (``profile_pgas.py``): one PGAS iteration with replay storage and
  its nine phases, each alone: the iteration, the conditional sweep,
  propagate + score with the reference slot injected, the weight reductions,
  B1 and B4 with the guard, the ancestor draw, the reference-row splice, and
  the replay with the retained draw.  ``faithfulness``: the six per-step parts
  over the conditional sweep; ``iteration_ratio``: (sweep + replay) over the
  iteration.
* ``resample`` (``profile_resample.py``): B1, B4 on one column, B2 and the
  plain float64 ``cumsum`` chain that B1 replaced, each called ``inner``
  times on one sweep's final weights, and the gated sweep's firings.
* ``moves`` (``bench_move_versions.py``): the decode + move of each
  ``MOVE_VERSION`` (0: B5 and a gather, 1: B4, 6: B2 and B3) on even,
  skewed and degenerate extents drawn with numpy, on one and two columns.
  Every version must decode the same ancestors and move bitwise the same
  rows, or :class:`~advancedps_tpu_torch.bench.AnchorError` is raised.

Each subcommand writes its diagnostics to stderr and prints one JSON line to
stdout in :mod:`~advancedps_tpu_torch.bench`'s format: ``value`` is the
headline component's device ms, ``vs_baseline`` null, the host times those of
the headline component, ``launches`` the resampling kernels' launches over
every call, ``rng_launches`` the positional Threefry's
(:mod:`~advancedps_tpu_torch.ops.threefry`), and ``components`` the readings by
component.
"""

from __future__ import annotations

import argparse
import bisect
import math
import os
import statistics
import time
from collections import Counter
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from . import _tree, bench, models, rng, tracing
from ._device import resolve_device
from .engine import SweepKernel, _reduce_weights, propagate_rng, replay_trajectory
from .engine import sweep as run_sweep
from .inference import step_pg
from .ops import resample as ops
from .ops import threefry
from .pg import PGAS, PGState
from .resampling import ResampleWithESSThreshold, randcat_gumbel, resample_systematic
from .smc import SMC, SSMKernel
from .ssm import simulate

__all__ = ["FAITHFUL", "MOVE_PROFILES", "REPS", "SUBCOMMANDS", "faithfulness", "main", "move_extents",
           "moves", "pgas", "propagate_score", "resample", "retained_draw", "sweep"]

N, T = bench.N, bench.T
#: The range outside which a breakdown does not explain what it decomposes
#: (``profile_sweep.py:186``).
FAITHFUL = (0.5, 1.5)
#: Timed calls of each component by subcommand (the JAX scripts' ``--reps``),
#: and the calls a component of ``resample`` and ``moves`` makes (their inner
#: scan).
REPS = {"sweep": 10, "pgas": 4, "resample": 20, "moves": 3}
INNER = 16
#: Ops and gaps listed for the headline component.
TOP_OPS, TOP_GAPS = 10, 5
#: bench_move_versions.py:56-67, and the versions its check compares.
MOVE_PROFILES = ("even", "skewed", "degenerate")
MOVE_DIMS = (1, 2)
#: Kineto drops a device record whose converted timestamp falls outside the
#: window, so the window stays open this long before and after the call.
PROFILER_PAD_S = 0.02

log = bench.log


def faithfulness(readings: Dict[str, dict], parts: Sequence[str], whole: str) -> float:
    """The parts' device time over the whole's (``profile_sweep.py:176-193``)."""
    total = readings[whole]["device_ms"]
    return sum(readings[p]["device_ms"] for p in parts) / total if total > 0 else math.nan


def _is_span(e) -> bool:
    return e.name.startswith(tracing.PREFIX)


def _caller(e):
    """The operator that called ``e``, through the sweep's spans."""
    p = e.cpu_parent
    while p is not None and _is_span(p):
        p = p.cpu_parent
    return p


def _records(prof, label: str, device: torch.device):
    """The activity of the call profiled under ``record_function(label)``
    (its device-side kernels, copies and memsets; on the CPU the operators it
    calls directly, the sweep's spans passed through) and the host's events
    (operators, spans and runtime calls)."""
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    if device.type == "cuda":
        # Kineto also records each annotation's span on the device: not work.
        return [e for e in events if e.device_type == DeviceType.CUDA and e.name != label
                and not _is_span(e) and not getattr(e, "is_user_annotation", False)], host
    direct = []
    for e in host:
        caller = None if _is_span(e) else _caller(e)
        if caller is not None and caller.cpu_parent is None and caller.name == label:
            direct.append(e)
    return direct, host


def _span_readings(activity, host, device: torch.device) -> dict:
    """Device ms and count of each ``aps.*`` span in a profiled call.  A
    device record belongs to the span that holds its launch: the runtime call
    with the record's correlation id.  On the CPU the operators that a span
    calls directly stand in for its records."""
    spans = sorted((e for e in host if _is_span(e)), key=lambda e: e.time_range.start)
    out = {}
    for e in spans:
        out.setdefault(e.name, {"count": 0, "device_ms": 0.0})["count"] += 1
    if device.type != "cuda":
        for e in host:
            if not _is_span(e) and e.cpu_parent is not None and _is_span(e.cpu_parent):
                ms = (e.time_range.end - e.time_range.start) / 1e3
                out[e.cpu_parent.name]["device_ms"] += ms
        return out
    starts = [e.time_range.start for e in spans]
    launched = {e.id: e.time_range.start for e in host if e.name.startswith(("cuda", "cu"))}
    for d in activity:
        at = launched.get(d.id)
        i = -1 if at is None else bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= spans[i].time_range.end:
            out[spans[i].name]["device_ms"] += (d.time_range.end - d.time_range.start) / 1e3
    return out


def _span(e):
    return e.time_range.start, e.time_range.end


def _union_us(spans) -> float:
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _top_ops(activity, k: int = TOP_OPS):
    ms, count = Counter(), Counter()
    for e in activity:
        a, b = _span(e)
        ms[e.name] += (b - a) / 1e3
        count[e.name] += 1
    return [{"op": name[:120], "ms": t, "launches": count[name]} for name, t in ms.most_common(k)]


def _idle_gaps(activity, host, label: str, k: int = TOP_GAPS):
    """The ``k`` longest gaps between device records.  Each is named by the
    host operator that overlaps it most (the innermost of equal overlap;
    None where the host ran Python between operators the whole gap), and by
    ``after``: the operator the host had entered last when the gap began,
    taken up to its outermost caller under ``label``."""
    gaps, end = [], None
    for a, b in sorted(_span(e) for e in activity):
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    ops_ = [e for e in host if e.name != label and not _is_span(e)]
    out = []
    for length, a, b in sorted(gaps, reverse=True)[:k]:
        def overlap(e):
            s, f = _span(e)
            return min(b, f) - max(a, s)

        best = max(ops_, key=lambda e: (overlap(e), -(e.time_range.end - e.time_range.start)),
                   default=None)
        covered = overlap(best) if best is not None else 0.0
        last = max((e for e in ops_ if e.time_range.start <= a), key=lambda e: e.time_range.start,
                   default=None)
        while last is not None and (up := _caller(last)) is not None and up.name != label:
            last = up
        out.append({"ms": length / 1e3, "at_ms": a / 1e3,
                    "host_op": best.name if covered > 0 else None,
                    "host_op_ms": max(covered, 0.0) / 1e3,
                    "after": last.name if last is not None else None})
    return out


def _profiled(label: str, fn, key, device: torch.device, breakdown: bool,
              trace: Optional[str] = None) -> dict:
    """One call of ``fn`` under the profiler.  The host's operators are
    recorded only for a breakdown: on the card the other readings need only
    the device's records, and the host's multiply what the profiler parses."""
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if breakdown else [
            ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        time.sleep(PROFILER_PAD_S)
        t0 = time.perf_counter()
        with record_function(label):
            fn(key)
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(PROFILER_PAD_S)
    if trace:
        prof.export_chrome_trace(trace)
        log(f"trace of {label} written to {trace}")
    activity, host = _records(prof, label, device)
    out = {"wall_ms": wall_us / 1e3,
           "device_ms": sum(b - a for a, b in map(_span, activity)) / 1e3,
           "launches": len(activity),
           "busy_share": _union_us(map(_span, activity)) / wall_us}
    if breakdown:
        out["top_ops"] = _top_ops(activity)
        out["idle_gaps"] = _idle_gaps(activity, host, label)
        out["spans"] = _span_readings(activity, host, device)
        in_spans = sum(r["device_ms"] for r in out["spans"].values())
        out["span_share"] = (in_spans / out["device_ms"] if out["device_ms"] > 0
                             else math.nan)
    return out


def _host_times(fn: Callable, device: torch.device, reps: int):
    """One warm-up call of ``fn``, then ``reps`` calls on fresh keys, each
    timed from a synchronised start to the host read that ends it."""
    fn(rng.key(0))
    times = []
    for i in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn(rng.fold_in(rng.key(1), i))
        times.append(time.perf_counter() - t0)
    return times


def _run(components, device: torch.device, reps: int, headline: str, trace=None):
    """Every component's readings (the module notes), in ``components``'
    order; the headline's host times; the wrappers' launches over all the
    calls."""
    before, rng_before = bench._launch_counts(), _rng_launch_counts()
    times = {label: _host_times(fn, device, reps) for label, (fn, _) in components.items()}
    readings = {}
    # Kineto loses records of the kernels that the ctypes-bound library
    # launches in windows that follow one of tens of thousands of records:
    # the shortest components are profiled first.
    for label in sorted(components, key=lambda k: statistics.median(times[k])):
        fn, steps = components[label]
        top = label == headline
        r = _profiled(label, fn, rng.fold_in(rng.key(1), reps), device, top,
                      trace if top else None)
        ts = times[label]
        r.update(host_median_ms=statistics.median(ts) * 1e3, host_min_ms=min(ts) * 1e3,
                 host_max_ms=max(ts) * 1e3, steps=steps, launches_per_step=r["launches"] / steps)
        log(f"[{label}] device {r['device_ms']:.3f} ms, host median {r['host_median_ms']:.3f} "
            f"ms of {reps} ({r['host_min_ms']:.3f}-{r['host_max_ms']:.3f}), {r['launches']} "
            f"launches ({r['launches_per_step']:.1f} a step), busy {r['busy_share']:.3f} of "
            f"{r['wall_ms']:.3f} ms")
        for row in r.get("top_ops", ()):
            log(f"    {row['ms']:10.3f} ms {row['launches']:7d}x  {row['op'][:90]}")
        for gap in r.get("idle_gaps", ()):
            log(f"    idle {gap['ms']:8.3f} ms at {gap['at_ms']:.3f} ms: under {gap['host_op']} "
                f"({gap['host_op_ms']:.3f} ms of it), after {gap['after']}")
        for name, s in r.get("spans", {}).items():
            log(f"    span {name:22s} {s['device_ms']:10.3f} ms in {s['count']:4d}")
        if "span_share" in r:
            log(f"    the spans hold {r['span_share']:.4f} of the device ms")
        readings[label] = r
    return ({label: readings[label] for label in components}, times[headline],
            bench._launch_counts() - before, _rng_launch_counts() - rng_before)


def _rng_launch_counts() -> Counter:
    return Counter({w.__name__: w.launches for w in threefry.KERNEL_WRAPPERS})


#: The headline's readings that the record gives beside its components.
_BREAKDOWN = ("top_ops", "idle_gaps", "spans", "span_share")


def _emit(metric: str, unit: str, device: torch.device, readings, headline: str, times, launches,
          rng_launches, **extra) -> dict:
    head = readings[headline]
    extra = {k: head[k] for k in _BREAKDOWN if k in head} | extra
    components = {k: {f: v for f, v in r.items() if f not in _BREAKDOWN}
                  for k, r in readings.items()}
    return bench._emit(bench._record(
        metric, head["device_ms"], unit, None, device, times, launches,
        headline=headline, busy_share=head["busy_share"], **extra, components=components,
        rng_launches=dict(sorted(rng_launches.items()))))


def _check_faithful(what: str, ratio: float):
    lo, hi = FAITHFUL
    log(f"faithfulness: {what} = {ratio:.4f}")
    if not lo <= ratio <= hi:
        log(f"WARNING: the components explain {ratio:.0%} of {what.split(' / ')[-1]}: the "
            f"profile measures another path than the engine takes")


def _weight_reductions(lw, steps: int):
    """``profile_sweep.py``'s reduction loop: the sweep's (max, Σe, Σe²) a step,
    through the engine's own reduction, on weights that drift a little a step."""
    z = torch.zeros((), dtype=lw.dtype, device=lw.device)
    for t in range(1, steps):
        m, _, s1, s2 = _reduce_weights(lw)
        lw = lw * 0.9999 + 1e-7 * t
        z = z + m + torch.log(s1) + 1e-30 * s2
    return z


@torch.no_grad()
def propagate_score(key, kernel: SweepKernel, n: int, device, ref=None):
    """``init`` and the ``T − 1`` steps of propagate + score with the weights
    summed, as a sweep that never resamples runs them: each step's
    ``StepRng`` from :func:`~advancedps_tpu_torch.engine.propagate_rng`, and
    with ``ref`` slot ``n − 1`` takes the reference through the kernel's
    :func:`~advancedps_tpu_torch.engine.inject_ref`.  Returns ``(state,
    logw)``."""
    device = torch.device(device)
    gids = torch.arange(n, device=device)
    ref_mask = None
    if ref is not None:
        ref = _tree.as_reference(ref, device)
        ref_mask = gids == (n - 1)
    state, logw = kernel.init(rng.StepRng(rng.step_key(key, rng.INIT, 0), gids),
                              _tree.tree_at(ref, 0), ref_mask)
    for t in range(1, kernel.num_steps):
        state, score = kernel.step(t, propagate_rng(key, t, gids), state, _tree.tree_at(ref, t),
                                   ref_mask)
        logw = logw + score
    return state, logw


@torch.no_grad()
def retained_draw(key, kernel: SweepKernel, res, ref=None):
    """A PG iteration's tail with replay storage, as ``step_pg`` runs it: the
    retained slot drawn ∝ the sweep ``res``'s final weights, then its lineage
    replayed (:func:`~advancedps_tpu_torch.engine.replay_trajectory`)."""
    idx = randcat_gumbel(rng.step_key(key, rng.DRAW, 0), res.log_weights)
    return replay_trajectory(key, kernel, res.ancestors, idx, ref=ref)


def sweep(device=None, n: int = N, steps: int = T, reps: int = REPS["sweep"],
          trace: Optional[str] = None) -> dict:
    """``profile_sweep.py``: the headline sweep broken into its parts."""
    device = resolve_device(device)
    bench._setup(device)
    _, traced = bench.lgssm(steps, device)
    kernel = SSMKernel(traced)
    gated, never = SMC(n).resampler, ResampleWithESSThreshold(resample_systematic, 0.0)
    gids = torch.arange(n, device=device)

    def sweep_of(resampler):
        return lambda key: run_sweep(key, kernel, n, resampler, store_states=False,
                                     device=device).log_evidence.item()

    def propagate(key):
        return propagate_score(key, kernel, n, device)[1].sum().item()

    def normals(key):
        x = rng.pos_uniform(rng.step_key(key, rng.INIT, 0), gids)
        for t in range(1, steps):
            x = x * bench.A + rng.pos_normal(rng.step_key(key, rng.PROPAGATE, t), gids) * bench.Q
        return x.sum().item()

    def reductions(key):
        return _weight_reductions(rng.pos_uniform(key, gids), steps).item()

    iota = torch.arange(n, dtype=torch.int32, device=device)

    def gather(key):
        x = rng.pos_uniform(key, gids)
        for _ in range(1, steps):
            idx = torch.clamp(torch.argsort(x[:8])[0].to(torch.int32) + iota, 0, n - 1)
            x = x.index_select(0, idx) * 0.9999
        return x.sum().item()

    components = {
        "gated sweep": (sweep_of(gated), steps - 1),
        "never-resampling sweep": (sweep_of(never), steps - 1),
        "propagate + score": (propagate, steps - 1),
        "pos_normal loop": (normals, steps - 1),
        "weight reductions": (reductions, steps - 1),
        "dynamic gather": (gather, steps - 1),
    }
    trace_path = None
    if trace:
        os.makedirs(trace, exist_ok=True)
        trace_path = os.path.join(trace, "gated_sweep_trace.json")
    readings, times, launches, rng_launches = _run(components, device, reps, "gated sweep",
                                                   trace_path)
    ratio = faithfulness(readings, ("propagate + score", "weight reductions"),
                         "never-resampling sweep")
    _check_faithful("(propagate + score + reductions) / never-resampling sweep", ratio)
    return _emit("torch_profile_sweep_device_ms", f"device ms of the ESS-gated sweep (N={n}, "
                 f"T={steps})", device, readings, "gated sweep", times, launches, rng_launches,
                 faithfulness=ratio, particles=n, steps=steps, reps=reps, trace=trace_path)


def pgas(device=None, n: int = N, steps: int = T, reps: int = REPS["pgas"]) -> dict:
    """``profile_pgas.py``: one PGAS iteration (replay storage) in its phases."""
    device = resolve_device(device)
    bench._setup(device)
    model = models.stationary_lgssm(a=bench.A, q=bench.Q, r=bench.R)
    _, traced = bench.lgssm(steps, device)
    kernel = SSMKernel(traced)
    sampler = PGAS(n)
    xs_ref, _ = simulate(rng.key(42), model, steps)  # profile_pgas.py:67
    ref = xs_ref.to(device)
    gids = torch.arange(n, device=device)
    iota = torch.arange(n, dtype=torch.int32, device=device)

    def cond_sweep(key):
        return run_sweep(key, kernel, n, sampler.resampler, ref=ref, ancestor_sampling=True,
                         store_states=False, device=device)

    # The per-step phases run on one conditional sweep's final weights and state.
    res = cond_sweep(rng.key(3))
    lw, x = res.log_weights, res.final_state
    m = torch.max(lw)
    s1 = torch.sum(torch.exp(lw - m))
    f = ops.extents_from_logw(lw, m, s1, 0.25, n - 1)

    def extents(key):
        for t in range(1, steps):
            out = ops.extents_from_logw(lw, m, s1, rng.uniform(rng.step_key(key, rng.RESAMPLE, t)),
                                        n - 1)
        return out[-1].item()

    def move(key):
        for _ in range(1, steps):
            anc, moved = ops.resample_move_f(f, x, n, guard_n=n - 1)
        return moved[0].item()

    def ancestor_draw(key):
        for t in range(1, steps):
            anc_logw = lw + kernel.transition_logprob(t, x, ref[t])
            j = randcat_gumbel(rng.step_key(key, rng.ANCESTOR, t), anc_logw, gids)
        return j.item()

    anc0, moved0 = ops.resample_move_f(f, x, n, guard_n=n - 1)

    def splice(key):
        for t in range(1, steps):
            ref_anc = iota[(t * 7919) % n:][:1]
            row = _tree.tree_rows(x, ref_anc)
            anc0[n - 1:] = ref_anc
            moved0[n - 1:] = row
        return moved0[-1].item()

    components = {
        "PGAS iteration": (lambda key: step_pg(key, traced, sampler, PGState(trajectory=ref),
                                               "replay", device)[0].log_evidence.item(),
                           steps - 1),
        "conditional sweep": (lambda key: cond_sweep(key).log_evidence.item(), steps - 1),
        "propagate + score (reference injected)":
            (lambda key: propagate_score(key, kernel, n, device, ref=ref)[1].sum().item(),
             steps - 1),
        "weight reductions": (lambda key: _weight_reductions(rng.pos_uniform(key, gids),
                                                              steps).item(), steps - 1),
        "B1 with the guard": (extents, steps - 1),
        "B4 with the guard": (move, steps - 1),
        "ancestor draw": (ancestor_draw, steps - 1),
        "reference-row splice": (splice, steps - 1),
        "replay + retained draw": (lambda key: retained_draw(rng.key(3), kernel, res,
                                                             ref).sum().item(), 1),
    }
    readings, times, launches, rng_launches = _run(components, device, reps, "PGAS iteration")
    parts = tuple(components)[2:8]
    ratio = faithfulness(readings, parts, "conditional sweep")
    _check_faithful("parts / conditional sweep", ratio)
    whole = readings["PGAS iteration"]["device_ms"]
    iteration_ratio = (readings["conditional sweep"]["device_ms"]
                       + readings["replay + retained draw"]["device_ms"]) / whole
    log(f"iteration = sweep + replay: {iteration_ratio:.4f} of the iteration's device time")
    return _emit("torch_profile_pgas_device_ms", f"device ms of one PGAS iteration (N={n}, "
                 f"T={steps}, replay storage)", device, readings, "PGAS iteration", times,
                 launches, rng_launches, faithfulness=ratio, iteration_ratio=iteration_ratio,
                 particles=n, steps=steps, reps=reps)


def resample(device=None, n: int = N, steps: int = T, reps: int = REPS["resample"],
             inner: int = INNER) -> dict:
    """``profile_resample.py``: the resampling kernels alone at ``n``, and
    how many steps of the gated sweep fire."""
    device = resolve_device(device)
    bench._setup(device)
    _, traced = bench.lgssm(steps, device)
    res = run_sweep(rng.key(1), SSMKernel(traced), n, SMC(n).resampler, store_states=False,
                    device=device)
    firings = int(res.resampled.sum())
    log(f"ESS-gate firings in a {steps}-step sweep: {firings}")
    lw = res.log_weights
    m = torch.max(lw)
    s1 = torch.sum(torch.exp(lw - m))
    f = ops.extents_from_logw(lw, m, s1, 0.25, n)
    x = rng.pos_normal(rng.key(2), torch.arange(n, device=device))

    def calls(call):
        def fn(key):
            u = rng.uniform(key)
            for _ in range(inner):
                out = call(u)
            return float(out[-1])
        return fn

    components = {
        "B1": (calls(lambda u: ops.extents_from_logw(lw, m, s1, u, n)), inner),
        "B4, one column": (calls(lambda u: ops.decode_move(f, x, n)[1]), inner),
        "B2": (calls(lambda u: ops.decode_ancestors(f, n)), inner),
        "plain float64 cumsum chain": (calls(lambda u: ops.extents_from_logw_ref(lw, m, s1, u,
                                                                                   n)), inner),
    }
    readings, times, launches, rng_launches = _run(components, device, reps, "B1")
    return _emit("torch_profile_resample_b1_device_ms", f"device ms of {inner} calls of B1 "
                 f"(N={n})", device, readings, "B1", times, launches, rng_launches,
                 firings=firings, particles=n, steps=steps, reps=reps, inner=inner)


def move_extents(profile: str, n: int, gen: np.random.Generator) -> torch.Tensor:
    """``bench_move_versions.py:56-67``'s extents: weights even (gamma(2)),
    skewed (gamma(0.1)) or degenerate (20 of weight 1, the rest 1e-12), made
    int32 ``clip(ceil(n·cdf − 0.37), 0, n)``.  The CDF is summed in float64
    over its total, so the last extent is ``n``: no slot lies past the drawn
    population, where version 0 keeps a row that 1 and 6 zero."""
    if profile == "even":
        w = gen.gamma(2.0, size=n)
    elif profile == "skewed":
        w = gen.gamma(0.1, size=n)
    elif profile == "degenerate":
        w = np.full(n, 1e-12)
        w[gen.integers(n, size=20)] = 1.0
    else:
        raise ValueError(f"unknown extents profile {profile!r}")
    cdf = np.cumsum(w.astype(np.float32), dtype=np.float64)
    f = np.clip(np.ceil(n * (cdf / cdf[-1]) - 0.37), 0, n).astype(np.int32)
    return torch.from_numpy(f)


def moves(device=None, n: int = N, reps: int = REPS["moves"], inner: int = INNER) -> dict:
    """``bench_move_versions.py``: the decode + move of each move version on
    each extents profile, after a check that all versions agree."""
    device = resolve_device(device)
    bench._setup(device)
    gen = np.random.default_rng(0)
    versions = sorted(ops._MOVE_VERSIONS)
    components = {}
    for profile_name in MOVE_PROFILES:
        f = move_extents(profile_name, n, gen).to(device)
        for d in MOVE_DIMS:
            shape = (n,) if d == 1 else (n, d)
            x = torch.from_numpy(gen.standard_normal(shape).astype(np.float32)).to(device)
            outs = {v: ops.resample_move_f(f, x, n, version=v) for v in versions}
            anc, moved = outs[ops.MOVE_VERSION]
            for v, (a, mv) in outs.items():
                if not (torch.equal(a, anc) and torch.equal(mv.view(torch.int32),
                                                            moved.view(torch.int32))):
                    raise bench.AnchorError(f"moves: version {v} differs from version "
                                            f"{ops.MOVE_VERSION} on {profile_name} extents, D={d}")
            for v in versions:
                def fn(key, f=f, x=x, v=v):
                    for _ in range(inner):
                        out = ops.resample_move_f(f, x, n, version=v)[1]
                    return float(out.reshape(-1)[0])
                components[f"{profile_name}, D={d}, version {v}"] = (fn, inner)
    log(f"versions {versions} decode the same ancestors and move bitwise the same rows on "
        f"{', '.join(MOVE_PROFILES)} extents, D in {list(MOVE_DIMS)}")
    headline = f"{MOVE_PROFILES[0]}, D={MOVE_DIMS[0]}, version {ops.MOVE_VERSION}"
    readings, times, launches, rng_launches = _run(components, device, reps, headline)
    return _emit("torch_profile_moves_device_ms", f"device ms of {inner} decodes + moves under "
                 f"version {ops.MOVE_VERSION} ({headline}; N={n})", device, readings, headline,
                 times, launches, rng_launches, versions_agree=True, versions=versions,
                 particles=n, reps=reps, inner=inner)


SUBCOMMANDS = {"sweep": sweep, "pgas": pgas, "resample": resample, "moves": moves}
_HELP = {
    "sweep": "the headline sweep's parts (profiling/profile_sweep.py)",
    "pgas": "a PGAS iteration's nine phases (profiling/profile_pgas.py)",
    "resample": "the resampling kernels alone and the gate's firings "
                "(profiling/profile_resample.py)",
    "moves": "the move versions on three extents profiles (profiling/bench_move_versions.py)",
}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m advancedps_tpu_torch.profiling",
                                description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="command", required=True)
    for name in SUBCOMMANDS:
        sp = sub.add_parser(name, help=_HELP[name])
        sp.add_argument("--device", default=None,
                        help="torch device (default: the GPU; raises without one)")
        sp.add_argument("--reps", type=int, default=REPS[name],
                        help="timed calls of each component")
        if name == "sweep":
            sp.add_argument("--trace", default=None,
                            help="write the gated sweep's Chrome trace into this directory")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.command == "sweep":
        return sweep(device, reps=args.reps, trace=args.trace)
    return SUBCOMMANDS[args.command](device, reps=args.reps)


if __name__ == "__main__":
    main()
