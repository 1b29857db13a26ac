"""The sweep's spans (``advancedps_tpu_torch.tracing``) on the CPU.

Under ``torch.profiler`` a sweep, one chain or a batch of chains, records one
``aps.setup``, ``T − 1`` each of ``aps.weights`` and ``aps.propagate_score``,
``T − 1`` ``aps.gate`` below threshold 1 and none at 1, one ``aps.resample``
a firing, ``aps.keep`` for the other steps, and one ``aps.close``; no two
overlap.  With no profiler the sweep never enters ``record_function``, and
its results are bitwise the same either way."""

import collections

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import bench, inference, tracing  # noqa: E402

CPU = torch.device("cpu")
N, T, C = 512, 20, 3
PATHS = ["one chain", "chains"]


def _key(path, seed=3):
    key = apt.rng.key(seed)
    return apt.rng.chain_keys(key, C) if path == "chains" else key


def _kernel():
    return apt.SSMKernel(bench.lgssm(T, CPU)[1])


def _sweep(path, threshold, **kw):
    resampler = apt.SMC(N, threshold=threshold).resampler
    return apt.sweep(_key(path), _kernel(), N, resampler, device="cpu", **kw)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith(tracing.PREFIX))
    return out, spans


def _fired_steps(res):
    """Steps on which some chain fired."""
    fired = res.resampled.reshape(-1, res.resampled.shape[-1])
    return int(fired.any(0).sum())


def _assert_disjoint(spans):
    for (_, end, name), (start, _, nxt) in zip(spans, spans[1:]):
        assert end <= start, f"{name} overlaps {nxt}"


@pytest.mark.parametrize("threshold", [0.5, 1.0])
@pytest.mark.parametrize("path", PATHS)
def test_a_sweep_records_each_phase_once_a_step(path, threshold):
    res, spans = _profiled(lambda: _sweep(path, threshold, store_states=True))
    counts = collections.Counter(name for _, _, name in spans)
    firings = _fired_steps(res)
    if threshold < 1.0:
        assert 0 < firings < T - 1  # the gate both fires and keeps here
    else:
        assert firings == T - 1
    assert counts == collections.Counter({
        "aps.setup": 1, "aps.weights": T - 1, "aps.gate": T - 1 if threshold < 1.0 else 0,
        "aps.propagate_score": T - 1, "aps.resample": firings, "aps.keep": T - 1 - firings,
        "aps.close": 1})
    _assert_disjoint(spans)
    assert spans[0][2] == "aps.setup" and spans[-1][2] == "aps.close"


@pytest.mark.parametrize("threshold", [0.5, 1.0])
@pytest.mark.parametrize("path", PATHS)
def test_a_pgas_step_records_one_resample_span_a_firing(path, threshold, monkeypatch):
    sweeps = []
    real = inference.sweep

    def spy(*args, **kwargs):
        sweeps.append(real(*args, **kwargs))
        return sweeps[-1]

    monkeypatch.setattr(inference, "sweep", spy)
    model = bench.lgssm(T, CPU)[1]
    sampler = apt.PGAS(N, threshold=threshold)
    assert sampler.ancestor_sampling
    ref, _ = apt.simulate(apt.rng.key(42), apt.models.stationary_lgssm(a=0.9, q=0.32, r=1.0),
                          T)
    if path == "chains":
        ref = ref.expand(C, T).clone()
    _, spans = _profiled(lambda: apt.step_pg(_key(path, 12), model, sampler,
                                             apt.PGState(trajectory=ref), device="cpu"))
    (res,) = sweeps
    counts = collections.Counter(name for _, _, name in spans)
    assert counts["aps.resample"] == _fired_steps(res) > 0
    assert counts["aps.resample"] + counts["aps.keep"] == T - 1
    assert counts["aps.gate"] == (T - 1 if threshold < 1.0 else 0)
    _assert_disjoint(spans)


@pytest.mark.parametrize("path", PATHS)
def test_with_no_profiler_the_sweep_never_enters_record_function(path, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(tracing, "record_function", refuse)
    assert tracing.spans()("aps.weights") is tracing.spans()("aps.close")
    _sweep(path, 0.5)
    # The patched branch is the one a profiler takes.
    with pytest.raises(AssertionError, match="record_function"):
        _profiled(lambda: _sweep(path, 0.5))


@pytest.mark.parametrize("threshold", [0.5, 1.0])
@pytest.mark.parametrize("path", PATHS)
def test_results_are_bitwise_the_same_with_tracing_on_and_off(path, threshold):
    off = _sweep(path, threshold)
    on, spans = _profiled(lambda: _sweep(path, threshold))
    assert spans
    for field in ("log_evidence", "log_weights", "ancestors", "ess", "resampled", "states"):
        assert torch.equal(getattr(on, field), getattr(off, field)), field
