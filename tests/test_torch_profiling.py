"""The port's profiles (``advancedps_tpu_torch.profiling``) at small sizes on
the CPU: each subcommand's JSON line and readings, the propagate + score loop
held to the engine's path and to the JAX package's loop over its
``propagate_rng``, the PGAS replay phase held to ``step_pg``, the move
versions' agreement on every extents profile, and the faithfulness
arithmetic."""

import json
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import advancedps_tpu as aps  # noqa: E402
from advancedps_tpu import rng as jrng  # noqa: E402
from advancedps_tpu.engine import propagate_rng as jpropagate_rng  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import bench, profiling  # noqa: E402
from advancedps_tpu_torch.ops import resample as ops  # noqa: E402

CPU = torch.device("cpu")
READINGS = {"device_ms", "wall_ms", "launches", "busy_share", "host_median_ms", "host_min_ms",
            "host_max_ms", "steps", "launches_per_step"}
#: Each subcommand at a small size, with its components and headline.
CASES = {
    "sweep": (dict(n=1024, steps=10, reps=2), 6, "gated sweep"),
    "pgas": (dict(n=512, steps=10, reps=2), 9, "PGAS iteration"),
    "resample": (dict(n=2048, steps=10, reps=2, inner=2), 4, "B1"),
    "moves": (dict(n=1024, reps=2, inner=2), 18, "even, D=1, version 1"),
}


def _port_key(jkey):
    return apt.key_from_words(np.asarray(jax.random.key_data(jkey)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_subcommand_prints_one_json_line_with_its_readings(name, capsys, tmp_path):
    kw, n_components, headline = CASES[name]
    if name == "sweep":
        kw = dict(kw, trace=str(tmp_path / "trace"))
    record = profiling.SUBCOMMANDS[name](device="cpu", **kw)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert {"metric", "value", "unit", "vs_baseline", "device", "n_runs", "median_s", "min_s",
            "max_s", "launches", "components", "headline"} <= record.keys()
    assert record["device"] == "cpu" and record["vs_baseline"] is None
    assert record["n_runs"] == kw["reps"] and record["headline"] == headline
    assert record["launches"] == {}  # the CPU runs the plain versions
    components = record["components"]
    assert len(components) == n_components
    for label, r in components.items():
        assert r.keys() == READINGS, label
        assert r["device_ms"] > 0 and r["launches"] > 0 and 0 < r["busy_share"] <= 1 + 1e-9
        assert r["launches_per_step"] == pytest.approx(r["launches"] / r["steps"])
        assert r["host_min_ms"] <= r["host_median_ms"] <= r["host_max_ms"]
    assert record["value"] == components[headline]["device_ms"]
    if name in ("sweep", "pgas"):
        assert 0 < len(record["top_ops"]) <= profiling.TOP_OPS
        ms = [row["ms"] for row in record["top_ops"]]
        assert ms == sorted(ms, reverse=True) and all(row["launches"] > 0
                                                      for row in record["top_ops"])
        assert 0 < len(record["idle_gaps"]) <= profiling.TOP_GAPS
        for g in record["idle_gaps"]:
            assert g["ms"] > 0 and g["after"] and g["host_op_ms"] <= g["ms"] + 1e-9
            assert (g["host_op"] is None) == (g["host_op_ms"] == 0)
        assert math.isfinite(record["faithfulness"])
        _check_spans(record, kw["steps"] - 1, gated=name == "sweep")
    if name == "sweep":
        trace = json.loads((tmp_path / "trace" / "gated_sweep_trace.json").read_text())
        assert trace["traceEvents"] and record["trace"].endswith("gated_sweep_trace.json")
    if name == "pgas":
        assert math.isfinite(record["iteration_ratio"])
    if name == "resample":
        assert 0 < record["firings"] < kw["steps"]
    if name == "moves":
        assert record["versions_agree"] and record["versions"] == [0, 1, 6]


def _check_spans(record, steps, gated):
    """The headline sweep's spans: each phase's count, and their device ms
    (the operators each calls directly, on the CPU) a part of the sweep's."""
    spans = record["spans"]
    counts = {name: s["count"] for name, s in spans.items()}
    firings = counts.get("aps.resample", 0)
    assert counts == {"aps.setup": 1, "aps.weights": steps, "aps.propagate_score": steps,
                      "aps.close": 1, "aps.resample": firings,
                      **({"aps.gate": steps} if gated else {}),
                      **({"aps.keep": steps - firings} if firings < steps else {})}
    assert 0 < firings <= steps and (firings < steps) == gated
    assert all(s["device_ms"] >= 0 for s in spans.values())
    assert spans["aps.propagate_score"]["device_ms"] > 0
    assert spans["aps.weights"]["device_ms"] > 0
    assert sum(s["device_ms"] for s in spans.values()) == pytest.approx(
        record["span_share"] * record["value"])
    assert 0.5 < record["span_share"] <= 1 + 1e-9
    assert "spans" not in record["components"][record["headline"]]


def test_on_the_card_a_record_goes_to_the_span_that_launched_it():
    """The card's branch of the span readings, on events built by hand: a
    device record joins its launch by correlation id, whatever its own time."""
    def ev(name, a, b, id_=0):
        return types.SimpleNamespace(name=name, id=id_, cpu_parent=None,
                                     time_range=types.SimpleNamespace(start=a, end=b))

    host = [ev("aps.weights", 0, 10), ev("aps.gate", 10, 20), ev("aps.weights", 30, 40),
            ev("aten::sum", 1, 5, 7), ev("cudaLaunchKernel", 2, 3, 101),
            ev("cudaMemcpyAsync", 12, 19, 102), ev("cudaLaunchKernel", 31, 32, 103),
            ev("cudaLaunchKernel", 50, 51, 104)]
    activity = [ev("k", 900, 1900, 101), ev("Memcpy DtoH", 2000, 2500, 102),
                ev("k", -80, 220, 103), ev("k", 3000, 3100, 104), ev("k", 10, 20, 7)]
    out = profiling._span_readings(activity, host, torch.device("cuda"))
    assert out == {"aps.weights": {"count": 2, "device_ms": pytest.approx(1.3)},
                   "aps.gate": {"count": 1, "device_ms": pytest.approx(0.5)}}


def _evidence_never_resampling(logws):
    """engine.sweep's log-evidence when no step resamples, on the weights of
    steps 0..T−1 (``engine.py``'s bookkeeping, transcribed)."""
    n = logws[0].shape[0]
    ln_n = torch.log(torch.tensor(float(n), dtype=torch.float32))
    log_z, pending = ln_n * 0.0, ln_n
    for logw in logws[:-1]:
        m = torch.max(logw)
        lse = m + torch.log(torch.sum(torch.exp(logw - m)))
        log_z, pending = log_z + (lse - pending), lse
    return log_z + (torch.logsumexp(logws[-1], 0) - pending)


def test_the_propagate_loop_is_the_never_resampling_sweep():
    n, steps = 512, 10
    ys, traced = bench.lgssm(steps, CPU)
    kernel = apt.SSMKernel(traced)
    key = apt.rng.key(4)
    never = apt.ResampleWithESSThreshold(apt.resample_systematic, 0.0)
    res = apt.sweep(key, kernel, n, never, store_states=False, device="cpu")
    assert not bool(res.resampled.any())
    state, logw = profiling.propagate_score(key, kernel, n, CPU)
    assert torch.equal(state, res.final_state) and torch.equal(logw, res.log_weights)
    # The loop over the first t + 1 observations gives the sweep's weights at
    # step t, and those give bitwise the sweep's log-evidence.
    logws = [profiling.propagate_score(
        key, apt.SSMKernel(apt.TracedSSM(apt.models.stationary_lgssm(a=0.9, q=0.32, r=1.0),
                                         ys[:t + 1])), n, CPU)[1] for t in range(steps)]
    assert torch.equal(logws[-1], logw)
    assert torch.equal(_evidence_never_resampling(logws), res.log_evidence)


@pytest.mark.parametrize("with_ref", [False, True], ids=["bootstrap", "reference"])
def test_the_propagate_loop_is_the_jax_loop_over_propagate_rng(with_ref):
    n, steps = 512, 10
    ys, traced = bench.lgssm(steps, CPU)
    jkernel = aps.SSMKernel(ssm=aps.TracedSSM(
        aps.models.stationary_lgssm(a=0.9, q=0.32, r=1.0), jnp.asarray(ys.numpy())))
    ref = np.random.default_rng(6).standard_normal(steps).astype(np.float32) if with_ref else None
    key = jax.random.key(8)
    gids = jnp.arange(n)
    mask = (gids == n - 1) if with_ref else None

    def ref_at(t):
        return None if ref is None else jnp.asarray(ref[t])

    # profiling/profile_sweep.py:111-121 (profile_pgas.py:125-130 with the
    # reference), from the kernel's own init.
    x, lw = jkernel.init(jrng.StepRng(key=jrng.step_key(key, jrng.INIT, 0), gids=gids),
                         ref_at(0), mask)
    for t in range(1, steps):
        x, score = jkernel.step(t, jpropagate_rng(key, t, gids), x, ref_at(t), mask)
        lw = lw + score
    state, logw = profiling.propagate_score(_port_key(key), apt.SSMKernel(traced), n, CPU,
                                            ref=None if ref is None else torch.from_numpy(ref))
    # tests/test_torch_sweep.py's rule for states over several steps.
    np.testing.assert_allclose(state.numpy(), np.asarray(x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logw.numpy(), np.asarray(lw), rtol=1e-5, atol=1e-5)
    if with_ref:
        assert float(state[-1]) == float(ref[-1])


def test_the_pgas_replay_phase_is_step_pg():
    n, steps = 256, 10
    _, traced = bench.lgssm(steps, CPU)
    kernel = apt.SSMKernel(traced)
    ref, _ = apt.simulate(apt.rng.key(42), apt.models.stationary_lgssm(a=0.9, q=0.32, r=1.0),
                          steps)
    sampler = apt.PGAS(n)
    key = apt.rng.key(12)
    res = apt.sweep(key, kernel, n, sampler.resampler, ref=ref, ancestor_sampling=True,
                    store_states=False, device="cpu")
    got = profiling.retained_draw(key, kernel, res, ref)
    smp, _ = apt.step_pg(key, traced, sampler, apt.PGState(trajectory=ref), "replay",
                         device="cpu")
    assert torch.equal(got, smp.trajectory)


@pytest.mark.parametrize("profile", profiling.MOVE_PROFILES)
def test_the_move_versions_agree_on_each_extents_profile(profile):
    n = 4096
    gen = np.random.default_rng(0)
    f = profiling.move_extents(profile, n, gen)
    assert f.dtype == torch.int32 and int(f[-1]) == n and bool((f[1:] >= f[:-1]).all())
    for d in profiling.MOVE_DIMS:
        x = torch.from_numpy(gen.standard_normal((n, d)[:d]).astype(np.float32))
        outs = [ops.resample_move_f(f, x, n, version=v) for v in (0, 1, 6)]
        for anc, moved in outs[1:]:
            assert torch.equal(anc, outs[0][0])
            assert torch.equal(moved.view(torch.int32), outs[0][1].view(torch.int32))
        assert torch.equal(outs[0][1], x.index_select(0, outs[0][0]))


def test_moves_refuses_versions_that_disagree(monkeypatch, capsys):
    real = ops.resample_move_f

    def off_by_one(f, x, n, version=None, guard_n=None):
        anc, moved = real(f, x, n, version=version, guard_n=guard_n)
        return (anc, moved + 1) if version == 6 else (anc, moved)

    monkeypatch.setattr(ops, "resample_move_f", off_by_one)
    with pytest.raises(bench.AnchorError, match="version 6 differs"):
        profiling.moves(device="cpu", n=256, reps=1, inner=1)
    assert capsys.readouterr().out == ""


def test_the_faithfulness_arithmetic():
    table = {"whole": {"device_ms": 80.0}, "a": {"device_ms": 60.0}, "b": {"device_ms": 12.0},
             "c": {"device_ms": 100.0}, "none": {"device_ms": 0.0}}
    assert profiling.faithfulness(table, ("a", "b"), "whole") == pytest.approx(0.9)
    assert profiling.faithfulness(table, ("a", "b", "c"), "whole") == pytest.approx(2.15)
    assert profiling.faithfulness(table, (), "whole") == 0.0
    assert math.isnan(profiling.faithfulness(table, ("a",), "none"))
    lo, hi = profiling.FAITHFUL
    assert (lo, hi) == (0.5, 1.5)  # profile_sweep.py:186


@pytest.mark.parametrize("name", sorted(profiling.SUBCOMMANDS))
def test_without_a_device_named_each_subcommand_needs_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.main([name])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.SUBCOMMANDS[name]()


@pytest.mark.parametrize("argv, want", [
    (["sweep", "--device", "cpu"], ("sweep", (CPU,), {"reps": 10, "trace": None})),
    (["sweep", "--device", "cpu", "--reps", "3", "--trace", "t"],
     ("sweep", (CPU,), {"reps": 3, "trace": "t"})),
    (["pgas", "--device", "cpu"], ("pgas", (CPU,), {"reps": 4})),
    (["resample", "--device", "cpu", "--reps", "5"], ("resample", (CPU,), {"reps": 5})),
    (["moves", "--device", "cpu"], ("moves", (CPU,), {"reps": 3})),
])
def test_main_hands_each_subcommand_its_flags(argv, want, monkeypatch):
    calls = []
    for name in profiling.SUBCOMMANDS:
        def fake(*args, name=name, **kwargs):
            calls.append((name, args, kwargs))
            return {}
        monkeypatch.setitem(profiling.SUBCOMMANDS, name, fake)
    monkeypatch.setattr(profiling, "sweep", profiling.SUBCOMMANDS["sweep"])
    profiling.main(argv)
    assert calls == [want]
