"""The port's benchmarks (``advancedps_tpu_torch.bench``) at small sizes on the
CPU: each mode's JSON line and anchors, and the pieces it shares with the JAX
package's benchmarks held against them (the observations, the flagship sweep,
the PGAS anchor statistic and the native baseline)."""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import advancedps_tpu as aps  # noqa: E402
from advancedps_tpu.engine import sweep as jsweep  # noqa: E402
from advancedps_tpu.ops import native as jnative  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import bench  # noqa: E402
from advancedps_tpu_torch.ops import _build, native  # noqa: E402

CPU = torch.device("cpu")
KEYS = {"metric", "value", "unit", "vs_baseline", "device", "n_runs", "median_s", "min_s",
        "max_s", "launches"}
BASELINE_N = 4096

#: Each mode at a small size: N ≤ 4096, T ≤ 20, 2 timed runs, 2 shards.
CASES = {
    "smc": ("smc", dict(n=4096, steps=20, runs=2)),
    "pgas": ("pgas", dict(n=1024, steps=20, runs=2)),
    "scaling-overhead": ("scaling", dict(mode="overhead", total=4096, steps=20, iters=2,
                                         shards=(1, 2))),
    "scaling-weak": ("scaling", dict(mode="weak", per_device=2048, steps=20, iters=2,
                                     shards=(1, 2), exchange="neighbor")),
    "ensemble": ("ensemble", dict(n_runs=3, n=4096, steps=20, runs=2)),
    "chains": ("chains", dict(n_chains=4, n=1024, steps=20, iters=2, runs=2)),
    "schemes-systematic": ("schemes", dict(scheme="systematic", n=4096, steps=20, runs=2)),
    "schemes-stratified": ("schemes", dict(scheme="stratified", n=4096, steps=20, runs=2)),
    "schemes-multinomial": ("schemes", dict(scheme="multinomial", n=4096, steps=20, runs=2)),
    "generic": ("generic", dict(n=1024, steps=10, runs=2)),
}
#: The JAX package's schemes by the names of ``bench.SCHEMES``.
JAX_SCHEMES = {"systematic": aps.resampling.resample_systematic,
               "stratified": aps.resampling.resample_stratified,
               "multinomial": aps.resampling.resample_multinomial}


def _jax_ys(steps):
    _, ys = aps.simulate(jax.random.key(0), aps.models.stationary_lgssm(a=0.9, q=0.32, r=1.0),
                         steps)
    return np.asarray(ys, np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_mode_prints_one_json_line_and_passes_its_anchors(case, capsys, tmp_path):
    mode, kw = CASES[case]
    if mode == "scaling":
        kw = dict(kw, out=str(tmp_path / "record.json"))
    record = bench.MODES[mode](device="cpu", baseline_n=BASELINE_N, **kw)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert KEYS <= record.keys()
    assert record["device"] == "cpu" and record["n_runs"] == 2
    assert 0 < record["min_s"] <= record["median_s"] <= record["max_s"]
    assert math.isfinite(record["value"]) and record["value"] > 0 and record["vs_baseline"] > 0
    assert record["launches"] == {}  # the CPU runs the plain versions, which launch nothing
    if mode == "scaling":
        assert (tmp_path / "record.json").read_text() == lines[0] + "\n"
        assert record["particle_steps_per_sec_by_devices"].keys() == {"1", "2"}
        assert "logical shards" in record["note"]
        return
    assert record["logz_error_vs_kalman"] < bench.EVIDENCE_LIMIT
    if mode == "pgas":
        assert record["rms_z_vs_rts"] < bench.ZRMS_LIMIT
        assert record["best_iterations_per_sec"] >= record["value"]
        assert record["value"] == pytest.approx(bench.BENCH_ITERS / record["median_s"])
    elif mode == "chains":
        assert record["value"] == pytest.approx(4 * 2 / record["median_s"])
    else:
        runs = kw.get("n_runs", 1)
        assert record["value"] == pytest.approx(runs * kw["n"] * kw["steps"] / record["median_s"])
    if mode == "schemes":
        assert record["metric"] == (f"torch_lgssm_{kw['scheme']}_always_resample_"
                                    f"particle_steps_per_sec")
        assert record["base_min_s"] <= record["base_median_s"] <= record["base_max_s"]
        assert record["per_firing_ms"] == pytest.approx(
            (record["median_s"] - record["base_median_s"]) / (kw["steps"] - 1) * 1e3)
    elif mode == "generic":
        assert record["structured_logz_error_vs_kalman"] < bench.EVIDENCE_LIMIT
        assert record["structured_particle_steps_per_sec"] == pytest.approx(
            kw["n"] * kw["steps"] / record["structured_median_s"])
        assert record["generic_over_structured"] == pytest.approx(
            record["value"] / record["structured_particle_steps_per_sec"])
        assert record["structured_launches"] == {}


@pytest.mark.parametrize("mode, limit", [("smc", "EVIDENCE_LIMIT"), ("pgas", "ZRMS_LIMIT"),
                                         ("schemes", "EVIDENCE_LIMIT"),
                                         ("generic", "EVIDENCE_LIMIT")])
def test_a_mode_fails_on_its_anchor(mode, limit, monkeypatch, capsys):
    monkeypatch.setattr(bench, limit, 0.0)
    with pytest.raises(bench.AnchorError):
        bench.MODES[mode](device="cpu", n=256, steps=10, runs=2, baseline_n=BASELINE_N)
    assert capsys.readouterr().out == ""  # no result printed


@pytest.mark.parametrize("mode", sorted(bench.MODES))
def test_without_a_device_named_main_needs_cuda(mode, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([mode])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.MODES[mode]()


@pytest.mark.parametrize("argv, want", [
    (["pgas", "--device", "cpu"], ("pgas", (CPU,))),
    (["scaling", "--device", "cpu"],
     ("scaling", (CPU, "weak", 65536, 262144, 50, 3, "auto", None))),
    (["scaling", "--device", "cpu", "--mode", "overhead", "--per-device", "8", "--total", "64",
      "--steps", "5", "--iters", "2", "--exchange", "neighbor", "--out", "r.json"],
     ("scaling", (CPU, "overhead", 8, 64, 5, 2, "neighbor", "r.json"))),
    (["schemes", "--device", "cpu"], ("schemes", (CPU, "systematic"))),
    (["schemes", "--device", "cpu", "--scheme", "multinomial"], ("schemes", (CPU, "multinomial"))),
    (["generic", "--device", "cpu"], ("generic", (CPU,))),
])
def test_main_hands_each_mode_its_flags(argv, want, monkeypatch):
    calls = []
    for name in bench.MODES:
        def fake(*args, name=name):
            calls.append((name, args))
            return {}
        monkeypatch.setitem(bench.MODES, name, fake)
    monkeypatch.setattr(bench, "scaling", bench.MODES["scaling"])
    monkeypatch.setattr(bench, "schemes", bench.MODES["schemes"])
    bench.main(argv)
    assert calls == [want]


def test_an_unknown_scheme_is_refused():
    with pytest.raises(ValueError, match="unknown scheme 'residual'"):
        bench.schemes(device="cpu", scheme="residual")
    with pytest.raises(SystemExit):
        bench.main(["schemes", "--device", "cpu", "--scheme", "residual"])


def test_the_observations_are_jax_simulate():
    ys, traced = bench.lgssm(20, CPU)
    want = _jax_ys(20)
    got = ys.numpy()
    # tests/test_torch_rng.py's rule: 4 float32 ulps, or 1e-6 absolute.
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ((ulps <= 4) | (np.abs(got - want) <= 1e-6)).all()
    assert torch.equal(traced.observations, ys)


def test_the_flagship_sweep_is_jax_sweep():
    n, steps = 4096, 20
    ys, run = bench.flagship(n, steps, CPU)
    key = jax.random.key(1)
    jys = _jax_ys(steps)
    traced = aps.TracedSSM(aps.models.stationary_lgssm(a=0.9, q=0.32, r=1.0),
                           jnp.asarray(jys))
    want = jsweep(key, aps.SSMKernel(ssm=traced), n, aps.SMC(n).resampler,
                  store_states=False).log_evidence
    got = run(apt.key_from_words(np.asarray(jax.random.key_data(key))))
    # tests/test_torch_sweep.py's bound: equal until the first boundary flip,
    # then Monte Carlo noise.
    assert abs(got - float(want)) < 0.2


@pytest.mark.parametrize("scheme", sorted(bench.SCHEMES))
def test_each_scheme_resampling_at_every_step_is_jax_sweep(scheme):
    n, steps = 4096, 20
    _, run = bench.flagship(n, steps, CPU, bench.always_resample(scheme))
    key = jax.random.key(5)
    traced = aps.TracedSSM(aps.models.stationary_lgssm(a=0.9, q=0.32, r=1.0),
                           jnp.asarray(_jax_ys(steps)))
    gated = aps.ResampleWithESSThreshold(JAX_SCHEMES[scheme], math.inf)
    res = jsweep(key, aps.SSMKernel(ssm=traced), n, gated, store_states=False)
    assert bool(np.asarray(res.resampled)[1:].all())
    got = run(apt.key_from_words(np.asarray(jax.random.key_data(key))))
    # The documented flip contract (multinomial draws another variable than
    # the JAX package's CPU path, ROADMAP Queue C): Monte Carlo noise.
    assert abs(got - float(res.log_evidence)) <= 0.2


def test_the_generic_program_is_bench_generic_program():
    from advancedps_tpu.inference import make_kernel as jmake_kernel

    n, steps = 512, 8
    ys, _ = bench.lgssm(steps, CPU)
    ys_np = ys.numpy()

    # profiling/bench_generic.py:63-68, transcribed.
    def jprog(ctx):
        x = ctx.sample(aps.Normal(0.0, bench.SIGMA0), name="x0")
        ctx.observe(aps.Normal(x, bench.R), float(ys_np[0]))
        for t in range(1, steps):
            x = ctx.sample(aps.Normal(bench.A * x, bench.Q), name=f"x{t}")
            ctx.observe(aps.Normal(x, bench.R), float(ys_np[t]))

    jm, tm = aps.GenericModel(jprog), apt.GenericModel(bench.lgssm_program(ys))
    assert (tm.num_steps, tm.flat_size, len(tm.sites)) == (jm.num_steps, jm.flat_size, steps)
    key = jax.random.key(11)
    jres = jsweep(key, jmake_kernel(jm), n, aps.SMC(n).resampler)
    tres = apt.sweep(apt.key_from_words(np.asarray(jax.random.key_data(key))),
                     apt.make_kernel(tm), n, apt.SMC(n).resampler, device="cpu")
    # tests/test_torch_generic.py's rule: the same computation until the first
    # ±1 extent flip (states within 4 ulps), then logZ within 0.2.
    j_anc, t_anc = np.asarray(jres.ancestors), tres.ancestors.numpy()
    flips = (j_anc != t_anc).sum(axis=1)
    first = int(np.argmax(flips > 0)) if flips.any() else steps
    assert first > 1
    got, want = tres.states.numpy()[:first], np.asarray(jres.states)[:first]
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ((ulps <= 4) | (np.abs(got - want) <= 1e-6)).all()
    if first == steps:
        assert float(tres.log_evidence) == pytest.approx(float(jres.log_evidence), rel=1e-5)
    assert abs(float(tres.log_evidence) - float(jres.log_evidence)) < 0.2


def test_rts_zrms_is_bench_pgas_statistic():
    rng = np.random.default_rng(3)
    c, steps, kept = 6, 20, 4
    cm = rng.standard_normal((c, steps))
    means = rng.standard_normal(steps) * 0.3
    variances = rng.random(steps) * 0.5 + 0.05
    # bench_pgas.py:103-111, transcribed.
    est = cm.mean(axis=0)
    sd = np.sqrt(variances)
    se_chains = cm.std(axis=0, ddof=1) / math.sqrt(cm.shape[0])
    se = np.maximum(se_chains, sd / math.sqrt(cm.shape[0] * kept))
    z = (est - means) / se
    want = float(np.sqrt(np.mean(z * z)))
    got = bench.rts_zrms(torch.as_tensor(cm), torch.as_tensor(means),
                         torch.as_tensor(variances), kept)
    assert got == pytest.approx(want, rel=1e-12)
    # The floor binds where the chain means agree.
    same = np.repeat(cm[:1], c, axis=0)
    z = (same.mean(axis=0) - means) / (sd / math.sqrt(c * kept))
    assert bench.rts_zrms(same, means, variances, kept) == pytest.approx(
        float(np.sqrt(np.mean(z * z))), rel=1e-12)


def test_the_native_binding_is_the_jax_package_binding():
    n, steps = 2048, 20
    ys = _jax_ys(steps)
    rng = np.random.default_rng(0)
    init = rng.standard_normal(n).astype(np.float32)
    step = rng.standard_normal((steps - 1) * n).astype(np.float32)
    res_u = rng.random(steps).astype(np.float32)
    args = (ys, init, step, res_u, n, 0.9, 0.32, 1.0, bench.SIGMA0)
    got = native.lgssm_sweep(*args)
    assert got == jnative.lgssm_sweep(*args)
    assert math.isfinite(got)
    # The port's own build, beside its kernels, not the JAX package's library.
    assert native.library()._name.startswith(str(_build.BUILD_DIR))
    with pytest.raises(ValueError, match="do not fit"):
        native.lgssm_sweep(ys, init[:-1], step, res_u, n, 0.9, 0.32, 1.0, bench.SIGMA0)
    assert native.native_baseline_rate(ys, 0.9, 0.32, 1.0, bench.SIGMA0, n) > 0
