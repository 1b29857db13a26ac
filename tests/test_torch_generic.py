"""The port's generic-program front-end against the JAX package.

Mirrors ``tests/test_generic.py`` (structure discovery, the analytic PG
evidence, single-particle replay, multivariate and trailing sites, the
mis-aligned guard, determinism; not its two StableHLO and trace-growth
guards, which are JAX's own) and the generic legs of ``tests/test_smc.py``
(the analytic SMC evidence, the random observation count) and
``tests/test_pg_pgas.py`` (PGAS and replay storage refused).  Each program is
written once against a distributions module and built with each package's,
and both run with the same key words.  Held, with the tolerances stated:

* the structure (sites, segments, shapes, offsets, ``flat_size``) is JAX's;
* step 0 (``init``) and later steps, teacher-forced from JAX's values: Normal
  and Bernoulli sites and the log-weights within 4 ulps (the distributions'
  ``loc + scale·z`` rounding, ROADMAP Queue C), Categorical sites bitwise;
  Gamma and Beta sites (bounded attempts here, rejection loops in JAX) by
  law, against scipy;
* a small SMC sweep equals JAX's to ulps until the first ±1 extent flip, and
  logZ agrees to ≤ 0.2 at N = 4096;
* the segment's run stopped at its observe gives bitwise the sweep of the
  whole program run at every step.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
scipy_stats = pytest.importorskip("scipy.stats")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import advancedps_tpu as aps  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu import rng as jrng  # noqa: E402

cpu_sample = functools.partial(apt.sample, device="cpu")
cpu_sweep = functools.partial(apt.sweep, device="cpu")
LOG_HALF_SQ = -2.0 * math.log(2.0)


def _port_key(jkey):
    return apt.key_from_words(np.asarray(jax.random.key_data(jkey)))


def _assert_close_ulps(got, want, max_ulps, atol=1e-6):
    """Within ``max_ulps`` float32 ulps, or ``atol`` absolute where a sum
    cancels to near zero and ulps shrink."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    ok = (ulps <= max_ulps) | (np.abs(got - want) <= atol)
    assert ok.all(), (ulps.max(), np.abs(got - want).max())


# --- programs, each written once against a distributions module D ----------


def normal_model(D):
    # NormalModel (reference test/smc.jl:24-47).
    def m(ctx):
        a = ctx.sample(D.Normal(4.0, 5.0), name="a")
        ctx.observe(D.Normal(a, 2.0), 3.0)
        b = ctx.sample(D.Normal(a, 1.0), name="b")
        ctx.observe(D.Normal(b, 2.0), 1.5)
    return m


def bernoulli_model(D):
    # TestModel (reference test/smc.jl:76-97): latent sites that do not touch
    # the evidence and two Bernoulli(x/2) observations with x ≡ 1, so the
    # log-evidence is exactly −2·log 2.
    def m(ctx):
        ctx.sample(D.Normal(0.0, 1.0), name="a")
        x = ctx.sample(D.Bernoulli(1.0), name="x")
        ctx.sample(D.Gamma(2.0, 3.0), name="b")
        ctx.observe(D.Bernoulli(x / 2.0), 1.0)
        ctx.sample(D.Beta(1.0, 1.0), name="c")
        ctx.observe(D.Bernoulli(x / 2.0), 0.0)
    return m


def mixed_model(D):
    # Normal, Bernoulli, Categorical and a three-vector site, with module-
    # level ``sample_site`` / ``observe`` next to the context methods.
    def m(ctx):
        a = ctx.sample(D.Normal(0.5, 1.5), name="a")
        x = D.sample_site(ctx, D.Bernoulli(0.3), "x")
        k = ctx.sample(D.Categorical(np.array([0.2, 0.5, 0.3], np.float32)), name="k")
        ctx.observe(D.Normal(a + x + 0.25 * k, 1.0), 0.7)
        v = ctx.sample(D.Normal(a, np.ones(3, np.float32)), name="v")
        D.observe(ctx, D.Normal(v.sum(), 2.0), -0.4)
        b = ctx.sample(D.Normal(0.9 * a, 0.5), name="b")
        ctx.observe(D.Normal(b, 1.0), 0.1)
    return m


def random_walk(D, T=6):
    def m(ctx):
        x = ctx.sample(D.Normal(0.0, 1.0), name="x0")
        ctx.observe(D.Normal(x, 1.0), 0.3)
        for t in range(1, T):
            x = ctx.sample(D.Normal(0.9 * x, 0.6), name=f"x{t}")
            ctx.observe(D.Normal(x, 1.0), 0.3 * math.sin(t))
    return m


def trailing_model(D):
    def m(ctx):
        a = ctx.sample(D.Normal(1.0, 0.1), name="a")
        ctx.observe(D.Normal(a, 1.0), 1.0)
        ctx.sample(D.Normal(a + 10.0, 0.1), name="tail")
    return m


def gamma_beta_model(D):
    def m(ctx):
        g = ctx.sample(D.Gamma(2.0, 3.0), name="g")
        b = ctx.sample(D.Beta(2.0, 5.0), name="b")
        ctx.observe(D.Normal(g * b, 1.0), 0.5)
    return m


def both(program):
    return aps.GenericModel(program(aps)), apt.GenericModel(program(apt))


# --- structure ---------------------------------------------------------------


@pytest.mark.parametrize("program", [normal_model, bernoulli_model, mixed_model, random_walk,
                                     trailing_model])
def test_structure_matches_jax(program):
    jm, tm = both(program)
    assert tm.num_steps == jm.num_steps
    assert tm.flat_size == jm.flat_size
    got = [(s.name, s.shape, s.segment, s.offset, s.size) for s in tm.sites]
    want = [(s.name, tuple(s.shape), s.segment, s.offset, s.size) for s in jm.sites]
    assert got == want
    assert [str(s.dtype).replace("torch.", "") for s in tm.sites] == \
        [str(np.dtype(s.dtype)) for s in jm.sites]


def test_structure_discovery():
    gm = apt.GenericModel(normal_model(apt))
    assert gm.num_steps == 2
    assert [s.name for s in gm.sites] == ["a", "b"]
    assert [s.segment for s in gm.sites] == [0, 1]
    assert gm.flat_size == 2


def test_normal_model_smoke():
    out = cpu_sample(apt.rng.key(0), apt.GenericModel(normal_model(apt)), apt.SMC(100))
    assert math.isfinite(float(out.log_evidence))
    assert out.trajectories.shape == (2, 100, 2)


# --- steps against JAX -------------------------------------------------------


def _rngs(key, tag, t, n):
    gids = np.arange(n)
    j = jrng.StepRng(key=jrng.step_key(key, tag, t), gids=jnp.asarray(gids))
    p = apt.rng.StepRng(apt.rng.step_key(_port_key(key), tag, t), torch.as_tensor(gids))
    return j, p


@pytest.mark.parametrize("with_ref", [False, True])
def test_init_and_steps_match_jax(with_ref):
    # Normal, Bernoulli and Categorical sites, a vector site: init, then each
    # step teacher-forced from JAX's values.
    jm, tm = both(mixed_model)
    jk, tk = aps.generic.GenericSSMKernel(model=jm), apt.GenericSSMKernel(tm)
    n = 256
    key = jax.random.key(21)
    ref = np.linspace(-1.0, 1.0, jm.flat_size).astype(np.float32)
    ref[2] = 2.0  # the Categorical site's slot holds a category
    jmask = jnp.arange(n) == n - 1 if with_ref else None
    tmask = torch.arange(n) == n - 1 if with_ref else None
    jref = jnp.asarray(ref) if with_ref else None
    tref = torch.as_tensor(ref) if with_ref else None
    j_rng, t_rng = _rngs(key, jrng.INIT, 0, n)
    jv, jw = jk.init(j_rng, jref, jmask)
    tv, tw = tk.init(t_rng, tref, tmask)
    _assert_close_ulps(tv.numpy(), jv, 4)
    _assert_close_ulps(tw.numpy(), jw, 4)
    k = tm.decode(tv)["k"]
    assert k.dtype == torch.int32
    assert torch.equal(k, torch.as_tensor(np.array(jm.decode(jv)["k"])))
    if with_ref:
        # The reference slot keeps its segment-0 values (a, x, k).
        np.testing.assert_array_equal(tv.numpy()[n - 1, :3], ref[:3])
    for t in range(1, jm.num_steps):
        j_rng, t_rng = _rngs(key, jrng.PROPAGATE, t, n)
        jv_new, jw = jk.step(t, j_rng, jv, jref, jmask)
        tv_new, tw = tk.step(t, t_rng, torch.as_tensor(np.array(jv)), tref, tmask)
        _assert_close_ulps(tv_new.numpy(), jv_new, 4)
        _assert_close_ulps(tw.numpy(), jw, 4)
        jv = jv_new


def test_run_sample_and_run_score_match_jax():
    jm, tm = both(normal_model)
    key = jax.random.fold_in(jax.random.key(5), 3)
    tkey = torch.as_tensor(np.asarray(jax.random.key_data(key)).astype(np.int64))
    values = np.array([0.25, -1.5], np.float32)
    for t in range(jm.num_steps):
        jv = jm.run_sample(t, key, jnp.asarray(values))
        tv = tm.run_sample(t, tkey, torch.as_tensor(values))
        _assert_close_ulps(tv.numpy(), jv, 4)
        _assert_close_ulps(tm.run_score(t, tv).numpy(), jm.run_score(t, jv), 4)


def test_gamma_and_beta_sites_by_law():
    # Bounded attempts here, rejection loops in JAX: held to the law.
    tm = apt.GenericModel(gamma_beta_model(apt))
    n = 4096
    _, t_rng = _rngs(jax.random.key(2), jrng.INIT, 0, n)
    tv, tw = apt.GenericSSMKernel(tm).init(t_rng, None, None)
    d = tm.decode(tv)
    assert scipy_stats.kstest(d["g"].double().numpy(), "gamma", args=(2.0, 0.0, 3.0)).pvalue > 1e-3
    assert scipy_stats.kstest(d["b"].double().numpy(), "beta", args=(2.0, 5.0)).pvalue > 1e-3
    want = scipy_stats.norm.logpdf(0.5, d["g"].double() * d["b"].double(), 1.0)
    np.testing.assert_allclose(tw.numpy(), want, rtol=1e-5, atol=1e-5)


# --- sweeps ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_small_sweep_matches_jax_until_the_first_flip(seed):
    jm, tm = both(random_walk)
    n = 64
    key = jax.random.key(seed)
    jres = aps.sweep(key, aps.generic.GenericSSMKernel(model=jm), n, aps.SMC(n).resampler)
    tres = cpu_sweep(_port_key(key), apt.GenericSSMKernel(tm), n, apt.SMC(n).resampler)
    T = jm.num_steps
    j_anc, t_anc = np.asarray(jres.ancestors), tres.ancestors.numpy()
    flips = (j_anc != t_anc).sum(axis=1)
    first = int(np.argmax(flips > 0)) if flips.any() else T
    assert first > 1
    j_rs, t_rs = np.asarray(jres.resampled), tres.resampled.numpy()
    assert (j_rs[:first + 1] == t_rs[:first + 1]).all()
    _assert_close_ulps(tres.states.numpy()[:first], np.asarray(jres.states)[:first], 4)
    if first == T:
        np.testing.assert_allclose(float(tres.log_evidence), float(jres.log_evidence), rtol=1e-5)
    assert abs(float(tres.log_evidence) - float(jres.log_evidence)) < 0.2


def test_sweep_log_evidence_agrees_with_jax_at_4096():
    jm, tm = both(random_walk)
    n = 4096
    key = jax.random.key(7)
    jz = float(aps.sample(key, jm, aps.SMC(n)).log_evidence)
    tz = float(cpu_sample(_port_key(key), tm, apt.SMC(n)).log_evidence)
    assert abs(tz - jz) < 0.2


def test_smc_analytic_log_evidence():
    # tests/test_smc.py::test_smc_analytic_log_evidence (reference
    # test/smc.jl:99-104): logZ = −2·log 2.
    gm = apt.GenericModel(bernoulli_model(apt))
    out = cpu_sample(_port_key(jax.random.key(100)), gm, apt.SMC(100))
    np.testing.assert_allclose(float(out.log_evidence), LOG_HALF_SQ, rtol=1e-6)
    dec = gm.decode(out.trajectories[-1])
    assert bool((dec["x"] == 1.0).all())


def test_pg_analytic_log_evidence():
    # tests/test_generic.py::test_pg_analytic_log_evidence (reference
    # test/smc.jl:155-158): the PG mean logZ within 0.01 of −2·log 2.
    gm = apt.GenericModel(bernoulli_model(apt))
    chain = cpu_sample(_port_key(jax.random.key(100)), gm, apt.PG(10), 100)
    assert abs(float(chain.log_evidence.double().mean()) - LOG_HALF_SQ) < 0.01
    final = gm.decode(chain.trajectory[:, -1, :])
    assert bool((final["x"] == 1.0).all())


def test_single_particle_pg_replay():
    # DummyModel replay (reference test/smc.jl:161-189): PG(1) returns the
    # same values in consecutive iterations, bit for bit.
    def m(ctx):
        a = ctx.sample(apt.Normal(0.0, 1.0), name="a")
        ctx.observe(apt.Normal(0.0, 1.0), a)
        b = ctx.sample(apt.Normal(0.0, 1.0), name="b")
        ctx.observe(apt.Normal(0.0, 1.0), b)

    gm = apt.GenericModel(m)
    chain = cpu_sample(apt.rng.key(0), gm, apt.PG(1), 2)
    first, second = gm.decode(chain.trajectory[0, -1]), gm.decode(chain.trajectory[1, -1])
    assert torch.equal(first["a"], second["a"]) and torch.equal(first["b"], second["b"])
    assert torch.equal(chain.log_evidence[0], chain.log_evidence[1])


def test_multivariate_sites():
    def m(ctx):
        v = ctx.sample(apt.Normal(torch.zeros(3), torch.ones(3)), name="v")
        ctx.observe(apt.Normal(v.sum(), 1.0), 0.5)

    gm = apt.GenericModel(m)
    assert gm.flat_size == 3
    out = cpu_sample(apt.rng.key(0), gm, apt.SMC(50))
    assert gm.decode(out.trajectories[-1])["v"].shape == (50, 3)


def _rejected_program(ctx):
    a = ctx.sample(apt.Normal(4.0, 5.0), name="a")
    b = ctx.sample(apt.Normal(a, 1.0), name="b")
    if a >= 4:  # data-dependent structure
        ctx.observe(apt.Normal(b, 2.0), 1.5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_conditional_structure_rejected(seed):
    # The build trace sees zero observes, or the sweep's vmap meets the `if`.
    with pytest.raises(Exception, match="mis-aligned|at least one observe"):
        gm = apt.GenericModel(_rejected_program, seed=seed)
        cpu_sample(apt.rng.key(0), gm, apt.SMC(10))


@pytest.mark.parametrize("branch", ["if", "item"])
def test_value_dependent_branch_rejected(branch):
    # The build trace always meets an observe, so the sweep's vmap meets the
    # branch: a Python ``if`` on the sampled tensor, or ``.item()`` of it.
    def m(ctx):
        a = ctx.sample(apt.Normal(0.0, 1.0), name="a")
        ctx.observe(apt.Normal(a, 1.0), 0.3)
        if (a > 0 if branch == "if" else a.item() > 0):
            ctx.observe(apt.Normal(a, 1.0), -0.2)

    gm = apt.GenericModel(m)
    with pytest.raises(apt.generic._TraceError, match="mis-aligned"):
        cpu_sample(apt.rng.key(0), gm, apt.SMC(10))


def test_generic_determinism():
    def m(ctx):
        a = ctx.sample(apt.Normal(0.0, 1.0), name="a")
        ctx.observe(apt.Normal(a, 1.0), 0.3)
        b = ctx.sample(apt.Normal(a, 1.0), name="b")
        ctx.observe(apt.Normal(b, 1.0), -0.1)

    gm = apt.GenericModel(m)
    c1 = cpu_sample(apt.rng.key(3), gm, apt.PG(8), 5)
    c2 = cpu_sample(apt.rng.key(3), gm, apt.PG(8), 5)
    assert torch.equal(c1.trajectory, c2.trajectory)
    assert torch.equal(c1.log_evidence, c2.log_evidence)


def test_trailing_site_materialised():
    # A site after the final observe appears in trajectories (the reference
    # materialises it in its replay pass).
    gm = apt.GenericModel(trailing_model(apt))
    assert [s.segment for s in gm.sites] == [0, 1]
    out = cpu_sample(apt.rng.key(0), gm, apt.SMC(64))
    dec = gm.decode(out.trajectories[-1])
    assert bool(((dec["tail"] - dec["a"] - 10.0).abs() < 1.0).all())
    chain = cpu_sample(apt.rng.key(1), gm, apt.PG(8), 3)
    final = gm.decode(chain.trajectory[:, -1, :])
    assert bool(((final["tail"] - final["a"] - 10.0).abs() < 1.0).all())


def test_pgas_rejects_generic_models():
    gm = apt.GenericModel(normal_model(apt))
    with pytest.raises(TypeError, match="ancestor sampling"):
        cpu_sample(apt.rng.key(0), gm, apt.PGAS(5), 2)


def test_replay_storage_rejects_generic_models():
    gm = apt.GenericModel(normal_model(apt))
    with pytest.raises(TypeError, match="replay"):
        cpu_sample(apt.rng.key(0), gm, apt.PG(8), 3, trajectory_storage="replay")


# --- the early stop -------------------------------------------------------------


@pytest.mark.parametrize("program", [random_walk, mixed_model, trailing_model])
def test_stopping_at_the_observe_is_bitwise_the_whole_run(program, monkeypatch):
    gm = apt.GenericModel(program(apt))
    smc = cpu_sample(apt.rng.key(4), gm, apt.SMC(32))
    pg = cpu_sample(apt.rng.key(5), gm, apt.PG(16), 3)
    monkeypatch.setattr(apt.GenericModel, "_stops_early", lambda self, t: False)
    smc_whole = cpu_sample(apt.rng.key(4), gm, apt.SMC(32))
    pg_whole = cpu_sample(apt.rng.key(5), gm, apt.PG(16), 3)
    assert torch.equal(smc.trajectories, smc_whole.trajectories)
    assert torch.equal(smc.log_evidence, smc_whole.log_evidence)
    assert torch.equal(pg.trajectory, pg_whole.trajectory)
    assert torch.equal(pg.log_evidence, pg_whole.log_evidence)


def test_steps_before_the_last_stop_at_their_observe():
    T = 5
    calls = []

    def m(ctx):
        x = ctx.sample(apt.Normal(0.0, 1.0))
        for t in range(T):
            calls.append(t)
            ctx.observe(apt.Normal(x, 1.0), 0.1)
            x = ctx.sample(apt.Normal(x, 1.0))

    gm = apt.GenericModel(m)
    calls.clear()
    cpu_sample(apt.rng.key(0), gm, apt.SMC(8))
    # Step t < T − 1 reaches observes 0 … t; the last step the whole program.
    assert calls == [i for t in range(T - 1) for i in range(t + 1)] + list(range(T))


def test_distribution_to_moves_every_parameter():
    d = apt.MvNormal(torch.zeros(2), torch.eye(2))
    moved = d.to("cpu")
    assert moved is not d and moved.loc.device.type == "cpu" and moved.cov.device.type == "cpu"
    assert torch.equal(moved.loc, d.loc) and torch.equal(moved.cov, d.cov)


@pytest.mark.parametrize("exchange", ["allgather", "auto"])
def test_generic_kernel_on_the_sharded_mesh(exchange):
    # The [N, S] value matrix moves through the sharded exchanges like any
    # state: equal to the single-device sweep until the first firing whose
    # float32 Σe, summed in another order, moves an extent.
    from advancedps_tpu_torch import parallel

    gm = apt.GenericModel(random_walk(apt))
    kernel, n = apt.GenericSSMKernel(gm), 256
    resampler = apt.SMC(n).resampler
    one = cpu_sweep(apt.rng.key(6), kernel, n, resampler)
    mesh = parallel.particle_mesh(4, "cpu")
    sh = parallel.sharded_sweep(apt.rng.key(6), kernel, n, resampler, mesh, exchange=exchange)
    flips = (sh.ancestors != one.ancestors).sum(1)
    first = int(torch.argmax((flips > 0).int())) if bool(flips.any()) else gm.num_steps
    assert first > 1 and sum(mesh.exchanges.values()) == int(sh.resampled.sum())
    assert torch.equal(sh.states[:first], one.states[:first])
    assert abs(float(sh.log_evidence) - float(one.log_evidence)) < 0.2
