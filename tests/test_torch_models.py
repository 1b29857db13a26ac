"""The port's model families against the JAX package.

Mirrors ``tests/test_models.py`` (the Lévy jump budget and moments, GP
regression against a direct regression, SMC determinism) and adds, with the
same numpy inputs and key words in both packages:

* ``simulate`` with a key: the JAX package's draws, to ulps;
* sweeps of the stochastic-volatility, Lévy and GP-SSM models: equal to ulps
  until the first ±1 boundary flip of an extent (the port's extents against
  JAX's CPU searchsorted), then |ΔlogZ| ≤ 0.2 (Monte Carlo noise);
* the PGAS update rate ≈ 1 − 1/N on the SV model (``test_pg_pgas.py``'s
  thresholds), and replay storage equal to dense for a non-Markov model.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import advancedps_tpu as aps  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import random as rnd  # noqa: E402
from torch.func import vmap  # noqa: E402

cpu_sample = functools.partial(apt.sample, device="cpu")
cpu_sweep = functools.partial(apt.sweep, device="cpu")

#: family → (JAX model, port parameters, steps of the sweep tests)
MODELS = {
    "stochastic_volatility": (lambda: aps.models.stochastic_volatility_ssm(a=0.9, q=0.5),
                              dict(a=0.9, q=0.5), 20),
    "levy": (lambda: aps.models.levy_ssm(dt=0.5), dict(dt=0.5), 12),
    "gp_ssm": (lambda: aps.models.gp_ssm(num_steps=10, lengthscale=1.5, variance=0.5),
               dict(num_steps=10, lengthscale=1.5, variance=0.5), 10),
}


def _port_key(jkey):
    return apt.key_from_words(np.asarray(jax.random.key_data(jkey)))


def _pair(family):
    """The JAX model, the port's (on the CPU), and JAX-simulated ys."""
    jmodel, params, T = MODELS[family]
    jm = jmodel()
    _, ys = aps.simulate(jax.random.key(0), jm, T)
    return jm, apt.model_from_numpy(family, params, device="cpu"), np.array(ys)


def test_sv_model_observation_scale():
    m = apt.models.stochastic_volatility_ssm(a=0.9, q=0.5)
    d = m.observation.distribution(0, torch.tensor(2.0))
    assert float(d.scale) == pytest.approx(math.exp(1.0), rel=1e-6) and float(d.loc) == 0.0


@pytest.mark.parametrize("family", sorted(MODELS))
def test_simulate_with_a_key_draws_what_jax_draws(family):
    jmodel, params, T = MODELS[family]
    jxs, jys = aps.simulate(jax.random.key(5), jmodel(), T)
    xs, ys = apt.simulate(_port_key(jax.random.key(5)), apt.model_from_numpy(family, params,
                                                                           device="cpu"), T)
    assert xs.shape == np.shape(jxs) and ys.shape == np.shape(jys)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=1e-4, atol=1e-5)


class TestGammaProcess:
    def test_masked_simulation_shapes(self):
        gp = apt.models.GammaProcess(C=1.0, beta=1.0, max_jumps=32)
        jumps, times, mask = gp.simulate(apt.rng.key(0), 0.5, 0.0, 0.5)
        assert jumps.shape == times.shape == mask.shape == (32,)
        assert bool((times >= 0.0).all() and (times <= 0.5).all())

    def test_jump_budget_sufficient(self):
        # The masked tail is dead: the last candidate jump is below tolerance.
        gp = apt.models.GammaProcess(C=1.0, beta=1.0, max_jumps=64)
        for s in range(5):
            _, _, mask = gp.simulate(apt.rng.key(s), 0.5, 0.0, 0.5)
            assert not bool(mask[-1]), "jump budget too small"

    def test_paths_match_jax(self):
        jgp = aps.models.GammaProcess(C=1.0, beta=1.0, max_jumps=64)
        gp = apt.models.GammaProcess(C=1.0, beta=1.0, max_jumps=64)
        for s in range(3):
            jk = jax.random.key(s)
            want = jgp.simulate(jk, 0.5, 0.5, 1.0)
            got = gp.simulate(rnd.key_tensor(_port_key(jk), "cpu"), 0.5, 0.5, 1.0)
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            # Jumps below float32's normal range are 0 in XLA (flushed) and
            # subnormal here; the mask drops both.
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-30)

    def test_moments_against_numpy_loop(self):
        # Oracle: the reference's while loop in numpy; total masses agree in
        # distribution (mean within 4 combined standard errors).
        rng = np.random.default_rng(0)

        def numpy_total(C=1.0, beta=1.0, rate=0.5, tol=1e-10):
            total, t, last = 0.0, 0.0, np.inf
            while not last < tol:
                t += rng.exponential(1.0 / rate)
                xi = 1.0 / (beta * (np.exp(t / C) - 1.0))
                if rng.random() < (1.0 + beta * xi) * np.exp(-beta * xi):
                    total += xi
                    last = xi
            return total

        np_totals = np.array([numpy_total() for _ in range(3000)])
        gp = apt.models.GammaProcess(C=1.0, beta=1.0, max_jumps=64)
        keys = rnd.split(rnd.key_tensor(apt.rng.key(1), "cpu"), 3000)
        totals = vmap(lambda k: (lambda j, _, m: (j * m).sum())(*gp.simulate(k, 0.5, 0.0, 0.5)))(
            keys).numpy()
        se = np.hypot(np_totals.std() / 55.0, totals.std() / 55.0)
        assert abs(np_totals.mean() - totals.mean()) < 4 * se


def test_gp_posterior_matches_direct_regression():
    # The masked fixed-shape predictive equals a direct (unmasked) regression.
    T, t = 8, 5
    model = apt.models.gp_ssm(num_steps=T)
    hist = torch.linspace(-1, 1, T)
    d = model.dynamics.distribution(t, None, apt.History(states=hist, length=t))
    times = np.arange(t, dtype=np.float64)
    K = np.exp(-0.5 * (times[:, None] - times[None, :]) ** 2) + 1e-6 * np.eye(t)
    k_star = np.exp(-0.5 * (times - t) ** 2)
    alpha = np.linalg.solve(K, hist.numpy()[:t].astype(np.float64))
    var = 1.0 - k_star @ np.linalg.solve(K, k_star)
    np.testing.assert_allclose(float(d.loc), k_star @ alpha, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(d.scale), math.sqrt(var), rtol=1e-3)
    # A batch of histories: each row's mean is its own.
    batch = torch.stack([hist, -hist, 2 * hist])
    db = model.dynamics.distribution(t, None, apt.History(states=batch, length=t))
    np.testing.assert_allclose(db.loc.numpy(), [float(d.loc), -float(d.loc), 2 * float(d.loc)],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t", [1, 4, 8, 11])
def test_gp_means_read_only_the_active_columns(t):
    # Every entry from ``length`` on is NaN: a mean that read one would be NaN.
    T = 12
    model = apt.models.gp_ssm(num_steps=T)
    hist = np.random.default_rng(t).standard_normal((16, T)).astype(np.float32)
    hist[:, t:] = np.nan
    d = model.dynamics.distribution(t, None, apt.History(torch.as_tensor(hist), t))
    # A direct regression in float64 over the active block 0 .. t-1 alone.
    times = np.arange(t + 1, dtype=np.float64)
    k = np.exp(-0.5 * (times[:, None] - times[None, :]) ** 2)
    K, k_star = k[:t, :t] + 1e-6 * np.eye(t), k[:t, t]
    w = np.linalg.solve(K, k_star)
    mean = hist[:, :t].astype(np.float64) @ w
    np.testing.assert_allclose(d.loc.numpy(), mean, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(d.scale), math.sqrt(1.0 - k_star @ w), rtol=1e-3)
    # One history [T] as a row of the batch.
    one = model.dynamics.distribution(t, None, apt.History(torch.as_tensor(hist[3]), t))
    np.testing.assert_allclose(float(one.loc), mean[3], rtol=1e-4, atol=1e-5)


def test_gp_means_over_the_chain_axis_equal_each_chains():
    # Chains run the dynamics under vmap over a [C, N, T] buffer (engine._chain_map).
    T, C, N = 12, 3, 32
    dyn = apt.models.gp_ssm(num_steps=T, lengthscale=1.5, variance=0.5).dynamics
    buf = torch.randn(C, N, T, generator=torch.Generator().manual_seed(5))
    for t in (1, 6, 11):
        bt = buf.clone()
        bt[..., t:] = float("nan")
        got = vmap(lambda b: dyn.distribution(t, None, apt.History(b, t)).loc)(bt)
        want = torch.stack([dyn.distribution(t, None, apt.History(b, t)).loc for b in bt])
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_gp_dynamics_solve_one_right_hand_side():
    # The step's factor is shared by every particle: each solve takes one
    # column, never a column per history.
    T, N = 10, 4096
    dyn = apt.models.gp_ssm(num_steps=T).dynamics
    buf = torch.randn(N, T, generator=torch.Generator().manual_seed(0))
    rhs = {"aten::cholesky_solve": 0, "aten::linalg_solve_triangular": 1,
           "aten::triangular_solve": 0}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        for t in (1, 5, T - 1):
            dyn.distribution(t, None, apt.History(buf, t))
    solves = [(e.name, e.input_shapes[rhs[e.name]]) for e in prof.events() if e.name in rhs]
    assert solves
    assert all(shape[-1] == 1 for _, shape in solves), solves


def test_gp_dynamics_match_jax():
    T = 12
    jd = aps.models.gp_ssm(num_steps=T, lengthscale=1.5, variance=0.5).dynamics
    td = apt.models.gp_ssm(num_steps=T, lengthscale=1.5, variance=0.5).dynamics
    hist = np.random.default_rng(3).standard_normal(T).astype(np.float32)
    for t in (1, 4, 11):
        want = jd.distribution(jnp.asarray(t), None, aps.History(jnp.asarray(hist), jnp.asarray(t)))
        got = td.distribution(t, None, apt.History(torch.as_tensor(hist), t))
        np.testing.assert_allclose(float(got.loc), float(want.loc), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(got.scale), float(want.scale), rtol=1e-4)


def test_gp_ssm_smc_determinism():
    m = apt.models.gp_ssm(num_steps=10)
    _, ys = apt.simulate(apt.rng.key(0), m, 10)
    traced = apt.TracedSSM(m, ys)
    a = cpu_sample(apt.rng.key(2), traced, apt.SMC(16))
    b = cpu_sample(apt.rng.key(2), traced, apt.SMC(16))
    assert torch.equal(a.trajectories, b.trajectories)


@pytest.mark.parametrize("family", sorted(MODELS))
def test_sweep_matches_jax_until_the_first_flip(family):
    jm, tm, ys = _pair(family)
    T = ys.shape[0]
    n = 512
    key = jax.random.key(3)
    jres = aps.sweep(key, aps.SSMKernel(ssm=aps.TracedSSM(jm, jnp.asarray(ys))), n,
                     aps.SMC(n).resampler)
    tres = cpu_sweep(_port_key(key), apt.SSMKernel(apt.TracedSSM(tm, ys)), n,
                     apt.SMC(n).resampler)
    j_anc, t_anc = np.asarray(jres.ancestors), tres.ancestors.numpy()
    flips = (j_anc != t_anc).sum(axis=1)
    first = int(np.argmax(flips > 0)) if flips.any() else T
    assert first > 1
    j_rs, t_rs = np.asarray(jres.resampled), tres.resampled.numpy()
    assert (j_rs[: first + 1] == t_rs[: first + 1]).all()
    # States to ulps (absolutely near zero) before the first flip.  A Lévy
    # step sums 64 masked jumps in another order, and a path with one
    # accepted jump has a rank-one covariance plus 1e-6 jitter, whose
    # Cholesky factor turns those ulps into up to ~2e-4 relative.
    tol = 1e-3 if family == "levy" else 2e-5
    np.testing.assert_allclose(tres.states.numpy()[:first], np.asarray(jres.states)[:first],
                               rtol=tol, atol=tol)
    if first == T:
        np.testing.assert_allclose(float(tres.log_evidence), float(jres.log_evidence),
                                   rtol=1e-5)
    assert abs(float(tres.log_evidence) - float(jres.log_evidence)) < 0.2


@pytest.mark.parametrize("family", sorted(MODELS))
def test_pg_and_pgas_run_and_replay_equals_dense(family):
    jm, tm, ys = _pair(family)
    traced = apt.TracedSSM(tm, ys)
    T = ys.shape[0]
    for sampler in (apt.PG(8), apt.PGAS(8)):
        dense = cpu_sample(apt.rng.key(9), traced, sampler, 3)
        repl = cpu_sample(apt.rng.key(9), traced, sampler, 3, trajectory_storage="replay")
        state_shape = (2,) if family == "levy" else ()
        assert dense.trajectory.shape == (3, T) + state_shape
        assert torch.isfinite(dense.log_evidence).all()
        # Replay re-samples the lineage: the same draws, states to float
        # reordering (a step of Lévy sums 64 masked jumps in another order).
        atol = 1e-4 if family == "levy" else 1e-5
        np.testing.assert_allclose(repl.trajectory.numpy(), dense.trajectory.numpy(),
                                   rtol=0, atol=atol)
        # The first iteration's sweep is the same computation; later ones take
        # the two trajectories as references, equal to float reordering.
        assert torch.equal(repl.log_evidence[0], dense.log_evidence[0])
        np.testing.assert_allclose(repl.log_evidence.numpy(), dense.log_evidence.numpy(),
                                   rtol=1e-5)


def test_replay_storage_nonmarkov_matches_dense():
    # test_pg_pgas.py::test_replay_storage_nonmarkov_matches_dense: the
    # non-Markov dynamics replay their own lineage's history buffer.
    model = apt.models.gp_ssm(num_steps=5, lengthscale=1.5, variance=0.5)
    _, ys = apt.simulate(apt.rng.key(1), model, 5)
    traced = apt.TracedSSM(model, ys)
    dense = cpu_sample(apt.rng.key(2), traced, apt.PG(8), 5)
    repl = cpu_sample(apt.rng.key(2), traced, apt.PG(8), 5, trajectory_storage="replay")
    np.testing.assert_allclose(dense.trajectory.numpy(), repl.trajectory.numpy(), rtol=0,
                               atol=1e-5)


def test_pgas_mixes_better_than_pg():
    # test_pg_pgas.py::test_pgas_mixes_better_than_pg, its sizes and
    # thresholds: PGAS's per-step update rate approaches 1 − 1/N; PG
    # (always resampling) path-degenerates at the early steps.
    N, T, iters = 20, 60, 150
    model = apt.models.stochastic_volatility_ssm(a=0.9, q=0.5)
    _, ys = aps.simulate(jax.random.key(0), aps.models.stochastic_volatility_ssm(a=0.9, q=0.5), T)
    traced = apt.TracedSSM(model, np.array(ys))

    def update_rate(chain):
        traj = chain.trajectory.numpy()
        return (np.abs(np.diff(traj, axis=0)) > 0).mean(axis=0)

    key = _port_key(jax.random.key(1))
    pgas_rate = update_rate(cpu_sample(key, traced, apt.PGAS(N), iters))
    pg_rate = update_rate(cpu_sample(key, traced, apt.PG(N, 1.0), iters))
    theory = 1.0 - 1.0 / N
    assert pgas_rate.mean() > theory - 0.1
    early = slice(0, T // 3)
    assert pg_rate[early].mean() < pgas_rate[early].mean() - 0.3


def test_levy_end_to_end():
    m = apt.models.levy_ssm(dt=0.5)
    xs, ys = apt.simulate(apt.rng.key(0), m, 20)
    assert xs.shape == (20, 2) and ys.shape == (20,)
    chain = cpu_sample(apt.rng.key(1), apt.TracedSSM(m, ys), apt.PGAS(10), 5)
    assert chain.trajectory.shape == (5, 20, 2) and torch.isfinite(chain.log_evidence).all()


def test_model_from_numpy_checks_its_names():
    with pytest.raises(ValueError, match="unknown model family"):
        apt.model_from_numpy("nope", {}, device="cpu")
    with pytest.raises(ValueError, match="unknown levy parameters"):
        apt.model_from_numpy("levy", {"q": 1.0}, device="cpu")
    m = apt.model_from_numpy("levy", {"max_jumps": np.int64(16), "dt": np.float64(0.25)},
                             device="cpu")
    assert m.dynamics.process.max_jumps == 16 and m.dynamics.dt.dtype == torch.float32
    traced = apt.TracedSSM(apt.model_from_numpy("gp_ssm", {"num_steps": 4}, device="cpu"),
                           np.zeros(4, np.float32))
    assert traced.model.dynamics.num_steps == 4 and not traced.model.markov


def test_levy_step_is_finite_for_an_infinite_rejected_jump(monkeypatch):
    # A first arrival gap of exactly 0 (a uniform of 0, 2⁻²³ a draw; ~12 times
    # a sweep at N = 1M, T = 100) makes an infinite jump, which thinning
    # rejects.  The JAX package multiplies it by its 0 mask (0·∞ = NaN); the
    # port selects, so the step stays finite and equals the step without it.
    dyn = apt.models.levy_ssm(dt=0.5).dynamics
    jumps, times, mask = dyn.process.simulate(apt.rng.key(3), dyn.dt, 0.0, 0.5)
    inf_jumps = jumps.clone()
    inf_jumps[0] = float("inf")
    inf_mask = mask.clone()
    inf_mask[0] = False
    monkeypatch.setattr(type(dyn.process), "simulate",
                        lambda self, *a: (inf_jumps, times, inf_mask))
    mu, cov = dyn._meancov(rnd.key_tensor(apt.rng.key(3), "cpu"), 1)
    assert torch.isfinite(mu).all() and torch.isfinite(cov).all()
    zero_jumps = inf_jumps.clone()
    zero_jumps[0] = 0.0
    monkeypatch.setattr(type(dyn.process), "simulate",
                        lambda self, *a: (zero_jumps, times, inf_mask))
    mu0, cov0 = dyn._meancov(rnd.key_tensor(apt.rng.key(3), "cpu"), 1)
    assert torch.equal(mu, mu0) and torch.equal(cov, cov0)
