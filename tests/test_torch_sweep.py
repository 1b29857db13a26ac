"""The port's model layer and whole bootstrap-SMC slice against the JAX package.

Same key words, same JAX-simulated observations, small sizes.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import advancedps_tpu as aps  # noqa: E402
from advancedps_tpu import rng as jrng  # noqa: E402
from advancedps_tpu.engine import lineages as jlineages  # noqa: E402
from advancedps_tpu.engine import reconstruct as jreconstruct  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402

# The port runs on the GPU unless the caller asks for the CPU: every call of an
# entry point in this file names device="cpu", through these partials.
cpu_sweep = functools.partial(apt.sweep, device="cpu")
cpu_sample = functools.partial(apt.sample, device="cpu")
cpu_sample_smc = functools.partial(apt.sample_smc, device="cpu")
cpu_traced_ssm = functools.partial(apt.traced_ssm_from_numpy, device="cpu")

A, Q, R = 0.9, 0.32, 1.0
SIGMA0 = math.sqrt(Q * Q / (1 - A * A))
PARAMS = dict(mu=0.0, sigma0=SIGMA0, a=A, b=0.0, q=Q, h=1.0, r=R)
N, T = 4096, 50


def _port_key(jkey):
    return apt.key_from_words(np.asarray(jax.random.key_data(jkey)))


def _ys(seed, steps=T):
    _, ys = aps.simulate(jax.random.key(seed), aps.models.stationary_lgssm(A, Q, R), steps)
    return np.array(ys)


def _assert_close_ulps(got, want, max_ulps, atol=1e-6):
    """Within ``max_ulps`` float32 ulps, or ``atol`` absolute where a sum
    cancels to near zero and ulps shrink (a·x + q·ε ≈ 0)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    ok = (ulps <= max_ulps) | (np.abs(got - want) <= atol)
    assert ok.all(), (ulps.max(), np.abs(got - want).max())


def test_normal_log_prob_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32) * 3
    loc = rng.standard_normal(4096).astype(np.float32)
    want = aps.Normal(jnp.asarray(loc), 0.32).log_prob(jnp.asarray(x))
    got = apt.Normal(torch.as_tensor(loc), 0.32).log_prob(torch.as_tensor(x))
    # Same float32 formula; XLA may contract a multiply-add differently.
    _assert_close_ulps(got.numpy(), want, max_ulps=4)


def test_ssm_kernel_init_and_steps_match_jax():
    ys = _ys(3)
    jkern = aps.SSMKernel(ssm=aps.TracedSSM(aps.models.stationary_lgssm(A, Q, R), jnp.asarray(ys)))
    tkern = apt.SSMKernel(cpu_traced_ssm(PARAMS, ys))
    key = jax.random.key(17)
    gids = np.arange(N)
    j_rng = jrng.StepRng(key=jrng.step_key(key, jrng.INIT, 0), gids=jnp.asarray(gids))
    t_rng = apt.rng.StepRng(apt.rng.step_key(_port_key(key), apt.rng.INIT, 0),
                            torch.as_tensor(gids))
    jx, jw = jkern.init(j_rng, None, None)
    tx, tw = tkern.init(t_rng, None, None)
    # Box–Muller normals agree to 4 ulp; the affine map and score add a few more.
    _assert_close_ulps(tx.numpy(), jx, 8)
    _assert_close_ulps(tw.numpy(), jw, 16)
    for t in (1, 2):
        # Teacher-forced: both kernels step from the JAX state.
        j_rng = jrng.StepRng(key=jrng.step_key(key, jrng.PROPAGATE, t), gids=jnp.asarray(gids))
        t_rng = apt.rng.StepRng(apt.rng.step_key(_port_key(key), apt.rng.PROPAGATE, t),
                                torch.as_tensor(gids))
        jx_new, jw = jkern.step(t, j_rng, jx, None, None)
        tx_new, tw = tkern.step(t, t_rng, torch.as_tensor(np.array(jx)), None, None)
        _assert_close_ulps(tx_new.numpy(), jx_new, 8)
        _assert_close_ulps(tw.numpy(), jw, 16)
        jx = jx_new


def test_kalman_matches_jax():
    ys = _ys(5, 100)
    want = aps.utils.kalman_filter(ys, A, 0.0, Q, 1.0, R, 0.0, SIGMA0)
    got = apt.utils.kalman_filter(ys, A, 0.0, Q, 1.0, R, 0.0, SIGMA0)
    # The port runs in float64; the JAX filter in float32 (x64 off).
    np.testing.assert_allclose(float(got.log_likelihood), float(want.log_likelihood), rtol=1e-5)
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means), rtol=1e-4, atol=1e-5)
    assert got.log_likelihood.dtype == torch.float64


def _both_sweeps(seed, n=N):
    ys = _ys(seed)
    key = jax.random.key(100 + seed)
    jres = aps.sweep(key, aps.SSMKernel(ssm=aps.TracedSSM(aps.models.stationary_lgssm(A, Q, R),
                                                          jnp.asarray(ys))),
                     n, aps.SMC(n).resampler)
    tres = cpu_sweep(_port_key(key), apt.SSMKernel(cpu_traced_ssm(PARAMS, ys)),
                     n, apt.SMC(n).resampler)
    return ys, jres, tres


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_matches_jax_until_the_first_boundary_flip(seed):
    # The port's extents ceil(n·cdf − u) and JAX's CPU searchsorted on
    # (u + k)/n round differently where a position lies within float32
    # rounding of a CDF entry, and then pick neighbouring ancestors.  Until
    # the first such flip the two sweeps are the same computation.
    _, jres, tres = _both_sweeps(seed)
    j_anc, t_anc = np.asarray(jres.ancestors), tres.ancestors.numpy()
    flips = (j_anc != t_anc).sum(axis=1)
    first = int(np.argmax(flips > 0)) if flips.any() else T
    assert first > 1 and (first == T or flips[first] <= 1e-3 * N)
    j_rs, t_rs = np.asarray(jres.resampled), tres.resampled.numpy()
    assert (j_rs[: first + 1] == t_rs[: first + 1]).all() and j_rs[:first].any()
    # States agree to ulps (1e-5 absolute near zero) before the first flip.
    np.testing.assert_allclose(tres.states.numpy()[:first], np.asarray(jres.states)[:first],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tres.ess.numpy()[: first + 1],
                               np.asarray(jres.ess)[: first + 1], rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_smc_matches_jax(seed):
    ys = _ys(seed)
    key = jax.random.key(100 + seed)
    js = aps.sample_smc(key, aps.TracedSSM(aps.models.stationary_lgssm(A, Q, R), jnp.asarray(ys)),
                        aps.SMC(N), store_states=False)
    ts = cpu_sample_smc(_port_key(key), cpu_traced_ssm(PARAMS, ys), apt.SMC(N),
                        store_states=False)
    # After the first boundary flip (see above) the clouds differ in the
    # flipped lineages, and all randomness being positional, the remaining
    # difference is Monte Carlo noise: measured |ΔlogZ| ≤ 0.083 over six seeds
    # at N=4096, T=50, hence the bound 0.2.  The gate may then fire at a
    # different step or two.
    assert abs(float(ts.log_evidence) - float(js.log_evidence)) < 0.2
    j_rs = np.asarray(js.diagnostics["resampled"])
    t_rs = ts.diagnostics["resampled"].numpy()
    assert (j_rs != t_rs).sum() <= 2
    kf = apt.utils.kalman_filter(ys, A, 0.0, Q, 1.0, R, 0.0, SIGMA0)
    # Monte Carlo noise at N=4096 (verify skill: < 0.8 at N=512, < 0.2 at 8192).
    assert abs(float(ts.log_evidence) - float(kf.log_likelihood)) < 0.8
    assert abs(float(js.log_evidence) - float(kf.log_likelihood)) < 0.8
    np.testing.assert_allclose(float(ts.weights.sum()), 1.0, rtol=1e-5)
    assert ts.trajectories is None


def test_sweep_same_key_is_bitwise_repeatable():
    tr = cpu_traced_ssm(PARAMS, _ys(4))
    key = apt.rng.key(9)
    a = cpu_sweep(key, apt.SSMKernel(tr), 2048, apt.SMC(2048).resampler)
    b = cpu_sweep(key, apt.SSMKernel(tr), 2048, apt.SMC(2048).resampler)
    assert torch.equal(a.log_evidence, b.log_evidence)
    assert torch.equal(a.ancestors, b.ancestors) and torch.equal(a.states, b.states)
    assert a.ancestors.dtype == torch.int32 and a.ancestors.shape == (T, 2048)
    assert a.resampled.any()
    c = cpu_sweep(apt.rng.key(10), apt.SSMKernel(tr), 2048, apt.SMC(2048).resampler)
    assert not torch.equal(a.ancestors, c.ancestors)


def test_always_resample_runs_every_step():
    tr = cpu_traced_ssm(PARAMS, _ys(6, 12))
    res = cpu_sweep(apt.rng.key(1), apt.SSMKernel(tr), 512,
                    apt.SMC(512, apt.resample_systematic).resampler, store_states=False)
    assert res.resampled[1:].all() and not res.resampled[0]
    assert res.states is None and torch.isfinite(res.log_evidence)


def test_lineages_and_reconstruct_match_jax():
    rng = np.random.default_rng(2)
    anc = np.sort(rng.integers(0, 64, size=(9, 64)), axis=1).astype(np.int32)
    anc[0] = np.arange(64)
    states = rng.standard_normal((9, 64)).astype(np.float32)
    np.testing.assert_array_equal(apt.lineages(torch.as_tensor(anc)).numpy(),
                                  np.asarray(jlineages(jnp.asarray(anc))))
    np.testing.assert_array_equal(
        apt.reconstruct(torch.as_tensor(states), torch.as_tensor(anc), None).numpy(),
        np.asarray(jreconstruct(jnp.asarray(states), jnp.asarray(anc), None)))
    np.testing.assert_array_equal(
        apt.reconstruct(torch.as_tensor(states), torch.as_tensor(anc), 37).numpy(),
        np.asarray(jreconstruct(jnp.asarray(states), jnp.asarray(anc), 37)))


def test_simulate_with_torch_generator():
    model = apt.models.stationary_lgssm(A, Q, R)
    xs, ys = apt.simulate(torch.Generator().manual_seed(0), model, 30)
    xs2, ys2 = apt.simulate(torch.Generator().manual_seed(0), model, 30)
    assert xs.shape == ys.shape == (30,) and xs.dtype == torch.float32
    assert torch.equal(ys, ys2) and torch.isfinite(ys).all()


def test_model_buffers_follow_to():
    model = apt.models.LinearGaussianSSM(0.0, 1.0, A, 0.0, Q, 1.0, R)
    names = {n for n, _ in model.named_buffers()}
    assert names == {"prior.mu", "prior.sigma", "dynamics.a", "dynamics.b", "dynamics.q",
                     "observation.h", "observation.r"}
    assert model.to(torch.float64).dynamics.a.dtype == torch.float64


class _HistoryDynamics(apt.models.LinearGaussianDynamics):
    """The LGSSM's dynamics declared non-Markov: the history is passed and
    not read."""

    needs_history = True

    def distribution(self, step, state, history=None):
        return super().distribution(step, state)


class _ScalarPrior(apt.models.GaussianPrior):
    """The LGSSM's prior, drawn particle by particle."""

    vectorized = False


def _formerly_refused_models():
    lg = apt.models
    return [apt.StateSpaceModel(lg.GaussianPrior(), _HistoryDynamics(),
                                lg.LinearGaussianObservation()),
            apt.StateSpaceModel(_ScalarPrior(), lg.LinearGaussianDynamics(),
                                lg.LinearGaussianObservation())]


def test_unported_paths_raise():
    tr = cpu_traced_ssm(PARAMS, _ys(7, 5))
    key = apt.rng.key(0)
    with pytest.raises(TypeError, match="unknown sampler"):
        cpu_sample(key, tr, object(), 10)
    with pytest.raises(ValueError):
        cpu_sample(key, tr, apt.SMC(16), 10)
    with pytest.raises(TypeError):
        apt.make_kernel(object())
    with pytest.raises(ValueError, match="missing"):
        cpu_traced_ssm({"a": 0.9}, np.zeros(3))


@pytest.mark.parametrize("which", [0, 1])
def test_formerly_refused_models_now_sweep(which):
    # Non-Markov dynamics and a per-particle prior: the two models the port
    # refused before its models slice.  Both run through sample, SMC and
    # PGAS, and equal the plain LGSSM where their draws are the same.
    model = _formerly_refused_models()[which]
    ys = torch.as_tensor(_ys(7, 12))
    traced = apt.TracedSSM(model, ys)
    smc = cpu_sample(apt.rng.key(0), traced, apt.SMC(64))
    assert torch.isfinite(smc.log_evidence) and smc.trajectories.shape == (12, 64)
    chain = cpu_sample(apt.rng.key(1), traced, apt.PGAS(16), 3)
    assert chain.trajectory.shape == (3, 12) and torch.isfinite(chain.log_evidence).all()
    xs, ys_sim = apt.simulate(apt.rng.key(2), model, 6)
    assert xs.shape == ys_sim.shape == (6,) and torch.isfinite(xs).all()
    if which == 0:
        # The history is not read, and the non-Markov branch draws with
        # per-particle keys: a Markov model that draws so gives the same sweep.
        class _Keyed(apt.models.LinearGaussianDynamics):
            vectorized = False

        plain = apt.TracedSSM(apt.StateSpaceModel(apt.models.GaussianPrior(), _Keyed(),
                                                  apt.models.LinearGaussianObservation()), ys)
        other = cpu_sample(apt.rng.key(0), plain, apt.SMC(64))
        assert torch.equal(other.log_evidence, smc.log_evidence)
