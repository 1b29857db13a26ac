"""The port's PG / PGAS against the JAX package: the RTS smoother, the
conditional sweep with and without ancestor sampling, replay against dense
storage, seeded determinism, the reference-slot white-boxes, PG(1), the
constructor defaults (as ``tests/test_pg_pgas.py``) and the posterior mean
against the RTS smoother.

Same key words, JAX-simulated observations, small sizes.
"""

import functools
import math

import numpy as np
import pytest
import scipy.stats

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import advancedps_tpu as aps  # noqa: E402
from advancedps_tpu.engine import SweepKernel as JSweepKernel  # noqa: E402
from advancedps_tpu.engine import inject_ref as jinject_ref  # noqa: E402
from advancedps_tpu.utils.trees import pytree_dataclass  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402

# The port runs on the GPU unless the caller asks for the CPU: every call of an
# entry point in this file names device="cpu", through these partials.
cpu_sweep = functools.partial(apt.sweep, device="cpu")
cpu_sample = functools.partial(apt.sample, device="cpu")
cpu_step_pg = functools.partial(apt.step_pg, device="cpu")
cpu_traced_ssm = functools.partial(apt.traced_ssm_from_numpy, device="cpu")

A, Q, R = 0.9, 0.32, 1.0
SIGMA0 = math.sqrt(Q * Q / (1 - A * A))
PARAMS = dict(mu=0.0, sigma0=SIGMA0, a=A, b=0.0, q=Q, h=1.0, r=R)
SCHEMES = [apt.resample_systematic, apt.resample_stratified, apt.resample_multinomial,
           apt.resample_residual]


def _port_key(jkey):
    return apt.key_from_words(np.asarray(jax.random.key_data(jkey)))


def _ys(seed, steps):
    _, ys = aps.simulate(jax.random.key(seed), aps.models.stationary_lgssm(A, Q, R), steps)
    return np.array(ys)


def _traced(seed=0, steps=6):
    return cpu_traced_ssm(PARAMS, _ys(seed, steps))


def test_kalman_smoother_matches_jax():
    ys = _ys(5, 100).astype(np.float64)
    got = apt.utils.kalman_smoother(ys, A, 0.0, Q, 1.0, R, 0.0, SIGMA0)
    with jax.enable_x64(True):
        want = aps.utils.kalman_smoother(ys, A, 0.0, Q, 1.0, R, 0.0, SIGMA0)
        want = [np.asarray(w) for w in want]
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-10)
    # The smoother's last step is the filter's; its log-likelihood is the filter's.
    filt = apt.utils.kalman_filter(ys, A, 0.0, Q, 1.0, R, 0.0, SIGMA0)
    assert float(got.means[-1]) == float(filt.means[-1])
    assert float(got.log_likelihood) == float(filt.log_likelihood)


@pytest.mark.parametrize("ancestor_sampling", [False, True])
def test_conditional_sweep_matches_jax_until_the_first_boundary_flip(ancestor_sampling):
    # Every PGAS step resamples, and the chance that some position lies within
    # float32 rounding of a CDF entry grows faster than N: at N = 4096 a flip
    # comes within the first few steps, at N = 1024 after many.
    n, steps = 1024, 40
    ys = _ys(13, steps)
    ref = np.array(aps.simulate(jax.random.key(14), aps.models.stationary_lgssm(A, Q, R),
                                steps)[0], np.float32)
    key = jax.random.key(31)
    sampler_j, sampler_t = ((aps.PGAS(n), apt.PGAS(n)) if ancestor_sampling
                            else (aps.PG(n), apt.PG(n)))
    jr = aps.sweep(key, aps.SSMKernel(ssm=aps.TracedSSM(aps.models.stationary_lgssm(A, Q, R),
                                                        jnp.asarray(ys))),
                   n, sampler_j.resampler, ref=jnp.asarray(ref),
                   ancestor_sampling=ancestor_sampling)
    tr = cpu_sweep(_port_key(key), apt.SSMKernel(cpu_traced_ssm(PARAMS, ys)), n,
                   sampler_t.resampler, ref=torch.as_tensor(ref),
                   ancestor_sampling=ancestor_sampling)
    j_anc, t_anc = np.asarray(jr.ancestors), tr.ancestors.numpy()
    # JAX's CPU sweep draws the n − 1 ancestors by searchsorted and appends
    # the reference's; the port decodes all n slots from extents drawn for
    # n − 1 positions and overwrites slot n − 1.  Until an ancestor flips at
    # a float32 boundary the two are the same computation.
    flips = (j_anc != t_anc).sum(axis=1)
    first = int(np.argmax(flips > 0)) if flips.any() else steps
    assert first > 2
    if first < steps:  # the first difference is a flip to a neighbour
        d = np.abs(t_anc[first].astype(np.int64) - j_anc[first])
        assert d.max() == 1 and flips[first] <= 2
    np.testing.assert_array_equal(t_anc[:first, -1], j_anc[:first, -1])
    if not ancestor_sampling:
        assert (t_anc[:, -1] == n - 1).all()
    states = tr.states.numpy()
    np.testing.assert_allclose(states[:first], np.asarray(jr.states)[:first], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(states[:, -1], ref)  # the reference slot reads ref
    np.testing.assert_allclose(tr.ess.numpy()[:first], np.asarray(jr.ess)[:first], rtol=1e-4)


@pytest.mark.parametrize("sampler_cls", [apt.PG, apt.PGAS])
def test_replay_storage_matches_dense(sampler_cls):
    # As test_pg_pgas.py: same key ⇒ same genealogy and draws; states agree
    # to float reordering (one-element against N-element elementwise kernels).
    traced = _traced(seed=3)
    key = apt.rng.key(9)
    dense = cpu_sample(key, traced, sampler_cls(12), 8)
    repl = cpu_sample(key, traced, sampler_cls(12), 8, trajectory_storage="replay")
    np.testing.assert_allclose(dense.trajectory.numpy(), repl.trajectory.numpy(), rtol=0,
                               atol=1e-5)
    assert torch.equal(dense.log_evidence, repl.log_evidence)
    # And one conditional iteration at a larger N.
    st = apt.PGState(dense.trajectory[-1])
    d, d_st = cpu_step_pg(apt.rng.key(4), traced, sampler_cls(2048), st, "dense")
    r, r_st = cpu_step_pg(apt.rng.key(4), traced, sampler_cls(2048), st, "replay")
    np.testing.assert_allclose(d.trajectory.numpy(), r.trajectory.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(d.log_evidence, r.log_evidence)
    assert d_st.trajectory is d.trajectory and d.trajectory.shape == (6,)


@pytest.mark.parametrize("sampler_cls", [apt.PG, apt.PGAS])
def test_seeded_determinism(sampler_cls):
    traced = _traced(seed=0, steps=6)
    c1 = cpu_sample(apt.rng.key(7), traced, sampler_cls(10), 10)
    c2 = cpu_sample(apt.rng.key(7), traced, sampler_cls(10), 10)
    assert torch.equal(c1.trajectory, c2.trajectory)
    assert torch.equal(c1.log_evidence, c2.log_evidence)
    assert c1.trajectory.shape == (10, 6) and c1.log_evidence.shape == (10,)
    c3 = cpu_sample(apt.rng.key(8), traced, sampler_cls(10), 10)
    assert not torch.equal(c1.trajectory, c3.trajectory)


class _CtrlKernel(apt.SweepKernel):
    """3-step kernel with hand-set weights: among the non-reference slots only
    slot 1 has a finite log-weight.  The state is the slot id at t = 0."""

    num_steps = 3

    def __init__(self, n=4):
        self.n = n

    def _scores(self):
        s = torch.full((self.n,), -math.inf)
        s[1] = 0.0
        return s

    def init(self, rng, ref0, ref_mask):
        x = apt.inject_ref(ref_mask, ref0, torch.arange(self.n, dtype=torch.float32))
        return x, self._scores()

    def step(self, t, rng, state, ref_t, ref_mask):
        return apt.inject_ref(ref_mask, ref_t, state), self._scores()

    def snapshot(self, state):
        return state

    def transition_logprob(self, t, state, ref_t):
        return torch.zeros(self.n)  # ancestor weights are the weights alone


@pytree_dataclass
class _JCtrlKernel(JSweepKernel):
    """The same kernel in JAX (``tests/test_pg_pgas.py``)."""

    n: int = 4

    @property
    def num_steps(self):
        return 3

    def _scores(self):
        return jnp.full((self.n,), -jnp.inf).at[1].set(0.0)

    def init(self, rng, ref0, ref_mask):
        return jinject_ref(ref_mask, ref0, jnp.arange(self.n, dtype=jnp.float32)), self._scores()

    def step(self, t, rng, state, ref_t, ref_mask):
        return jinject_ref(ref_mask, ref_t, state), self._scores()

    def snapshot(self, state):
        return state

    def transition_logprob(self, t, state, ref_t):
        return jnp.zeros((self.n,))


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda f: f.__name__)
def test_pgas_ancestor_update_whitebox(scheme):
    # As test_pg_pgas.py:86-104, through each scheme: the ancestor weights
    # are [-inf, 0, -inf, -inf], so the reference slot's ancestor is slot 1 at
    # every step, and so is every other slot's.
    res = cpu_sweep(apt.rng.key(0), _CtrlKernel(4), 4,
                    apt.ResampleWithESSThreshold(scheme, float("inf")),
                    ref=torch.full((3,), 99.0), ancestor_sampling=True)
    assert (res.ancestors[1:] == 1).all()
    assert (res.states[:, -1] == 99.0).all()
    jr = aps.sweep(jax.random.key(0), _JCtrlKernel(n=4), 4,
                   aps.resampling.ResampleWithESSThreshold(threshold=float("inf")),
                   ref=jnp.full((3,), 99.0), ancestor_sampling=True)
    np.testing.assert_array_equal(res.ancestors.numpy(), np.asarray(jr.ancestors))


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda f: f.__name__)
def test_pg_reference_ancestor_is_fixed_without_ancestor_sampling(scheme):
    res = cpu_sweep(apt.rng.key(0), _CtrlKernel(4), 4,
                    apt.ResampleWithESSThreshold(scheme, float("inf")),
                    ref=torch.zeros(3), ancestor_sampling=False)
    assert (res.ancestors[:, -1] == 3).all()
    assert (res.ancestors[1:, :-1] == 1).all()


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda f: f.__name__)
def test_single_particle_pg_replays(scheme):
    # PG with one particle returns the same trajectory and log-evidence every
    # iteration: no position is drawn, the reference fills the only slot.
    chain = cpu_sample(apt.rng.key(0), _traced(steps=5), apt.PG(1, scheme, 1.0), 3)
    t = chain.trajectory
    assert torch.equal(t[0], t[1]) and torch.equal(t[1], t[2])
    assert float(chain.log_evidence[0]) == float(chain.log_evidence[2])


def test_pg_constructor_defaults():
    s = apt.PG(10)
    assert s.n_particles == 10 and not s.ancestor_sampling
    assert s.resampler.resampler is apt.resample_systematic and s.resampler.threshold == 0.5
    assert apt.PG(60, 0.6).resampler.threshold == 0.6
    s = apt.PG(80, apt.resample_multinomial, 0.6)
    assert s.resampler.resampler is apt.resample_multinomial and s.resampler.threshold == 0.6


def test_pgas_constructor_default_always_resamples():
    s = apt.PGAS(10)
    assert s.n_particles == 10 and s.ancestor_sampling
    assert s.resampler.threshold == 1.0
    assert apt.PGAS(10, apt.resample_stratified).resampler.threshold == float("inf")


def test_pg_errors():
    traced = _traced(steps=4)
    with pytest.raises(ValueError, match="n_iterations"):
        cpu_sample(apt.rng.key(0), traced, apt.PG(8))
    with pytest.raises(ValueError, match="trajectory_storage"):
        cpu_step_pg(apt.rng.key(0), traced, apt.PG(8), trajectory_storage="sparse")
    with pytest.raises(ValueError, match="reference"):
        cpu_sweep(apt.rng.key(0), apt.SSMKernel(traced), 8, apt.PG(8).resampler,
                  ancestor_sampling=True)

    class NoDensity(_CtrlKernel):
        transition_logprob = apt.SweepKernel.transition_logprob

    with pytest.raises(NotImplementedError, match="transition densities"):
        cpu_sweep(apt.rng.key(0), NoDensity(4), 4, apt.PGAS(4).resampler,
                  ref=torch.zeros(3), ancestor_sampling=True)


@pytest.mark.parametrize("scheme", [apt.resample_systematic, apt.resample_multinomial],
                         ids=lambda f: f.__name__)
def test_pgas_posterior_mean_matches_rts(scheme):
    # Retained trajectories are marginally the smoothing law: the pooled mean
    # of independent chains against the RTS means, with the standard error of
    # bench_pgas.py:103-111 (chain means, floored at sd/sqrt(iterates)).
    steps, n, chains, iters, warm = 15, 256, 4, 25, 5
    ys = _ys(2, steps)
    traced = cpu_traced_ssm(PARAMS, ys)
    sm = apt.utils.kalman_smoother(ys, A, 0.0, Q, 1.0, R, 0.0, SIGMA0)
    cm = torch.stack([
        cpu_sample(apt.rng.fold_in(apt.rng.key(9), c), traced, apt.PGAS(n, scheme, 1.0),
                   iters).trajectory[warm:].double().mean(0)
        for c in range(chains)
    ])
    se = torch.maximum(cm.std(0) / math.sqrt(chains),
                       sm.variances.sqrt() / math.sqrt(chains * (iters - warm)))
    zrms = float((((cm.mean(0) - sm.means) / se) ** 2).mean().sqrt())
    assert zrms < 3.0


@pytest.mark.parametrize("sampler_cls", [apt.PGAS, apt.PG])
def test_ks_vs_kalman(sampler_cls):
    # The reference's gold test (tests/test_linear_gaussian.py::test_ks_vs_kalman):
    # a 1-D LGSSM with T = 3, 100 particles, 200 MCMC samples; the final
    # state's draws against the exact filtering marginal, KS p > 0.05.  Both
    # packages get the observations the JAX package simulates.
    a, b, q, h, r, x0, p0 = 0.5, 0.2, 0.1, 1.0, 0.1, 0.0, 1.0
    model = aps.models.LinearGaussianSSM(x0, p0, a, b, q, h, r)
    _, ys = aps.simulate(jax.random.key(1234), model, 3)
    ys = np.array(ys)
    traced = cpu_traced_ssm(dict(mu=x0, sigma0=p0, a=a, b=b, q=q, h=h, r=r), ys)
    kf = apt.utils.kalman_filter(ys, a, b, q, h, r, x0, p0)
    chain = cpu_sample(apt.rng.key(4321), traced, sampler_cls(100), 200)
    final = chain.trajectory[:, -1].numpy()
    assert final.shape == (200,)
    mean, std = float(kf.means[-1]), math.sqrt(float(kf.variances[-1]))
    p = scipy.stats.kstest(final, "norm", args=(mean, std)).pvalue
    assert p > 0.05, f"{sampler_cls.__name__}: KS p={p}"
