"""The port's resampling schemes against the JAX package: the four resamplers
and ``randcat_gumbel``, the fused stratified and multinomial steps (the
engine's extents, on the CPU through the kernels' plain versions) against the
JAX pieces with the Pallas kernels in interpret mode, and each scheme's SMC
sweep against the Kalman evidence.

Same key words, numpy inputs, small sizes.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import advancedps_tpu as aps  # noqa: E402
from advancedps_tpu import resampling as jres  # noqa: E402
from advancedps_tpu import rng as jrng  # noqa: E402
from advancedps_tpu.ops import pallas_resample as pr  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import engine as tengine  # noqa: E402
from advancedps_tpu_torch import resampling as tres  # noqa: E402
from advancedps_tpu_torch.ops import resample as ops  # noqa: E402

# The port runs on the GPU unless the caller asks for the CPU: every call of an
# entry point in this file names device="cpu", through these partials.
cpu_sweep = functools.partial(apt.sweep, device="cpu")
cpu_sample = functools.partial(apt.sample, device="cpu")
cpu_traced_ssm = functools.partial(apt.traced_ssm_from_numpy, device="cpu")
cpu_spacings = functools.partial(tres.multinomial_spacings, device="cpu")

A, Q, R = 0.9, 0.32, 1.0
SIGMA0 = math.sqrt(Q * Q / (1 - A * A))
PARAMS = dict(mu=0.0, sigma0=SIGMA0, a=A, b=0.0, q=Q, h=1.0, r=R)
SCHEMES = ["systematic", "stratified", "multinomial", "residual"]


def _port_key(jkey):
    return apt.key_from_words(np.asarray(jax.random.key_data(jkey)))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32).astype(np.int64)


def _weights(m, seed):
    w = np.random.default_rng(seed).gamma(0.5, size=m).astype(np.float32)
    return w / w.sum(dtype=np.float32)


@pytest.mark.parametrize("m", [1000, 4096])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_resamplers_match_jax(scheme, m):
    w = _weights(m, seed=m + SCHEMES.index(scheme))
    key = jax.random.key(m + 17)
    want = np.asarray(getattr(jres, f"resample_{scheme}")(key, jnp.asarray(w), m))
    got = getattr(tres, f"resample_{scheme}")(_port_key(key), torch.as_tensor(w), m).numpy()
    # The same uniforms (bitwise, positional) through the same searchsorted
    # form; torch's and XLA's float32 cumsum round a CDF entry differently
    # now and then and move one ancestor to its neighbour.
    diff = np.abs(got.astype(np.int64) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert got.dtype == np.int32 and got.shape == (m,)
    if scheme != "systematic":
        u_j = jrng.pos_uniform(key, jnp.arange(m))
        u_t = apt.rng.pos_uniform(_port_key(key), torch.arange(m))
        np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    if scheme in ("systematic", "stratified"):
        assert (np.diff(got) >= 0).all()


@pytest.mark.parametrize("scheme,tol", [("systematic", 1e-3), ("stratified", 1e-3),
                                        ("multinomial", 1e-2), ("residual", 1e-2)])
def test_resampling_frequencies(scheme, tol):
    # Weights [0.3, 0.4, 0.3], 10^6 draws: index 1 comes up with frequency 0.4,
    # within 1e-3 for the low-variance schemes and 1e-2 for the others
    # (BASELINE.md; tests/test_resampling.py::test_frequency_oracle).
    w = torch.tensor([0.3, 0.4, 0.3])
    n = 1_000_000
    idx = getattr(tres, f"resample_{scheme}")(apt.rng.key(42), w, n)
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (n,)
    assert int(idx.min()) >= 0 and int(idx.max()) <= 2
    assert abs(float((idx == 1).double().mean()) - 0.4) < tol


def test_residual_deterministic_copies_are_exact():
    # n·w integral for every particle: all slots are deterministic copies.
    w = np.asarray([0.25, 0.5, 0.0, 0.25], np.float32)
    got = tres.resample_residual(apt.rng.key(0), torch.as_tensor(w), 8)
    assert got.tolist() == [0, 0, 1, 1, 1, 1, 3, 3]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jres.resample_residual(jax.random.key(0), jnp.asarray(w), 8)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randcat_gumbel_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logw = (rng.standard_normal(3000) * 2).astype(np.float32)
    logw[rng.choice(3000, 500, replace=False)] = -np.inf  # excluded slots
    for t in range(20):
        key = jrng.step_key(jax.random.key(seed), jrng.ANCESTOR, t)
        want = int(jres.randcat_gumbel(key, jnp.asarray(logw)))
        got = tres.randcat_gumbel(_port_key(key), torch.as_tensor(logw))
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == want and np.isfinite(logw[want])
    # Only one finite weight: always that slot.
    one = np.full(64, -np.inf, np.float32)
    one[17] = 0.0
    assert int(tres.randcat_gumbel(apt.rng.key(3), torch.as_tensor(one))) == 17


def test_as_gated_resampler():
    g = tres.as_gated_resampler(tres.resample_stratified)
    assert g.resampler is tres.resample_stratified and g.threshold == float("inf")
    assert tres.as_gated_resampler(g) is g


def _fused_case(profile, m, guarded, seed):
    rng = np.random.default_rng(seed)
    if profile == "lognormal":
        logw = (rng.standard_normal(m) * 2).astype(np.float32)
    else:  # one survivor
        logw = np.full(m, -80.0, np.float32)
        logw[rng.integers(m)] = 0.0
    mx = np.float32(logw.max())
    s1 = np.float32(np.exp(logw - mx, dtype=np.float32).sum(dtype=np.float32))
    n = m - 1 if guarded else m
    x = rng.standard_normal(m).astype(np.float32)
    return logw, mx, s1, n, x


def _port_fused(scheme, key, logw, mx, s1, n):
    """The engine's extents for one firing, on the CPU."""
    return tengine._fused_extents(scheme, _port_key(key), torch.as_tensor(logw),
                                  torch.tensor(mx), torch.tensor(s1), n).numpy()


def _jax_fused(scheme, key, logw, mx, s1, n):
    """The JAX engine's fused extents (``engine.py:339-352``), its Pallas
    kernels in interpret mode."""
    logw, mx, s1 = jnp.asarray(logw), jnp.float32(mx), jnp.float32(s1)
    if scheme == "stratified":
        c = pr.scaled_prefix_from_logw(logw, mx, n / s1, interpret=True)
        return np.asarray(jres.stratified_extents(key, c, n))
    g = jres.multinomial_spacings(key, n)
    S = pr.prefix_sum(g, interpret=True)
    thr = pr.scaled_prefix_from_logw(logw, mx, S[n] / s1, interpret=True)
    return np.asarray(pr.count_le_sorted_auto(S[:n], thr, interpret=True))


@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("profile", ["lognormal", "single"])
@pytest.mark.parametrize("scheme", ["stratified", "multinomial"])
def test_fused_step_matches_pallas(scheme, profile, guarded):
    m = 4096
    logw, mx, s1, n, x = _fused_case(profile, m, guarded, seed=m + guarded)
    key = jrng.step_key(jax.random.key(5), jrng.RESAMPLE, 3)
    f = _port_fused(scheme, key, logw, mx, s1, n)
    f_jax = _jax_fused(scheme, key, logw, mx, s1, n)
    # The scaled prefixes differ by float32 ulps (test_torch_ops), and the
    # multinomial gaps by log1p ulps; an extent moves by one where that
    # straddles a stratum boundary or a sorted uniform.
    diff = np.abs(f.astype(np.int64) - f_jax)
    assert diff.max() <= 1 and (diff > 0).mean() <= 2e-3
    assert (np.diff(f) >= 0).all() and f.min() >= 0 and f.max() <= n
    # Given the same extents, the decode and move are exact.
    anc, moved = ops.move_rows(ops.decode_ancestors(torch.as_tensor(f), m, guard=n),
                               torch.as_tensor(x))
    anc_j, moved_j = pr.resample_move_f(jnp.asarray(f), jnp.asarray(x), m, interpret=True,
                                        guard_n=n)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(anc_j))
    np.testing.assert_array_equal(_bits(moved.numpy()), _bits(moved_j))
    if guarded:
        assert anc[-1] == m - 1 and moved[-1] == 0


def test_multinomial_spacings_match_jax():
    key = jax.random.key(4)
    want = np.asarray(jres.multinomial_spacings(key, 5000))
    got = cpu_spacings(_port_key(key), 5000).numpy()
    assert got.shape == (5001,) and np.isfinite(got).all() and (got >= 0).all()
    # −log1p(−u) of bitwise-equal uniforms: log1p differs by an ulp across
    # backends.
    assert np.abs(_bits(got) - _bits(want)).max() <= 2


def test_fused_multinomial_offspring_follow_the_weights():
    # Offspring counts Multinomial(n, w): frequencies n·w_j (as
    # test_fast_resampling_schemes.py, on the port's fused path).
    w = np.asarray([0.3, 0.4, 0.3], np.float32)
    logw = np.log(w)
    n = 100_000
    f = tengine._fused_extents("multinomial", apt.rng.key(42), torch.as_tensor(logw),
                               torch.tensor(logw.max()), torch.tensor(np.exp(logw - logw.max()).sum()), n)
    anc = ops.decode_ancestors(f, n)
    freq = np.bincount(np.minimum(anc.numpy(), 2), minlength=3) / n
    np.testing.assert_allclose(freq, w, atol=1e-2)


def _ys(seed, steps):
    _, ys = aps.simulate(jax.random.key(seed), aps.models.stationary_lgssm(A, Q, R), steps)
    return np.array(ys)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_sweep_with_each_scheme_matches_kalman(scheme):
    # As test_fast_resampling_schemes.py:253-280: N = 2000, T = 25.
    key = jax.random.key(7)
    ys = _ys(7, 25)
    kf = apt.utils.kalman_filter(ys, A, 0.0, Q, 1.0, R, 0.0, SIGMA0)
    sampler = apt.SMC(2000, apt.ResampleWithESSThreshold(getattr(tres, f"resample_{scheme}")))
    out = cpu_sample(_port_key(jax.random.fold_in(key, 1)), cpu_traced_ssm(PARAMS, ys),
                     sampler)
    assert abs(float(out.log_evidence) - float(kf.log_likelihood)) < 0.5
    assert out.diagnostics["resampled"].any()
    assert torch.isfinite(out.trajectories).all() and out.trajectories.shape == (25, 2000)


@pytest.mark.parametrize("scheme", ["stratified", "residual"])
def test_sweep_matches_jax_until_the_first_boundary_flip(scheme):
    # Stratified: JAX's CPU sweep runs the searchsorted form, the port the
    # fused extents; both consume the same positional uniforms.  Residual:
    # both run the same formula.  They agree until an ancestor flips at a
    # float32 boundary (see test_torch_sweep.py).
    n, steps = 4096, 40
    ys = _ys(11, steps)
    key = jax.random.key(21)
    resampler = getattr(jres, f"resample_{scheme}")
    jr = aps.sweep(key, aps.SSMKernel(ssm=aps.TracedSSM(aps.models.stationary_lgssm(A, Q, R),
                                                        jnp.asarray(ys))),
                   n, jres.ResampleWithESSThreshold(resampler))
    tr = cpu_sweep(_port_key(key), apt.SSMKernel(cpu_traced_ssm(PARAMS, ys)), n,
                   apt.ResampleWithESSThreshold(getattr(tres, f"resample_{scheme}")))
    j_anc, t_anc = np.asarray(jr.ancestors), tr.ancestors.numpy()
    flips = (j_anc != t_anc).sum(axis=1)
    first = int(np.argmax(flips > 0)) if flips.any() else steps
    assert first > 1 and (first == steps or flips[first] <= 2e-3 * n)
    assert np.asarray(jr.resampled)[:first].any()
    np.testing.assert_allclose(tr.states.numpy()[:first], np.asarray(jr.states)[:first],
                               rtol=1e-5, atol=1e-5)
