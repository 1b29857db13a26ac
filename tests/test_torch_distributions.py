"""The port's distributions against scipy and against the JAX package.

Mirrors ``tests/test_distributions.py`` (log-probs against scipy, moments,
positional layout independence, the KS tests of the counted gamma, beta and
t, Poisson and Categorical frequencies, stream non-collision) and adds
draw-by-draw parity with the JAX package's ``sample_rng`` and
``sample_positional`` for the same key words: bitwise where the draw is a
uniform (Uniform, Bernoulli, Categorical, the counted Poisson), within ulps
where a transcendental transform follows (normals, log, exp, the gamma's
acceptance), or absolutely near zero where ``loc + scale·z`` cancels (XLA
contracts it into one fused multiply-add, the port rounds twice).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy.stats as st  # noqa: E402

import advancedps_tpu as aps  # noqa: E402
from advancedps_tpu import rng as jrng  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import random as rnd  # noqa: E402
from advancedps_tpu_torch import rng as trng  # noqa: E402

JKEY = jax.random.key(0)
KEY = apt.key_from_words(np.asarray(jax.random.key_data(JKEY)))


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _close(got, want, ulps, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ok = (_ulps(got, want) <= ulps) | (np.abs(got - want) <= atol)
    assert ok.all(), (_ulps(got, want).max(), np.abs(got - want).max())


@pytest.mark.parametrize(
    "dist,ref,xs",
    [
        (apt.Normal(0.5, 2.0), st.norm(0.5, 2.0), [-1.0, 0.0, 3.0]),
        (apt.Gamma(2.0, 3.0), st.gamma(2.0, scale=3.0), [0.5, 2.0, 10.0]),
        (apt.Beta(2.0, 5.0), st.beta(2.0, 5.0), [0.1, 0.5, 0.9]),
        (apt.Uniform(-1.0, 3.0), st.uniform(-1.0, 4.0), [0.0, 2.0]),
        (apt.Exponential(2.0), st.expon(scale=2.0), [0.1, 1.0, 5.0]),
        (apt.LogNormal(0.3, 0.8), st.lognorm(0.8, scale=np.exp(0.3)), [0.5, 1.0, 4.0]),
        (apt.StudentT(4.0, 1.0, 2.0), st.t(4.0, loc=1.0, scale=2.0), [-2.0, 1.0, 3.0]),
        (apt.Poisson(2.5), st.poisson(2.5), [0.0, 2.0, 7.0]),
        (apt.Bernoulli(0.3), st.bernoulli(0.3), [0.0, 1.0]),
    ],
)
def test_log_prob_matches_scipy(dist, ref, xs):
    xs = np.asarray(xs, np.float32)
    got = dist.log_prob(torch.as_tensor(xs)).numpy()
    want = ref.logpmf(xs) if hasattr(ref.dist, "pmf") else ref.logpdf(xs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


FAMILIES = [
    ("Normal", (0.5, 2.0), [-1.0, 0.0, 3.0]),
    ("Gamma", (2.0, 3.0), [0.5, 2.0, 10.0]),
    ("Beta", (2.0, 5.0), [0.1, 0.5, 0.9]),
    ("Uniform", (-1.0, 3.0), [0.0, 2.0, 4.0]),
    ("Exponential", (2.0,), [0.1, 1.0, 5.0, -1.0]),
    ("LogNormal", (0.3, 0.8), [0.5, 1.0, 4.0]),
    ("StudentT", (4.0, 1.0, 2.0), [-2.0, 1.0, 3.0]),
    ("Poisson", (2.5,), [0.0, 2.0, 7.0]),
    ("Bernoulli", (0.3,), [0.0, 1.0]),
    ("Dirac", (1.5,), [1.5, 1.0]),
]


@pytest.mark.parametrize("name,params,xs", FAMILIES)
def test_log_prob_matches_jax(name, params, xs):
    xs = np.asarray(xs, np.float32)
    want = np.asarray(getattr(aps, name)(*params).log_prob(jnp.asarray(xs)))
    got = getattr(apt, name)(*params).log_prob(torch.as_tensor(xs)).numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=2e-6, atol=2e-6)


def test_mvnormal_and_categorical_log_prob():
    loc = np.array([0.5, -1.0], np.float32)
    cov = np.array([[2.0, 0.3], [0.3, 1.0]], np.float32)
    x = np.random.default_rng(0).standard_normal((10, 2)).astype(np.float32)
    got = apt.MvNormal(torch.as_tensor(loc), torch.as_tensor(cov)).log_prob(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), st.multivariate_normal(loc, cov).logpdf(x),
                               rtol=1e-5, atol=1e-5)
    # Batched parameters: a mean per row, one covariance.
    locs = np.random.default_rng(1).standard_normal((10, 2)).astype(np.float32)
    got = apt.MvNormal(torch.as_tensor(locs), torch.as_tensor(cov)).log_prob(torch.as_tensor(x))
    want = [st.multivariate_normal(m, cov).logpdf(v) for m, v in zip(locs, x)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    p = torch.tensor([0.2, 0.5, 0.3])
    assert abs(float(apt.Categorical(p).log_prob(1)) - np.log(0.5)) < 1e-6
    assert float(apt.Categorical(p).mean) == pytest.approx(1.1)


def test_bernoulli_extreme_p_exact():
    # xlogy scoring: p ∈ {0, 1} gives exact 0 and −inf.
    assert float(apt.Bernoulli(1.0).log_prob(1.0)) == 0.0
    assert float(apt.Bernoulli(1.0).log_prob(0.0)) == -np.inf
    assert float(apt.Bernoulli(0.0).log_prob(0.0)) == 0.0


def test_key_sampling_moments():
    key = rnd.key_tensor(KEY, "cpu")
    s = apt.Normal(1.5, 0.7).sample(key, (100_000,))
    assert abs(float(s.mean()) - 1.5) < 0.01 and abs(float(s.std()) - 0.7) < 0.01
    g = apt.Gamma(2.0, 3.0).sample(key, (50_000,))
    assert abs(float(g.mean()) - 6.0) < 0.1
    m = apt.MvNormal(torch.zeros(2), torch.tensor([[2.0, 0.3], [0.3, 1.0]])).sample(KEY, (50_000,))
    np.testing.assert_allclose(np.cov(m.numpy().T), [[2.0, 0.3], [0.3, 1.0]], atol=0.05)


# --- draw-by-draw parity with the JAX package --------------------------------

PARITY = [
    # name, params, bitwise draws
    ("Uniform", (-1.0, 2.0), True),
    ("Bernoulli", (0.3,), True),
    ("Poisson", (3.5,), True),
    ("Categorical", (np.array([0.2, 0.5, 0.3], np.float32),), True),
    ("Dirac", (1.5,), True),
    ("Normal", (0.3, 1.7), False),
    ("Exponential", (1.5,), False),
    ("LogNormal", (0.1, 0.5), False),
    ("Gamma", (2.5, 1.3), False),
    ("Gamma", (0.4, 1.0), False),
    ("Beta", (2.0, 3.0), False),
    ("StudentT", (4.0, 0.5, 2.0), False),
]


@pytest.mark.parametrize("name,params,bitwise", PARITY)
def test_positional_draws_match_jax(name, params, bitwise):
    gids = np.arange(2000)
    jd = getattr(aps, name)(*(jnp.asarray(p) for p in params))
    td = getattr(apt, name)(*(torch.as_tensor(p) for p in params))
    jr = jrng.StepRng(key=JKEY, gids=jnp.asarray(gids))
    tr = trng.StepRng(KEY, torch.as_tensor(gids))
    pairs = [(jd.sample_positional(JKEY, jnp.asarray(gids)),
              td.sample_positional(KEY, torch.as_tensor(gids)))]
    pairs.append((jd.sample_rng(jr, 2), td.sample_rng(tr, 2)))
    for want, got in pairs:
        want, got = np.asarray(want), got.numpy()
        assert got.shape == want.shape
        if bitwise:
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want, ulps=64, atol=1e-5)


@pytest.mark.parametrize("name,params", [("Uniform", (-1.0, 2.0)), ("Bernoulli", (0.3,)),
                                         ("Categorical", (np.array([0.2, 0.5, 0.3], np.float32),)),
                                         ("Exponential", (1.5,)), ("Normal", (0.3, 1.7)),
                                         ("LogNormal", (0.1, 0.5))])
def test_key_draws_match_jax(name, params):
    # sample(key, shape): jax.random's draws.
    want = np.asarray(getattr(aps, name)(*(jnp.asarray(p) for p in params)).sample(JKEY, (500,)))
    got = getattr(apt, name)(*(torch.as_tensor(p) for p in params)).sample(
        rnd.key_tensor(KEY, "cpu"), (500,)).numpy()
    if name in ("Uniform", "Bernoulli", "Categorical"):
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want, ulps=64, atol=1e-5)


def test_mvnormal_draws_match_jax():
    loc, cov = np.array([0.5, -1.0], np.float32), np.array([[2.0, 0.3], [0.3, 1.0]], np.float32)
    jd = aps.MvNormal(jnp.asarray(loc), jnp.asarray(cov))
    td = apt.MvNormal(torch.as_tensor(loc), torch.as_tensor(cov))
    gids = np.arange(1000)
    _close(td.sample_positional(KEY, torch.as_tensor(gids)).numpy(),
           jd.sample_positional(JKEY, jnp.asarray(gids)), ulps=64, atol=1e-5)
    _close(td.sample(rnd.key_tensor(KEY, "cpu"), (7,)).numpy(), jd.sample(JKEY, (7,)),
           ulps=64, atol=1e-5)


# --- positional contract: layout independence --------------------------------


def _layout_independent(dist):
    gids = torch.arange(64)
    full = dist.sample_positional(KEY, gids)
    assert torch.equal(full[:32], dist.sample_positional(KEY, gids[:32]))
    assert torch.equal(full[32:], dist.sample_positional(KEY, gids[32:]))
    shuffled = torch.tensor([5, 63, 17, 0])
    assert torch.equal(dist.sample_positional(KEY, shuffled), full[shuffled])


@pytest.mark.parametrize("dist", [apt.Poisson(3.5), apt.Poisson(120.0),
                                  apt.Categorical(torch.tensor([0.2, 0.5, 0.1, 0.2])),
                                  apt.Gamma(2.0, 3.0), apt.Gamma(0.6, 1.0), apt.Beta(2.0, 5.0),
                                  apt.StudentT(4.0, 0.0, 1.0), apt.Exponential(1.0),
                                  apt.MvNormal(torch.zeros(3), torch.eye(3))],
                         ids=lambda d: type(d).__name__)
def test_positional_layout_independent(dist):
    _layout_independent(dist)


@pytest.mark.parametrize("rate", [0.3, 2.5, 30.0])
def test_poisson_positional_frequencies(rate):
    n = 100_000
    s = apt.Poisson(rate).sample_positional(KEY, torch.arange(n)).numpy()
    assert s.min() >= 0 and (s == np.round(s)).all()
    np.testing.assert_allclose(s.mean(), rate, rtol=0.02)
    np.testing.assert_allclose(s.var(), rate, rtol=0.05)
    ref = st.poisson(rate)
    for k in range(int(rate + 3)):
        np.testing.assert_allclose((s == k).mean(), ref.pmf(k), atol=4.0 / np.sqrt(n))


def test_poisson_positional_large_rate_fallback():
    # exp(−λ) below float32's normal range: the per-id key path, positional.
    s = apt.Poisson(120.0).sample_positional(KEY, torch.arange(30_000)).numpy()
    np.testing.assert_allclose(s.mean(), 120.0, rtol=0.02)
    np.testing.assert_allclose(s.var(), 120.0, rtol=0.08)


def test_poisson_positional_batched_rates_and_saturation():
    rates = torch.tensor([0.5, 4.0, 9.0, 1.0] * 16)
    gids = torch.arange(64)
    full = apt.Poisson(rates).sample_positional(KEY, gids)
    assert torch.equal(full[:32], apt.Poisson(rates[:32]).sample_positional(KEY, gids[:32]))
    # A uniform past the float32 CDF's saturation ends the walk at a sane draw.
    out = apt.Poisson(60.0).sample_positional(KEY, torch.tensor([1900208, 0, 1, 2])).numpy()
    assert (out >= 0).all() and (out < 200.0).all()


def test_categorical_positional_frequencies_and_batched_probs():
    n = 100_000
    p = np.asarray([0.3, 0.4, 0.3], np.float32)
    s = apt.Categorical(torch.as_tensor(p)).sample_positional(KEY, torch.arange(n)).numpy()
    assert s.dtype == np.int32 and s.min() >= 0 and s.max() <= 2
    for k in range(3):
        np.testing.assert_allclose((s == k).mean(), p[k], atol=5e-3)
    probs = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.2, 0.8]]).repeat(n // 2, 1)
    s = apt.Categorical(probs).sample_positional(KEY, torch.arange(n)).numpy()
    assert (s[0::2] == 0).all() and set(np.unique(s[1::2])) <= {1, 2}
    np.testing.assert_allclose((s[1::2] == 2).mean(), 0.8, atol=6e-3)


@pytest.mark.parametrize("alpha", [0.5, 1.0, 2.0, 7.5])
def test_gamma_positional_ks_vs_scipy(alpha):
    s = apt.Gamma(alpha, 1.0).sample_positional(KEY, torch.arange(30_000)).numpy()
    assert (s >= 0).all() and np.isfinite(s).all()
    assert st.kstest(s, st.gamma(alpha).cdf).pvalue > 1e-3


def test_gamma_positional_scale_and_batched_params():
    n = 60_000
    alphas = torch.where(torch.arange(n) % 2 == 0, 0.7, 4.0)
    s = apt.Gamma(alphas, 2.0).sample_positional(KEY, torch.arange(n)).numpy()
    np.testing.assert_allclose(s[0::2].mean(), 1.4, rtol=0.03)
    np.testing.assert_allclose(s[1::2].mean(), 8.0, rtol=0.03)


@pytest.mark.parametrize("a,b", [(2.0, 5.0), (0.5, 0.5), (3.0, 1.0)])
def test_beta_positional_ks_vs_scipy(a, b):
    s = apt.Beta(a, b).sample_positional(KEY, torch.arange(30_000)).numpy()
    assert ((s >= 0) & (s <= 1)).all()
    assert st.kstest(s, st.beta(a, b).cdf).pvalue > 1e-3


@pytest.mark.parametrize("df", [3.0, 10.0])
def test_studentt_positional_ks_vs_scipy(df):
    s = apt.StudentT(df, 1.0, 2.0).sample_positional(KEY, torch.arange(30_000)).numpy()
    assert st.kstest(s, st.t(df, loc=1.0, scale=2.0).cdf).pvalue > 1e-3


@pytest.mark.parametrize("name,params,ref", [
    ("Gamma", (0.6, 2.0), st.gamma(0.6, scale=2.0)),
    ("Beta", (0.7, 2.5), st.beta(0.7, 2.5)),
    ("StudentT", (3.0, 0.0, 1.0), st.t(3.0)),
])
def test_key_draws_of_rejection_samplers_ks(name, params, ref):
    # jax.random's rejection loops have no bitwise counterpart: the key-based
    # draws are held to the law.
    keys = rnd.split(rnd.key_tensor(KEY, "cpu"), 20_000)
    d = getattr(apt, name)(*params)
    s = d.sample_keyed(keys).numpy()
    assert st.kstest(s, ref.cdf).pvalue > 1e-3


def test_gamma_positional_streams_do_not_collide():
    gids = torch.arange(4096)
    r = trng.StepRng(trng.step_key(KEY, trng.PROPAGATE, 3), gids)
    g0 = apt.Gamma(2.0, 1.0).sample_rng(r, 0).numpy()
    g1 = apt.Gamma(2.0, 1.0).sample_rng(r, 1).numpy()
    b0 = apt.Beta(2.0, 2.0).sample_rng(r, 0).numpy()
    assert not np.array_equal(g0, g1)
    assert abs(np.corrcoef(g0, g1)[0, 1]) < 0.05 and abs(np.corrcoef(g0, b0)[0, 1]) < 0.05


def test_sample_keyed_is_a_vmap_of_sample():
    keys = rnd.split(rnd.key_tensor(KEY, "cpu"), 16)
    d = apt.Normal(torch.linspace(-1, 1, 16), 0.5)
    got = d.sample_keyed(keys)
    for i in range(16):
        assert torch.equal(got[i], apt.Normal(d.loc[i], 0.5).sample(keys[i]))
    with pytest.raises(ValueError, match="batch_shape"):
        apt.Normal(torch.zeros(3), 1.0).sample_keyed(keys)
