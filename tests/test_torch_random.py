"""The port's key-based samplers and positional draws against ``jax.random``
and the JAX package's ``rng``.

Same key words to both packages: uniform bits, ``split``, ``fold_in``,
``bits``, ``uniform``, ``bernoulli`` and ``categorical`` bitwise; ``normal``
(XLA's erfinv polynomial, ported) and ``exponential`` within 4 ulps; the
rejection samplers held to their laws by KS and moment tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402
from torch.func import vmap  # noqa: E402

from advancedps_tpu import resampling as jresampling  # noqa: E402
from advancedps_tpu import rng as jrng  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import random as rnd  # noqa: E402
from advancedps_tpu_torch import rng as trng  # noqa: E402

SEEDS = [0, 7, 12345]


def _port_key(jkey):
    return apt.key_from_words(np.asarray(jax.random.key_data(jkey)))


def _key_tensor(jkey):
    return rnd.key_tensor(_port_key(jkey), "cpu")


def _words(jkeys):
    return np.asarray(jax.random.key_data(jkeys)).astype(np.int64)


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_bitwise(seed):
    jk = jax.random.key(seed)
    want = _words(jax.random.split(jk, 7))
    np.testing.assert_array_equal(rnd.split(_key_tensor(jk), 7).numpy(), want)
    host = rnd.split(_port_key(jk), 7)
    assert [(k.k0, k.k1) for k in host] == [tuple(w) for w in want.tolist()]
    # A batch of keys splits key by key.
    batch = rnd.split(_key_tensor(jk), 3)
    got = rnd.split(batch, 4)
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), _words(jax.random.split(
            jax.random.wrap_key_data(jnp.asarray(batch[i].numpy().astype(np.uint32))), 4)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_on_batched_keys_bitwise(seed):
    jk = jax.random.key(seed)
    keys = jax.random.split(jk, 5)
    tkeys = torch.as_tensor(_words(keys))
    for d in (0, 3, 2**31 + 5):
        want = _words(jax.vmap(lambda k: jax.random.fold_in(k, d))(keys))
        np.testing.assert_array_equal(rnd.fold_in(tkeys, d).numpy(), want)
    ids = np.arange(9)
    want = _words(jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.asarray(ids)))
    np.testing.assert_array_equal(rnd.fold_in(_port_key(jk), torch.as_tensor(ids)).numpy(), want)
    assert rnd.fold_in(_port_key(jk), 11) == _port_key(jax.random.fold_in(jk, 11))


@pytest.mark.parametrize("shape", [(), (5,), (3, 4)])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_bitwise(seed, shape):
    jk = jax.random.key(seed)
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(rnd.bits(_key_tensor(jk), shape).numpy(), want)


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-0.3, 2.7), (5.0, 5.5)])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bitwise(seed, bounds):
    jk = jax.random.key(seed)
    want = np.asarray(jax.random.uniform(jk, (4099,), minval=bounds[0], maxval=bounds[1]))
    got = rnd.uniform(_key_tensor(jk), (4099,), *bounds).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_and_exponential_within_4_ulps(seed):
    jk = jax.random.key(seed)
    n = 1 << 16
    ul = _ulps(rnd.normal(_key_tensor(jk), (n,)).numpy(), jax.random.normal(jk, (n,)))
    assert ul.max() <= 4 and (ul == 0).mean() > 0.9
    ul = _ulps(rnd.exponential(_key_tensor(jk), (n,)).numpy(), jax.random.exponential(jk, (n,)))
    assert ul.max() <= 4


def test_erfinv_is_xlas_not_torchs():
    # XLA's float32 polynomial, within 4 ulps of jax.lax.erf_inv across
    # (-1, 1); torch.erfinv is further from it.
    x = np.linspace(-0.9999999, 0.9999999, 200_001).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert _ulps(rnd.erfinv(torch.as_tensor(x)).numpy(), want).max() <= 4
    assert _ulps(torch.erfinv(torch.as_tensor(x)).numpy(), want).max() > 4
    assert float(rnd.erfinv(torch.tensor(1.0))) == np.finfo(np.float32).max


@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_and_categorical_bitwise(seed):
    jk = jax.random.key(seed)
    p = np.linspace(0, 1, 33).astype(np.float32)
    np.testing.assert_array_equal(
        rnd.bernoulli(_key_tensor(jk), torch.as_tensor(p), (6, 33)).numpy(),
        np.asarray(jax.random.bernoulli(jk, jnp.asarray(p), (6, 33))))
    logits = np.random.default_rng(seed).standard_normal((4, 5)).astype(np.float32)
    for axis, shape in [(-1, None), (-1, (3, 4)), (0, None)]:
        want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits), axis=axis, shape=shape))
        got = rnd.categorical(_key_tensor(jk), torch.as_tensor(logits), axis, shape)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32


def test_batched_keys_draw_what_each_key_draws():
    keys = rnd.split(_key_tensor(jax.random.key(3)), 6)
    for fn in (lambda k: rnd.normal(k, (4,)), lambda k: rnd.uniform(k, (2, 3), -1.0, 3.0),
               lambda k: rnd.gamma(k, 1.7, (4,)), lambda k: rnd.poisson(k, 12.0, (4,))):
        batch = fn(keys)
        for i in range(6):
            assert torch.equal(batch[i], fn(keys[i]))
        assert torch.equal(vmap(fn)(keys), batch)


def test_samplers_are_vmap_safe():
    # Per-particle parameters and keys under torch.func.vmap, as a model's
    # component draws them in the sweep.
    keys = rnd.split(_key_tensor(jax.random.key(4)), 8)
    a = torch.linspace(0.3, 4.0, 8)
    for fn in (lambda k, s: rnd.gamma(k, s), lambda k, s: rnd.beta(k, s, 2.0),
               lambda k, s: rnd.t(k, s + 1.0), lambda k, s: rnd.poisson(k, 5.0 * s),
               lambda k, s: rnd.bernoulli(k, s / 4.0), lambda k, s: rnd.exponential(k) * s,
               lambda k, s: rnd.categorical(k, torch.stack([s, -s]))):
        out = vmap(fn)(keys, a)
        assert out.shape == (8,)
        for i in range(8):
            assert torch.equal(out[i], fn(keys[i], a[i]))


def _law_draws(fn, n=20_000, seed=11):
    return fn(rnd.split(_key_tensor(jax.random.key(seed)), n)).numpy().astype(np.float64)


@pytest.mark.parametrize("alpha", [0.4, 1.0, 3.5])
def test_gamma_law(alpha):
    x = _law_draws(lambda k: rnd.gamma(k, alpha, ()))
    assert stats.kstest(x, stats.gamma(alpha).cdf).pvalue > 1e-3


def test_beta_and_t_laws():
    x = _law_draws(lambda k: rnd.beta(k, 0.7, 2.5, ()))
    assert stats.kstest(x, stats.beta(0.7, 2.5).cdf).pvalue > 1e-3
    x = _law_draws(lambda k: rnd.t(k, 3.0, ()))
    assert stats.kstest(x, stats.t(3.0).cdf).pvalue > 1e-3


@pytest.mark.parametrize("lam", [0.0, 0.7, 4.0, 9.5, 10.0, 37.0, 250.0])
def test_poisson_law(lam):
    x = _law_draws(lambda k: rnd.poisson(k, lam, ()))
    if lam == 0:
        assert (x == 0).all()
        return
    se = np.sqrt(lam / x.size)
    assert abs(x.mean() - lam) < 5 * se
    assert abs(x.var() / lam - 1) < 0.08
    # Frequencies of the small counts against the pmf.
    k = np.arange(int(lam) + 3)
    obs = np.array([(x == i).sum() for i in k])
    expct = stats.poisson(lam).pmf(k) * x.size
    keep = expct > 20
    z = (obs[keep] - expct[keep]) / np.sqrt(expct[keep])
    assert np.abs(z).max() < 5


# --- positional draws (rng) ---------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 5])
def test_pos_normals_bitwise_uniforms_and_ulps(d):
    jk = jax.random.key(21)
    gids = np.arange(1000)
    want = np.asarray(jrng.pos_normals(jk, jnp.asarray(gids), d, draw0=3))
    got = trng.pos_normals(_port_key(jk), torch.as_tensor(gids), d, draw0=3).numpy()
    assert got.shape == (1000, d)
    assert ((_ulps(got, want) <= 4) | (np.abs(got - want) <= 1e-6)).all()
    # The normal pair of a StepRng is pos_normal_pair's.
    r = trng.StepRng(_port_key(jk), torch.as_tensor(gids))
    z0, z1 = r.normal_pair(3)
    w0, w1 = jrng.pos_normal_pair(jk, jnp.asarray(gids), 3)
    assert _ulps(z0.numpy(), w0).max() <= 4 and _ulps(z1.numpy(), w1).max() <= 4
    assert torch.equal(r.normals(d), trng.pos_normals(r.key, r.gids, d))


@pytest.mark.parametrize("seed", SEEDS)
def test_particle_keys_bitwise(seed):
    jk = jax.random.key(seed)
    for tag, t, n in [(trng.PROPAGATE, 3, 8), (trng.INIT, 0, 5), (trng.RESAMPLE, 99, 17)]:
        want = _words(jrng.particle_keys(jk, tag, t, n))
        got = trng.particle_keys(_port_key(jk), tag, t, n, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    gids = np.array([5, 1, 40_000, 7])
    jr = jrng.StepRng(key=jrng.step_key(jk, trng.PROPAGATE, 2), gids=jnp.asarray(gids))
    tr = trng.StepRng(trng.step_key(_port_key(jk), trng.PROPAGATE, 2), torch.as_tensor(gids))
    np.testing.assert_array_equal(tr.particle_keys().numpy(), _words(jr.particle_keys()))


def test_particle_keys_all_distinct():
    # Siblings, steps and streams give disjoint keys (tests/test_rng.py).
    k = trng.key(0)
    keys = [trng.particle_keys(k, tag, t, 4, device="cpu")
            for tag in (trng.PROPAGATE, trng.RESAMPLE, trng.ANCESTOR, trng.INIT) for t in range(3)]
    flat = torch.cat(keys).numpy()
    assert np.unique(flat, axis=0).shape[0] == flat.shape[0]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_randcat_equal(seed):
    jk = jax.random.key(seed)
    w = np.random.default_rng(seed).random(50).astype(np.float32)
    w /= w.sum()
    want = int(jresampling.randcat(jk, jnp.asarray(w)))
    got = apt.randcat(_port_key(jk), torch.as_tensor(w))
    assert got.dtype == torch.int32 and got.dim() == 0 and int(got) == want
