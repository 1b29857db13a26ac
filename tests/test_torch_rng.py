"""The PyTorch port's RNG against the JAX package's, bit for bit.

Inputs come from numpy seeds and go to both packages as numpy arrays.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from advancedps_tpu import rng as jrng  # noqa: E402
from advancedps_tpu_torch import rng as trng  # noqa: E402
from advancedps_tpu_torch.convert import key_from_words  # noqa: E402

SEEDS = [0, 1, 7, 12345, 2**31 - 1]


def _port_key(jkey):
    return key_from_words(np.asarray(jax.random.key_data(jkey)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_words_match_jax(seed):
    assert trng.key(seed) == _port_key(jax.random.key(seed))


@pytest.mark.parametrize("seed", [3, 99])
def test_threefry2x32_bitwise(seed):
    rng = np.random.default_rng(seed)
    k0, k1 = (int(w) for w in rng.integers(0, 2**32, size=2, dtype=np.uint64))
    c0, c1 = (rng.integers(0, 2**32, size=4099, dtype=np.uint64) for _ in range(2))
    j0, j1 = jrng.threefry2x32(
        jnp.uint32(k0), jnp.uint32(k1),
        jnp.asarray(c0.astype(np.uint32)), jnp.asarray(c1.astype(np.uint32)),
    )
    t0, t1 = trng.threefry2x32(
        k0, k1, torch.as_tensor(c0.astype(np.int64)), torch.as_tensor(c1.astype(np.int64))
    )
    np.testing.assert_array_equal(np.asarray(j0).astype(np.int64), t0.numpy())
    np.testing.assert_array_equal(np.asarray(j1).astype(np.int64), t1.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_step_key_bitwise(seed):
    jk, tk = jax.random.key(seed), trng.key(seed)
    for d in (0, 1, 5, 2**31 + 3, 2**32 - 1):
        assert trng.fold_in(tk, d) == _port_key(jax.random.fold_in(jk, d))
    for tag in (trng.PROPAGATE, trng.RESAMPLE, trng.INIT):
        for t in (0, 1, 2, 99, 4097):
            assert trng.step_key(tk, tag, t) == _port_key(jrng.step_key(jk, tag, t))


@pytest.mark.parametrize("seed", SEEDS)
def test_scalar_uniform_bitwise(seed):
    # The systematic offset u of every resampling step of a 200-step sweep.
    jk, tk = jax.random.key(seed), trng.key(seed)
    for t in range(1, 200):
        want = np.float32(jax.random.uniform(jrng.step_key(jk, jrng.RESAMPLE, t)))
        got = trng.uniform(trng.step_key(tk, trng.RESAMPLE, t))
        assert np.float32(got) == want and float(np.float32(got)) == got


@pytest.mark.parametrize(
    "start,count", [(0, 4096), (1, 1000), (4097, 333), (2**31 - 5000, 4999)]
)
@pytest.mark.parametrize("draw", [0, 3])
def test_pos_uniform_bitwise(start, count, draw):
    # Odd starts and odd lengths exercise both words of the paired layout.
    gids = np.arange(start, start + count, dtype=np.int64)
    jk = jrng.step_key(jax.random.key(11), jrng.PROPAGATE, 5)
    want = np.asarray(jrng.pos_uniform(jk, jnp.asarray(gids.astype(np.int32)), draw))
    got = trng.pos_uniform(_port_key(jk), torch.as_tensor(gids), draw).numpy()
    np.testing.assert_array_equal(got, want)
    u0, u1 = jrng.pos_uniform_pair(jk, jnp.asarray(gids.astype(np.int32)), draw)
    t0, t1 = trng.pos_uniform_pair(_port_key(jk), torch.as_tensor(gids), draw)
    np.testing.assert_array_equal(t0.numpy(), np.asarray(u0))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(u1))


def _assert_ulps(got, want, max_ulps=4, atol=1e-6):
    """log1p/cos/sin in Box–Muller are not bitwise equal across backends:
    hold each normal to 4 float32 ulp of the JAX value, or 1e-6 absolute
    near zero where ulps shrink."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    ok = (ulps <= max_ulps) | (np.abs(got - want) <= atol)
    assert ok.all(), (ulps.max(), np.abs(got - want).max())


@pytest.mark.parametrize("start,count", [(0, 4096), (1, 999), (123457, 2048)])
def test_pos_normal_within_ulps(start, count):
    gids = np.arange(start, start + count, dtype=np.int64)
    jk = jrng.step_key(jax.random.key(5), jrng.INIT, 0)
    want = jrng.pos_normal(jk, jnp.asarray(gids.astype(np.int32)))
    got = trng.pos_normal(_port_key(jk), torch.as_tensor(gids))
    _assert_ulps(got.numpy(), want)
    jz0, jz1 = jrng.pos_normal_pair(jk, jnp.asarray(gids.astype(np.int32)), 2)
    tz0, tz1 = trng.pos_normal_pair(_port_key(jk), torch.as_tensor(gids), 2)
    _assert_ulps(tz0.numpy(), jz0)
    _assert_ulps(tz1.numpy(), jz1)


def test_step_rng_matches_jax():
    gids = np.arange(3000)
    jk = jrng.step_key(jax.random.key(2), jrng.PROPAGATE, 7)
    j = jrng.StepRng(key=jk, gids=jnp.asarray(gids))
    t = trng.StepRng(_port_key(jk), torch.as_tensor(gids))
    assert t.n == 3000
    np.testing.assert_array_equal(t.uniform(1).numpy(), np.asarray(j.uniform(1)))
    _assert_ulps(t.normal().numpy(), j.normal())


def test_key_rejects_bad_words():
    with pytest.raises(ValueError):
        trng.Key(0, 2**32)
    with pytest.raises(ValueError):
        trng.key(-1)
    with pytest.raises(ValueError):
        key_from_words([1, 2, 3])


def test_port_imports_no_jax():
    code = ("import advancedps_tpu_torch, advancedps_tpu_torch.bench, "
            "advancedps_tpu_torch.profiling, sys; assert 'jax' not in sys.modules")
    repo = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=repo)
