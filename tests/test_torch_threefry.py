"""The positional Threefry's kernel layer (``ops.threefry``) on the CPU.

Every draw on tensors now goes through ``advancedps_tpu_torch.ops.threefry``,
whose wrappers launch a CUDA kernel on the card and take the plain version
for CPU tensors.  Held here, through ``rng``'s dispatch as the engine calls
it:

* the cipher words and uniforms bitwise the JAX package's
  ``advancedps_tpu.rng``, the normals within ``test_torch_rng.py``'s 4 ulps /
  1e-6, for a ``Key`` and a ``KeyBatch`` column ``[C, 1]``, on odd counts and
  odd starts, ids around 2**31 and 2**32 and an offset slice of ids as a
  shard holds;
* each wrapper's batching rule under ``torch.func.vmap``: over chain words,
  over ``[N, 2]`` particle keys, over ids, and nested, bitwise the loop of
  one-key calls; only a batched operand takes the rule's ``autograd.Function``;
* the geometry the wrappers hand the kernels: the element offsets a thread
  unravels from it are each operand's broadcast elements, in at most the
  kernels' own ``kMaxDims`` dimensions;
* the wrappers' refusals;
* a CPU sweep and a CPU PGAS iteration never build or load the CUDA library.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from advancedps_tpu import rng as jrng  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import random as trandom  # noqa: E402
from advancedps_tpu_torch import rng as trng  # noqa: E402
from advancedps_tpu_torch.ops import _build  # noqa: E402
from advancedps_tpu_torch.ops import threefry as tf  # noqa: E402
from advancedps_tpu_torch.parallel import smc_ensemble  # noqa: E402

vmap = torch.func.vmap
MASK = 0xFFFFFFFF

#: A wrapper whose batching rule were missing would make vmap loop, with
#: this warning: it must not.
NO_VMAP_LOOP = pytest.mark.filterwarnings("error:There is a performance drop:UserWarning")


def _port_key(jkey):
    return apt.key_from_words(np.asarray(jax.random.key_data(jkey)))


def _assert_ulps(got, want, max_ulps=4, atol=1e-6):
    """``test_torch_rng.py``'s hold on normals: log1p, cos and sin differ
    across backends by a few ulps."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    ok = (ulps <= max_ulps) | (np.abs(got - want) <= atol)
    assert ok.all(), (ulps.max(), np.abs(got - want).max())


def _jkey():
    return jrng.step_key(jax.random.key(21), jrng.PROPAGATE, 7)


#: Id ranges (start, count): odd starts and counts, around 2**31 and 2**32.
ID_RANGES = [(0, 4099), (1, 999), (2**31 - 501, 1001), (2**32 - 600, 1200)]


def _u32(ids):
    return jnp.asarray((ids & MASK).astype(np.uint32))


def _jax_pair(fn, jk, ids, draw):
    """``fn`` (JAX's ``pos_*_pair``) at counters ``ids & MASK``."""
    a, b = fn(jk, _u32(ids), draw)
    return np.asarray(a), np.asarray(b)


def _jax_paired(fn, jk, ids, draw):
    """The paired layout from JAX's pair form at counters ``(ids >> 1) &
    MASK``: ``rng._as_counter`` of ``ids >> 1``, which JAX's uint32 ids
    cannot hold past 2**32."""
    a, b = _jax_pair(fn, jk, ids >> 1, draw)
    return np.where(ids & 1, b, a)


@pytest.mark.parametrize("start,count", ID_RANGES)
@pytest.mark.parametrize("draw", [0, 5])
def test_uniforms_are_jax_bitwise(start, count, draw):
    ids = np.arange(start, start + count, dtype=np.int64)
    jk, tk = _jkey(), _port_key(_jkey())
    got = trng.pos_uniform(tk, torch.as_tensor(ids), draw).numpy()
    np.testing.assert_array_equal(got, _jax_paired(jrng.pos_uniform_pair, jk, ids, draw))
    if start + count < 2**32:
        want = np.asarray(jrng.pos_uniform(jk, _u32(ids), draw))
        np.testing.assert_array_equal(got, want)
    u0, u1 = trng.pos_uniform_pair(tk, torch.as_tensor(ids), draw)
    w0, w1 = _jax_pair(jrng.pos_uniform_pair, jk, ids, draw)
    np.testing.assert_array_equal(u0.numpy(), w0)
    np.testing.assert_array_equal(u1.numpy(), w1)


@pytest.mark.parametrize("start,count", ID_RANGES)
def test_normals_are_jax_within_ulps(start, count):
    ids = np.arange(start, start + count, dtype=np.int64)
    jk, tk = _jkey(), _port_key(_jkey())
    got = trng.pos_normal(tk, torch.as_tensor(ids), 3).numpy()
    _assert_ulps(got, _jax_paired(jrng.pos_normal_pair, jk, ids, 3))
    z0, z1 = trng.pos_normal_pair(tk, torch.as_tensor(ids), 3)
    w0, w1 = _jax_pair(jrng.pos_normal_pair, jk, ids, 3)
    _assert_ulps(z0.numpy(), w0)
    _assert_ulps(z1.numpy(), w1)


@pytest.mark.parametrize("d", [1, 2, 5])
def test_pos_normals_are_jax_within_ulps(d):
    ids = np.arange(2**31 - 77, 2**31 + 100, dtype=np.int64)
    jk, tk = _jkey(), _port_key(_jkey())
    got = trng.pos_normals(tk, torch.as_tensor(ids), d, 4)
    assert got.shape == (ids.size, d)
    _assert_ulps(got.numpy(), np.asarray(jrng.pos_normals(jk, _u32(ids), d, 4)))


def test_cipher_words_and_key_folds_are_jax_bitwise():
    rng = np.random.default_rng(15)
    k0, k1 = (int(w) for w in rng.integers(0, 2**32, size=2, dtype=np.uint64))
    c0 = rng.integers(0, 2**32, size=(3, 1), dtype=np.uint64)
    c1 = rng.integers(0, 2**32, size=(1, 257), dtype=np.uint64)
    j0, j1 = jrng.threefry2x32(jnp.uint32(k0), jnp.uint32(k1), jnp.asarray(c0.astype(np.uint32)),
                               jnp.asarray(c1.astype(np.uint32)))
    t0, t1 = trng.threefry2x32(k0, k1, torch.as_tensor(c0.astype(np.int64)),
                               torch.as_tensor(c1.astype(np.int64)))
    assert t0.shape == (3, 257) and t0.dtype == torch.int64
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))
    # fold_in_ids: jax.random.fold_in of every id, ids past 2**32 by their low word.
    jk = jax.random.key(3)
    ids = np.array([0, 1, 7, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 5, 2**40 + 9])
    got = trng.fold_in_ids(_port_key(jk), torch.as_tensor(ids))
    want = jax.vmap(lambda i: jax.random.key_data(jax.random.fold_in(jk, i)))(
        jnp.asarray((ids & MASK).astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    got32 = trng.fold_in_ids(_port_key(jk), torch.arange(9, dtype=torch.int32))
    np.testing.assert_array_equal(got32.numpy(), trng.fold_in_ids(_port_key(jk),
                                                                  torch.arange(9)).numpy())


@pytest.mark.parametrize("c", [1, 3])
def test_a_keybatch_column_draws_jax_vmap_of_each_chain(c):
    jk = jax.random.key(8)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.arange(c))
    kb = trng.chain_keys(_port_key(jk), c).column()
    ids = np.arange(2**32 - 51, 2**32 + 50, dtype=np.int64)
    t_ids = torch.as_tensor(ids)
    np.testing.assert_array_equal(
        trng.pos_uniform(kb, t_ids, 2).numpy(),
        np.stack([_jax_paired(jrng.pos_uniform_pair, jkeys[i], ids, 2) for i in range(c)]))
    _assert_ulps(trng.pos_normal(kb, t_ids, 2).numpy(),
                 np.stack([_jax_paired(jrng.pos_normal_pair, jkeys[i], ids, 2) for i in range(c)]))
    z = trng.pos_normals(kb, t_ids, 3)
    assert z.shape == (c, ids.size, 3)
    _assert_ulps(z.numpy(), np.stack([np.asarray(jrng.pos_normals(jkeys[i], _u32(ids), 3))
                                      for i in range(c)]))
    # The systematic offsets and the folds of a batch: one cipher for all chains.
    np.testing.assert_array_equal(
        trng.uniform(trng.chain_keys(_port_key(jk), c)).numpy(),
        np.stack([np.float32(jax.random.uniform(jkeys[i])) for i in range(c)]))


def test_a_shard_slice_of_ids_draws_the_whole_populations_values():
    # A shard's ids are an offset slice (a view with a storage offset) of the
    # population's: its draws are that slice of the whole draw.
    tk = _port_key(_jkey())
    gids = torch.arange(4097)
    shard = gids[1025:3073]
    for draw_fn in (trng.pos_uniform, trng.pos_normal):
        assert torch.equal(draw_fn(tk, shard, 1), draw_fn(tk, gids, 1)[1025:3073])
    assert torch.equal(trng.pos_normals(tk, shard, 3), trng.pos_normals(tk, gids, 3)[1025:3073])
    assert torch.equal(trng.fold_in_ids(tk, shard), trng.fold_in_ids(tk, gids)[1025:3073])
    strided = gids[5::3]
    assert torch.equal(trng.pos_uniform(tk, strided), trng.pos_uniform(tk, gids)[5::3])


# ---------------------------------------------------------------------------
# Batching rules
# ---------------------------------------------------------------------------


def _chain_words(c=4):
    kb = trng.chain_keys(trng.key(77), c)
    return kb, [kb.key(i) for i in range(c)]


@NO_VMAP_LOOP
@pytest.mark.parametrize("kind", ["uniform", "normal", "uniform_pair", "normal_pair", "normals"])
def test_vmap_over_chain_words_is_the_loop(kind):
    kb, keys = _chain_words()
    gids = torch.arange(1, 1002)
    fn = {"uniform": lambda k: trng.pos_uniform(k, gids, 3),
          "normal": lambda k: trng.pos_normal(k, gids, 3),
          "uniform_pair": lambda k: torch.stack(trng.pos_uniform_pair(k, gids, 3)),
          "normal_pair": lambda k: torch.stack(trng.pos_normal_pair(k, gids, 3)),
          "normals": lambda k: trng.pos_normals(k, gids, 3, 1)}[kind]
    got = vmap(lambda a, b: fn(trng.KeyBatch(a, b)))(kb.k0, kb.k1)
    want = torch.stack([fn(k) for k in keys])
    assert got.dtype == want.dtype and torch.equal(got, want)


@NO_VMAP_LOOP
def test_vmap_over_chain_words_and_ids_is_the_loop():
    # The batched replay: each chain's words and its own slot ids.
    kb, keys = _chain_words()
    slots = torch.tensor([[3], [0], [2**32 + 1], [17]])
    got = vmap(lambda a, b, g: trng.pos_normal(trng.KeyBatch(a, b), g))(kb.k0, kb.k1, slots)
    want = torch.stack([trng.pos_normal(k, g) for k, g in zip(keys, slots)])
    assert torch.equal(got, want)
    got = vmap(lambda g: trng.pos_uniform(keys[0], g), in_dims=1)(slots.T.contiguous())
    assert torch.equal(got, torch.stack([trng.pos_uniform(keys[0], g) for g in slots]))


@NO_VMAP_LOOP
def test_vmap_over_particle_keys_is_the_loop():
    keys = trng.particle_keys(trng.key(4), trng.PROPAGATE, 3, 37, device="cpu")
    for fn in (lambda k: trandom.bits(k, (2, 5)), lambda k: trandom.split(k, 3),
               lambda k: trandom.fold_in(k, 11), lambda k: trandom.uniform(k, (7,)),
               lambda k: trandom.normal(k, (3,)), lambda k: trandom.fold_in(k, torch.tensor(9))):
        got = vmap(fn)(keys)
        want = torch.stack([fn(k) for k in keys])
        assert got.dtype == want.dtype and torch.equal(got, want)
    # The words given apart, a key's stream on columns of ids under in_dims=1.
    got = vmap(lambda k: tf.threefry2x32(k[0], k[1], 0, torch.arange(6), stacked=True))(keys)
    want = torch.stack([torch.stack(tf.threefry2x32_ref(int(k[0]), int(k[1]), 0, torch.arange(6)),
                                    -1) for k in keys])
    assert torch.equal(got, want)


@NO_VMAP_LOOP
def test_nested_vmap_over_chains_and_particles_is_the_loop():
    # A per-particle component under a batch of chains (the Lévy model's draws
    # in an ensemble): vmap over chains of vmap over particle keys.
    kb, keys = _chain_words(3)

    def draws(a, b):
        pk = trng.fold_in_ids(trng.KeyBatch(a, b), torch.arange(9))
        return vmap(lambda k: trandom.normal(k, (4,)))(pk)

    got = vmap(draws)(kb.k0, kb.k1)
    want = torch.stack([vmap(lambda k: trandom.normal(k, (4,)))(
        trng.fold_in_ids(k, torch.arange(9))) for k in keys])
    assert torch.equal(got, want)


@NO_VMAP_LOOP
def test_only_batched_operands_take_the_batching_functions(monkeypatch):
    # An unbatched call skips the autograd.Function's dispatch, under vmap
    # too (a captured key and ids); a batched operand goes through it.
    kb, keys = _chain_words(3)
    gids = torch.arange(5, 70)
    want = [trng.pos_normal(keys[0], gids), trng.pos_uniform(keys[0], gids),
            trng.pos_normals(keys[0], gids, 3), trng.fold_in_ids(keys[0], gids)]
    applied = []
    for fn in (tf._Threefry, tf._Positional, tf._Normals):
        monkeypatch.setattr(fn, "apply", functools.partial(
            lambda apply, *a: applied.append(1) or apply(*a), fn.apply))
    draws = (lambda: [trng.pos_normal(keys[0], gids), trng.pos_uniform(keys[0], gids),
                      trng.pos_normals(keys[0], gids, 3), trng.fold_in_ids(keys[0], gids)])
    got = draws()
    assert not applied and all(torch.equal(a, b) for a, b in zip(got, want))
    inner = vmap(lambda x: draws()[0] + 0 * x)(torch.zeros(2, 1))
    assert not applied and torch.equal(inner, torch.stack([want[0]] * 2))
    got = vmap(lambda a, b: trng.pos_normal(trng.KeyBatch(a, b), gids))(kb.k0, kb.k1)
    assert len(applied) == 1
    assert torch.equal(got, torch.stack([trng.pos_normal(k, gids) for k in keys]))


# ---------------------------------------------------------------------------
# The geometry the kernels unravel
# ---------------------------------------------------------------------------


def _unravel(geom, n_ops, n):
    """Each operand's element offsets for flat indices ``0..n-1``, as a
    thread of ``csrc/threefry.cu`` computes them."""
    ndim = geom[0]
    sizes = list(geom[1:1 + ndim])
    strides = [list(geom[1 + ndim + k * ndim:1 + ndim + (k + 1) * ndim]) for k in range(n_ops)]
    coords = np.unravel_index(np.arange(n), sizes)
    return [sum(np.asarray(c, np.int64) * s[d] for d, c in enumerate(coords)) for s in strides], ndim


@pytest.mark.parametrize("case", ["scalar keys", "chain column", "chain and ids batched",
                                  "moved batch dim", "strided ids", "three dims"])
def test_geometry_offsets_are_each_operands_broadcast_elements(case):
    g = torch.Generator().manual_seed(1)

    def words(*shape):
        return torch.randint(0, 2**32, shape, generator=g, dtype=torch.int64)

    k0, k1, ids, want_ndim = {
        "scalar keys": (5, 9, words(1000), 1),
        "chain column": (words(4, 1), words(4, 1), words(1000), 2),
        "chain and ids batched": (words(4, 1), words(4, 1), words(4, 1), 1),
        "moved batch dim": (words(4, 1), 7, words(6, 4).T, 2),
        "strided ids": (3, 4, words(2000)[1::2], 1),
        "three dims": (words(2, 1, 1), words(1, 3, 1), words(5), 3),
    }[case]
    operands = (k0, k1, ids)
    shape = torch.broadcast_shapes(*(o.shape for o in operands if isinstance(o, torch.Tensor)))
    n = int(np.prod(shape))
    offsets, ndim = _unravel(list(tf._geometry(shape, operands)), 3, n)
    assert ndim == want_ndim
    for o, off in zip(operands, offsets):
        if isinstance(o, torch.Tensor):
            storage = torch.as_strided(o, (o.untyped_storage().nbytes() // 8 - o.storage_offset(),),
                                       (1,)).numpy()
            np.testing.assert_array_equal(storage[off], o.expand(shape).reshape(-1).numpy())


def test_max_dims_is_the_kernels_own():
    # The wrapper refuses what the kernel's operand table cannot hold:
    # kMaxDims in the source (read back by chip_smoke.py on the card).
    src = (Path(tf.__file__).resolve().parent.parent / "csrc" / "threefry.cu").read_text()
    assert int(re.search(r"constexpr int kMaxDims = (\d+);", src).group(1)) == tf.MAX_DIMS


# ---------------------------------------------------------------------------
# Refusals, and the CPU path's independence from the CUDA library
# ---------------------------------------------------------------------------


def test_wrappers_refuse_what_the_kernels_do_not_take():
    ids = torch.arange(8)
    with pytest.raises(ValueError, match="rounds"):
        tf.threefry2x32(1, 2, 0, ids, rounds=12)
    with pytest.raises(TypeError, match="int64"):
        tf.threefry2x32(torch.tensor([1], dtype=torch.int32), 2, 0, ids)
    with pytest.raises(TypeError, match="tensor operand"):
        tf.threefry2x32(1, 2, 3, 4)
    with pytest.raises(TypeError, match="ids"):
        tf.pos_uniform(1, 2, ids.float())
    with pytest.raises(TypeError, match="draw"):
        tf.pos_normal(1, 2, ids, 1.5)
    with pytest.raises(ValueError, match="d must be"):
        tf.pos_normals(1, 2, ids, 0)
    with pytest.raises(ValueError, match="dimensions"):
        # Eight dimensions walked in reverse: none merges with its neighbour
        # (the geometry of a launch; the CPU takes the plain version).
        rev = torch.arange(256).reshape((2,) * 8).permute(*range(7, -1, -1))
        tf._geometry(rev.shape, (1, 2, rev))
    with pytest.raises(ValueError, match="different devices"):
        tf.pos_uniform(torch.tensor([1], device="meta"), 2, ids)
    # Host words keep the host cipher; a CPU tensor counts no launch.
    assert trng.threefry2x32(1, 2, 3, 4) == tf.threefry2x32_ref(1, 2, 3, 4)
    tf.reset_launch_counts()
    trng.pos_normal(trng.key(1), ids)
    assert all(w.launches == 0 for w in tf.KERNEL_WRAPPERS)


def test_cpu_paths_never_build_or_load_the_cuda_library(monkeypatch):
    def refuse():
        raise AssertionError("the CUDA library was asked for on the CPU")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    model = apt.models.stationary_lgssm(0.9, 0.32, 1.0)
    _, ys = apt.simulate(torch.Generator().manual_seed(0), model, 12)
    traced = apt.TracedSSM(model, ys)
    cpu = functools.partial(apt.sample, device="cpu")
    smc = cpu(trng.key(1), traced, apt.SMC(256, apt.ResampleWithESSThreshold(
        apt.resample_stratified)))
    assert bool(torch.isfinite(smc.log_evidence))
    chain = cpu(trng.key(2), traced, apt.PGAS(128), 2, trajectory_storage="replay")
    assert chain.trajectory.shape == (2, 12)
    ens = smc_ensemble(trng.key(3), traced, apt.SMC(128), 2, device="cpu")
    assert ens.log_evidence.shape == (2,)
