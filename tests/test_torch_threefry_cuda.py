"""The positional Threefry's CUDA kernels on the card.

Needs a CUDA device (marker ``cuda``; skips where there is none) and imports no JAX, so it
runs on a GPU machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_threefry_cuda.py

Each kernel of ``csrc/threefry.cu`` against its plain version on the card:
the cipher words and the uniforms bitwise, the normals within 2 ulps, for one
key and a column of chain keys, at an odd count from an odd id, past 2**32,
on int32 ids and on a strided slice; each batching rule one launch, bitwise
the loop of one-key calls; a sweep draws T positional normals, and a batch of
chains as many.
"""

import pytest

torch = pytest.importorskip("torch")

import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import random as rnd  # noqa: E402
from advancedps_tpu_torch import rng as R  # noqa: E402
from advancedps_tpu_torch.ops import threefry as tf  # noqa: E402
from advancedps_tpu_torch.parallel import smc_ensemble  # noqa: E402

pytestmark = pytest.mark.cuda

NORMAL_ULPS = 2


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _ulps(a, b):
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def _case(name):
    k = R.step_key(R.key(7), R.PROPAGATE, 3)
    if name == "chain column":
        kb = R.chain_keys(R.key(7), 4).to("cuda").column()
        return kb.k0, kb.k1, torch.arange(65_536, device="cuda")
    ids = {"odd count from an odd id": torch.arange(3, 65_540, device="cuda"),
           "past 2**32": torch.arange(2**32 - 30_000, 2**32 + 30_001, device="cuda"),
           "int32 ids": torch.arange(65_536, device="cuda", dtype=torch.int32),
           "strided slice": torch.arange(200_000, device="cuda")[7::3]}[name]
    return k.k0, k.k1, ids


@pytest.mark.parametrize("name", ["odd count from an odd id", "chain column", "past 2**32",
                                  "int32 ids", "strided slice"])
def test_each_kernel_is_its_plain_version(name):
    k0, k1, ids = _case(name)
    for pair in (False, True):
        got, want = tf.pos_uniform(k0, k1, ids, 5, pair), tf.pos_uniform_ref(k0, k1, ids, 5, pair)
        got, want = (got, want) if pair else ((got,), (want,))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got, want = tf.pos_normal(k0, k1, ids, 5, pair), tf.pos_normal_ref(k0, k1, ids, 5, pair)
        got, want = (got, want) if pair else ((got,), (want,))
        assert max(_ulps(a, b) for a, b in zip(got, want)) <= NORMAL_ULPS
    assert _ulps(tf.pos_normals(k0, k1, ids, 3, 2),
                 tf.pos_normals_ref(k0, k1, ids, 3, 2)) <= NORMAL_ULPS
    c1 = ids.to(torch.int64)
    words = tf.threefry2x32(k0, k1, 9, c1)
    assert all(torch.equal(a, b) for a, b in zip(words, tf.threefry2x32_ref(k0, k1, 9, c1)))
    assert torch.equal(tf.threefry2x32(k0, k1, 9, c1, stacked=True), torch.stack(words, -1))
    torch.cuda.synchronize()


def test_the_batching_rules_are_one_launch_and_the_loop():
    chains = R.chain_keys(R.key(9), 4).to("cuda")
    ids = torch.arange(10_001, device="cuda")
    tf.reset_launch_counts()
    got = torch.func.vmap(lambda a, b: R.pos_normal(R.KeyBatch(a, b), ids))(chains.k0, chains.k1)
    assert tf.pos_normal.launches == 1
    assert torch.equal(got, torch.stack([R.pos_normal(chains.key(c), ids) for c in range(4)]))
    keys = R.particle_keys(R.key(4), R.PROPAGATE, 3, 256)
    tf.reset_launch_counts()
    got = torch.func.vmap(lambda q: rnd.uniform(q, (6,)))(keys)
    assert tf.threefry2x32.launches == 1
    assert torch.equal(got, torch.stack([rnd.uniform(q, (6,)) for q in keys]))


def test_a_sweep_draws_t_normals_and_a_batch_as_many():
    model = apt.models.stationary_lgssm(0.9, 0.32, 1.0)
    _, ys = apt.simulate(torch.Generator().manual_seed(0), model, 20)
    traced = apt.TracedSSM(model, ys)
    tf.reset_launch_counts()
    apt.sample(R.key(1), traced, apt.SMC(65_536))
    one = {w.__name__: w.launches for w in tf.KERNEL_WRAPPERS}
    tf.reset_launch_counts()
    smc_ensemble(R.key(1), traced, apt.SMC(65_536), 4, store_states=False)
    batch = {w.__name__: w.launches for w in tf.KERNEL_WRAPPERS}
    assert one == batch == {"threefry2x32": 0, "pos_uniform": 0, "pos_normal": 20,
                            "pos_normals": 0}
