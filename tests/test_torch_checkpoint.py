"""Chain checkpoints of the port (``advancedps_tpu_torch.utils.checkpoint``).

Mirrors ``tests/test_chains_checkpoint.py::test_checkpoint_roundtrip_and_deterministic_resume``:
a chain checkpointed after some iterations and resumed is bitwise the
uninterrupted chain.  Also: a ``.npz`` checkpoint written by the JAX
package's ``save_chain`` restores to the same trajectory bits and key words
and the port resumes from it; a tree-shaped trajectory round-trips leaf by
leaf in its own dtypes; the non-Markov GP-SSM's chain resumes bitwise.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import advancedps_tpu as aps  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu.pg import PGState as JPGState  # noqa: E402
from advancedps_tpu.utils import save_chain as jax_save_chain  # noqa: E402
from advancedps_tpu_torch.utils import (  # noqa: E402
    ChainCheckpoint,
    restore_chain,
    resume_chain,
    save_chain,
)

cpu_step_pg = functools.partial(apt.step_pg, device="cpu")
cpu_sample = functools.partial(apt.sample, device="cpu")


def _traced(T=6):
    model = aps.models.stationary_lgssm(a=0.9, q=0.32, r=1.0)
    _, ys = aps.simulate(jax.random.key(0), model, T)
    return apt.convert.traced_ssm_from_numpy(
        dict(mu=0.0, sigma0=(0.32 ** 2 / 0.19) ** 0.5, a=0.9, b=0.0, q=0.32, h=1.0, r=1.0),
        np.array(ys), device="cpu")


@pytest.mark.parametrize("sampler_cls", [apt.PG, apt.PGAS])
@pytest.mark.parametrize("storage", ["dense", "replay"])
def test_checkpoint_roundtrip_and_deterministic_resume(tmp_path, sampler_cls, storage):
    traced = _traced()
    sampler = sampler_cls(8)
    key = apt.rng.key(3)
    # Uninterrupted run of 6 iterations, iteration i from fold_in(key, i).
    states, samples, st = [], [], None
    for i in range(6):
        smp, st = cpu_step_pg(apt.rng.fold_in(key, i), traced, sampler, st, storage)
        samples.append(smp)
        states.append(st)
    # Checkpoint after iteration 3, resume 3 more.
    path = str(tmp_path / "chain.pt")
    save_chain(path, states[2], key, iteration=3)
    ck = restore_chain(path, device="cpu")
    assert isinstance(ck, ChainCheckpoint)
    assert ck.iteration == 3 and ck.key == key
    assert torch.equal(ck.trajectory, states[2].trajectory)
    resumed, st_r, it = resume_chain(path, traced, sampler, 3, device="cpu",
                                     trajectory_storage=storage)
    assert it == 6
    want = torch.stack([samples[i].trajectory for i in (3, 4, 5)])
    assert torch.equal(resumed.trajectory, want)
    assert torch.equal(resumed.log_evidence, torch.stack([samples[i].log_evidence
                                                          for i in (3, 4, 5)]))
    assert torch.equal(st_r.trajectory, states[5].trajectory)
    # ... and the driver's chain of the same key.
    chain = cpu_sample(key, traced, sampler, 6, trajectory_storage=storage)
    assert torch.equal(chain.trajectory[3:], resumed.trajectory)


def test_jax_npz_checkpoint_restores_bit_for_bit(tmp_path):
    model = aps.models.stationary_lgssm(a=0.9, q=0.32, r=1.0)
    _, ys = aps.simulate(jax.random.key(0), model, 6)
    jchain = aps.sample(jax.random.key(4), aps.TracedSSM(model, ys), aps.PGAS(8), 3)
    traj = jchain.trajectory[-1]
    key = jax.random.fold_in(jax.random.key(7), 2)
    path = str(tmp_path / "jax_chain.npz")
    jax_save_chain(path, JPGState(trajectory=traj), key, 3)
    ck = restore_chain(path, device="cpu")
    assert ck.iteration == 3
    assert ck.key == apt.key_from_words(np.asarray(jax.random.key_data(key)))
    want = np.asarray(traj)
    assert ck.trajectory.dtype == torch.float32 and ck.trajectory.shape == want.shape
    np.testing.assert_array_equal(ck.trajectory.numpy().view(np.int32), want.view(np.int32))
    # The port carries the JAX chain on: two iterations from its state.
    resumed, st, it = resume_chain(path, _traced(), apt.PGAS(8), 2, device="cpu")
    assert it == 5 and resumed.trajectory.shape == (2, 6)
    assert bool(torch.isfinite(resumed.log_evidence).all())


def test_tree_trajectory_round_trips(tmp_path):
    T = 7
    g = torch.Generator().manual_seed(0)
    traj = {"x": torch.randn(T, generator=g), "v": torch.randn(T, 2, generator=g),
            "n": torch.randint(0, 9, (T,), generator=g, dtype=torch.int32),
            "pair": (torch.randn(T, 3, generator=g),
                     torch.randint(0, 1 << 40, (T,), generator=g, dtype=torch.int64))}
    path = str(tmp_path / "tree.pt")
    save_chain(path, apt.PGState(traj), apt.rng.key(11), 5)
    ck = restore_chain(path, device="cpu")
    assert ck.iteration == 5 and ck.key == apt.rng.key(11)
    assert set(ck.trajectory) == set(traj) and isinstance(ck.trajectory["pair"], tuple)
    for got, want in ((ck.trajectory["x"], traj["x"]), (ck.trajectory["v"], traj["v"]),
                      (ck.trajectory["n"], traj["n"]),
                      (ck.trajectory["pair"][0], traj["pair"][0]),
                      (ck.trajectory["pair"][1], traj["pair"][1])):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_nonmarkov_chain_resumes_bitwise(tmp_path):
    model = apt.model_from_numpy("gp_ssm", {"num_steps": 6, "lengthscale": 1.5,
                                            "variance": 0.5}, device="cpu")
    _, ys = apt.simulate(apt.rng.key(1), model, 6)
    traced = apt.TracedSSM(model, ys)
    key = apt.rng.key(2)
    chain = cpu_sample(key, traced, apt.PGAS(8), 4)
    path = str(tmp_path / "gp.pt")
    save_chain(path, apt.PGState(chain.trajectory[1]), key, 2)
    resumed, _, it = resume_chain(path, traced, apt.PGAS(8), 2, device="cpu")
    assert it == 4
    assert torch.equal(resumed.trajectory, chain.trajectory[2:])
    assert torch.equal(resumed.log_evidence, chain.log_evidence[2:])


def test_restore_defaults_to_the_gpu(tmp_path):
    path = str(tmp_path / "c.pt")
    save_chain(path, apt.PGState(torch.zeros(3)), apt.rng.key(0), 1)
    if torch.cuda.is_available():
        assert restore_chain(path).trajectory.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            restore_chain(path)
