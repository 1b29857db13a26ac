"""The Lévy jump path's CUDA kernel (``csrc/levy.cu``) on the card.

Needs a CUDA device (marker ``cuda``; skips where there is none) and imports no JAX, so it
runs on a GPU machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_levy_cuda.py

The kernel against the plain chain (``LevyLangevinDynamics._meancov_plain``)
on the card, ``(mu, cov)`` bitwise: at N = 1, 32, 33, 4097 and 2**21 path
keys for steps 1, 2, 100 and 199; one chain and four as ``vmap`` over
``vmap``; the unbatched shared key of ``log_prob``; a key whose first gap is
0 (an infinite, rejected jump) and a process that masks every candidate;
``mu_w = 0.7``; one launch a call under each ``vmap``; and a gated sweep of
T = 200 at N = 2**18 through ``sample_smc``, bitwise the sweep on the plain
chain, 199 launches.
"""

import pytest

torch = pytest.importorskip("torch")

import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import random as rnd  # noqa: E402
from advancedps_tpu_torch import rng as R  # noqa: E402
from advancedps_tpu_torch.ops import levy as L  # noqa: E402
from advancedps_tpu_torch.ops import threefry as tf  # noqa: E402

pytestmark = pytest.mark.cuda

vmap = torch.func.vmap


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _dynamics(**kw):
    return apt.models.levy_ssm(dt=0.5, **kw).to("cuda").dynamics


def _path_keys(n, seed=11, t=5):
    keys = R.particle_keys(R.key(seed), R.PROPAGATE, t, n, device="cuda")
    return rnd.split(keys)[..., 0, :]


def _both(dyn, keys, step, nest):
    """The kernel's and the plain chain's ``(mu, cov)`` of ``keys`` under
    ``nest`` levels of ``vmap``, and the kernel's launches."""
    kernel = lambda k: dyn._meancov(k, step)  # noqa: E731
    plain = lambda k: dyn._meancov_plain(k, step)  # noqa: E731
    for _ in range(nest):
        kernel, plain = vmap(kernel), vmap(plain)
    L.reset_launch_counts()
    got = kernel(keys)
    launches = L.meancov.launches
    return got, plain(keys), launches


def _assert_bitwise(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.equal(a, b), int((a != b).sum())


@pytest.mark.parametrize("step", [1, 2, 100, 199])
@pytest.mark.parametrize("n", [1, 32, 33, 4097, 2**21])
def test_kernel_is_the_plain_chain(n, step):
    got, want, launches = _both(_dynamics(), _path_keys(n), step, 1)
    _assert_bitwise(got, want)
    assert launches == 1


@pytest.mark.parametrize("chains", [1, 4])
def test_chains_of_particles_are_one_launch(chains):
    keys = _path_keys(chains * 4097).reshape(chains, 4097, 2)
    got, want, launches = _both(_dynamics(), keys, 100, 2)
    _assert_bitwise(got, want)
    assert launches == 1


@pytest.mark.parametrize("step", [1, 199])
def test_shared_key_of_log_prob(step):
    """``log_prob`` scores every particle with one key: an unbatched call,
    one row (PyTorch's cumsum takes CUB's scan there)."""
    dyn = _dynamics(mu_w=0.7)
    shared = R.fold_in(R.key(dyn.score_seed), step)
    L.reset_launch_counts()
    got = dyn._meancov(shared, step)
    assert L.meancov.launches == 1
    _assert_bitwise(got, dyn._meancov_plain(rnd.key_tensor(shared, "cuda"), step))
    state, x = torch.randn(64, 2, device="cuda"), torch.randn(64, 2, device="cuda")
    got = vmap(lambda s, y: dyn.log_prob(step, s, y))(state, x)
    dyn._meancov = dyn._meancov_plain
    want = vmap(lambda s, y: dyn.log_prob(step, s, y))(state, x)
    assert torch.equal(got, want)


def test_mu_w_sums_as_pytorch_does():
    """A nonzero mean: its sums over the candidates, bitwise."""
    dyn = _dynamics(mu_w=0.7)
    for n in (1, 33, 2**21):
        got, want, _ = _both(dyn, _path_keys(n, seed=12), 100, 1)
        assert bool((got[0] != 0).any())
        _assert_bitwise(got, want)


def test_zero_first_gap_is_an_infinite_rejected_jump():
    """Keys whose first arrival gap is exactly 0 (its uniform 0: 2**-23 of
    keys), found on the card, among others: finite moments, bitwise."""
    found = []
    for chunk in range(8):
        ids = torch.arange(chunk << 24, (chunk + 1) << 24, device="cuda")
        keys = rnd.split(R.fold_in_ids(R.key(13), ids))[..., 0, :]
        k_arr = rnd.split(keys, 3)[..., 0, :]
        zero = (rnd.bits(k_arr, ()) >> 9) == 0
        found.append(keys[zero])
        del keys, k_arr
        if sum(len(f) for f in found) >= 2:
            break
    zeros = torch.cat(found)
    assert len(zeros) >= 1
    dyn = _dynamics()
    keys = torch.cat([zeros, _path_keys(40)])
    first_gap = vmap(lambda k: rnd.exponential(rnd.split(k, 3)[0], (1,)))(zeros)
    assert bool((first_gap == 0).all())
    got, want, _ = _both(dyn, keys, 7, 1)
    _assert_bitwise(got, want)
    assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())


def test_every_candidate_masked():
    """A truncation above every jump: the mean 0, the covariance jitter·I."""
    model = apt.models.levy_ssm(dt=0.5, mu_w=0.7)
    model.dynamics.process.tol = 1e30
    dyn = model.to("cuda").dynamics
    got, want, _ = _both(dyn, _path_keys(33), 3, 1)
    _assert_bitwise(got, want)
    assert bool((got[0] == 0).all())
    eye = torch.eye(2, device="cuda") * torch.tensor(1e-6, dtype=torch.float32)
    assert torch.equal(got[1], eye.expand_as(got[1]))


def test_a_step_draws_no_threefry_for_the_path():
    """Under ``vmap`` over particles the path is one launch and no Threefry
    launch: the path key's split and the candidates' draws are the kernel's."""
    dyn = _dynamics()
    keys = _path_keys(4097)
    tf.reset_launch_counts()
    L.reset_launch_counts()
    vmap(lambda k: dyn._meancov(k, 9))(keys)
    assert L.meancov.launches == 1
    assert all(w.launches == 0 for w in tf.KERNEL_WRAPPERS)


def test_sweep_is_the_plain_chain_sweep():
    """``sample_smc`` of T = 200 at N = 2**18, gated at ESS ≤ N/2: bitwise
    the sweep on the plain chain, the kernel launched once a step."""
    model = apt.models.levy_ssm(dt=0.5).to("cuda")
    _, ys = apt.simulate(R.key(21), model, 200)
    traced = apt.TracedSSM(model, ys)

    def run():
        L.reset_launch_counts()
        res = apt.sample(R.key(22), traced, apt.SMC(2**18), store_states=False)
        torch.cuda.synchronize()
        return res, L.meancov.launches

    got, launches = run()
    assert launches == 199
    model.dynamics._meancov = model.dynamics._meancov_plain
    want, plain_launches = run()
    assert plain_launches == 0
    assert torch.equal(got.log_evidence, want.log_evidence)
    assert torch.equal(got.weights, want.weights)
    for key in ("ess", "resampled"):
        assert torch.equal(got.diagnostics[key], want.diagnostics[key])
    assert int(got.diagnostics["resampled"].sum()) > 0
