"""The port's multi-device layer on an 8-shard CPU mesh: each test of
``tests/test_sharded.py`` against its counterpart, the collectives'
footprint read from the mesh's counters, the engine under each move version,
and the port's sharded sweep against the JAX package's.

Every draw is keyed by the global particle id, and the sharded sweep's
float32 weight sums differ from the single-device sweep's only by the order of
summation, so at these sizes the two agree bitwise or up to a rare ±1 flip at
a stratum boundary; the contract held is the JAX package's (ancestors > 0.99,
logZ to 0.05).
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import advancedps_tpu as aps  # noqa: E402
from advancedps_tpu.parallel import particle_mesh as jparticle_mesh  # noqa: E402
from advancedps_tpu.parallel import sharded_sweep as jsharded_sweep  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch.ops import resample as ops  # noqa: E402
from advancedps_tpu_torch.parallel import (  # noqa: E402
    chain_particle_mesh,
    particle_mesh,
    sample_chains,
    shard_along,
    sharded_chains_pg,
    sharded_sample_pg,
    sharded_sample_smc,
    sharded_step_pg,
    sharded_sweep,
    smc_ensemble,
)
from advancedps_tpu_torch.parallel import mesh as pmesh  # noqa: E402

# The port runs on the GPU unless the caller asks for the CPU: every call of an
# entry point in this file names device="cpu", through these partials.
cpu_sweep = functools.partial(apt.sweep, device="cpu")
cpu_sample = functools.partial(apt.sample, device="cpu")
cpu_sample_smc = functools.partial(apt.sample_smc, device="cpu")
cpu_traced_ssm = functools.partial(apt.traced_ssm_from_numpy, device="cpu")
cpu_sample_chains = functools.partial(sample_chains, device="cpu")
cpu_smc_ensemble = functools.partial(smc_ensemble, device="cpu")

N = 64
T = 12
A, Q = 0.9, 0.32
SCHEMES = [apt.resample_systematic, apt.resample_stratified, apt.resample_multinomial,
           apt.resample_residual]


def _port_key(jkey):
    return apt.key_from_words(np.asarray(jax.random.key_data(jkey)))


def _ys(r, steps=T, seed=0):
    _, ys = aps.simulate(jax.random.key(seed), aps.models.stationary_lgssm(A, Q, r), steps)
    return np.array(ys)


def _kernel(ys, r):
    sigma0 = math.sqrt(Q * Q / (1 - A * A))
    params = dict(mu=0.0, sigma0=sigma0, a=A, b=0.0, q=Q, h=1.0, r=r)
    return apt.SSMKernel(cpu_traced_ssm(params, ys))


@pytest.fixture(scope="module")
def setup():
    return _kernel(_ys(0.5), 0.5)


@pytest.fixture(scope="module")
def mesh():
    return particle_mesh(8, "cpu")


def _gated(resampler=apt.resample_systematic, threshold=0.5):
    return apt.ResampleWithESSThreshold(resampler, threshold)


def _assert_equivalent(single, sharded):
    agreement = (single.ancestors == sharded.ancestors).double().mean().item()
    assert agreement > 0.99, f"ancestor agreement {agreement}"
    assert torch.equal(single.resampled, sharded.resampled)
    np.testing.assert_allclose(float(single.log_evidence), float(sharded.log_evidence), atol=0.05)
    np.testing.assert_allclose(single.ess.numpy(), sharded.ess.numpy(), rtol=1e-4)


def _assert_identical(a, b):
    assert torch.equal(a.ancestors, b.ancestors)
    assert torch.equal(a.states, b.states)
    assert torch.equal(a.log_evidence, b.log_evidence)


@pytest.mark.parametrize("resampler", SCHEMES)
def test_sharded_matches_single_chip(setup, mesh, resampler):
    key = apt.rng.key(42)
    single = cpu_sweep(key, setup, N, _gated(resampler))
    _assert_equivalent(single, sharded_sweep(key, setup, N, _gated(resampler), mesh))


def test_vectorized_models_bit_exact(mesh):
    r = 0.5
    ys = _ys(r)
    kernel = _kernel(ys, r)
    single = cpu_sweep(apt.rng.key(2), kernel, 512, _gated())
    sharded = sharded_sweep(apt.rng.key(2), kernel, 512, _gated(), mesh)
    _assert_equivalent(single, sharded)
    assert torch.equal(single.ancestors, sharded.ancestors)
    np.testing.assert_allclose(single.states.numpy(), sharded.states.numpy(), atol=1e-5)
    kf = apt.utils.kalman_filter(ys, A, 0.0, Q, 1.0, r, 0.0, math.sqrt(Q * Q / (1 - A * A)))
    assert abs(float(single.log_evidence) - float(kf.log_likelihood)) < 0.5
    assert abs(float(sharded.log_evidence) - float(kf.log_likelihood)) < 0.5


def test_sharded_longer_horizon(mesh):
    kernel = _kernel(_ys(1.0, 50), 1.0)
    key = apt.rng.key(1)
    single = cpu_sweep(key, kernel, 512, _gated())
    sharded = sharded_sweep(key, kernel, 512, _gated(), mesh)
    np.testing.assert_allclose(float(single.log_evidence), float(sharded.log_evidence), atol=0.1)

    def final_mean(res):
        return float((torch.softmax(res.log_weights, 0) * res.states[-1]).sum())

    assert abs(final_mean(single) - final_mean(sharded)) < 0.05


def test_sharded_path_is_deterministic(setup, mesh):
    a = sharded_sweep(apt.rng.key(5), setup, N, _gated(), mesh)
    b = sharded_sweep(apt.rng.key(5), setup, N, _gated(), mesh)
    _assert_identical(a, b)
    c = sharded_sweep(apt.rng.key(6), setup, N, _gated(), mesh)
    assert not torch.equal(a.states, c.states)


def test_sharded_conditional_sweep_with_ancestor_sampling(setup, mesh):
    key = apt.rng.key(3)
    ref = torch.linspace(-0.5, 0.5, T)
    always = _gated(threshold=1.0)
    single = cpu_sweep(key, setup, N, always, ref=ref, ancestor_sampling=True)
    sharded = sharded_sweep(key, setup, N, always, mesh, ref=ref, ancestor_sampling=True)
    _assert_equivalent(single, sharded)
    # The reference slot reads the retained trajectory, on the last shard.
    assert torch.equal(sharded.states[:, -1], ref)
    anc_ref = sharded.ancestors[:, -1]
    assert ((0 <= anc_ref) & (anc_ref < N)).all()
    # PG pins the reference slot's ancestor to n − 1.
    pg = sharded_sweep(key, setup, N, always, mesh, ref=ref)
    assert (pg.ancestors[1:, -1] == N - 1).all()
    with pytest.raises(ValueError, match="reference"):
        sharded_sweep(key, setup, N, always, mesh, ancestor_sampling=True)


def test_sharded_store_states_false(setup, mesh):
    res = sharded_sweep(apt.rng.key(1), setup, N, _gated(), mesh, store_states=False)
    assert res.states is None
    single = cpu_sweep(apt.rng.key(1), setup, N, _gated(), store_states=False)
    np.testing.assert_allclose(float(single.log_evidence), float(res.log_evidence), atol=0.05)


def test_uneven_shard_rejected(setup, mesh):
    with pytest.raises(ValueError, match="divisible"):
        sharded_sweep(apt.rng.key(0), setup, 60, _gated(), mesh)
    with pytest.raises(ValueError, match="exchange"):
        sharded_sweep(apt.rng.key(0), setup, N, _gated(), mesh, exchange="ring")


class TestChainParticleMesh:
    def _setup(self):
        r = 1.0
        ys = _ys(r, 8)
        return _kernel(ys, r)

    def test_matches_vmap_chains_and_deterministic(self):
        kernel = self._setup()
        cmesh = chain_particle_mesh(2, 4, "cpu")
        sampler = apt.PGAS(16)
        key = apt.rng.key(7)
        trajs, lzs = sharded_chains_pg(key, kernel, sampler, cmesh, 4, 5)
        assert trajs.shape == (4, 5, 8) and lzs.shape == (4, 5)
        assert bool(torch.isfinite(lzs).all())
        trajs2, _ = sharded_chains_pg(key, kernel, sampler, cmesh, 4, 5)
        assert torch.equal(trajs, trajs2)
        assert not np.allclose(trajs[0], trajs[1]) and not np.allclose(trajs[1], trajs[2])
        # The single-device chains draw the same randomness.
        ref = cpu_sample_chains(key, kernel.ssm, sampler, 5, 4)
        np.testing.assert_allclose(trajs.numpy(), ref.trajectory.numpy(), atol=1e-4)

    def test_chain_counts_validated(self):
        kernel = self._setup()
        cmesh = chain_particle_mesh(2, 4, "cpu")
        assert cmesh.shape == {"c": 2, "p": 4}
        with pytest.raises(ValueError, match="n_chains"):
            sharded_chains_pg(apt.rng.key(0), kernel, apt.PG(16), cmesh, 3, 2)
        with pytest.raises(ValueError, match="n_particles"):
            sharded_chains_pg(apt.rng.key(0), kernel, apt.PG(18), cmesh, 2, 2)


class TestNeighborExchange:
    def _sweep(self, kernel, key, mesh, n=N, **kw):
        return sharded_sweep(key, kernel, n, _gated(), mesh, **kw)

    @pytest.mark.parametrize("n", [64, 512])
    def test_modes_bitwise_identical_when_predicate_holds(self, setup, mesh, n):
        key = apt.rng.key(7)
        rs = {}
        for m in ("allgather", "neighbor", "auto"):
            mesh.reset_counts()
            rs[m] = self._sweep(setup, key, mesh, n, exchange=m)
            if m == "auto":
                assert mesh.exchanges["allgather"] == 0, "the predicate must hold"
        assert int(rs["allgather"].resampled.sum()) > 0, "test must exercise the exchange"
        _assert_identical(rs["allgather"], rs["neighbor"])
        _assert_identical(rs["allgather"], rs["auto"])

    def test_matches_single_chip(self, setup, mesh):
        key = apt.rng.key(11)
        _assert_equivalent(cpu_sweep(key, setup, N, _gated()),
                           self._sweep(setup, key, mesh, exchange="auto"))

    def test_auto_falls_back_on_heavy_skew(self, mesh):
        # A misspecified observation noise makes every step nearly degenerate,
        # so owners leave the 3-shard window and the predicate must route the
        # firing to the all-gather exchange; the fallback-free "neighbor"
        # mode then diverges.
        kernel = _kernel(_ys(0.5), 0.01)
        key = apt.rng.key(3)
        mesh.reset_counts()
        auto = self._sweep(kernel, key, mesh, exchange="auto")
        assert mesh.exchanges["allgather"] > 0
        ag = self._sweep(kernel, key, mesh, exchange="allgather")
        _assert_identical(auto, ag)
        nb = self._sweep(kernel, key, mesh, exchange="neighbor")
        assert not torch.equal(nb.ancestors, ag.ancestors), \
            "skew never left the neighbour window; predicate untested"

    def test_neighbor_collective_footprint(self, setup, mesh):
        # The neighbour exchange moves the state by ppermute, and its only
        # all-gathers take one scalar per shard; the all-gather exchange is
        # the control.
        for mode in ("neighbor", "allgather"):
            mesh.reset_counts()
            self._sweep(setup, apt.rng.key(0), mesh, exchange=mode, store_states=False)
            if mode == "neighbor":
                assert mesh.calls["ppermute"] > 0
                assert mesh.largest["all_gather"] <= 1, dict(mesh.largest)
                assert mesh.largest["ppermute"] == N // 8
            else:
                assert mesh.calls["ppermute"] == 0
                assert mesh.largest["all_gather"] == N // 8

    def test_pgas_step_collective_count_budget(self, setup, mesh):
        # Always-resample PGAS with the neighbour exchange.  Per step: one
        # pmax of the weight max and one of the ancestor draw's value, one
        # psum of (Σe, Σe²), one pmin of the owner id, four ppermutes
        # (extents and state, left and right) and two one-scalar all-gathers
        # (shard sums, the reference row); the close-out adds a pmax and a
        # psum.  The JAX test holds per-step + close-out counts to a budget.
        xs, _ = aps.simulate(jax.random.key(5), aps.models.stationary_lgssm(A, Q, 1.0), T)
        mesh.reset_counts()
        sharded_sweep(apt.rng.key(0), setup, N, _gated(threshold=1.0), mesh,
                      ref=torch.as_tensor(np.array(xs)), ancestor_sampling=True,
                      exchange="neighbor", store_states=False)
        closeout = {"pmax": 1, "psum": 1}
        per_step = {k: (mesh.calls[k] - closeout.get(k, 0)) / (T - 1)
                    for k in ("ppermute", "all_gather", "psum", "pmax", "pmin")}
        assert per_step == {"ppermute": 4, "all_gather": 2, "psum": 1, "pmax": 2, "pmin": 1}
        budget = {"ppermute": 4, "all_gather": 4, "psum": 2, "pmax": 3, "pmin": 1}
        for k, b in budget.items():
            assert per_step[k] + closeout.get(k, 0) <= b, (k, per_step)
        assert mesh.largest["all_gather"] <= 1, dict(mesh.largest)
        assert mesh.exchanges == {"neighbor": T - 1}

    def test_chains_driver_rejects_neighbor_exchange(self, setup):
        with pytest.raises(ValueError, match="allgather"):
            sharded_chains_pg(apt.rng.key(0), setup, apt.PG(16), chain_particle_mesh(2, 4, "cpu"),
                              2, 2, exchange="auto")

    def test_sharded_pg_replay_matches_dense(self, setup, mesh):
        sampler = apt.PGAS(N)
        key = apt.rng.key(21)
        st_d = st_r = None
        for i in range(3):
            k = apt.rng.fold_in(key, i)
            smp_d, st_d = sharded_step_pg(k, setup, sampler, mesh, st_d)
            smp_r, st_r = sharded_step_pg(k, setup, sampler, mesh, st_r,
                                          trajectory_storage="replay")
            assert torch.equal(smp_d.log_evidence, smp_r.log_evidence)
            np.testing.assert_allclose(smp_d.trajectory.numpy(), smp_r.trajectory.numpy(),
                                       rtol=2e-5, atol=2e-5)


def test_sharded_sample_smc_matches_single_chip(mesh):
    ys = _ys(1.0)
    kernel = _kernel(ys, 1.0)
    key = apt.rng.key(4)
    single = cpu_sample_smc(key, kernel.ssm, apt.SMC(256))
    sharded = sharded_sample_smc(key, kernel, apt.SMC(256), mesh)
    close = np.isclose(single.trajectories.numpy(), sharded.trajectories.numpy(), atol=1e-5)
    assert close.mean() > 0.95
    np.testing.assert_allclose(float(single.log_evidence), float(sharded.log_evidence), atol=0.05)
    assert torch.equal(single.diagnostics["resampled"], sharded.diagnostics["resampled"])
    np.testing.assert_allclose(float(sharded.weights.sum()), 1.0, rtol=1e-5)
    again = sharded_sample_smc(key, kernel, apt.SMC(256), mesh)
    assert torch.equal(sharded.trajectories, again.trajectories)


def test_sharded_sample_pg_matches_single_device(setup, mesh):
    # Same keys, and weight sums that differ by the order of summation only:
    # at this size the sharded chain is the single-device one.
    key = apt.rng.key(8)
    for storage in ("dense", "replay"):
        single = cpu_sample(key, setup.ssm, apt.PGAS(N), 4, trajectory_storage=storage)
        sharded = sharded_sample_pg(key, setup, apt.PGAS(N), mesh, 4,
                                    trajectory_storage=storage)
        assert sharded.trajectory.shape == (4, T)
        np.testing.assert_allclose(sharded.trajectory.numpy(), single.trajectory.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(sharded.log_evidence.numpy(), single.log_evidence.numpy(),
                                   atol=1e-5)


@pytest.mark.parametrize("conditional", [False, True])
def test_engine_move_versions_bitwise_equal(setup, monkeypatch, conditional):
    # B2 + B3 (6), B4 (1) and B5 + a gather (0) decode and move the same way;
    # with a reference the slot past the drawn population differs (0 or the
    # last row) but is overwritten by the reference row.
    ref = torch.linspace(-0.5, 0.5, T) if conditional else None
    runs = {}
    for version in (6, 1, 0):
        monkeypatch.setattr(ops, "MOVE_VERSION", version)
        runs[version] = cpu_sweep(apt.rng.key(13), setup, 512, _gated(threshold=0.9), ref=ref,
                                  ancestor_sampling=conditional)
    assert bool(runs[6].resampled.any())
    _assert_identical(runs[6], runs[1])
    _assert_identical(runs[6], runs[0])


@pytest.mark.parametrize("exchange", ["allgather", "neighbor"])
def test_sharded_move_versions_bitwise_equal(setup, mesh, monkeypatch, exchange):
    # Windowed calls run B4 for versions 1 and 0.
    runs = {}
    for version in (6, 1, 0):
        monkeypatch.setattr(ops, "MOVE_VERSION", version)
        runs[version] = sharded_sweep(apt.rng.key(14), setup, 512, _gated(threshold=1.0), mesh,
                                      ref=torch.linspace(-0.5, 0.5, T), ancestor_sampling=True,
                                      exchange=exchange)
    _assert_identical(runs[6], runs[1])
    _assert_identical(runs[6], runs[0])


def test_port_sharded_sweep_matches_jax():
    # The same key words and observations through both packages' sharded
    # sweeps on 8 CPU shards (JAX: 8 virtual devices).  The port's extents are
    # B1's formula on a float64 prefix, JAX's a float32 cumsum: the two agree
    # to ulps until an ancestor flips at a stratum boundary, and the first
    # flip moves few ancestors; after it the clouds differ by Monte Carlo
    # noise (as test_torch_sweep.py holds for the single-device sweep).  The
    # neighbour exchange (the default "auto" takes it here) is compared on at
    # least two firings before the first flip.
    n, steps, r = 512, 30, 1.0
    ys = _ys(r, steps, seed=2)
    key = jax.random.key(77)
    jkernel = aps.SSMKernel(ssm=aps.TracedSSM(aps.models.stationary_lgssm(A, Q, r),
                                              jnp.asarray(ys)))
    jres = jsharded_sweep(key, jkernel, n, aps.SMC(n).resampler, jparticle_mesh(8))
    tres = sharded_sweep(_port_key(key), _kernel(ys, r), n, apt.SMC(n).resampler,
                         particle_mesh(8, "cpu"))
    j_anc, t_anc = np.asarray(jres.ancestors), tres.ancestors.numpy()
    flips = (j_anc != t_anc).sum(axis=1)
    first = int(np.argmax(flips > 0)) if flips.any() else steps
    j_rs, t_rs = np.asarray(jres.resampled), tres.resampled.numpy()
    assert first > 1 and (first == steps or flips[first] <= 1e-3 * n)
    assert j_rs[:first].sum() >= 2
    assert (j_rs[: first + 1] == t_rs[: first + 1]).all()
    np.testing.assert_allclose(tres.states.numpy()[:first], np.asarray(jres.states)[:first],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tres.ess.numpy()[: first + 1], np.asarray(jres.ess)[: first + 1],
                               rtol=1e-4)
    assert abs(float(tres.log_evidence) - float(jres.log_evidence)) < 0.2


def test_mesh_collectives_and_counts():
    mesh = particle_mesh(4, "cpu")
    assert mesh.shape == {"p": 4} and list(pmesh.axis_index(mesh)) == [0, 1, 2, 3]
    xs = shard_along(mesh, torch.arange(8.0))
    assert [x.tolist() for x in xs] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert [x.tolist() for x in pmesh.ppermute(mesh, xs, 1)] == [[6, 7], [0, 1], [2, 3], [4, 5]]
    assert [x.tolist() for x in pmesh.ppermute(mesh, xs, -1)] == [[2, 3], [4, 5], [6, 7], [0, 1]]
    for got in pmesh.all_gather(mesh, xs):
        assert got.tolist() == list(range(8))
    assert pmesh.all_gather(mesh, xs, tiled=False)[2].shape == (4, 2)
    assert all(s.tolist() == [12, 16] for s in pmesh.psum(mesh, xs))
    assert pmesh.pmax(mesh, xs)[1].tolist() == [6, 7]
    assert pmesh.pmin(mesh, xs)[3].tolist() == [0, 1]
    assert mesh.calls == {"ppermute": 2, "all_gather": 2, "psum": 1, "pmax": 1, "pmin": 1}
    assert mesh.elements["all_gather"] == 16 and mesh.largest["psum"] == 2
    mesh.reset_counts()
    assert not mesh.calls and not mesh.exchanges
    with pytest.raises(ValueError, match="tensors"):
        pmesh.psum(mesh, xs[:3])
    with pytest.raises(ValueError, match="divisible"):
        shard_along(mesh, torch.zeros(6))
    with pytest.raises(ValueError):
        particle_mesh(0, "cpu")
    two = particle_mesh(2, ["cpu", "cpu"])
    assert two.devices == (torch.device("cpu"),) * 2


def test_ensembles_are_independent_runs(setup):
    traced = setup.ssm
    key = apt.rng.key(9)
    ens = cpu_smc_ensemble(key, traced, apt.SMC(128), 3)
    assert ens.log_evidence.shape == (3,) and ens.trajectories.shape == (3, T, 128)
    assert ens.diagnostics["resampled"].shape == (3, T)
    one = cpu_sample_smc(apt.rng.fold_in(key, 1), traced, apt.SMC(128))
    assert torch.equal(ens.log_evidence[1], one.log_evidence)
    chains = cpu_sample_chains(key, traced, apt.PG(16), 3, 2, trajectory_storage="replay")
    assert chains.trajectory.shape == (2, 3, T) and chains.log_evidence.shape == (2, 3)
    first = cpu_sample(apt.rng.fold_in(key, 0), traced, apt.PG(16), 3,
                       trajectory_storage="replay")
    assert torch.equal(chains.trajectory[0], first.trajectory)
