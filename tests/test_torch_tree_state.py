"""Tree-shaped particle states: the engine, the moves and the sharded sweep.

* A sweep whose state is a dict of float32, int32 and int64 leaves equals the
  JAX package's ``aps.sweep`` on the same pytree kernel until the first ±1
  boundary flip (the JAX CPU path gathers every leaf; the port moves the
  32-bit leaves as words through B4 over leaves and gathers the int64 one).
* The plain version of B4 over leaves equals the per-leaf B2 + B3 plain
  versions and the Pallas ``_resample_move_cols`` in interpret mode, with 1,
  2 and 9 leaves; the tree form of every move version gives the same tree.
* A kernel whose components are sampled particle by particle (per-particle
  keys), and the GP-SSM's ``(x, history)`` state, sweep on the 8-shard CPU
  mesh as on one device, as ``tests/test_sharded.py`` holds for JAX.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import advancedps_tpu as aps  # noqa: E402
from advancedps_tpu.engine import SweepKernel as JSweepKernel  # noqa: E402
from advancedps_tpu.engine import inject_ref as jinject_ref  # noqa: E402
from advancedps_tpu.ops import pallas_resample as pr  # noqa: E402
from advancedps_tpu.utils.trees import pytree_dataclass  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch.ops import resample as ops  # noqa: E402
from advancedps_tpu_torch.parallel import particle_mesh, sharded_sweep  # noqa: E402

cpu_sweep = functools.partial(apt.sweep, device="cpu")
cpu_sample = functools.partial(apt.sample, device="cpu")
A, Q, R = 0.9, 0.5, 0.7


def _port_key(jkey):
    return apt.key_from_words(np.asarray(jax.random.key_data(jkey)))


# --- one kernel, two packages: a dict state with integer leaves ---------------


@pytree_dataclass
class _JTreeKernel(JSweepKernel):
    ys: jax.Array

    @property
    def num_steps(self):
        return self.ys.shape[0]

    def _score(self, t, x):
        return -0.5 * ((self.ys[t] - x) / R) ** 2

    def init(self, rng, ref0, ref_mask):
        x = rng.normal(0)
        state = {"x": x, "v": jnp.stack([x, -2.0 * x], -1),
                 "n": (x > 0).astype(jnp.int32), "id": rng.gids.astype(jnp.int32)}
        state = jinject_ref(ref_mask, ref0, state)
        return state, self._score(0, state["x"])

    def step(self, t, rng, state, ref_t, ref_mask):
        x = A * state["x"] + Q * rng.normal(0)
        new = {"x": x, "v": 0.5 * state["v"] + x[:, None],
               "n": state["n"] + (x > 0).astype(jnp.int32), "id": state["id"] + 1000}
        new = jinject_ref(ref_mask, ref_t, new)
        return new, self._score(t, new["x"])

    def snapshot(self, state):
        return state


class _TreeKernel(apt.SweepKernel):
    """The same kernel; the id leaf is int64 here (JAX's 64-bit types are off)."""

    def __init__(self, ys):
        self.ys = torch.as_tensor(ys)

    @property
    def num_steps(self):
        return self.ys.shape[0]

    def _score(self, t, x):
        return -0.5 * ((self.ys[t] - x) / R) ** 2

    def init(self, rng, ref0, ref_mask):
        x = rng.normal(0)
        state = {"x": x, "v": torch.stack([x, -2.0 * x], -1),
                 "n": (x > 0).to(torch.int32), "id": rng.gids.to(torch.int64)}
        state = apt.inject_ref(ref_mask, ref0, state)
        return state, self._score(0, state["x"])

    def step(self, t, rng, state, ref_t, ref_mask):
        x = A * state["x"] + Q * rng.normal(0)
        new = {"x": x, "v": 0.5 * state["v"] + x[:, None],
               "n": state["n"] + (x > 0).to(torch.int32), "id": state["id"] + 1000}
        new = apt.inject_ref(ref_mask, ref_t, new)
        return new, self._score(t, new["x"])

    def snapshot(self, state):
        return state


def _tree_ys(T=15):
    _, ys = aps.simulate(jax.random.key(8), aps.models.stationary_lgssm(A, Q, R), T)
    return np.array(ys)


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_state_sweep_matches_jax(seed):
    ys = _tree_ys()
    T, n = ys.shape[0], 1024
    key = jax.random.key(seed)
    jres = aps.sweep(key, _JTreeKernel(jnp.asarray(ys)), n, aps.SMC(n, threshold=0.7).resampler)
    tres = cpu_sweep(_port_key(key), _TreeKernel(ys), n, apt.SMC(n, threshold=0.7).resampler)
    j_anc, t_anc = np.asarray(jres.ancestors), tres.ancestors.numpy()
    flips = (j_anc != t_anc).sum(axis=1)
    first = int(np.argmax(flips > 0)) if flips.any() else T
    assert first > 1 and np.asarray(jres.resampled)[:first].any()
    assert set(tres.states) == {"x", "v", "n", "id"}
    assert tres.states["n"].dtype == torch.int32 and tres.states["id"].dtype == torch.int64
    for leaf in ("x", "v"):
        np.testing.assert_allclose(tres.states[leaf].numpy()[:first],
                                   np.asarray(jres.states[leaf])[:first], rtol=1e-5, atol=1e-5)
    for leaf in ("n", "id"):
        np.testing.assert_array_equal(tres.states[leaf].numpy()[:first],
                                      np.asarray(jres.states[leaf])[:first])
    # The integer leaves moved exactly: each slot's id is its lineage's.
    lin = apt.lineages(tres.ancestors).numpy()
    ids = tres.states["id"].numpy()
    assert (ids[0][lin[0]] == np.arange(n)[lin[0]]).all()
    assert abs(float(tres.log_evidence) - float(jres.log_evidence)) < 0.2


def test_tree_state_pg_and_reconstruct():
    ys = torch.as_tensor(_tree_ys(10))
    kernel = _TreeKernel(ys)
    chain = cpu_sample(apt.rng.key(3), kernel, apt.PG(32), 3)
    assert set(chain.trajectory) == {"x", "v", "n", "id"}
    assert chain.trajectory["v"].shape == (3, 10, 2) and chain.trajectory["id"].dtype == torch.int64
    # The retained trajectory is one lineage: its ids follow id ← id + 1000.
    ids = chain.trajectory["id"][-1]
    assert torch.equal(ids[1:], ids[:-1] + 1000)
    replay = cpu_sample(apt.rng.key(3), kernel, apt.PG(32), 3, trajectory_storage="replay")
    for leaf in ("n", "id"):
        assert torch.equal(replay.trajectory[leaf], chain.trajectory[leaf])
    np.testing.assert_allclose(replay.trajectory["x"].numpy(), chain.trajectory["x"].numpy(),
                               atol=1e-5)


# --- B4 over leaves: plain version, per-leaf plain versions, Pallas ----------


def _extents(m, n, seed):
    w = np.random.default_rng(seed).random(m) ** 4
    f = np.clip(np.ceil(np.cumsum(w) / w.sum() * n), 0, n).astype(np.int32)
    f = np.maximum.accumulate(f)
    f[-1] = n
    return f


def _leaves(m, count, seed):
    rng = np.random.default_rng(seed)
    shapes = [(m,), (m, 2), (m, 5), (m,)]
    out = []
    for i in range(count):
        shape = shapes[i % len(shapes)]
        if i % len(shapes) == 3:
            out.append(torch.as_tensor(rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int64)
                                       .astype(np.int32)))
        else:
            out.append(torch.as_tensor(rng.standard_normal(shape).astype(np.float32)))
    return out


def _cols(leaves):
    """The float32 leaves as the Pallas kernel's columns."""
    cols = []
    for v in leaves:
        if v.dtype == torch.float32:
            flat = v.reshape(v.shape[0], -1).numpy()
            cols.extend(jnp.asarray(flat[:, c]) for c in range(flat.shape[1]))
    return cols


@pytest.mark.parametrize("count", [1, 2, 9])
@pytest.mark.parametrize("guarded", [False, True])
def test_decode_move_leaves_matches_b2_b3_and_pallas(count, guarded):
    m = 3000
    n = m - 1 if guarded else m
    f = _extents(m, n, count)
    leaves = _leaves(m, count, count)
    for start, n_out in [(0, m), (700, 1000)]:
        anc, moved = ops.decode_move_leaves(torch.as_tensor(f), leaves, n_out, guard=n,
                                            start=start)
        raw = ops.decode_ancestors(torch.as_tensor(f), n_out, guard=n, start=start)
        assert torch.equal(anc, torch.clamp(raw, max=m - 1))
        for v, mv in zip(leaves, moved):
            want = ops.move_rows(raw, v)
            assert mv.dtype == v.dtype and torch.equal(mv, want[1])
            assert torch.equal(mv, ops.decode_move(torch.as_tensor(f), v, n_out, guard=n,
                                                   start=start)[1])
        kw = {} if start == 0 else {"start": start, "n_out": n_out}
        anc_j, ys_j = pr._resample_move_cols(jnp.asarray(f), tuple(_cols(leaves)), m,
                                             interpret=True, guard=n, **kw)
        np.testing.assert_array_equal(anc.numpy(), np.minimum(np.asarray(anc_j), m - 1))
        got = _cols([mv for mv in moved])
        assert len(got) == len(ys_j)
        for g, w in zip(got, ys_j):
            np.testing.assert_array_equal(np.asarray(g).view(np.int32), np.asarray(w).view(np.int32))


@pytest.mark.parametrize("version", [1, 6, 0])
def test_tree_moves_agree_across_versions(version):
    m = 2048
    f = torch.as_tensor(_extents(m, m - 1, 5))
    state = {"a": _leaves(m, 3, 6), "b": (torch.arange(m, dtype=torch.int64),
                                          torch.rand(m, 3, 2) > 0.5)}
    anc, moved = ops.resample_move_f(f, state, m, version=version, guard_n=m - 1)
    anc_1, moved_1 = ops.resample_move_f(f, state, m, version=1, guard_n=m - 1)
    assert torch.equal(anc, anc_1)
    # The past-the-population slot m − 1 differs by version (0 or row m − 1);
    # every drawn slot is equal, and every leaf is its rows at the ancestors.
    for got, want, v in zip(apt._tree.tree_flatten(moved)[0], apt._tree.tree_flatten(moved_1)[0],
                            apt._tree.tree_flatten(state)[0]):
        assert got.dtype == v.dtype and got.shape == v.shape
        assert torch.equal(got[:m - 1], want[:m - 1])
        assert torch.equal(got[:m - 1], v[anc[:m - 1].long()])
    # A one-tensor state takes the one-tensor path: the same result as before.
    x = state["a"][0]
    assert torch.equal(ops.resample_move_f(f, x, m, version=version, guard_n=m - 1)[1][:m - 1],
                       x[anc[:m - 1].long()])


def test_tree_window_moves_as_the_whole():
    m, K = 4096, 4
    L = m // K
    f = torch.as_tensor(_extents(m, m, 7))
    state = (torch.randn(m), torch.randn(m, 3), torch.arange(m, dtype=torch.int32))
    _, whole = ops.resample_move_f(f, state, m)
    for k in range(K):
        for ver in (1, 6):
            _, win = ops.resample_move_window_fext(f, state, m, k * L, L, version=ver)
            for a, b in zip(win, whole):
                assert torch.equal(a, b[k * L:(k + 1) * L])


# --- the sharded sweep of per-particle and tree-state models ------------------


class _Prior(apt.StatePrior):
    def distribution(self):
        return apt.Normal(0.0, 0.678)


class _Dyn(apt.LatentDynamics):
    def distribution(self, step, state):
        return apt.Normal(0.9 * state, 0.32)


class _Obs(apt.ObservationProcess):
    def distribution(self, step, state):
        return apt.Normal(state, 0.5)


@pytest.fixture(scope="module")
def mesh():
    return particle_mesh(8, "cpu")


def _ys_lgssm(T=12):
    _, ys = aps.simulate(jax.random.key(0), aps.models.stationary_lgssm(0.9, 0.32, 0.5), T)
    return np.array(ys)


# (The forced "neighbor" exchange is wrong by design where owners leave the
# neighbour window, as they do at 8 particles a shard: "auto" falls back.)
@pytest.mark.parametrize("exchange", ["allgather", "auto"])
def test_non_vectorized_kernel_sharded_matches_single_device(mesh, exchange):
    # tests/test_sharded.py's _Prior/_Dyn/_Obs: every draw per particle key,
    # keyed by the global id, so the shards draw what one device draws.
    model = apt.StateSpaceModel(_Prior(), _Dyn(), _Obs())
    kernel = apt.SSMKernel(apt.TracedSSM(model, _ys_lgssm()))
    gated = apt.ResampleWithESSThreshold()
    single = cpu_sweep(apt.rng.key(42), kernel, 64, gated)
    sharded = sharded_sweep(apt.rng.key(42), kernel, 64, gated, mesh, exchange=exchange)
    agreement = float((single.ancestors == sharded.ancestors).double().mean())
    assert agreement > 0.99
    assert torch.equal(single.resampled, sharded.resampled)
    assert abs(float(single.log_evidence) - float(sharded.log_evidence)) < 0.05
    np.testing.assert_allclose(single.ess.numpy(), sharded.ess.numpy(), rtol=1e-4)
    if agreement == 1.0:
        np.testing.assert_allclose(single.states.numpy(), sharded.states.numpy(), atol=1e-6)


def test_non_vectorized_kernel_matches_jax():
    from advancedps_tpu.distributions import Normal as JNormal

    @pytree_dataclass
    class JPrior(aps.StatePrior):
        def distribution(self):
            return JNormal(0.0, 0.678)

    @pytree_dataclass
    class JDyn(aps.LatentDynamics):
        def distribution(self, step, state):
            return JNormal(0.9 * state, 0.32)

    @pytree_dataclass
    class JObs(aps.ObservationProcess):
        def distribution(self, step, state):
            return JNormal(state, 0.5)

    ys = _ys_lgssm()
    jkernel = aps.SSMKernel(ssm=aps.TracedSSM(aps.StateSpaceModel(JPrior(), JDyn(), JObs()),
                                              jnp.asarray(ys)))
    tkernel = apt.SSMKernel(apt.TracedSSM(apt.StateSpaceModel(_Prior(), _Dyn(), _Obs()), ys))
    key = jax.random.key(42)
    jres = aps.sweep(key, jkernel, 256, aps.SMC(256).resampler)
    tres = cpu_sweep(_port_key(key), tkernel, 256, apt.SMC(256).resampler)
    flips = (np.asarray(jres.ancestors) != tres.ancestors.numpy()).sum(axis=1)
    first = int(np.argmax(flips > 0)) if flips.any() else ys.shape[0]
    assert first > 1
    np.testing.assert_allclose(tres.states.numpy()[:first], np.asarray(jres.states)[:first],
                               rtol=1e-5, atol=1e-5)


def test_nonmarkov_tree_state_sharded_matches_single_device(mesh):
    model = apt.models.gp_ssm(num_steps=8, lengthscale=1.5, variance=0.5)
    _, ys = apt.simulate(apt.rng.key(1), model, 8)
    kernel = apt.SSMKernel(apt.TracedSSM(model, ys))
    gated = apt.ResampleWithESSThreshold(apt.resample_systematic, 0.8)
    single = cpu_sweep(apt.rng.key(5), kernel, 64, gated)
    for exchange in ("allgather", "auto"):
        sharded = sharded_sweep(apt.rng.key(5), kernel, 64, gated, mesh, exchange=exchange)
        assert isinstance(sharded.final_state, tuple) and sharded.final_state[1].shape == (64, 8)
        agreement = float((single.ancestors == sharded.ancestors).double().mean())
        assert agreement > 0.99
        assert abs(float(single.log_evidence) - float(sharded.log_evidence)) < 0.05
    assert single.resampled.any()
    # A conditional sharded sweep with the tree state: the reference slot.
    ref = single.states[:, 3]
    pg = sharded_sweep(apt.rng.key(6), kernel, 64, gated, mesh, ref=ref,
                       ancestor_sampling=True)
    assert torch.equal(pg.states[:, -1], ref)
