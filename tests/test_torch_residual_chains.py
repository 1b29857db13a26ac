"""The schemes' chain-batch form, residual resampling on the chain axis, the
tree move by ancestors, and ``engine.propagate_rng``.

Held here, on the CPU:

* each of the four schemes given a ``KeyBatch`` column and weights ``[C, N]``:
  row ``c`` bitwise the one-chain call with chain ``c``'s key, and against
  ``jax.vmap`` of the JAX scheme under the rule ``test_torch_schemes.py``
  holds one chain to (the same uniforms; an ancestor off by at most one, in
  at most 1e-3 of the slots, where two float32 ``cumsum``s round apart);
* a batched sweep with residual resampling draws once a firing step for all
  chains (its two prefix sums by B6 with the chain axis), moves the state by
  B3 with the chain axis, and reads no chain's key words on the host;
  residual PGAS chains with ancestor sampling are bitwise the loop of
  one-chain chains;
* ``ops.move_by_ancestors`` bitwise the indexing it replaced, on leaves of
  float32, int32, float64 and bool and one wider than a kernel takes, for
  one chain and with the chain axis;
* ``engine.propagate_rng`` against the JAX package's: the same key words and
  uniforms bitwise, normals within ``test_torch_rng.py``'s ulps; for a chain
  batch, the ``StepRng`` the batched sweep builds from its key table; and the
  sweep and the replay build their propagate streams through it.

Inputs are made from a seed with numpy; sizes are small.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import advancedps_tpu as aps  # noqa: E402
from advancedps_tpu import engine as jengine  # noqa: E402
from advancedps_tpu import resampling as jres  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import engine  # noqa: E402
from advancedps_tpu_torch import resampling as tres  # noqa: E402
from advancedps_tpu_torch import rng as R  # noqa: E402
from advancedps_tpu_torch.ops import resample as ops  # noqa: E402
from advancedps_tpu_torch.parallel import sample_chains, smc_ensemble  # noqa: E402

cpu_sample_smc = functools.partial(apt.sample_smc, device="cpu")
cpu_sample_pg = functools.partial(apt.sample_pg, device="cpu")
cpu_smc_ensemble = functools.partial(smc_ensemble, device="cpu")
cpu_sample_chains = functools.partial(sample_chains, device="cpu")
cpu_sweep = functools.partial(apt.sweep, device="cpu")

A, Q, RR = 0.9, 0.32, 1.0
SIGMA0 = math.sqrt(Q * Q / (1 - A * A))
PARAMS = dict(mu=0.0, sigma0=SIGMA0, a=A, b=0.0, q=Q, h=1.0, r=RR)
SCHEMES = ["systematic", "stratified", "multinomial", "residual"]


def _weights(c, m, seed):
    w = np.random.default_rng(seed).gamma(0.5, size=(c, m)).astype(np.float32)
    w[0, : m // 3] = 0.0  # a run of particles with no weight
    return w / w.sum(1, keepdims=True, dtype=np.float32)


def _jax_keys(seed, c):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(jnp.arange(c))


def _port_keys(jkeys) -> R.KeyBatch:
    w = np.asarray(jax.random.key_data(jkeys)).astype(np.int64)
    return R.KeyBatch(torch.as_tensor(w[:, 0]), torch.as_tensor(w[:, 1]))


def _lgssm_ys(steps, seed=0):
    _, ys = aps.simulate(jax.random.key(seed), aps.models.stationary_lgssm(A, Q, RR), steps)
    return np.array(ys)


def _lgssm():
    return apt.traced_ssm_from_numpy(PARAMS, _lgssm_ys(15), device="cpu")


# --- the schemes' chain-batch form -----------------------------------------------


@pytest.mark.parametrize("c,m,n", [(4, 1000, 1000), (3, 4096, 4095)])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_batched_scheme_rows_are_the_one_chain_draws_and_jax_vmap(scheme, c, m, n):
    w = _weights(c, m, seed=m + SCHEMES.index(scheme))
    jkeys = _jax_keys(m + 17, c)
    keys = _port_keys(jkeys)
    port = getattr(tres, f"resample_{scheme}")
    got = port(keys.column(), torch.as_tensor(w), n)
    assert got.dtype == torch.int32 and tuple(got.shape) == (c, n)
    for r in range(c):
        assert torch.equal(got[r], port(keys.key(r), torch.as_tensor(w[r]), n)), r
    jax_scheme = getattr(jres, f"resample_{scheme}")
    want = np.asarray(jax.vmap(lambda k, wr: jax_scheme(k, wr, n))(jkeys, jnp.asarray(w)))
    diff = np.abs(got.numpy().astype(np.int64) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_batched_residual_keeps_each_rows_deterministic_copies():
    # Row 0: n·w integral everywhere, every slot a deterministic copy; row 1
    # has residuals, so its tail is drawn; row 2 puts all weight on one particle.
    w = torch.tensor([[0.25, 0.5, 0.0, 0.25], [0.3, 0.3, 0.2, 0.2], [0.0, 0.0, 1.0, 0.0]])
    keys = R.chain_keys(R.key(0), 3)
    got = tres.resample_residual(keys.column(), w, 8)
    assert got[0].tolist() == [0, 0, 1, 1, 1, 1, 3, 3]
    assert got[2].tolist() == [2] * 8
    assert got[1, :6].tolist() == [0, 0, 1, 1, 2, 3]  # floor(8·w) = 2, 2, 1, 1
    for r in range(3):
        assert torch.equal(got[r], tres.resample_residual(keys.key(r), w[r], 8))


# --- residual resampling in the batched sweep --------------------------------------


class _NoHostWords:
    """Stands in for the key table's host words: any read fails."""

    def __getitem__(self, i):
        raise AssertionError("the batched sweep read a chain's key words on the host")


def _counted(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def counted(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return real(*a, **k)
    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("gated", [True, False])
def test_batched_residual_draws_once_a_firing_step(monkeypatch, gated):
    real_table = engine._key_table
    monkeypatch.setattr(engine, "_key_table",
                        lambda *a: (real_table(*a)[0], (_NoHostWords(), _NoHostWords())))
    calls, keys_seen = {}, []
    real_multinomial = tres.resample_multinomial

    def multinomial(key, weights, n):  # residual's tail draw, once a call
        keys_seen.append((type(key), tuple(weights.shape)))
        return real_multinomial(key, weights, n)
    monkeypatch.setattr(tres, "resample_multinomial", multinomial)
    _counted(monkeypatch, ops, "move_rows_chains", calls)
    _counted(monkeypatch, ops, "prefix_sum_chains", calls)
    for name in ("move_rows", "prefix_sum"):
        def refused(*a, name=name, **k):
            raise AssertionError(f"the one-chain {name} ran in the batched sweep")
        monkeypatch.setattr(ops, name, refused)
    C, N = 3, 256
    sampler = apt.SMC(N, apt.ResampleWithESSThreshold(apt.resample_residual,
                                                      0.5 if gated else 1.0))
    ens = cpu_smc_ensemble(R.key(21), _lgssm(), sampler, C)
    steps = int(ens.diagnostics["resampled"].any(dim=0).sum())
    assert steps > 0
    assert keys_seen == [(R.KeyBatch, (C, N))] * steps
    # B6 for the two prefix sums, B3 for the one float32 leaf.
    assert calls == {"move_rows_chains": steps, "prefix_sum_chains": 2 * steps}


class _TreeKernel(apt.SweepKernel):
    """An LGSSM on a tree state of float32, int32, float64 and bool leaves,
    with transition densities, for residual PGAS."""

    def __init__(self, ys):
        self.ys = torch.as_tensor(ys, dtype=torch.float32)
        self.num_steps = len(ys)

    def _score(self, t, x):
        return -0.5 * ((self.ys[t] - x) / RR) ** 2

    def init(self, rng, ref0, ref_mask):
        x = SIGMA0 * rng.normal(0)
        state = {"x": x, "v": torch.stack([x, 2.0 * x], -1), "n": (x > 0).to(torch.int32),
                 "w": x.double(), "pos": x > 0}
        state = apt.inject_ref(ref_mask, ref0, state)
        return state, self._score(0, state["x"])

    def step(self, t, rng, state, ref_t, ref_mask):
        x = A * state["x"] + Q * rng.normal(0)
        new = {"x": x, "v": 0.5 * state["v"] + x[..., None], "n": state["n"] + (x > 0).to(torch.int32),
               "w": 0.5 * state["w"] + x.double(), "pos": state["pos"] ^ (x > 0)}
        new = apt.inject_ref(ref_mask, ref_t, new)
        return new, self._score(t, new["x"])

    def snapshot(self, state):
        return state

    def transition_logprob(self, t, state, ref_t):
        return -0.5 * ((ref_t["x"] - A * state["x"]) / Q) ** 2


def _leaves(tree):
    return apt._tree.tree_flatten(tree)[0]


@pytest.mark.parametrize("storage", ["dense", "replay"])
@pytest.mark.parametrize("model", ["lgssm", "tree"])
def test_residual_pgas_chains_are_the_loop_of_single_chains(model, storage):
    m = _lgssm() if model == "lgssm" else _TreeKernel(_lgssm_ys(12, seed=3))
    smp = apt.PGAS(64, resampler=apt.resample_residual)
    key = R.key(8)
    ch = cpu_sample_chains(key, m, smp, 2, 3, trajectory_storage=storage)
    for c in range(3):
        one = cpu_sample_pg(R.fold_in(key, c), m, smp, 2, trajectory_storage=storage)
        assert torch.equal(ch.log_evidence[c], one.log_evidence)
        for a, b in zip(_leaves(ch.trajectory), _leaves(one.trajectory)):
            assert torch.equal(a[c], b)


def test_user_resampler_still_runs_once_a_chain_with_its_key():
    seen = []

    def user(key, weights, n):
        seen.append(key)
        return tres.resample_residual(key, weights, n)

    sampler = apt.SMC(128, apt.ResampleWithESSThreshold(user, 1.0))
    key = R.key(5)
    ens = cpu_smc_ensemble(key, _lgssm(), sampler, 2)
    assert seen and all(isinstance(k, R.Key) for k in seen)
    for c in range(2):
        one = cpu_sample_smc(R.fold_in(key, c), _lgssm(), sampler)
        assert torch.equal(ens.log_evidence[c], one.log_evidence)


# --- the tree move by ancestors ------------------------------------------------------


def _tree(lead, m, seed):
    """Leaves ``lead + (m, ...)``: float32 [.], [., 2, 3], int32 [., 4],
    float64, bool, and a float32 leaf one word wider than a kernel takes."""
    g = torch.Generator().manual_seed(seed)
    wide = ops.MAX_DECODE_MOVE_D + 1
    return {"x": torch.randn(lead + (m,), generator=g),
            "v": torch.randn(lead + (m, 2, 3), generator=g),
            "k": torch.randint(-(1 << 30), 1 << 30, lead + (m, 4), generator=g,
                               dtype=torch.int32),
            "w": torch.randn(lead + (m,), generator=g, dtype=torch.float64),
            "b": torch.rand(lead + (m,), generator=g) > 0.5,
            "wide": torch.randn(lead + (m, wide), generator=g)}


@pytest.mark.parametrize("chains", [False, True])
def test_move_by_ancestors_is_the_indexing_it_replaced(monkeypatch, chains):
    calls = {}
    _counted(monkeypatch, ops, "move_rows", calls)
    _counted(monkeypatch, ops, "move_rows_chains", calls)
    m, n = 3, 5
    lead = (2,) if chains else ()
    state = _tree(lead, m, seed=1)
    rng = np.random.default_rng(2)
    anc = torch.as_tensor(rng.integers(0, m, size=lead + (n,)), dtype=torch.int32)
    got_anc, got = ops.move_by_ancestors(anc, state)
    assert torch.equal(got_anc, anc)
    for name, leaf in state.items():
        if chains:
            want = leaf[torch.arange(2)[:, None], anc.long()]
        else:
            want = leaf[anc.long()]
        assert got[name].dtype == leaf.dtype and torch.equal(got[name], want), name
    # B3 for the three 32-bit leaves a kernel takes, a gather for the others.
    assert calls == {"move_rows_chains" if chains else "move_rows": 3}


@pytest.mark.parametrize("chains", [False, True])
def test_move_by_ancestors_past_the_drawn_population(chains):
    # anc == M: B3's leaves take 0, the gathered ones row M − 1.
    m = 4
    lead = (3,) if chains else ()
    state = _tree(lead, m, seed=3)
    anc = torch.tensor([0, m, 2, m - 1, m], dtype=torch.int32).expand(lead + (5,)).contiguous()
    got_anc, got = ops.move_by_ancestors(anc, state)
    clipped = torch.clamp(anc, max=m - 1)
    assert torch.equal(got_anc, clipped)
    past = anc == m
    for name, leaf in state.items():
        want = leaf[torch.arange(3)[:, None], clipped.long()] if chains else leaf[clipped.long()]
        if name in ("x", "v", "k"):
            mask = past.reshape(past.shape + (1,) * (want.dim() - past.dim()))
            want = torch.where(mask, torch.zeros((), dtype=want.dtype), want)
        assert torch.equal(got[name], want), name


@pytest.mark.parametrize("chains", [False, True])
def test_move_versions_agree_on_a_leaf_wider_than_a_kernel_takes(chains):
    m = 6
    c = 2 if chains else None
    state = _tree((c,) if chains else (), m, seed=4)
    w = np.random.default_rng(5).random((2, m))
    f = np.ceil(np.cumsum(w, 1) / w.sum(1, keepdims=True) * (m - 1)).astype(np.int32)
    f = torch.as_tensor(np.maximum.accumulate(f, axis=1))
    move = ops.resample_move_f_chains if chains else ops.resample_move_f
    f = f if chains else f[0].contiguous()
    runs = [move(f, state, m, version, guard_n=m - 1) for version in (1, 6, 0)]
    for anc, moved in runs[1:]:
        assert torch.equal(anc, runs[0][0])
        for name in state:
            if name in ("x", "v", "k"):  # version 0 gives row M − 1 past the guard
                continue
            assert torch.equal(moved[name], runs[0][1][name]), name
    for name in ("x", "v", "k"):
        assert torch.equal(runs[1][1][name], runs[0][1][name]), name


# --- engine.propagate_rng --------------------------------------------------------------


def _assert_ulps(got, want, max_ulps=4, atol=1e-6):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ((ulps <= max_ulps) | (np.abs(got - want) <= atol)).all()


@pytest.mark.parametrize("t", [1, 7])
def test_propagate_rng_is_jaxs(t):
    assert "propagate_rng" in engine.__all__
    jkey = jax.random.key(42)
    gids = np.arange(3, 1003)
    j = jengine.propagate_rng(jkey, t, jnp.asarray(gids, jnp.int32))
    p = engine.propagate_rng(apt.key_from_words(np.asarray(jax.random.key_data(jkey))), t,
                             torch.as_tensor(gids))
    assert [p.key.k0, p.key.k1] == np.asarray(jax.random.key_data(j.key)).tolist()
    assert torch.equal(p.gids, torch.as_tensor(gids))
    np.testing.assert_array_equal(p.uniform().numpy(), np.asarray(j.uniform()))
    np.testing.assert_array_equal(p.uniform(3).numpy(), np.asarray(j.uniform(3)))
    _assert_ulps(p.normal().numpy(), j.normal())


def test_propagate_rng_of_a_chain_batch_is_the_key_tables():
    C, T, N = 4, 6, 50
    keys = R.chain_keys(R.key(7), C)
    table, _ = engine._key_table(keys, T, "cpu")
    gids = torch.arange(N)
    for t in range(1, T):
        batch = engine.propagate_rng(keys, t, gids)
        want = engine._table_keys(table, R.PROPAGATE, t)
        assert torch.equal(batch.key.k0, want.k0) and torch.equal(batch.key.k1, want.k1)
        draws = engine.propagate_rng(keys.column(), t, gids).normal()
        assert draws.shape == (C, N)
        for c in range(C):
            assert torch.equal(draws[c], engine.propagate_rng(keys.key(c), t, gids).normal())


def test_sweep_and_replay_build_the_propagate_stream_through_propagate_rng(monkeypatch):
    calls = []
    real = engine.propagate_rng

    def counted(key, t, gids):
        calls.append(t)
        return real(key, t, gids)
    monkeypatch.setattr(engine, "propagate_rng", counted)
    m = _lgssm()
    kernel = apt.SSMKernel(m)
    T = kernel.num_steps
    res = cpu_sweep(R.key(3), kernel, 64, apt.SMC(64).resampler)
    assert calls == list(range(1, T))
    calls.clear()
    traj = engine.replay_trajectory(R.key(3), kernel, res.ancestors, 5)
    assert calls == list(range(1, T))
    want = engine.reconstruct(res.states, res.ancestors, 5)
    assert torch.allclose(traj, want, rtol=1e-5, atol=1e-5)
