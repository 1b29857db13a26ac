"""Independent chains as one batch along a leading chain axis.

The port's ``smc_ensemble`` and ``sample_chains`` run C chains in one batched
sweep (the key a :class:`~advancedps_tpu_torch.rng.KeyBatch`), as the JAX
package ``vmap``s them.  Held here, on the CPU:

* the batch of keys and the batched :class:`StepRng`: bitwise each chain's own
  draws, and the keys bitwise JAX's ``vmap(fold_in)``;
* the chain-axis plain versions of B1, B6 and B4 (over leaves): row by row
  bitwise the one-chain plain versions, and against ``jax.vmap`` of the
  Pallas kernels in interpret mode as ``test_torch_ops.py`` holds the
  one-chain ones;
* the batched ensembles and chains against the loop of one-chain calls, for
  the model families, a generic program and a hand-written kernel, under
  the four schemes, gated and ungated: bitwise, except where a model's own
  arithmetic is a batched GEMM under ``vmap`` (the Lévy dynamics), which is
  held to float32 rounding;
* the JAX package's ``vmap``-ed ensembles and chains: per chain |ΔlogZ| ≤ 0.2
  and gate flags equal up to the first boundary flip (``test_torch_sweep.py``'s
  contract);
* a kernel that is not vmap-safe raises, and the batch never loops over
  chains.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import advancedps_tpu as aps  # noqa: E402
from advancedps_tpu.parallel import chains as jchains  # noqa: E402
from advancedps_tpu.ops import pallas_resample as pr  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import engine  # noqa: E402
from advancedps_tpu_torch import rng as R  # noqa: E402
from advancedps_tpu_torch.ops import resample as ops  # noqa: E402
from advancedps_tpu_torch.parallel import sample_chains, smc_ensemble  # noqa: E402

cpu_sample_smc = functools.partial(apt.sample_smc, device="cpu")
cpu_sample_pg = functools.partial(apt.sample_pg, device="cpu")
cpu_smc_ensemble = functools.partial(smc_ensemble, device="cpu")
cpu_sample_chains = functools.partial(sample_chains, device="cpu")

#: A missing batching rule makes vmap loop over the batch with this warning;
#: the model families must not need it.
NO_VMAP_LOOP = pytest.mark.filterwarnings("error:There is a performance drop:UserWarning")

A, Q, RR = 0.9, 0.32, 1.0
SIGMA0 = math.sqrt(Q * Q / (1 - A * A))
PARAMS = dict(mu=0.0, sigma0=SIGMA0, a=A, b=0.0, q=Q, h=1.0, r=RR)


def _port_key(jkey):
    return apt.key_from_words(np.asarray(jax.random.key_data(jkey)))


# --- keys and the batched StepRng ----------------------------------------------


def test_chain_keys_are_jax_vmap_fold_in():
    jkey = jax.random.key(17)
    want = np.asarray(jax.random.key_data(
        jax.vmap(lambda i: jax.random.fold_in(jkey, i))(jnp.arange(9))))
    kb = R.chain_keys(_port_key(jkey), 9)
    np.testing.assert_array_equal(torch.stack([kb.k0, kb.k1], -1).numpy(), want)
    for c in range(9):
        assert kb.key(c) == R.fold_in(_port_key(jkey), c)


def test_step_key_table_and_offsets_are_each_chains_own():
    kb = R.chain_keys(R.key(5), 4)
    tags = (R.INIT, R.PROPAGATE, R.RESAMPLE, R.ANCESTOR, R.DRAW)
    k0, k1 = R.step_key_table(kb, tags, 6)
    u = R.uniform(R.KeyBatch(k0, k1))
    for s, tag in enumerate(tags):
        for t in range(6):
            for c in range(4):
                one = R.step_key(kb.key(c), tag, t)
                assert (int(k0[s, t, c]), int(k1[s, t, c])) == (one.k0, one.k1)
                assert float(u[s, t, c]) == R.uniform(one)
    assert u.dtype == torch.float32
    folded = R.fold_in(R.fold_in(kb, 3), 7)
    assert all(folded.key(c) == R.step_key(kb.key(c), 3, 7) for c in range(4))


def test_batched_step_rng_draws_each_chains_draws():
    kb = R.chain_keys(R.key(8), 5)
    gids = torch.arange(37) * 3 + 1
    sr = R.StepRng(kb.column(), gids)
    draws = [sr.uniform(2), sr.normal(1), torch.stack(sr.normal_pair(0)), sr.normals(5),
             sr.particle_keys(), R.fold_in_ids(kb.column(), gids)]
    for c in range(5):
        one = R.StepRng(kb.key(c), gids)
        want = [one.uniform(2), one.normal(1), torch.stack(one.normal_pair(0)), one.normals(5),
                one.particle_keys(), R.fold_in_ids(kb.key(c), gids)]
        for got, w in zip(draws, want):
            row = got[:, c] if got.dim() == w.dim() + 1 and got.shape[0] == 2 else got[c]
            assert torch.equal(row, w)
    # Under vmap over the chain axis a StepRng holds one chain's 0-dim words.
    mapped = torch.func.vmap(lambda a, b: R.StepRng(R.KeyBatch(a, b), gids).normals(3))(
        kb.k0, kb.k1)
    for c in range(5):
        assert torch.equal(mapped[c], R.StepRng(kb.key(c), gids).normals(3))


# --- the chain-axis plain kernels ------------------------------------------------

PROFILES = ["lognormal", "uniform", "single", "survivors20"]
CHAIN_SIZES = [(3, 1000), (4, 2049)]  # 2049: one element past a tile


def _logw(profile, c, m, seed):
    rng = np.random.default_rng(seed)
    if profile == "lognormal":
        return (rng.standard_normal((c, m)) * 2.0).astype(np.float32)
    if profile == "uniform":
        return np.zeros((c, m), np.float32)
    logw = np.full((c, m), -80.0, np.float32)
    k = 1 if profile == "single" else 20
    for r in range(c):
        logw[r, rng.choice(m, size=k, replace=False)] = rng.standard_normal(k)
    return logw


def _reduce(logw):
    m = logw.max(axis=1).astype(np.float32)
    s1 = np.exp(logw - m[:, None], dtype=np.float32).sum(axis=1, dtype=np.float32)
    return m, s1.astype(np.float32)


def _chain_case(profile, c, m, guarded):
    logw = _logw(profile, c, m, seed=c * m)
    mx, s1 = _reduce(logw)
    u = np.random.default_rng(m + 1).random(c).astype(np.float32)
    n = m - 1 if guarded else m
    return logw, mx, s1, u, n


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("c,m", CHAIN_SIZES)
def test_chain_extents_rows_are_b1_and_match_vmapped_pallas(c, m, profile):
    logw, mx, s1, u, n = _chain_case(profile, c, m, False)
    f = ops.extents_from_logw_chains(torch.as_tensor(logw), torch.as_tensor(mx),
                                     torch.as_tensor(s1), torch.as_tensor(u), n)
    assert f.shape == (c, m) and f.dtype == torch.int32
    for r in range(c):
        one = ops.extents_from_logw(torch.as_tensor(logw[r]), torch.tensor(mx[r]),
                                    torch.tensor(s1[r]), float(u[r]), n)
        assert torch.equal(f[r], one)
    # jax.vmap of the Pallas kernel: every pallas_call gains a grid axis.
    f_jax = np.asarray(jax.vmap(
        lambda lw, a, b, uu: pr.extents_from_logw(lw, a, b, uu, n, interpret=True))(
            logw, mx, s1, u))
    diff = np.abs(f.numpy().astype(np.int64) - f_jax.astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert (np.diff(f.numpy(), axis=1) >= 0).all()


def _ulps(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


@pytest.mark.parametrize("c,m", CHAIN_SIZES)
def test_chain_scaled_prefix_rows_are_b6_and_match_vmapped_pallas(c, m):
    logw, mx, s1, _, n = _chain_case("lognormal", c, m, False)
    scale = (np.float32(n) / s1).astype(np.float32)
    got = ops.scaled_prefix_from_logw_chains(torch.as_tensor(logw), torch.as_tensor(mx),
                                             torch.as_tensor(scale))
    x = np.abs(logw)
    ps = ops.prefix_sum_chains(torch.as_tensor(x))
    for r in range(c):
        assert torch.equal(got[r], ops.scaled_prefix_from_logw(
            torch.as_tensor(logw[r]), torch.tensor(mx[r]), torch.tensor(scale[r])))
        assert torch.equal(ps[r], ops.prefix_sum(torch.as_tensor(x[r])))
    want = np.asarray(jax.vmap(
        lambda lw, a, s: pr.scaled_prefix_from_logw(lw, a, s, interpret=True))(logw, mx, scale))
    assert _ulps(got.numpy(), want).max() <= 4  # test_torch_ops.B6_ULPS
    want_ps = np.asarray(jax.vmap(lambda v: pr.prefix_sum(v, interpret=True))(x))
    assert _ulps(ps.numpy(), want_ps).max() <= 4
    assert (np.diff(got.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("c,m", CHAIN_SIZES)
def test_chain_decode_move_rows_are_b4_and_match_vmapped_pallas(c, m, profile, guarded):
    logw, mx, s1, u, n = _chain_case(profile, c, m, guarded)
    f = ops.extents_from_logw_chains(torch.as_tensor(logw), torch.as_tensor(mx),
                                     torch.as_tensor(s1), torch.as_tensor(u), n)
    rng = np.random.default_rng(m)
    x = rng.standard_normal((c, m)).astype(np.float32)
    wide = rng.standard_normal((c, m, 3)).astype(np.float32)
    ids = rng.integers(0, 1 << 30, (c, m)).astype(np.int32)
    anc, moved = ops.decode_move_chains(f, torch.as_tensor(x), m, guard=n)
    anc_l, (mx_, mw, mi) = ops.decode_move_leaves_chains(
        f, [torch.as_tensor(x), torch.as_tensor(wide), torch.as_tensor(ids)], m, guard=n)
    assert torch.equal(anc, anc_l) and torch.equal(moved, mx_)
    for r in range(c):
        a1, v1 = ops.decode_move(f[r].contiguous(), torch.as_tensor(x[r]), m, guard=n)
        assert torch.equal(anc[r], a1) and torch.equal(moved[r], v1)
        a2, (w2, i2) = ops.decode_move_leaves(
            f[r].contiguous(), [torch.as_tensor(wide[r]), torch.as_tensor(ids[r])], m, guard=n)
        assert torch.equal(anc_l[r], a2) and torch.equal(mw[r], w2) and torch.equal(mi[r], i2)
    # resample_move_f (B4, version 1) under jax.vmap, bitwise.
    anc_j, moved_j = jax.vmap(lambda ff, xx, ww: pr.resample_move_f(
        ff, (xx, ww), m, interpret=True, version=1, guard_n=n))(
            jnp.asarray(f.numpy()), jnp.asarray(x), jnp.asarray(wide))
    np.testing.assert_array_equal(anc.numpy(), np.asarray(anc_j))
    np.testing.assert_array_equal(moved.numpy().view(np.int32),
                                  np.asarray(moved_j[0]).view(np.int32))
    np.testing.assert_array_equal(mw.numpy().view(np.int32),
                                  np.asarray(moved_j[1]).view(np.int32))
    if guarded:
        assert (anc[:, -1] == m - 1).all() and (moved[:, -1] == 0).all()


@pytest.mark.parametrize("version", [0, 1, 6])
def test_chain_resample_move_is_the_one_chain_move_under_each_version(version):
    logw, mx, s1, u, n = _chain_case("lognormal", 3, 1500, True)
    f = ops.extents_from_logw_chains(torch.as_tensor(logw), torch.as_tensor(mx),
                                     torch.as_tensor(s1), torch.as_tensor(u), n)
    g = torch.Generator().manual_seed(0)
    state = {"x": torch.randn(3, 1500, generator=g),
             "h": torch.randn(3, 1500, 4, 2, generator=g),
             "k": torch.randint(0, 9, (3, 1500), generator=g, dtype=torch.int32),
             "d": torch.randn(3, 1500, generator=g, dtype=torch.float64)}
    anc, moved = ops.resample_move_f_chains(f, state, 1500, version, guard_n=n)
    for r in range(3):
        a1, m1 = ops.resample_move_f(f[r].contiguous(), {k: v[r] for k, v in state.items()},
                                     1500, version, guard_n=n)
        assert torch.equal(anc[r], a1)
        for k in state:
            assert torch.equal(moved[k][r], m1[k]), k


def test_chain_wrappers_check_shapes():
    f = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        ops.decode_move_chains(f, torch.zeros(3, 8), 8)
    with pytest.raises(ValueError, match="shape"):
        ops.extents_from_logw_chains(torch.zeros(2, 8), torch.zeros(3), torch.ones(2),
                                     torch.zeros(2), 8)
    with pytest.raises(ValueError):
        ops.extents_from_logw_chains(torch.zeros(8), torch.zeros(1), torch.ones(1),
                                     torch.zeros(1), 8)


# --- the batched sweep against the loop ----------------------------------------------


class _TreeKernel(apt.SweepKernel):
    """A hand-written kernel with a tree state: float32, int32 and int64 leaves."""

    def __init__(self, ys):
        self.ys = torch.as_tensor(ys)

    @property
    def num_steps(self):
        return self.ys.shape[0]

    def _score(self, t, x):
        return -0.5 * ((self.ys[t] - x) / RR) ** 2

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

    def transition_logprob(self, t, state, ref_t):
        return -0.5 * ((ref_t["x"] - A * state["x"]) / Q) ** 2


def _lgssm_ys(steps, seed=0):
    _, ys = aps.simulate(jax.random.key(seed), aps.models.stationary_lgssm(A, Q, RR), steps)
    return np.array(ys)


def _family_model(family, params, steps):
    m = apt.model_from_numpy(family, params, device="cpu")
    _, ys = apt.simulate(R.key(0), m, steps)
    return apt.TracedSSM(m, ys)


def _program(ctx):
    x = ctx.sample(apt.Normal(0.0, 1.0), name="x0")
    for t in range(6):
        x = ctx.sample(apt.Normal(0.9 * x, 0.5), name=f"x{t + 1}")
        ctx.observe(apt.Normal(x, 1.0), 0.4 * t - 1.0)


#: model → (builder, whether the batch is bitwise the loop)
MODELS = {
    "lgssm": (lambda: apt.traced_ssm_from_numpy(PARAMS, _lgssm_ys(15), device="cpu"), True),
    "stochastic_volatility": (lambda: _family_model(
        "stochastic_volatility", dict(a=0.9, q=0.5), 12), True),
    # Its 2x2 matmul under vmap is a batched GEMM whose blocking follows C.
    "levy": (lambda: _family_model("levy", dict(dt=0.5), 5), False),
    "gp_ssm": (lambda: _family_model("gp_ssm", dict(num_steps=8, lengthscale=1.5,
                                                   variance=0.5), 8), True),
    "generic": (lambda: apt.GenericModel(_program), True),
    "tree_kernel": (lambda: _TreeKernel(_lgssm_ys(12, seed=3)), True),
}

SCHEMES = {
    "systematic": apt.resample_systematic,
    "stratified": apt.resample_stratified,
    "multinomial": apt.resample_multinomial,
    "residual": apt.resample_residual,
}


#: Models whose gated chains fire on different steps under the key of
#: test_ensemble_is_the_loop_of_single_runs (a step where some chains fire and
#: others do not is the batch's ``where`` path).
FIRE_APART = ("lgssm", "generic", "stochastic_volatility")


def _leaves(tree):
    return apt._tree.tree_flatten(tree)[0] if tree is not None else []


def _same(got, want, bitwise):
    if bitwise:
        return torch.equal(got, want)
    return torch.allclose(got, want, rtol=1e-5, atol=1e-5)


@NO_VMAP_LOOP
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_ensemble_is_the_loop_of_single_runs(model, scheme, gated):
    build, bitwise = MODELS[model]
    m = build()
    sampler = apt.SMC(256, apt.ResampleWithESSThreshold(SCHEMES[scheme], 0.5 if gated else 1.0))
    key = R.key(21)
    C = 3
    ens = cpu_smc_ensemble(key, m, sampler, C)
    assert ens.log_evidence.shape == (C,) and ens.weights.shape == (C, 256)
    patterns = set()
    for c in range(C):
        one = cpu_sample_smc(R.fold_in(key, c), m, sampler)
        assert torch.equal(ens.diagnostics["resampled"][c], one.diagnostics["resampled"])
        assert _same(ens.log_evidence[c], one.log_evidence, bitwise)
        assert _same(ens.weights[c], one.weights, bitwise)
        assert _same(ens.diagnostics["ess"][c], one.diagnostics["ess"], bitwise)
        for a, b in zip(_leaves(ens.trajectories), _leaves(one.trajectories)):
            assert _same(a[c], b, bitwise)
        patterns.add(tuple(one.diagnostics["resampled"].tolist()))
    if gated and model in FIRE_APART:
        assert len(patterns) > 1, "the chains should fire on different steps"
    if not gated:
        assert bool(ens.diagnostics["resampled"][:, 1:].all())


@NO_VMAP_LOOP
@pytest.mark.parametrize("storage", ["dense", "replay"])
@pytest.mark.parametrize("sampler", ["PG", "PGAS"])
@pytest.mark.parametrize("model", ["lgssm", "stochastic_volatility", "gp_ssm", "tree_kernel",
                                   "levy"])
def test_chains_are_the_loop_of_single_chains(model, sampler, storage):
    build, bitwise = MODELS[model]
    m = build()
    smp = getattr(apt, sampler)(64)
    key = R.key(4)
    ch = cpu_sample_chains(key, m, smp, 2, 2, trajectory_storage=storage)
    for c in range(2):
        one = cpu_sample_pg(R.fold_in(key, c), m, smp, 2, trajectory_storage=storage)
        assert _same(ch.log_evidence[c], one.log_evidence, bitwise)
        for a, b in zip(_leaves(ch.trajectory), _leaves(one.trajectory)):
            assert a.shape[:2] == (2, 2)
            assert _same(a[c], b, bitwise)


def test_generic_chains_are_the_loop_of_single_chains():
    m = apt.GenericModel(_program)
    key = R.key(6)
    ch = cpu_sample_chains(key, m, apt.PG(32), 3, 2)
    for c in range(2):
        one = cpu_sample_pg(R.fold_in(key, c), m, apt.PG(32), 3)
        assert torch.equal(ch.trajectory[c], one.trajectory)
        assert torch.equal(ch.log_evidence[c], one.log_evidence)


class _Float64Kernel(_TreeKernel):
    """:class:`_TreeKernel`'s dynamics on a state with no 32-bit leaf: a
    float64 value and an int64 id, both gathered by the decoded ancestors."""

    def init(self, rng, ref0, ref_mask):
        x = rng.normal(0).double()
        state = apt.inject_ref(ref_mask, ref0, {"x": x, "id": rng.gids.to(torch.int64)})
        return state, self._score(0, state["x"]).float()

    def step(self, t, rng, state, ref_t, ref_mask):
        x = A * state["x"] + Q * rng.normal(0).double()
        new = apt.inject_ref(ref_mask, ref_t, {"x": x, "id": state["id"] + 1000})
        return new, self._score(t, new["x"]).float()


@pytest.mark.parametrize("version", [0, 6])
def test_batched_sweep_under_the_other_move_versions(monkeypatch, version):
    """The GP-SSM's tree state, the LGSSM's float32 rows, and a state with
    no 32-bit leaf (decoded by B2 with the chain axis, then gathered), gated
    at ESS 0.5 and resampling at every step."""
    monkeypatch.setattr(ops, "MOVE_VERSION", version)
    key = R.key(2)
    for m in (MODELS["gp_ssm"][0](), MODELS["lgssm"][0](), _Float64Kernel(_lgssm_ys(12, seed=3))):
        for threshold in (0.5, 1.0):
            smp = apt.SMC(128, apt.ResampleWithESSThreshold(apt.resample_systematic, threshold))
            ens = cpu_smc_ensemble(key, m, smp, 2)
            if threshold == 1.0:
                assert bool(ens.diagnostics["resampled"][:, 1:].all())
            for c in range(2):
                one = cpu_sample_smc(R.fold_in(key, c), m, smp)
                assert torch.equal(ens.log_evidence[c], one.log_evidence)
                for a, b in zip(_leaves(ens.trajectories), _leaves(one.trajectories)):
                    assert torch.equal(a[c], b)


def test_no_resampling_kernel_on_a_step_where_no_chain_fires(monkeypatch):
    calls = []
    real = ops.extents_from_logw_chains

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ops, "extents_from_logw_chains", counted)
    m = MODELS["lgssm"][0]()
    ens = cpu_smc_ensemble(R.key(21), m, apt.SMC(256), 3)
    rs = ens.diagnostics["resampled"]
    assert len(calls) == int(rs.any(dim=0).sum()) < rs.shape[1] - 1
    assert int(rs.any(dim=0).sum()) > int(rs.all(dim=0).sum())  # some steps: some chains


class _Counting(apt.SweepKernel):
    """Counts its own calls; ``host_read`` makes its step read a value."""

    num_steps = 6

    def __init__(self, host_read=False):
        self.calls = 0
        self.host_read = host_read

    def init(self, rng, ref0, ref_mask):
        x = rng.normal()
        return x, -0.5 * x * x

    def step(self, t, rng, state, ref_t, ref_mask):
        self.calls += 1
        x = 0.9 * state + rng.normal()
        if self.host_read and float(x[0]) > 100.0:
            x = x * 0.0
        return x, -0.5 * x * x

    def snapshot(self, state):
        return state


def test_batch_calls_the_kernel_once_a_step_and_never_loops():
    k = _Counting()
    cpu_smc_ensemble(R.key(1), k, apt.SMC(32), 7)
    assert k.calls == k.num_steps - 1


def test_kernel_that_is_not_vmap_safe_raises():
    k = _Counting(host_read=True)
    with pytest.raises(engine.ChainBatchError, match="kernel.step is not vmap-safe"):
        cpu_smc_ensemble(R.key(1), k, apt.SMC(32), 3)
    assert k.calls == 1  # one attempt, no loop over the chains
    # The same kernel runs one chain.
    assert torch.isfinite(cpu_sample_smc(R.key(1), _Counting(host_read=True),
                                         apt.SMC(32)).log_evidence)


def test_batched_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run there")
    m = MODELS["lgssm"][0]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smc_ensemble(R.key(1), m, apt.SMC(16), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_chains(R.key(1), m, apt.PGAS(16), 1, 2)


# --- against the JAX package's vmap ------------------------------------------------

JN, JT, JC = 4096, 30, 3


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's ensemble and chains, each compiled once."""
    ys = _lgssm_ys(JT, seed=5)
    jm = aps.TracedSSM(aps.models.stationary_lgssm(A, Q, RR), jnp.asarray(ys))
    key = jax.random.key(31)
    ens = jchains.smc_ensemble(key, jm, aps.SMC(JN), JC)
    chains = jchains.sample_chains(key, jm, aps.PGAS(JN), 2, JC)
    return ys, key, ens, chains


def test_ensemble_matches_jax_vmap(jax_runs):
    ys, key, jens, _ = jax_runs
    ens = cpu_smc_ensemble(_port_key(key), apt.traced_ssm_from_numpy(PARAMS, ys, device="cpu"),
                           apt.SMC(JN), JC, store_states=False)
    j_rs = np.asarray(jens.diagnostics["resampled"])
    t_rs = ens.diagnostics["resampled"].numpy()
    j_ess = np.asarray(jens.diagnostics["ess"])
    t_ess = ens.diagnostics["ess"].numpy()
    for c in range(JC):
        assert abs(float(ens.log_evidence[c]) - float(jens.log_evidence[c])) <= 0.2
        # Flags equal until the first boundary flip: the ESS agree to float32
        # rounding up to then, and the gate is the same comparison.
        close = np.isclose(t_ess[c], j_ess[c], rtol=1e-4)
        first = int(np.argmin(close)) if not close.all() else JT
        assert first > 1
        assert (j_rs[c, :first] == t_rs[c, :first]).all()


def test_chains_match_jax_vmap(jax_runs):
    ys, key, _, jch = jax_runs
    ch = cpu_sample_chains(_port_key(key), apt.traced_ssm_from_numpy(PARAMS, ys, device="cpu"),
                           apt.PGAS(JN), 2, JC)
    assert ch.trajectory.shape == tuple(np.shape(jch.trajectory))
    # Iteration 0 is an unconditional sweep: its log-evidence is held as the
    # ensemble's; the later iterations follow different references after a flip.
    d = np.abs(ch.log_evidence.numpy()[:, 0] - np.asarray(jch.log_evidence)[:, 0])
    assert d.max() <= 0.2
    assert np.isfinite(ch.trajectory.numpy()).all()
