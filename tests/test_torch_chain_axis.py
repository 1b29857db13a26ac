"""B2, B3, B5, B7 and B8 with the chain axis, and the batched sweep that
runs them once a firing step for all chains.

Held here, on the CPU:

* each batched plain version (``*_chains_ref``, what the wrapper runs on a
  CPU tensor): row ``c`` bitwise the one-chain plain version on row ``c``,
  and equal to ``jax.vmap`` of the Pallas kernel in interpret mode, which is
  what the JAX package runs under ``vmap`` (every ``pallas_call`` gains a
  grid axis);
* the wrappers refuse bad shapes, no chains and more than ``MAX_CHAINS``;
* a multinomial batch calls ``count_le_sorted_auto_chains`` once a firing
  step, and ``resample_move_f_chains`` under move versions 6 and 0 calls each
  chain entry once, never a one-chain kernel;
* multinomial ensembles and PGAS chains, and batches under move versions 6
  and 0, bitwise the loop of one-chain calls.

The kernels themselves are held row by row against the one-chain kernels on
the card by ``tests/test_torch_chains_cuda.py`` and ``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from advancedps_tpu.ops import pallas_resample as pr  # noqa: E402
import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import rng as R  # noqa: E402
from advancedps_tpu_torch.ops import resample as ops  # noqa: E402
from advancedps_tpu_torch.parallel import sample_chains, smc_ensemble  # noqa: E402

cpu_sample_smc = functools.partial(apt.sample_smc, device="cpu")
cpu_sample_pg = functools.partial(apt.sample_pg, device="cpu")
cpu_smc_ensemble = functools.partial(smc_ensemble, device="cpu")
cpu_sample_chains = functools.partial(sample_chains, device="cpu")

#: (C, M): 2049 is one past a tile of B1's scan and of B5's, 1025 past two of
#: B2's and B7's.  The JAX comparisons run at the second size only: each
#: shape is a compile of every Pallas kernel under vmap.
SIZES = [(3, 1000), (4, 2049)]
JAX_SIZE = (4, 2049)


def _extents(c, m, guarded, seed):
    """Nondecreasing extents ``[C, M]`` drawn for ``n`` positions (``M``, or
    ``M − 1`` in the guard case), from skewed weights, with ``n``."""
    n = m - 1 if guarded else m
    rng = np.random.default_rng(seed)
    w = rng.random((c, m)) ** 4
    w[0, : m // 2] = 0.0  # a long run of rows that own nothing
    f = np.ceil(np.cumsum(w, 1) / w.sum(1, keepdims=True) * n).clip(0, n).astype(np.int32)
    f = np.maximum.accumulate(f, axis=1)
    return f, n


def _guarded(f, n):
    g = np.array(f)
    g[:, -1] = n
    return g


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _counts_case(c, m, seed):
    """The engine's multinomial inputs: ``S [C, m + 1]`` (its rows sliced to
    ``m`` as the engine slices them: rows ``m + 1`` apart) and thresholds
    ``[C, m]``, with ties and values below and above every entry of ``s``."""
    rng = np.random.default_rng(seed)
    S = np.cumsum(rng.exponential(size=(c, m + 1)), 1).astype(np.float32)
    t = np.sort(rng.random((c, m)) * S[:, -1:] * 1.05, 1).astype(np.float32)
    t[:, :5] = -1.0
    t[:, 10:20] = S[:, 10:11]
    return torch.as_tensor(S), torch.as_tensor(t)


# --- the batched plain versions -------------------------------------------------


@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("c,m", SIZES)
def test_decode_and_move_rows_are_b2_and_b3_and_match_vmapped_pallas(c, m, guarded):
    f, n = _extents(c, m, guarded, seed=c * m)
    ft = torch.as_tensor(f)
    rng = np.random.default_rng(m)
    x = rng.standard_normal((c, m)).astype(np.float32)
    wide = rng.standard_normal((c, m, 3)).astype(np.float32)
    ids = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, (c, m)).astype(np.int32))
    anc = ops.decode_ancestors_chains(ft, m, guard=n)
    assert torch.equal(anc, ops.decode_ancestors_chains_ref(ft, m, guard=n))
    assert anc.shape == (c, m) and anc.dtype == torch.int32
    moved = {name: ops.move_rows_chains(anc, torch.as_tensor(v))
             for name, v in (("x", x), ("wide", wide), ("ids", ids))}
    for r in range(c):
        assert torch.equal(anc[r], ops.decode_ancestors(ft[r].contiguous(), m, guard=n))
        for name, v in (("x", x), ("wide", wide), ("ids", ids)):
            a1, m1 = ops.move_rows(anc[r].contiguous(), torch.as_tensor(v[r]))
            assert torch.equal(moved[name][0][r], a1) and torch.equal(moved[name][1][r], m1)
    if guarded:  # the last slot lies past the drawn population
        assert (anc[:, -1] == m).all()
        assert (moved["x"][0][:, -1] == m - 1).all() and (moved["x"][1][:, -1] == 0).all()
    if (c, m) != JAX_SIZE:
        return
    # The v6 pipeline under jax.vmap: decode_ancestors_bs on the guarded
    # extents (unclipped ancestors), then the lookup move of each column.
    anc_j, cols_j = jax.vmap(lambda ff, xx, ww: pr._resample_move_cols_v6(
        ff, (xx, ww[:, 0], ww[:, 1], ww[:, 2]), m, interpret=True, guard=n))(
            jnp.asarray(f), jnp.asarray(x), jnp.asarray(wide))
    np.testing.assert_array_equal(anc.numpy(), np.asarray(anc_j))
    np.testing.assert_array_equal(moved["x"][0].numpy(), np.minimum(np.asarray(anc_j), m - 1))
    np.testing.assert_array_equal(_bits(moved["x"][1].numpy()), _bits(cols_j[0]))
    for k in range(3):
        np.testing.assert_array_equal(_bits(moved["wide"][1][..., k].numpy()), _bits(cols_j[k + 1]))


@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("c,m", SIZES)
def test_dense_decode_rows_are_b5_and_match_vmapped_pallas(c, m, guarded):
    f, n = _extents(c, m, guarded, seed=c * m + 1)
    ft = torch.as_tensor(f)
    anc = ops.decode_ancestors_dense_chains(ft, m, guard=n)
    assert torch.equal(anc, ops.decode_ancestors_dense_chains_ref(ft, m, guard=n))
    assert torch.equal(anc, ops.decode_ancestors_chains(ft, m, guard=n))
    for r in range(c):
        assert torch.equal(anc[r], ops.decode_ancestors_dense(ft[r].contiguous(), m, guard=n))
    # Slots fewer and more than rows.
    for n_out in (m // 3, 2 * m + 5):
        got = ops.decode_ancestors_dense_chains(ft, n_out, guard=n)
        assert torch.equal(got, ops.decode_ancestors_chains(ft, n_out, guard=n))
    if (c, m) == JAX_SIZE:
        want = jax.vmap(lambda ff: pr.decode_ancestors(ff, m, interpret=True))(
            jnp.asarray(_guarded(f, n)))
        np.testing.assert_array_equal(anc.numpy(), np.asarray(want))


@pytest.mark.parametrize("form", ["bs", "merge"])
@pytest.mark.parametrize("c,m", SIZES)
def test_counts_rows_are_b7_and_b8_and_match_vmapped_pallas(c, m, form):
    S, t = _counts_case(c, m, seed=c * m + 2)
    s = S[:, :m]  # rows m + 1 apart, as the engine hands them over
    assert not s.is_contiguous()
    chains = {"bs": ops.count_le_sorted_bs_chains, "merge": ops.count_le_sorted_chains}[form]
    one = {"bs": ops.count_le_sorted_bs, "merge": ops.count_le_sorted}[form]
    got = chains(s, t)
    assert got.shape == (c, m) and got.dtype == torch.int32
    assert torch.equal(got, ops.count_le_sorted_chains_ref(s, t))
    for r in range(c):
        assert torch.equal(got[r], one(s[r], t[r]))
        assert torch.equal(got[r], ops.count_le_sorted_ref(s[r], t[r]))
    if (c, m) == JAX_SIZE:
        pallas = {"bs": pr.count_le_sorted_bs, "merge": pr.count_le_sorted}[form]
        want = jax.vmap(lambda a, b: pallas(a, b, interpret=True))(
            jnp.asarray(s.numpy()), jnp.asarray(t.numpy()))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_count_le_auto_chains_dispatch(monkeypatch):
    S, t = _counts_case(2, 300, seed=5)
    calls = []
    for name in ("count_le_sorted_bs_chains", "count_le_sorted_chains"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda s, t, real=real, name=name: (
            calls.append(name), real(s, t))[1])
    for mode in ("bs", "merge"):
        monkeypatch.setattr(ops, "COUNT_LE_SORTED", mode)
        ops.count_le_sorted_auto_chains(S[:, :300], t)
    assert calls == ["count_le_sorted_bs_chains", "count_le_sorted_chains"]
    monkeypatch.setattr(ops, "COUNT_LE_SORTED", "other")
    with pytest.raises(ValueError, match="COUNT_LE_SORTED"):
        ops.count_le_sorted_auto_chains(S[:, :300], t)


def test_chain_wrappers_refuse_bad_shapes_and_chain_counts():
    f = torch.zeros(2, 8, dtype=torch.int32)
    for fn in (ops.decode_ancestors_chains, ops.decode_ancestors_dense_chains):
        with pytest.raises(ValueError, match="chains"):
            fn(torch.zeros(0, 8, dtype=torch.int32), 8)
        with pytest.raises(ValueError, match="chains"):
            fn(torch.zeros(ops.MAX_CHAINS + 1, 1, dtype=torch.int32), 1)
        with pytest.raises(ValueError):
            fn(torch.zeros(8, dtype=torch.int32), 8)
        with pytest.raises(ValueError, match="empty"):
            fn(torch.zeros(2, 0, dtype=torch.int32), 8)
        with pytest.raises(TypeError):
            fn(f.float(), 8)
    anc = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        ops.move_rows_chains(anc, torch.zeros(3, 8))
    with pytest.raises(ValueError, match="chains"):
        ops.move_rows_chains(torch.zeros(0, 8, dtype=torch.int32), torch.zeros(0, 8))
    with pytest.raises(ValueError, match="chains"):
        ops.move_rows_chains(torch.zeros(ops.MAX_CHAINS + 1, 1, dtype=torch.int32),
                             torch.zeros(ops.MAX_CHAINS + 1, 1))
    with pytest.raises(TypeError):
        ops.move_rows_chains(anc, torch.zeros(2, 8, dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.move_rows_chains(anc, torch.zeros(2, 8, 2).transpose(1, 2))
    s, t = torch.zeros(2, 8), torch.zeros(2, 5)
    for fn in (ops.count_le_sorted_bs_chains, ops.count_le_sorted_chains):
        with pytest.raises(ValueError, match="shape"):
            fn(s, torch.zeros(3, 5))
        with pytest.raises(ValueError, match="chains"):
            fn(torch.zeros(0, 8), torch.zeros(0, 5))
        with pytest.raises(ValueError, match="chains"):
            fn(torch.zeros(ops.MAX_CHAINS + 1, 1), torch.zeros(ops.MAX_CHAINS + 1, 1))
        with pytest.raises(ValueError, match="rows"):
            fn(torch.zeros(8, 2).t(), t)  # columns of consecutive values
        with pytest.raises(ValueError, match="rows"):
            fn(torch.zeros(8).expand(2, 8), t)  # every row the same values
        with pytest.raises(TypeError):
            fn(s.double(), t)
        with pytest.raises(TypeError):
            fn(s, t.double())


# --- the batched sweep runs each chain entry once a firing step --------------------

A, Q, RR = 0.9, 0.32, 1.0
PARAMS = dict(mu=0.0, sigma0=(Q * Q / (1 - A * A)) ** 0.5, a=A, b=0.0, q=Q, h=1.0, r=RR)


def _lgssm():
    model = apt.models.stationary_lgssm(A, Q, RR)
    _, ys = apt.simulate(torch.Generator().manual_seed(4), model, 15)
    return apt.TracedSSM(model, ys)


def _refuse(monkeypatch, *names):
    for name in names:
        def refused(*a, name=name, **k):
            raise AssertionError(f"{name} called by the batched sweep")
        monkeypatch.setattr(ops, name, refused)


def _count(monkeypatch, calls, name):
    real = getattr(ops, name)

    def counted(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return real(*a, **k)
    monkeypatch.setattr(ops, name, counted)


@pytest.mark.parametrize("merge", [False, True])
def test_multinomial_batch_counts_once_a_firing_step(monkeypatch, merge):
    monkeypatch.setattr(ops, "COUNT_LE_SORTED", "merge" if merge else "bs")
    calls = {}
    for name in ("count_le_sorted_auto_chains", "count_le_sorted_bs_chains",
                 "count_le_sorted_chains"):
        _count(monkeypatch, calls, name)
    _refuse(monkeypatch, "count_le_sorted_auto", "count_le_sorted_bs", "count_le_sorted")
    sampler = apt.SMC(256, apt.ResampleWithESSThreshold(apt.resample_multinomial))
    ens = cpu_smc_ensemble(R.key(21), _lgssm(), sampler, 3)
    steps = int(ens.diagnostics["resampled"].any(dim=0).sum())
    assert steps > 0
    entry = "count_le_sorted_chains" if merge else "count_le_sorted_bs_chains"
    assert calls == {"count_le_sorted_auto_chains": steps, entry: steps}


@pytest.mark.parametrize("version", [0, 6])
def test_other_move_versions_run_each_chain_entry_once_a_firing_step(monkeypatch, version):
    monkeypatch.setattr(ops, "MOVE_VERSION", version)
    calls = {}
    for name in ("decode_ancestors_chains", "move_rows_chains", "decode_ancestors_dense_chains"):
        _count(monkeypatch, calls, name)
    _refuse(monkeypatch, "resample_move_f", "decode_ancestors", "move_rows",
            "decode_ancestors_dense", "decode_move_chains", "decode_move_leaves_chains")
    ens = cpu_smc_ensemble(R.key(21), _lgssm(), apt.SMC(256), 3)
    steps = int(ens.diagnostics["resampled"].any(dim=0).sum())
    assert steps > 0
    want = ({"decode_ancestors_dense_chains": steps} if version == 0 else
            {"decode_ancestors_chains": steps, "move_rows_chains": steps})
    assert calls == want


# --- the batch against the loop of one-chain calls --------------------------------


@pytest.mark.parametrize("storage", ["dense", "replay"])
@pytest.mark.parametrize("scheme", ["multinomial", "multinomial, merge path"])
def test_multinomial_pgas_chains_are_the_loop_of_single_chains(monkeypatch, scheme, storage):
    monkeypatch.setattr(ops, "COUNT_LE_SORTED", "merge" if "merge" in scheme else "bs")
    m = _lgssm()
    smp = apt.PGAS(64, resampler=apt.resample_multinomial)
    key = R.key(8)
    ch = cpu_sample_chains(key, m, smp, 2, 3, trajectory_storage=storage)
    for c in range(3):
        one = cpu_sample_pg(R.fold_in(key, c), m, smp, 2, trajectory_storage=storage)
        assert torch.equal(ch.log_evidence[c], one.log_evidence)
        assert torch.equal(ch.trajectory[c], one.trajectory)


@pytest.mark.parametrize("version", [0, 6])
def test_pgas_chains_under_the_other_move_versions_are_the_loop(monkeypatch, version):
    monkeypatch.setattr(ops, "MOVE_VERSION", version)
    m = _lgssm()
    key = R.key(9)
    ch = cpu_sample_chains(key, m, apt.PGAS(64), 2, 3, trajectory_storage="replay")
    for c in range(3):
        one = cpu_sample_pg(R.fold_in(key, c), m, apt.PGAS(64), 2, trajectory_storage="replay")
        assert torch.equal(ch.log_evidence[c], one.log_evidence)
        assert torch.equal(ch.trajectory[c], one.trajectory)


@pytest.mark.parametrize("version", [0, 1, 6])
def test_resample_move_f_chains_on_a_state_with_no_32_bit_leaf(version):
    f, n = _extents(3, 1500, True, seed=7)
    f = torch.as_tensor(f)
    g = torch.Generator().manual_seed(1)
    state = {"x": torch.randn(3, 1500, generator=g, dtype=torch.float64),
             "id": torch.randint(0, 1 << 40, (3, 1500), generator=g)}
    anc, moved = ops.resample_move_f_chains(f, state, 1500, version, guard_n=n)
    for r in range(3):
        a1, m1 = ops.resample_move_f(f[r].contiguous(), {k: v[r] for k, v in state.items()},
                                     1500, version, guard_n=n)
        assert torch.equal(anc[r], a1)
        for k in state:
            assert torch.equal(moved[k][r], m1[k]), k
