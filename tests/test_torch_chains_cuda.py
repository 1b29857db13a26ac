"""The chain-axis kernels and the batched sweep on the card.

Needs a CUDA device (marker ``cuda``; skips here) and imports no JAX, so it
runs on a GPU machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_chains_cuda.py

Row ``c`` of each chain-axis kernel (B1, B6, B4 and B4 over leaves; B2, B3,
B5, B7 and B8) is the one-chain kernel on row ``c`` bit for bit, and within
the one-chain tolerances of the batched plain version; B3 is bitwise its
plain version at one, three, four and 50 columns, C = 1, 8 and 64, on rows of
every alignment and on unaligned slices; a batched ensemble on the card, with
systematic and with residual resampling, holds the flip contract against the
loop.
"""

import pytest

torch = pytest.importorskip("torch")

import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import rng as R  # noqa: E402
from advancedps_tpu_torch.ops import resample as ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _case(c, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    logw = torch.randn(c, n, generator=g, device="cuda") * 2.0
    m = torch.amax(logw, -1)
    s1 = torch.sum(torch.exp(logw - m[:, None]), -1)
    u = torch.rand(c, generator=g, device="cuda")
    return g, logw, m, s1, u


@pytest.mark.parametrize("c,n", [(3, 5000), (8, 2048 * 3 + 1), (1, 100_000), (5, 7)])
@pytest.mark.parametrize("guarded", [False, True])
def test_chain_kernels_rows_are_the_one_chain_kernels(c, n, guarded):
    g, logw, m, s1, u = _case(c, n, c * n)
    nd = n - 1 if guarded else n
    f = ops.extents_from_logw_chains(logw, m, s1, u, nd)
    f_ref = ops.extents_from_logw_chains_ref(logw, m, s1, u, nd)
    assert int((f.long() - f_ref.long()).abs().max()) <= 1
    assert bool((f[:, 1:] >= f[:, :-1]).all())
    scale = nd / s1
    p = ops.scaled_prefix_from_logw_chains(logw, m, scale)
    e = torch.exp(logw - m[:, None])
    ps = ops.prefix_sum_chains(e)
    x = torch.randn(c, n, generator=g, device="cuda")
    w = torch.randn(c, n, 3, generator=g, device="cuda")
    k = torch.randint(0, 1 << 30, (c, n), generator=g, device="cuda", dtype=torch.int32)
    a, mv = ops.decode_move_chains(f, x, n, guard=nd)
    al, (mx, mw, mk) = ops.decode_move_leaves_chains(f, [x, w, k], n, guard=nd)
    ar, mr = ops.decode_move_chains_ref(f, x, n, guard=nd)
    assert torch.equal(a, ar) and torch.equal(mv.view(torch.int32), mr.view(torch.int32))
    assert torch.equal(a, al) and torch.equal(mv, mx)
    for r in range(c):
        assert torch.equal(f[r], ops.extents_from_logw(logw[r], m[r], s1[r], float(u[r]), nd))
        assert torch.equal(p[r], ops.scaled_prefix_from_logw(logw[r], m[r], scale[r]))
        assert torch.equal(ps[r], ops.prefix_sum(e[r].contiguous()))
        a1, v1 = ops.decode_move(f[r].contiguous(), x[r], n, guard=nd)
        assert torch.equal(a[r], a1) and torch.equal(mv[r], v1)
        a2, (w2, k2) = ops.decode_move_leaves(f[r].contiguous(), [w[r], k[r]], n, guard=nd)
        assert torch.equal(al[r], a2) and torch.equal(mw[r], w2) and torch.equal(mk[r], k2)


@pytest.mark.parametrize("c,n", [(3, 5000), (8, 2048 * 3 + 1), (1, 100_000), (5, 7)])
@pytest.mark.parametrize("guarded", [False, True])
def test_decode_move_and_count_chain_rows_are_the_one_chain_kernels(c, n, guarded):
    """B2, B3, B5, B7 and B8 with the chain axis: exact against their batched
    plain versions, each row bitwise the one-chain kernel, B5's marks zero
    after the call, B7 and B8 on rows of s n + 1 apart as the engine's."""
    g, logw, m, s1, u = _case(c, n, c * n + 1)
    nd = n - 1 if guarded else n
    f = ops.extents_from_logw_chains(logw, m, s1, u, nd)
    a2 = ops.decode_ancestors_chains(f, n, guard=nd)
    a5 = ops.decode_ancestors_dense_chains(f, n, guard=nd)
    assert all(int(mk.count_nonzero()) == 0 for mk in ops._DENSE_MARKS.values())
    assert torch.equal(a2, ops.decode_ancestors_chains_ref(f, n, guard=nd))
    assert torch.equal(a5, ops.decode_ancestors_dense_chains_ref(f, n, guard=nd))
    x = torch.randn(c, n, generator=g, device="cuda")
    w = torch.randn(c, n, 3, generator=g, device="cuda")
    moved = [(v, ops.move_rows_chains(a2, v)) for v in (x, w)]
    for v, (ac, mv) in moved:
        rac, rmv = ops.resample_move_chains_ref(a2, v)
        assert torch.equal(ac, rac) and torch.equal(mv.view(torch.int32), rmv.view(torch.int32))
    S = ops.prefix_sum_chains(-torch.log1p(-torch.rand(c, n + 1, generator=g, device="cuda")))
    s = S[:, :nd]
    thr = ops.scaled_prefix_from_logw_chains(logw, m, S[:, nd] / s1)
    b7 = ops.count_le_sorted_bs_chains(s, thr)
    b8 = ops.count_le_sorted_chains(s, thr)
    want = ops.count_le_sorted_chains_ref(s, thr)
    assert torch.equal(b7, want) and torch.equal(b8, want)
    for r in range(c):
        assert torch.equal(a2[r], ops.decode_ancestors(f[r], n, guard=nd))
        assert torch.equal(a5[r], ops.decode_ancestors_dense(f[r], n, guard=nd))
        for v, (ac, mv) in moved:
            ac1, mv1 = ops.move_rows(a2[r], v[r])
            assert torch.equal(ac[r], ac1) and torch.equal(mv[r], mv1)
        assert torch.equal(b7[r], ops.count_le_sorted_bs(s[r], thr[r]))
        assert torch.equal(b8[r], ops.count_le_sorted(s[r], thr[r]))


def test_batched_ensemble_on_the_card_holds_the_flip_contract():
    model = apt.models.stationary_lgssm(a=0.9, q=0.32, r=1.0)
    _, ys = apt.simulate(torch.Generator().manual_seed(0), model, 30)
    kernel = apt.SSMKernel(apt.TracedSSM(model, ys).to("cuda"))
    rs = apt.SMC(20_000).resampler
    key = R.key(3)
    ops.reset_launch_counts()
    res = apt.sweep(R.chain_keys(key, 4), kernel, 20_000, rs, store_states=False)
    fired = int(res.resampled.any(0).sum())
    assert ops.extents_from_logw_chains.launches == fired > 0
    assert ops.decode_move_chains.launches == fired
    for c in range(4):
        one = apt.sweep(R.fold_in(key, c), kernel, 20_000, rs, store_states=False)
        same = res.ancestors[c] == one.ancestors
        flips = (~same).sum(1)
        first = int(torch.argmax((flips > 0).int())) if bool(flips.any()) else 30
        assert torch.equal(res.resampled[c, :first + 1], one.resampled[:first + 1])
        assert abs(float(res.log_evidence[c]) - float(one.log_evidence)) < 0.2


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("c", [1, 8, 64])
@pytest.mark.parametrize("d", [1, 3, 4, 50])
def test_move_rows_on_every_geometry_is_the_plain_version(c, d):
    """B3 with the chain axis at C = 1, 8 and 64 on D columns: bitwise its
    plain version and, row by row, the one-chain kernel, with slots past the
    drawn population (anc == M), n_out no multiple of four (every row starts
    at another alignment) and, for one chain, unaligned slices of anc and v."""
    g = torch.Generator(device="cuda").manual_seed(c * 100 + d)
    for m, n_out in ((4099, 4099), (5000, 3), (1, 2047), (2048, 2048 * 3 + 5)):
        anc = torch.randint(0, m + 1, (c, n_out), generator=g, device="cuda", dtype=torch.int32)
        anc[:, ::7] = m
        shape = (c, m) if d == 1 else (c, m, d)
        v = torch.randn(shape, generator=g, device="cuda")
        ac, mv = ops.move_rows_chains(anc, v)
        rac, rmv = ops.resample_move_chains_ref(anc, v)
        assert torch.equal(ac, rac) and torch.equal(_bits(mv), _bits(rmv)), (m, n_out)
        for r in range(c):
            ac1, mv1 = ops.move_rows(anc[r], v[r])
            assert torch.equal(ac[r], ac1) and torch.equal(_bits(mv[r]), _bits(mv1))
        ai = torch.randint(0, 1 << 30, shape, generator=g, device="cuda", dtype=torch.int32)
        assert torch.equal(ops.move_rows_chains(anc, ai)[1], ops.resample_move_chains_ref(anc, ai)[1])
        flat_a = torch.randint(0, m + 1, (n_out + 3,), generator=g, device="cuda",
                               dtype=torch.int32)
        flat_v = torch.randn(m * d + 3, generator=g, device="cuda")
        for shift in (1, 2, 3):
            a1 = flat_a[shift:shift + n_out]
            v1 = flat_v[shift:shift + m * d]
            v1 = v1 if d == 1 else v1.view(m, d)
            got, want = ops.move_rows(a1, v1), ops.resample_move_ref(a1, v1)
            assert torch.equal(got[0], want[0]) and torch.equal(_bits(got[1]), _bits(want[1]))


def test_batched_residual_on_the_card_moves_by_b3_and_holds_the_flip_contract():
    model = apt.models.stationary_lgssm(a=0.9, q=0.32, r=1.0)
    _, ys = apt.simulate(torch.Generator().manual_seed(0), model, 30)
    kernel = apt.SSMKernel(apt.TracedSSM(model, ys).to("cuda"))
    rs = apt.ResampleWithESSThreshold(apt.resample_residual)
    key = R.key(4)
    ops.reset_launch_counts()
    res = apt.sweep(R.chain_keys(key, 4), kernel, 20_000, rs, store_states=False)
    fired = int(res.resampled.any(0).sum())
    assert ops.move_rows_chains.launches == fired > 0 and ops.move_rows.launches == 0
    assert ops.prefix_sum_chains.launches == 2 * fired and ops.prefix_sum.launches == 0
    for c in range(4):
        one = apt.sweep(R.fold_in(key, c), kernel, 20_000, rs, store_states=False)
        same = res.ancestors[c] == one.ancestors
        flips = (~same).sum(1)
        first = int(torch.argmax((flips > 0).int())) if bool(flips.any()) else 30
        assert torch.equal(res.resampled[c, :first + 1], one.resampled[:first + 1])
        assert abs(float(res.log_evidence[c]) - float(one.log_evidence)) < 0.2
