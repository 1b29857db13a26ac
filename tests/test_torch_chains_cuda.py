"""The chain-axis kernels and the batched sweep on the card.

Needs a CUDA device (marker ``cuda``; skips here) and imports no JAX, so it
runs on a GPU machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_chains_cuda.py

Row ``c`` of each chain-axis kernel is the one-chain kernel on row ``c`` bit
for bit, and within the one-chain tolerances of the batched plain version;
a batched ensemble on the card holds the flip contract against the loop.
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
