"""The port's Lévy-driven Langevin SSM against the plain reference of the
``levy`` configuration (``benchmark/configs/levy.py``) on the CPU.

At N = 4096 and the configuration's K = 64: the keyed draws, the prior and
the step on the same keys, and the move by a systematic resampling; a gated
sweep of T = 200 through ``sample_smc`` against the reference sweep, under
the ``levy-smc`` cell's limits, and the reference in bfloat16 outside them;
the K budget against the script's loop of jumps; and the two spans the
step records under a profiler."""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
stats = pytest.importorskip("scipy.stats")

from torch.func import vmap  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import random as prandom  # noqa: E402
from advancedps_tpu_torch import rng as rngmod  # noqa: E402
from advancedps_tpu_torch import tracing  # noqa: E402
from advancedps_tpu_torch.ops import resample as ops  # noqa: E402
from advancedps_tpu_torch.smc import SSMKernel  # noqa: E402
from benchmark import manifest  # noqa: E402
from benchmark.reference import cipher, compare, keyed, smc  # noqa: E402

N = 4096
KEY = (0x2F6B1C09, 0x9D33A1E7)
CELL = manifest.resolve("levy-smc")
CFG = CELL.config
REF = CELL.reference
K = CFG["max_jumps"]
#: float32 ulps apart that the state, the score and the transcendental draws
#: may be.  PyTorch's CPU kernels take log1p, exp, cos and sin through a
#: vectorised and a scalar routine, each within an ulp, and which elements
#: take which depends on the work's split among threads and on the layout
#: (vmap's or the reference's).  The mean's product, the covariance's einsum
#: and the factor are batched library calls over [N] under vmap and over
#: [1, N] in the reference, which may sum in another order.  (They agree
#: bitwise in one process on this CPU build, and on the card.)
ULPS = 4


@pytest.fixture(scope="module")
def ys():
    return torch.tensor(REF.simulate(CFG))


def _model():
    return apt.models.levy_ssm(**{k: CFG[k] for k in CFG["program"]["args"]})


def _ref_key(tag, t):
    k = cipher.step_key(KEY, tag, t)
    return torch.tensor([[k[0]]]), torch.tensor([[k[1]]])


def _close(got, want, floor=1.0):
    """``got`` within :data:`ULPS` float32 ulps of ``want``'s magnitude, or
    of ``floor`` where that is larger (a sum that cancels)."""
    ulp = torch.finfo(torch.float32).eps * want.abs().clamp_min(floor)
    assert ((got - want).abs() <= ULPS * ulp).all(), float((got - want).abs().max())


#: Each draw, the port's and the reference's, and whether it takes a
#: transcendental function (then within :data:`ULPS`, else bitwise).
DRAWS = {
    "split": (lambda k: prandom.split(k, 3), lambda k: torch.stack(
        [torch.stack(w, -1) for w in keyed.split(k, 3)], -2), False),
    "exponential": (lambda k: prandom.exponential(k, (K,)),
                    lambda k: keyed.exponential(k, K), True),
    "uniform": (lambda k: prandom.uniform(k, (K,)), lambda k: keyed.uniform(k, K), False),
    "uniform on [99.5, 100)": (
        lambda k: prandom.uniform(k, (K,), minval=99.5, maxval=100.0),
        lambda k: keyed.uniform(k, K, 99.5, 100.0), False),
    "normal": (lambda k: prandom.normal(k, (2,)), lambda k: keyed.normal(k, 2), True),
}


def test_the_references_wide_cipher_is_its_plain_cipher():
    # int32 words wrapping modulo 2^32, against the masked int64 cipher: bitwise,
    # keys with the top bit set included.
    g = torch.Generator().manual_seed(3)
    k0, k1 = (torch.randint(0, 2 ** 32, (512,), generator=g, dtype=torch.int64)
              for _ in range(2))
    want = cipher.threefry2x32(k0[:, None], k1[:, None], 0, torch.arange(K))
    got = keyed.threefry_wide((k0, k1), K)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("draw", list(DRAWS))
def test_a_keyed_draw_under_vmap_is_the_references(draw):
    # The same cipher words and the same float32 operations in order.
    port, ref, transcendental = DRAWS[draw]
    keys = rngmod.fold_in_ids(rngmod.Key(*KEY), torch.arange(N))
    got, want = vmap(port)(keys), ref((keys[:, 0], keys[:, 1]))
    if transcendental:
        _close(got, want, floor=0.0)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("t", [0, 1, 2, 100, 199])
def test_the_prior_and_a_step_on_the_same_keys_are_the_references(ys, t):
    kernel = SSMKernel(apt.TracedSSM(_model(), ys))
    gids = torch.arange(N)
    rng0 = rngmod.StepRng(rngmod.step_key(rngmod.Key(*KEY), rngmod.INIT, 0), gids)
    x0, logw0 = kernel.init(rng0, None, None)
    rx0, rlogw0 = REF.init(CFG, _ref_key(cipher.INIT, 0), gids, ys[0], torch.float32)
    # The prior is one Box-Muller pair an id, its factor the identity.
    _close(x0, rx0[0])
    _close(logw0, rlogw0[0])
    if t == 0:
        return
    rng_t = rngmod.StepRng(rngmod.step_key(rngmod.Key(*KEY), rngmod.PROPAGATE, t), gids)
    x, score = kernel.step(t, rng_t, x0, None, None)
    rx, rscore = REF.step(CFG, t, _ref_key(cipher.PROPAGATE, t), gids, rx0, ys[t],
                          torch.float32)
    assert x.shape == (N, 2) and torch.isfinite(x).all()
    _close(x, rx[0])
    _close(score, rscore[0])


def test_the_move_of_a_systematic_resampling_is_the_references():
    g = torch.Generator().manual_seed(11)
    x = torch.randn(N, 2, generator=g)
    logw = 3.0 * torch.randn(N, generator=g)
    m = torch.max(logw)
    e = torch.exp(logw - m)
    s1 = torch.sum(e)
    u = 0.3712
    f = ops.extents_from_logw_ref(logw, m, s1, u, N)
    anc, moved = ops.resample_move_f(f, x, N)
    ref_anc = smc.systematic(e[None], s1[None], torch.tensor([u]), N)
    # Ancestors from the same float32 extents, rows copied: bitwise.
    assert torch.equal(anc.long(), ref_anc[0])
    assert torch.equal(moved, REF.move(x[None], ref_anc)[0])
    assert REF.row_words(CFG) == 2 == moved.shape[-1]


@pytest.fixture(scope="module")
def sweeps(ys):
    """The program's gated sweep of ``levy-smc`` at N = 4096 through the cell's
    driver, and the reference sweep on the same keys."""
    traffic = {**CELL.traffic, "particles": N}
    call = CELL.driver.make(apt, apt.TracedSSM(_model(), ys), traffic, torch.device("cpu"))
    k = cipher.fold_in(cipher.key(2 ** 31 + 4099), 0)
    logz, ess, fired = call(k)
    ref = smc.sweep(REF, CFG, ys, [k], N, traffic["threshold"])
    return {"program": (logz, ess, fired), "ref": ref, "key": k,
            "threshold": traffic["threshold"]}


@pytest.mark.parametrize("side", ["program", "bfloat16 control"])
def test_a_gated_sweep_is_within_the_cells_limits_and_its_control_is_not(ys, sweeps, side):
    ref = sweeps["ref"]
    assert 0 < int(ref.resampled.sum()) < CFG["num_steps"] - 1
    if side == "program":
        got = compare.numbers(*sweeps["program"], ref)
        assert all(got[n] <= limit for n, limit in CELL.limits.items()), got
    else:
        ctl = smc.sweep(REF, CFG, ys, [sweeps["key"]], N, sweeps["threshold"],
                        dtype=torch.bfloat16)
        got = compare.numbers(ctl.log_evidence, ctl.ess, ctl.resampled, ref)
        assert any(got[n] > limit for n, limit in CELL.limits.items()), got


def test_the_jump_budget_holds_the_scripts_loop_of_jumps():
    ids = torch.arange(N)
    totals, last = [], []
    for t in (1, 100, 199):
        k_path, _ = keyed.split(cipher.particle_keys(_ref_key(cipher.PROPAGATE, t), ids), 2)
        sizes, mask, _ = REF.jump_path(CFG, t, k_path)
        totals.append(torch.where(mask, sizes, 0.0).sum(-1).flatten().double())
        last.append(sizes[..., -1].flatten())
    # Sizes fall with the arrival time, so no candidate past the K-th, which
    # lies below tol, is kept.
    assert float(torch.cat(last).max()) < CFG["tol"]
    g = np.random.default_rng(20)
    paths = [REF.gamma_path(g, CFG, 0.0, CFG["dt"]) for _ in range(3 * N)]
    assert max(arrivals for _, _, arrivals in paths) < K
    script = np.array([jumps[jumps >= CFG["tol"]].sum() for jumps, _, _ in paths])
    budget = torch.cat(totals).numpy()
    # Both are the Gamma process's increment over dt: mean C dt / beta.
    assert stats.ks_2samp(budget, script).pvalue > 0.01
    assert abs(budget.mean() - CFG["C"] * CFG["dt"] / CFG["beta"]) < 0.02


PATHS = ["one chain", "chains"]


def _levy_sweep(path, steps=6, n=256):
    ys = torch.tensor(REF.simulate(CFG))[:steps]
    key = rngmod.key(5)
    if path == "chains":
        key = rngmod.chain_keys(key, 2)
    resampler = apt.SMC(n, threshold=0.5).resampler
    kernel = SSMKernel(apt.TracedSSM(_model(), ys))
    return apt.sweep(key, kernel, n, resampler, device="cpu")


@pytest.mark.parametrize("path", PATHS)
def test_a_levy_step_records_its_path_then_its_draw_inside_its_propagate_score(path):
    steps = 6
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _levy_sweep(path, steps)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith(tracing.PREFIX))
    counts = collections.Counter(name for _, _, name in spans)
    assert counts["aps.jump_path"] == counts["aps.factor_draw"] == steps - 1
    assert counts["aps.propagate_score"] == steps - 1
    for lo, hi, name in spans:
        if name != "aps.propagate_score":
            continue
        inner = [(a, b, n) for a, b, n in spans if lo < a and b <= hi]
        assert [n for _, _, n in inner] == ["aps.jump_path", "aps.factor_draw"]
        assert inner[0][1] <= inner[1][0]


@pytest.mark.parametrize("path", PATHS)
def test_with_no_profiler_the_levy_step_never_enters_record_function(path, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(tracing, "record_function", refuse)
    off = _levy_sweep(path)
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        on = _levy_sweep(path)
    for field in ("log_evidence", "ancestors", "ess", "resampled"):
        assert torch.equal(getattr(on, field), getattr(off, field)), field


def test_the_configuration_names_what_the_builder_takes():
    dyn = _model().dynamics
    assert dyn.process.max_jumps == CFG["max_jumps"] == K
    assert dyn.process.tol == CFG["tol"] and dyn.jitter == CFG["jitter"]
    assert float(dyn.dt) * CFG["num_steps"] == 100.0
