"""The Lévy jump path's kernel layer (``ops.levy``) on the CPU.

The kernel itself runs only on the card (``test_torch_levy_cuda.py``).  Held
here:

* on the CPU, ``LevyLangevinDynamics.sample`` and ``log_prob`` never build or
  load the CUDA library, and their results are the plain chain's, bitwise;
* the wrapper's refusals of shapes, dtypes, devices and the key layout come
  before any load of the library;
* the batching rule: ``vmap`` over particles, and over chains of that, is one
  call on the flattened batch of keys, each key's result where the loop of
  one-key calls puts it;
* the chunk width of PyTorch's cumsum that the wrapper hands the kernel
  against a transcription of ``get_log_num_threads_x_inner_scan``
  (``ATen/native/cuda/ScanUtils.cuh``) in uint32 arithmetic, for rows 1 to
  2**22;
* the kernel's candidate budget against the source.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import random as rnd  # noqa: E402
from advancedps_tpu_torch import rng as R  # noqa: E402
from advancedps_tpu_torch.ops import _build  # noqa: E402
from advancedps_tpu_torch.ops import levy as L  # noqa: E402

vmap = torch.func.vmap
NO_VMAP_LOOP = pytest.mark.filterwarnings("error:There is a performance drop:UserWarning")


def _refuse(*args, **kwargs):
    raise AssertionError("the CUDA library was asked for")


@pytest.fixture
def no_library(monkeypatch):
    monkeypatch.setattr(_build, "library", _refuse)
    monkeypatch.setattr(_build, "build", _refuse)


def _path_keys(n, seed=3):
    return rnd.split(R.particle_keys(R.key(seed), R.PROPAGATE, 5, n, device="cpu"))[..., 0, :]


# ---------------------------------------------------------------------------
# The CPU keeps the plain chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [1, 2, 100])
def test_cpu_meancov_is_the_plain_chain(no_library, step):
    dyn = apt.models.levy_ssm(dt=0.5, mu_w=0.7).dynamics
    keys = _path_keys(33)
    got = vmap(lambda k: dyn._meancov(k, step))(keys)
    want = vmap(lambda k: dyn._meancov_plain(k, step))(keys)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    shared = R.fold_in(R.key(dyn.score_seed), step)
    got = dyn._meancov(shared, step)
    want = dyn._meancov_plain(rnd.key_tensor(shared, "cpu"), step)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cpu_sample_and_log_prob_never_reach_the_library(no_library, monkeypatch):
    """A gated sweep (``sample``) and a PGAS iteration on its trajectory
    (``log_prob``, the shared key) with the library refused, bitwise the same
    with ``_meancov`` replaced by the plain chain."""
    model = apt.models.levy_ssm(dt=0.5)
    _, ys = apt.simulate(R.key(1), model, 12)
    traced = apt.TracedSSM(model, ys)

    def run():
        smc = apt.sample(R.key(2), traced, apt.SMC(64), device="cpu")
        chain = apt.sample(R.key(3), traced, apt.PGAS(16), 2, device="cpu")
        return [smc.log_evidence, smc.weights, smc.trajectories, chain.log_evidence,
                chain.trajectory]

    got = run()
    dyn = model.dynamics
    monkeypatch.setattr(dyn, "_meancov", dyn._meancov_plain)
    want = run()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert L.meancov.launches == 0


# ---------------------------------------------------------------------------
# Refusals, before any load of the library
# ---------------------------------------------------------------------------


def _args(**over):
    p = {name: torch.tensor(v) for name, v in
         (("dt", 0.5), ("theta", -0.5), ("c", 1.0), ("beta", 1.0), ("mu_w", 0.0), ("sigma_w", 1.0))}
    args = dict(key=torch.zeros(4, 2, dtype=torch.int64), step=3, **p, tol=1e-10, jitter=1e-6,
                jumps=64)
    args.update(over)
    return args


REFUSALS = {
    "int32 keys": (dict(key=torch.zeros(4, 2, dtype=torch.int32)), TypeError),
    "a host key": (dict(key=R.key(3)), TypeError),
    "three words a key": (dict(key=torch.zeros(4, 3, dtype=torch.int64)), ValueError),
    "a 0-dim key": (dict(key=torch.zeros((), dtype=torch.int64)), ValueError),
    "a float64 parameter": (dict(theta=torch.tensor(-0.5, dtype=torch.float64)), TypeError),
    "a parameter of two values": (dict(beta=torch.ones(2)), TypeError),
    "a Python float parameter": (dict(dt=0.5), TypeError),
    "CPU tensors": ({}, ValueError),
    "a tensor step": (dict(step=torch.tensor(3)), TypeError),
    "a bool step": (dict(step=True), TypeError),
    "no candidates": (dict(jumps=0), ValueError),
    "more candidates than the kernel holds": (dict(jumps=L.MAX_JUMPS + 1), ValueError),
    "an int tolerance": (dict(tol=0), TypeError),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_wrapper_refuses_before_any_load(no_library, name):
    over, error = REFUSALS[name]
    with pytest.raises(error):
        L.meancov(**_args(**over))


# ---------------------------------------------------------------------------
# The batching rule, with the launch replaced by a stand-in
# ---------------------------------------------------------------------------


def _stand_in(calls):
    """A stand-in for the launch: each key's words as its mean, their sum
    on the covariance's diagonal, the call's shape recorded."""

    def run(key, step, *rest):
        calls.append((tuple(key.shape), step))
        w = key.to(torch.float32)
        mu = w + step
        cov = torch.diag_embed(w.sum(-1, keepdim=True).expand(w.shape))
        return mu, cov

    return run


@NO_VMAP_LOOP
@pytest.mark.parametrize("nest", ["particles", "chains of particles", "unbatched"])
def test_batching_rule_is_one_call_on_the_flattened_keys(no_library, monkeypatch, nest):
    calls = []
    monkeypatch.setattr(L, "_meancov", _stand_in(calls))
    monkeypatch.setattr(L, "_check", lambda *a: None)
    args = _args()
    rest = [args[k] for k in ("dt", "theta", "c", "beta", "mu_w", "sigma_w", "tol", "jitter",
                              "jumps")]
    keys = R.particle_keys(R.key(4), 0, 1, 4 * 6, device="cpu").reshape(4, 6, 2)

    def one(k):
        return L.meancov(k, 7, *rest)

    if nest == "particles":
        keys = keys[0]
        got = vmap(one)(keys)
        shape = (6, 2)
    elif nest == "chains of particles":
        got = vmap(vmap(one))(keys)
        shape = (4, 6, 2)
    else:
        keys = keys[0, 0]
        got = one(keys)
        shape = (2,)
    assert calls == [(shape, 7)]
    calls.clear()
    flat = keys.reshape(-1, 2)
    want = [one(k) for k in flat]
    assert torch.equal(got[0].reshape(-1, 2), torch.stack([m for m, _ in want]))
    assert torch.equal(got[1].reshape(-1, 2, 2), torch.stack([c for _, c in want]))


def test_batching_rule_refuses_batched_parameters(no_library, monkeypatch):
    monkeypatch.setattr(L, "_meancov", _stand_in([]))
    monkeypatch.setattr(L, "_check", lambda *a: None)
    args = _args()
    keys = torch.zeros(3, 2, dtype=torch.int64)
    with pytest.raises(ValueError, match="parameters"):
        vmap(lambda k, th: L.meancov(k, 3, args["dt"], th, args["c"], args["beta"],
                                     args["mu_w"], args["sigma_w"], 1e-10, 1e-6, 64))(
            keys, torch.full((3,), -0.5))


# ---------------------------------------------------------------------------
# The scan's chunk width; the candidate budget
# ---------------------------------------------------------------------------


def _log_threads_x(rows: np.ndarray, row_size: int) -> np.ndarray:
    """``get_log_num_threads_x_inner_scan<uint32_t>`` over an array of row
    counts, line by line."""
    u = np.uint32
    log_x = 0
    while (1 << log_x) < row_size:
        log_x += 1
    log_y = np.zeros(rows.shape, np.uint32)
    while True:
        short = (np.left_shift(u(1), log_y, dtype=np.uint32)) < rows
        if not short.any():
            break
        log_y += short.astype(np.uint32)
    with np.errstate(over="ignore"):
        diff = (u(log_x) - log_y).astype(np.uint32)
        out = ((u(9) + diff).astype(np.uint32)) // u(2)
    return np.minimum(np.maximum(u(4), out), u(9))


@pytest.mark.parametrize("row_size", [16, 33, 64])
def test_scan_chunk_is_pytorchs(row_size):
    """Every row count to 2**22 at the cell's K = 64; around each power of
    two for the others."""
    if row_size == 64:
        rows = np.arange(1, (1 << 22) + 1, dtype=np.uint32)
    else:
        rows = np.unique([max(1, (1 << j) + d) for j in range(23) for d in (-1, 0, 1)]
                         ).astype(np.uint32)
    want = 2 << _log_threads_x(rows, row_size).astype(np.int64)
    got = np.array([L.scan_chunk(int(r), row_size) for r in rows])
    assert got[0] == 0  # one row: CUB's scan
    np.testing.assert_array_equal(got[1:], want[1:])


def test_cell_rows_take_one_tree():
    """At the cell's 2M rows the chunk is 1024 columns, one tree over K = 64;
    from 33 to 32,768 rows it is 32, two trees."""
    assert L.scan_chunk(2 * 2**20, 64) == 1024
    assert [L.scan_chunk(r, 64) for r in (2, 8, 9, 32, 33, 32768, 32769)] == \
        [256, 128, 64, 64, 32, 32, 1024]


def test_max_jumps_is_the_sources():
    src = (Path(_build.SRC_DIR) / "levy.cu").read_text()
    assert int(re.search(r"constexpr int kMaxJumps = (\d+);", src).group(1)) == L.MAX_JUMPS
    assert "aps_levy_meancov" in _build._SIGNATURES
