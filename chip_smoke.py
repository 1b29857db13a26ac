"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero before the
final line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build the CUDA kernels from ``advancedps_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card at M = N = 1M,
   on four weight profiles and the guard case (N−1 positions drawn): B1-B3,
   B4 and B5 and the windowed B2 (whole population, the four windows of
   K = 4 shards of L = 250,000, and the 3L-row form of the neighbour
   exchange; bitwise), B6 (both modes, within 1 ulp and bitwise
   nondecreasing), B7 and B8 (exact against the plain version: the scheme's
   thresholds, every threshold one value, every threshold inside one gap,
   heavy ties, ns ≠ nt from unaligned slices, thresholds below and above all
   of s and +inf, and for B7 unsorted thresholds and NaN); and B7 and B8 at
   the edges of their own geometry, read back from the built library: sizes
   one short of, equal to and one past a tile, a tile whose run of s is one
   short of, exactly and one past the staging buffer from an unaligned start,
   a merge tile that holds entries of s alone or thresholds alone; B2, B4 and
   B5 at the edges of each one's geometry (slot counts around a tile, an owner
   run around the staging buffer from an aligned and an unaligned ``f``, one
   row owning every slot, every row owning one, all extents 0 but the guard,
   many rows of one extent, the guard case; for B2 and B4 each also as a
   window whose start is no multiple of the tile; B4 on one, three and four
   columns and on rows and outputs that are no 16-byte aligned slices, bitwise
   its plain version and B2 + B3; exact); B5 twice, in turn with B1 and B6 on
   one stream and beside B1 on a second stream, with slots fewer and more
   than rows, and at 16M; and the scan of B1 and B6 at lengths around a tile, a
   group of 32 tiles and 32 groups, at 1M and at 16M (within the plain
   versions' tolerances, nondecreasing, two calls bitwise equal); B4 over
   leaves at 1M (leaves [N], [N, 2], [N, 100] and an int32 [N] in one launch,
   nine leaves in two, unaligned rows; whole, guarded and windowed) bitwise
   its plain version and B4 a leaf; and the kernels with the chain axis (B1,
   B6 in both modes, B4 and B4 over leaves; B2, B3, B5, B7 and B8) at C x N
   = 8 x 1M, 64 x 16,384, 1 x 1M and 7 x 100,003, for n = N and the guard
   case: within their batched plain versions' tolerances (B2-B5, B7 and B8
   exact or bitwise), each row bitwise the one-chain kernel on that row, B5's
   marks zero after every call, B7 and B8 on the engine's rows of
   ``S[:, :n]`` (n + 1 apart), the rows of chains whose flag is off kept by
   the sweep's ``where``, and B4 on a chain that lies past 2**31 words; B3
   on each geometry of ``MOVE_GEOMETRIES`` (one, three and 50 columns; C = 1,
   8 and 64; n_out no multiple of four, so that a chain's row starts at any
   alignment; ancestors random and sorted, every seventh past the drawn
   population; float32 and int32 rows), bitwise its plain version and row by
   row the one-chain kernel, and for one chain on slices one to three words
   off 16-byte alignment; and the positional Threefry's four kernels
   (``csrc/threefry.cu``) at 1M, at 8 x 1M on the chain axis, at 100,003 ids
   from an odd one, at ids past 2**32, on int32 ids and on an offset slice:
   the cipher words and the uniforms bitwise their plain versions, the
   normals within ``NORMAL_ULPS`` (the largest gap printed), and each
   batching rule under ``torch.func.vmap`` (chain words, chain words and ids,
   particle keys, nested) bitwise the loop of one-key calls, in one launch;
   and the Lévy jump path's kernel (``csrc/levy.cu``) against the plain
   chain, mean and covariance bitwise at 1M keys (steps 1, 100, 199; mu_w 0
   and 0.7), at 4 x 65,536 as nested ``vmap`` and on the unbatched shared
   key, one launch each (phase 7 times it at 1M against its int32 bound);
4. the SMC flagship (stationary LGSSM a=0.9, q=0.32, r=1.0, T=100,
   N=1,000,000, resampling at ESS ≤ N/2) through ``sample`` with each fused
   scheme — systematic, stratified, multinomial, and multinomial with the
   B8 merge-count — anchored to the exact Kalman log-likelihood, with each
   kernel's launch count equal to what the scheme runs per firing times the
   firings, and a bitwise repeat (systematic through the default device, no
   ``device`` named); the multinomial sweeps on B7 and on B8 bitwise equal to
   each other and at the |logZ − Kalman| recorded for the kernels they
   replaced; then the systematic flagship under each move version (1: B4,
   the default; 6: B2 + B3; 0: B5 + a gather), bitwise equal;
5. the sharded flagship on K = 4 logical shards of the card
   (``parallel.sharded_sweep``) with each exchange, against Kalman and the
   single-device sweep (equal until the first firing whose Σe, summed in
   another order, moves an extent; there every differing ancestor is off by
   one), ``auto`` against ``neighbor`` and move version 6 against the
   default 1, bitwise;
6. PGAS at N=1M, T=100 with replay storage (``bench_pgas.py``'s
   configuration): one chain of 8 iterations, the final iteration's logZ
   against Kalman, 99 launches of B1 and B4 per iteration (the RTS anchor over
   6 such chains is phase 11's pgas mode); short
   PGAS chains with multinomial (logZ bitwise what the chain on the earlier
   B7 gave) and stratified; replay against dense storage;
   then sharded PGAS (K = 4, replay, ``auto``) and sharded chains on a 2 × 2
   chain mesh;
7. timings: the median of 5 sweeps per scheme and of a never-firing base,
   the sharded sweep's median beside the single-device one and its exchange
   time per firing, PGAS iterations/s (single-device and sharded), and a
   profiled sharded sweep for the device busy share (the single-device
   sweep's and a PGAS iteration's profiles are phase 12's).  For each kernel at 1M: its
   device time (the profiler's device-side rows over a window of REPS calls,
   every launch of the call summed) and the device-side launches a call makes
   (1 for B1, B2, B4 and B6, at most 2 for B5, or the phase fails), the same
   time for its plain version and, where one PyTorch call computes the same
   function, for that call; the time per call by CUDA events, wrapper and host
   included (plain, kernel, kernel, plain); the bytes it must move and the
   least time they take at the card's memory rate (a move counting only the
   rows that own a slot: B3, B4, and B4 over leaves at 1 + 2 + 100 + 1 words
   a row and on the GP-SSM's state; B4 also on phase 9's ``[100k, 50]``
   generic state, beside B2 + ``index_select``); the kernels with the chain
   axis at 8 x 1M (B2, B5, B7 and B8 beside a batched ``searchsorted``, B3
   beside ``gather``), and B1-B5, B7 and B8 with it at 8 x 1M and 64 x 16,384
   beside C launches of the one-chain kernel; B3 also on three columns at
   1M and on phase 9's ``[100k, 50]`` state, L2-warm and L2-cold beside
   ``index_select``; and one residual firing step (the draw for C chains from
   their keys on the card, then B3 with the chain axis): its device-side
   launches for C = 1, 4 and 64 at 1M and at 16,384, equal at C = 4 and 64,
   beside the loop of one-chain draws it replaced at 4 x 1M; the Lévy jump
   path's kernel at 1M keys beside the plain chain, against its int32 bound;
   and each Threefry kernel at 1M and 8 x 1M (L2-warm, L2-cold, one launch a call, the plain
   version, per call by events, its bound: bytes or BLOCK_OPS int32
   operations for each distinct block the ids need, whichever takes longer).  The inputs are the same
   tensors on every call, as in the sweep, where each was written by the step
   before: they sit in the 50 MB L2, so the readings are L2-warm.  A second
   window takes each kernel L2-cold, on 128 MB of copies of its inputs in
   turn.  The bound is the device memory's: a cold time below it fails the
   phase.  A warm time may pass it, the L2 being faster than the memory behind
   it, and is held to the L2's ceiling instead (``L2_BYTES_PER_S``); a warm
   share above 1 is printed.  Then the move versions in turns (6, 1, 0, 0, 1,
   6): the device time of one firing's decode + move on one and on three
   columns, and the median of 5 systematic sweeps under each;
8. the model families at N=1M, T=100 through ``sample`` with no device named
   (systematic at ESS ≤ N/2): the stochastic-volatility model (a=0.9, q=0.5),
   the Lévy SSM (state [N, 2], 64 jumps, dt=0.5; T = 100, ``LEVY_STEPS``) and
   the GP-SSM (state (x [N], history [N, 100])): finite logZ, B1 and the decode + move on every
   firing (B4 over leaves ⌈leaves / 8⌉ times for the GP-SSM), the sweep time
   (median of 3; one for Lévy), launches a step and the device busy share of
   a profiled sweep; PGAS (2 iterations, replay) and the sharded sweep (K = 4)
   of each model at 1M, with their launch counts; then the
   statistical contracts at the JAX tests' sizes: the SV PGAS update rate
   (N=20, T=60, 100 iterations, the JAX test's 150 cut: mean > (1 − 1/N) −
   0.1, PG's early third 0.3 below PGAS's), GP-SSM PG (N=20, T=100, 3
   iterations) and Lévy PGAS
   (N=50, T=200, 2 iterations), replay against dense storage within 1e-5 and
   1e-4;
9. the generic front-end, chain checkpoints and a mesh spanning processes:
   the LGSSM as a ``GenericModel`` program of T = 50 sample sites and 50
   observes at N = 100,000 (``profiling/bench_generic.py``'s harness, not
   cut) through ``sample`` with no device named, against Kalman (|logZ −
   Kalman| < 0.1) and beside the structured ``SSMKernel`` on the same ys
   (their sweep times are phase 12's ``bench generic``): B1 and B4 on every firing
   (its state ``[N, 50]``), launches a step and the busy share of a profiled
   sweep, with and without the early stop at a step's observe (bitwise the
   same sweep), PG with dense storage (3 iterations, finite), and B4 on one
   firing of the ``[100k, 50]`` state beside B2 + ``index_select`` (read in
   phase 7, before any profiled sweep); the two
   analytic −2·log 2 tests at their CPU sizes (PG's 100 iterations cut to 20),
   a multivariate site whose
   parameters lie on the CPU, a program that branches on a sampled value
   (by ``if`` and by ``.item()``) refused as mis-aligned, and a CPU sweep
   over parameters on the card, bitwise one over CPU parameters; a PGAS chain at 1M with replay storage
   checkpointed after 2 iterations and resumed for 2, bitwise the 4
   uninterrupted ones; and a child process that joins a process group as one
   NCCL rank (one card allows no more) with a K = 4 mesh, whose systematic
   sharded sweep at 1M must be bitwise phase 5's one-controller sweep;
10. independent chains as one batch on a leading chain axis, at the
   flagship's width: ``smc_ensemble`` of 8 systematic runs at 1M (each run's
   |logZ − Kalman| < 0.1; runs 0 and 7 against the one-chain sweep of their
   key, bitwise or within the flip contract of the sharded sweep; launches
   per firing step; the launches and busy share of one profiled sweep at 1
   chain, 8 chains of 1M and 64 of 16,384, the batched sweep's launches under
   1.5 x one chain's and not growing with C; its time beside 8 one-chain
   sweeps), the same ensemble under move versions 6 (B2 + B3) and 0 (B5 + a
   gather) bitwise the version-1 ensemble, each kernel once a firing step;
   stratified, multinomial and merge-path multinomial (B8) ensembles of 4 x
   1M, ``sample_chains``
   PGAS with replay storage for 64 chains of 16,384 (3 iterations: the RMS
   z-score of the pooled chain means against the RTS smoother < 3; chains 0,
   1, 2 and 63 run one at a time with ``sample_pg`` of their key, held
   against the batch and timed as the loop of one-chain calls beside its
   chain-iterations/s; a profiled iteration), multinomial PGAS for 64 chains
   of 16,384 (2 iterations: B7 once a step for all chains, its launches a
   firing step those of the 4-chain ensemble; an iteration timed and profiled
   in turns with B7 run once a chain, the loop it replaced) and for 4
   chains at 1M (2 iterations), and a GP-SSM ensemble of 4 x 65,536 (B4 over
   leaves with the chain axis); and residual resampling on the chain axis: an
   ensemble of 4 x 1M (each run's |logZ - Kalman| < 0.1, runs 0 and 3 under
   the flip contract against their one-chain sweeps, with extents off by at
   most ``TAIL_OFF`` for its iid tail, B6 twice and B3 once a
   firing step) and PGAS for 64 chains of 16,384 (2 iterations, replay: the
   same kernels a firing step, as at C = 4; chains 0, 1, 2 and 63 held against ``sample_pg`` of
   their key and timed as the loop of one-chain calls beside the batch's
   chain-iterations/s; the launches of a profiled iteration beside those of
   the loop it replaced, counted from phase 7's firing steps);
11. the five modes of ``advancedps_tpu_torch.bench`` at full size through its
   functions, no device named, each printing its JSON line: ``smc`` (the
   flagship, 5 timed sweeps), ``pgas`` (N=1M, replay; 2 timed windows of 8
   iterations, the mode's 5 cut, and its RTS anchor over 6 chains of 8
   iterations whole), ``scaling --mode overhead`` (262,144 particles on 1, 2,
   4 and 8 logical shards, T = 50), ``ensemble`` (8 x 1M) and ``chains`` (64
   PGAS chains of 16,384); each anchor must hold, the JSON line must name this
   card, and each run must launch its path's kernels and no other (B1 and B4,
   with the chain axis for a batch; exact counts where every step fires);
12. the profiling entry points at full size, no device named, each printing
   its JSON line; through their functions ``bench schemes`` for each of
   systematic, stratified and multinomial (every step firing, beside a
   never-firing base that must launch no kernel; exactly T − 1 launches a
   sweep of each kernel of the scheme's firing), ``bench generic`` (the
   T = 50 program at 100k beside ``SSMKernel``, B1 = B4 in both), and as
   commands ``python -m advancedps_tpu_torch.profiling sweep`` (its Chrome trace
   written to a temporary directory), ``pgas``, ``resample`` and ``moves``,
   each a process of its own: each anchor must hold, each component show
   device time and at least one device record a step, each
   faithfulness ratio lie in 0.5-1.5, the move versions agree bitwise on
   every extents profile, the JSON line name this card, and each run launch
   its path's kernels and no other.

Each launch count is read from the run of its own path, the counts set to 0
just before it: the resampling kernels' against what each firing runs, and
beside them the Threefry kernels' against what the path draws (``draws``,
``model_draws``, ``pgas_draws``: e.g. exactly T pos_normal launches a
flagship sweep, as many for a batch of chains as for one).  The last lines are the kernels' JSON record (launches summed
over the runs of phases 4-6 and 8-12, and per sweep and per PGAS iteration by path),
the card, and ``{"ok": true, "device": {...}}``.
Imports no JAX: the card's machine has none.
"""

from __future__ import annotations

import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity
from torch.profiler import profile as profiler_window  # main() has a local named profile

N = 1_000_000
T = 100
K = 4  # logical shards of the sharded phases
L = N // K
A, Q, R = 0.9, 0.32, 1.0
SIGMA0 = math.sqrt(Q * Q / (1 - A * A))
REPS = 20  # launches per timing window
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# The L2's ceiling, for L2-warm readings: 5120 bytes a clock (NVIDIA's figure
# for the A100's L2; none is published for the H100, which is no narrower) at
# the H100 SXM's 1.98 GHz boost clock.  About three times the memory's rate.
L2_BYTES_PER_S = 5120 * 1.98e9
# Kineto drops a device record whose timestamp, converted to the host's clock,
# falls outside the window, and that conversion is off by up to a few
# milliseconds in bursts: a window that closes right after its last launch now
# and then comes back short of records or empty.  So the window stays open this
# long before its first launch and after its last.
PROFILER_PAD_S = 0.02
COLD_BYTES = 128 << 20  # inputs cycled through per L2-cold window, over the 50 MB L2
SWEEPS = 5  # timed sweeps per scheme
PGAS_ITERS = 8  # bench_pgas.py:34-38
#: Timed windows of the bench's pgas mode in phase 11: the mode's 5 cut for the
#: script's time limit (its RTS anchor, 6 chains of 8 iterations, runs whole).
BENCH_PGAS_RUNS = 2
SHARDED_PGAS_ITERS = 3
CHAIN_ITERS = 3
#: The SV PGAS update-rate contract's iterations: the JAX test runs 150; cut to
#: 100 (2 chains of ~0.33 s an iteration on a slow host) for the script's time
#: limit once phase 10 came in.
SV_RATE_ITERS = 100
#: Steps of phase 8's Lévy runs at 1M (the flagship's T = 100) and of its
#: replay = dense check at N = 50 (the JAX test's T = 200): whole since the
#: jump path became one kernel (``csrc/levy.cu``).
LEVY_STEPS, LEVY_CHECK_STEPS = 100, 200
#: Iterations of phase 9's analytic PG(10) evidence (the CPU test's 100 cut:
#: every iteration's logZ is the exact −2·log 2).
ANALYTIC_PG_ITERS = 20
# The generic program of profiling/bench_generic.py: particles, observes, sites.
NG, TG, SG = 100_000, 50, 50
NCCL_CHILD_TIMEOUT_S = 300
#: Phase 12's limit on one profiling subcommand's process.
PROFILE_TIMEOUT_S = 300
SOURCE = "advancedps_tpu_torch/csrc/resample.cu"
TPU_FILE = "advancedps_tpu/ops/pallas_resample.py"
REPLACES = {
    "extents_from_logw": f"{TPU_FILE}:237",
    "decode_ancestors": f"{TPU_FILE}:972",
    "move_rows": f"{TPU_FILE}:1090",
    "decode_move": f"{TPU_FILE}:728",
    "decode_move_leaves": f"{TPU_FILE}:728",
    "decode_ancestors_dense": f"{TPU_FILE}:103",
    "scaled_prefix_from_logw": f"{TPU_FILE}:325",
    "prefix_sum": f"{TPU_FILE}:325",
    "count_le_sorted_bs": f"{TPU_FILE}:476",
    "count_le_sorted": f"{TPU_FILE}:516",
    # The chain axis: under the JAX package's vmap each pallas_call gains a
    # grid axis, so these replace the same functions over [C, N].
    "extents_from_logw_chains": f"{TPU_FILE}:237",
    "scaled_prefix_from_logw_chains": f"{TPU_FILE}:325",
    "prefix_sum_chains": f"{TPU_FILE}:325",
    "decode_move_chains": f"{TPU_FILE}:728",
    "decode_move_leaves_chains": f"{TPU_FILE}:728",
    "decode_ancestors_chains": f"{TPU_FILE}:972",
    "move_rows_chains": f"{TPU_FILE}:1090",
    "decode_ancestors_dense_chains": f"{TPU_FILE}:103",
    "count_le_sorted_bs_chains": f"{TPU_FILE}:476",
    "count_le_sorted_chains": f"{TPU_FILE}:516",
}
#: The chain axis (phases 3, 7 and 10): phase 3's sizes (C, N) of the
#: chain-axis kernels (100,003 no multiple of a tile), the flagship ensemble's
#: runs, the runs of the other schemes' ensembles, the PGAS chains of modest N
#: and their iterations, the chains of the loop they are timed beside, the
#: PGAS chains at the flagship's N, and the GP-SSM ensemble.
CHAIN_SIZES = ((8, N), (64, 16_384), (1, N), (7, 100_003))
ENSEMBLE_RUNS = 8
SCHEME_RUNS = 4
MANY_CHAINS, MANY_N, MANY_ITERS = 64, 16_384, 3
#: Iterations of the multinomial PGAS batch of MANY_CHAINS x MANY_N.
MULTI_ITERS = 2
#: The PGAS chains run one at a time beside the batch: held against it and
#: timed as the loop of one-chain calls that the batch replaces.
LOOP_CHAINS = (0, 1, 2, MANY_CHAINS - 1)
WIDE_CHAINS, WIDE_ITERS = 4, 2
GP_RUNS, GP_N = 4, 65_536
#: The multinomial paths as they ran on the B7 and B8 kernels of before the
#: redesign (H100 80GB HBM3, same seeds): the flagship's |logZ − Kalman| to the
#: six decimals printed, and the two logZ of the 2-iteration PGAS chain.
EARLIER_MULTINOMIAL_ERR = "0.000238"
EARLIER_MULTINOMIAL_PGAS_LOGZ = [-161.53640747070312, -161.53016662597656]
#: Wrappers whose call is one device-side launch by design: the single-pass
#: scan (no reset pass, no memset), the tile decode, and the decode + move on
#: it; with the chain axis, each kernel once for all chains.
SINGLE_LAUNCH = ("extents_from_logw", "scaled_prefix_from_logw", "prefix_sum", "decode_ancestors",
                 "decode_move", "decode_move_leaves", "extents_from_logw_chains",
                 "scaled_prefix_from_logw_chains", "prefix_sum_chains", "decode_move_chains",
                 "decode_move_leaves_chains", "decode_ancestors_chains", "move_rows_chains",
                 "count_le_sorted_bs_chains", "count_le_sorted_chains")
#: Device-side launches a call may make at most, where that is not 1: B5 is a
#: scatter and a single-pass scan, with no memset, for one chain or C.
MOST_LAUNCHES = {"decode_ancestors_dense": 2, "decode_ancestors_dense_chains": 2}
#: The decode + move kernels of each move version, per firing.
DECODE_MOVE = {
    6: {"decode_ancestors": 1, "move_rows": 1},
    1: {"decode_move": 1},
    0: {"decode_ancestors_dense": 1},
}
#: ``ops.MOVE_VERSION`` as the package sets it (checked in phase 2), the
#: version a windowed call runs under it (0 has no windowed form and runs 1),
#: and another windowed version to hold it against.
DEFAULT_MOVE = 1
WINDOWED_MOVE = 1 if DEFAULT_MOVE == 0 else DEFAULT_MOVE
OTHER_WINDOWED_MOVE = 6 if WINDOWED_MOVE == 1 else 1
#: Kernel launches per resampling firing of each fused scheme.
PER_FIRING = {
    scheme: {**extents, **DECODE_MOVE[DEFAULT_MOVE]} for scheme, extents in {
        "systematic": {"extents_from_logw": 1},
        "stratified": {"scaled_prefix_from_logw": 1},
        "multinomial": {"prefix_sum": 1, "scaled_prefix_from_logw": 1, "count_le_sorted_bs": 1},
        "multinomial, merge path": {"prefix_sum": 1, "scaled_prefix_from_logw": 1,
                                    "count_le_sorted": 1},
    }.items()
}
#: The systematic firing under each move version.
PER_VERSION = {ver: {"extents_from_logw": 1, **move} for ver, move in DECODE_MOVE.items()}
#: Turns of the move versions' A/B in phase 7.
VERSION_TURNS = (6, 1, 0, 0, 1, 6)


def per_firing_chains(scheme: str, leaves: int = 1, version: int = DEFAULT_MOVE) -> dict:
    """Kernel launches per step of a batched sweep on which some chain fires,
    by scheme: every kernel once for all chains, whatever C."""
    if scheme == "residual":  # B6 for its two prefix sums, B3 a 32-bit leaf
        return {"prefix_sum_chains": 2, "move_rows_chains": leaves}
    move = {1: ({"decode_move_chains": 1} if leaves == 1
                else {"decode_move_leaves_chains": -(-leaves // 8)}),
            6: {"decode_ancestors_chains": 1, "move_rows_chains": leaves},
            0: {"decode_ancestors_dense_chains": 1}}[version]
    return {**{"systematic": {"extents_from_logw_chains": 1},
               "stratified": {"scaled_prefix_from_logw_chains": 1},
               "multinomial": {"prefix_sum_chains": 1, "scaled_prefix_from_logw_chains": 1,
                               "count_le_sorted_bs_chains": 1},
               "multinomial, merge path": {"prefix_sum_chains": 1,
                                           "scaled_prefix_from_logw_chains": 1,
                                           "count_le_sorted_chains": 1}}[scheme], **move}


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed nothing")
    return out[0]


def profile_logw(profile: str, gen: torch.Generator) -> torch.Tensor:
    """Weight profiles at M = N: log-normal, uniform, one survivor, 20 survivors."""
    if profile == "lognormal":
        return torch.randn(N, generator=gen, device="cuda") * 2.0
    if profile == "uniform":
        return torch.zeros(N, device="cuda")
    logw = torch.full((N,), -80.0, device="cuda")
    k = 1 if profile == "single" else 20
    idx = torch.randperm(N, generator=gen, device="cuda")[:k]
    logw[idx] = torch.randn(k, generator=gen, device="cuda")
    return logw


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def word_bits(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit words of a float32 or int32 tensor."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def max_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest float32 ulp distance between two nonnegative tensors."""
    return int((bits(a).long() - bits(b).long()).abs().max())


def nondecreasing(x: torch.Tensor) -> bool:
    return bool((x[1:] >= x[:-1]).all())


def time_ms(fn) -> float:
    """Mean time of one call over REPS calls, by CUDA events around the
    window: the wrapper's host work is inside it."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def plain_vs_kernel(plain, kernel):
    """Turns plain, kernel, kernel, plain in one window: the mean of each
    pair and the four readings in turn."""
    p1, k1, k2, p2 = time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def device_rows(fn, reps: int):
    """The profiler's device-side rows (kernels and memsets; an aten op's own
    row repeats its kernels' time) of a window of ``reps`` calls of ``fn``.
    Fails if a record is missing: every row must count a multiple of
    ``reps``."""
    with profiler_window(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILER_PAD_S)
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    check(sum(e.self_device_time_total for e in rows) > 0, "the profiler saw no device time")
    short = [f"{e.key[:60]} x{e.count}" for e in rows if e.count % reps]
    check(not short, f"the profiler lost device records of a window of {reps} calls: {short}")
    return rows


def device_ms_and_launches(fn):
    """Device time of one call and its device-side launches (kernels and
    memsets): the device-side rows of a window of REPS calls, every launch of
    the call summed, over REPS."""
    fn()
    torch.cuda.synchronize()
    rows = device_rows(fn, REPS)
    return (sum(e.self_device_time_total for e in rows) / REPS / 1e3,
            sum(e.count for e in rows) // REPS)


def device_ms(fn) -> float:
    return device_ms_and_launches(fn)[0]


def nbytes(*tensors) -> int:
    """Bytes of the tensors, lists of tensors counted element by element."""
    return sum(nbytes(*t) if isinstance(t, (list, tuple)) else t.numel() * t.element_size()
               for t in tensors)


def clone_as_laid(a: torch.Tensor) -> torch.Tensor:
    """A copy of ``a`` with its strides: a slice of a wider array stays one."""
    out = torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device=a.device)
    return out.copy_(a)


def monotone_extents(m: int, n: int, gen: torch.Generator) -> torch.Tensor:
    """Nondecreasing extents of m rows for n positions ending at n, from
    skewed weights: the running max of the float32 cumsum's extents (a
    parallel cumsum may dip by an ulp where its partial sums meet)."""
    w = torch.rand(m, generator=gen, device="cuda") ** 4
    f = torch.ceil(torch.cumsum(w, 0) / w.sum() * n).clamp(0, n).to(torch.int32)
    f = torch.cummax(f, 0).values
    f[-1] = n
    return f


def geometry_cases(tile: int, stage: int, merge: int, gen: torch.Generator):
    """Merge-count inputs ``(label, s, t)`` on the card at the edges of B7's
    and B8's geometry (thresholds per B7 block, entries of s a B7 block stages,
    merged entries per B8 block); every ``t`` is nondecreasing."""
    def spaced(n):
        return torch.cumsum(torch.empty(n, device="cuda").exponential_(generator=gen), 0)

    def ar(n):
        return torch.arange(n, dtype=torch.float32, device="cuda")

    def lin(lo, hi, n):
        return torch.linspace(lo, hi, n, device="cuda")

    cases = []
    for ns, nt in [(tile - 1, tile + 1), (tile + 1, tile - 1), (tile, tile), (1, tile), (tile, 1),
                   (1, 1), (stage - 1, 7), (stage, 7), (stage + 1, 7), (merge // 2, merge // 2),
                   (merge // 2, merge // 2 + 1), (merge - 1, 1), (5, merge + 1), (merge, merge),
                   (merge + 1, 5)]:
        s = spaced(ns)
        t = (torch.rand(nt, generator=gen, device="cuda") * s[-1] * 1.05).sort().values
        cases.append((f"sizes ({ns}, {nt})", s, t))
    # One B7 tile whose run of s starts at entry 3 and is one short of, exactly
    # and one past the staging buffer: a few thresholds and a tile of them, s
    # itself 16-byte aligned (off 0) and not (off 1).
    base = ar(3 * stage + 8)
    for run in (stage - 1, stage, stage + 1):
        for nt in (7, tile - 1, tile, tile + 1):
            t = lin(2.5, 2.5 + run, nt)
            t[0], t[-1] = 2.5, 2.5 + run
            for off in (0, 1):
                cases.append((f"run of {run} from entry 3, {nt} thresholds, s offset {off}",
                              base[off:], t + off))
    cases += [
        ("ties across tile boundaries", torch.floor(ar(stage + tile + 5) / 37),
         torch.floor(ar(2 * tile + 3) / 41 * 2)),
        ("a tile inside one gap of s", ar(stage),
         torch.cat([lin(7.1, 7.9, tile), lin(9.1, 2000.0, tile)])),
        ("three thresholds over a long run of s", lin(0.0, 1.0, 2 * stage + 1),
         torch.tensor([0.01, 0.5, 0.99], device="cuda")),
        ("thresholds below, above and inf", spaced(tile + 1) + 10.0,
         torch.cat([torch.ones(tile, device="cuda"), lin(10.0, 500.0, tile),
                    torch.full((tile,), 1e9, device="cuda"),
                    torch.full((3,), math.inf, device="cuda")])),
    ]
    s = spaced(merge + 1)
    cases.append(("every threshold one value", s, torch.full((tile + 1,), float(s[merge // 2]),
                                                             device="cuda")))
    # B8 tiles that hold entries of s alone (ni = the whole tile) or thresholds
    # alone (an empty run of s).
    for nt in (1, 5, merge):
        cases.append((f"a merge tile of s alone, then {nt} thresholds", ar(merge), merge + ar(nt)))
    cases.append(("a merge tile of thresholds alone, then one of s alone",
                  2 * merge + ar(merge), ar(merge)))
    cases.append(("every threshold below all of s", merge + ar(5), ar(merge)))
    return cases


def decode_geometry_cases(tile: int, stage: int, gen: torch.Generator):
    """Decode inputs ``(label, f, n_out, guard, start)`` on the card at the
    edges of B2's geometry (output slots per block, owner rows a block
    stages): each case for the whole population and as a window whose start
    is no multiple of the tile."""
    def extents(m, n):
        """Nondecreasing extents of m rows for n positions, ending at n."""
        w = torch.rand(m, generator=gen, device="cuda") ** 4
        f = torch.ceil(torch.cumsum(w, 0) / w.sum() * n).clamp(0, n).to(torch.int32)
        f[-1] = n
        return f

    def i32(*parts):
        return torch.cat([torch.as_tensor(p_, dtype=torch.int32, device="cuda").reshape(-1)
                          for p_ in parts])

    cases = []
    for n in (tile - 1, tile, tile + 1, 3 * tile + 17):
        cases.append((f"{n} rows and slots", extents(n, n), n, n))
    n = 3 * tile + 17
    cases.append((f"the guard case, {n - 1} of {n} positions drawn", extents(n, n - 1), n, n - 1))
    # The first tile's owners are rows [3, 3 + run): one short of, exactly and
    # one past the staging buffer, with f itself 16-byte aligned or not.
    for run in (stage - 1, stage, stage + 1):
        inside = torch.randint(1, tile, (run,), generator=gen, device="cuda").sort().values
        n = 2 * tile + 5
        rest = tile + torch.arange(tile + 6, device="cuda")
        whole = i32([0, 0, 0, 0], inside, rest, [n])
        for off in (0, 1):
            cases.append((f"an owner run of {run} rows from row 3, f offset {off}",
                          whole[off:] if off else whole[1:].clone(), n, n))
    m, n = 2 * tile + 9, 2 * tile + 9
    cases.append(("one row owns every slot", i32(torch.zeros(tile + 3), torch.full((m - tile - 3,), n)),
                  n, n))
    cases.append(("every row owns one slot", torch.arange(1, n + 1, dtype=torch.int32, device="cuda"),
                  n, n))
    cases.append(("all extents 0 but the guard", torch.zeros(m, dtype=torch.int32, device="cuda"),
                  n, n))
    cases.append((f"{3 * stage} rows of one extent inside a tile",
                  i32([0, 0], torch.full((3 * stage,), 5), torch.arange(6, n + 1)), n, n))
    cases.append(("no row owns a slot of the last tile", i32(torch.arange(1, tile + 1), [n] * 9),
                  n, n))
    out = []
    for label, f, n_out, guard in cases:
        out.append((label, f, n_out, guard, 0))
        start = 333 if n_out > 400 else 1
        out.append((label + f", window from slot {start}", f, n_out - start - 2, guard, start))
    return out


def scan_lengths(tile: int, group: int):
    """Lengths at the edges of the scan's geometry: a tile, a group of tiles,
    and a group of groups plus one element (the level above)."""
    return [tile - 1, tile, tile + 1, group * tile - 1, group * tile, group * tile + 1,
            group * group * tile + 1]


def extents_of(anc: torch.Tensor) -> torch.Tensor:
    """The extents a decode inverted: ``f_j = #{k : anc_k ≤ j}``."""
    return torch.cumsum(torch.bincount(anc.long(), minlength=anc.numel()), 0)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def chain_case(c: int, n: int, gen: torch.Generator):
    """Log-weights ``[c, n]`` with their ``(m, s1)`` and offsets ``u [c]``."""
    logw = torch.randn(c, n, generator=gen, device="cuda") * 2.0
    m = torch.amax(logw, -1)
    s1 = torch.sum(torch.exp(logw - m[:, None]), -1)
    return logw, m, s1, torch.rand(c, generator=gen, device="cuda")


def chain_kernel_checks(ops, gen, err):
    """Phase 3's chain-axis kernels: B1, B6 (both modes), B4 and B4 over
    leaves at each of CHAIN_SIZES, for n = N and the guard case, against
    their batched plain versions (B1 within the one-chain tolerance, B6
    within 1 ulp, B4 bitwise), each row bitwise the one-chain kernel on that
    row, chains whose flag is off kept by the sweep's ``where``, and B4 on a
    chain whose rows lie past 2**31 words."""
    t0 = time.perf_counter()
    for c, n in CHAIN_SIZES:
        logw, m, s1, u = chain_case(c, n, gen)
        e = torch.exp(logw - m[:, None])
        x = torch.randn(c, n, generator=gen, device="cuda")
        leaves = [x, torch.randn(c, n, 3, generator=gen, device="cuda"),
                  torch.randint(-2**31, 2**31 - 1, (c, n), generator=gen, device="cuda",
                                dtype=torch.int32)]
        if c * n <= 2 * N:
            leaves.append(torch.randn(c, n, 100, generator=gen, device="cuda"))
        u_host = u.tolist()
        iota = torch.arange(n, dtype=torch.int32, device="cuda")
        for nd in (n, n - 1):
            label = f"chain axis C={c} N={n} n={nd}"
            f = ops.extents_from_logw_chains(logw, m, s1, u, nd)
            f_ref = ops.extents_from_logw_chains_ref(logw, m, s1, u, nd)
            diff = (f.long() - f_ref.long()).abs()
            check(int(diff.max()) <= 1 and int((diff > 0).sum()) <= max(2, 1e-3 * f.numel()),
                  f"{label}: B1 differs from its plain version by {int(diff.max())} in "
                  f"{int((diff > 0).sum())}")
            check(bool((f[:, 1:] >= f[:, :-1]).all()), f"{label}: B1 rows not nondecreasing")
            err["extents_from_logw_chains"] = max(err["extents_from_logw_chains"],
                                                  float(diff.max()))
            scale = nd / s1
            p = ops.scaled_prefix_from_logw_chains(logw, m, scale)
            ps = ops.prefix_sum_chains(e)
            for name, got, want in (
                    ("scaled_prefix_from_logw_chains", p,
                     ops.scaled_prefix_chains_ref(logw, m, scale, True)),
                    ("prefix_sum_chains", ps, ops.scaled_prefix_chains_ref(e, None, None, False))):
                check(max_ulps(got, want) <= 1, f"{label}: {name} {max_ulps(got, want)} ulps")
                err[name] = max(err[name], max_abs(got, want))
            a, mv = ops.decode_move_chains(f, x, n, guard=nd)
            ra, rmv = ops.decode_move_chains_ref(f, x, n, guard=nd)
            check(torch.equal(a, ra) and torch.equal(bits(mv), bits(rmv)),
                  f"{label}: B4 differs from its plain version")
            err["decode_move_chains"] = max(err["decode_move_chains"], max_abs(a, ra),
                                            max_abs(mv, rmv))
            al, mvs = ops.decode_move_leaves_chains(f, leaves, n, guard=nd)
            rl, rmvs = ops.decode_move_leaves_chains_ref(f, leaves, n, guard=nd)
            check(torch.equal(al, rl) and all(torch.equal(word_bits(g), word_bits(w))
                                              for g, w in zip(mvs, rmvs)),
                  f"{label}: B4 over leaves differs from its plain version")
            check(torch.equal(al, a) and torch.equal(bits(mvs[0]), bits(mv)),
                  f"{label}: B4 over leaves differs from B4")
            err["decode_move_leaves_chains"] = max(
                err["decode_move_leaves_chains"], max_abs(al, rl),
                *(max_abs(g.float(), w.float()) for g, w in zip(mvs, rmvs)))
            del rl, rmvs, rmv
            for r in range(c):
                one_f = ops.extents_from_logw(logw[r], m[r], s1[r], u_host[r], nd)
                one_p = ops.scaled_prefix_from_logw(logw[r], m[r], scale[r])
                one_ps = ops.prefix_sum(e[r])
                one_a, one_mv = ops.decode_move(f[r], x[r], n, guard=nd)
                one_al, one_mvs = ops.decode_move_leaves(f[r], [v[r] for v in leaves], n, guard=nd)
                check(torch.equal(f[r], one_f) and torch.equal(bits(p[r]), bits(one_p))
                      and torch.equal(bits(ps[r]), bits(one_ps)),
                      f"{label}: row {r} of B1 or B6 differs from the one-chain kernel")
                check(torch.equal(a[r], one_a) and torch.equal(bits(mv[r]), bits(one_mv))
                      and torch.equal(al[r], one_al)
                      and all(torch.equal(word_bits(g[r]), word_bits(w))
                              for g, w in zip(mvs, one_mvs)),
                      f"{label}: row {r} of B4 differs from the one-chain kernel")
            # The chains whose flag is off keep their ancestors (the identity)
            # and rows by the sweep's where; the others take the kernel's.
            flags = torch.arange(c, device="cuda") % 2 == 0
            anc_k = torch.where(flags[:, None], a, iota)
            rows_k = torch.where(flags[:, None], mv, x)
            for r in range(c):
                on = bool(flags[r])
                check(torch.equal(anc_k[r], a[r] if on else iota)
                      and torch.equal(bits(rows_k[r]), bits(mv[r] if on else x[r])),
                      f"{label}: chain {r} (flag {on}) not kept by the where")
            del f_ref, p, ps, a, mv, al, mvs
        del logw, e, x, leaves
        torch.cuda.empty_cache()
    # Chain 2 of a [3, N, 768] state lies 2 * N * 768 > 2**31 words in.
    c, d = 3, 768
    logw, m, s1, u = chain_case(c, N, gen)
    f = ops.extents_from_logw_chains(logw, m, s1, u, N - 1)
    v = torch.randn(c, N, d, generator=gen, device="cuda")
    a, mv = ops.decode_move_chains(f, v, N, guard=N - 1)
    one_a, one_mv = ops.decode_move(f[2], v[2], N, guard=N - 1)
    check(torch.equal(a[2], one_a) and torch.equal(bits(mv[2]), bits(one_mv)),
          "B4 with the chain axis past 2**31 words differs from the one-chain kernel")
    del v, mv, one_mv
    torch.cuda.empty_cache()
    print(f"chain axis: B1, B6 (both modes), B4 and B4 over leaves at C x N = "
          f"{', '.join(f'{c} x {n}' for c, n in CHAIN_SIZES)}, n = N and the guard: within the "
          f"plain versions' tolerances (B4 bitwise), each row bitwise the one-chain kernel, "
          f"chains whose flag is off kept; B4 on chain 2 of [3, {N}, {d}] (past 2**31 words) "
          f"bitwise the one-chain kernel; {time.perf_counter() - t0:.1f}s", flush=True)


def chain_decode_checks(ops, gen, err):
    """Phase 3's B2, B3, B5, B7 and B8 with the chain axis at each of
    CHAIN_SIZES, for n = N and the guard case: exact against their batched
    plain versions (B3 bitwise), each row bitwise the one-chain kernel on that
    row, B5's marks zero again after every call, and B7 and B8 on the rows of
    ``S[:, :n]`` as the engine hands them over (rows n + 1 apart, most of them
    not 16-byte aligned); B7 also on thresholds in random order with NaN."""
    t0 = time.perf_counter()
    for c, n in CHAIN_SIZES:
        logw, m, s1, u = chain_case(c, n, gen)
        x = torch.randn(c, n, generator=gen, device="cuda")
        w = torch.randn(c, n, 3, generator=gen, device="cuda")
        S = ops.prefix_sum_chains(-torch.log1p(-torch.rand(c, n + 1, generator=gen, device="cuda")))
        for nd in (n, n - 1):
            label = f"chain axis C={c} N={n} n={nd}"
            f = ops.extents_from_logw_chains(logw, m, s1, u, nd)
            a2 = ops.decode_ancestors_chains(f, n, guard=nd)
            a5 = ops.decode_ancestors_dense_chains(f, n, guard=nd)
            check(all(int(mk.count_nonzero()) == 0 for mk in ops._DENSE_MARKS.values()),
                  f"{label}: B5 left marks set")
            r2 = ops.decode_ancestors_chains_ref(f, n, guard=nd)
            r5 = ops.decode_ancestors_dense_chains_ref(f, n, guard=nd)
            err["decode_ancestors_chains"] = max(err["decode_ancestors_chains"], max_abs(a2, r2))
            err["decode_ancestors_dense_chains"] = max(err["decode_ancestors_dense_chains"],
                                                       max_abs(a5, r5))
            check(torch.equal(a2, r2), f"{label}: B2 differs from its plain version")
            check(torch.equal(a5, r5) and torch.equal(a5, a2),
                  f"{label}: B5 differs from its plain version or from B2")
            moved = [(v, ops.move_rows_chains(a2, v)) for v in (x, w)]
            for v, (ac, mv) in moved:
                rac, rmv = ops.resample_move_chains_ref(a2, v)
                err["move_rows_chains"] = max(err["move_rows_chains"], max_abs(ac, rac),
                                              max_abs(mv, rmv))
                check(torch.equal(ac, rac) and torch.equal(bits(mv), bits(rmv)),
                      f"{label}: B3 on {tuple(v.shape)} differs from its plain version")
            s_ = S[:, :nd]
            thr = ops.scaled_prefix_from_logw_chains(logw, m, S[:, nd] / s1)
            t_any = thr[:, torch.randperm(n, generator=gen, device="cuda")].contiguous()
            t_any[:, ::1000] = math.nan
            counts = {}
            for name, fn, t_ in (("count_le_sorted_bs_chains", ops.count_le_sorted_bs_chains, thr),
                                 ("count_le_sorted_chains", ops.count_le_sorted_chains, thr),
                                 ("count_le_sorted_bs_chains", ops.count_le_sorted_bs_chains,
                                  t_any)):
                got = fn(s_, t_)
                want = ops.count_le_sorted_chains_ref(s_, t_)
                err[name] = max(err[name], max_abs(got, want))
                check(torch.equal(got, want), f"{label}: {name} differs from its plain version")
                counts.setdefault(name, got)
            for r in range(c):
                one = [ops.decode_ancestors(f[r], n, guard=nd),
                       ops.decode_ancestors_dense(f[r], n, guard=nd)]
                check(torch.equal(a2[r], one[0]) and torch.equal(a5[r], one[1]),
                      f"{label}: row {r} of B2 or B5 differs from the one-chain kernel")
                for v, (ac, mv) in moved:
                    ac1, mv1 = ops.move_rows(a2[r], v[r])
                    check(torch.equal(ac[r], ac1) and torch.equal(bits(mv[r]), bits(mv1)),
                          f"{label}: row {r} of B3 on {tuple(v.shape)} differs from the "
                          f"one-chain kernel")
                check(torch.equal(counts["count_le_sorted_bs_chains"][r],
                                  ops.count_le_sorted_bs(s_[r], thr[r]))
                      and torch.equal(counts["count_le_sorted_chains"][r],
                                      ops.count_le_sorted(s_[r], thr[r])),
                      f"{label}: row {r} of B7 or B8 differs from the one-chain kernel")
            del f, a2, a5, r2, r5, moved, thr, t_any, counts
        del logw, x, w, S
        torch.cuda.empty_cache()
    print(f"chain axis: B2, B3 (1 and 3 columns), B5, B7 and B8 (B7 also on thresholds in random "
          f"order with NaN) at C x N = {', '.join(f'{c} x {n}' for c, n in CHAIN_SIZES)}, n = N "
          f"and the guard: exact against their batched plain versions, each row bitwise the "
          f"one-chain kernel, B5's marks zero after every call; "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


#: Phase 3's geometries of B3 (C, M, n_out, D): one column, three and 50;
#: n_out no multiple of four (a chain's row then starts at another 16-byte
#: alignment than the one before), and n_out other than M.
MOVE_GEOMETRIES = ((1, N, N, 1), (1, N, N - 1, 3), (1, NG, NG, SG), (1, N, N + 3, 1),
                   (8, N, N, 1), (8, N, N - 1, 1), (8, N, N - 3, 3), (8, NG + 3, NG + 3, SG),
                   (64, MANY_N, MANY_N, 1), (64, MANY_N, MANY_N - 1, 3),
                   (64, MANY_N, MANY_N - 3, SG))


def move_rows_checks(ops, gen, err):
    """Phase 3's B3 on every geometry of MOVE_GEOMETRIES, with ancestors in
    random order and sorted (as a decode gives them), every seventh slot past
    the drawn population (anc == M), float32 and int32 rows: bitwise its plain
    version, each row of C > 1 bitwise the one-chain kernel; and for one chain
    anc and v as slices one to three words off 16-byte alignment."""
    t0 = time.perf_counter()
    for c, m, n_out, d in MOVE_GEOMETRIES:
        label = f"B3 C={c} M={m} n_out={n_out} D={d}"
        anc = torch.randint(0, m + 1, (c, n_out), generator=gen, device="cuda", dtype=torch.int32)
        anc[:, ::7] = m
        shape = (c, m) if d == 1 else (c, m, d)
        for a_ in (anc, torch.sort(anc, dim=1).values):
            for v in (torch.randn(shape, generator=gen, device="cuda"),
                      torch.randint(-(1 << 30), 1 << 30, shape, generator=gen, device="cuda",
                                    dtype=torch.int32)):
                if c == 1:
                    got, want = ops.move_rows(a_[0], v[0]), ops.resample_move_ref(a_[0], v[0])
                    err["move_rows"] = max(err["move_rows"], max_abs(got[0], want[0]))
                    check(torch.equal(got[0], want[0])
                          and torch.equal(word_bits(got[1]), word_bits(want[1])),
                          f"{label}: move_rows differs from its plain version")
                got = ops.move_rows_chains(a_, v)
                want = ops.resample_move_chains_ref(a_, v)
                err["move_rows_chains"] = max(err["move_rows_chains"], max_abs(got[0], want[0]))
                check(torch.equal(got[0], want[0])
                      and torch.equal(word_bits(got[1]), word_bits(want[1])),
                      f"{label}: move_rows_chains differs from its plain version")
                for r in range(c if c > 1 else 0):
                    one = ops.move_rows(a_[r], v[r])
                    check(torch.equal(got[0][r], one[0])
                          and torch.equal(word_bits(got[1][r]), word_bits(one[1])),
                          f"{label}: row {r} of move_rows_chains differs from the one-chain "
                          f"kernel")
                del got, want
        if c == 1:
            flat_a = torch.randint(0, m + 1, (n_out + 3,), generator=gen, device="cuda",
                                   dtype=torch.int32)
            flat_v = torch.randn(m * d + 3, generator=gen, device="cuda")
            for shift in (1, 2, 3):
                a1 = flat_a[shift:shift + n_out]
                v1 = flat_v[shift:shift + m * d]
                v1 = v1 if d == 1 else v1.view(m, d)
                got, want = ops.move_rows(a1, v1), ops.resample_move_ref(a1, v1)
                check(torch.equal(got[0], want[0]) and torch.equal(bits(got[1]), bits(want[1])),
                      f"{label}: move_rows on slices {shift} words off alignment differs from "
                      f"its plain version")
        del anc
        torch.cuda.empty_cache()
    print(f"B3 at (C, M, n_out, D) = {', '.join(map(str, MOVE_GEOMETRIES))}, ancestors random "
          f"and sorted, every seventh past the population, float32 and int32 rows: bitwise its "
          f"plain version and, row by row, the one-chain kernel; one chain also on slices one "
          f"to three words off alignment; {time.perf_counter() - t0:.1f}s", flush=True)


def check_decode_forms(ops, f, n, vs, label, err):
    """B5, the windowed B2 and B4 against their plain versions and against
    the whole-population B2 (+ B3) on extents ``f`` drawn for ``n``
    positions: the whole population, the K windows of L slots, and the
    neighbour exchange's 3L-row form with both windowed move versions."""
    whole = ops.decode_ancestors(f, N, guard=n)
    a5 = ops.decode_ancestors_dense(f, N, guard=n)
    err["decode_ancestors_dense"] = max(err["decode_ancestors_dense"],
                                        max_abs(a5, ops.decode_ancestors_dense_ref(f, N, guard=n)))
    check(torch.equal(a5, ops.decode_ancestors_dense_ref(f, N, guard=n)), f"{label}: B5 differs")
    check(torch.equal(a5, whole), f"{label}: B5 and B2 differ")
    for v in vs:
        a4, mv4 = ops.decode_move(f, v, N, guard=n)
        r4 = ops.decode_move_ref(f, v, N, guard=n)
        err["decode_move"] = max(err["decode_move"], max_abs(a4, r4[0]), max_abs(mv4, r4[1]))
        check(torch.equal(a4, r4[0]) and torch.equal(bits(mv4), bits(r4[1])),
              f"{label}: B4 differs from its plain version")
        b3 = ops.move_rows(whole, v)
        check(torch.equal(a4, b3[0]) and torch.equal(bits(mv4), bits(b3[1])),
              f"{label}: B4 differs from B2 + B3")
        for k in range(K):
            start = k * L
            a2 = ops.decode_ancestors(f, L, guard=n, start=start)
            a2_ref = ops.decode_ancestors_ref(f, L, guard=n, start=start)
            err["decode_ancestors"] = max(err["decode_ancestors"], max_abs(a2, a2_ref))
            check(torch.equal(a2, a2_ref) and torch.equal(a2, whole[start:start + L]),
                  f"{label}: windowed B2 differs (window {k})")
            a4w, mv4w = ops.decode_move(f, v, L, guard=n, start=start)
            r4w = ops.decode_move_ref(f, v, L, guard=n, start=start)
            check(torch.equal(a4w, r4w[0]) and torch.equal(bits(mv4w), bits(r4w[1])),
                  f"{label}: windowed B4 differs (window {k})")
            check(torch.equal(mv4w, mv4[start:start + L]), f"{label}: B4 window {k} not a slice")
            # The 3L rows of shards k−1, k, k+1, ring-wrapped and masked as
            # the neighbour exchange hands them over.
            rows = [(k + d) % K for d in (-1, 0, 1)]
            f_ext = torch.cat([f[r * L:(r + 1) * L] for r in rows])
            if k == 0:
                f_ext[:L] = 0
            if k == K - 1:
                f_ext[2 * L:] = n
            v_ext = torch.cat([v[r * L:(r + 1) * L] for r in rows])
            plain = ops.decode_move_ref(f_ext, v_ext, L, guard=n, start=start)
            for ver in (1, 6):
                a, mv = ops.resample_move_window_fext(f_ext, v_ext, n, start, L, version=ver)
                check(torch.equal(a, plain[0]) and torch.equal(bits(mv), bits(plain[1])),
                      f"{label}: 3L-row form, version {ver}, window {k} differs")


#: The positional Threefry (phases 3, 7 and every path): four CUDA kernels of
#: csrc/threefry.cu.  They stand for no pallas_call: each is the fusion that
#: XLA makes of the JAX package's jnp uint32 cipher and its draws.
TF_SOURCE = "advancedps_tpu_torch/csrc/threefry.cu"
TF_FILE = "advancedps_tpu/rng.py"
TF_REPLACES = {"threefry2x32": f"{TF_FILE}:91", "pos_uniform": f"{TF_FILE}:139",
               "pos_normal": f"{TF_FILE}:161", "pos_normals": f"{TF_FILE}:182"}
#: Integer operations of one 20-round block as csrc/threefry.cu computes it:
#: two xors for the key schedule, two adds, 20 rounds of add, rotate and xor,
#: five injections of three adds.
BLOCK_OPS = 79
#: The H100 SXM's int32 rate outside the tensor cores: 132 SMs x 64 INT32
#: lanes (NVIDIA's Hopper white paper) at the 1.98 GHz boost clock.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: Normals on the card against their plain version: at most this many ulps
#: apart (the kernel calls the library functions torch's kernels call).
NORMAL_ULPS = 2
#: Threefry launches of each model family at init, a step, and a step with a
#: PGAS reference on top (its ancestor weights): the LGSSM and the SV model one
#: pos_normal at init and a step; the Lévy model pos_normals at init, 3
#: key-based ciphers a step (the particle keys, the split of each one, the
#: noise) and its jump path's kernel (``meancov``: the path's split, gaps,
#: acceptances and times inside it), and that kernel once more with a
#: reference (the scoring path); the
#: GP-SSM a pos_normal at init and 2 a step (the particle keys, the keyed
#: normal); the generic LGSSM program 3 a step and none at init (the particle
#: keys, a site's fold_in of each, the keyed normal).
MODEL_DRAWS = {
    "LGSSM": ({"pos_normal": 1}, {"pos_normal": 1}, {}),
    "stochastic volatility": ({"pos_normal": 1}, {"pos_normal": 1}, {}),
    "Lévy": ({"pos_normals": 1}, {"threefry2x32": 3, "meancov": 1}, {"meancov": 1}),
    "GP-SSM": ({"pos_normal": 1}, {"threefry2x32": 2}, {}),
    "generic": ({"threefry2x32": 3}, {"threefry2x32": 3}, {}),
}


def draws(normal: int = 0, uniform: int = 0, words: int = 0, normals: int = 0) -> dict:
    """Launches of each Threefry kernel on a path, and of the Lévy jump path's
    kernel (``meancov``, counted through ``MODEL_DRAWS``)."""
    return {"threefry2x32": words, "pos_uniform": uniform, "pos_normal": normal,
            "pos_normals": normals, "meancov": 0}


def add_draws(*ds) -> dict:
    return {k: sum(d[k] for d in ds) for k in draws()}


def model_draws(label: str, steps: int = T, sweeps: int = 1, referenced: int = 0,
                uniform: int = 0) -> dict:
    """The Threefry launches of ``sweeps`` sweeps (or replays) of ``steps``
    steps of model ``label``, ``referenced`` of them with a PGAS reference,
    and ``uniform`` positional uniforms besides."""
    init, step, ref = MODEL_DRAWS[label]
    out = {k: sweeps * (init.get(k, 0) + (steps - 1) * step.get(k, 0))
           + referenced * (steps - 1) * ref.get(k, 0) for k in draws()}
    out["pos_uniform"] += uniform
    return out


def pgas_draws(iters: int, steps: int = T, conditional=None, replay: bool = True,
               shards: int = 1, firing_uniforms: int = 0, model: str = "LGSSM") -> dict:
    """The Threefry launches of ``iters`` PG(AS) iterations (every step
    firing): each iteration's sweep on each of ``shards`` shards and, with
    ``replay``, its replay; one pos_uniform for the retained draw; the
    ancestor draw's at each step on each shard of the ``conditional``
    iterations (those with a reference: all but a fresh chain's first; 0 for
    PG); ``firing_uniforms`` a firing for a scheme's uniform pass
    (stratified, multinomial, residual: 1)."""
    conditional = iters - 1 if conditional is None else conditional
    return model_draws(model, steps, iters * (shards + int(replay)), conditional * shards,
                       iters + (steps - 1) * (conditional * shards + iters * firing_uniforms))


def check_draws(drive, what: str, want: dict):
    """The Threefry and Lévy path launches of the path ``drive`` ran last,
    against ``want``."""
    check(drive.draws == want, f"{what}: Threefry and Lévy path launches {drive.draws} != "
          f"{want}")


def ulps_apart(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest float32 ulp distance between two tensors of equal signs."""
    return int((bits(a).long() - bits(b).long()).abs().max()) if a.numel() else 0


def threefry_checks(apt, tf, err):
    """Phase 3: each Threefry kernel against its plain version on the card:
    at 1M, at 8 x 1M on the chain axis, at an odd N from an odd id, at ids
    past 2**32, on int32 ids and on an offset slice; the cipher words and the
    uniforms bitwise, the normals within NORMAL_ULPS (the largest gap
    printed); then each batching rule under vmap against the loop of
    one-key calls, in one launch."""
    R = apt.rng
    k = R.step_key(R.key(7), R.PROPAGATE, 3)
    kb = R.chain_keys(R.key(7), ENSEMBLE_RUNS).to("cuda").column()
    ids = torch.arange(N, device="cuda")
    cases = (("1M", k.k0, k.k1, ids),
             (f"{ENSEMBLE_RUNS} x 1M", kb.k0, kb.k1, ids),
             ("100,003 ids from 3", k.k0, k.k1, torch.arange(3, 100_006, device="cuda")),
             ("ids past 2**32", k.k0, k.k1,
              torch.arange(2**32 - N // 2, 2**32 + N // 2 + 1, device="cuda")),
             ("int32 ids", k.k0, k.k1, ids.to(torch.int32)),
             ("an offset slice", k.k0, k.k1, ids[333:N - 7:3]))
    worst = dict.fromkeys(("pos_normal", "pos_normals"), 0)
    for what, k0, k1, g in cases:
        for pair in (False, True):
            for name, fn, ref in (("pos_uniform", tf.pos_uniform, tf.pos_uniform_ref),
                                  ("pos_normal", tf.pos_normal, tf.pos_normal_ref)):
                got, want = fn(k0, k1, g, 5, pair), ref(k0, k1, g, 5, pair)
                got, want = (got, want) if pair else ((got,), (want,))
                err[name] = max(err[name], *(max_abs(a, b) for a, b in zip(got, want)))
                if name == "pos_uniform":
                    check(all(torch.equal(a, b) for a, b in zip(got, want)),
                          f"{what}: pos_uniform (pair {pair}) differs from its plain version")
                else:
                    worst[name] = max(worst[name], *(ulps_apart(a, b) for a, b in zip(got, want)))
        got, want = tf.pos_normals(k0, k1, g, 3, 2), tf.pos_normals_ref(k0, k1, g, 3, 2)
        err["pos_normals"] = max(err["pos_normals"], max_abs(got, want))
        worst["pos_normals"] = max(worst["pos_normals"], ulps_apart(got, want))
        c1 = g.to(torch.int64)
        for stacked in (False, True):
            got = tf.threefry2x32(k0, k1, 9, c1, stacked=stacked)
            want = tf.threefry2x32_ref(k0, k1, 9, c1)
            got = got.unbind(-1) if stacked else got
            err["threefry2x32"] = max(err["threefry2x32"],
                                      *(max_abs(a, b) for a, b in zip(got, want)))
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"{what}: threefry2x32 (stacked {stacked}) differs from its plain version")
    for name, gap in worst.items():
        check(gap <= NORMAL_ULPS, f"{name}: {gap} ulps from its plain version, over "
              f"{NORMAL_ULPS}")
    # The batching rules: vmap over 8 chains' words, over 4,096 particle keys,
    # and both nested, each one launch and bitwise the loop of one-key calls.
    chains = R.chain_keys(R.key(9), ENSEMBLE_RUNS).to("cuda")
    pk = R.particle_keys(R.key(4), R.PROPAGATE, 3, 4096)
    from advancedps_tpu_torch import random as rnd
    for what, mapped, loop, name in (
            ("pos_normal over chain words",
             lambda: torch.func.vmap(lambda a, b: R.pos_normal(R.KeyBatch(a, b), ids))(
                 chains.k0, chains.k1),
             lambda: torch.stack([R.pos_normal(chains.key(c), ids)
                                  for c in range(ENSEMBLE_RUNS)]), "pos_normal"),
            ("pos_uniform over chain words and ids",
             lambda: torch.func.vmap(lambda a, b, g: R.pos_uniform(R.KeyBatch(a, b), g))(
                 chains.k0, chains.k1, ids[:ENSEMBLE_RUNS * 1000].view(ENSEMBLE_RUNS, 1000)),
             lambda: torch.stack([R.pos_uniform(chains.key(c), ids[c * 1000:(c + 1) * 1000])
                                  for c in range(ENSEMBLE_RUNS)]), "pos_uniform"),
            ("random.normal over particle keys",
             lambda: torch.func.vmap(lambda q: rnd.normal(q, (64,)))(pk),
             lambda: torch.stack([rnd.normal(q, (64,)) for q in pk]), "threefry2x32"),
            ("fold_in_ids under chains, random.uniform under particles",
             lambda: torch.func.vmap(lambda a, b: torch.func.vmap(
                 lambda q: rnd.uniform(q, (5,)))(R.fold_in_ids(R.KeyBatch(a, b), ids[:512])))(
                 chains.k0, chains.k1),
             lambda: torch.stack([torch.stack([rnd.uniform(q, (5,)) for q in
                                               R.fold_in_ids(chains.key(c), ids[:512])])
                                  for c in range(ENSEMBLE_RUNS)]), "threefry2x32")):
        tf.reset_launch_counts()
        got = mapped()
        launches = {w.__name__: w.launches for w in tf.KERNEL_WRAPPERS if w.launches}
        check(torch.equal(got, loop()), f"{what} under vmap differs from the loop")
        want = {name: 2} if "fold_in_ids" in what else {name: 1}
        check(launches == want, f"{what} under vmap: launches {launches}, want {want}")
    tf.reset_launch_counts()
    print(f"Threefry kernels against their plain versions at 1M, {ENSEMBLE_RUNS} x 1M, 100,003 "
          f"ids from 3, ids past 2**32, int32 ids and an offset slice: cipher words and "
          f"uniforms bitwise, normals within {worst['pos_normal']} ulps (pos_normal) and "
          f"{worst['pos_normals']} (pos_normals); the batching rules under vmap (chain words, "
          f"chain words and ids, particle keys, nested) bitwise the loop, one launch each",
          flush=True)


#: Threefry blocks of one Lévy jump path a key (the path key's split into
#: three, and K = 64 candidates' three draws), BLOCK_OPS int32 operations each.
LEVY_BLOCKS = 3 + 3 * 64


def levy_path_keys(apt):
    """The Lévy dynamics on the card and 1M path keys."""
    R, rnd = apt.rng, apt.random
    dyn = apt.models.levy_ssm(dt=0.5).to("cuda").dynamics
    return dyn, rnd.split(R.particle_keys(R.key(30), R.PROPAGATE, 4, N))[..., 0, :]


def levy_checks(apt, levy_ops):
    """Phase 3: the Lévy jump path's kernel against the plain chain
    (``_meancov_plain``) on the card, ``(mu, cov)`` bitwise: 1M path keys at
    steps 1, 100 and 199 with ``mu_w`` 0 and 0.7, 4 chains of 65,536 as
    ``vmap`` over ``vmap``, and ``log_prob``'s unbatched shared key, each one
    launch."""
    R, rnd = apt.rng, apt.random
    vmap = torch.func.vmap
    dyn, keys = levy_path_keys(apt)

    def pair(key, step, nest):
        kernel = lambda k: dyn._meancov(k, step)  # noqa: E731
        plain = lambda k: dyn._meancov_plain(k, step)  # noqa: E731
        for _ in range(nest):
            kernel, plain = vmap(kernel), vmap(plain)
        levy_ops.reset_launch_counts()
        got = kernel(key)
        launches = levy_ops.meancov.launches
        return got, plain(key), launches

    shared = rnd.key_tensor(R.fold_in(R.key(dyn.score_seed), 100), "cuda")
    cases = [(f"1M keys, step {t}, mu_w {mu_w}", keys, t, 1, mu_w)
             for t in (1, 100, 199) for mu_w in (0.0, 0.7)]
    cases += [("4 x 65,536 keys as vmap over vmap", keys[:4 * 65536].reshape(4, 65536, 2), 100,
               2, 0.0),
              ("the shared key of log_prob", shared, 100, 0, 0.7)]
    for what, key, step, nest, mu_w in cases:
        dyn.mu_w.fill_(mu_w)
        got, want, launches = pair(key, step, nest)
        check(launches == 1, f"Lévy path, {what}: {launches} launches")
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"Lévy path, {what}: the kernel differs from the plain chain")
    levy_ops.reset_launch_counts()
    print(f"Lévy jump path kernel against the plain chain: {len(cases)} cases bitwise (mu, cov), "
          f"one launch each", flush=True)


def levy_timing(apt, levy_ops, tag: str):
    """Phase 7: the Lévy jump path's kernel at 1M path keys, by events
    (plain, kernel, kernel, plain) and by the profiler, against its bound:
    BLOCK_OPS for each of LEVY_BLOCKS blocks a key at the int32 rate."""
    vmap = torch.func.vmap
    dyn, keys = levy_path_keys(apt)
    kernel = lambda: vmap(lambda k: dyn._meancov(k, 100))(keys)  # noqa: E731
    plain = lambda: vmap(lambda k: dyn._meancov_plain(k, 100))(keys)  # noqa: E731
    call_ms, plain_ms, readings = plain_vs_kernel(plain, kernel)
    dev_ms = device_ms(kernel)
    bound_ms = BLOCK_OPS * LEVY_BLOCKS * N / INT32_OPS_PER_S * 1e3
    levy_ops.reset_launch_counts()
    print(f"Lévy jump path kernel at 1M keys: {dev_ms:.4f} device ms against its bound "
          f"{bound_ms:.4f} ms ({LEVY_BLOCKS} blocks a key at {INT32_OPS_PER_S / 1e12:.2f} "
          f"Tops/s int32; share {bound_ms / dev_ms:.3f}); per call by events {call_ms:.4f} ms, "
          f"plain chain {plain_ms:.4f} ms (plain, kernel, kernel, plain: "
          f"{', '.join(f'{r:.4f}' for r in readings)}) {tag}", flush=True)


def threefry_timings(apt, tf, tag: str) -> dict:
    """Phase 7: each Threefry kernel at the shapes the main path gives it, 1M
    ids with one key (the flagship's propagate, the Gumbel pass, the particle
    keys, the Lévy model's init) and the chain axis's 8 x 1M: device time
    L2-warm and L2-cold (128 MB of copies of the ids in turn), launches a
    call, the plain version's device time, the time a call by CUDA events
    (host included; plain, kernel, kernel, plain), and the bound: the larger
    of the bytes (ids and key words read, the output written) at the memory's
    rate and BLOCK_OPS at the int32 rate for each distinct block these ids
    need.  In the paired layout ids 2p and 2p + 1 share the block at counter
    p, so 1M ids need 500k blocks, though the kernel computes a block for each id."""
    R = apt.rng
    k = R.step_key(R.key(1), R.PROPAGATE, 1)
    kb = R.chain_keys(R.key(200), ENSEMBLE_RUNS).to("cuda").column()
    ids = torch.arange(N, device="cuda")
    # name -> (kernel, plain version, the block counters of a key's ids: d = 2
    # columns of pos_normals take one block's two outputs)
    calls = {
        "threefry2x32": (lambda k0, k1, g: tf.threefry2x32(k0, k1, 0, g, stacked=True),
                         lambda k0, k1, g: torch.stack(tf.threefry2x32_ref(k0, k1, 0, g), -1),
                         lambda g: g & 0xFFFFFFFF),
        "pos_uniform": (tf.pos_uniform, tf.pos_uniform_ref, lambda g: (g >> 1) & 0xFFFFFFFF),
        "pos_normal": (tf.pos_normal, tf.pos_normal_ref, lambda g: (g >> 1) & 0xFFFFFFFF),
        "pos_normals": (lambda k0, k1, g: tf.pos_normals(k0, k1, g, 2),
                        lambda k0, k1, g: tf.pos_normals_ref(k0, k1, g, 2),
                        lambda g: g & 0xFFFFFFFF),
    }
    rows = {}
    for name, (kernel_fn, plain, counters) in calls.items():
        for at, k0, k1 in (("1M", k.k0, k.k1), (f"{ENSEMBLE_RUNS} x 1M", kb.k0, kb.k1)):
            out = kernel_fn(k0, k1, ids)
            words = [w for w in (k0, k1) if isinstance(w, torch.Tensor)]
            moved = nbytes(ids, *words, out)
            keys = max((w.numel() for w in words), default=1)
            blocks = keys * torch.unique(counters(ids)).numel()
            ops_count = BLOCK_OPS * blocks
            by_bytes, by_ops = moved / HBM_BYTES_PER_S * 1e3, ops_count / INT32_OPS_PER_S * 1e3
            copies = [ids.clone() for _ in range(-(-COLD_BYTES // nbytes(ids)))]
            turn = iter(range(10 ** 9))
            warm_ms, per_call = device_ms_and_launches(lambda: kernel_fn(k0, k1, ids))
            cold_ms = device_ms(lambda: kernel_fn(k0, k1, copies[next(turn) % len(copies)]))
            del copies
            plain_ms = device_ms(lambda: plain(k0, k1, ids))
            call_ms, plain_call_ms, readings = plain_vs_kernel(lambda: plain(k0, k1, ids),
                                                               lambda: kernel_fn(k0, k1, ids))
            row = {"device_ms": warm_ms, "cold_device_ms": cold_ms, "launches_per_call": per_call,
                   "plain_ms": plain_ms, "library_ms": None, "call_ms": call_ms,
                   "plain_call_ms": plain_call_ms, "bytes": moved, "blocks": blocks,
                   "int_ops": ops_count,
                   "bound_ms": max(by_bytes, by_ops),
                   "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
            row["bound_share"] = row["bound_ms"] / warm_ms
            rows.setdefault(name, {})[at] = row
            print(f"kernel {name} at {at}: {per_call} launch(es) a call, device {warm_ms:.5f} ms "
                  f"L2-warm, {cold_ms:.5f} ms L2-cold, plain {plain_ms:.5f} ms, library no "
                  f"single call (torch.rand is Philox, another function); bound "
                  f"{row['bound_ms']:.5f} ms by {row['bound_by']} ({moved} bytes at 3.35 TB/s: "
                  f"{by_bytes:.5f} ms; {blocks} blocks, {ops_count} int32 operations at "
                  f"{INT32_OPS_PER_S / 1e12:.2f} Tops/s: {by_ops:.5f} ms), share "
                  f"{row['bound_share']:.4f} warm; per call by events, host included: "
                  f"{call_ms:.4f} ms, plain {plain_call_ms:.4f} ms (plain, kernel, kernel, plain: "
                  f"{', '.join(f'{r:.4f}' for r in readings)}) {tag}", flush=True)
            check(per_call == 1, f"{name} at {at}: {per_call} device-side launches a call, the "
                  f"fused draw has 1")
            check(row["bound_ms"] <= cold_ms, f"{name} at {at}: L2-cold device time {cold_ms} "
                  f"ms below its bound {row['bound_ms']} ms")
    return rows


def main():
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs only on a GPU")
    import advancedps_tpu_torch as apt
    from advancedps_tpu_torch.ops import _build
    from advancedps_tpu_torch.ops import levy as levy_ops
    from advancedps_tpu_torch.ops import resample as ops
    from advancedps_tpu_torch.ops import threefry as tfops

    names = [w.__name__ for w in ops.KERNEL_WRAPPERS]
    tf_names = [w.__name__ for w in tfops.KERNEL_WRAPPERS]
    draw_wrappers = tfops.KERNEL_WRAPPERS + levy_ops.KERNEL_WRAPPERS
    check([w.__name__ for w in draw_wrappers] == list(draws()),
          f"the Threefry and Lévy path kernels are {[w.__name__ for w in draw_wrappers]}")

    def counts(wrappers=ops.KERNEL_WRAPPERS):
        return {w.__name__: w.launches for w in wrappers}

    def expected(per_firing, firings):
        return {name: per_firing.get(name, 0) * firings for name in names}

    main_launches = dict.fromkeys(names + list(draws()), 0)

    def drive(fn):
        """Run one main path with the counts set to 0 just before it; return
        its result and the resampling kernels' counts read just after (the
        Threefry and Lévy path kernels' in ``drive.draws``)."""
        ops.reset_launch_counts()
        tfops.reset_launch_counts()
        levy_ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = counts()
        drive.draws = counts(draw_wrappers)
        for name, c in {**got, **drive.draws}.items():
            main_launches[name] += c
        return out, got

    # ---- 1. device
    card = card_line()
    print(card, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | python {sys.version.split()[0]}",
          flush=True)
    tag = f"[{card}]"

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    lib = _build.library()
    print(f"build: {time.perf_counter() - t0:.2f}s {lib_path.name}", flush=True)
    for ln in lib_path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            print(f"  ptxas {mangled[:110]}", flush=True)
        elif "registers" in ln or "spill" in ln:
            print(f"  ptxas   {ln.strip()}", flush=True)
    geometry = [lib.aps_count_le_geometry(i) for i in range(3)]
    # The CPU tests build their cases around the wrappers' constants.
    check(geometry == [ops.COUNT_TILE, ops.COUNT_STAGE, ops.MERGE_TILE],
          f"B7/B8 geometry {geometry} differs from the wrappers' constants")
    decode_geometry = [lib.aps_decode_geometry(i) for i in range(4)]
    check(decode_geometry == [ops.DECODE_TILE, ops.DECODE_STAGE, ops.DECODE_MOVE_TILE,
                              ops.DENSE_TILE],
          f"B2, B4 and B5 geometry {decode_geometry} differs from the wrappers' constants")
    check(ops.MOVE_VERSION == DEFAULT_MOVE,
          f"ops.MOVE_VERSION is {ops.MOVE_VERSION}, the launch tables here are for {DEFAULT_MOVE}")
    check(lib.aps_prefix_tile_size() == ops.PREFIX_TILE,
          f"scan tile {lib.aps_prefix_tile_size()} differs from the wrappers' constant")
    check(lib.aps_threefry_max_dims() == tfops.MAX_DIMS,
          f"the Threefry kernels take {lib.aps_threefry_max_dims()} dimensions, the wrappers "
          f"{tfops.MAX_DIMS}")
    check(lib.aps_levy_max_jumps() == levy_ops.MAX_JUMPS,
          f"the Lévy kernel holds {lib.aps_levy_max_jumps()} jumps, the wrapper "
          f"{levy_ops.MAX_JUMPS}")

    # ---- 3. kernels vs plain versions on the card, M = N = 1M
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = dict.fromkeys(names + tf_names, 0.0)
    edge_cases = geometry_cases(*geometry, gen)
    for what, s_, t_ in edge_cases:
        want = ops.count_le_sorted_ref(s_, t_)
        for fn, t_x, want_x in ((ops.count_le_sorted_bs, t_, want), (ops.count_le_sorted, t_, want),
                                (ops.count_le_sorted_bs, t_.flip(0).contiguous(), want.flip(0))):
            got = fn(s_, t_x)
            err[fn.__name__] = max(err[fn.__name__], max_abs(got, want_x))
            check(torch.equal(got, want_x), f"{what}: {fn.__name__} differs from its plain version")
    print(f"B7 and B8 at the edges of their geometry (tile {geometry[0]}, stage {geometry[1]}, "
          f"merge tile {geometry[2]}): {len(edge_cases)} cases exact, B7 also on each case's "
          f"thresholds in reverse", flush=True)
    # B2, B4 and B5 at the edges of each one's own tile (B2 and B4 stage the
    # same number of owner rows): B2 and B4 (one, three and four columns; a v
    # that is no 16-byte aligned slice) whole and as a window, B5 whole.
    tiles = sorted({decode_geometry[0], decode_geometry[2], decode_geometry[3]})
    n_decode_cases = 0
    for tile in tiles:
        for what, f_, n_out, guard, start in decode_geometry_cases(tile, decode_geometry[1], gen):
            what = f"{what} (tile {tile})"
            n_decode_cases += 1
            got = ops.decode_ancestors(f_, n_out, guard=guard, start=start)
            want = ops.decode_ancestors_ref(f_, n_out, guard=guard, start=start)
            err["decode_ancestors"] = max(err["decode_ancestors"], max_abs(got, want))
            check(torch.equal(got, want), f"{what}: decode_ancestors differs from its plain version")
            m_rows = f_.numel()
            flat = torch.randn(4 * m_rows + 1, generator=gen, device="cuda")
            for v in (flat[:m_rows], flat[:3 * m_rows].view(m_rows, 3),
                      flat[:4 * m_rows].view(m_rows, 4), flat[1:m_rows + 1],
                      flat[1:].view(m_rows, 4)):
                a4, mv4 = ops.decode_move(f_, v, n_out, guard=guard, start=start)
                r4 = ops.decode_move_ref(f_, v, n_out, guard=guard, start=start)
                err["decode_move"] = max(err["decode_move"], max_abs(a4, r4[0]),
                                         max_abs(mv4, r4[1]))
                check(torch.equal(a4, r4[0]) and torch.equal(bits(mv4), bits(r4[1])),
                      f"{what}, v {tuple(v.shape)}: decode_move differs from its plain version")
                b3 = ops.move_rows(got, v)
                check(torch.equal(a4, b3[0]) and torch.equal(bits(mv4), bits(b3[1])),
                      f"{what}, v {tuple(v.shape)}: decode_move differs from B2 + B3")
            if start == 0:
                a5 = ops.decode_ancestors_dense(f_, n_out, guard=guard)
                r5 = ops.decode_ancestors_dense_ref(f_, n_out, guard=guard)
                err["decode_ancestors_dense"] = max(err["decode_ancestors_dense"], max_abs(a5, r5))
                check(torch.equal(a5, r5), f"{what}: decode_ancestors_dense differs from its plain "
                      f"version")
                check(torch.equal(a5, got), f"{what}: decode_ancestors_dense differs from B2")
    print(f"B2, B4 and B5 at the edges of their geometry (tiles {tiles}, stage "
          f"{decode_geometry[1]}): {n_decode_cases} cases exact; B4 bitwise its plain version and "
          f"B2 + B3 on 1, 3 and 4 columns and on unaligned rows, whole and windowed", flush=True)

    # B4 straight through the C entry on outputs that are no 16-byte aligned
    # slices (the wrapper's own are always aligned): the scalar stores.
    n_u = 3 * decode_geometry[2] + 17
    w_u = torch.rand(n_u, generator=gen, device="cuda") ** 4
    f_u = torch.ceil(torch.cumsum(w_u, 0) / w_u.sum() * n_u).clamp(0, n_u).to(torch.int32)
    v_u = torch.randn(n_u, generator=gen, device="cuda")
    out_u = torch.empty(n_u + 1, device="cuda")
    anc_u = torch.empty(n_u + 1, dtype=torch.int32, device="cuda")
    rc = lib.aps_decode_move(ops._ptr(f_u), n_u, n_u, 0, n_u, ops._ptr(v_u), 1, ops._ptr(out_u[1:]),
                             ops._ptr(anc_u[1:]), ops._stream(f_u.device))
    check(rc == 0, f"decode_move on unaligned outputs: CUDA error {rc}")
    r_u = ops.decode_move_ref(f_u, v_u, n_u)
    check(torch.equal(anc_u[1:], r_u[0]) and torch.equal(bits(out_u[1:]), bits(r_u[1])),
          "decode_move on unaligned outputs differs from its plain version")

    # B5 shares the look-back scratch with B1 and B6 and keeps its marks zero
    # between calls: two calls bitwise equal, B1, B5, B1 and B6, B5, B6 in turn
    # on one stream each equal to the call alone, a second stream with a scratch
    # of its own, slots fewer and more than rows, and 16M rows and slots.
    lw = torch.randn(N, generator=gen, device="cuda") * 2.0
    m = torch.max(lw)
    s1 = torch.sum(torch.exp(lw - m))
    f_alone = ops.extents_from_logw(lw, m, s1, 0.37, N)
    c_alone = ops.scaled_prefix_from_logw(lw, m, N / s1)
    a_alone = ops.decode_ancestors_dense(f_alone, N)
    check(torch.equal(a_alone, ops.decode_ancestors(f_alone, N)), "B5 at 1M differs from B2")
    f_1 = ops.extents_from_logw(lw, m, s1, 0.37, N)
    a_1 = ops.decode_ancestors_dense(f_alone, N)
    f_2 = ops.extents_from_logw(lw, m, s1, 0.37, N)
    c_1 = ops.scaled_prefix_from_logw(lw, m, N / s1)
    a_2 = ops.decode_ancestors_dense(f_alone, N)
    c_2 = ops.scaled_prefix_from_logw(lw, m, N / s1)
    check(torch.equal(f_1, f_alone) and torch.equal(f_2, f_alone) and torch.equal(a_1, a_alone)
          and torch.equal(a_2, a_alone) and torch.equal(bits(c_1), bits(c_alone))
          and torch.equal(bits(c_2), bits(c_alone)),
          "B1, B5, B1, B6, B5, B6 in turn on one stream differ from each alone")
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        a_side = [ops.decode_ancestors_dense(f_alone, N) for _ in range(3)]
        f_side = ops.extents_from_logw(lw, m, s1, 0.37, N)
    a_main = [ops.decode_ancestors_dense(f_alone, N) for _ in range(3)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, a_alone) for a in a_side + a_main) and torch.equal(f_side, f_alone),
          "B5 and B1 on two streams at once differ from each alone")
    for n_slots in (N // 3 + 5, 2 * N + 7):
        check(torch.equal(ops.decode_ancestors_dense(f_alone, n_slots, guard=N),
                          ops.decode_ancestors_ref(f_alone, n_slots, guard=N)),
              f"B5 with {n_slots} slots of {N} rows differs from the plain decode")
    f_16m = torch.arange(1, 16 * N + 1, dtype=torch.int32, device="cuda") // 3 * 3
    a_16m = ops.decode_ancestors_dense(f_16m, 16 * N)
    check(torch.equal(a_16m, ops.decode_ancestors_dense(f_16m, 16 * N))
          and torch.equal(a_16m, ops.decode_ancestors(f_16m, 16 * N)),
          "B5 at 16M differs from B2 or from itself")
    del lw, f_16m, a_16m, a_side, a_main
    print("B5: two calls bitwise equal; B1, B5, B1 and B6, B5, B6 in turn on one stream and B5 "
          "beside B1 on a second stream equal to each alone; slots fewer and more than rows; 16M "
          "rows and slots equal to B2", flush=True)

    # B4 over leaves at 1M: leaves [N], [N, 2], [N, 100] and an int32 [N] in
    # one call, bitwise its plain version and B4 a leaf, whole, guarded and as
    # windows; nine leaves take two launches; unaligned leaves.
    check(lib.aps_max_leaves() == ops.MAX_LEAVES,
          f"aps_max_leaves() is {lib.aps_max_leaves()}, the wrapper's MAX_LEAVES {ops.MAX_LEAVES}")
    f_ml = monotone_extents(N, N, gen)
    leaves = [torch.randn(N, generator=gen, device="cuda"),
              torch.randn(N, 2, generator=gen, device="cuda"),
              torch.randn(N, 100, generator=gen, device="cuda"),
              torch.randint(-2**31, 2**31 - 1, (N,), generator=gen, device="cuda",
                            dtype=torch.int32)]
    unaligned = [torch.randn(3 * N + 1, generator=gen, device="cuda")[1:].view(N, 3),
                 torch.randn(N + 1, generator=gen, device="cuda")[1:]]
    for what, ls, launches_want in (("1 + 2 + 100 + 1 words", leaves, 1),
                                    ("nine leaves", [leaves[0]] * 5 + leaves, 2),
                                    ("unaligned rows", unaligned, 1)):
        for guard, start, n_out in ((N, 0, N), (N - 1, 0, N), (N, 2 * L, L), (N, 333, 1000)):
            ops.reset_launch_counts()
            a_ml, mv_ml = ops.decode_move_leaves(f_ml, ls, n_out, guard=guard, start=start)
            got_launches = ops.decode_move_leaves.launches
            ra, rmv = ops.decode_move_leaves_ref(f_ml, ls, n_out, guard, start)
            err["decode_move_leaves"] = max(err["decode_move_leaves"], max_abs(a_ml, ra),
                                            *(max_abs(x.float(), y.float())
                                              for x, y in zip(mv_ml, rmv)))
            label = f"B4 over leaves [{what}, guard {guard}, slots {start}+{n_out}]"
            check(torch.equal(a_ml, ra) and all(torch.equal(word_bits(x), word_bits(y))
                                                for x, y in zip(mv_ml, rmv)),
                  f"{label}: differs from its plain version")
            check(got_launches == launches_want,
                  f"{label}: {got_launches} launches, want ceil(leaves / 8) = {launches_want}")
            for v, mv in zip(ls, mv_ml):
                a4, mv4 = ops.decode_move(f_ml, v, n_out, guard=guard, start=start)
                check(torch.equal(a4, a_ml) and torch.equal(word_bits(mv4), word_bits(mv)),
                      f"{label}: differs from B4 a leaf")
    # A tree state under each move version (B4 over leaves, B3 a leaf, B5 and
    # an index_select a leaf): the same tree on every drawn slot.
    tree = {"x": leaves[0], "rest": (leaves[1], leaves[3], leaves[3].long())}
    moved_by = {ver: ops.resample_move_f(f_ml, tree, N, version=ver, guard_n=N - 1)
                for ver in (1, 6, 0)}
    for ver, (a_v, mv_v) in moved_by.items():
        for got, want in zip(apt._tree.tree_flatten(mv_v)[0],
                             apt._tree.tree_flatten(moved_by[1][1])[0]):
            check(torch.equal(a_v, moved_by[1][0]) and torch.equal(got[:N - 1], want[:N - 1]),
                  f"a tree state under move version {ver} differs from version 1")
    del leaves, unaligned, tree, moved_by
    ops.reset_launch_counts()
    print(f"B4 over leaves at 1M: 1 + 2 + 100 + 1 words a row (float32 and int32) in one launch, "
          f"nine leaves in two, unaligned rows: bitwise its plain version and B4 a leaf, whole, "
          f"guarded and as windows; a tree with an int64 leaf equal under move versions 1, 6, 0",
          flush=True)

    # The scan of B1 and B6 at the edges of its geometry, and at 1M and 16M:
    # against the plain versions, nondecreasing, and two calls bitwise equal.
    for length in scan_lengths(ops.PREFIX_TILE, ops.PREFIX_GROUP) + [N, 16 * N]:
        lw = torch.randn(length, generator=gen, device="cuda") * 2.0
        m = torch.max(lw)
        s1 = torch.sum(torch.exp(lw - m))
        n = min(length, N)
        e = torch.exp(lw - m)
        forms = (("extents_from_logw", lambda: ops.extents_from_logw(lw, m, s1, 0.37, n),
                  lambda: ops.extents_from_logw_ref(lw, m, s1, 0.37, n)),
                 ("scaled_prefix_from_logw", lambda: ops.scaled_prefix_from_logw(lw, m, n / s1),
                  lambda: ops.scaled_prefix_ref(lw, m, n / s1, True)),
                 ("prefix_sum", lambda: ops.prefix_sum(e),
                  lambda: ops.scaled_prefix_ref(e, None, None, False)))
        for name, kernel_fn, plain in forms:
            got, again, want = kernel_fn(), kernel_fn(), plain()
            check(torch.equal(bits(got), bits(again)), f"{name} at {length}: two calls differ")
            check(nondecreasing(got), f"{name} at {length}: not nondecreasing")
            if name == "extents_from_logw":
                diff = (got.long() - want.long()).abs()
                check(int(diff.max()) <= 1 and int((diff > 0).sum()) <= max(2, 1e-3 * length),
                      f"{name} at {length}: differs by {int(diff.max())} in {int((diff > 0).sum())}")
            else:
                check(max_ulps(got, want) <= 1, f"{name} at {length}: {max_ulps(got, want)} ulps")
            err[name] = max(err[name], max_abs(got, want))
        del lw, e
    # A prefix that falls is held at its running max, across tiles too.
    x_neg = torch.randn(5 * ops.PREFIX_TILE + 3, generator=gen, device="cuda")
    check(torch.equal(ops.prefix_sum(x_neg), ops.scaled_prefix_ref(x_neg, None, None, False)),
          "prefix_sum of inputs with negative entries differs from its plain version")
    print(f"B1 and B6 at the edges of the scan's geometry (tile {ops.PREFIX_TILE}, groups of "
          f"{ops.PREFIX_GROUP}; lengths {scan_lengths(ops.PREFIX_TILE, ops.PREFIX_GROUP)}, 1M and "
          f"16M): extents within 1, prefixes within 1 ulp, nondecreasing, two calls bitwise "
          f"equal; a falling prefix held at its running max", flush=True)

    for i, profile in enumerate(["lognormal", "uniform", "single", "survivors20"]):
        logw = profile_logw(profile, gen)
        m = torch.max(logw)
        s1 = torch.sum(torch.exp(logw - m))
        u = apt.rng.uniform(apt.rng.key(1000 + i))
        f = ops.extents_from_logw(logw, m, s1, u, N)
        f_ref = ops.extents_from_logw_ref(logw, m, s1, u, N)
        diff = (f.long() - f_ref.long()).abs()
        flips = float((diff > 0).float().mean())
        check(nondecreasing(f), f"{profile}: extents not nondecreasing")
        # f[-1] is n, or n−1 where fl32(n·cdf − u) rounds down to n−1 (u near 1);
        # the decode reads f[-1] as n (the undershoot guard).
        check(int(f[-1]) in (N - 1, N), f"{profile}: f[-1] = {int(f[-1])}")
        check(int(diff.max()) <= 1 and flips <= 1e-3,
              f"{profile}: extents differ by {int(diff.max())} in {flips:.2e} of entries")
        err["extents_from_logw"] = max(err["extents_from_logw"], float(diff.max()))

        anc = ops.decode_ancestors(f, N)
        anc_ref = ops.decode_ancestors_ref(f, N)
        check(torch.equal(anc, anc_ref), f"{profile}: decoded ancestors differ")
        x = torch.randn(N, generator=gen, device="cuda")
        xd = torch.randn(N, 3, generator=gen, device="cuda")
        for v in (x, xd):
            anc_c, moved = ops.move_rows(anc, v)
            anc_c_ref, moved_ref = ops.resample_move_ref(anc, v)
            check(torch.equal(anc_c, anc_c_ref), f"{profile}: clipped ancestors differ")
            check(torch.equal(bits(moved), bits(moved_ref)), f"{profile}: moved rows differ")
            check(torch.equal(bits(moved), bits(v[anc_c.long()])), f"{profile}: not v[anc]")

        # Guard case: N−1 positions drawn, slot N−1 decodes past the population.
        f_g = ops.extents_from_logw(logw, m, s1, u, N - 1)
        anc_g = ops.decode_ancestors(f_g, N, guard=N - 1)
        check(torch.equal(anc_g, ops.decode_ancestors_ref(f_g, N, guard=N - 1)),
              f"{profile}: guarded ancestors differ")
        check(int(anc_g[-1]) == N, f"{profile}: guarded last slot anc = {int(anc_g[-1])}")
        anc_gc, moved_g = ops.move_rows(anc_g, x)
        check(int(anc_gc[-1]) == N - 1 and float(moved_g[-1]) == 0.0,
              f"{profile}: guarded last slot not clipped / zeroed")
        check(torch.equal(bits(moved_g), bits(ops.resample_move_ref(anc_g, x)[1])),
              f"{profile}: guarded move differs")

        # B4, B5 and the windowed B2 for n = N and the guard case.
        for n, f_n in ((N, f), (N - 1, f_g)):
            check_decode_forms(ops, f_n, n, (x, xd), f"{profile} n={n}", err)

        # B6-B8 as stratified and multinomial use them, for n = N and the
        # guard case n = N − 1.
        rs_key = apt.rng.key(2000 + i)
        ulp6 = {"scaled_prefix_from_logw": 0, "prefix_sum": 0}
        for n in (N, N - 1):
            c = ops.scaled_prefix_from_logw(logw, m, n / s1)
            c_ref = ops.scaled_prefix_ref(logw, m, n / s1, True)
            g = apt.multinomial_spacings(rs_key, n, device="cuda")
            S = ops.prefix_sum(g)
            S_ref = ops.scaled_prefix_ref(g, None, None, False)
            thr = ops.scaled_prefix_from_logw(logw, m, S[n] / s1)
            thr_ref = ops.scaled_prefix_ref(logw, m, S[n] / s1, True)
            for name, got, want in (("scaled_prefix_from_logw", c, c_ref),
                                    ("scaled_prefix_from_logw", thr, thr_ref),
                                    ("prefix_sum", S, S_ref)):
                check(nondecreasing(got), f"{profile} n={n}: {name} not nondecreasing")
                ulp6[name] = max(ulp6[name], max_ulps(got, want))
                err[name] = max(err[name], float((got - want).abs().max()))
            check(max(ulp6.values()) <= 1, f"{profile} n={n}: B6 off by {ulp6} ulps")
            f_s = apt.stratified_extents(rs_key, c, n)
            check(nondecreasing(f_s), f"{profile} n={n}: stratified extents not nondecreasing")
            edge = torch.tensor([-1.0] * 10 + [3e38] * 10 + [math.inf] * 10, device="cuda")
            cases = [("thresholds", S[:n], thr),
                     ("one value", S[:n], torch.full_like(thr, float(S[n // 2]))),
                     ("one tile", S[:n], torch.linspace(float(S[n // 3]), float(S[n // 3 + 1]),
                                                        N, device="cuda").sort().values),
                     ("heavy ties", torch.floor(S[:n] / 7) * 7, torch.floor(thr / 7) * 7),
                     ("ns != nt, unaligned", S[1:n // 3], thr[3:700_000]),
                     ("below, above, inf", S[:n], torch.cat([edge[:10], thr[:-30], edge[10:]])),
                     ("one entry", S[:1], thr[:1])]
            for what, s_, t_ in cases:
                want = ops.count_le_sorted_ref(s_, t_)
                for fn in (ops.count_le_sorted_bs, ops.count_le_sorted):
                    got = fn(s_, t_)
                    err[fn.__name__] = max(err[fn.__name__], max_abs(got, want))
                    check(torch.equal(got, want), f"{profile} n={n} {what}: {fn.__name__} differs")
            # B7 takes any thresholds: unsorted, and NaN (which counts all of s).
            t_any = thr[torch.randperm(N, generator=gen, device="cuda")]
            t_any[::1000] = math.nan
            check(torch.equal(ops.count_le_sorted_bs(S[:n], t_any),
                              ops.count_le_sorted_ref(S[:n], t_any)),
                  f"{profile} n={n}: B7 differs on unsorted thresholds with NaN")
            f_m = ops.count_le_sorted_bs(S[:n], thr)
            for f_x in (f_s, f_m):
                a_x = ops.decode_ancestors(f_x, N, guard=n)
                check(torch.equal(a_x, ops.decode_ancestors_ref(f_x, N, guard=n)),
                      f"{profile} n={n}: decode of scheme extents differs")
                check((int(a_x[-1]) == N) == (n == N - 1), f"{profile} n={n}: guard slot")
        print(f"kernels vs plain [{profile}]: extents ±{int(diff.max())} in {flips:.2e} of "
              f"entries, decode exact, move bitwise (D=1, D=3), guard ok; B4, B5 and the "
              f"windowed B2 exact and bitwise (whole, {K} windows, 3L rows); B6 within "
              f"{ulp6} ulps and nondecreasing; B7 = B8 = plain "
              f"(thresholds, one value, one tile, heavy ties, ns != nt unaligned, below/above/"
              f"inf, one entry); B7 = plain on unsorted thresholds with NaN", flush=True)
    torch.cuda.synchronize()
    chain_kernel_checks(ops, gen, err)
    chain_decode_checks(ops, gen, err)
    move_rows_checks(ops, gen, err)
    threefry_checks(apt, tfops, err)
    levy_checks(apt, levy_ops)

    # ---- 4. the SMC flagship with each fused scheme, through sample
    model = apt.models.stationary_lgssm(A, Q, R)
    _, ys = apt.simulate(torch.Generator().manual_seed(0), model, T)
    traced = apt.TracedSSM(model, ys)
    kf_ll = float(apt.utils.kalman_filter(ys, A, 0.0, Q, 1.0, R, 0.0, SIGMA0).log_likelihood)
    kernel = apt.SSMKernel(traced.to("cuda"))
    key = apt.rng.key(1)
    schemes = {
        "systematic": apt.resample_systematic,
        "stratified": apt.resample_stratified,
        "multinomial": apt.resample_multinomial,
        "multinomial, merge path": apt.resample_multinomial,
    }
    evidence, ancestors = {}, {}
    per_sweep, per_pgas_iteration = {}, {}
    for label, fn in schemes.items():
        ops.COUNT_LE_SORTED = "merge" if "merge" in label else "bs"
        sampler = apt.SMC(N, apt.ResampleWithESSThreshold(fn))
        t0 = time.perf_counter()
        # Systematic names no device: the default itself, the card, is driven.
        where = {} if label == "systematic" else {"device": "cuda"}
        smc, launches = drive(lambda: apt.sample(key, traced, sampler, **where))
        first_s = time.perf_counter() - t0
        log_z = float(smc.log_evidence)
        n_rs = int(smc.diagnostics["resampled"].sum())
        print(f"flagship [{label}]: logZ {log_z:.6f} kalman {kf_ll:.6f} "
              f"|err| {abs(log_z - kf_ll):.6f} resampled {n_rs}/{T} launches {launches} "
              f"first call {first_s:.3f}s {tag}", flush=True)
        check(math.isfinite(log_z), f"{label}: logZ is not finite")
        check(abs(log_z - kf_ll) < 0.1, f"{label}: |logZ - kalman| = {abs(log_z - kf_ll)} >= 0.1")
        check(n_rs > 0, f"{label}: the gate never fired")
        check(launches == expected(PER_FIRING[label], n_rs),
              f"{label}: launches {launches} != {expected(PER_FIRING[label], n_rs)}")
        # One positional normal a step, init included; stratified and
        # multinomial draw their uniforms in one pass a firing.
        check_draws(drive, label, draws(normal=T, uniform=0 if label == "systematic" else n_rs))
        check(tuple(smc.trajectories.shape) == (T, N), f"{label}: trajectories shape")
        check(bool(torch.isfinite(smc.trajectories).all()), f"{label}: trajectories not finite")
        check(abs(float(smc.weights.sum()) - 1.0) < 1e-4, f"{label}: weights do not sum to 1")

        a = apt.sweep(key, kernel, N, sampler.resampler, store_states=False, device="cuda")
        b = apt.sweep(key, kernel, N, sampler.resampler, store_states=False, device="cuda")
        check(torch.equal(a.log_evidence, b.log_evidence), f"{label}: same key, logZ differs")
        check(torch.equal(a.ancestors, b.ancestors), f"{label}: same key, ancestors differ")
        check(torch.equal(a.log_evidence, smc.log_evidence), f"{label}: sweep and sample disagree")
        check(a.ancestors.is_cuda, f"{label}: the sweep did not run on the card")
        evidence[label] = smc.log_evidence
        per_sweep[label] = {k: v for k, v in {**launches, **drive.draws}.items() if v}
        if fn is apt.resample_multinomial:
            # The counts are exact, so the sweep is what the earlier kernels gave.
            check(f"{abs(log_z - kf_ll):.6f}" == EARLIER_MULTINOMIAL_ERR,
                  f"{label}: |logZ - kalman| is not the {EARLIER_MULTINOMIAL_ERR} recorded for "
                  f"the earlier kernel")
            ancestors[label] = a.ancestors
    # B7 and B8 give the same counts, so the same key gives the same sweep.
    check(torch.equal(evidence["multinomial"], evidence["multinomial, merge path"])
          and torch.equal(ancestors["multinomial"], ancestors["multinomial, merge path"]),
          "multinomial: B7 and B8 sweeps differ")
    del ancestors
    ops.COUNT_LE_SORTED = "bs"
    print("repeat: same key gives bitwise equal logZ and ancestors for every scheme; "
          "B7 and B8 multinomial sweeps bitwise equal (logZ and ancestors), at the "
          "|logZ - kalman| recorded for the earlier kernels", flush=True)

    # The systematic flagship under each move version: B4 (1) and B5 (0)
    # launch once per firing in place of B2 + B3 (6), with the same result.
    systematic = apt.ResampleWithESSThreshold(apt.resample_systematic)
    by_version = {}
    for ver in (6, 1, 0):
        ops.MOVE_VERSION = ver
        res, launches = drive(lambda: apt.sweep(key, kernel, N, systematic, store_states=False,
                                                device="cuda"))
        fires = int(res.resampled.sum())
        print(f"flagship [systematic, move version {ver}]: logZ {float(res.log_evidence):.6f} "
              f"launches {launches}", flush=True)
        check(launches == expected(PER_VERSION[ver], fires),
              f"move version {ver}: launches {launches} != {expected(PER_VERSION[ver], fires)}")
        check_draws(drive, f"move version {ver}", draws(normal=T))
        by_version[ver] = res
    ops.MOVE_VERSION = DEFAULT_MOVE
    single = by_version[DEFAULT_MOVE]
    for ver in (6, 1, 0):
        check(torch.equal(by_version[ver].log_evidence, single.log_evidence)
              and torch.equal(by_version[ver].ancestors, single.ancestors),
              f"move version {ver}: sweep differs from version {DEFAULT_MOVE}")
    print("move versions 6, 1, 0: bitwise equal logZ and ancestors", flush=True)

    # ---- 5. the sharded flagship on K logical shards of the card
    from advancedps_tpu_torch import parallel
    from advancedps_tpu_torch.parallel import sharded as sharded_mod

    mesh = parallel.particle_mesh(K)  # no device named: K shards on the card
    per_shard_move = {name: K * c for name, c in DECODE_MOVE[WINDOWED_MOVE].items()}
    check(all(d.type == "cuda" for d in mesh.devices), "particle_mesh(K) is not on the card")
    sharded = {}
    for ex in ("allgather", "neighbor", "auto"):
        mesh.reset_counts()
        t0 = time.perf_counter()
        res, launches = drive(lambda: parallel.sharded_sweep(key, kernel, N, systematic, mesh,
                                                             store_states=False, exchange=ex))
        first_s = time.perf_counter() - t0
        branches = dict(mesh.exchanges)
        log_z = float(res.log_evidence)
        same = res.ancestors == single.ancestors
        agree = float(same.double().mean())
        # The sharded Σe is a psum of per-shard float32 sums, the
        # single-device one a torch.sum over all N: an ulp apart, they move
        # the extents within that ulp of a stratum boundary by one.  Until
        # the first such firing the two sweeps are the same computation;
        # there, the extents the two decodes inverted (#{k : anc_k ≤ j}, read
        # back from the ancestors) differ by at most one.
        flips = (~same).sum(1)
        first = int(torch.argmax((flips > 0).int())) if bool(flips.any()) else T
        off = 0 if first == T else int(
            (extents_of(res.ancestors[first]) - extents_of(single.ancestors[first])).abs().max())
        rs_equal = torch.equal(res.resampled, single.resampled)
        rs_equal_to_first = torch.equal(res.resampled[:first + 1], single.resampled[:first + 1])
        dlz = abs(log_z - float(single.log_evidence))
        print(f"sharded flagship [{ex}] K={K}: logZ {log_z:.6f} |err| {abs(log_z - kf_ll):.6f} "
              f"vs single-device: first flip at step {first} "
              f"(after {int(single.resampled[:first].sum())} firings; "
              f"{0 if first == T else int(flips[first])} ancestors, extents off by {off}), "
              f"ancestors agree {agree:.6f}, |dlogZ| {dlz:.3e}, flags equal {rs_equal}; "
              f"firings by branch {branches}; collectives {dict(mesh.calls)}; "
              f"launches {launches}; first call {first_s:.3f}s {tag}", flush=True)
        check(abs(log_z - kf_ll) < 0.1, f"sharded {ex}: |logZ - kalman| = {abs(log_z - kf_ll)}")
        check(rs_equal_to_first, f"sharded {ex}: flags differ before the first flip")
        check(off <= 1, f"sharded {ex}: extents off by {off} at the first flip (step {first})")
        check(dlz < 0.05, f"sharded {ex}: |dlogZ| = {dlz}")
        n_ag = branches.get("allgather", 0)
        fires_ex = int(res.resampled.sum())
        check(sum(branches.values()) == fires_ex, f"sharded {ex}: branches {branches}")
        want = expected(per_shard_move, fires_ex)
        want["extents_from_logw"] = K * n_ag
        check(launches == want, f"sharded {ex}: launches {launches} != {want}")
        check_draws(drive, f"sharded {ex}", draws(normal=K * T))  # each shard its own
        sharded[ex] = (res, branches)
    ag, nb = sharded["allgather"][0], sharded["neighbor"][0]
    print(f"sharded flagship: allgather against neighbor: "
          f"{int((ag.ancestors != nb.ancestors).sum())} ancestors differ, logZ equal "
          f"{torch.equal(ag.log_evidence, nb.log_evidence)}", flush=True)
    auto, auto_branches = sharded["auto"]
    if auto_branches.get("allgather", 0) == 0:
        check(torch.equal(auto.log_evidence, sharded["neighbor"][0].log_evidence)
              and torch.equal(auto.ancestors, sharded["neighbor"][0].ancestors),
              "sharded: auto differs from neighbor though every firing took the neighbour branch")
    ops.MOVE_VERSION = OTHER_WINDOWED_MOVE
    mesh.reset_counts()
    res, launches = drive(lambda: parallel.sharded_sweep(key, kernel, N, systematic, mesh,
                                                         store_states=False))
    ops.MOVE_VERSION = DEFAULT_MOVE
    check(torch.equal(res.log_evidence, auto.log_evidence)
          and torch.equal(res.ancestors, auto.ancestors),
          f"sharded: move version {OTHER_WINDOWED_MOVE} differs from version {WINDOWED_MOVE}")
    want = expected({name: K * c for name, c in DECODE_MOVE[OTHER_WINDOWED_MOVE].items()},
                    int(auto.resampled.sum()))
    want["extents_from_logw"] = launches["extents_from_logw"]  # by the exchange's branch
    check(launches == want, f"sharded, move version {OTHER_WINDOWED_MOVE}: launches {launches}")
    check_draws(drive, f"sharded, move version {OTHER_WINDOWED_MOVE}", draws(normal=K * T))
    print(f"sharded flagship: auto bitwise equal to neighbor "
          f"({'checked' if auto_branches.get('allgather', 0) == 0 else 'not checked: a firing fell back'}); "
          f"move version {OTHER_WINDOWED_MOVE} ({launches}) bitwise equal to {WINDOWED_MOVE}",
          flush=True)

    # ---- 6. PGAS at 1M, replay storage (bench_pgas.py), single-device and sharded
    sm = apt.utils.kalman_smoother(ys, A, 0.0, Q, 1.0, R, 0.0, SIGMA0)
    pgas = apt.PGAS(N)

    # The RTS anchor at this size (bench_pgas.py's 6 chains of 8 iterations)
    # is the bench's pgas mode in phase 11; here one chain of them.
    t0 = time.perf_counter()
    last, launches = drive(lambda: apt.sample(apt.rng.fold_in(apt.rng.key(9), 0), traced, pgas,
                                              PGAS_ITERS, trajectory_storage="replay",
                                              device="cuda"))
    chain_s = time.perf_counter() - t0
    iters = PGAS_ITERS
    lz_err = abs(float(last.log_evidence[-1]) - float(sm.log_likelihood))
    print(f"PGAS N={N} T={T} replay: one chain of {PGAS_ITERS} iterations in {chain_s:.3f}s; "
          f"final-iteration |logZ - kalman| {lz_err:.6f}; launches {launches} {tag}", flush=True)
    check(bool(torch.isfinite(last.trajectory).all()), "PGAS trajectory not finite")
    check(lz_err < 1.0, f"PGAS: final |logZ - kalman| = {lz_err} >= 1")
    check(launches == expected(PER_FIRING["systematic"], iters * (T - 1)),
          f"PGAS: launches {launches}, expected {T - 1} of B1 and the decode + move per "
          f"iteration")
    check_draws(drive, "PGAS", pgas_draws(PGAS_ITERS))
    per_pgas_iteration["systematic"] = {k: v // iters for k, v in launches.items() if v}

    for label in ("multinomial", "stratified"):
        sampler = apt.PGAS(N, resampler=schemes[label])
        chain, launches = drive(lambda: apt.sample(apt.rng.key(11), traced, sampler, 2,
                                                   trajectory_storage="replay", device="cuda"))
        print(f"PGAS [{label}] 2 iterations: logZ {chain.log_evidence.tolist()} "
              f"launches {launches}", flush=True)
        check(bool(torch.isfinite(chain.trajectory).all()), f"PGAS {label}: not finite")
        check(float((chain.log_evidence - sm.log_likelihood).abs().max()) < 1.0,
              f"PGAS {label}: |logZ - kalman| >= 1")
        check(launches == expected(PER_FIRING[label], 2 * (T - 1)),
              f"PGAS {label}: launches {launches}")
        check_draws(drive, f"PGAS {label}", pgas_draws(2, firing_uniforms=1))
        per_pgas_iteration[label] = {k: v // 2 for k, v in launches.items() if v}
        if label == "multinomial":
            check(chain.log_evidence.tolist() == EARLIER_MULTINOMIAL_PGAS_LOGZ,
                  "PGAS multinomial: logZ is not what the chain on the earlier B7 gave")

    st = apt.PGState(last.trajectory[-1])
    k_rd = apt.rng.key(12)
    dense, _ = apt.step_pg(k_rd, traced, pgas, st, "dense", device="cuda")
    (repl, _), _ = drive(lambda: apt.step_pg(k_rd, traced, pgas, st, "replay", device="cuda"))
    # One iteration with a reference: the draws of a PGAS iteration of the chain.
    check_draws(drive, "one PGAS iteration", pgas_draws(1, conditional=1))
    per_pgas_iteration["systematic"].update({k: v for k, v in drive.draws.items() if v})
    rd_err = float((dense.trajectory - repl.trajectory).abs().max())
    print(f"PGAS replay vs dense storage, one iteration: max |diff| {rd_err:.3e}, "
          f"logZ equal {torch.equal(dense.log_evidence, repl.log_evidence)}", flush=True)
    check(rd_err <= 1e-5, f"replay and dense trajectories differ by {rd_err}")
    check(torch.equal(dense.log_evidence, repl.log_evidence), "replay and dense logZ differ")

    # Sharded PGAS: K shards, replay storage, the auto exchange.  Every step
    # fires, each firing launches the decode and move on every shard.
    mesh.reset_counts()
    t0 = time.perf_counter()
    chain, launches = drive(lambda: parallel.sharded_sample_pg(
        apt.rng.key(40), kernel, pgas, mesh, SHARDED_PGAS_ITERS, trajectory_storage="replay"))
    sharded_pgas_s = (time.perf_counter() - t0) / SHARDED_PGAS_ITERS
    branches = dict(mesh.exchanges)
    lz_err = abs(float(chain.log_evidence[-1]) - float(sm.log_likelihood))
    single_chain = apt.sample(apt.rng.key(40), traced, pgas, SHARDED_PGAS_ITERS,
                              trajectory_storage="replay", device="cuda")
    print(f"sharded PGAS N={N} T={T} K={K} replay auto: {SHARDED_PGAS_ITERS} iterations, "
          f"{1 / sharded_pgas_s:.4f} iterations/s (first call included); logZ "
          f"{chain.log_evidence.tolist()}; final |logZ - kalman| {lz_err:.6f}; against the "
          f"single-device chain of the same key: max |traj diff| "
          f"{float((chain.trajectory - single_chain.trajectory).abs().max()):.3e}, max |dlogZ| "
          f"{float((chain.log_evidence - single_chain.log_evidence).abs().max()):.3e}; "
          f"firings by branch {branches}; launches {launches} {tag}", flush=True)
    check(bool(torch.isfinite(chain.trajectory).all()), "sharded PGAS trajectory not finite")
    check(lz_err < 1.0, f"sharded PGAS: final |logZ - kalman| = {lz_err}")
    firings = SHARDED_PGAS_ITERS * (T - 1)
    want = expected(per_shard_move, firings)
    want["extents_from_logw"] = K * branches.get("allgather", 0)
    check(sum(branches.values()) == firings and launches == want,
          f"sharded PGAS: launches {launches} != {want}")
    # Each shard draws its own normals and ancestor uniforms; the replay and
    # the retained draw run once.
    check_draws(drive, "sharded PGAS", pgas_draws(SHARDED_PGAS_ITERS, shards=K))
    st_s = apt.PGState(chain.trajectory[-1])
    k_rd = apt.rng.key(41)
    dense, _ = parallel.sharded_step_pg(k_rd, kernel, pgas, mesh, st_s, trajectory_storage="dense")
    repl, _ = parallel.sharded_step_pg(k_rd, kernel, pgas, mesh, st_s, trajectory_storage="replay")
    rd_err = float((dense.trajectory - repl.trajectory).abs().max())
    print(f"sharded PGAS replay vs dense storage, one iteration: max |diff| {rd_err:.3e}, "
          f"logZ equal {torch.equal(dense.log_evidence, repl.log_evidence)}", flush=True)
    check(rd_err <= 1e-5, f"sharded: replay and dense trajectories differ by {rd_err}")
    check(torch.equal(dense.log_evidence, repl.log_evidence), "sharded: replay and dense logZ differ")

    # Sharded chains: 2 chain rows × 2 particle shards (all-gather exchange).
    cmesh = parallel.chain_particle_mesh(2, 2, "cuda")
    t0 = time.perf_counter()
    (trajs, lzs), launches = drive(lambda: parallel.sharded_chains_pg(
        apt.rng.key(50), kernel, pgas, cmesh, 2, CHAIN_ITERS))
    chains_s = time.perf_counter() - t0
    trajs2, lzs2 = parallel.sharded_chains_pg(apt.rng.key(50), kernel, pgas, cmesh, 2, CHAIN_ITERS)
    print(f"sharded chains on a 2 x 2 chain mesh, N={N}: 2 chains x {CHAIN_ITERS} iterations in "
          f"{chains_s:.3f}s; logZ {lzs.tolist()}; same key bitwise equal "
          f"{torch.equal(trajs, trajs2) and torch.equal(lzs, lzs2)}; launches {launches} {tag}",
          flush=True)
    check(tuple(trajs.shape) == (2, CHAIN_ITERS, T), "sharded chains: trajectory shape")
    check(bool(torch.isfinite(lzs).all()), "sharded chains: logZ not finite")
    check(torch.equal(trajs, trajs2) and torch.equal(lzs, lzs2), "sharded chains: not repeatable")
    firings = 2 * CHAIN_ITERS * (T - 1) * 2  # chains × iterations × steps × shards
    check(launches == expected({"extents_from_logw": 1, **DECODE_MOVE[WINDOWED_MOVE]}, firings),
          f"sharded chains: launches {launches}")
    check_draws(drive, "sharded chains", pgas_draws(
        2 * CHAIN_ITERS, conditional=2 * (CHAIN_ITERS - 1), replay=False, shards=2))

    # ---- 7. timings
    base = apt.ResampleWithESSThreshold(apt.resample_systematic, 0.0)  # never fires
    sweep_ms = {}
    for label, resampler in [("base, never firing", base)] + [
            (lb, apt.ResampleWithESSThreshold(fn)) for lb, fn in schemes.items()
            if "merge" not in lb]:
        times, firings = [], []
        for i in range(SWEEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = apt.sweep(apt.rng.key(10 + i), kernel, N, resampler, store_states=False,
                            device="cuda")
            float(res.log_evidence)
            times.append(time.perf_counter() - t0)
            firings.append(int(res.resampled.sum()))
        med = statistics.median(times)
        sweep_ms[label] = (med * 1e3, statistics.mean(firings))
        print(f"sweep [{label}] N={N} T={T}: median {med * 1e3:.3f} ms of {SWEEPS} "
              f"({', '.join(f'{t * 1e3:.3f}' for t in times)}), firings {firings}, "
              f"{N * T / med:.4e} particle-steps/s {tag}", flush=True)
    base_ms = sweep_ms["base, never firing"][0]
    for label, (ms, fires) in sweep_ms.items():
        if fires:
            print(f"per firing [{label}]: {(ms - base_ms) / fires:.4f} ms "
                  f"((median {ms:.3f} - base {base_ms:.3f}) / {fires:.1f} firings) {tag}",
                  flush=True)

    # The sharded sweep (auto) against the single-device one, in turns.
    turn_times = {"single-device": [], f"sharded K={K}": []}
    for i in range(SWEEPS):
        for label in turn_times:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if label == "single-device":
                res = apt.sweep(apt.rng.key(10 + i), kernel, N, systematic, store_states=False,
                                device="cuda")
            else:
                res = parallel.sharded_sweep(apt.rng.key(10 + i), kernel, N, systematic, mesh,
                                             store_states=False)
            float(res.log_evidence)
            turn_times[label].append(time.perf_counter() - t0)
    for label, times in turn_times.items():
        m_s = statistics.median(times)
        print(f"sweep [systematic, {label}] N={N} T={T}: median {m_s * 1e3:.3f} ms of {SWEEPS} "
              f"({', '.join(f'{t * 1e3:.3f}' for t in times)}), in turns with the other {tag}",
              flush=True)

    # Host time of each exchange, synchronised before and after it.
    spent = {"allgather": [], "neighbor": []}
    originals = {"allgather": sharded_mod._exchange_allgather,
                 "neighbor": sharded_mod._exchange_neighbor}

    def timed(name):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](*args, **kwargs)
            torch.cuda.synchronize()
            spent[name].append(time.perf_counter() - t0)
            return out
        return run

    sharded_mod._exchange_allgather, sharded_mod._exchange_neighbor = (
        timed("allgather"), timed("neighbor"))
    try:
        for ex in ("neighbor", "allgather"):
            parallel.sharded_sweep(apt.rng.key(15), kernel, N, systematic, mesh,
                                   store_states=False, exchange=ex)
    finally:
        sharded_mod._exchange_allgather = originals["allgather"]
        sharded_mod._exchange_neighbor = originals["neighbor"]
    for name, times in spent.items():
        print(f"exchange [{name}] K={K} at 1M: {statistics.mean(times) * 1e3:.4f} ms per firing "
              f"(host clock, synchronised; {len(times)} firings, median "
              f"{statistics.median(times) * 1e3:.4f} ms) {tag}", flush=True)

    windows = []
    st_t = st
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(3):
            smp, st_t = apt.step_pg(apt.rng.key(100 + 3 * i + j), traced, pgas, st_t,
                                    "replay", device="cuda")
        float(smp.log_evidence)
        windows.append((time.perf_counter() - t0) / 3)
    per_iter = statistics.median(windows)
    print(f"PGAS N={N} T={T} replay: {1 / per_iter:.4f} iterations/s (median of 5 windows of "
          f"3 iterations; per-iteration {', '.join(f'{w * 1e3:.3f}' for w in windows)} ms) {tag}",
          flush=True)

    logw = profile_logw("lognormal", gen)
    m = torch.max(logw)
    s1 = torch.sum(torch.exp(logw - m))
    u = apt.rng.uniform(apt.rng.key(7))
    f = ops.extents_from_logw(logw, m, s1, u, N)
    anc = ops.decode_ancestors(f, N)
    x = torch.randn(N, generator=gen, device="cuda")
    xd = torch.randn(N, 3, generator=gen, device="cuda")
    wide_leaves = (x, torch.randn(N, 2, generator=gen, device="cuda"),
                   torch.randn(N, T, generator=gen, device="cuda"),
                   torch.randint(0, 1 << 30, (N,), generator=gen, device="cuda",
                                 dtype=torch.int32))
    f_16m = torch.arange(1, 16 * N + 1, dtype=torch.int32, device="cuda") // 3 * 3
    scale = N / s1
    g = apt.multinomial_spacings(apt.rng.key(8), N, device="cuda")
    S = ops.prefix_sum(g)
    thr = ops.scaled_prefix_from_logw(logw, m, S[N] / s1)
    s_, one = S[:N], torch.full_like(thr, float(S[N // 2]))
    # Per kernel: the plain version and the wrapper as functions of the
    # tensors the kernel must read, the one PyTorch call that computes the
    # same function (None where there is none: B1 and B6 are a cumsum chain
    # with an epilogue, B4 a decode and a move; B5 computes B2's function, so
    # B2's call is its call too), and those tensors.  The library calls' own inputs are made here,
    # outside the windows.
    f_guarded = torch.cat([f[:-1], torch.full((1,), N, dtype=f.dtype, device="cuda")])
    slots = torch.arange(N, dtype=torch.int32, device="cuda")

    def count_library():
        return torch.searchsorted(s_, thr, right=True, out_int32=True)

    def decode_library():
        return torch.searchsorted(f_guarded, slots, right=True, out_int32=True)

    measured = {
        "extents_from_logw": (
            lambda lw: ops.extents_from_logw_ref(lw, m, s1, u, N),
            lambda lw: ops.extents_from_logw(lw, m, s1, u, N), None, (logw,)),
        "decode_ancestors": (
            lambda f_: ops.decode_ancestors_ref(f_, N), lambda f_: ops.decode_ancestors(f_, N),
            decode_library, (f,)),
        "move_rows": (
            ops.resample_move_ref, ops.move_rows, lambda: x.index_select(0, anc), (anc, x)),
        "decode_move": (
            lambda f_, v: ops.decode_move_ref(f_, v, N), lambda f_, v: ops.decode_move(f_, v, N),
            None, (f, x)),
        "decode_ancestors_dense": (
            lambda f_: ops.decode_ancestors_dense_ref(f_, N),
            lambda f_: ops.decode_ancestors_dense(f_, N), decode_library, (f,)),
        "scaled_prefix_from_logw": (
            lambda lw: ops.scaled_prefix_ref(lw, m, scale, True),
            lambda lw: ops.scaled_prefix_from_logw(lw, m, scale), None, (logw,)),
        "prefix_sum": (
            lambda g_: ops.scaled_prefix_ref(g_, None, None, False), ops.prefix_sum, None, (g,)),
        "count_le_sorted_bs": (
            ops.count_le_sorted_ref, ops.count_le_sorted_bs, count_library, (s_, thr)),
        "count_le_sorted": (
            ops.count_le_sorted_ref, ops.count_le_sorted, count_library, (s_, thr)),
        # B4 over leaves at 1 + 2 + 100 + 1 words a row: its library yardstick
        # is B2 and one index_select a leaf (no single call moves a list).
        "decode_move_leaves": (
            lambda f_, *ls: ops.decode_move_leaves_ref(f_, list(ls), N),
            lambda f_, *ls: ops.decode_move_leaves(f_, list(ls), N),
            lambda: (lambda a: [v.index_select(0, a) for v in wide_leaves])(
                ops.decode_ancestors(f, N)),
            (f, *wide_leaves)),
    }

    # The kernels with the chain axis at the flagship ensemble's 8 x 1M: B4
    # over leaves on 1 + 2 + 1 words a row.
    C = ENSEMBLE_RUNS
    cl, cm, cs1, cu = chain_case(C, N, gen)
    cscale = N / cs1
    cg = -torch.log1p(-torch.rand(C, N + 1, generator=gen, device="cuda"))
    cf = ops.extents_from_logw_chains(cl, cm, cs1, cu, N)
    cx = torch.randn(C, N, generator=gen, device="cuda")
    c_leaves = (cx, torch.randn(C, N, 2, generator=gen, device="cuda"),
                torch.randint(0, 1 << 30, (C, N), generator=gen, device="cuda", dtype=torch.int32))
    measured.update({
        "extents_from_logw_chains": (
            lambda lw: ops.extents_from_logw_chains_ref(lw, cm, cs1, cu, N),
            lambda lw: ops.extents_from_logw_chains(lw, cm, cs1, cu, N), None, (cl,)),
        "scaled_prefix_from_logw_chains": (
            lambda lw: ops.scaled_prefix_chains_ref(lw, cm, cscale, True),
            lambda lw: ops.scaled_prefix_from_logw_chains(lw, cm, cscale), None, (cl,)),
        "prefix_sum_chains": (
            lambda g_: ops.scaled_prefix_chains_ref(g_, None, None, False), ops.prefix_sum_chains,
            None, (cg,)),
        "decode_move_chains": (
            lambda f_, v: ops.decode_move_chains_ref(f_, v, N),
            lambda f_, v: ops.decode_move_chains(f_, v, N), None, (cf, cx)),
        "decode_move_leaves_chains": (
            lambda f_, *ls: ops.decode_move_leaves_chains_ref(f_, list(ls), N),
            lambda f_, *ls: ops.decode_move_leaves_chains(f_, list(ls), N), None,
            (cf, *c_leaves)),
    })
    # B2, B3, B5, B7 and B8 with the chain axis at 8 x 1M, each beside the one
    # batched PyTorch call for its function: searchsorted over the rows (B2,
    # B5, B7, B8) and gather (B3).  B7 and B8 read the rows of S[:, :N] as the
    # engine hands them over; the library call gets a contiguous copy.
    c_raw = ops.decode_ancestors_chains(cf, N)
    c_idx = torch.clamp(c_raw, max=N - 1).long()
    cS = ops.prefix_sum_chains(cg)
    cs_ = cS[:, :N]
    cs_dense = cs_.contiguous()
    cthr = ops.scaled_prefix_from_logw_chains(cl, cm, cS[:, N] / cs1)
    cf_guarded = cf.clone()
    cf_guarded[:, -1] = N
    c_slots = torch.arange(N, dtype=torch.int32, device="cuda").expand(C, N).contiguous()

    def chains_decode_library():
        return torch.searchsorted(cf_guarded, c_slots, right=True, out_int32=True)

    def chains_count_library():
        return torch.searchsorted(cs_dense, cthr, right=True, out_int32=True)

    measured.update({
        "decode_ancestors_chains": (
            lambda f_: ops.decode_ancestors_chains_ref(f_, N),
            lambda f_: ops.decode_ancestors_chains(f_, N), chains_decode_library, (cf,)),
        "move_rows_chains": (
            ops.resample_move_chains_ref, ops.move_rows_chains,
            lambda: torch.gather(cx, 1, c_idx), (c_raw, cx)),
        "decode_ancestors_dense_chains": (
            lambda f_: ops.decode_ancestors_dense_chains_ref(f_, N),
            lambda f_: ops.decode_ancestors_dense_chains(f_, N), chains_decode_library, (cf,)),
        "count_le_sorted_bs_chains": (
            ops.count_le_sorted_chains_ref, ops.count_le_sorted_bs_chains, chains_count_library,
            (cs_, cthr)),
        "count_le_sorted_chains": (
            ops.count_le_sorted_chains_ref, ops.count_le_sorted_chains, chains_count_library,
            (cs_, cthr)),
    })

    def turns(readings):
        return ", ".join(f"{r:.4f}" for r in readings)

    # A move reads only the rows that own a slot: the rows of the others are
    # bytes it need not move, so its bound counts this run's owner rows.
    owners = int(torch.unique(anc).numel())
    c_anc = ops.decode_move_chains(cf, cx, N)[0]
    owners_c = sum(int(torch.unique(c_anc[r]).numel()) for r in range(C))
    # name -> (rows moved, rows in all, rows that own a slot)
    gathered = {"move_rows": ((x,), N, owners), "decode_move": ((x,), N, owners),
                "decode_move_leaves": (wide_leaves, N, owners),
                "decode_move_chains": ((cx,), C * N, owners_c),
                "decode_move_leaves_chains": (c_leaves, C * N, owners_c),
                "move_rows_chains": ((cx,), C * N, owners_c)}
    timing = {}
    for name, (plain, kernel_fn, library, inputs) in measured.items():
        call_ms, plain_call_ms, readings = plain_vs_kernel(lambda: plain(*inputs),
                                                           lambda: kernel_fn(*inputs))
        outputs = kernel_fn(*inputs)
        moved = nbytes(*inputs) + nbytes(*(outputs if isinstance(outputs, tuple) else (outputs,)))
        if name in gathered:
            vs, rows_all, own = gathered[name]
            moved -= sum(nbytes(v) // rows_all for v in vs) * (rows_all - own)
        # The same call on copies of its inputs taken in turn, 128 MB of them:
        # by the time a copy comes round again the 50 MB L2 has lost it.
        copies = [tuple(map(clone_as_laid, inputs)) for _ in range(-(-COLD_BYTES // moved))]
        turn = iter(range(10 ** 9))
        warm_ms, launches_per_call = device_ms_and_launches(lambda: kernel_fn(*inputs))
        row = {
            "device_ms": warm_ms, "launches_per_call": launches_per_call,
            "cold_device_ms": device_ms(lambda: kernel_fn(*copies[next(turn) % len(copies)])),
            "plain_ms": device_ms(lambda: plain(*inputs)),
            "library_ms": device_ms(library) if library is not None else None,
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "bytes": moved, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
        }
        del copies
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        row["cold_bound_share"] = row["bound_ms"] / row["cold_device_ms"]
        row["l2_bound_ms"] = moved / L2_BYTES_PER_S * 1e3
        timing[name] = row
        if name in gathered:
            row["owner_rows"] = gathered[name][2]
        lib_txt = "no single call" if library is None else f"{row['library_ms']:.5f} ms"
        at = f"{C} x 1M" if name.endswith("_chains") else "1M"
        print(f"kernel {name} at {at}: {launches_per_call} launch(es) a call, device "
              f"{row['device_ms']:.5f} ms L2-warm, "
              f"{row['cold_device_ms']:.5f} ms L2-cold, plain {row['plain_ms']:.5f} ms, library "
              f"{lib_txt}; bound {row['bound_ms']:.5f} ms ({moved} bytes at 3.35 TB/s"
              f"{f', {gathered[name][2]} owner rows' if name in gathered else ''}), share "
              f"{row['bound_share']:.4f} warm, {row['cold_bound_share']:.4f} cold; per call by "
              f"events, host included: {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms (plain, "
              f"kernel, kernel, plain: {turns(readings)}) {tag}", flush=True)
        # From device memory nothing moves faster than the bound; from the L2
        # nothing faster than the L2's ceiling.
        check(row["cold_bound_share"] <= 1.0, f"{name}: L2-cold device time "
              f"{row['cold_device_ms']} ms below its bound {row['bound_ms']} ms")
        check(row["device_ms"] >= row["l2_bound_ms"], f"{name}: L2-warm device time "
              f"{row['device_ms']} ms below the L2's ceiling {row['l2_bound_ms']} ms")
        if name in SINGLE_LAUNCH:
            check(launches_per_call == 1, f"{name}: {launches_per_call} device-side launches a "
                  f"call, the single-pass design has 1")
        if name in MOST_LAUNCHES:
            check(launches_per_call <= MOST_LAUNCHES[name], f"{name}: {launches_per_call} "
                  f"device-side launches a call, memsets counted, over {MOST_LAUNCHES[name]}")
        if row["bound_share"] > 1.0:
            print(f"  note: {name} L2-warm is faster than the device memory allows "
                  f"(share {row['bound_share']:.4f}): its tensors never left the L2", flush=True)
    tf_timing = threefry_timings(apt, tfops, tag)
    levy_timing(apt, levy_ops, tag)
    for what, plain, kernel_fn in (
            (f"decode_ancestors at 1M, window of L={L}",
             lambda: ops.decode_ancestors_ref(f, L, guard=N, start=2 * L),
             lambda: ops.decode_ancestors(f, L, guard=N, start=2 * L)),
            (f"decode_move at 1M, window of L={L}",
             lambda: ops.decode_move_ref(f, x, L, guard=N, start=2 * L),
             lambda: ops.decode_move(f, x, L, guard=N, start=2 * L)),
            ("decode_move at 1M, D = 3",
             lambda: ops.decode_move_ref(f, xd, N), lambda: ops.decode_move(f, xd, N)),
            ("decode_ancestors_dense at 16M rows and slots",
             lambda: ops.decode_ancestors_dense_ref(f_16m, 16 * N),
             lambda: ops.decode_ancestors_dense(f_16m, 16 * N))):
        k_ms, p_ms, readings = plain_vs_kernel(plain, kernel_fn)
        print(f"kernel {what}: device {device_ms(kernel_fn):.5f} ms, plain "
              f"{device_ms(plain):.5f} ms; per call by events {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"({turns(readings)}) {tag}", flush=True)
    del f_16m
    b3_reading(ops, "move_rows at 1M, D = 3", anc, xd, tag)
    residual_step_launches(apt, ops, gen, tag)
    # The kernels with the chain axis at 8 x 1M and 64 x 16,384 beside C
    # launches of the one-chain kernel on the same rows, device time, bound
    # and, where there is one, the one batched PyTorch call.
    for c_, n_ in ((ENSEMBLE_RUNS, N), (MANY_CHAINS, MANY_N)):
        lw_, m_, s1_, u_ = chain_case(c_, n_, gen)
        u_list = u_.tolist()
        f_ = ops.extents_from_logw_chains(lw_, m_, s1_, u_, n_)
        x_ = torch.randn(c_, n_, generator=gen, device="cuda")
        a_ = ops.decode_move_chains(f_, x_, n_)[0]
        raw_ = ops.decode_ancestors_chains(f_, n_)
        idx_ = a_.long()
        own_ = sum(int(torch.unique(a_[r]).numel()) for r in range(c_))
        Sc_ = ops.prefix_sum_chains(
            -torch.log1p(-torch.rand(c_, n_ + 1, generator=gen, device="cuda")))
        sc_ = Sc_[:, :n_]
        s_dense = sc_.contiguous()
        thr_ = ops.scaled_prefix_from_logw_chains(lw_, m_, Sc_[:, n_] / s1_)
        fg_ = f_.clone()
        fg_[:, -1] = n_
        slots_ = torch.arange(n_, dtype=torch.int32, device="cuda").expand(c_, n_).contiguous()

        def decode_lib():
            return torch.searchsorted(fg_, slots_, right=True, out_int32=True)

        def count_lib():
            return torch.searchsorted(s_dense, thr_, right=True, out_int32=True)

        rows = 4 * c_ * n_  # bytes of one int32 or float32 [C, N]
        forms = (  # name, the batched call, the loop of one-chain calls, bytes, library call
            ("B1 extents_from_logw_chains",
             lambda: ops.extents_from_logw_chains(lw_, m_, s1_, u_, n_),
             lambda: [ops.extents_from_logw(lw_[r], m_[r], s1_[r], u_list[r], n_)
                      for r in range(c_)], 2 * rows + nbytes(m_, s1_, u_), None),
            ("B2 decode_ancestors_chains", lambda: ops.decode_ancestors_chains(f_, n_),
             lambda: [ops.decode_ancestors(f_[r], n_) for r in range(c_)], 2 * rows, decode_lib),
            ("B3 move_rows_chains", lambda: ops.move_rows_chains(raw_, x_),
             lambda: [ops.move_rows(raw_[r], x_[r]) for r in range(c_)], 3 * rows + 4 * own_,
             lambda: torch.gather(x_, 1, idx_)),
            ("B4 decode_move_chains", lambda: ops.decode_move_chains(f_, x_, n_),
             lambda: [ops.decode_move(f_[r], x_[r], n_) for r in range(c_)],
             3 * rows + 4 * own_, None),
            ("B5 decode_ancestors_dense_chains", lambda: ops.decode_ancestors_dense_chains(f_, n_),
             lambda: [ops.decode_ancestors_dense(f_[r], n_) for r in range(c_)], 2 * rows,
             decode_lib),
            ("B7 count_le_sorted_bs_chains", lambda: ops.count_le_sorted_bs_chains(sc_, thr_),
             lambda: [ops.count_le_sorted_bs(sc_[r], thr_[r]) for r in range(c_)], 3 * rows,
             count_lib),
            ("B8 count_le_sorted_chains", lambda: ops.count_le_sorted_chains(sc_, thr_),
             lambda: [ops.count_le_sorted(sc_[r], thr_[r]) for r in range(c_)], 3 * rows,
             count_lib))
        for what, batched, loop, moved, library in forms:
            batched()
            torch.cuda.synchronize()
            by_kernel = device_rows(batched, REPS)
            ms = sum(e.self_device_time_total for e in by_kernel) / REPS / 1e3
            loop_ms = device_ms(loop)
            bound = moved / HBM_BYTES_PER_S * 1e3
            if len(by_kernel) > 1:  # B5: the scatter and the scan
                print(f"  {what} by kernel: " + ", ".join(
                    f"{e.key[:40]} {e.self_device_time_total / REPS / 1e3:.5f} ms"
                    for e in by_kernel), flush=True)
            lib_txt = "no single call" if library is None else f"{device_ms(library):.5f} ms"
            own_txt = f", {own_} owner rows" if "move" in what else ""
            print(f"chain axis C={c_} N={n_}: {what} device {ms:.5f} ms L2-warm against {c_} "
                  f"one-chain launches {loop_ms:.5f} ms ({loop_ms / ms:.2f}x), library {lib_txt}; "
                  f"bound {bound:.5f} ms ({moved} bytes{own_txt}), share {bound / ms:.4f} {tag}",
                  flush=True)
        del lw_, f_, x_, a_, raw_, idx_, Sc_, sc_, s_dense, thr_, fg_, slots_
    del cl, cg, cf, cx, c_leaves, c_anc, c_raw, c_idx, cS, cs_, cs_dense, cthr, cf_guarded, c_slots
    # One firing's move of the GP-SSM's tree state (phase 8) at 1M: x [N] and
    # the history [N, T], 101 words a row, through B4 over leaves.
    gp_state = (x, wide_leaves[2])
    ms_tree = device_ms(lambda: ops.resample_move_f(f, gp_state, N))
    tree_bytes = (nbytes(f, *gp_state) * 2 - nbytes(f) + 4 * N
                  - sum(nbytes(v) // N for v in gp_state) * (N - owners))
    print(f"B4 over leaves, one firing of the GP-SSM's state (x [N] + history [N, {T}]) at 1M: "
          f"device {ms_tree:.5f} ms, bound {tree_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms "
          f"({tree_bytes} bytes, {owners} owner rows) {tag}", flush=True)
    generic_b4 = generic_state_move(ops, tag)
    # The move versions in one call and in turns: the device time of one
    # firing's decode + move (version 0's clamp and gather included) on one and
    # on three columns, and the median of SWEEPS systematic flagship sweeps.
    # All three give the same sweep (phase 4), so this alone picks the default.
    version_ms = {ver: [] for ver in DECODE_MOVE}
    for ver in VERSION_TURNS:
        ms_one = device_ms(lambda: ops.resample_move_f(f, x, N, version=ver))
        ms_three = device_ms(lambda: ops.resample_move_f(f, xd, N, version=ver))
        ops.MOVE_VERSION = ver
        times = []
        for i in range(SWEEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = apt.sweep(apt.rng.key(10 + i), kernel, N, systematic, store_states=False,
                            device="cuda")
            float(res.log_evidence)
            times.append(time.perf_counter() - t0)
        ops.MOVE_VERSION = DEFAULT_MOVE
        med_ms = statistics.median(times) * 1e3
        version_ms[ver].append((ms_one, ms_three, med_ms))
        print(f"move version {ver}: decode + move of one firing at 1M, device {ms_one:.5f} ms "
              f"(D = 1), {ms_three:.5f} ms (D = 3); systematic sweep median {med_ms:.3f} ms of "
              f"{SWEEPS} ({', '.join(f'{t * 1e3:.3f}' for t in times)}) {tag}", flush=True)
    # A version should take the default's place if its device time is lower by
    # more than the 6% that runs differ by, in every turn: then the phase fails
    # until the default follows.
    for ver, turns_ in version_ms.items():
        if ver == DEFAULT_MOVE:
            continue
        ratios = [t[0] / d[0] for t, d in zip(turns_, version_ms[DEFAULT_MOVE])]
        print(f"move version {ver} against the default {DEFAULT_MOVE}, device time at D = 1: "
              f"ratios {', '.join(f'{r:.3f}' for r in ratios)}", flush=True)
        check(max(ratios) >= 0.94, f"move version {ver} is faster than the default "
              f"{DEFAULT_MOVE} by more than 6% in every turn: make it the default")
    # B7 and B8 beside the library call, device time in one window each: the
    # sweep's thresholds, every threshold one value, and (B7 only) the
    # thresholds in random order.
    shuffled = thr[torch.randperm(N, generator=gen, device="cuda")]
    count_kernels = (
        ("B7", ops.count_le_sorted_bs), ("B8", ops.count_le_sorted),
        ("searchsorted", lambda a, b: torch.searchsorted(a, b, right=True, out_int32=True)))
    for what, t_ in (("the sweep's thresholds", thr), ("every threshold one value", one),
                     ("unsorted thresholds", shuffled)):
        got = ", ".join(f"{label} {device_ms(lambda: fn(s_, t_)):.5f}"
                        for label, fn in count_kernels
                        if not ("B8" in label and t_ is shuffled))
        print(f"merge-count at 1M, {what}, device ms: {got} {tag}", flush=True)
    # One firing's extents as the sweep builds them, host clock to the end of
    # the device work: what each scheme adds before B2/B3.
    for label in ("systematic", "stratified", "multinomial"):
        def extents(label=label):
            return apt.engine._fused_extents(label, apt.rng.key(30), logw, m, s1, N)
        extents()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            extents()
        torch.cuda.synchronize()
        print(f"extents of one firing [{label}] at 1M: "
              f"{(time.perf_counter() - t0) / REPS * 1e3:.4f} ms (host clock) {tag}", flush=True)

    def profiled(what, fn, reads):
        with profiler_window(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_PAD_S)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            time.sleep(PROFILER_PAD_S)
        events = prof.key_averages()
        # Only device-side rows: an aten op's row repeats its kernels' device time.
        kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.self_device_time_total, reverse=True)
        busy_us = sum(e.self_device_time_total for e in kernels)
        gate_us = sum(e.cpu_time_total for e in events if e.key == "aten::_local_scalar_dense")
        if busy_us > 0:
            print(f"profiled {what}: wall {wall_us / 1e3:.3f} ms, device busy "
                  f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.3f} of wall), host blocked "
                  f"in scalar reads {gate_us / 1e3:.3f} ms ({reads}), "
                  f"{sum(e.count for e in kernels)} kernel launches {tag}", flush=True)
        else:
            print(f"profiled {what}: device time not measured (profiler saw no device time)",
                  flush=True)
        for e in kernels[:10]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}",
                  flush=True)

    # The single-device sweep's and a PGAS iteration's profiles are phase 12's
    # profiling sweep and pgas.
    profiled(f"sharded systematic sweep, K={K}, auto",
             lambda: float(parallel.sharded_sweep(apt.rng.key(20), kernel, N, systematic, mesh,
                                                  store_states=False).log_evidence),
             f"{T - 1} gate reads and a boundary read per firing")

    # ---- 8. the model families at the flagship's N and T, through sample
    def profile_one(fn):
        """Wall ms, device busy ms, device-side launches and result of one call."""
        with profiler_window(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_PAD_S)
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILER_PAD_S)
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        check(rows, "the profiler saw no device time")
        for e in sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)[:6]:
            print(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:7d}x  {e.key[:90]}",
                  flush=True)
        return (wall * 1e3, sum(e.self_device_time_total for e in rows) / 1e3,
                sum(e.count for e in rows), out)

    # (label, model, leaves of its state, steps): the SV model (a = 0.9, q =
    # 0.5, scalar state), the Lévy SSM (state [N, 2], a budget of 64 jumps, dt
    # = 0.5; LEVY_STEPS) and the GP-SSM (state (x [N], history [N, T])).
    model_set = (("stochastic volatility", apt.models.stochastic_volatility_ssm(a=0.9, q=0.5), 1,
                  T),
                 ("Lévy", apt.models.levy_ssm(dt=0.5), 1, LEVY_STEPS),
                 ("GP-SSM", apt.models.gp_ssm(num_steps=T), 2, T))
    t_models = time.perf_counter()
    for label, model, leaves, steps in model_set:
        model = model.to("cuda")
        _, ys_m = apt.simulate(apt.rng.key(60), model, steps)
        traced_m = apt.TracedSSM(model, ys_m)
        kernel_m = apt.SSMKernel(traced_m)
        per_firing = {"extents_from_logw": 1,
                      **({"decode_move": 1} if leaves == 1 else {"decode_move_leaves": -(-leaves // 8)})}
        # SMC with no device named: the card.  Lévy's one sweep (a hundred
        # times as long as the others') is this run, profiled; the others are
        # timed three times unprofiled and profiled once more.
        levy = label == "Lévy"
        sample_smc = lambda: apt.sample(apt.rng.key(61), traced_m, apt.SMC(N), store_states=False)
        if levy:
            (wall, busy, kernels, smc), launches = drive(lambda: profile_one(sample_smc))
            times = [wall / 1e3]
        else:
            t0 = time.perf_counter()
            smc, launches = drive(sample_smc)
            log_z = float(smc.log_evidence)
            times = [time.perf_counter() - t0]
        log_z = float(smc.log_evidence)
        fires = int(smc.diagnostics["resampled"].sum())
        check(math.isfinite(log_z), f"{label}: SMC logZ {log_z} is not finite")
        check(fires > 0, f"{label}: the gate never fired")
        check(launches == expected(per_firing, fires),
              f"{label}: launches {launches} != {expected(per_firing, fires)} "
              f"(B4 over leaves: ceil({leaves} leaves / 8) a firing)")
        check_draws(drive, f"{label} SMC", model_draws(label, steps))
        if not levy:
            for i in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                float(apt.sweep(apt.rng.key(62 + i), kernel_m, N, systematic,
                                store_states=False, device="cuda").log_evidence)
                times.append(time.perf_counter() - t0)
            wall, busy, kernels, _ = profile_one(lambda: apt.sweep(
                apt.rng.key(61), kernel_m, N, systematic, store_states=False, device="cuda"))
        print(f"model [{label}] N={N} T={steps}: SMC logZ {log_z:.6f}, firings {fires}, launches "
              f"{launches}; sweep {statistics.median(times) * 1e3:.3f} ms (median of "
              f"{len(times)}{', profiled' if levy else ''}: "
              f"{', '.join(f'{t * 1e3:.3f}' for t in times)}); profiled sweep: wall {wall:.3f} ms, "
              f"device busy {busy:.3f} ms ({busy / wall:.4f} of wall), {kernels} device-side "
              f"launches ({kernels / steps:.1f} a step) {tag}", flush=True)

        # PGAS with replay storage, 2 iterations (the first without a
        # reference, the second on the first's trajectory; every step
        # resamples), and the sharded sweep on K logical shards, each shard
        # moving its window.
        chain, launches = drive(lambda: apt.sample(apt.rng.key(63), traced_m, apt.PGAS(N), 2,
                                                   trajectory_storage="replay"))
        check(bool(torch.isfinite(chain.log_evidence).all())
              and bool(torch.isfinite(chain.trajectory).all()), f"{label}: PGAS not finite")
        check(launches == expected(per_firing, 2 * (steps - 1)),
              f"{label}: PGAS launches {launches}")
        check_draws(drive, f"{label} PGAS", pgas_draws(2, steps, model=label))
        mesh.reset_counts()
        res, launches = drive(lambda: parallel.sharded_sweep(apt.rng.key(61), kernel_m, N,
                                                             systematic, mesh, store_states=False))
        fires_s = int(res.resampled.sum())
        branches = dict(mesh.exchanges)
        dlz = abs(float(res.log_evidence) - log_z)
        print(f"model [{label}] PGAS N={N} 2 iterations (replay): logZ "
              f"{chain.log_evidence.tolist()}; sharded N={N} K={K}: logZ "
              f"{float(res.log_evidence):.6f} |dlogZ| vs single-device {dlz:.3e}, firings by "
              f"branch {branches}, launches {launches}; phase 8 so far "
              f"{time.perf_counter() - t_models:.1f}s", flush=True)
        check(math.isfinite(float(res.log_evidence)), f"{label}: sharded logZ not finite")
        move = "decode_move" if leaves == 1 else "decode_move_leaves"
        check(launches[move] == K * fires_s * per_firing[move]
              and launches["extents_from_logw"] == K * branches.get("allgather", 0),
              f"{label}: sharded launches {launches}")
        check_draws(drive, f"{label} sharded", model_draws(label, steps, K))
        del traced_m, kernel_m, smc, chain, res
        torch.cuda.empty_cache()

    # The statistical contracts at the JAX tests' sizes, on the card.
    sv = apt.models.stochastic_volatility_ssm(a=0.9, q=0.5).to("cuda")
    _, ys_sv = apt.simulate(apt.rng.key(70), sv, 60)
    sv_traced = apt.TracedSSM(sv, ys_sv)

    def update_rate(chain):
        return (chain.trajectory.diff(dim=0).abs() > 0).double().mean(0)

    (pgas_rate, pg_rate), _ = drive(lambda: (
        update_rate(apt.sample(apt.rng.key(71), sv_traced, apt.PGAS(20), SV_RATE_ITERS)),
        update_rate(apt.sample(apt.rng.key(71), sv_traced, apt.PG(20, 1.0), SV_RATE_ITERS))))
    sv = "stochastic volatility"
    check_draws(drive, "SV update rates", add_draws(
        pgas_draws(SV_RATE_ITERS, 60, replay=False, model=sv),
        pgas_draws(SV_RATE_ITERS, 60, conditional=0, replay=False, model=sv)))
    theory = 1.0 - 1.0 / 20
    early = slice(0, 20)
    print(f"SV PGAS update rate N=20 T=60, {SV_RATE_ITERS} iterations: mean "
          f"{float(pgas_rate.mean()):.4f} "
          f"(phase 8 so far {time.perf_counter() - t_models:.1f}s) "
          f"(1 - 1/N = {theory}); early third PG {float(pg_rate[early].mean()):.4f} against "
          f"PGAS {float(pgas_rate[early].mean()):.4f}", flush=True)
    check(float(pgas_rate.mean()) > theory - 0.1, "SV PGAS update rate below (1 - 1/N) - 0.1")
    check(float(pg_rate[early].mean()) < float(pgas_rate[early].mean()) - 0.3,
          "SV: PG's early update rate is not 0.3 below PGAS's")
    for label, model, n_p, steps, sampler, tol, iters in (
            ("GP-SSM PG", apt.models.gp_ssm(num_steps=T), 20, T, apt.PG, 1e-5, 3),
            # One particle and N particles sum a step's 64 masked jumps in
            # different orders on the card (PyTorch's cumsum of one row and
            # of N rows, which the kernel keeps): hence the looser bound.  Two
            # iterations (the second conditional on the first).
            ("Lévy PGAS", apt.models.levy_ssm(dt=0.5), 50, LEVY_CHECK_STEPS, apt.PGAS, 1e-4, 2)):
        model = model.to("cuda")
        _, ys_x = apt.simulate(apt.rng.key(72), model, steps)
        tr_x = apt.TracedSSM(model, ys_x)
        (dense, repl), _ = drive(lambda: tuple(
            apt.sample(apt.rng.key(73), tr_x, sampler(n_p), iters, trajectory_storage=st)
            for st in ("dense", "replay")))
        family, conditional = label.split()[0], (iters - 1 if sampler is apt.PGAS else 0)
        check_draws(drive, label, add_draws(*(
            pgas_draws(iters, steps, conditional, replay, model=family)
            for replay in (False, True))))
        diff = float((dense.trajectory - repl.trajectory).abs().max())
        print(f"{label} N={n_p} T={steps}, {iters} iterations: replay against dense storage max |diff| "
              f"{diff:.3e} (bound {tol}), logZ {dense.log_evidence.tolist()}; phase 8 so far "
              f"{time.perf_counter() - t_models:.1f}s", flush=True)
        check(bool(torch.isfinite(dense.log_evidence).all()), f"{label}: logZ not finite")
        check(diff <= tol, f"{label}: replay and dense differ by {diff} > {tol}")

    generic_phase(apt, ops, drive, expected, profile_one, tag, traced, kernel, systematic, auto,
                  generic_b4, main_launches)
    print(f"phases 1-9 took {time.perf_counter() - t_script:.1f}s", flush=True)
    chain_sweeps, chain_iterations = chains_phase(apt, ops, drive, expected, profile_one, tag,
                                                  traced, kernel, systematic, kf_ll, sm)
    per_sweep.update(chain_sweeps)
    per_pgas_iteration.update(chain_iterations)
    print(f"phases 1-10 took {time.perf_counter() - t_script:.1f}s", flush=True)
    bench_phase(drive, card, tag)
    print(f"phases 1-11 took {time.perf_counter() - t_script:.1f}s", flush=True)
    profiling_phase(drive, card, tag)
    print(f"phases 1-12 took {time.perf_counter() - t_script:.1f}s", flush=True)
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": main_launches[name], "max_abs_err": err[name],
         "ms": timing[name]["device_ms"], **timing[name], "bound_by": "bytes",
         "launches_per_sweep": {k: v[name] for k, v in per_sweep.items() if name in v},
         "launches_per_pgas_iteration": {k: v[name] for k, v in per_pgas_iteration.items()
                                         if name in v}}
        for name in names
    ] + [
        {"name": name, "route": "cuda", "source": TF_SOURCE, "replaces": TF_REPLACES[name],
         "launches": main_launches[name], "max_abs_err": err[name],
         "ms": tf_timing[name]["1M"]["device_ms"], **tf_timing[name]["1M"],
         f"at_{ENSEMBLE_RUNS}x1M": tf_timing[name][f"{ENSEMBLE_RUNS} x 1M"],
         "launches_per_sweep": {k: v[name] for k, v in per_sweep.items() if name in v},
         "launches_per_pgas_iteration": {k: v[name] for k, v in per_pgas_iteration.items()
                                         if name in v}}
        for name in tf_names
    ]}
    for k in record["kernels"]:
        check(k["launches"] > 0, f"{k['name']} was never launched on a main path")
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def bench_launches_ok(bench, mode: str, record: dict, launches: dict) -> bool:
    """Whether a bench mode's run launched its path's kernels and no other:
    ``launches`` counted over the whole run, ``record["launches"]`` over its
    timed runs.  Every PGAS step fires; a gated sweep's firings are read from
    B1 = B4 (with the chain axis for a batch)."""
    run = {k: v for k, v in launches.items() if v}
    timed = record["launches"]
    if mode in ("smc", "ensemble"):
        names = set(PER_FIRING["systematic"] if mode == "smc" else per_firing_chains("systematic"))
        return all(set(got) == names and len(set(got.values())) == 1 for got in (run, timed))
    if mode == "scaling":
        # Each shard decodes and moves its window once a firing; B1 runs on
        # each shard where a firing takes the all-gather.
        shards = [int(k) for k in record["particle_steps_per_sec_by_devices"]]
        moves = {k: sum(s * (2 + record["n_runs"]) * (record["steps"] - 1) for s in shards) * v
                 for k, v in DECODE_MOVE[WINDOWED_MOVE].items()}
        return (set(run) <= {"extents_from_logw", *moves}
                and all(run[k] == v for k, v in moves.items())
                and run.get("extents_from_logw", 0) <= sum(moves.values()))
    if mode == "pgas":
        per_firing = PER_FIRING["systematic"]
        chains = -(-bench.ANCHOR_ITERS // (bench.BENCH_ITERS - bench.WARM_ITERS))
        windows, timed_windows = 1 + record["n_runs"] + chains, record["n_runs"]
        per_window = bench.BENCH_ITERS * (T - 1)
    else:  # chains: every chain fires at every step
        per_firing = per_firing_chains("systematic")
        windows, timed_windows = 1 + record["n_runs"], record["n_runs"]
        per_window = record["iterations_per_run"] * (T - 1)
    return (run == {k: v * windows * per_window for k, v in per_firing.items()}
            and timed == {k: v * timed_windows * per_window for k, v in per_firing.items()})


def bench_draws(bench, mode: str, record: dict) -> dict:
    """The Threefry launches of a bench mode's whole run: the sweeps or PGAS
    chains of its first call and its timed runs, pgas's anchor chains, and on
    each of scaling's meshes its two untimed iterations (the first without a
    reference; dense storage)."""
    runs = 1 + record["n_runs"]
    if mode in ("smc", "ensemble"):
        return draws(normal=T * runs)
    if mode == "pgas":
        iters = bench.BENCH_ITERS
        chains = runs + -(-bench.ANCHOR_ITERS // (iters - bench.WARM_ITERS))
        return pgas_draws(chains * iters, conditional=chains * (iters - 1))
    if mode == "chains":
        iters = record["iterations_per_run"]
        return pgas_draws(runs * iters, conditional=runs * (iters - 1))
    its = 1 + runs
    return add_draws(*(pgas_draws(its, record["steps"], its - 1, replay=False, shards=int(k))
                       for k in record["particle_steps_per_sec_by_devices"]))


def bench_phase(drive, card: str, tag: str):
    """Phase 11: the five modes of ``advancedps_tpu_torch.bench`` at full size
    through its functions, no device named.  Each prints its JSON line and
    raises on a failed anchor; each ran on this card and launched its path's
    kernels (B1 and B4; with the chain axis for a batch) and no other."""
    from advancedps_tpu_torch import bench

    t_phase = time.perf_counter()
    modes = {
        "smc": bench.smc,
        "pgas": lambda: bench.pgas(runs=BENCH_PGAS_RUNS),
        "scaling": lambda: bench.scaling(mode="overhead"),
        "ensemble": bench.ensemble,
        "chains": bench.chains,
    }
    for mode, run in modes.items():
        t0 = time.perf_counter()
        try:
            record, launches = drive(run)
        except bench.AnchorError as e:
            fail(f"bench {mode}: {e}")
        print(f"bench {mode} took {time.perf_counter() - t0:.1f}s; launches "
              f"{ {k: v for k, v in launches.items() if v} } {tag}", flush=True)
        check(record["device"] == card, f"bench {mode}: device {record['device']!r}")
        check(bench_launches_ok(bench, mode, record, launches),
              f"bench {mode}: launches {launches}, in the timed runs {record['launches']}: "
              f"not its path's kernels")
        check_draws(drive, f"bench {mode}", bench_draws(bench, mode, record))
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f}s", flush=True)


#: The Threefry launches of each profile of phase 12, whose components run
#: once warm, ``reps`` times timed and once profiled: the sweep's gated,
#: never-resampling and propagate + score sweeps and the pos_normal loop
#: (4T - 1 normals), the uniforms of that loop, the reductions and the gather;
#: a PGAS iteration's (2T normals, T uniforms), the conditional sweep's (T,
#: T - 1), propagate + score's (T), the reductions' (one uniform), the
#: ancestor draws' (T - 1) and the replay's (T and the retained draw).
PROFILE_DRAWS = {
    "sweep": lambda r: draws(normal=(r["reps"] + 2) * (4 * T - 1), uniform=3 * (r["reps"] + 2)),
    "pgas": lambda r: draws(normal=(r["reps"] + 2) * 5 * T, uniform=(r["reps"] + 2) * 3 * T),
    "resample": lambda r: draws(),
    "moves": lambda r: draws(),
}
#: The kernels each profile of phase 12 runs: the sweep's and a PGAS
#: iteration's (B1 and the default move), the resample branch's pieces, and
#: the decode + move of every move version.
PROFILE_KERNELS = {
    "sweep": set(PER_FIRING["systematic"]),
    "pgas": set(PER_FIRING["systematic"]),
    "resample": {"extents_from_logw", "decode_move", "decode_ancestors"},
    "moves": {name for move in DECODE_MOVE.values() for name in move},
}


def profiling_phase(drive, card: str, tag: str):
    """Phase 12: ``bench schemes`` (each scheme) and ``bench generic`` at full
    size through their functions, and the four subcommands of
    ``advancedps_tpu_torch.profiling`` as commands, no device named."""
    from advancedps_tpu_torch import bench, profiling

    t_phase = time.perf_counter()

    def run(what, fn):
        t0 = time.perf_counter()
        try:
            record, launches = drive(fn)
        except bench.AnchorError as e:
            fail(f"{what}: {e}")
        launches = {k: v for k, v in launches.items() if v}
        print(f"{what} took {time.perf_counter() - t0:.1f}s; launches {launches} {tag}",
              flush=True)
        check(record["device"] == card, f"{what}: device {record['device']!r}")
        return record, launches

    for scheme in bench.SCHEMES:
        record, launches = run(f"bench schemes --scheme {scheme}",
                               lambda: bench.schemes(scheme=scheme))
        # The base launches nothing (bench._timed refuses it otherwise); the
        # first call and each timed sweep fire at each of the T − 1 steps.
        per_sweep = {k: v * (T - 1) for k, v in PER_FIRING[scheme].items()}
        check(record["launches"] == {k: v * record["n_runs"] for k, v in per_sweep.items()}
              and launches == {k: v * (1 + record["n_runs"]) for k, v in per_sweep.items()},
              f"bench schemes {scheme}: launches {launches}, in the timed runs "
              f"{record['launches']}: not {per_sweep} a sweep")
        sweeps = 1 + record["n_runs"]  # of the base and of the scheme each
        check_draws(drive, f"bench schemes {scheme}", draws(
            normal=2 * T * sweeps, uniform=0 if scheme == "systematic" else sweeps * (T - 1)))
        print(f"bench schemes {scheme}: per firing {record['per_firing_ms']:.4f} ms, median "
              f"{record['median_s']:.4f} s ({record['min_s']:.4f}-{record['max_s']:.4f}), base "
              f"{record['base_median_s']:.4f} s ({record['base_min_s']:.4f}-"
              f"{record['base_max_s']:.4f}) {tag}", flush=True)
    record, launches = run("bench generic", bench.generic)
    names = set(PER_FIRING["systematic"])
    for what, got in (("run", launches), ("generic's timed runs", record["launches"]),
                      ("structured timed runs", record["structured_launches"])):
        check(set(got) == names and len(set(got.values())) == 1,
              f"bench generic: launches of the {what} {got}: not B1 = B4")
    sweeps = 1 + record["n_runs"]  # of each form
    check_draws(drive, "bench generic", add_draws(
        model_draws("generic", record["steps"], sweeps), model_draws("LGSSM", record["steps"],
                                                                      sweeps)))
    print(f"bench generic: generic median {record['median_s']:.4f} s, structured "
          f"{record['structured_median_s']:.4f} s, generic/structured throughput "
          f"{record['generic_over_structured']:.4f} {tag}", flush=True)

    # Each subcommand in a process of its own, as a user runs it: in this one
    # the profiler has by now begun to lose records of the kernels launched
    # through ctypes (see phase 9's B4 reading).
    with tempfile.TemporaryDirectory() as trace_dir:
        for name in profiling.SUBCOMMANDS:
            args = ["--trace", trace_dir] if name == "sweep" else []
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [sys.executable, "-m", "advancedps_tpu_torch.profiling", name, *args],
                    stdout=subprocess.PIPE, text=True, timeout=PROFILE_TIMEOUT_S,
                    cwd=os.path.dirname(os.path.abspath(__file__)))
            except subprocess.TimeoutExpired:
                fail(f"profiling {name}: no result within {PROFILE_TIMEOUT_S} s")
            check(proc.returncode == 0, f"profiling {name}: exit code {proc.returncode}")
            line = proc.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            record = json.loads(line)
            launches = record["launches"]
            print(f"profiling {name} took {time.perf_counter() - t0:.1f}s; launches {launches} "
                  f"{tag}", flush=True)
            check(record["device"] == card, f"profiling {name}: device {record['device']!r}")
            check(set(launches) == PROFILE_KERNELS[name],
                  f"profiling {name}: launches {launches}: not its path's kernels")
            want = {k: v for k, v in PROFILE_DRAWS[name](record).items() if v}
            check(record["rng_launches"] == want, f"profiling {name}: Threefry launches "
                  f"{record['rng_launches']} != {want}")
            for label, r in record["components"].items():
                # A step launches at least one kernel: fewer records is a lost record.
                check(r["device_ms"] > 0 and r["launches"] >= r["steps"],
                      f"profiling {name} [{label}]: {r['launches']} device records for "
                      f"{r['steps']} steps, {r['device_ms']} ms: device time not measured")
                print(f"  {label}: device {r['device_ms']:.4f} ms, host median "
                      f"{r['host_median_ms']:.4f} ms ({r['host_min_ms']:.4f}-"
                      f"{r['host_max_ms']:.4f}), {r['launches_per_step']:.2f} launches a step, "
                      f"busy {r['busy_share']:.4f} {tag}", flush=True)
            if "faithfulness" in record:
                lo, hi = profiling.FAITHFUL
                check(lo <= record["faithfulness"] <= hi,
                      f"profiling {name}: faithfulness {record['faithfulness']} outside "
                      f"{lo}-{hi}: the profile measures another path than the engine takes")
                top = [(r["op"][:40], round(r["ms"], 3), r["launches"]) for r in record["top_ops"]]
                print(f"profiling {name}: faithfulness {record['faithfulness']:.4f}; top device "
                      f"ops {top}; idle gaps {record['idle_gaps']} {tag}", flush=True)
            if name == "sweep":
                check(os.path.getsize(record["trace"]) > 0, "profiling sweep: no trace written")
            if name == "pgas":
                print(f"profiling pgas: (sweep + replay) / iteration "
                      f"{record['iteration_ratio']:.4f}", flush=True)
            if name == "resample":
                check(0 < record["firings"] < T - 1, f"profiling resample: {record['firings']} "
                      f"firings")
                print(f"profiling resample: {record['firings']} firings in a sweep", flush=True)
            if name == "moves":
                check(record["versions_agree"], "profiling moves: the move versions disagree")
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f}s", flush=True)


def b3_reading(ops, what: str, anc: torch.Tensor, v: torch.Tensor, tag: str) -> dict:
    """B3 on ``(anc, v)``: device time L2-warm and L2-cold (128 MB of copies
    of its inputs in turn), beside one ``index_select`` by the clipped
    ancestors, and its bound: ``anc`` read, the rows that own a slot read
    once, the rows and the clipped ancestors written."""
    clipped, moved = ops.move_rows(anc, v)
    owners = int(torch.unique(clipped).numel())
    nb = nbytes(anc, clipped, moved) + v[0].numel() * v.element_size() * owners
    copies = [(clone_as_laid(anc), clone_as_laid(v))
              for _ in range(-(-COLD_BYTES // nbytes(anc, v)))]
    turn = iter(range(10 ** 9))
    row = {"device_ms": device_ms(lambda: ops.move_rows(anc, v)),
           "cold_device_ms": device_ms(lambda: ops.move_rows(*copies[next(turn) % len(copies)])),
           "library_ms": device_ms(lambda: v.index_select(0, clipped)),
           "bound_ms": nb / HBM_BYTES_PER_S * 1e3}
    del copies
    print(f"kernel {what}: device {row['device_ms']:.5f} ms L2-warm, {row['cold_device_ms']:.5f} "
          f"ms L2-cold, index_select {row['library_ms']:.5f} ms; bound {row['bound_ms']:.5f} ms "
          f"({nb} bytes, {owners} owner rows), share {row['bound_ms'] / row['device_ms']:.4f} "
          f"warm, {row['bound_ms'] / row['cold_device_ms']:.4f} cold {tag}", flush=True)
    check(row["bound_ms"] <= row["cold_device_ms"], f"{what}: L2-cold device time "
          f"{row['cold_device_ms']} ms below its bound {row['bound_ms']} ms")
    return row


#: Device-side launches of one residual firing step (the draw and B3), by
#: chains: read in phase 7, used by phase 10 to count the loop it replaced.
RESIDUAL_STEP = {}


def residual_step_launches(apt, ops, gen, tag):
    """Phase 7: one residual firing step, C chains drawn in one call from
    their keys on the card and moved by B3 with the chain axis, for C = 1, 4
    and 64 at N = 1M and 16,384: device-side launches (equal at C = 4 and
    64 for each N; torch's own reductions and scans may take one launch more
    for long rows than for short ones) and device time, with the three
    kernels that take the most of it, beside the loop it replaced at C = 4 x
    1M (each chain's draw from its host key, then one gather)."""
    for c_, n_ in ((SCHEME_RUNS, N), (MANY_CHAINS, N), (1, N), (SCHEME_RUNS, MANY_N),
                   (MANY_CHAINS, MANY_N), (1, MANY_N)):
        w_ = torch.softmax(torch.randn(c_, n_, generator=gen, device="cuda") * 2.0, -1)
        x_ = torch.randn(c_, n_, generator=gen, device="cuda")
        keys_ = apt.rng.chain_keys(apt.rng.key(300), c_)
        col = keys_.to("cuda").column()

        def step():
            return ops.move_by_ancestors(apt.resample_residual(col, w_, n_), x_)

        step()
        torch.cuda.synchronize()
        rows = device_rows(step, 5)
        launched = sum(e.count for e in rows) // 5
        ms = sum(e.self_device_time_total for e in rows) / 5 / 1e3
        top = ", ".join(f"{e.key[:50]} {e.self_device_time_total / 5 / 1e3:.4f} ms"
                        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:3])
        RESIDUAL_STEP[c_, n_] = launched
        loop_txt = ""
        if (c_, n_) == (SCHEME_RUNS, N):
            host = [keys_.key(c) for c in range(c_)]
            chain_ix = torch.arange(c_, device="cuda")[:, None]

            def loop():
                anc = torch.stack([apt.resample_residual(host[c], w_[c], n_) for c in range(c_)])
                return x_[chain_ix, anc.long()]

            loop()
            torch.cuda.synchronize()
            lrows = device_rows(loop, 2)
            loop_txt = (f"; the loop of {c_} one-chain draws and a gather "
                        f"{sum(e.count for e in lrows) // 2} launches, "
                        f"{sum(e.self_device_time_total for e in lrows) / 2 / 1e3:.5f} ms")
        print(f"residual firing step, C={c_} N={n_}: {launched} device-side launches, device "
              f"{ms:.5f} ms (most: {top}){loop_txt} {tag}", flush=True)
        del w_, x_
    for n_ in (N, MANY_N):
        check(RESIDUAL_STEP[SCHEME_RUNS, n_] == RESIDUAL_STEP[MANY_CHAINS, n_],
              f"a residual firing step's launches grow with C: {RESIDUAL_STEP}")


def generic_state_move(ops, tag) -> dict:
    """B4 on one firing of phase 9's generic state ``[NG, SG]``, bitwise its
    plain version, beside B2 + ``index_select``: device times and the bound
    (the rows that own a slot read once, the rows and ancestors written)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    logw = torch.randn(NG, generator=gen, device="cuda") * 2.0
    m = torch.max(logw)
    s1 = torch.sum(torch.exp(logw - m))
    f = ops.extents_from_logw(logw, m, s1, 0.25, NG)
    v = torch.randn(NG, SG, generator=gen, device="cuda")
    anc, moved = ops.decode_move(f, v, NG)
    ref = ops.decode_move_ref(f, v, NG)
    check(torch.equal(anc, ref[0]) and torch.equal(word_bits(moved), word_bits(ref[1])),
          f"B4 on the [{NG}, {SG}] state differs from its plain version")
    owners = int(torch.unique(anc).numel())
    nb = nbytes(f, anc, moved) + 4 * SG * owners
    row = {"device_ms": device_ms(lambda: ops.decode_move(f, v, NG)),
           "library_ms": device_ms(lambda: v.index_select(0, ops.decode_ancestors(f, NG))),
           "plain_ms": device_ms(lambda: ops.decode_move_ref(f, v, NG)),
           "bound_ms": nb / HBM_BYTES_PER_S * 1e3}
    print(f"kernel decode_move at {NG // 1000}k, D = {SG} (phase 9's generic state): device "
          f"{row['device_ms']:.5f} ms, B2 + index_select {row['library_ms']:.5f} ms, plain "
          f"{row['plain_ms']:.5f} ms; bound {row['bound_ms']:.5f} ms ({nb} bytes, {owners} "
          f"owner rows) {tag}", flush=True)
    # B3 on the same firing, bitwise B4's move: with B2 before it, the other
    # form a dispatch by shape could run on this state.
    raw = ops.decode_ancestors(f, NG)
    b3 = ops.move_rows(raw, v)
    check(torch.equal(b3[0], anc) and torch.equal(word_bits(b3[1]), word_bits(moved)),
          f"B3 on the [{NG}, {SG}] state differs from B4")
    b3_row = b3_reading(ops, f"move_rows at {NG // 1000}k, D = {SG} (phase 9's generic state)",
                        raw, v, tag)
    row["b3_device_ms"], row["b2_device_ms"] = b3_row["device_ms"], device_ms(
        lambda: ops.decode_ancestors(f, NG))
    print(f"  B2 + B3 on the [{NG}, {SG}] state: {row['b2_device_ms']:.5f} + "
          f"{row['b3_device_ms']:.5f} ms against B4's {row['device_ms']:.5f} ms {tag}",
          flush=True)
    return row


def generic_phase(apt, ops, drive, expected, profile_one, tag, traced, kernel, systematic,
                  sharded_auto, generic_b4, main_launches):
    """Phase 9: the generic front-end, chain checkpoints and a one-rank NCCL
    mesh (the module docstring)."""
    from advancedps_tpu_torch import parallel

    t_phase = time.perf_counter()
    # ---- 9a. the LGSSM as a generic program at N = 100k, T = 50
    model = apt.models.stationary_lgssm(A, Q, R)
    _, ys_g = apt.simulate(torch.Generator().manual_seed(0), model, TG)
    ys_list = ys_g.tolist()
    kf_g = float(apt.utils.kalman_filter(ys_g, A, 0.0, Q, 1.0, R, 0.0, SIGMA0).log_likelihood)

    def prog(ctx):
        x = ctx.sample(apt.Normal(0.0, SIGMA0), name="x0")
        ctx.observe(apt.Normal(x, R), ys_list[0])
        for t in range(1, TG):
            x = ctx.sample(apt.Normal(A * x, Q), name=f"x{t}")
            ctx.observe(apt.Normal(x, R), ys_list[t])

    gm = apt.GenericModel(prog)
    check(gm.num_steps == TG and gm.flat_size == SG, "generic program: structure")
    smc, launches = drive(lambda: apt.sample(apt.rng.key(80), gm, apt.SMC(NG)))
    log_z = float(smc.log_evidence)
    fires = int(smc.diagnostics["resampled"].sum())
    check(smc.trajectories.is_cuda and tuple(smc.trajectories.shape) == (TG, NG, SG),
          "generic SMC: trajectories not [T, N, S] on the card")
    check(bool(torch.isfinite(smc.trajectories).all()), "generic SMC: trajectories not finite")
    check(abs(log_z - kf_g) < 0.1, f"generic SMC: |logZ - kalman| = {abs(log_z - kf_g)} >= 0.1")
    check(fires > 0 and launches == expected(PER_FIRING["systematic"], fires),
          f"generic SMC: launches {launches} for {fires} firings")
    check_draws(drive, "generic SMC", model_draws("generic", TG))
    print(f"generic program N={NG} T={TG} ({SG} sites): SMC logZ {log_z:.6f} kalman {kf_g:.6f} "
          f"|err| {abs(log_z - kf_g):.6f}, firings {fires}, launches {launches} {tag}", flush=True)
    del smc
    # The sweep times of the two forms are phase 12's bench generic.
    g_kernel = apt.make_kernel(gm)
    s_kernel = apt.SSMKernel(apt.TracedSSM(model, ys_g).to("cuda"))
    # One profiled sweep each: the early stop at a step's observe, the whole
    # program at every step, and the structured kernel; the first two bitwise.
    profiled = {}
    stops_early = apt.GenericModel._stops_early
    for label in ("generic, early stop", "generic, whole program", "structured"):
        k = s_kernel if label == "structured" else g_kernel
        if label == "generic, whole program":
            apt.GenericModel._stops_early = lambda self, t: False
        try:
            wall, busy, kernels, res = profile_one(lambda: apt.sweep(
                apt.rng.key(84), k, NG, systematic, store_states=False, device="cuda"))
        finally:
            apt.GenericModel._stops_early = stops_early
        profiled[label] = res
        print(f"profiled sweep [{label}] N={NG} T={TG}: wall {wall:.3f} ms, device busy "
              f"{busy:.3f} ms ({busy / wall:.4f} of wall), {kernels} device-side launches "
              f"({kernels / TG:.1f} a step) {tag}", flush=True)
    a, b = profiled["generic, early stop"], profiled["generic, whole program"]
    check(torch.equal(a.log_evidence, b.log_evidence) and torch.equal(a.ancestors, b.ancestors)
          and torch.equal(a.final_state, b.final_state),
          "generic: the early stop changes the sweep")
    print("generic: the sweep with the early stop is bitwise the whole program's (logZ, "
          "ancestors, final values)", flush=True)
    chain, launches = drive(lambda: apt.sample(apt.rng.key(85), gm, apt.PG(NG), 3))
    check(tuple(chain.trajectory.shape) == (3, TG, SG)
          and bool(torch.isfinite(chain.trajectory).all())
          and bool(torch.isfinite(chain.log_evidence).all()), "generic PG: not finite")
    check(launches["extents_from_logw"] > 0 and launches["decode_move"] > 0,
          f"generic PG: launches {launches}")
    check_draws(drive, "generic PG", pgas_draws(3, TG, conditional=0, replay=False,
                                                model="generic"))
    print(f"generic PG N={NG} dense, 3 iterations: logZ {chain.log_evidence.tolist()}, "
          f"launches {launches}", flush=True)
    del chain
    print(f"B4 on one firing of the generic state [{NG}, {SG}] (read in phase 7, before the "
          f"profiled sweeps: after a window of ~40k records the profiler drops a record of the "
          f"ctypes-launched kernels in each later window): device "
          f"{generic_b4['device_ms']:.5f} ms, B2 + index_select "
          f"{generic_b4['library_ms']:.5f} ms, plain {generic_b4['plain_ms']:.5f} ms, bound "
          f"{generic_b4['bound_ms']:.5f} ms {tag}", flush=True)

    # ---- 9b. the analytic −2·log 2 evidence (tests/test_torch_generic.py's sizes)
    def bernoulli_model(ctx):
        ctx.sample(apt.Normal(0.0, 1.0), name="a")
        x = ctx.sample(apt.Bernoulli(1.0), name="x")
        ctx.sample(apt.Gamma(2.0, 3.0), name="b")
        ctx.observe(apt.Bernoulli(x / 2.0), 1.0)
        ctx.sample(apt.Beta(1.0, 1.0), name="c")
        ctx.observe(apt.Bernoulli(x / 2.0), 0.0)

    bm = apt.GenericModel(bernoulli_model)
    exact = -2.0 * math.log(2.0)
    smc_b = apt.sample(apt.rng.key(100), bm, apt.SMC(100))
    pg_b = apt.sample(apt.rng.key(100), bm, apt.PG(10), ANALYTIC_PG_ITERS)
    smc_rel = abs(float(smc_b.log_evidence) - exact) / abs(exact)
    pg_err = abs(float(pg_b.log_evidence.double().mean()) - exact)
    check(smc_rel <= 1e-6, f"analytic SMC evidence: relative error {smc_rel} > 1e-6")
    check(pg_err < 0.01, f"analytic PG evidence: |mean logZ + 2 log 2| = {pg_err} >= 0.01")
    check(bool((bm.decode(smc_b.trajectories[-1])["x"] == 1.0).all())
          and bool((bm.decode(pg_b.trajectory[:, -1, :])["x"] == 1.0).all()),
          "analytic evidence: x is not 1 everywhere")

    def vector_site(ctx):
        v = ctx.sample(apt.Normal(torch.zeros(3), torch.ones(3)), name="v")
        ctx.observe(apt.Normal(v.sum(), 1.0), 0.5)

    vm = apt.GenericModel(vector_site)
    smc_v = apt.sample(apt.rng.key(0), vm, apt.SMC(1000))
    check(tuple(vm.decode(smc_v.trajectories[-1])["v"].shape) == (1000, 3)
          and math.isfinite(float(smc_v.log_evidence)), "a site with CPU parameters failed")

    # A branch on a sampled value is refused on the card with the reference's
    # diagnosis, whether it is an ``if`` or an ``.item()``.
    for branch in ("if", "item"):
        def value_dependent(ctx, branch=branch):
            a = ctx.sample(apt.Normal(0.0, 1.0), name="a")
            ctx.observe(apt.Normal(a, 1.0), 0.3)
            if (a > 0 if branch == "if" else a.item() > 0):
                ctx.observe(apt.Normal(a, 1.0), -0.2)

        try:
            apt.sample(apt.rng.key(0), apt.GenericModel(value_dependent), apt.SMC(1000))
        except RuntimeError as e:
            check("mis-aligned" in str(e), f"value-dependent program ({branch}): {e}")
        else:
            fail(f"value-dependent program ({branch}): not refused on the card")

    # Parameters on the card, swept on the CPU: each law's copy to the CPU
    # lands before it is read, so the sweep is bitwise the CPU parameters'.
    def card_params(where):
        mean, sd = torch.zeros(3, device=where), torch.ones(3, device=where)

        def fn(ctx):
            v = ctx.sample(apt.Normal(mean, sd), name="v")
            ctx.observe(apt.Normal(v.sum(), 1.0), 0.5)
        return apt.GenericModel(fn)

    from_card = apt.sample(apt.rng.key(4), card_params("cuda"), apt.SMC(1000), device="cpu")
    from_cpu = apt.sample(apt.rng.key(4), card_params("cpu"), apt.SMC(1000), device="cpu")
    check(torch.equal(from_card.log_evidence, from_cpu.log_evidence)
          and torch.equal(from_card.trajectories, from_cpu.trajectories),
          "a CPU sweep over parameters on the card differs from one over CPU parameters")
    pg_mean = float(pg_b.log_evidence.double().mean())
    print(f"analytic evidence on the card: SMC(100) logZ {float(smc_b.log_evidence):.9f} "
          f"(relative error {smc_rel:.3e}), PG(10) x {ANALYTIC_PG_ITERS} mean {pg_mean:.9f} "
          f"(|err| {pg_err:.3e}), exact {exact:.9f}; a [3] site with CPU parameters: logZ "
          f"{float(smc_v.log_evidence):.6f}; value-dependent programs (if, .item()) refused "
          f"as mis-aligned; a CPU sweep over card parameters bitwise the CPU one", flush=True)

    # ---- 9c. a PGAS chain at 1M, replay storage, checkpointed and resumed
    pgas = apt.PGAS(N)
    key = apt.rng.key(90)
    t0 = time.perf_counter()
    (whole, first, resumed), launches = drive(lambda: _checkpointed_chain(apt, traced, pgas, key))
    check(torch.equal(first.trajectory, whole.trajectory[:2])
          and torch.equal(resumed.trajectory, whole.trajectory[2:])
          and torch.equal(resumed.log_evidence, whole.log_evidence[2:]),
          "PGAS resumed from a checkpoint differs from the uninterrupted chain")
    check(launches == expected(PER_FIRING["systematic"], 8 * (T - 1)),
          f"PGAS with a checkpoint: launches {launches}")
    # Four iterations whole, two, and two resumed on a reference: six conditional.
    check_draws(drive, "PGAS with a checkpoint", pgas_draws(8, conditional=6))
    print(f"PGAS N={N} T={T} replay: 2 iterations, checkpoint, 2 resumed: bitwise the 4 "
          f"uninterrupted (trajectories and logZ {whole.log_evidence.tolist()}); "
          f"{time.perf_counter() - t0:.3f}s for 8 iterations, launches {launches} {tag}",
          flush=True)

    # ---- 9d. one NCCL rank of a K-shard mesh spanning processes
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "nccl_rank.pt")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        try:
            child = subprocess.run([sys.executable, os.path.abspath(__file__), "--nccl-rank",
                                    str(port), out_path], capture_output=True, text=True,
                                   timeout=NCCL_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"the NCCL rank did not finish in {NCCL_CHILD_TIMEOUT_S} s")
        child_s = time.perf_counter() - t0
        check(child.returncode == 0, f"the NCCL rank failed (rc {child.returncode}):\n"
              f"{(child.stdout + child.stderr)[-4000:]}")
        got = torch.load(out_path, weights_only=True)
    for name, c in got["launches"].items():
        main_launches[name] += c
    fires = int(sharded_auto.resampled.sum())
    branches = got["exchanges"]
    want = expected({"decode_move": K}, fires)
    want["extents_from_logw"] = K * branches.get("allgather", 0)
    check(got["backend"] == "nccl" and got["local"] == list(range(K)),
          f"the child's group is {got['backend']} with local shards {got['local']}")
    check(got["launches"] == want, f"NCCL rank: launches {got['launches']} != {want}")
    same = (torch.equal(got["log_evidence"], sharded_auto.log_evidence.cpu())
            and torch.equal(got["ancestors"], sharded_auto.ancestors.cpu())
            and torch.equal(got["log_weights"], sharded_auto.log_weights.cpu())
            and torch.equal(got["resampled"], sharded_auto.resampled.cpu()))
    check(same, "the NCCL rank's sharded sweep differs from the one-controller sweep")
    print(f"NCCL rank (world 1, K={K} local shards) sharded sweep N={N} T={T}: logZ "
          f"{float(got['log_evidence']):.6f}, bitwise the one-controller sweep (logZ, ancestors, "
          f"log-weights, flags); firings by branch {branches}; collectives {got['calls']}; "
          f"launches {got['launches']}; sweep {got['sweep_s'] * 1e3:.3f} ms, child process "
          f"{child_s:.1f}s {tag}", flush=True)
    print(f"phase 9 took {time.perf_counter() - t_phase:.1f}s", flush=True)


#: The flip contract's limit on the extents of a scheme whose positions are
#: iid uniforms, residual's multinomial tail, where evenly spaced positions
#: (systematic) allow 1: a CDF entry that moves by one float32 ulp (Σe summed
#: in another order) moves every tail uniform that lies inside that ulp, a
#: Poisson count of mean ~0.03 at 1M (~0.5M tail uniforms, an ulp of 6e-8
#: below 1).  Over 1M entries the largest is typically 2-4, and one above 8
#: has a probability under 1e-13.
TAIL_OFF = 8


def dlogz_bound(n: int) -> float:
    """The flip contract's bound on |ΔlogZ| at n particles: 0.05 at 1M (the
    sharded sweep's), scaled as the Monte Carlo noise that follows the first
    flip, by sqrt(1M / n): 0.39 at 16,384, 0.20 at 65,536."""
    return 0.05 * math.sqrt(N / n)


def flip_contract(anc, resampled, log_z, one):
    """A chain of a batched sweep (its ``ancestors [T, N]``, flags and logZ)
    against the one-chain sweep ``one`` of its key: the first step whose
    ancestors differ (T if none), the largest difference of the extents the
    two decodes inverted there, whether the flags agree up to it, and
    |ΔlogZ|.  On the card torch may split a row of ``[C, N]`` across blocks
    otherwise than an ``[N]`` vector, so Σe may differ by an ulp and move an
    extent at a stratum boundary by one: the sharded sweep's contract."""
    steps = anc.shape[0]
    flips = (anc != one.ancestors).sum(1)
    first = int(torch.argmax((flips > 0).int())) if bool(flips.any()) else steps
    off = 0 if first == steps else int(
        (extents_of(anc[first]) - extents_of(one.ancestors[first])).abs().max())
    flags = torch.equal(resampled[:first + 1], one.resampled[:first + 1])
    return first, off, flags, abs(float(log_z) - float(one.log_evidence))


def chains_phase(apt, ops, drive, expected, profile_one, tag, traced, kernel, systematic, kf_ll,
                 sm):
    """Phase 10: independent chains as one batch on a leading chain axis, at
    the flagship LGSSM's full width (the module docstring).  Returns the
    launches per batched sweep and per batched PGAS iteration, by path."""
    from advancedps_tpu_torch import bench, parallel

    t_phase = time.perf_counter()
    per_sweep, per_iteration = {}, {}

    # ---- 10a. an ensemble of 8 systematic runs at 1M, log-evidence only
    C = ENSEMBLE_RUNS
    key = apt.rng.key(200)
    ens, launches = drive(lambda: parallel.smc_ensemble(key, traced, apt.SMC(N), C,
                                                        store_states=False))
    lz = ens.log_evidence.double().cpu()
    fired = int(ens.diagnostics["resampled"].any(0).sum())
    errs = (lz - kf_ll).abs()
    print(f"ensemble [systematic] {C} runs x N={N} T={T}: logZ {lz.tolist()}, |logZ - kalman| "
          f"max {float(errs.max()):.6f}, steps on which some run fired {fired}, launches "
          f"{ {k: v for k, v in launches.items() if v} } {tag}", flush=True)
    check(bool((errs < 0.1).all()), f"ensemble: |logZ - kalman| {errs.tolist()}, not all < 0.1")
    check(launches == expected(per_firing_chains("systematic"), fired),
          f"ensemble: launches {launches}")
    # The chains' draws: one launch a step for all C, as one chain's.
    check_draws(drive, "ensemble", draws(normal=T))
    per_sweep[f"systematic, {C} chains"] = {k: v for k, v in launches.items() if v}
    keys = apt.rng.chain_keys(key, C)
    # Launches and busy share of one sweep: one chain, 8 chains at 1M (the
    # ensemble's own sweep, whose genealogy is held against the one-chain
    # sweeps below), and 64 chains of 16,384.
    prof = {}
    for label, fn in (
            ("1 chain x 1M", lambda: apt.sweep(apt.rng.fold_in(key, 0), kernel, N, systematic,
                                               store_states=False, device="cuda")),
            (f"{C} chains x 1M", lambda: apt.sweep(keys, kernel, N, systematic,
                                                   store_states=False)),
            (f"{MANY_CHAINS} chains x {MANY_N}", lambda: apt.sweep(
                apt.rng.chain_keys(key, MANY_CHAINS), kernel, MANY_N, systematic,
                store_states=False))):
        wall, busy, launched, res = profile_one(fn)
        prof[label] = launched
        if label.startswith(f"{C} "):
            batched = res
        print(f"profiled sweep [{label}] T={T}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
              f"({busy / wall:.4f} of wall), {launched} device-side launches, steps with a "
              f"firing {int(res.resampled.reshape(-1, T).any(0).sum())} {tag}", flush=True)
    l1, l8, l64 = prof.values()
    print(f"launches of one sweep: {l8 / l1:.4f} x one chain's at C={C}, C={MANY_CHAINS} against "
          f"C={C} {l64 / l8:.4f}", flush=True)
    check(l8 < 1.5 * l1, f"a batched sweep of {C} chains launches {l8}, 1.5 x one chain's {l1} "
          f"or more")
    check(abs(l64 - l8) <= 0.1 * l8, f"launches grow with C: {l8} at C={C}, {l64} at "
          f"C={MANY_CHAINS}")
    check(torch.equal(batched.log_evidence, ens.log_evidence),
          "ensemble: the batched sweep differs from smc_ensemble")
    for c in (0, C - 1):
        one = apt.sweep(apt.rng.fold_in(key, c), kernel, N, systematic, store_states=False,
                        device="cuda")
        first, off, flags, dlz = flip_contract(batched.ancestors[c], batched.resampled[c],
                                               batched.log_evidence[c], one)
        print(f"ensemble run {c} against sample_smc(fold_in(key, {c})): bitwise "
              f"{first == T and torch.equal(batched.log_evidence[c], one.log_evidence)}, first "
              f"flip at step {first}, extents off by {off}, flags equal to it {flags}, "
              f"|dlogZ| {dlz:.3e}", flush=True)
        check(off <= 1 and flags and dlz < 0.05, f"ensemble run {c}: not within the flip "
              f"contract (first {first}, off {off}, flags {flags}, |dlogZ| {dlz})")
    del batched, res
    # The batched sweep's time beside 8 one-chain sweeps, in turns.
    times = {"batched": [], "one chain": []}
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(apt.sweep(apt.rng.chain_keys(apt.rng.key(210 + i), C), kernel, N, systematic,
                        store_states=False).log_evidence[0])
        times["batched"].append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(apt.sweep(apt.rng.key(210 + i), kernel, N, systematic, store_states=False,
                        device="cuda").log_evidence)
        times["one chain"].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"ensemble time, {C} runs x N={N}: batched sweep median {med['batched'] * 1e3:.3f} ms "
          f"({', '.join(f'{t * 1e3:.3f}' for t in times['batched'])}); one-chain sweep median "
          f"{med['one chain'] * 1e3:.3f} ms, x {C} = {C * med['one chain'] * 1e3:.3f} ms; "
          f"ratio {med['batched'] / (C * med['one chain']):.4f} (in turns) {tag}", flush=True)

    # The same ensemble under move versions 6 (B2 + B3) and 0 (B5 + a
    # gather), each kernel once a firing step for all chains: bitwise the
    # version-1 ensemble.
    for ver in (6, 0):
        ops.MOVE_VERSION = ver
        try:
            e_v, launches = drive(lambda: parallel.smc_ensemble(key, traced, apt.SMC(N), C,
                                                                store_states=False))
        finally:
            ops.MOVE_VERSION = DEFAULT_MOVE
        fired_v = int(e_v.diagnostics["resampled"].any(0).sum())
        same = (torch.equal(e_v.log_evidence, ens.log_evidence)
                and torch.equal(e_v.weights, ens.weights)
                and torch.equal(e_v.diagnostics["resampled"], ens.diagnostics["resampled"]))
        print(f"ensemble [systematic, move version {ver}] {C} runs x N={N}: bitwise the version "
              f"{DEFAULT_MOVE} ensemble (logZ, weights, flags) {same}, launches "
              f"{ {k: v for k, v in launches.items() if v} } {tag}", flush=True)
        check(same, f"ensemble under move version {ver} differs from version {DEFAULT_MOVE}")
        check(launches == expected(per_firing_chains("systematic", version=ver), fired_v),
              f"ensemble under move version {ver}: launches {launches}")
        check_draws(drive, f"ensemble under move version {ver}", draws(normal=T))
        per_sweep[f"systematic, {C} chains, move version {ver}"] = {
            k: v for k, v in launches.items() if v}

    # ---- 10b. stratified and multinomial (B7, and B8 by the merge path)
    # ensembles, 4 runs at 1M
    per_step, by_count = {}, {}
    for label, fn in (("stratified", apt.resample_stratified),
                      ("multinomial", apt.resample_multinomial),
                      ("multinomial, merge path", apt.resample_multinomial)):
        smp = apt.SMC(N, apt.ResampleWithESSThreshold(fn))
        ops.COUNT_LE_SORTED = "merge" if "merge" in label else "bs"
        try:
            e_, launches = drive(lambda: parallel.smc_ensemble(key, traced, smp, SCHEME_RUNS,
                                                               store_states=False))
        finally:
            ops.COUNT_LE_SORTED = "bs"
        lz_ = e_.log_evidence.double().cpu()
        fired = int(e_.diagnostics["resampled"].any(0).sum())
        one = apt.sample_smc(apt.rng.fold_in(key, 0), traced, smp, store_states=False,
                             device="cuda")
        dlz = abs(float(lz_[0]) - float(one.log_evidence))
        print(f"ensemble [{label}] {SCHEME_RUNS} runs x N={N}: |logZ - kalman| "
              f"{[round(abs(v - kf_ll), 6) for v in lz_.tolist()]}, run 0 against the one-chain "
              f"run |dlogZ| {dlz:.3e}, steps with a firing {fired}, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        check(bool(((lz_ - kf_ll).abs() < 0.1).all()), f"ensemble {label}: |logZ - kalman| >= 0.1")
        check(dlz < 0.05, f"ensemble {label}: run 0 |dlogZ| {dlz} against the one-chain run")
        check(launches == expected(per_firing_chains(label), fired),
              f"ensemble {label}: launches {launches}")
        check_draws(drive, f"ensemble {label}", draws(normal=T, uniform=fired))
        per_sweep[f"{label}, {SCHEME_RUNS} chains"] = {k: v for k, v in launches.items() if v}
        per_step[label] = sum(launches.values()) / fired
        by_count[label] = e_
    # B7 and B8 give the same counts, so the two multinomial ensembles are one.
    check(torch.equal(by_count["multinomial"].log_evidence,
                      by_count["multinomial, merge path"].log_evidence)
          and torch.equal(by_count["multinomial"].weights,
                          by_count["multinomial, merge path"].weights),
          "multinomial ensembles on B7 and B8 with the chain axis differ")
    del by_count

    # ---- 10c. PGAS, 64 chains of 16,384, replay storage, as one batch
    pg = apt.PGAS(MANY_N)
    key_c = apt.rng.key(220)
    t0 = time.perf_counter()
    chains, launches = drive(lambda: parallel.sample_chains(
        key_c, traced, pg, MANY_ITERS, MANY_CHAINS, trajectory_storage="replay"))
    first_s = time.perf_counter() - t0
    check(tuple(chains.trajectory.shape) == (MANY_CHAINS, MANY_ITERS, T)
          and bool(torch.isfinite(chains.trajectory).all()), "PGAS chains: shape or not finite")
    check(launches == expected(per_firing_chains("systematic"),
                               MANY_ITERS * (T - 1)), f"PGAS chains: launches {launches}")
    check_draws(drive, "PGAS chains", pgas_draws(MANY_ITERS))
    per_iteration[f"systematic, {MANY_CHAINS} chains"] = {
        k: v // MANY_ITERS for k, v in launches.items() if v}
    # Each chain's mean over its iterations, against the smoother by
    # bench_pgas.py's statistic.
    cmeans = chains.trajectory.double().cpu().mean(1)
    zrms = bench.rts_zrms(cmeans, sm.means, sm.variances, MANY_ITERS)
    print(f"PGAS {MANY_CHAINS} chains x N={MANY_N} x {MANY_ITERS} iterations (replay), one batch: "
          f"RMS z-score of the pooled chain means vs RTS smoother {zrms:.4f}; first call "
          f"{first_s:.3f}s; launches {launches} {tag}", flush=True)
    check(zrms < 3.0, f"PGAS chains: RMS z-score {zrms} >= 3")
    it0 = apt.sweep(apt.rng.fold_in(apt.rng.chain_keys(key_c, MANY_CHAINS), 0), kernel, MANY_N,
                    pg.resampler, store_states=False)
    loop_s = 0.0
    for c in LOOP_CHAINS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = apt.sample(apt.rng.fold_in(key_c, c), traced, pg, MANY_ITERS,
                         trajectory_storage="replay", device="cuda")
        float(one.log_evidence[-1])
        loop_s += time.perf_counter() - t0
        same = [torch.equal(one.trajectory[i], chains.trajectory[c, i])
                and torch.equal(one.log_evidence[i], chains.log_evidence[c, i])
                for i in range(MANY_ITERS)]
        one0 = apt.sweep(apt.rng.fold_in(apt.rng.fold_in(key_c, c), 0), kernel, MANY_N,
                         pg.resampler, store_states=False, device="cuda")
        first, off, flags, dlz = flip_contract(it0.ancestors[c], it0.resampled[c],
                                               it0.log_evidence[c], one0)
        print(f"PGAS chain {c} against sample_pg(fold_in(key, {c})): iterations bitwise {same}; "
              f"iteration 0's sweep: first flip at step {first}, extents off by {off}, flags "
              f"equal to it {flags}, |dlogZ| {dlz:.3e}", flush=True)
        check(all(same) or (off <= 1 and flags and dlz < dlogz_bound(MANY_N)),
              f"PGAS chain {c}: neither bitwise nor within the flip contract (|dlogZ| bound "
              f"{dlogz_bound(MANY_N):.3f} at N={MANY_N})")
    del it0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = parallel.sample_chains(apt.rng.key(221), traced, pg, MANY_ITERS, MANY_CHAINS,
                                   trajectory_storage="replay")
    float(again.log_evidence[0, 0])
    batched_s = time.perf_counter() - t0
    print(f"PGAS N={MANY_N} T={T} replay: {MANY_CHAINS} chains as one batch "
          f"{MANY_CHAINS * MANY_ITERS / batched_s:.3f} chain-iterations/s "
          f"({batched_s:.3f}s for {MANY_ITERS} iterations); the loop of one-chain calls on "
          f"chains {list(LOOP_CHAINS)} {len(LOOP_CHAINS) * MANY_ITERS / loop_s:.3f} "
          f"chain-iterations/s ({loop_s:.3f}s); ratio "
          f"{(MANY_CHAINS / batched_s) / (len(LOOP_CHAINS) / loop_s):.3f} "
          f"{tag}", flush=True)
    profiled_it = profile_one(lambda: apt.step_pg(
        apt.rng.fold_in(apt.rng.chain_keys(apt.rng.key(222), MANY_CHAINS), 1), traced, pg,
        apt.PGState(again.trajectory[:, -1]), "replay"))
    print(f"profiled PGAS iteration, {MANY_CHAINS} chains x {MANY_N} (replay): wall "
          f"{profiled_it[0]:.3f} ms, device busy {profiled_it[1]:.3f} ms "
          f"({profiled_it[1] / profiled_it[0]:.4f} of wall), {profiled_it[2]} device-side "
          f"launches {tag}", flush=True)
    del chains, again

    # ---- 10c'. multinomial PGAS, 64 chains of 16,384, replay storage: B7
    # once a step for all chains.  Its time in turns with the same iteration
    # where B7 runs once a chain (the loop this replaces), and the launches of
    # a profiled iteration of each.
    pg_m = apt.PGAS(MANY_N, resampler=apt.resample_multinomial)
    key_m = apt.rng.key(225)
    t0 = time.perf_counter()
    chains_m, launches = drive(lambda: parallel.sample_chains(
        key_m, traced, pg_m, MULTI_ITERS, MANY_CHAINS, trajectory_storage="replay"))
    first_s = time.perf_counter() - t0
    lz_m = chains_m.log_evidence.double().cpu()
    check(bool(torch.isfinite(chains_m.trajectory).all()) and bool(torch.isfinite(lz_m).all()),
          "multinomial PGAS chains: not finite")
    check(float((lz_m - sm.log_likelihood).abs().max()) < 1.0,
          "multinomial PGAS chains: |logZ - kalman| >= 1")
    check(launches == expected(per_firing_chains("multinomial"), MULTI_ITERS * (T - 1)),
          f"multinomial PGAS chains: launches {launches}")
    check_draws(drive, "multinomial PGAS chains", pgas_draws(MULTI_ITERS, firing_uniforms=1))
    per_iteration[f"multinomial, {MANY_CHAINS} chains"] = {
        k: v // MULTI_ITERS for k, v in launches.items() if v}
    per_step[f"multinomial PGAS, {MANY_CHAINS} chains"] = sum(launches.values()) / (
        MULTI_ITERS * (T - 1))
    print(f"PGAS [multinomial] {MANY_CHAINS} chains x N={MANY_N} x {MULTI_ITERS} iterations "
          f"(replay), one batch: logZ range [{float(lz_m.min()):.4f}, {float(lz_m.max()):.4f}]; "
          f"first call {first_s:.3f}s; launches {launches} {tag}", flush=True)
    print(f"resampling launches a firing step, multinomial: "
          f"{ {k: v for k, v in per_step.items() if 'multinomial' in k} }", flush=True)
    check(per_step["multinomial"] == per_step[f"multinomial PGAS, {MANY_CHAINS} chains"],
          f"multinomial launches a firing step grow with C: {per_step}")
    state_m = apt.PGState(chains_m.trajectory[:, -1])

    def per_chain_counts(s_, t_):
        """The loop this PR replaced: B7 (or B8) once a chain."""
        return torch.stack([ops.count_le_sorted_auto(s_[c], t_[c]) for c in range(s_.shape[0])])

    def multinomial_iteration(i):
        return apt.step_pg(apt.rng.fold_in(apt.rng.chain_keys(apt.rng.key(226), MANY_CHAINS), i),
                           traced, pg_m, state_m, "replay")[0]

    batched_chains = ops.count_le_sorted_auto_chains
    iter_s = {"batched": [], "once a chain": []}
    for i, form in enumerate(("batched", "once a chain", "once a chain", "batched")):
        ops.count_le_sorted_auto_chains = batched_chains if form == "batched" else per_chain_counts
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(multinomial_iteration(i).log_evidence[0])
            iter_s[form].append(time.perf_counter() - t0)
            if i < 2:
                wall, busy, launched, _ = profile_one(lambda: multinomial_iteration(10 + i))
                print(f"profiled multinomial PGAS iteration [{form}], {MANY_CHAINS} chains x "
                      f"{MANY_N} (replay): wall {wall:.3f} ms, device busy {busy:.3f} ms "
                      f"({busy / wall:.4f} of wall), {launched} device-side launches {tag}",
                      flush=True)
        finally:
            ops.count_le_sorted_auto_chains = batched_chains
    rate = {form: MANY_CHAINS * len(v) / sum(v) for form, v in iter_s.items()}
    print(f"PGAS [multinomial] N={MANY_N} T={T} replay, {MANY_CHAINS} chains: "
          f"{rate['batched']:.3f} chain-iterations/s with B7 once a step for all chains, "
          f"{rate['once a chain']:.3f} with B7 once a chain (in turns: "
          f"{', '.join(f'{t:.3f}' for t in iter_s['batched'])} s and "
          f"{', '.join(f'{t:.3f}' for t in iter_s['once a chain'])} s an iteration); ratio "
          f"{rate['batched'] / rate['once a chain']:.4f} {tag}", flush=True)
    del chains_m, state_m

    residual_chains(apt, ops, drive, expected, profile_one, tag, traced, kernel, kf_ll, sm,
                    per_sweep, per_iteration)

    # ---- 10d. PGAS, 4 chains at 1M, replay storage, 2 iterations
    t0 = time.perf_counter()
    wide, launches = drive(lambda: parallel.sample_chains(
        apt.rng.key(230), traced, apt.PGAS(N), WIDE_ITERS, WIDE_CHAINS,
        trajectory_storage="replay"))
    wide_s = time.perf_counter() - t0
    lz_w = wide.log_evidence.double().cpu()
    print(f"PGAS {WIDE_CHAINS} chains x N={N} x {WIDE_ITERS} iterations (replay), one batch: "
          f"logZ {lz_w.tolist()}; {wide_s:.3f}s; launches {launches} {tag}", flush=True)
    check(bool(torch.isfinite(wide.trajectory).all()) and bool(torch.isfinite(lz_w).all()),
          "PGAS chains at 1M: not finite")
    check(float((lz_w - sm.log_likelihood).abs().max()) < 1.0,
          "PGAS chains at 1M: |logZ - kalman| >= 1")
    check(launches == expected(per_firing_chains("systematic"),
                               WIDE_ITERS * (T - 1)), f"PGAS chains at 1M: launches {launches}")
    check_draws(drive, "PGAS chains at 1M", pgas_draws(WIDE_ITERS))
    per_iteration[f"systematic, {WIDE_CHAINS} chains x 1M"] = {
        k: v // WIDE_ITERS for k, v in launches.items() if v}
    del wide

    # ---- 10e. a GP-SSM ensemble, 4 runs of 65,536: B4 over leaves with the
    # chain axis moves x [C, N] and the history [C, N, T]
    gp = apt.models.gp_ssm(num_steps=T).to("cuda")
    _, ys_gp = apt.simulate(apt.rng.key(60), gp, T)
    traced_gp = apt.TracedSSM(gp, ys_gp)
    t0 = time.perf_counter()
    e_gp, launches = drive(lambda: parallel.smc_ensemble(
        apt.rng.key(240), traced_gp, apt.SMC(GP_N), GP_RUNS, store_states=False))
    gp_s = time.perf_counter() - t0
    fired = int(e_gp.diagnostics["resampled"].any(0).sum())
    one = apt.sample_smc(apt.rng.fold_in(apt.rng.key(240), 0), traced_gp, apt.SMC(GP_N),
                         store_states=False, device="cuda")
    dlz = abs(float(e_gp.log_evidence[0]) - float(one.log_evidence))
    print(f"GP-SSM ensemble {GP_RUNS} runs x N={GP_N} T={T}: logZ "
          f"{e_gp.log_evidence.tolist()}, run 0 against the one-chain run |dlogZ| {dlz:.3e}, "
          f"steps with a firing {fired}, {gp_s:.3f}s, launches "
          f"{ {k: v for k, v in launches.items() if v} } {tag}", flush=True)
    check(bool(torch.isfinite(e_gp.log_evidence).all()), "GP-SSM ensemble: logZ not finite")
    check(dlz < dlogz_bound(GP_N), f"GP-SSM ensemble: run 0 |dlogZ| {dlz} against the one-chain "
          f"run, over {dlogz_bound(GP_N):.3f}")
    check(fired > 0 and launches == expected(per_firing_chains("systematic", 2), fired),
          f"GP-SSM ensemble: launches {launches}")
    check_draws(drive, "GP-SSM ensemble", model_draws("GP-SSM"))
    per_sweep[f"GP-SSM, {GP_RUNS} chains"] = {k: v for k, v in launches.items() if v}
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f}s", flush=True)
    return per_sweep, per_iteration


def residual_chains(apt, ops, drive, expected, profile_one, tag, traced, kernel, kf_ll, sm,
                    per_sweep, per_iteration):
    """Phase 10f: residual resampling on the chain axis.  An ensemble of
    SCHEME_RUNS runs at 1M (each against Kalman; runs 0 and the last under
    the flip contract against their one-chain sweeps), and PGAS for
    MANY_CHAINS chains of MANY_N (MULTI_ITERS iterations, replay): one draw
    (its two prefix sums by B6) and one B3 a firing step for all chains, as
    many at C = 4 as at 64; its
    chain-iterations/s beside the loop of one-chain calls, and the launches
    of a profiled iteration beside those of the loop it replaced (counted
    from phase 7's firing steps)."""
    from advancedps_tpu_torch import parallel

    t0 = time.perf_counter()
    rs = apt.ResampleWithESSThreshold(apt.resample_residual)
    key = apt.rng.key(250)
    ens, launches = drive(lambda: parallel.smc_ensemble(key, traced, apt.SMC(N, rs), SCHEME_RUNS,
                                                        store_states=False))
    lz = ens.log_evidence.double().cpu()
    fired = int(ens.diagnostics["resampled"].any(0).sum())
    per_step = {"ensemble": sum(launches.values()) / max(fired, 1)}
    print(f"ensemble [residual] {SCHEME_RUNS} runs x N={N} T={T}: |logZ - kalman| "
          f"{[round(abs(v - kf_ll), 6) for v in lz.tolist()]}, steps with a firing {fired}, "
          f"launches { {k: v for k, v in launches.items() if v} } {tag}", flush=True)
    check(bool(((lz - kf_ll).abs() < 0.1).all()), "ensemble residual: |logZ - kalman| >= 0.1")
    check(fired > 0 and launches == expected(per_firing_chains("residual"), fired),
          f"ensemble residual: launches {launches}")
    check_draws(drive, "ensemble residual", draws(normal=T, uniform=fired))
    per_sweep[f"residual, {SCHEME_RUNS} chains"] = {k: v for k, v in launches.items() if v}
    batched = apt.sweep(apt.rng.chain_keys(key, SCHEME_RUNS), kernel, N, rs, store_states=False)
    check(torch.equal(batched.log_evidence, ens.log_evidence),
          "ensemble residual: the batched sweep differs from smc_ensemble")
    for c in (0, SCHEME_RUNS - 1):
        one = apt.sweep(apt.rng.fold_in(key, c), kernel, N, rs, store_states=False, device="cuda")
        first, off, flags, dlz = flip_contract(batched.ancestors[c], batched.resampled[c],
                                               batched.log_evidence[c], one)
        print(f"ensemble [residual] run {c} against its one-chain sweep: bitwise "
              f"{first == T and torch.equal(batched.log_evidence[c], one.log_evidence)}, first "
              f"flip at step {first}, extents off by {off} (limit {TAIL_OFF}), flags equal to "
              f"it {flags}, |dlogZ| {dlz:.3e}", flush=True)
        check(off <= TAIL_OFF and flags and dlz < 0.05, f"ensemble residual run {c}: not "
              f"within the flip contract (first {first}, off {off}, flags {flags}, |dlogZ| "
              f"{dlz})")
    del batched, ens

    pg = apt.PGAS(MANY_N, resampler=apt.resample_residual)
    key_p = apt.rng.key(255)
    chains, launches = drive(lambda: parallel.sample_chains(
        key_p, traced, pg, MULTI_ITERS, MANY_CHAINS, trajectory_storage="replay"))
    lz_p = chains.log_evidence.double().cpu()
    check(bool(torch.isfinite(chains.trajectory).all()) and bool(torch.isfinite(lz_p).all()),
          "residual PGAS chains: not finite")
    check(float((lz_p - sm.log_likelihood).abs().max()) < 1.0,
          "residual PGAS chains: |logZ - kalman| >= 1")
    check(launches == expected(per_firing_chains("residual"), MULTI_ITERS * (T - 1)),
          f"residual PGAS chains: launches {launches}")
    check_draws(drive, "residual PGAS chains", pgas_draws(MULTI_ITERS, firing_uniforms=1))
    per_iteration[f"residual, {MANY_CHAINS} chains"] = {
        k: v // MULTI_ITERS for k, v in launches.items() if v}
    per_step[f"PGAS, {MANY_CHAINS} chains"] = sum(launches.values()) / (MULTI_ITERS * (T - 1))
    print(f"resampling kernel launches a residual firing step: {per_step}", flush=True)
    check(per_step["ensemble"] == per_step[f"PGAS, {MANY_CHAINS} chains"],
          f"residual launches a firing step grow with C: {per_step}")
    it0 = apt.sweep(apt.rng.fold_in(apt.rng.chain_keys(key_p, MANY_CHAINS), 0), kernel, MANY_N,
                    pg.resampler, store_states=False)
    loop_s = 0.0
    for c in LOOP_CHAINS:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one = apt.sample(apt.rng.fold_in(key_p, c), traced, pg, MULTI_ITERS,
                         trajectory_storage="replay", device="cuda")
        float(one.log_evidence[-1])
        loop_s += time.perf_counter() - t1
        same = all(torch.equal(one.trajectory[i], chains.trajectory[c, i])
                   and torch.equal(one.log_evidence[i], chains.log_evidence[c, i])
                   for i in range(MULTI_ITERS))
        one0 = apt.sweep(apt.rng.fold_in(apt.rng.fold_in(key_p, c), 0), kernel, MANY_N,
                         pg.resampler, store_states=False, device="cuda")
        first, off, flags, dlz = flip_contract(it0.ancestors[c], it0.resampled[c],
                                               it0.log_evidence[c], one0)
        print(f"PGAS [residual] chain {c} against sample_pg(fold_in(key, {c})): iterations "
              f"bitwise {same}; iteration 0's sweep: first flip at step {first}, extents off by "
              f"{off}, |dlogZ| {dlz:.3e}", flush=True)
        check(same or (off <= TAIL_OFF and flags and dlz < dlogz_bound(MANY_N)),
              f"residual PGAS chain {c}: neither bitwise nor within the flip contract")
    del it0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    again = parallel.sample_chains(apt.rng.key(256), traced, pg, MULTI_ITERS, MANY_CHAINS,
                                   trajectory_storage="replay")
    float(again.log_evidence[0, 0])
    batched_s = time.perf_counter() - t1
    rate, loop_rate = MANY_CHAINS * MULTI_ITERS / batched_s, len(LOOP_CHAINS) * MULTI_ITERS / loop_s
    print(f"PGAS [residual] N={MANY_N} T={T} replay: {MANY_CHAINS} chains as one batch "
          f"{rate:.3f} chain-iterations/s ({batched_s:.3f}s for {MULTI_ITERS} iterations); the "
          f"loop of one-chain calls on chains {list(LOOP_CHAINS)} {loop_rate:.3f} "
          f"chain-iterations/s ({loop_s:.3f}s); ratio {rate / loop_rate:.3f} {tag}", flush=True)
    wall, busy, launched, _ = profile_one(lambda: apt.step_pg(
        apt.rng.fold_in(apt.rng.chain_keys(apt.rng.key(257), MANY_CHAINS), 1), traced, pg,
        apt.PGState(again.trajectory[:, -1]), "replay"))
    # The loop: each firing step's batched draw and move in place of C draws
    # from host keys and a gather (phase 7's counts of one firing step).
    loop_launches = launched + (T - 1) * (MANY_CHAINS * RESIDUAL_STEP[1, MANY_N]
                                          - RESIDUAL_STEP[MANY_CHAINS, MANY_N])
    print(f"profiled residual PGAS iteration, {MANY_CHAINS} chains x {MANY_N} (replay): wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms ({busy / wall:.4f} of wall), {launched} "
          f"device-side launches; the loop it replaced, counted from phase 7's firing steps: "
          f"~{loop_launches} {tag}", flush=True)
    del chains, again
    print(f"phase 10f (residual) took {time.perf_counter() - t0:.1f}s", flush=True)


def _checkpointed_chain(apt, traced, pgas, key):
    """Four PGAS iterations in one chain; the same chain's first two, a
    checkpoint, and two iterations resumed from it."""
    whole = apt.sample(key, traced, pgas, 4, trajectory_storage="replay")
    first = apt.sample(key, traced, pgas, 2, trajectory_storage="replay")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chain.pt")
        apt.utils.save_chain(path, apt.PGState(first.trajectory[-1]), key, 2)
        resumed, _, it = apt.utils.resume_chain(path, traced, pgas, 2,
                                                trajectory_storage="replay")
    check(it == 4, f"resume_chain ended at iteration {it}")
    return whole, first, resumed


def nccl_rank(port: str, out_path: str):
    """Phase 9's child: rank 0 of a one-process NCCL group, whose K-shard
    mesh spans processes, runs phase 5's systematic sharded sweep at 1M."""
    import torch.distributed as dist

    import advancedps_tpu_torch as apt
    from advancedps_tpu_torch import parallel
    from advancedps_tpu_torch.ops import resample as ops

    parallel.init_distributed(f"localhost:{port}", 1, 0)
    try:
        mesh = parallel.particle_mesh(K)
        check(mesh.spans_processes, "the mesh does not span processes")
        model = apt.models.stationary_lgssm(A, Q, R)
        _, ys = apt.simulate(torch.Generator().manual_seed(0), model, T)
        kernel = apt.SSMKernel(apt.TracedSSM(model, ys).to("cuda"))
        systematic = apt.ResampleWithESSThreshold(apt.resample_systematic)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = parallel.sharded_sweep(apt.rng.key(1), kernel, N, systematic, mesh,
                                     store_states=False)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        torch.save({
            "log_evidence": res.log_evidence.cpu(), "ancestors": res.ancestors.cpu(),
            "log_weights": res.log_weights.cpu(), "resampled": res.resampled.cpu(),
            "launches": {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS},
            "exchanges": dict(mesh.exchanges), "calls": dict(mesh.calls),
            "backend": dist.get_backend(), "local": list(mesh.local), "sweep_s": sweep_s,
        }, out_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--nccl-rank"]:
        nccl_rank(sys.argv[2], sys.argv[3])
    else:
        main()
