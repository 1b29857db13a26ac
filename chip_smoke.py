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
   nondecreasing), B7 and B8 (exact, also where every threshold falls in one
   tile);
4. the SMC flagship (stationary LGSSM a=0.9, q=0.32, r=1.0, T=100,
   N=1,000,000, resampling at ESS ≤ N/2) through ``sample`` with each fused
   scheme — systematic, stratified, multinomial, and multinomial with the
   B8 merge-count — anchored to the exact Kalman log-likelihood, with each
   kernel's launch count equal to what the scheme runs per firing times the
   firings, and a bitwise repeat; then the systematic flagship under each
   move version (6: B2 + B3, 1: B4, 0: B5 + a gather), bitwise equal;
5. the sharded flagship on K = 4 logical shards of the card
   (``parallel.sharded_sweep``) with each exchange, against Kalman and the
   single-device sweep (equal until the first firing whose Σe, summed in
   another order, moves an extent; there every differing ancestor is off by
   one), ``auto`` against ``neighbor`` and move version 1 against 6,
   bitwise;
6. PGAS at N=1M, T=100 with replay storage (``bench_pgas.py``'s
   configuration): the pooled chain means against the RTS smoother (RMS
   z-score < 3 over 6 chains of 8 iterations, 4 dropped), the final
   iteration's logZ against Kalman, 99 launches of B1-B3 per iteration; short
   PGAS chains with multinomial and stratified; replay against dense storage;
   then sharded PGAS (K = 4, replay, ``auto``) and sharded chains on a 2 × 2
   chain mesh;
7. timings: the median of 5 sweeps per scheme and of a never-firing base,
   the sharded sweep's median beside the single-device one and its exchange
   time per firing, PGAS iterations/s (single-device and sharded), each
   kernel against its plain version, and profiled sweeps for the device busy
   share.

Each launch count is read from the run of its own path, the counts set to 0
just before it.  The last two lines are the kernels' JSON record (launches
summed over the runs of phases 4-6) and ``{"ok": true, "device": {...}}``.
Imports no JAX: the card's machine has none.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

N = 1_000_000
T = 100
K = 4  # logical shards of the sharded phases
L = N // K
A, Q, R = 0.9, 0.32, 1.0
SIGMA0 = math.sqrt(Q * Q / (1 - A * A))
REPS = 20  # launches per timing window
SWEEPS = 5  # timed sweeps per scheme
PGAS_ITERS, PGAS_WARM, PGAS_CHAINS = 8, 4, 6  # bench_pgas.py:34-38, 96-114
SHARDED_PGAS_ITERS = 3
CHAIN_ITERS = 3
SOURCE = "advancedps_tpu_torch/csrc/resample.cu"
TPU_FILE = "advancedps_tpu/ops/pallas_resample.py"
REPLACES = {
    "extents_from_logw": f"{TPU_FILE}:237",
    "decode_ancestors": f"{TPU_FILE}:972",
    "move_rows": f"{TPU_FILE}:1090",
    "decode_move": f"{TPU_FILE}:728",
    "decode_ancestors_dense": f"{TPU_FILE}:103",
    "scaled_prefix_from_logw": f"{TPU_FILE}:325",
    "prefix_sum": f"{TPU_FILE}:325",
    "count_le_sorted_bs": f"{TPU_FILE}:476",
    "count_le_sorted": f"{TPU_FILE}:516",
}
#: Kernel launches per resampling firing of each fused scheme.
PER_FIRING = {
    "systematic": {"extents_from_logw": 1, "decode_ancestors": 1, "move_rows": 1},
    "stratified": {"scaled_prefix_from_logw": 1, "decode_ancestors": 1, "move_rows": 1},
    "multinomial": {"prefix_sum": 1, "scaled_prefix_from_logw": 1, "count_le_sorted_bs": 1,
                    "decode_ancestors": 1, "move_rows": 1},
    "multinomial, merge path": {"prefix_sum": 1, "scaled_prefix_from_logw": 1,
                                "count_le_sorted": 1, "decode_ancestors": 1,
                                "move_rows": 1},
}
#: The decode + move of each move version, per firing (systematic).
PER_VERSION = {
    6: {"extents_from_logw": 1, "decode_ancestors": 1, "move_rows": 1},
    1: {"extents_from_logw": 1, "decode_move": 1},
    0: {"extents_from_logw": 1, "decode_ancestors_dense": 1},
}


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


def max_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest float32 ulp distance between two nonnegative tensors."""
    return int((bits(a).long() - bits(b).long()).abs().max())


def nondecreasing(x: torch.Tensor) -> bool:
    return bool((x[1:] >= x[:-1]).all())


def time_ms(fn) -> float:
    """Mean device time of one call over REPS calls, by CUDA events."""
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


def extents_of(anc: torch.Tensor) -> torch.Tensor:
    """The extents a decode inverted: ``f_j = #{k : anc_k ≤ j}``."""
    return torch.cumsum(torch.bincount(anc.long(), minlength=anc.numel()), 0)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


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


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs only on a GPU")
    import advancedps_tpu_torch as apt
    from advancedps_tpu_torch.ops import _build
    from advancedps_tpu_torch.ops import resample as ops

    names = [w.__name__ for w in ops.KERNEL_WRAPPERS]

    def counts():
        return {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}

    def expected(per_firing, firings):
        return {name: per_firing.get(name, 0) * firings for name in names}

    main_launches = dict.fromkeys(names, 0)

    def drive(fn):
        """Run one main path with the counts set to 0 just before it; return
        its result and the counts read just after."""
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = counts()
        for name, c in got.items():
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
    _build.library()
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {time.perf_counter() - t0:.2f}s {lib_path.name}", flush=True)
    for ln in ptxas:
        print(f"  ptxas {ln}", flush=True)

    # ---- 3. kernels vs plain versions on the card, M = N = 1M
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = dict.fromkeys(names, 0.0)
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
            cases = [("thresholds", S[:n], thr),
                     ("one value", S[:n], torch.full_like(thr, float(S[n // 2]))),
                     ("one tile", S[:n], torch.linspace(float(S[n // 3]), float(S[n // 3 + 1]),
                                                        N, device="cuda").sort().values)]
            for what, s_, t_ in cases:
                want = ops.count_le_sorted_ref(s_, t_)
                for fn in (ops.count_le_sorted_bs, ops.count_le_sorted):
                    got = fn(s_, t_)
                    check(torch.equal(got, want), f"{profile} n={n} {what}: {fn.__name__} differs")
            f_m = ops.count_le_sorted_bs(S[:n], thr)
            for f_x in (f_s, f_m):
                a_x = ops.decode_ancestors(f_x, N, guard=n)
                check(torch.equal(a_x, ops.decode_ancestors_ref(f_x, N, guard=n)),
                      f"{profile} n={n}: decode of scheme extents differs")
                check((int(a_x[-1]) == N) == (n == N - 1), f"{profile} n={n}: guard slot")
        print(f"kernels vs plain [{profile}]: extents ±{int(diff.max())} in {flips:.2e} of "
              f"entries, decode exact, move bitwise (D=1, D=3), guard ok; B4, B5 and the "
              f"windowed B2 exact and bitwise (whole, {K} windows, 3L rows); B6 within "
              f"{ulp6} ulps and nondecreasing; B7 = B8 = plain (thresholds, one value, "
              f"one tile)", flush=True)
    torch.cuda.synchronize()

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
    evidence = {}
    for label, fn in schemes.items():
        ops.COUNT_LE_SORTED = "merge" if "merge" in label else "bs"
        sampler = apt.SMC(N, apt.ResampleWithESSThreshold(fn))
        t0 = time.perf_counter()
        smc, launches = drive(lambda: apt.sample(key, traced, sampler, device="cuda"))
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
        check(tuple(smc.trajectories.shape) == (T, N), f"{label}: trajectories shape")
        check(bool(torch.isfinite(smc.trajectories).all()), f"{label}: trajectories not finite")
        check(abs(float(smc.weights.sum()) - 1.0) < 1e-4, f"{label}: weights do not sum to 1")

        a = apt.sweep(key, kernel, N, sampler.resampler, store_states=False, device="cuda")
        b = apt.sweep(key, kernel, N, sampler.resampler, store_states=False, device="cuda")
        check(torch.equal(a.log_evidence, b.log_evidence), f"{label}: same key, logZ differs")
        check(torch.equal(a.ancestors, b.ancestors), f"{label}: same key, ancestors differ")
        check(torch.equal(a.log_evidence, smc.log_evidence), f"{label}: sweep and sample disagree")
        evidence[label] = smc.log_evidence
    # B7 and B8 give the same counts, so the same key gives the same sweep.
    check(torch.equal(evidence["multinomial"], evidence["multinomial, merge path"]),
          "multinomial: B7 and B8 sweeps differ")
    ops.COUNT_LE_SORTED = "bs"
    print("repeat: same key gives bitwise equal logZ and ancestors for every scheme; "
          "B7 and B8 multinomial sweeps bitwise equal", flush=True)

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
        by_version[ver] = res
    ops.MOVE_VERSION = 6
    single = by_version[6]
    for ver in (1, 0):
        check(torch.equal(by_version[ver].log_evidence, single.log_evidence)
              and torch.equal(by_version[ver].ancestors, single.ancestors),
              f"move version {ver}: sweep differs from version 6")
    print("move versions 6, 1, 0: bitwise equal logZ and ancestors", flush=True)

    # ---- 5. the sharded flagship on K logical shards of the card
    from advancedps_tpu_torch import parallel
    from advancedps_tpu_torch.parallel import sharded as sharded_mod

    mesh = parallel.particle_mesh(K, "cuda")
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
        want = expected({"decode_ancestors": K, "move_rows": K}, fires_ex)
        want["extents_from_logw"] = K * n_ag
        check(launches == want, f"sharded {ex}: launches {launches} != {want}")
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
    ops.MOVE_VERSION = 1
    mesh.reset_counts()
    res, launches = drive(lambda: parallel.sharded_sweep(key, kernel, N, systematic, mesh,
                                                         store_states=False))
    ops.MOVE_VERSION = 6
    check(torch.equal(res.log_evidence, auto.log_evidence)
          and torch.equal(res.ancestors, auto.ancestors),
          "sharded: move version 1 differs from version 6")
    check(launches["decode_move"] == K * int(auto.resampled.sum())
          and launches["decode_ancestors"] == 0,
          f"sharded, move version 1: launches {launches}")
    print(f"sharded flagship: auto bitwise equal to neighbor "
          f"({'checked' if auto_branches.get('allgather', 0) == 0 else 'not checked: a firing fell back'}); "
          f"move version 1 (B4, {launches['decode_move']} launches) bitwise equal to 6", flush=True)

    # ---- 6. PGAS at 1M, replay storage (bench_pgas.py), single-device and sharded
    sm = apt.utils.kalman_smoother(ys, A, 0.0, Q, 1.0, R, 0.0, SIGMA0)
    pgas = apt.PGAS(N)

    def anchor_chains():
        means = []
        for c in range(PGAS_CHAINS):
            res = apt.sample(apt.rng.fold_in(apt.rng.key(9), c), traced, pgas, PGAS_ITERS,
                             trajectory_storage="replay", device="cuda")
            check(bool(torch.isfinite(res.trajectory).all()), "PGAS trajectory not finite")
            means.append(res.trajectory[PGAS_WARM:].double().mean(0).cpu())
        return torch.stack(means), res

    t0 = time.perf_counter()
    (cm, last), launches = drive(anchor_chains)
    anchor_s = time.perf_counter() - t0
    iters = PGAS_CHAINS * PGAS_ITERS
    est = cm.mean(0)
    # SE from the independent chain means, floored at the posterior sd over
    # the pooled iterates (bench_pgas.py:103-111).
    sd = sm.variances.sqrt()
    se = torch.maximum(cm.std(0, unbiased=True) / math.sqrt(PGAS_CHAINS),
                       sd / math.sqrt(PGAS_CHAINS * (PGAS_ITERS - PGAS_WARM)))
    zrms = float((((est - sm.means) / se) ** 2).mean().sqrt())
    lz_err = abs(float(last.log_evidence[-1]) - float(sm.log_likelihood))
    print(f"PGAS N={N} T={T} replay: {PGAS_CHAINS} chains x {PGAS_ITERS} iterations "
          f"({PGAS_WARM} dropped) in {anchor_s:.3f}s; RMS z-score vs RTS smoother {zrms:.4f}; "
          f"final-iteration |logZ - kalman| {lz_err:.6f}; launches {launches} {tag}", flush=True)
    check(zrms < 3.0, f"PGAS: RMS z-score vs RTS smoother {zrms} >= 3")
    check(lz_err < 1.0, f"PGAS: final |logZ - kalman| = {lz_err} >= 1")
    check(launches == expected(PER_FIRING["systematic"], iters * (T - 1)),
          f"PGAS: launches {launches}, expected {T - 1} of B1-B3 per iteration")

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

    st = apt.PGState(last.trajectory[-1])
    k_rd = apt.rng.key(12)
    dense, _ = apt.step_pg(k_rd, traced, pgas, st, "dense", device="cuda")
    repl, _ = apt.step_pg(k_rd, traced, pgas, st, "replay", device="cuda")
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
    want = expected({"decode_ancestors": K, "move_rows": K}, firings)
    want["extents_from_logw"] = K * branches.get("allgather", 0)
    check(sum(branches.values()) == firings and launches == want,
          f"sharded PGAS: launches {launches} != {want}")
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
    check(launches == expected({"extents_from_logw": 1, "decode_ancestors": 1, "move_rows": 1},
                               firings), f"sharded chains: launches {launches}")

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
    scale = N / s1
    g = apt.multinomial_spacings(apt.rng.key(8), N, device="cuda")
    S = ops.prefix_sum(g)
    thr = ops.scaled_prefix_from_logw(logw, m, S[N] / s1)
    s_, one = S[:N], torch.full_like(thr, float(S[N // 2]))
    timing = {
        "extents_from_logw": plain_vs_kernel(
            lambda: ops.extents_from_logw_ref(logw, m, s1, u, N),
            lambda: ops.extents_from_logw(logw, m, s1, u, N)),
        "decode_ancestors": plain_vs_kernel(
            lambda: ops.decode_ancestors_ref(f, N), lambda: ops.decode_ancestors(f, N)),
        "move_rows": plain_vs_kernel(
            lambda: ops.resample_move_ref(anc, x), lambda: ops.move_rows(anc, x)),
        "decode_move": plain_vs_kernel(
            lambda: ops.decode_move_ref(f, x, N), lambda: ops.decode_move(f, x, N)),
        "decode_ancestors_dense": plain_vs_kernel(
            lambda: ops.decode_ancestors_dense_ref(f, N), lambda: ops.decode_ancestors_dense(f, N)),
        "scaled_prefix_from_logw": plain_vs_kernel(
            lambda: ops.scaled_prefix_ref(logw, m, scale, True),
            lambda: ops.scaled_prefix_from_logw(logw, m, scale)),
        "prefix_sum": plain_vs_kernel(
            lambda: ops.scaled_prefix_ref(g, None, None, False), lambda: ops.prefix_sum(g)),
        "count_le_sorted_bs": plain_vs_kernel(
            lambda: ops.count_le_sorted_ref(s_, thr), lambda: ops.count_le_sorted_bs(s_, thr)),
        "count_le_sorted": plain_vs_kernel(
            lambda: ops.count_le_sorted_ref(s_, thr), lambda: ops.count_le_sorted(s_, thr)),
    }

    def turns(readings):
        return ", ".join(f"{r:.4f}" for r in readings)

    for name, (k_ms, p_ms, readings) in timing.items():
        print(f"kernel {name} at 1M: {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"(plain, kernel, kernel, plain: {turns(readings)}) {tag}", flush=True)
    k_ms, p_ms, readings = plain_vs_kernel(
        lambda: ops.decode_ancestors_ref(f, L, guard=N, start=2 * L),
        lambda: ops.decode_ancestors(f, L, guard=N, start=2 * L))
    print(f"kernel decode_ancestors at 1M, window of L={L}: {k_ms:.4f} ms, plain {p_ms:.4f} ms "
          f"({turns(readings)}) {tag}", flush=True)
    k_ms, p_ms, readings = plain_vs_kernel(
        lambda: ops.decode_move_ref(f, x, L, guard=N, start=2 * L),
        lambda: ops.decode_move(f, x, L, guard=N, start=2 * L))
    print(f"kernel decode_move at 1M, window of L={L}: {k_ms:.4f} ms, plain {p_ms:.4f} ms "
          f"({turns(readings)}) {tag}", flush=True)
    for fn in (ops.count_le_sorted_bs, ops.count_le_sorted):
        k_ms, p_ms, readings = plain_vs_kernel(lambda: ops.count_le_sorted_ref(s_, one),
                                               lambda: fn(s_, one))
        print(f"kernel {fn.__name__} at 1M, every threshold one value: {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms ({turns(readings)}) {tag}", flush=True)
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

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profiled(what, fn, reads):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
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

    profiled("systematic sweep",
             lambda: float(apt.sweep(apt.rng.key(20), kernel, N, apt.SMC(N).resampler,
                                     store_states=False, device="cuda").log_evidence),
             f"{T - 1} gate reads")
    profiled("PGAS iteration (replay)",
             lambda: float(apt.step_pg(apt.rng.key(21), traced, pgas, st, "replay",
                                       device="cuda")[0].log_evidence),
             "no gate: every step resamples")
    profiled(f"sharded systematic sweep, K={K}, auto",
             lambda: float(parallel.sharded_sweep(apt.rng.key(20), kernel, N, systematic, mesh,
                                                  store_states=False).log_evidence),
             f"{T - 1} gate reads and a boundary read per firing")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": main_launches[name], "max_abs_err": err[name],
         "ms": timing[name][0], "plain_ms": timing[name][1]}
        for name in names
    ]}
    for k in record["kernels"]:
        check(k["launches"] > 0, f"{k['name']} was never launched on a main path")
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
