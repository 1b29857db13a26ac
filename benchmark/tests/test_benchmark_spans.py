"""The span readers (``benchmark/spans.py`` and the metrics that read it) on
hand-built windows: the pairing of records with their calls kind by kind,
None where the pairing fails or there is nothing to read, no reading moved
by the device clock's offset from the host's, the gate's idle arithmetic,
and the manifest entries.  On the card: a small traced run of
each cell reads every span metric and lists no span among the device's
records."""

import json
from types import SimpleNamespace

import pytest

from benchmark import manifest, spans, trace

NEW = ("weights_ms_per_step", "propagate_score_ms_per_step", "resample_ms_per_firing",
       "gate_idle_ms_per_sweep")


def _window(device, runtime, host):
    return trace.Window(wall_s=1e-3, device=list(device), runtime=list(runtime),
                        host=list(host))


#: One step: weights, gate, a firing and propagate + score, then the
#: harness's read outside every span.  Copies and sets interleave with
#: kernels, so a pairing across kinds would misplace them.
HOST = [("aps.weights", 0, 10), ("aten::sum", 1, 3), ("aps.gate", 10, 20),
        ("aps.resample", 20, 30), ("aps.propagate_score", 30, 60)]
RUNTIME = [("cudaLaunchKernel", 1, 2), ("cudaLaunchKernel", 3, 4),
           ("cudaMemcpyAsync", 11, 19), ("cudaStreamSynchronize", 12, 18),
           ("cudaLaunchCooperativeKernel", 21, 22), ("cudaMemsetAsync", 23, 24),
           ("cuLaunchKernel", 25, 26), ("cudaLaunchKernel", 31, 32),
           ("cudaMemcpyAsync", 33, 34), ("cudaLaunchKernel", 61, 62),
           ("cudaGetDevice", 63, 64)]
DEVICE = [("k0", 5, 7), ("k1", 7, 8), ("Memcpy DtoH (Device -> Pageable)", 12, 13),
          ("k2", 40, 44), ("Memset (Device)", 44, 45), ("k3", 45, 48), ("k4", 48, 51),
          ("Memcpy HtoD (Pageable -> Device)", 51, 52), ("k5", 70, 71)]


def test_records_pair_with_their_calls_kind_by_kind():
    t = spans.device_us(_window(DEVICE, RUNTIME, HOST))
    assert t == {"aps.weights": 3, "aps.gate": 1, "aps.resample": 4 + 1 + 3,
                 "aps.propagate_score": 3 + 1, "": 1}
    w = _window(DEVICE, RUNTIME, HOST)
    assert spans.span_ms(w, "aps.resample") == pytest.approx(8e-3)
    assert spans.span_ms(w, "aps.keep") is None
    assert spans.counts(w) == {"aps.weights": 1, "aps.gate": 1, "aps.resample": 1,
                               "aps.propagate_score": 1}


@pytest.mark.parametrize("kind, drop", [("kernel", "k3"), ("copy", "Memcpy HtoD"),
                                        ("set", "Memset")])
def test_a_count_that_differs_gives_none_and_names_the_kind(kind, drop, capsys):
    device = [d for d in DEVICE if not d[0].startswith(drop)]
    assert spans.device_us(_window(device, RUNTIME, HOST)) is None
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and f" {kind} records against " in err[0]


def test_kinds_in_another_order_give_none(capsys):
    # The set runs before the kernel enqueued ahead of it.
    device = [("Memset (Device)", 39, 40) if d[0].startswith("Memset") else d
              for d in DEVICE]
    assert spans.device_us(_window(device, RUNTIME, HOST)) is None
    err = capsys.readouterr().err.strip().splitlines()
    assert err == ["spans: record 3 is a set, and call 3 enqueues a kernel"]


@pytest.mark.parametrize("offset", [lambda t: t - 5000, lambda t: t + 3000,
                                    lambda t: t * 1.012 - 40],
                         ids=["behind", "ahead", "drifting"])
def test_the_device_clock_s_offset_moves_nothing(offset):
    device = [(name, offset(a), offset(b)) for name, a, b in DEVICE]
    w, shifted = _window(DEVICE, RUNTIME, HOST), _window(device, RUNTIME, HOST)
    assert spans.device_us(shifted) == pytest.approx(spans.device_us(w), rel=0.02)
    assert spans.gate_idle_us(shifted) == pytest.approx(spans.gate_idle_us(w), rel=0.02)


def _run(w, sweeps=2, steps=10):
    return SimpleNamespace(window=w, window_sweeps=sweeps, window_steps=sweeps * steps)


@pytest.mark.parametrize("host, device", [
    ([h for h in HOST if not h[0].startswith("aps.")], DEVICE),  # a program without spans
    (HOST, []),  # no device records: a run on the CPU
], ids=["no spans", "no device"])
def test_with_nothing_to_read_every_span_metric_is_none(host, device, capsys):
    run = _run(_window(device, RUNTIME, host))
    for name in NEW:
        assert manifest.metric_reader(name).read(run) is None, name
    assert capsys.readouterr().err == ""


def test_the_readers_divide_by_steps_firings_and_sweeps():
    run = _run(_window(DEVICE, RUNTIME, HOST), sweeps=2, steps=10)
    read = {name: manifest.metric_reader(name).read(run) for name in NEW}
    assert read["weights_ms_per_step"] == pytest.approx(3e-3 / 20)
    assert read["propagate_score_ms_per_step"] == pytest.approx(4e-3 / 20)
    assert read["resample_ms_per_firing"] == pytest.approx(8e-3)
    # The gate closes at 20 with the device idle since the copy ended at 13;
    # the next record starts at 40.
    assert read["gate_idle_ms_per_sweep"] == pytest.approx(27e-3 / 2)


def test_the_gate_idle_arithmetic_on_a_hand_built_timeline():
    calls = [("cudaLaunchKernel", 1, 2),
             ("cudaMemcpyAsync", 3, 11),  # the first gate's read
             ("cudaLaunchKernel", 13, 14),  # the first record after it
             ("cudaLaunchKernel", 30, 31), ("cudaLaunchKernel", 32, 33),
             ("cudaLaunchKernel", 50, 51)]
    device = [("k", 100, 105), ("Memcpy DtoH", 106, 109.5), ("k", 120, 130),
              ("k", 131, 150), ("k", 150, 152), ("k", 170, 171)]
    gates = [("aps.gate", 2, 12), ("aps.gate", 31.5, 31.8), ("aps.gate", 60, 70)]
    w = _window(device, calls, gates)
    # 120 − 109.5 after the first; none after the second, whose next record
    # (150) starts as the last one enqueued before it ends; the third has no
    # record after it.
    assert spans.gate_idle_us(w) == pytest.approx(10.5)
    assert spans.gate_idle_us(_window(device, calls, [("aps.weights", 0, 1)])) is None
    assert spans.gate_idle_us(_window(device[1:], calls, gates)) is None


@pytest.mark.parametrize("name", NEW)
def test_each_new_entry_keeps_the_contract(name):
    m = manifest.load()
    (entry,) = [e for e in m["per_layer"] if e["name"] == name]
    assert entry["source"] == "program_span" and entry["moves"] == "particle_steps_per_s"
    assert entry["unit"] == "ms" and entry["better"] == "lower"
    assert entry["layer"] in {e["layer"] for e in m["per_layer"] if e["name"] not in NEW}
    alone = dict(m, per_layer=[entry])
    assert manifest.check(alone) == []
    assert set(entry["workloads"]) <= {w["name"] for w in m["workloads"]}
    assert callable(manifest.metric_reader(name).read)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def small_traced_run(workload: str) -> dict:
    """One traced run of ``workload`` at 2^18 particles (at most 4 chains) on
    the card: what the span readers saw in its window."""
    from benchmark import run

    windows = []
    real = trace.from_profile

    def keep(prof, wall_s):
        windows.append(real(prof, wall_s))
        return windows[-1]

    trace.from_profile = keep
    cell = manifest.resolve(workload)
    cell.traffic = {**cell.traffic, "particles": 1 << 18,
                    "chains": min(cell.traffic["chains"], 4), "warm_sweeps": 1,
                    "trace_sweeps": 1, "reference_sweeps": 1}
    out = run.run_cell(workload, 2 ** 31 + 5, 0.5, True, "cuda", cell)["result"]
    (w,) = windows
    t = spans.device_us(w)
    return {"device_spans": [n for n, _, _ in w.device if n.startswith(spans.PREFIX)],
            "device_ops": [op for op, _ in out["breakdown"]["device_ops"]],
            "want": sorted(e["name"] for e in cell.per_layer if e["name"] in NEW),
            "metrics": sorted(out["metrics"]),
            "in_spans": None if t is None else sum(v for k, v in t.items() if k),
            "device": sum(b - a for _, a, b in w.device)}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in manifest.load()["workloads"]])
def test_on_the_card_a_traced_run_reads_every_span_metric(card, workload):
    # A process of its own, as every run of the harness has: a second
    # profiler session in one process lost a kernel record on the card.
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-m", "benchmark.tests.test_benchmark_spans",
                           workload], capture_output=True, text=True, cwd=str(manifest.ROOT),
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not got["device_spans"]
    assert not [op for op in got["device_ops"] if op.startswith(spans.PREFIX)]
    assert set(got["want"]) <= set(got["metrics"]), proc.stderr[-2000:]
    assert got["in_spans"] >= 0.95 * got["device"]


if __name__ == "__main__":
    import sys

    print(json.dumps(small_traced_run(sys.argv[1])), flush=True)
