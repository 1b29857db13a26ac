"""The ``levy-smc`` cell on the CPU: a small run is correct and each fault
planted in the timed path is not; the manifest keeps its contract with the
``levy`` entries; the reference and the harness import nothing of JAX or of
the JAX package; and the reader of the nested ``aps.jump_path`` span on
hand-built windows."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from benchmark import manifest, run, spans, trace
from benchmark.tests.faults import FAULTS

SEED = 2 ** 31 + 977
READER = "jump_path_ms_per_step"
#: Metrics whose readers hold for any single-sweep cell, and so read this one.
SHARED = ("device_idle_share", "peak_mem_gib", "launches_per_step",
          "host_syncs_per_sweep", "torch_kernels_ms_per_step", "resample_roofline",
          "step_mfu", "weights_ms_per_step", "resample_ms_per_firing",
          "gate_idle_ms_per_sweep")


def small():
    """The cell at 1024 particles over the configuration's first 50 steps."""
    cell = manifest.resolve("levy-smc")
    cell.config = {**cell.config, "num_steps": 50}
    cell.traffic = {**cell.traffic, "particles": 1024, "warm_sweeps": 1, "trace_sweeps": 1,
                    "reference_sweeps": 1}
    return cell


def test_a_small_run_is_correct():
    out = run.run_cell("levy-smc", SEED, 0.05, False, "cpu", small())["result"]
    assert out["correct"], json.dumps(out["checks"])
    assert set(out["checks"]) == {"logz_gap", "ess_gap", "ess_next_gap"}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch.setattr)
    out = run.run_cell("levy-smc", SEED, 0.05, False, "cpu", small())["result"]
    assert not out["correct"], json.dumps(out["checks"])


def test_the_manifest_keeps_the_contract_with_the_levy_entries():
    m = manifest.load()
    assert manifest.check(m) == []
    (conf,) = [c for c in m["configs"] if c["name"] == "levy"]
    assert conf["reduced"] == [] and conf["source"].endswith("examples/levy-ssm/script.jl")
    (cell,) = [w for w in m["workloads"] if w["config"] == "levy"]
    assert cell["name"] == "levy-smc" and cell["chips"] == 1 and len(cell["why"]) <= 200
    by_name = {e["name"]: e for e in m["per_layer"]}
    assert by_name[READER]["workloads"] == ["levy-smc"]
    assert by_name[READER]["layer"] == by_name["torch_kernels_ms_per_step"]["layer"]
    for name in SHARED:
        assert by_name[name]["workloads"][-1] == "levy-smc", name
    # Neither reads this cell: the Threefry counts are of one element a
    # particle a launch, and ``aps.propagate_score`` holds a nested span here.
    for name in ("rng_roofline", "propagate_score_ms_per_step"):
        assert "levy-smc" not in by_name[name]["workloads"], name
    c = manifest.resolve("levy-smc")
    assert c.traffic["particles"] == 2 * 2 ** 20 and c.config["num_steps"] == 200
    assert c.reference.row_words(c.config) == 2
    work = c.reference.step_work(c.config, 1)
    assert work["int_ops"] == 79 * (3 * 64 // 2 + 7)


def test_the_reference_and_the_harness_import_no_jax():
    code = ("import sys; from benchmark import manifest; c = manifest.resolve('levy-smc'); "
            "c.reference.simulate(c.config); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'advancedps_tpu', 'advancedps_tpu_torch'})); "
            "import benchmark.run, advancedps_tpu_torch.models.levy; "
            "from benchmark import run; print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(manifest.ROOT), check=True)
    assert out.stdout.split() == ["[]", "[]"]


def _window(device, runtime, host):
    return trace.Window(wall_s=1e-3, device=list(device), runtime=list(runtime),
                        host=list(host))


#: One step: weights, then propagate + score holding the jump path and the
#: factor and draw; a launch before the path, two and a copy inside it, one in
#: the draw, then one outside every span.
HOST = [("aps.weights", 0, 10), ("aps.propagate_score", 10, 60), ("aps.jump_path", 12, 40),
        ("aps.factor_draw", 42, 55)]
RUNTIME = [("cudaLaunchKernel", 1, 2), ("cudaLaunchKernel", 11, 12),
           ("cudaLaunchKernel", 13, 14), ("cudaMemcpyAsync", 20, 21),
           ("cudaLaunchKernel", 30, 31), ("cudaLaunchKernel", 45, 46),
           ("cudaLaunchKernel", 61, 62)]
DEVICE = [("k0", 5, 6), ("k1", 20, 22), ("k2", 22, 27), ("Memcpy HtoD (Pageable -> Device)",
                                                          27, 28),
          ("k3", 31, 38), ("k4", 50, 61), ("k5", 70, 71)]


def _run(w, sweeps=1, steps=2):
    return SimpleNamespace(window=w, window_sweeps=sweeps, window_steps=sweeps * steps)


def test_the_jump_path_reader_counts_the_records_enqueued_inside_the_nested_span():
    w = _window(DEVICE, RUNTIME, HOST)
    # k2, the copy and k3: 5 + 1 + 7 us over 2 steps.
    assert manifest.metric_reader(READER).read(_run(w)) == pytest.approx(13e-3 / 2)
    # The reader of unnested spans gives propagate + score only k1, enqueued
    # before the nested spans: why that metric skips this cell.
    assert spans.device_us(w) == {"aps.weights": 1, "aps.propagate_score": 2,
                                  "aps.jump_path": 13, "aps.factor_draw": 11, "": 1}


@pytest.mark.parametrize("offset", [lambda t: t - 5000, lambda t: t * 1.012 + 40],
                         ids=["behind", "drifting"])
def test_the_device_clock_s_offset_moves_the_jump_path_reading_not(offset):
    device = [(name, offset(a), offset(b)) for name, a, b in DEVICE]
    read = manifest.metric_reader(READER).read
    assert read(_run(_window(device, RUNTIME, HOST))) == pytest.approx(
        read(_run(_window(DEVICE, RUNTIME, HOST))), rel=0.02)


@pytest.mark.parametrize("host, device, runtime", [
    (HOST[:2], DEVICE, RUNTIME),  # a program without the spans: the parent's
    (HOST, [], RUNTIME),  # no device records: a run on the CPU
    (HOST, DEVICE[1:], RUNTIME),  # a record lost: the pairing fails
], ids=["no span", "no device", "pairing fails"])
def test_with_nothing_to_read_the_jump_path_reader_gives_none(host, device, runtime):
    assert manifest.metric_reader(READER).read(_run(_window(device, runtime, host))) is None
