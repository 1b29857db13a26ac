"""The manifest and the files it names: the contract's rules on names, units
and keys, every cell resolving, and a cell, traffic mix and metric added as
new files only being picked up."""

import json
import shutil

import pytest

from benchmark import manifest

M = manifest.load()


def test_manifest_keeps_the_contract():
    assert manifest.check(M) == []
    assert json.dumps(M).__len__() < 64 * 1024


@pytest.mark.parametrize("bad", [
    {"name": "has space"}, {"name": "a/b"}, {"name": "x" * 65}, {"name": "µs"},
])
def test_manifest_refuses_a_bad_name(bad):
    m = json.loads(json.dumps(M))
    m["per_layer"][0].update(bad)
    assert manifest.check(m)


@pytest.mark.parametrize("unit", ["tokens per second", "µs", "x" * 17, ""])
def test_manifest_refuses_a_bad_unit(unit):
    m = json.loads(json.dumps(M))
    m["end_to_end"][0]["unit"] = unit
    assert manifest.check(m)


def test_manifest_refuses_a_loose_bound_and_an_unknown_moves():
    m = json.loads(json.dumps(M))
    m["end_to_end"][0]["bound"] = 0.3
    m["per_layer"][0]["moves"] = "nothing"
    assert len(manifest.check(m)) == 2


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_every_cell_resolves_its_files(workload):
    cell = manifest.resolve(workload)
    assert cell.config["num_steps"] > 0
    for fn in ("simulate", "init", "step", "move", "step_work", "row_words"):
        assert callable(getattr(cell.reference, fn))
    for fn in ("make", "chain_keys", "particles_per_call"):
        assert callable(getattr(cell.driver, fn))
    assert set(cell.limits) == {"logz_gap", "ess_gap", "ess_next_gap"}
    assert {e["name"] for e in cell.end_to_end} >= {"setup_s", "particle_steps_per_s"}
    for e in cell.end_to_end + cell.per_layer:
        assert callable(manifest.metric_reader(e["name"]).read)
    assert cell.per_layer


def test_every_config_and_traffic_is_used():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_kernel_files_name_a_kernel_and_a_layer():
    layers = {e["layer"] for e in M["per_layer"]}
    for k in manifest.kernels():
        assert k.LAYER in layers and k.NAME.isidentifier()


def test_a_cell_traffic_and_metric_added_as_files_only_are_picked_up(tmp_path):
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    traffic = json.loads((bench / "traffic" / "smc-gated.json").read_text())
    traffic["particles"] = 4096
    (bench / "traffic" / "smc-tiny.json").write_text(json.dumps(traffic))
    (bench / "workloads" / "lgssm-tiny.json").write_text(
        json.dumps({"limits": {"logz_gap": 1.0, "ess_gap": 1e-4}}))
    (bench / "metrics" / "sweeps_done.py").write_text("def read(run):\n    return run.sweeps\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "lgssm-tiny", "config": "lgssm", "traffic": "smc-tiny",
                           "chips": 1, "why": "a cell of files only"})
    m["end_to_end"].append({"name": "sweeps_done", "unit": "sweeps", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["lgssm-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    assert manifest.check(m) == []

    cell = manifest.resolve("lgssm-tiny", root=tmp_path)
    assert cell.traffic["particles"] == 4096
    assert "sweeps_done" in {e["name"] for e in cell.end_to_end}
    from benchmark import run

    out = run.run_cell("lgssm-tiny", 7, 0.2, False, "cpu", cell)["result"]
    assert out["correct"]
    assert out["metrics"]["sweeps_done"]["value"] == out["attempted"] >= 1
