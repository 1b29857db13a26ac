"""The check that ends every run: the top-level name of each module, whole."""

import sys
import types

import pytest

from benchmark import run


@pytest.mark.parametrize("name,refused", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
    ("advancedps_tpu", True), ("advancedps_tpu.ops.native", True),
    ("advancedps_tpu_torch", False), ("advancedps_tpu_torch.ops", False),
    ("jaxtyping", False), ("flaxen", False),
])
def test_forbidden_modules_compare_whole_top_level_names(monkeypatch, name, refused):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in run.forbidden_modules()) is refused


def test_the_harness_and_the_program_import_no_jax():
    import subprocess

    code = ("import benchmark.run, benchmark.calibrate, advancedps_tpu_torch, "
            "advancedps_tpu_torch.parallel.chains, sys; from benchmark import run; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(run.manifest.ROOT), check=True)
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_either_package():
    import subprocess

    code = ("import sys; import benchmark.reference.smc, benchmark.reference.compare; "
            "from benchmark import manifest; "
            "[manifest.resolve(w['name']) for w in manifest.load()['workloads']]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'advancedps_tpu', 'advancedps_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(run.manifest.ROOT), check=True)
    assert out.stdout.strip() == "[]"


def test_without_a_card_a_run_prints_no_result():
    import subprocess

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "lgssm-smc",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         cwd=str(run.manifest.ROOT))
    assert out.returncode != 0 and out.stdout == ""
