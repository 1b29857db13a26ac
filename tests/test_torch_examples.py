"""The PyTorch examples (``examples/torch/``) run end to end on the CPU.

Each script's ``main`` is called in-process at a tiny size with ``--device
cpu``; its returned numbers are held loosely (the sizes are far too small for
the scripts' own accuracy).  The scripts import no JAX.
"""

import importlib.util
import math
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples" / "torch"

#: script → (tiny arguments, check of what main returns)
CASES = {
    "gaussian_ssm": (["--particles", "16", "--steps", "12", "--iters", "6", "--chains", "3"],
                     lambda r: r["logz_err"] < 2.0 and math.isfinite(r["rmse_truth"])),
    "particle_gibbs": (["--particles", "8", "--steps", "10", "--iters", "6"],
                       lambda r: 0.0 <= r["pg"] <= 1.0 and r["pgas"] > 0.3),
    "gaussian_process": (["--particles", "8", "--steps", "6", "--iters", "3"],
                         lambda r: r["finite"]),
    "levy_ssm": (["--particles", "8", "--steps", "4", "--iters", "2"],
                 lambda r: r["finite"]),
    "host_ppl_adapter": (["--n", "128", "--iters", "8", "--T", "10", "--runs", "3"],
                         lambda r: r["err"] < 1.0 and r["ens_err"] < 1.5 and r["zrms"] < 3.0),
    "pg_parameter_learning": (["--particles", "16", "--steps", "20", "--iters", "6"],
                              lambda r: math.isfinite(r["a"]) and r["q"] > 0.0),
}


def _load(name):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, capsys):
    argv, check = CASES[name]
    src = (EXAMPLES / f"{name}.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|advancedps_tpu)\b(?!_torch)", src, re.M)
    result = _load(name).main(argv + ["--device", "cpu"])
    assert check(result), result
    assert capsys.readouterr().out.strip()
