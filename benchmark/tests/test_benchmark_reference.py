"""The reference against the program at a tiny size on the CPU, its control
in bfloat16, and a run with the timed path broken underneath, for each fault
the cells can have: ``correct`` must come out false."""

import json

import pytest
import torch

import advancedps_tpu_torch as apt
from advancedps_tpu_torch import random as prandom
from advancedps_tpu_torch.ops import threefry as ptf
from benchmark import calibrate, manifest, run
from benchmark.reference import cipher, compare, smc
from benchmark.tests.faults import FAULTS

#: A cell's size here: the particle count and chains a CPU test holds, and
#: the limits of that size (the Monte Carlo gap of log Z grows as N falls).
#: The LGSSM cells resample bitwise as the reference does; the GP-SSM's
#: factor rounds apart from the reference's, which moves a few extents of
#: 4096 at the first firing (``ess_next_gap`` up to 6.4e-5 on the CPU).
SMALL = {"lgssm-smc": (8192, 1), "lgssm-smc-every": (8192, 1), "gpssm-smc": (4096, 1),
         "lgssm-ensemble": (4096, 2)}
SMALL_LIMITS = {"logz_gap": 0.6, "ess_gap": 1e-4}
SMALL_NEXT = {"gpssm-smc": 3e-4}  # ``ess_next_gap``; 1e-5 in the others
SEED = 2 ** 31 + 977


def small(workload):
    cell = manifest.resolve(workload)
    n, c = SMALL[workload]
    cell.traffic = {**cell.traffic, "particles": n, "chains": c, "warm_sweeps": 1,
                    "reference_sweeps": 1, "trace_sweeps": 1}
    cell.limits = {**SMALL_LIMITS, "ess_next_gap": SMALL_NEXT.get(workload, 1e-5)}
    return cell


def test_the_cipher_is_the_programs():
    k = (0x12345678, 0x9ABCDEF0)
    ids = torch.arange(1001, dtype=torch.int64)
    assert torch.equal(cipher.normal_paired(k, ids), ptf.pos_normal_ref(*k, ids))
    b = cipher.threefry2x32(*k, 0, ids)
    ref = ptf.threefry2x32_ref(*k, 0, ids)
    assert torch.equal(b[0], ref[0]) and torch.equal(b[1], ref[1])
    assert cipher.fold_in(k, 5) == tuple(ptf.threefry2x32_ref(*k, 0, 5))
    assert cipher.uniform_scalar(k) == apt.rng.uniform(apt.rng.Key(*k))
    kk = torch.stack(cipher.particle_keys(k, ids), -1)
    assert torch.equal(cipher.normal_keyed(kk[:, 0], kk[:, 1]),
                       torch.vmap(lambda q: prandom.normal(q))(kk))


@pytest.mark.parametrize("workload", list(SMALL))
def test_the_reference_agrees_with_the_program(workload):
    cell = small(workload)
    cal = calibrate.main(["--workload", workload, "--seeds", "3", "4", "--control", "1"],
                         "cpu", cell)
    for name, limit in cell.limits.items():
        assert cal["lower"][name] < limit / 2, (name, cal)
        # The control, the reference in bfloat16, fails the comparison.
        assert cal["upper"][name] > limit, (name, cal)


def test_compare_reads_a_firing_on_one_side_only():
    T = 6
    ess = torch.tensor([[100.0, 80, 60, 45, 90, 70]], dtype=torch.float64)
    fired = torch.tensor([[False, False, False, True, False, False]])
    ref = smc.Result(log_evidence=torch.zeros(1, dtype=torch.float64), ess=ess.clone(),
                     resampled=fired.clone(), owner_share=0.5)
    assert compare.numbers(torch.zeros(1), ess, fired, ref) == {
        "logz_gap": 0.0, "ess_gap": 0.0, "ess_next_gap": 0.0}
    late = ess.clone()
    late[0, 4] = 35.0  # the program did not fire at step 3
    got = compare.numbers(torch.zeros(1), late, torch.zeros(1, T, dtype=torch.bool), ref)
    assert got["ess_gap"] > 0.5


@pytest.mark.parametrize("workload", list(SMALL))
def test_a_sound_run_is_correct(workload):
    out = run.run_cell(workload, SEED, 0.05, False, "cpu", small(workload))["result"]
    assert out["correct"], json.dumps(out["checks"])
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("workload", list(SMALL))
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch.setattr)
    out = run.run_cell(workload, SEED, 0.05, False, "cpu", small(workload))["result"]
    assert not out["correct"], json.dumps(out["checks"])


def test_a_traced_run_on_the_cpu_reads_no_device_metric():
    out = run.run_cell("lgssm-smc", SEED, 0.05, True, "cpu", small("lgssm-smc"))["result"]
    assert out["correct"]
    assert set(out["metrics"]) <= {"device_idle_share"}
    assert "busy_s" in out["device"] and "breakdown" in out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", list(SMALL))
def test_on_the_card_a_small_run_is_correct_and_its_control_is_not(card, workload):
    cell = small(workload)
    out = run.run_cell(workload, SEED, 0.5, False, "cuda", cell)["result"]
    assert out["correct"], json.dumps(out["checks"])
    cal = calibrate.main(["--workload", workload, "--seeds", "5", "--control", "1"], "cuda", cell)
    assert any(cal["upper"][n] > cell.limits[n] for n in cell.limits)
