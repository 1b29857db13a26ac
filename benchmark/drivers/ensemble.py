"""``parallel.chains.smc_ensemble``: ``chains`` independent SMC sweeps of
``particles`` particles as one batch, run ``c`` keyed ``fold_in(key, c)``."""

from __future__ import annotations

from benchmark.reference import cipher


def make(apt, traced, traffic: dict, device):
    from advancedps_tpu_torch.parallel.chains import smc_ensemble

    sampler = apt.SMC(traffic["particles"], threshold=traffic["threshold"])
    runs = traffic["chains"]

    def call(k):
        res = smc_ensemble(apt.rng.Key(*k), traced, sampler, runs, store_states=False,
                           device=device)
        d = res.diagnostics
        return res.log_evidence, d["ess"], d["resampled"]

    return call


def chain_keys(k, traffic: dict) -> list:
    return [cipher.fold_in(k, c) for c in range(traffic["chains"])]


def particles_per_call(traffic: dict) -> int:
    return traffic["chains"] * traffic["particles"]
