"""One SMC sweep a call: ``inference.sample_smc`` of ``particles`` particles,
systematic resampling gated at ESS <= ``threshold`` * N, log-evidence only."""

from __future__ import annotations


def make(apt, traced, traffic: dict, device):
    """A call of the program on the key words ``k``; it returns the sweep's
    ``(log_evidence [1], ess [1, T], resampled [1, T])`` as the program
    gives them (device tensors)."""
    sampler = apt.SMC(traffic["particles"], threshold=traffic["threshold"])

    def call(k):
        res = apt.sample_smc(apt.rng.Key(*k), traced, sampler, store_states=False,
                             device=device)
        d = res.diagnostics
        return res.log_evidence.reshape(1), d["ess"][None], d["resampled"][None]

    return call


def chain_keys(k, traffic: dict) -> list:
    return [k]


def particles_per_call(traffic: dict) -> int:
    return traffic["particles"]
