"""The numbers that decide ``correct``, from one sweep's outputs and the
reference's for the same observations and keys, run by run (the max over
runs is taken):

* ``logz_gap``: ``|log Z - log Z_ref|``.  Once the two populations part
  (rounding moves an extent, at some firing), the gap is Monte Carlo noise
  between two filters that share their draws.
* ``ess_gap``: the largest relative gap of the ESS over the steps up to the
  later of the two first firings.  Until the first resampling both sides
  hold the same particles, so the gap is rounding; a firing on one side only
  shows as a gap of order one at the next step.
* ``ess_next_gap``: the relative gap of the ESS at the step after that first
  firing, the first that reads the resampling's work: the extents, the
  ancestors and every leaf of the moved state, propagated and scored once.
  Both sides resample alike where their weights agree (the reference's
  extents are rounded as the program defines them), so the gap is rounding
  and the rare extent that rounding moves; a wrong ancestor table or a leaf
  left unmoved gives another population and a Monte Carlo gap.
"""

from __future__ import annotations

import torch


def _first_fire(fired: torch.Tensor) -> torch.Tensor:
    """Per run, the first step ``t >= 1`` that resampled, or T - 1."""
    T = fired.shape[-1]
    steps = torch.arange(T).expand_as(fired)
    hit = torch.where(fired & (steps >= 1), steps, torch.full_like(steps, T - 1))
    return hit.amin(-1)


def numbers(logz, ess, fired, ref) -> dict:
    """``logz [C]``, ``ess [C, T]``, ``fired [C, T]`` of the program (CPU);
    ``ref`` a :class:`benchmark.reference.smc.Result`."""
    logz, ess = logz.double().cpu(), ess.double().cpu()
    fired, rfired = fired.bool().cpu(), ref.resampled.cpu()
    rz, ress = ref.log_evidence.cpu(), ref.ess.cpu()
    end = torch.maximum(_first_fire(fired), _first_fire(rfired))
    T = ess.shape[-1]
    steps = torch.arange(T).expand_as(ess)
    window = (steps >= 1) & (steps <= end[:, None])
    rel = ((ess - ress).abs() / ress).nan_to_num(nan=float("inf"))
    nxt = end + 1
    after = rel.gather(1, torch.clamp(nxt, max=T - 1)[:, None])[:, 0]
    after = torch.where(nxt < T, after, torch.zeros_like(after))
    return {"logz_gap": float((logz - rz).abs().nan_to_num(nan=float("inf")).max()),
            "ess_gap": float(torch.where(window, rel, torch.zeros_like(rel)).max()),
            "ess_next_gap": float(after.max())}
