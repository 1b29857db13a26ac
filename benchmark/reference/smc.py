"""The plain reference sweep: a bootstrap particle filter for C independent
runs at once, written from its definition.

Each step reduces the weights, adds ``logsumexp(logw) - log(previous base)``
to the log-evidence (the base is ``log N`` after a resampling, the previous
step's ``logsumexp`` otherwise), computes the ESS ``(sum w)^2 / sum w^2`` and,
where it is at most ``threshold * N`` (every step for ``threshold >= 1``),
resamples systematically: one uniform ``u`` a run, particle ``k`` takes the
first ``j`` whose extent ``f_j = ceil(N cdf_j - u)`` exceeds ``k``, where
``cdf_j`` is the cumulative weight summed in float64 and rounded to float32,
times the float32 reciprocal of the weights' sum.  The extents are computed
in float32, each operation rounded on its own, as the JAX package's
systematic resampler defines them: near ``N = 2^24`` a float32 holds
``N cdf_j`` only to half a slot or a slot, so the exact float64 form would
part from the program at the first resampling by rounding alone.  Then every
particle moves and scores the next observation.

``dtype`` is the precision of the state, the weights and every reduction:
float32 for the reference, bfloat16 for its control.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from benchmark.reference import cipher


@dataclass
class Result:
    log_evidence: torch.Tensor  # [C] float64
    ess: torch.Tensor  # [C, T] float64
    resampled: torch.Tensor  # [C, T] bool
    owner_share: float  # mean share of rows that own a slot, over the firings


def _words(keys, device):
    k0 = torch.tensor([k[0] for k in keys], dtype=torch.int64, device=device)[:, None]
    k1 = torch.tensor([k[1] for k in keys], dtype=torch.int64, device=device)[:, None]
    return k0, k1


def systematic(e, s1, u, n: int) -> torch.Tensor:
    """Ancestors ``[C, n]`` (int64) of weights ``e [C, N]`` with sums
    ``s1 [C]`` and offsets ``u [C]`` (float32)."""
    cdf = torch.cumsum(e.double(), -1).float() * (1.0 / s1.float())[:, None]
    f = torch.clamp(torch.ceil(n * cdf - u[:, None]), 0, n).long()
    f = torch.cummax(f, -1).values
    f[:, -1] = n
    k = torch.arange(n, dtype=torch.int64, device=e.device).expand(e.shape[0], n)
    return torch.searchsorted(f, k.contiguous(), right=True)


@torch.no_grad()
def sweep(model, cfg, ys: torch.Tensor, keys, n: int, threshold: float,
          dtype=torch.float32) -> Result:
    """One sweep of each run ``c`` under the key ``keys[c]`` (two uint32
    words), over the observations ``ys [T]``; ``model`` is the
    configuration's module (``init``, ``step``, ``move``)."""
    device = ys.device
    C, T = len(keys), ys.shape[0]
    ids = torch.arange(n, device=device)
    tags = (cipher.INIT, cipher.PROPAGATE, cipher.RESAMPLE)
    step_k = [[cipher.fold_in(tk, t) for t in range(T)]
              for tk in (cipher.fold_in(k, tag) for k in keys for tag in tags)]

    def k_of(tag_pos, t):
        return _words([step_k[3 * c + tag_pos][t] for c in range(C)], device)

    state, logw = model.init(cfg, k_of(0, 0), ids, ys[0].to(dtype), dtype)
    ln_n = torch.tensor(math.log(n), dtype=dtype, device=device)
    log_z = torch.zeros(C, dtype=dtype, device=device)
    pending = ln_n.expand(C)
    ess_all = torch.full((C, T), float(n), dtype=torch.float64, device=device)
    fired = torch.zeros((C, T), dtype=torch.bool)
    owners = []
    for t in range(1, T):
        m = torch.amax(logw, -1, keepdim=True)
        e = torch.exp(logw - m)
        s1 = torch.sum(e, -1)
        s2 = torch.sum(e * e, -1)
        lse = m[:, 0] + torch.log(s1)
        log_z = log_z + (lse - pending)
        ess = s1 * s1 / s2
        ess_all[:, t] = ess.double()
        fire = torch.ones(C, dtype=torch.bool) if threshold >= 1.0 else \
            (ess.double() <= threshold * n).cpu()
        fired[:, t] = fire
        if bool(fire.any()):
            u = torch.tensor([cipher.uniform_scalar(step_k[3 * c + 2][t]) for c in range(C)],
                             dtype=torch.float32, device=device)
            anc = systematic(e, s1, u, n)
            f = fire.to(device)
            keep = torch.arange(n, device=device).expand(C, n)
            anc = torch.where(f[:, None], anc, keep)
            for c in torch.nonzero(fire)[:, 0].tolist():
                owners.append(torch.unique_consecutive(anc[c]).numel() / n)
            state = model.move(state, anc)
            pending = torch.where(f, ln_n, lse)
        else:
            f = None
            pending = lse
        state, score = model.step(cfg, t, k_of(1, t), ids, state, ys[t].to(dtype), dtype)
        logw = logw + score if f is None else torch.where(f[:, None], score, logw + score)
    log_z = log_z + (torch.logsumexp(logw, -1) - pending)
    return Result(log_evidence=log_z.double(), ess=ess_all, resampled=fired,
                  owner_share=sum(owners) / len(owners) if owners else math.nan)
