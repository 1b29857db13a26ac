"""Carry state across from the JAX package, through numpy arrays only.

Nothing here imports JAX: the caller hands over ``jax.random.key_data(key)``
and the model's parameters and observations as numpy values.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ._device import resolve_device
from .models.lgssm import LinearGaussianSSM
from .rng import Key
from .ssm import TracedSSM

__all__ = ["key_from_words", "traced_ssm_from_numpy", "LGSSM_PARAMS"]

#: The LGSSM parameters :func:`traced_ssm_from_numpy` takes, in the order
#: ``LinearGaussianSSM`` takes them.
LGSSM_PARAMS = ("mu", "sigma0", "a", "b", "q", "h", "r")


def key_from_words(words) -> Key:
    """The :class:`~advancedps_tpu_torch.rng.Key` with the two uint32 words
    that ``jax.random.key_data`` gives."""
    w = np.asarray(words)
    if w.shape != (2,) or not np.issubdtype(w.dtype, np.integer):
        raise ValueError(f"expected two integer key words, got {w!r}")
    return Key(int(w[0]), int(w[1]))


def traced_ssm_from_numpy(params: Mapping[str, object], ys, device=None) -> TracedSSM:
    """A :class:`TracedSSM` of the scalar LGSSM with ``params`` (the names in
    :data:`LGSSM_PARAMS`) and observations ``ys``, on ``device`` (None: the GPU)."""
    missing = set(LGSSM_PARAMS) - set(params)
    if missing:
        raise ValueError(f"missing LGSSM parameters: {sorted(missing)}")
    model = LinearGaussianSSM(*(np.float32(params[k]) for k in LGSSM_PARAMS))
    return TracedSSM(model, np.array(ys, dtype=np.float32)).to(resolve_device(device))
