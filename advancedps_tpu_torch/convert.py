"""Carry state across from the JAX package, through numpy arrays only.

Nothing here imports JAX: the caller hands over ``jax.random.key_data(key)``
and the model's parameters and observations as numpy values.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ._device import resolve_device
from .models import gp_ssm, levy_ssm, stochastic_volatility_ssm
from .models.lgssm import LinearGaussianSSM
from .rng import Key
from .ssm import StateSpaceModel, TracedSSM

__all__ = ["key_from_words", "model_from_numpy", "traced_ssm_from_numpy", "LGSSM_PARAMS",
           "FAMILIES"]

#: The LGSSM parameters :func:`traced_ssm_from_numpy` takes, in the order
#: ``LinearGaussianSSM`` takes them.
LGSSM_PARAMS = ("mu", "sigma0", "a", "b", "q", "h", "r")

#: The other model families by name: each factory and its parameters, the
#: keywords of the JAX package's factory of the same name.  The integer ones
#: (a buffer length, a jump budget) stay integers.
FAMILIES = {
    "stochastic_volatility": (stochastic_volatility_ssm, ("a", "q")),
    "levy": (levy_ssm, ("dt", "theta", "sigma_e", "C", "beta", "mu_w", "sigma_w", "max_jumps")),
    "gp_ssm": (gp_ssm, ("num_steps", "lengthscale", "variance", "prior_sigma")),
}
_INTEGER_PARAMS = ("max_jumps", "num_steps")


def model_from_numpy(family: str, params: Mapping[str, object], device=None) -> StateSpaceModel:
    """The model of ``family`` (``"lgssm"`` or a key of :data:`FAMILIES`)
    with ``params`` (numpy or Python values; a parameter left out takes the
    factory's default), on ``device`` (None: the GPU)."""
    if family == "lgssm":
        missing = set(LGSSM_PARAMS) - set(params)
        if missing:
            raise ValueError(f"missing LGSSM parameters: {sorted(missing)}")
        model = LinearGaussianSSM(*(np.float32(params[k]) for k in LGSSM_PARAMS))
        return model.to(resolve_device(device))
    if family not in FAMILIES:
        raise ValueError(f"unknown model family {family!r}; known: lgssm, {', '.join(FAMILIES)}")
    factory, names = FAMILIES[family]
    unknown = set(params) - set(names)
    if unknown:
        raise ValueError(f"unknown {family} parameters: {sorted(unknown)}")
    kwargs = {k: int(v) if k in _INTEGER_PARAMS else np.float32(v) for k, v in params.items()}
    return factory(**kwargs).to(resolve_device(device))


def key_from_words(words) -> Key:
    """The :class:`~advancedps_tpu_torch.rng.Key` with the two uint32 words
    that ``jax.random.key_data`` gives."""
    w = np.asarray(words)
    if w.shape != (2,) or not np.issubdtype(w.dtype, np.integer):
        raise ValueError(f"expected two integer key words, got {w!r}")
    return Key(int(w[0]), int(w[1]))


def traced_ssm_from_numpy(params: Mapping[str, object], ys, device=None) -> TracedSSM:
    """A :class:`TracedSSM` of the scalar LGSSM with ``params`` (the names in
    :data:`LGSSM_PARAMS`) and observations ``ys``, on ``device`` (None: the
    GPU).  For another family: ``TracedSSM(model_from_numpy(family, params,
    device), ys)``."""
    device = resolve_device(device)
    model = model_from_numpy("lgssm", params, device)
    return TracedSSM(model, np.array(ys, dtype=np.float32)).to(device)
