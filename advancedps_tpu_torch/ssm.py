"""State-space-model DSL (PyTorch port of ``advancedps_tpu/ssm.py``).

A model is ``StateSpaceModel(prior, dynamics, observation)``.  Each component is
an ``nn.Module`` whose parameters are registered buffers, so ``.to(device)``
moves the whole model; its ``distribution`` methods build
:mod:`advancedps_tpu_torch.distributions` objects.  Steps are 0-based.

Components come in two kinds, as in the JAX package:

* ``vectorized = True``: ``distribution(step, x_batch)`` broadcasts over a
  batch of states, and the sweep draws all particles in one counted pass.
* ``vectorized = False``: the component is written for one particle, and the
  sweep runs it for every particle under :func:`torch.func.vmap`, each with its
  own key (``sample(key, ...)``).  Such code must be vmap-safe: no ``.item()``
  or other host read, no Python branch on a tensor's value, no in-place write
  to a tensor it did not make.

Non-Markovian dynamics (``needs_history = True``) receive a :class:`History`,
the particle's whole trajectory buffer, as the third argument of
``distribution``; the sweep carries it beside the state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from . import random as rnd
from .rng import Key

__all__ = [
    "StatePrior",
    "LatentDynamics",
    "ObservationProcess",
    "StateSpaceModel",
    "TracedSSM",
    "History",
    "simulate",
]


class StatePrior(nn.Module):
    """Initial-state distribution.  Subclass and implement ``distribution(self)``.

    ``vectorized = True`` declares that one batched positional draw samples all
    particles (the sweep's fast path)."""

    vectorized: bool = False

    def distribution(self):
        raise NotImplementedError

    def sample(self, key):
        return self.distribution().sample(key)

    def log_prob(self, x):
        return self.distribution().log_prob(x)


class LatentDynamics(nn.Module):
    """Transition kernel ``x_t | x_{t-1}``: implement ``distribution(self, step,
    state)``, or with ``needs_history = True`` ``distribution(self, step,
    state, history)``.

    ``vectorized = True`` declares that ``distribution`` broadcasts over a
    batch of states (and of histories).  A component that cannot say what its
    law is (a random jump path) overrides :meth:`sample` and :meth:`log_prob`
    instead."""

    needs_history: bool = False
    vectorized: bool = False

    def distribution(self, step, state, history=None):
        raise NotImplementedError

    def sample(self, key, step, state, history=None):
        return self._dist(step, state, history).sample(key)

    def log_prob(self, step, state, x, history=None):
        return self._dist(step, state, history).log_prob(x)

    def _dist(self, step, state, history):
        if self.needs_history:
            return self.distribution(step, state, history)
        return self.distribution(step, state)


class ObservationProcess(nn.Module):
    """Observation kernel ``y_t | x_t``: implement ``distribution(self, step, state)``."""

    vectorized: bool = False

    def distribution(self, step, state):
        raise NotImplementedError

    def sample(self, key, step, state):
        return self.distribution(step, state).sample(key)

    def log_prob(self, step, state, y):
        return self.distribution(step, state).log_prob(y)


@dataclass
class History:
    """The padded trajectory handed to non-Markovian dynamics: ``states``
    ``[T, ...]`` (``[N, T, ...]`` for a batch of particles), rows from
    ``length`` on undefined (zeros); ``length`` the number of valid steps.
    Dynamics mask on ``length`` (the step), so every step has the same
    shapes."""

    states: torch.Tensor
    length: Any


class StateSpaceModel(nn.Module):
    """Bundle of (prior, dynamics, observation)."""

    def __init__(self, prior: StatePrior, dynamics: LatentDynamics,
                 observation: ObservationProcess):
        super().__init__()
        self.prior = prior
        self.dynamics = dynamics
        self.observation = observation

    @property
    def markov(self) -> bool:
        return not getattr(self.dynamics, "needs_history", False)


class TracedSSM(nn.Module):
    """A state-space model paired with an observation sequence ``[T, ...]``
    (a buffer, so ``.to(device)`` moves it with the model)."""

    def __init__(self, model: StateSpaceModel, observations):
        super().__init__()
        self.model = model
        self.register_buffer(
            "observations", torch.as_tensor(observations, dtype=torch.float32)
        )

    @property
    def num_steps(self) -> int:
        return self.observations.shape[0]

    @property
    def prior(self):
        return self.model.prior

    @property
    def dynamics(self):
        return self.model.dynamics

    @property
    def observation(self):
        return self.model.observation


def _simulate_keys(key: Key, model: StateSpaceModel, num_steps: int):
    """JAX's ``simulate``: the same splits, so the same draws."""
    k_init, k_scan = rnd.split(key)
    kx0, ky0 = rnd.split(k_init)
    x = model.prior.sample(kx0)
    xs, ys = [x], [model.observation.sample(ky0, 0, x)]
    buf = None
    if not model.markov:
        buf = torch.zeros((num_steps,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        buf[0] = x
    for t, k in zip(range(1, num_steps), rnd.split(k_scan, num_steps - 1)):
        kx, ky = rnd.split(k)
        if buf is None:
            x = model.dynamics.sample(kx, t, x)
        else:
            x = model.dynamics.sample(kx, t, x, History(buf, t))
            buf[t] = x
        xs.append(x)
        ys.append(model.observation.sample(ky, t, x))
    return xs, ys


def _simulate_generator(generator: torch.Generator, model: StateSpaceModel, num_steps: int):
    """Draws through each component's law with ``torch.randn``."""
    x = model.prior.distribution().sample_generator(generator)
    xs, ys = [x], [model.observation.distribution(0, x).sample_generator(generator)]
    buf = None
    if not model.markov:
        buf = torch.zeros((num_steps,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        buf[0] = x
    for t in range(1, num_steps):
        hist = None if buf is None else History(buf, t)
        x = model.dynamics._dist(t, x, hist).sample_generator(generator)
        if buf is not None:
            buf[t] = x
        xs.append(x)
        ys.append(model.observation.distribution(t, x).sample_generator(generator))
    return xs, ys


@torch.no_grad()
def simulate(key, model: StateSpaceModel, num_steps: int):
    """Draw one latent/observation trajectory of length ``num_steps``.
    Returns ``(xs, ys)`` with a leading time axis, on the model's device.

    ``key`` a :class:`~advancedps_tpu_torch.rng.Key`: the draws of the JAX
    package's ``simulate`` with the same key words (its splits, each
    component's ``sample``; non-Markov dynamics get the history buffer).  A
    ``torch.Generator``: draws by ``torch.randn`` through each component's
    ``distribution`` (its ``sample_generator``), a different stream; a
    component that has no law to draw from (the Lévy dynamics) needs a key."""
    if isinstance(key, torch.Generator):
        xs, ys = _simulate_generator(key, model, num_steps)
    else:
        xs, ys = _simulate_keys(key, model, num_steps)
    return torch.stack(xs), torch.stack(ys)
