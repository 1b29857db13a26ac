"""State-space-model DSL (PyTorch port of ``advancedps_tpu/ssm.py``, Markov part).

A model is ``StateSpaceModel(prior, dynamics, observation)``.  Each component is
an ``nn.Module`` whose parameters are registered buffers, so ``.to(device)``
moves the whole model; its ``distribution`` methods build
:mod:`advancedps_tpu_torch.distributions` objects.  Steps are 0-based.

Non-Markovian dynamics (``needs_history``) wait for a later slice of the port.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = [
    "StatePrior",
    "LatentDynamics",
    "ObservationProcess",
    "StateSpaceModel",
    "TracedSSM",
    "simulate",
]


class StatePrior(nn.Module):
    """Initial-state distribution.  Subclass and implement ``distribution(self)``.

    ``vectorized = True`` declares that one batched positional draw samples all
    particles (the sweep's fast path)."""

    vectorized: bool = False

    def distribution(self):
        raise NotImplementedError

    def sample(self, generator: torch.Generator):
        return self.distribution().sample(generator)


class LatentDynamics(nn.Module):
    """Transition kernel ``x_t | x_{t-1}``: implement ``distribution(self, step, state)``.

    ``vectorized = True`` declares that ``distribution(step, x_batch)`` broadcasts
    over a batch of states."""

    needs_history: bool = False
    vectorized: bool = False

    def distribution(self, step, state):
        raise NotImplementedError

    def sample(self, generator: torch.Generator, step, state):
        return self.distribution(step, state).sample(generator)


class ObservationProcess(nn.Module):
    """Observation kernel ``y_t | x_t``: implement ``distribution(self, step, state)``."""

    vectorized: bool = False

    def distribution(self, step, state):
        raise NotImplementedError

    def sample(self, generator: torch.Generator, step, state):
        return self.distribution(step, state).sample(generator)

    def log_prob(self, step, state, y):
        return self.distribution(step, state).log_prob(y)


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


@torch.no_grad()
def simulate(generator: torch.Generator, model: StateSpaceModel, num_steps: int):
    """Draw one latent/observation trajectory of length ``num_steps`` with a
    ``torch.Generator``.  Returns ``(xs, ys)`` with a leading time axis, on the
    model's device.  (The draws differ from the JAX package's: the two
    frameworks' generators are different streams.)"""
    if not model.markov:
        raise NotImplementedError(
            "simulate for non-Markovian dynamics belongs to the models slice of the port"
        )
    x = model.prior.sample(generator)
    xs = [x]
    ys = [model.observation.sample(generator, 0, x)]
    for t in range(1, num_steps):
        x = model.dynamics.sample(generator, t, x)
        xs.append(x)
        ys.append(model.observation.sample(generator, t, x))
    return torch.stack(xs), torch.stack(ys)
