"""Faults planted in the program's timed path, for the tests that see
``correct`` come out false and for ``benchmark.calibrate --fault``.

Each takes ``patch(obj, name, value)`` (pytest's ``monkeypatch.setattr``, or
a plain ``setattr`` in a process that ends after the reading) and breaks one
thing a cell can get wrong."""

from __future__ import annotations

import torch

from advancedps_tpu_torch import inference
from advancedps_tpu_torch._tree import tree_flatten, tree_unflatten
from advancedps_tpu_torch.ops import resample as ops
from advancedps_tpu_torch.smc import SSMKernel

#: The engine's decode-and-move entries, with the axis of their particles.
_MOVES = (("resample_move_f", 0), ("resample_move_f_chains", 1))


def state_unchanged(patch):
    """A step that returns its state unchanged (and scores it)."""
    def step(self, t, rng, state, ref_t, ref_mask):
        x = state if self._markov else state[0]
        return state, self._obs_logw(t, x)
    patch(SSMKernel, "step", step)


def half_batch(patch):
    """Half of the batch left out: its weights -inf from the start."""
    init = SSMKernel.init

    def half(self, rng, ref0, ref_mask):
        state, logw = init(self, rng, ref0, ref_mask)
        n = logw.shape[-1]
        return state, torch.cat([logw[..., : n // 2],
                                 torch.full_like(logw[..., n // 2:], -float("inf"))], -1)
    patch(SSMKernel, "init", half)


def answer_altered(patch):
    """The answer altered where it is produced: log Z plus 1."""
    sweep = inference.sweep

    def altered(*args, **kwargs):
        res = sweep(*args, **kwargs)
        res.log_evidence = res.log_evidence + 1.0
        return res
    patch(inference, "sweep", altered)


def _moved_by(fix):
    """Patch both move entries so that ``fix(state, moved, axis)`` replaces
    their moved state."""
    def plant(patch):
        for name, axis in _MOVES:
            def move(f, state, *args, _orig=getattr(ops, name), _axis=axis, **kwargs):
                anc, moved = _orig(f, state, *args, **kwargs)
                return anc, fix(state, moved, _axis)
            patch(ops, name, move)
    return plant


def _last_leaf_kept(state, moved, axis):
    old, _ = tree_flatten(state)
    new, structure = tree_flatten(moved)
    return tree_unflatten(structure, new[:-1] + old[-1:])


def _rolled(state, moved, axis):
    new, structure = tree_flatten(moved)
    return tree_unflatten(structure, [torch.roll(v, 1, axis) for v in new])


#: The resampling's move leaves the state's last leaf as it was: the
#: GP-SSM's history, the whole state of a one-leaf model.
leaf_unmoved = _moved_by(_last_leaf_kept)
#: A wrong ancestor table: every slot takes its neighbour's row.
ancestors_shifted = _moved_by(_rolled)

FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered, "leaf_unmoved": leaf_unmoved,
          "ancestors_shifted": ancestors_shifted}
