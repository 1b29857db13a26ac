"""Where an entry point runs when the caller names no device.

Every entry point of the package that takes a ``device`` defaults to
``None``, which means the GPU: ``torch.device("cuda")``.  Without a CUDA
device such a call raises; it never carries on on the CPU.  The CPU is for
callers that ask for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"`` and raises
    where there is no CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: advancedps_tpu_torch runs on the GPU unless the "
            "caller passes device='cpu'"
        )
    return torch.device("cuda")
