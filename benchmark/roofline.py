"""Kernel rooflines from the traced window.

A kernel of the program is a device record whose name lies in the top-level
anonymous namespace of its CUDA sources (``void (anonymous namespace)::f<...>``);
PyTorch's and its libraries' kernels are all the others.  Each file of
``kernels/`` names one such kernel, its layer, and ``work(run)``: the bytes,
int32 operations and float32 FLOPs one launch of it needs in the run's cell.
A launch's bound is the longest of those at the card's peaks
(``peaks.json``); a layer's share is the bounds of its launches found in the
window over their device time.  Launches are counted as found, so a record
that the profiler lost takes its bound with it."""

from __future__ import annotations

import re

from benchmark import manifest

_PORT = re.compile(r"^(?:void )?\(anonymous namespace\)::([A-Za-z_][A-Za-z0-9_]*)")


def port_kernel(name: str):
    """The program's kernel function a device record runs, or None."""
    m = _PORT.match(name)
    return m.group(1) if m else None


def bound_s(work: dict, peaks: dict) -> float:
    return max(work.get("bytes", 0) / peaks["hbm_bytes_per_s"],
               work.get("flops", 0) / peaks["fp32_flops_per_s"],
               work.get("int_ops", 0) / peaks["int32_ops_per_s"])


def layer_share(run, layer: str):
    """100 x summed bound over summed device time of the layer's kernels in
    the window; None where none ran."""
    files = {k.NAME: k for k in manifest.kernels(run.cell.root) if k.LAYER == layer}
    peaks = manifest.peaks()
    bound = time = 0.0
    for name, a, b in run.window.kernels:
        k = files.get(port_kernel(name))
        if k is not None:
            bound += bound_s(k.work(run), peaks)
            time += (b - a) / 1e6
    return 100.0 * bound / time if time > 0 else None
