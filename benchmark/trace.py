"""The reduction of a ``torch.profiler`` window to what the per-layer metrics
read: the device's records, the host's runtime calls and operators, the
device's busy time (the union of its records), the costliest device
operations and the longest idle gaps named by the host operator that overlaps
each most.  The arithmetic of ``advancedps_tpu_torch.profiling`` (the union,
the top operations, the gaps by host operator), copied here so that the
yardstick does not move with the program."""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field

#: Kineto drops device records whose converted timestamps fall outside the
#: window, so the window stays open this long before and after the work.
PAD_S = 0.02
#: Runtime and driver calls that launch a kernel.
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")
#: Runtime calls that make the host wait for the device.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D", "cuStreamSynchronize", "cuCtxSynchronize")
TOP = 10


@dataclass
class Window:
    """One traced window: spans in microseconds on the profiler's clock."""

    wall_s: float
    device: list = field(default_factory=list)  # (name, start, end): kernels, copies, sets
    runtime: list = field(default_factory=list)  # (name, start, end): cuda* / cu* calls
    host: list = field(default_factory=list)  # (name, start, end): host operators

    @property
    def kernels(self):
        return [d for d in self.device if not d[0].startswith(("Memcpy", "Memset"))]

    @property
    def busy_s(self) -> float:
        return union_us((a, b) for _, a, b in self.device) / 1e6

    @property
    def launches(self) -> int:
        return sum(1 for name, _, _ in self.runtime if name.startswith(LAUNCH_PREFIXES))

    @property
    def syncs(self) -> int:
        return sum(1 for name, _, _ in self.runtime if name in SYNC_CALLS)


def union_us(spans) -> float:
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def from_profile(prof, wall_s: float) -> Window:
    """The window's records, from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    w = Window(wall_s=wall_s)
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                w.device.append(span)
        elif e.name.startswith(("cuda", "cu")) and not e.name.startswith("cudnn"):
            w.runtime.append(span)
        else:
            w.host.append(span)
    return w


def top_ops(w: Window, k: int = TOP):
    """The ``k`` device operations of most summed time: ``[[name, seconds]]``."""
    t = Counter()
    for name, a, b in w.device:
        t[name] += (b - a) / 1e6
    return [[name, s] for name, s in t.most_common(k)]


def idle_gaps(w: Window, k: int = TOP):
    """The ``k`` longest gaps between device records, each named by the host
    operator or runtime call that overlaps it most (the innermost of equal
    overlap; ``"python"`` where none does): ``[[name, seconds]]``."""
    gaps, end = [], None
    for a, b in sorted((a, b) for _, a, b in w.device):
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    ops = sorted(w.host + w.runtime, key=lambda e: e[1])
    starts = [e[1] for e in ops]
    out = []
    for length, a, b in sorted(gaps, reverse=True)[:k]:
        best, best_key = "python", (0.0, 0.0)
        for name, s, f in ops[:_bisect(starts, b)]:
            ov = min(b, f) - max(a, s)
            key = (ov, -(f - s))
            if ov > 0 and key > best_key:
                best, best_key = name, key
        out.append([best, length / 1e6])
    return out


def _bisect(starts, x) -> int:
    lo, hi = 0, len(starts)
    while lo < hi:
        mid = (lo + hi) // 2
        if starts[mid] < x:
            lo = mid + 1
        else:
            hi = mid
    return lo
