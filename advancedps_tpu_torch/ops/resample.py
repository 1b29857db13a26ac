"""Resampling kernels: the counterpart of ``advancedps_tpu/ops/pallas_resample.py``.

Systematic resampling is three functions per firing:

* B1 :func:`extents_from_logw` — log-weights to nondecreasing int32 extents
  ``f_j = clip(ceil(n·cumsum(exp(logw − m))/s1 − u), 0, n)``;
* B2 :func:`decode_ancestors` — extents to ancestors
  ``anc[k] = #{j : f_j ≤ start + k}`` over an output window;
* B3 :func:`move_rows` — particle rows moved by ancestor, bitwise, with
  slots past the drawn population set to 0.

Two more kernels compute the same decode in other forms:

* B4 :func:`decode_move` — B2 and B3 in one launch over an output window,
  each block decoding its slots as B2's does and moving their rows from
  registers; what the sweep runs after B1; and its form over a list of
  leaves, :func:`decode_move_leaves`, one decode for up to
  :data:`MAX_LEAVES` arrays of rows;
* B5 :func:`decode_ancestors_dense` — B2 by counting, with no search: a
  scatter of the run ends and one single-pass max-scan.

Stratified and multinomial resampling reach the decode through extents built
from two more primitives:

* B6 :func:`scaled_prefix_from_logw` and :func:`prefix_sum` — the float32
  scaled prefix ``(Σ_{i≤j} e_i)·scale`` with ``e = exp(x − m)`` or ``x``,
  bitwise nondecreasing;
* B7 :func:`count_le_sorted_bs` and B8 :func:`count_le_sorted` — the sorted
  merge-count ``out[j] = #{k : s_k ≤ t_j}``, by a search per tile of
  thresholds and by merge path; :func:`count_le_sorted_auto` picks one
  (:data:`COUNT_LE_SORTED`).

Independent chains run as a batch along a leading chain axis (``[C, N]``
log-weights, ``[C, N, ...]`` rows), and every kernel has a form for it, one
launch (two for B5) for all C chains, row ``c`` bitwise the one-chain kernel
on that row: :func:`extents_from_logw_chains` (B1),
:func:`decode_ancestors_chains` (B2), :func:`move_rows_chains` (B3),
:func:`decode_move_chains` and :func:`decode_move_leaves_chains` (B4),
:func:`decode_ancestors_dense_chains` (B5),
:func:`scaled_prefix_from_logw_chains` and :func:`prefix_sum_chains` (B6),
:func:`count_le_sorted_bs_chains` (B7) and :func:`count_le_sorted_chains` (B8),
picked by :func:`count_le_sorted_auto_chains`.
:func:`resample_move_f_chains` is the batched decode + move under each move
version.  The windowed forms of B2 and B4 serve the sharded exchange, which
runs its chains in turn, and keep one chain.

:func:`resample_move_f` is the decode + move the sweep runs on a firing;
:data:`MOVE_VERSION` picks B4 (1, the default), B2 + B3 (6) or B5 + a gather
(0), as the JAX package's ``APS_MOVE_VERSION`` does.  :func:`resample_move_window_fext`
and :func:`resample_move_window` decode and move one output window, as the
sharded exchange does.  All of them take the state as one tensor or as a
tree of tensors (:mod:`advancedps_tpu_torch._tree`): one decode a firing,
the float32 and int32 leaves moved by the kernels as 32-bit words (so
bitwise), any other leaf gathered by the clipped ancestors.
:func:`move_by_ancestors` moves a tensor or a tree by ancestors already drawn
(version 6's after B2, the residual scheme's, a user resampler's) the same
way, B3 for the 32-bit leaves, for one chain or C.

Each wrapper takes its plain PyTorch version (``*_ref``, beside it) only when
its tensors lie on the CPU.  On a CUDA tensor it launches the hand-written
kernel from ``csrc/resample.cu`` (built at first use by :mod:`._build`) or
raises; nothing falls back.  Each wrapper counts its kernel launches in its
``launches`` attribute.  The kernels' design notes are in the CUDA source.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .._tree import is_tree, tree_flatten, tree_unflatten

__all__ = [
    "extents_from_logw",
    "extents_from_logw_ref",
    "extents_from_logw_chains",
    "extents_from_logw_chains_ref",
    "scaled_prefix_from_logw_chains",
    "prefix_sum_chains",
    "scaled_prefix_chains_ref",
    "decode_move_chains",
    "decode_move_chains_ref",
    "decode_move_leaves_chains",
    "decode_move_leaves_chains_ref",
    "decode_ancestors_chains",
    "decode_ancestors_chains_ref",
    "move_rows_chains",
    "resample_move_chains_ref",
    "decode_ancestors_dense_chains",
    "decode_ancestors_dense_chains_ref",
    "count_le_sorted_bs_chains",
    "count_le_sorted_chains",
    "count_le_sorted_chains_ref",
    "count_le_sorted_auto_chains",
    "resample_move_f_chains",
    "MAX_CHAINS",
    "extents_from_prefix",
    "decode_ancestors",
    "decode_ancestors_ref",
    "decode_ancestors_dense",
    "decode_ancestors_dense_ref",
    "move_rows",
    "move_by_ancestors",
    "resample_move_ref",
    "decode_move",
    "decode_move_ref",
    "decode_move_leaves",
    "decode_move_leaves_ref",
    "scaled_prefix_from_logw",
    "prefix_sum",
    "scaled_prefix_ref",
    "count_le_sorted_bs",
    "count_le_sorted",
    "count_le_sorted_ref",
    "count_le_sorted_auto",
    "COUNT_TILE",
    "COUNT_STAGE",
    "MERGE_TILE",
    "DECODE_TILE",
    "DECODE_STAGE",
    "DECODE_MOVE_TILE",
    "DENSE_TILE",
    "PREFIX_TILE",
    "PREFIX_GROUP",
    "resample_move_f",
    "resample_move",
    "resample_move_window",
    "resample_move_window_fext",
    "systematic_decode",
    "COUNT_LE_SORTED",
    "MOVE_VERSION",
    "MAX_DECODE_MOVE_D",
    "MAX_LEAVES",
    "WORD_DTYPES",
    "KERNEL_WRAPPERS",
    "reset_launch_counts",
]

#: Extents are computed in float32; larger counts are not exact there.
MAX_N = 1 << 24

#: Chains one launch of a kernel with the chain axis takes (the grid's second
#: axis; a scan's rows).
MAX_CHAINS = 65535

#: B4 counts the words of one block's rows in an int32.
MAX_DECODE_MOVE_D = 1 << 19

#: Leaves one launch of :func:`decode_move_leaves` moves (``aps_max_leaves``).
MAX_LEAVES = 8

#: Row types the moves copy as 32-bit words: bitwise, whatever the bits.
WORD_DTYPES = (torch.float32, torch.int32)

#: Which merge-count :func:`count_le_sorted_auto` runs: ``"bs"`` (B7, the
#: search; the default, as in the JAX package) or ``"merge"`` (B8, merge
#: path).  The JAX package chooses by the ``APS_DECODE`` environment variable;
#: here it is set in code.
COUNT_LE_SORTED = "bs"

#: The geometry of B7 and B8, for tests to build their cases around:
#: thresholds per B7 block, entries of ``s`` a B7 block stages in shared
#: memory, merged entries per B8 block.  The kernels' own values are in
#: ``csrc/resample.cu`` (``aps_count_le_geometry`` reads them back).
COUNT_TILE = 1024
COUNT_STAGE = 4096
MERGE_TILE = 4096

#: The geometry of B2: output slots per block, and owner extents a block
#: stages in shared memory (a longer owner run is searched in global memory).
#: ``aps_decode_geometry`` reads the kernel's own values back.
DECODE_TILE = 1024
DECODE_STAGE = 4096

#: The geometry of B4 and B5: output slots per B4 block (it stages
#: :data:`DECODE_STAGE` owner extents, as B2 does) and slots per tile of B5's
#: scan (``aps_decode_geometry`` 2 and 3).
DECODE_MOVE_TILE = 1024
DENSE_TILE = 2048

#: The geometry of the scan of B1 and B6: elements per tile
#: (``aps_prefix_tile_size``), and tiles per group of the cross-tile
#: combination (a group's total stands one level up, for 32 groups in turn).
PREFIX_TILE = 2048
PREFIX_GROUP = 32

#: Which decode + move :func:`resample_move_f` runs: ``1`` (B4, one launch;
#: the default), ``6`` (B2 then B3, the JAX package's default) or ``0`` (B5,
#: then a gather).  All three give the same sweep bit for bit; on an NVIDIA
#: H100 80GB HBM3 at a 700 W power limit one firing's decode + move at 1M takes
#: 6.8 us of device time under 1, 11.1 under 6 and 20-22 under 0
#: (``chip_smoke.py`` phase 7 reads the three in turns).
#: The JAX package chooses by the ``APS_MOVE_VERSION`` environment variable;
#: here it is set in code.  Windowed calls run version 1 for version 0.
MOVE_VERSION = 1
_MOVE_VERSIONS = (0, 1, 6)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def extents_from_prefix(prefix, s1, u: float, n: int) -> torch.Tensor:
    """B1's epilogue on a prefix (float64, or float32 with ``s1 = 1``):
    ``clip(ceil(n·(fl32(prefix)·(1/s1)) − u), 0, n)`` as int32, each operation
    rounded to float32 on its own (not yet made nondecreasing)."""
    cdf = prefix.to(torch.float32) * (1.0 / s1)
    return torch.clamp(torch.ceil(n * cdf - u), 0, n).to(torch.int32)


def extents_from_logw_ref(logw, m, s1, u: float, n: int) -> torch.Tensor:
    """``cummax`` of :func:`extents_from_prefix` with ``prefix =
    cumsum(exp(logw − m))`` summed in float64."""
    prefix = torch.cumsum(torch.exp(logw - m), 0, dtype=torch.float64)
    return torch.cummax(extents_from_prefix(prefix, s1, u, n), 0).values


def _guard_of(n_out: int, guard: Optional[int], start: int) -> int:
    """The value read for ``f[M−1]``: ``guard``, or ``n_out`` for a decode of
    the whole population.  A window must name the drawn count itself."""
    if guard is not None:
        return int(guard)
    if start:
        raise ValueError("a windowed decode reads f[M-1] as the drawn count: pass guard=n")
    return n_out


def _guarded(f, guard: int):
    """``f`` with its last extent (each row's, for ``[C, M]``) set to ``guard``."""
    return torch.cat([f[..., :-1], torch.full_like(f[..., -1:], guard)], dim=-1)


def decode_ancestors_ref(f, n_out: int, guard: Optional[int] = None,
                         start: int = 0) -> torch.Tensor:
    """``searchsorted(f, arange(start, start + n_out), right=True)`` with
    ``f[-1]`` read as ``guard`` (see :func:`decode_ancestors`); ``f`` itself
    is not written."""
    k = torch.arange(start, start + n_out, dtype=f.dtype, device=f.device)
    g = _guarded(f, _guard_of(n_out, guard, start))
    return torch.searchsorted(g, k, right=True).to(torch.int32)


def decode_ancestors_dense_ref(f, n_out: int, guard: Optional[int] = None) -> torch.Tensor:
    """B5's counting form: ``j + 1`` scattered at ``f_j`` for the last row
    ``j`` of each run of equal extents (``f_j < n_out``), then ``cummax``."""
    g = _guarded(f, _guard_of(n_out, guard, 0))
    run_end = torch.ones_like(g, dtype=torch.bool)
    run_end[:-1] = g[:-1] < g[1:]
    keep = run_end & (g >= 0) & (g < n_out)
    rows = torch.arange(1, g.numel() + 1, dtype=torch.int32, device=f.device)
    buf = torch.zeros(n_out, dtype=torch.int32, device=f.device)
    buf[g[keep].long()] = rows[keep]
    return torch.cummax(buf, 0).values


def resample_move_ref(anc, v):
    """``(min(anc, M−1), v[anc])`` with rows of slots where ``anc == M`` set to 0."""
    m = v.shape[0]
    anc_clipped = torch.clamp(anc, max=m - 1)
    moved = v[anc_clipped.long()]
    past = (anc >= m).reshape((-1,) + (1,) * (v.dim() - 1))
    moved = torch.where(past, torch.zeros((), dtype=v.dtype, device=v.device), moved)
    return anc_clipped, moved


def decode_move_ref(f, v, n_out: int, guard: Optional[int] = None, start: int = 0):
    """:func:`decode_ancestors_ref` then :func:`resample_move_ref`."""
    return resample_move_ref(decode_ancestors_ref(f, n_out, guard, start), v)


def decode_move_leaves_ref(f, leaves, n_out: int, guard: Optional[int] = None,
                           start: int = 0):
    """:func:`decode_ancestors_ref` once, then :func:`resample_move_ref` of
    each leaf: ``(anc clipped to M−1, [moved leaf, ...])``."""
    anc = decode_ancestors_ref(f, n_out, guard, start)
    moved = [resample_move_ref(anc, v)[1] for v in leaves]
    return torch.clamp(anc, max=f.numel() - 1), moved


def scaled_prefix_ref(x, m, scale, use_exp: bool) -> torch.Tensor:
    """``cummax(fl32(cumsum(e)) · scale)`` with ``e = exp(x − m)`` (float32)
    or ``x``, the prefix summed in float64 and rounded once; ``scale`` None
    means 1.  For nonnegative summands the running max changes nothing."""
    e = torch.exp(x - m) if use_exp else x
    p = torch.cumsum(e, 0, dtype=torch.float64).to(torch.float32)
    if scale is not None:
        p = p * scale
    return torch.cummax(p, 0).values


def extents_from_logw_chains_ref(logw, m, s1, u, n: int) -> torch.Tensor:
    """:func:`extents_from_logw_ref` row by row: ``logw [C, N]``, ``m``,
    ``s1`` and ``u`` float32 ``[C]``."""
    prefix = torch.cumsum(torch.exp(logw - m[:, None]), -1, dtype=torch.float64)
    return torch.cummax(extents_from_prefix(prefix, s1[:, None], u[:, None], n), -1).values


def scaled_prefix_chains_ref(x, m, scale, use_exp: bool) -> torch.Tensor:
    """:func:`scaled_prefix_ref` row by row: ``x [C, N]``, ``m`` and
    ``scale`` float32 ``[C]`` (or None)."""
    e = torch.exp(x - m[:, None]) if use_exp else x
    p = torch.cumsum(e, -1, dtype=torch.float64).to(torch.float32)
    if scale is not None:
        p = p * scale[:, None]
    return torch.cummax(p, -1).values


def _rows_of(v, anc):
    """``v[c, anc[c, k]]`` for every chain ``c`` and slot ``k``."""
    return v[torch.arange(v.shape[0], device=v.device)[:, None], anc.long()]


def decode_ancestors_chains_ref(f, n_out: int, guard: Optional[int] = None) -> torch.Tensor:
    """:func:`decode_ancestors_ref` row by row: ``f [C, M]``, every row's
    ``f[c, M−1]`` read as the one ``guard``; int32 ``[C, n_out]``."""
    fg = _guarded(f, _guard_of(n_out, guard, 0))
    k = torch.arange(n_out, dtype=f.dtype, device=f.device).expand(f.shape[0], n_out)
    return torch.searchsorted(fg, k.contiguous(), right=True).to(torch.int32)


def decode_ancestors_dense_chains_ref(f, n_out: int, guard: Optional[int] = None) -> torch.Tensor:
    """:func:`decode_ancestors_dense_ref` row by row: each row's run ends
    scattered into its own row of marks, then ``cummax`` along the row."""
    g = _guarded(f, _guard_of(n_out, guard, 0))
    run_end = torch.ones_like(g, dtype=torch.bool)
    run_end[:, :-1] = g[:, :-1] < g[:, 1:]
    chain, row = (run_end & (g >= 0) & (g < n_out)).nonzero(as_tuple=True)
    buf = torch.zeros((f.shape[0], n_out), dtype=torch.int32, device=f.device)
    buf[chain, g[chain, row].long()] = (row + 1).to(torch.int32)
    return torch.cummax(buf, 1).values


def resample_move_chains_ref(anc, v):
    """:func:`resample_move_ref` row by row: ``anc [C, n]``, ``v [C, M, ...]``."""
    m = v.shape[1]
    clipped = torch.clamp(anc, max=m - 1)
    past = (anc >= m).reshape(anc.shape + (1,) * (v.dim() - 2))
    return clipped, torch.where(past, torch.zeros((), dtype=v.dtype, device=v.device),
                                _rows_of(v, clipped))


def decode_move_leaves_chains_ref(f, leaves, n_out: int, guard: Optional[int] = None):
    """:func:`decode_move_leaves_ref` row by row: ``f [C, M]``, each leaf
    ``[C, M, ...]``; returns ``(anc [C, n_out] clipped to M−1, [moved leaf
    [C, n_out, ...], ...])``."""
    anc = decode_ancestors_chains_ref(f, n_out, guard)
    moved = [resample_move_chains_ref(anc, v)[1] for v in leaves]
    return torch.clamp(anc, max=f.shape[1] - 1), moved


def decode_move_chains_ref(f, v, n_out: int, guard: Optional[int] = None):
    """:func:`decode_move_ref` row by row: ``f [C, M]``, ``v [C, M, ...]``."""
    anc, (moved,) = decode_move_leaves_chains_ref(f, [v], n_out, guard)
    return anc, moved


def count_le_sorted_ref(s, t) -> torch.Tensor:
    """``#{k : s_k ≤ t_j}`` for each ``t_j``: ``searchsorted(s, t, right=True)``."""
    return torch.searchsorted(s, t, right=True).to(torch.int32)


def count_le_sorted_chains_ref(s, t) -> torch.Tensor:
    """:func:`count_le_sorted_ref` row by row: ``s [C, ns]``, ``t [C, nt]``."""
    return torch.searchsorted(s.contiguous(), t, right=True).to(torch.int32)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, dtype, ndims=(1,)):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() not in ndims:
        raise ValueError(f"{name} must have {' or '.join(map(str, ndims))} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_extents(f, start: int):
    _check(f, "f", torch.int32)
    if f.numel() == 0:
        raise ValueError("f must not be empty")
    if f.numel() >= 1 << 31:
        raise ValueError(f"f must hold fewer than 2**31 extents, got {f.numel()}")
    if start < 0:
        raise ValueError(f"start must be >= 0, got {start}")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA tensors on one device; raises on
    anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, what: str):
    if rc != 0:
        msg = _build.library().aps_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _launch(entry: str, wrapper, device: torch.device, *args):
    """One launch of the C entry ``entry`` with ``args`` and the current
    stream of ``device``, under that device: its error raised in the name of
    ``wrapper``, the launch counted on ``wrapper.launches``."""
    lib = _build.library()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args, _stream(device))
    _raise_on(rc, wrapper.__name__)
    wrapper.launches += 1


#: The scan scratch of B1, B6 and B5 by (device index, stream): [tiles a
#: chain it serves, chains it serves, int64 words, launches so far].  Zero
#: when allocated; from then on only the scans' launches on that stream write
#: it, each under its own epoch:
#: a launch reads a published value only under its own epoch, so B1, B5 and B6
#: in turn on one stream never read each other's, and two streams have a
#: scratch each.
_SCAN_SCRATCH: dict = {}

#: B5's marks by (device index, stream): int32, zero when allocated and zero
#: again after every call (the scan clears each mark it reads).
_DENSE_MARKS: dict = {}


def _scan_scratch(device: torch.device, length: int, chains: int = 1):
    """``(scratch, cap, epoch)`` for one scan of ``chains`` rows of ``length``
    elements on the current stream of ``device``: the scratch (a part of
    ``cap`` tiles for each chain) is grown, and zeroed anew, when a row needs
    more tiles or the launch more chains than it serves, and ``epoch`` is one
    more than that of the launch before."""
    lib = _build.library()
    ntiles = -(-length // lib.aps_prefix_tile_size())
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    entry = _SCAN_SCRATCH.get(key)
    if entry is None or entry[0] < ntiles or entry[1] < chains:
        cap = max(1024, 1 << (ntiles - 1).bit_length(), entry[0] if entry else 0)
        rows = max(chains, entry[1] if entry else 1)
        words = lib.aps_scan_scratch_words(cap) * rows
        entry = [cap, rows, torch.zeros(words, dtype=torch.int64, device=device), 0]
        _SCAN_SCRATCH[key] = entry
    entry[3] += 1
    return entry[2], entry[0], entry[3]


def _dense_marks(device: torch.device, words: int) -> torch.Tensor:
    """B5's zeroed marks, ``words`` int32 words at least (``n_out`` slots,
    or C rows of them), on the current stream of ``device``, grown (and
    zeroed anew) when too short."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    marks = _DENSE_MARKS.get(key)
    if marks is None or marks.numel() < words:
        marks = torch.zeros(max(1 << 20, 1 << (words - 1).bit_length()), dtype=torch.int32,
                            device=device)
        _DENSE_MARKS[key] = marks
    return marks


def extents_from_logw(logw, m, s1, u: float, n: int) -> torch.Tensor:
    """B1: systematic extents straight from unnormalised log-weights.

    ``m`` = max(logw) and ``s1`` = Σ exp(logw − m) are float32 scalars on
    ``logw``'s device (the sweep's reduction already has both); ``u`` is the
    stratum offset and ``n`` the number of positions drawn.  Returns int32
    ``[M]``, nondecreasing bitwise.  The prefix is summed in double and rounded
    to float32 once, as in the plain version; the two may still differ by ±1
    where double rounding straddles a float32 rounding boundary.  One launch:
    each tile of :data:`PREFIX_TILE` elements is read once and takes its base
    from the sums of the tiles before it, combined in a fixed order, so two
    calls give the same bits.
    """
    _check(logw, "logw", torch.float32)
    for name, s in (("m", m), ("s1", s1)):
        _check(s, name, torch.float32, ndims=(0,))
    if not 0 <= n < MAX_N:
        raise ValueError(f"n must be in [0, 2**24), got {n}")
    if _on_cpu(logw, m, s1):
        return extents_from_logw_ref(logw, m, s1, u, n)
    f = torch.empty(logw.shape, dtype=torch.int32, device=logw.device)
    if logw.numel() == 0:
        return f
    scratch, cap, epoch = _scan_scratch(logw.device, logw.numel())
    _launch("aps_extents_from_logw", extents_from_logw, logw.device, _ptr(logw),
            logw.numel(), _ptr(m), _ptr(s1), float(u), int(n), _ptr(scratch), cap, epoch,
            _ptr(f))
    return f


def _check_chain_scalars(c: int, **scalars):
    for name, v in scalars.items():
        _check(v, name, torch.float32)
        if v.shape != (c,):
            raise ValueError(f"{name} must have shape ({c},), got {tuple(v.shape)}")


def extents_from_logw_chains(logw, m, s1, u, n: int) -> torch.Tensor:
    """B1 with the chain axis: ``logw`` float32 ``[C, N]``, and ``m``, ``s1``
    and the offsets ``u`` float32 ``[C]`` on its device.  Returns int32
    ``[C, N]``; row ``c`` is :func:`extents_from_logw` on ``logw[c]`` with
    ``(m[c], s1[c], u[c])``, bit for bit.  One launch: the tiles of all rows
    in one cooperative grid, each row looking back only at its own tiles."""
    _check(logw, "logw", torch.float32, ndims=(2,))
    _check_chain_scalars(logw.shape[0], m=m, s1=s1, u=u)
    if not 0 <= n < MAX_N:
        raise ValueError(f"n must be in [0, 2**24), got {n}")
    if _on_cpu(logw, m, s1, u):
        return extents_from_logw_chains_ref(logw, m, s1, u, n)
    f = torch.empty(logw.shape, dtype=torch.int32, device=logw.device)
    if logw.numel() == 0:
        return f
    c, length = logw.shape
    scratch, cap, epoch = _scan_scratch(logw.device, length, c)
    _launch("aps_extents_from_logw_chains", extents_from_logw_chains, logw.device,
            _ptr(logw), c, length, _ptr(m), _ptr(s1), _ptr(u), int(n), _ptr(scratch), cap,
            epoch, _ptr(f))
    return f


def decode_ancestors(f, n_out: int, guard: Optional[int] = None, start: int = 0) -> torch.Tensor:
    """B2: ``anc[k] = #{j : f_j ≤ start + k}`` for ``k < n_out`` — int32 in
    ``[0, M]``.

    ``f`` is nondecreasing int32 ``[M]``; its last entry is read as ``guard``,
    which covers float undershoot of the last extent and, with a guard below
    the last slot, leaves the slots from ``guard`` on past the drawn
    population (``anc == M``).  The guard is the number of positions drawn:
    ``n_out`` if not given for the whole population (``start == 0``); a
    window (``start > 0``) must pass it.  Each block takes
    :data:`DECODE_TILE` consecutive slots and only the rows that own them
    (staged on chip up to :data:`DECODE_STAGE` rows); exact for every
    nondecreasing ``f``, whatever its skew.
    """
    _check_extents(f, start)
    g = _guard_of(n_out, guard, start)
    if _on_cpu(f):
        return decode_ancestors_ref(f, n_out, g, start)
    anc = torch.empty(n_out, dtype=torch.int32, device=f.device)
    if n_out == 0:
        return anc
    _launch("aps_decode_ancestors", decode_ancestors, f.device, _ptr(f), f.numel(), g,
            int(start), int(n_out), _ptr(anc))
    return anc


def decode_ancestors_dense(f, n_out: int, guard: Optional[int] = None) -> torch.Tensor:
    """B5: the same counts as :func:`decode_ancestors` for the whole
    population, by counting instead of searching: each run of equal extents
    marks its end, and a running max fills the slots between.  ``f`` must be
    nonnegative (extents are).

    Two launches: the run ends are scattered into a zeroed scratch kept per
    device and stream, then one single-pass max-scan over tiles of
    :data:`DENSE_TILE` slots reads the marks, clears them behind itself and
    writes the counts, each tile taking the largest mark of the tiles before
    it through the scan scratch that B1 and B6 use, under this launch's epoch.
    """
    _check_extents(f, 0)
    g = _guard_of(n_out, guard, 0)
    if _on_cpu(f):
        return decode_ancestors_dense_ref(f, n_out, g)
    anc = torch.empty(n_out, dtype=torch.int32, device=f.device)
    if n_out == 0:
        return anc
    marks = _dense_marks(f.device, n_out)
    scratch, cap, epoch = _scan_scratch(f.device, n_out)
    try:
        _launch("aps_decode_ancestors_dense", decode_ancestors_dense, f.device, _ptr(f),
                f.numel(), g, int(n_out), _ptr(marks), _ptr(scratch), cap, epoch, _ptr(anc))
    except RuntimeError:
        _DENSE_MARKS.clear()  # the marks may be left set: the next call takes new ones
        raise
    return anc


def _check_rows(v, m: Optional[int] = None, name: str = "v"):
    _check(v, name, WORD_DTYPES, ndims=(1, 2))
    if v.shape[0] == 0:
        raise ValueError(f"{name} must hold at least one row")
    if m is not None and v.shape[0] != m:
        raise ValueError(f"{name} has {v.shape[0]} rows, f has {m} extents")
    d = 1 if v.dim() == 1 else v.shape[1]
    if not 1 <= d <= MAX_DECODE_MOVE_D:
        raise ValueError(f"{name} must have 1 to {MAX_DECODE_MOVE_D} columns, got {d}")
    return d


def move_rows(anc, v):
    """B3: move particle rows by ancestor.

    ``anc`` int32 ``[n]`` with values in ``[0, M]``; ``v`` float32 or int32
    ``[M]`` or ``[M, D]``, contiguous.  Returns ``(anc clipped to M−1, moved)`` where
    ``moved[k]`` is a bitwise copy of ``v[anc[k]]``, or 0 where
    ``anc[k] == M``.
    """
    _check(anc, "anc", torch.int32)
    _check_rows(v)
    if _on_cpu(anc, v):
        return resample_move_ref(anc, v)
    n_out = anc.shape[0]
    out = torch.empty((n_out,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    anc_clipped = torch.empty_like(anc)
    if n_out == 0:
        return anc_clipped, out
    d = 1 if v.dim() == 1 else v.shape[1]
    _launch("aps_move_rows", move_rows, v.device, _ptr(anc), n_out, v.shape[0], _ptr(v), d,
            _ptr(out), _ptr(anc_clipped))
    return anc_clipped, out


def decode_move(f, v, n_out: int, guard: Optional[int] = None, start: int = 0):
    """B4: :func:`decode_ancestors` and :func:`move_rows` in one launch.

    ``f`` int32 ``[M]`` extents, ``v`` float32 or int32 ``[M]`` or ``[M, D]`` rows;
    decodes the output slots ``[start, start + n_out)`` with ``f[M−1]`` read
    as ``guard`` (as :func:`decode_ancestors`) and returns ``(anc clipped to
    M−1, moved)``, ``moved`` a bitwise copy of the owner rows with 0 past the
    drawn population.  Each block decodes :data:`DECODE_MOVE_TILE` slots by
    the function B2's block runs, so the result is that of B2 then B3 bit
    for bit, and moves the rows of its slots without writing the unclipped
    owners in between.
    """
    _check_extents(f, start)
    d = _check_rows(v, f.numel())
    g = _guard_of(n_out, guard, start)
    if _on_cpu(f, v):
        return decode_move_ref(f, v, n_out, g, start)
    out = torch.empty((n_out,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    anc_clipped = torch.empty(n_out, dtype=torch.int32, device=v.device)
    if n_out == 0:
        return anc_clipped, out
    _launch("aps_decode_move", decode_move, v.device, _ptr(f), f.numel(), g, int(start),
            int(n_out), _ptr(v), d, _ptr(out), _ptr(anc_clipped))
    return anc_clipped, out


def decode_move_leaves(f, leaves, n_out: int, guard: Optional[int] = None, start: int = 0):
    """B4 over a list of leaves: :func:`decode_move`'s decode once, then
    each leaf's rows.

    ``leaves`` a list of float32 or int32 ``[M]`` or ``[M, D_l]`` contiguous
    rows; returns ``(anc clipped to M−1, [moved leaf, ...])``, each moved
    leaf a bitwise copy of its owner rows with 0 past the drawn population,
    as :func:`decode_move` gives it leaf by leaf.  One launch moves up to
    :data:`MAX_LEAVES` leaves; more take further launches, each of which
    decodes the tile again.  (The moves of a tree send a single 32-bit leaf
    to :func:`decode_move` instead.)
    """
    _check_extents(f, start)
    leaves = list(leaves)
    if not leaves:
        raise ValueError("decode_move_leaves needs at least one leaf")
    widths = [_check_rows(v, f.numel(), f"leaf {i}") for i, v in enumerate(leaves)]
    g = _guard_of(n_out, guard, start)
    if _on_cpu(f, *leaves):
        return decode_move_leaves_ref(f, leaves, n_out, g, start)
    outs = [torch.empty((n_out,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
            for v in leaves]
    anc_clipped = torch.empty(n_out, dtype=torch.int32, device=f.device)
    if n_out == 0:
        return anc_clipped, outs
    for part in _leaf_parts(leaves, outs, widths):
        _launch("aps_decode_move_leaves", decode_move_leaves, f.device, _ptr(f), f.numel(),
                g, int(start), int(n_out), *part, _ptr(anc_clipped))
    return anc_clipped, outs


def _leaf_parts(leaves, outs, widths):
    """The arguments of B4's launches over leaves, one for each
    :data:`MAX_LEAVES` of them: their count, and the arrays of their rows'
    pointers, their outputs' pointers and their widths."""
    for lo in range(0, len(leaves), MAX_LEAVES):
        part = range(lo, min(lo + MAX_LEAVES, len(leaves)))
        vs = (ctypes.c_void_p * len(part))(*(leaves[i].data_ptr() for i in part))
        os_ = (ctypes.c_void_p * len(part))(*(outs[i].data_ptr() for i in part))
        ds = (ctypes.c_int64 * len(part))(*(widths[i] for i in part))
        yield (len(part), ctypes.cast(vs, ctypes.c_void_p),
               ctypes.cast(os_, ctypes.c_void_p), ctypes.cast(ds, ctypes.c_void_p))


def _check_chain_rows(f, leaves):
    _check(f, "f", torch.int32, ndims=(2,))
    c, m = f.shape
    if m == 0:
        raise ValueError("f must not be empty")
    if m >= 1 << 31:
        raise ValueError(f"f must hold fewer than 2**31 extents a chain, got {m}")
    if not 1 <= c <= MAX_CHAINS:
        raise ValueError(f"f must have 1 to {MAX_CHAINS} chains, got {c}")
    widths = []
    for i, v in enumerate(leaves):
        name = f"leaf {i}"
        _check(v, name, WORD_DTYPES, ndims=(2, 3))
        if tuple(v.shape[:2]) != (c, m):
            raise ValueError(f"{name} has shape {tuple(v.shape)}, f has {(c, m)}")
        d = 1 if v.dim() == 2 else v.shape[2]
        if not 1 <= d <= MAX_DECODE_MOVE_D:
            raise ValueError(f"{name} must have 1 to {MAX_DECODE_MOVE_D} columns, got {d}")
        widths.append(d)
    return widths


def decode_move_chains(f, v, n_out: int, guard: Optional[int] = None):
    """B4 with the chain axis: ``f`` int32 ``[C, M]`` extents, ``v`` float32
    or int32 ``[C, M]`` or ``[C, M, D]`` rows; returns ``(anc [C, n_out]
    clipped to M−1, moved [C, n_out, ...])``, chain ``c`` bitwise
    :func:`decode_move` of row ``c`` with the same ``guard`` (``n_out`` if not
    given).  One launch, the chain on the grid's second axis."""
    (d,) = _check_chain_rows(f, [v])
    g = _guard_of(n_out, guard, 0)
    if _on_cpu(f, v):
        return decode_move_chains_ref(f, v, n_out, g)
    c, m = f.shape
    out = torch.empty((c, n_out) + tuple(v.shape[2:]), dtype=v.dtype, device=v.device)
    anc_clipped = torch.empty((c, n_out), dtype=torch.int32, device=v.device)
    if n_out == 0:
        return anc_clipped, out
    _launch("aps_decode_move_chains", decode_move_chains, v.device, _ptr(f), c, m, g, 0,
            int(n_out), _ptr(v), d, _ptr(out), _ptr(anc_clipped))
    return anc_clipped, out


def decode_move_leaves_chains(f, leaves, n_out: int, guard: Optional[int] = None):
    """B4 over leaves with the chain axis: ``f`` int32 ``[C, M]``, each leaf
    float32 or int32 ``[C, M]`` or ``[C, M, D_l]``; returns ``(anc [C, n_out]
    clipped to M−1, [moved leaf, ...])``, chain ``c`` bitwise
    :func:`decode_move_leaves` of row ``c``.  One launch per
    :data:`MAX_LEAVES` leaves."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("decode_move_leaves_chains needs at least one leaf")
    widths = _check_chain_rows(f, leaves)
    g = _guard_of(n_out, guard, 0)
    if _on_cpu(f, *leaves):
        return decode_move_leaves_chains_ref(f, leaves, n_out, g)
    c, m = f.shape
    outs = [torch.empty((c, n_out) + tuple(v.shape[2:]), dtype=v.dtype, device=v.device)
            for v in leaves]
    anc_clipped = torch.empty((c, n_out), dtype=torch.int32, device=f.device)
    if n_out == 0:
        return anc_clipped, outs
    for part in _leaf_parts(leaves, outs, widths):
        _launch("aps_decode_move_leaves_chains", decode_move_leaves_chains, f.device,
                _ptr(f), c, m, g, 0, int(n_out), *part, _ptr(anc_clipped))
    return anc_clipped, outs


def decode_ancestors_chains(f, n_out: int, guard: Optional[int] = None) -> torch.Tensor:
    """B2 with the chain axis: ``f`` int32 ``[C, M]`` extents; returns int32
    ``[C, n_out]``, row ``c`` bitwise :func:`decode_ancestors` of ``f[c]``
    with the same ``guard`` (``n_out`` if not given).  One launch, the chain
    on the grid's second axis."""
    _check_chain_rows(f, [])
    g = _guard_of(n_out, guard, 0)
    if _on_cpu(f):
        return decode_ancestors_chains_ref(f, n_out, g)
    c, m = f.shape
    anc = torch.empty((c, n_out), dtype=torch.int32, device=f.device)
    if n_out == 0:
        return anc
    _launch("aps_decode_ancestors_chains", decode_ancestors_chains, f.device, _ptr(f), c, m,
            g, 0, int(n_out), _ptr(anc))
    return anc


def decode_ancestors_dense_chains(f, n_out: int, guard: Optional[int] = None) -> torch.Tensor:
    """B5 with the chain axis: ``f`` int32 ``[C, M]`` nonnegative extents;
    returns int32 ``[C, n_out]``, row ``c`` bitwise
    :func:`decode_ancestors_dense` of ``f[c]`` with the same ``guard``.  Two
    launches for all chains: the scatter, with the chain on the grid's second
    axis, into a row of marks a chain, and one max-scan whose tiles run
    chain-major, each row looking back only at its own tiles; the marks are
    zero again after it."""
    _check_chain_rows(f, [])
    g = _guard_of(n_out, guard, 0)
    if _on_cpu(f):
        return decode_ancestors_dense_chains_ref(f, n_out, g)
    c, m = f.shape
    anc = torch.empty((c, n_out), dtype=torch.int32, device=f.device)
    if n_out == 0:
        return anc
    ldm = -(-n_out // 4) * 4  # rows of marks 16-byte aligned
    marks = _dense_marks(f.device, c * ldm)
    scratch, cap, epoch = _scan_scratch(f.device, n_out, c)
    try:
        _launch("aps_decode_ancestors_dense_chains", decode_ancestors_dense_chains,
                f.device, _ptr(f), c, m, g, int(n_out), _ptr(marks), ldm, _ptr(scratch),
                cap, epoch, _ptr(anc))
    except RuntimeError:
        _DENSE_MARKS.clear()  # the marks may be left set: the next call takes new ones
        raise
    return anc


def move_rows_chains(anc, v):
    """B3 with the chain axis: ``anc`` int32 ``[C, n]`` with values in ``[0,
    M]``, ``v`` float32 or int32 ``[C, M]`` or ``[C, M, D]``; returns ``(anc
    clipped to M−1, moved [C, n, ...])``, chain ``c`` bitwise
    :func:`move_rows` of ``(anc[c], v[c])``.  One launch."""
    _check(anc, "anc", torch.int32, ndims=(2,))
    c, n_out = anc.shape
    if not 1 <= c <= MAX_CHAINS:
        raise ValueError(f"anc must have 1 to {MAX_CHAINS} chains, got {c}")
    _check(v, "v", WORD_DTYPES, ndims=(2, 3))
    if v.shape[0] != c or v.shape[1] == 0:
        raise ValueError(f"v has shape {tuple(v.shape)}: want {c} chains of at least one row")
    d = 1 if v.dim() == 2 else v.shape[2]
    if not 1 <= d <= MAX_DECODE_MOVE_D:
        raise ValueError(f"v must have 1 to {MAX_DECODE_MOVE_D} columns, got {d}")
    if _on_cpu(anc, v):
        return resample_move_chains_ref(anc, v)
    m = v.shape[1]
    out = torch.empty((c, n_out) + tuple(v.shape[2:]), dtype=v.dtype, device=v.device)
    anc_clipped = torch.empty_like(anc)
    if n_out == 0:
        return anc_clipped, out
    _launch("aps_move_rows_chains", move_rows_chains, v.device, _ptr(anc), c, n_out, m,
            _ptr(v), d, _ptr(out), _ptr(anc_clipped))
    return anc_clipped, out


def _scaled_prefix(wrapper, x, m, scale, use_exp: bool) -> torch.Tensor:
    """B6 on ``x``'s device: the plain version on the CPU, else the kernel,
    counted on ``wrapper``."""
    tensors = (x,) + tuple(s for s in (m, scale) if s is not None)
    if _on_cpu(*tensors):
        return scaled_prefix_ref(x, m, scale, use_exp)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    scratch, cap, epoch = _scan_scratch(x.device, x.numel())
    _launch("aps_scaled_prefix", wrapper, x.device, _ptr(x), x.numel(), int(use_exp),
            _ptr(m) if use_exp else None, _ptr(scale) if scale is not None else None,
            _ptr(scratch), cap, epoch, _ptr(out))
    return out


def scaled_prefix_from_logw(logw, m, scale) -> torch.Tensor:
    """B6: ``(Σ_{i≤j} exp(logw_i − m)) · scale`` as float32 ``[M]``, bitwise
    nondecreasing.

    ``m`` (max of ``logw``) and ``scale`` are float32 scalars on ``logw``'s
    device: ``n/s1`` gives stratified's ``c = n·cdf``, ``S_n/s1`` gives
    multinomial's merge thresholds.  The prefix is summed in double and
    rounded to float32 once, then multiplied by ``scale``, as in the plain
    version; the two may differ by an ulp where double rounding straddles a
    float32 rounding boundary.
    """
    _check(logw, "logw", torch.float32)
    for name, s in (("m", m), ("scale", scale)):
        _check(s, name, torch.float32, ndims=(0,))
    return _scaled_prefix(scaled_prefix_from_logw, logw, m, scale, use_exp=True)


def prefix_sum(x) -> torch.Tensor:
    """B6 without the exponential or the scale: the inclusive prefix sum of
    float32 ``x``, summed in double and rounded once, bitwise nondecreasing
    (for inputs with negative entries, the running max of the prefix, as in
    the TPU kernel)."""
    _check(x, "x", torch.float32)
    return _scaled_prefix(prefix_sum, x, None, None, use_exp=False)


def _scaled_prefix_chains(wrapper, x, m, scale, use_exp: bool) -> torch.Tensor:
    """B6 with the chain axis on ``x``'s device, counted on ``wrapper``."""
    _check(x, "x", torch.float32, ndims=(2,))
    given = {k: v for k, v in (("m", m), ("scale", scale)) if v is not None}
    _check_chain_scalars(x.shape[0], **given)
    if _on_cpu(x, *given.values()):
        return scaled_prefix_chains_ref(x, m, scale, use_exp)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    c, length = x.shape
    scratch, cap, epoch = _scan_scratch(x.device, length, c)
    _launch("aps_scaled_prefix_chains", wrapper, x.device, _ptr(x), c, length, int(use_exp),
            _ptr(m) if use_exp else None, _ptr(scale) if scale is not None else None,
            _ptr(scratch), cap, epoch, _ptr(out))
    return out


def scaled_prefix_from_logw_chains(logw, m, scale) -> torch.Tensor:
    """B6 with the chain axis: ``logw`` float32 ``[C, N]``, ``m`` and
    ``scale`` float32 ``[C]``; row ``c`` is :func:`scaled_prefix_from_logw`
    on row ``c`` with ``(m[c], scale[c])``, bit for bit.  One launch."""
    if m is None or scale is None:
        raise ValueError("scaled_prefix_from_logw_chains needs m and scale")
    return _scaled_prefix_chains(scaled_prefix_from_logw_chains, logw, m, scale, use_exp=True)


def prefix_sum_chains(x) -> torch.Tensor:
    """B6's prefix sum with the chain axis: row ``c`` of float32 ``[C, N]``
    is :func:`prefix_sum` of ``x[c]``, bit for bit.  One launch."""
    return _scaled_prefix_chains(prefix_sum_chains, x, None, None, use_exp=False)


def _count_le(wrapper, entry: str, s, t) -> torch.Tensor:
    """B7/B8: the plain version on the CPU, else the kernel behind the C
    entry ``entry``, counted on ``wrapper``."""
    _check(s, "s", torch.float32)
    _check(t, "t", torch.float32)
    if s.numel() >= 1 << 31:
        raise ValueError(f"s must hold fewer than 2**31 values, got {s.numel()}")
    if _on_cpu(s, t):
        return count_le_sorted_ref(s, t)
    out = torch.empty(t.shape, dtype=torch.int32, device=t.device)
    if t.numel() == 0:
        return out
    _launch(entry, wrapper, t.device, _ptr(s), s.numel(), _ptr(t), t.numel(), _ptr(out))
    return out


def count_le_sorted_bs(s, t) -> torch.Tensor:
    """B7: ``out[j] = #{k : s_k ≤ t_j}`` as int32 for nondecreasing float32
    ``s`` and any float32 ``t``: each block of :data:`COUNT_TILE` consecutive
    thresholds searches only the run of ``s`` between the counts of its
    smallest and largest threshold (staged on chip up to :data:`COUNT_STAGE`
    entries)."""
    return _count_le(count_le_sorted_bs, "aps_count_le_sorted_bs", s, t)


def count_le_sorted(s, t) -> torch.Tensor:
    """B8: the same counts as :func:`count_le_sorted_bs` by a merge path over
    ``s`` and ``t``, both nondecreasing: equal tiles of :data:`MERGE_TILE`
    entries of the merged order, balanced under any skew of the thresholds."""
    return _count_le(count_le_sorted, "aps_count_le_sorted", s, t)


def count_le_sorted_auto(s, t) -> torch.Tensor:
    """The merge-count the sweep uses: B7 unless :data:`COUNT_LE_SORTED` is
    ``"merge"``."""
    if COUNT_LE_SORTED not in ("bs", "merge"):
        raise ValueError(f"COUNT_LE_SORTED must be 'bs' or 'merge', got {COUNT_LE_SORTED!r}")
    return (count_le_sorted if COUNT_LE_SORTED == "merge" else count_le_sorted_bs)(s, t)


def _count_le_chains(wrapper, entry: str, s, t) -> torch.Tensor:
    """B7/B8 with the chain axis: the plain version on the CPU, else the
    kernel behind the C entry ``entry``, counted on ``wrapper``."""
    _check(t, "t", torch.float32, ndims=(2,))
    if not isinstance(s, torch.Tensor) or s.dtype != torch.float32 or s.dim() != 2:
        raise TypeError("s must be a float32 tensor [C, ns]")
    c, ns = s.shape
    if t.shape[0] != c:
        raise ValueError(f"t has shape {tuple(t.shape)}, s has {c} chains")
    if not 1 <= c <= MAX_CHAINS:
        raise ValueError(f"s must have 1 to {MAX_CHAINS} chains, got {c}")
    if ns >= 1 << 31:
        raise ValueError(f"s must hold fewer than 2**31 values a chain, got {ns}")
    if (ns > 1 and s.stride(1) != 1) or (c > 1 and s.stride(0) < ns):
        raise ValueError("s must be rows of consecutive values, each row after the one before")
    if _on_cpu(s, t):
        return count_le_sorted_chains_ref(s, t)
    out = torch.empty(t.shape, dtype=torch.int32, device=t.device)
    if t.numel() == 0:
        return out
    _launch(entry, wrapper, t.device, _ptr(s), c, ns, s.stride(0), _ptr(t), t.shape[1],
            _ptr(out))
    return out


def count_le_sorted_bs_chains(s, t) -> torch.Tensor:
    """B7 with the chain axis: ``s`` float32 ``[C, ns]``, each row
    nondecreasing, whose rows may lie further apart than ``ns`` (a slice
    ``S[:, :n]`` of a wider array goes in as it lies), ``t`` float32 ``[C,
    nt]``; row ``c`` is :func:`count_le_sorted_bs` of ``(s[c], t[c])``, bit
    for bit.  One launch, the chain on the grid's second axis."""
    return _count_le_chains(count_le_sorted_bs_chains, "aps_count_le_sorted_bs_chains", s, t)


def count_le_sorted_chains(s, t) -> torch.Tensor:
    """B8 with the chain axis: rows as :func:`count_le_sorted_bs_chains`, each
    row of ``t`` nondecreasing too; row ``c`` is :func:`count_le_sorted` of
    ``(s[c], t[c])``.  One launch."""
    return _count_le_chains(count_le_sorted_chains, "aps_count_le_sorted_chains", s, t)


def count_le_sorted_auto_chains(s, t) -> torch.Tensor:
    """:func:`count_le_sorted_auto` for C chains: B7 with the chain axis
    unless :data:`COUNT_LE_SORTED` is ``"merge"``."""
    if COUNT_LE_SORTED not in ("bs", "merge"):
        raise ValueError(f"COUNT_LE_SORTED must be 'bs' or 'merge', got {COUNT_LE_SORTED!r}")
    return (count_le_sorted_chains if COUNT_LE_SORTED == "merge"
            else count_le_sorted_bs_chains)(s, t)


# ---------------------------------------------------------------------------
# Decode + move, as the sweep and the sharded exchange call them
# ---------------------------------------------------------------------------


def _resolve_version(version: Optional[int]) -> int:
    ver = MOVE_VERSION if version is None else version
    if ver not in _MOVE_VERSIONS:
        raise ValueError(f"unknown move version {ver}; valid: {list(_MOVE_VERSIONS)}")
    return ver


def _kernel_rows(leaf, lead: int):
    """A leaf as the contiguous rows a kernel moves, or None for a leaf no
    kernel moves (not 32-bit words, or no or more than
    :data:`MAX_DECODE_MOVE_D` words a row).  ``lead`` is 1 for leaves ``[M,
    ...]`` (rows ``[M]`` or ``[M, D]``) and 2 for chains' leaves ``[C, M,
    ...]`` (rows ``[C, M]`` or ``[C, M, D]``): the trailing axes flattened."""
    if leaf.dtype not in WORD_DTYPES or leaf.dim() < lead:
        return None
    if leaf.dim() == lead:
        return leaf.contiguous()
    d = math.prod(leaf.shape[lead:])
    if not 1 <= d <= MAX_DECODE_MOVE_D:
        return None
    return leaf.contiguous().reshape(tuple(leaf.shape[:lead]) + (d,))


def move_by_ancestors(anc, state):
    """Move ``state``, a tensor or a tree of tensors, by the ancestors
    ``anc``: for one chain ``anc`` int32 ``[n]`` and leaves ``[M, ...]``, for
    C chains ``anc [C, n]`` and leaves ``[C, M, ...]``, values in ``[0, M]``.
    Every float32 or int32 leaf of at most :data:`MAX_DECODE_MOVE_D` words a
    row goes through B3 (:func:`move_rows`, or :func:`move_rows_chains`), a
    bitwise copy with 0 where ``anc == M``; any other leaf is gathered by the
    ancestors clipped to ``M − 1``.  Returns ``(anc clipped to M − 1,
    moved)``, ``moved`` of ``state``'s structure with leaves ``[n, ...]`` (or
    ``[C, n, ...]``)."""
    lead = anc.dim()
    move = move_rows_chains if lead == 2 else move_rows
    leaves, structure = tree_flatten(state)
    moved = [None] * len(leaves)
    clipped = None
    for i, a in enumerate(leaves):
        rows = _kernel_rows(a, lead)
        if rows is not None:
            clipped, mv = move(anc, rows)
            moved[i] = mv.reshape(tuple(anc.shape) + tuple(a.shape[lead:]))
    if clipped is None:
        clipped = torch.clamp(anc, max=leaves[0].shape[lead - 1] - 1) if leaves else anc
    for i, a in enumerate(leaves):
        if moved[i] is None:
            moved[i] = _rows_of(a, clipped) if lead == 2 else a.index_select(0, clipped.long())
    return clipped, tree_unflatten(structure, moved)


def _move_tree(f, state, n_out: int, guard: Optional[int], start: int, ver: int):
    """Decode once and move every leaf of the tree ``state``, for one chain
    (``f [M]``, leaves ``[M, ...]``) or C (``f [C, M]``, leaves ``[C, M,
    ...]``, the kernels with the chain axis, ``start`` 0): the leaves a kernel
    moves by the move of version ``ver`` (B4 over leaves for 1, B3 a leaf for
    6), the others gathered by the clipped ancestors; version 0 (whole
    population only) gathers every leaf after B5."""
    lead = f.dim()
    chains = lead == 2
    window = {} if chains else {"start": start}
    leaves, structure = tree_flatten(state)
    rows = [_kernel_rows(a, lead) for a in leaves]
    words = [i for i, r in enumerate(rows) if r is not None]
    if ver == 6 or ver == 1 and not words:
        decode = decode_ancestors_chains if chains else decode_ancestors
        return move_by_ancestors(decode(f, n_out, guard, **window), state)
    moved = [None] * len(leaves)
    if ver == 0:
        dense = decode_ancestors_dense_chains if chains else decode_ancestors_dense
        anc = torch.clamp(dense(f, n_out, guard), max=f.shape[-1] - 1)
    elif len(words) == 1:
        move = decode_move_chains if chains else decode_move
        anc, moved[words[0]] = move(f, rows[words[0]], n_out, guard, **window)
    else:
        move = decode_move_leaves_chains if chains else decode_move_leaves
        anc, mvs = move(f, [rows[i] for i in words], n_out, guard, **window)
        for i, mv in zip(words, mvs):
            moved[i] = mv
    for i, a in enumerate(leaves):
        if moved[i] is None:
            moved[i] = _rows_of(a, anc) if chains else a.index_select(0, anc.long())
        else:
            moved[i] = moved[i].reshape(tuple(anc.shape) + tuple(a.shape[lead:]))
    return anc, tree_unflatten(structure, moved)


def resample_move_f(f, state, n: int, version: Optional[int] = None,
                    guard_n: Optional[int] = None):
    """Decode the ``n`` output slots of extents ``f`` and move ``state``
    (float32 ``[M]`` or ``[M, D]``, or a tree of tensors with leading axis
    ``M``) by them.  Returns ``(anc clipped to M−1, moved)``.

    ``f[M−1]`` is read as ``guard_n`` (``n`` if not given): slots from the
    guard on lie past the drawn population.  Their rows are 0 under versions
    1 and 6, and ``state[M−1]`` under version 0, which clips the counts and
    gathers (``pallas_resample.py:1273-1280``); a tree's leaves that are
    gathered take row ``M−1`` there under every version.  ``version`` None
    means :data:`MOVE_VERSION`.  A tree is decoded once: its float32 and
    int32 leaves of at most :data:`MAX_DECODE_MOVE_D` words a row go through
    B4 over leaves in ``⌈leaves / MAX_LEAVES⌉`` launches under version 1
    (one leaf: :func:`decode_move`), through B3 a leaf under 6
    (:func:`move_by_ancestors`), through an ``index_select`` a leaf under 0.
    """
    ver = _resolve_version(version)
    if is_tree(state):
        return _move_tree(f, state, n, guard_n, 0, ver)
    state = state.contiguous()
    if ver == 0:
        anc = decode_ancestors_dense(f, n, guard=guard_n)
        anc = torch.clamp(anc, max=f.shape[0] - 1)
        return anc, state.index_select(0, anc)
    if ver == 1:
        return decode_move(f, state, n, guard=guard_n)
    return move_rows(decode_ancestors(f, n, guard=guard_n), state)


def resample_move_f_chains(f, state, n: int, version: Optional[int] = None,
                           guard_n: Optional[int] = None):
    """:func:`resample_move_f` for C chains at once: ``f`` int32 ``[C, M]``,
    ``state`` a tensor or tree whose leaves are ``[C, M, ...]``.  Returns
    ``(anc [C, n] clipped to M−1, moved)``, chain ``c`` bitwise
    :func:`resample_move_f` of row ``c`` under the same version.  Every
    kernel runs once for all chains: version 1 B4 (over leaves) with the chain
    axis, 6 B2 and then B3 a 32-bit leaf (:func:`move_by_ancestors`), 0 B5 and
    then a gather; a state with no leaf a kernel moves is decoded by B2 and
    gathered under 1 and 6."""
    return _move_tree(f, state, n, guard_n, 0, _resolve_version(version))


def _systematic_extents(u, weights, n: int) -> torch.Tensor:
    """:func:`extents_from_prefix` on the float32 ``cumsum`` of normalised
    ``weights``, as the JAX package takes it."""
    return extents_from_prefix(torch.cumsum(weights, 0), 1.0, u, n)


def resample_move(u, weights, state, n: int, version: Optional[int] = None):
    """Systematic resampling of ``n`` positions from normalised ``weights``
    with offset ``u``, the state moved by :func:`resample_move_f`."""
    return resample_move_f(_systematic_extents(u, weights, n), state, n, version)


def resample_move_window_fext(f_ext, state, n: int, start: int, n_out: int,
                              version: Optional[int] = None):
    """Decode and move the output slots ``[start, start + n_out)`` against
    ``f_ext``, the global extents of a run of rows, and ``state``, those rows.

    ``n`` is the number of positions drawn (read as the guard, as the JAX
    package does).  Every owner of the window must lie in the run and every
    row before the run have an extent ``≤ start``; then the returned
    ancestors are run-local (global owner − the run's first row), clipped to
    the run.  Given the whole population as the run, they are global.
    Version 0 runs version 1, as ``pallas_resample.py:1323-1328`` does.
    ``state`` may be a tree of tensors, moved as :func:`resample_move_f`
    moves one.
    """
    ver = _resolve_version(version)
    if is_tree(state):
        return _move_tree(f_ext, state, n_out, n, start, 6 if ver == 6 else 1)
    state = state.contiguous()
    if ver == 6:
        return move_rows(decode_ancestors(f_ext, n_out, guard=n, start=start), state)
    return decode_move(f_ext, state, n_out, guard=n, start=start)


def resample_move_window(u, weights, state, n: int, start: int, n_out: int,
                         version: Optional[int] = None):
    """The window ``[start, start + n_out)`` of :func:`resample_move`: the
    same extents, so the ancestors are that slice of the whole population's.
    Slots at or past ``n`` decode past the population (ancestor M − 1, row
    0)."""
    f = _systematic_extents(u, weights, n)
    return resample_move_window_fext(f, state, n, start, n_out, version)


def systematic_decode(u, weights, n: int) -> torch.Tensor:
    """Systematic ancestors through B5, clipped to ``M − 1``: the counterpart
    of ``systematic_pallas`` (``pallas_resample.py:123-128``)."""
    anc = decode_ancestors_dense(_systematic_extents(u, weights, n), n)
    return torch.clamp(anc, max=weights.shape[0] - 1)


#: Every wrapper that launches a kernel, each with its ``launches`` count:
#: the one-chain kernels, then those with the chain axis.
KERNEL_WRAPPERS = (
    extents_from_logw, decode_ancestors, move_rows, decode_move, decode_move_leaves,
    decode_ancestors_dense, scaled_prefix_from_logw, prefix_sum, count_le_sorted_bs,
    count_le_sorted, extents_from_logw_chains, scaled_prefix_from_logw_chains,
    prefix_sum_chains, decode_move_chains, decode_move_leaves_chains, decode_ancestors_chains,
    move_rows_chains, decode_ancestors_dense_chains, count_le_sorted_bs_chains,
    count_le_sorted_chains,
)


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launch_counts()
