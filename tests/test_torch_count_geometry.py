"""The merge-count contract at the geometry of the CUDA kernels B7 and B8.

``out[j] = #{k : s_k ≤ t_j}``, equal to ``searchsorted(s, t, right=True)``.
The cases sit where the kernels' tiles meet (sizes read from the wrappers'
constants): ties across tile boundaries, thresholds below and above all of
``s``, ``+inf``, ``ns ≠ nt``, sizes one short of, equal to and one past a
tile, a tile of thresholds inside one gap of ``s`` (an empty run), a tile
whose run of ``s`` is one short of, exactly and one past what a block stages
(from an unaligned start), a merge tile of ``s`` alone or of thresholds alone,
and a few thresholds spanning more of ``s`` than a block stages.  On the CPU
the wrappers run their plain version, which is held here against numpy and
against the JAX package's Pallas kernels in interpret mode; the CUDA kernels
meet the same cases on the card in ``chip_smoke.py``, which also holds these
constants against the built library.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from advancedps_tpu.ops import pallas_resample as pr  # noqa: E402
from advancedps_tpu_torch.ops import resample as ops  # noqa: E402

TILE, STAGE, MERGE = ops.COUNT_TILE, ops.COUNT_STAGE, ops.MERGE_TILE

_COUNTS = {"bs": (ops.count_le_sorted_bs, pr.count_le_sorted_bs),
           "merge": (ops.count_le_sorted, pr.count_le_sorted)}


def _spaced(n, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(size=n)).astype(np.float32)


def _ties_across_boundaries():
    # Runs of 37 equal values in s and of 41 in t straddle every multiple of
    # the tile sizes, and s and t share values.
    s = np.floor(np.arange(STAGE + TILE + 5) / 37).astype(np.float32)
    t = np.floor(np.arange(2 * TILE + 3) / 41 * 2).astype(np.float32)
    return s, t


def _below_and_above():
    s = _spaced(TILE + 1, 1) + 10.0
    t = np.sort(np.concatenate([np.full(TILE, 1.0), s[::3], np.full(TILE, s[-1] + 5.0)]))
    return s, t.astype(np.float32)


def _infinite_thresholds():
    s = _spaced(MERGE, 2)
    t = np.concatenate([_spaced(TILE - 3, 3), np.full(3, np.inf)]).astype(np.float32)
    return s, t


def _empty_run():
    # A whole tile of thresholds inside one gap of s, then a tile past it.
    s = np.arange(STAGE, dtype=np.float32)
    t = np.sort(np.concatenate([np.linspace(7.1, 7.9, TILE), np.linspace(9.1, 2000.0, TILE)]))
    return s, t.astype(np.float32)


def _long_run():
    # Three thresholds spanning more of s than one block stages.
    s = np.linspace(0.0, 1.0, 2 * STAGE + 1, dtype=np.float32)
    return s, np.asarray([0.01, 0.5, 0.99], np.float32)


def _all_equal():
    s = _spaced(MERGE + 1, 4)
    return s, np.full(TILE + 1, s[MERGE // 2], np.float32)


def _run_of(run, nt):
    # One tile of nt thresholds whose counts span s[3 : 3 + run].
    def case():
        s = np.arange(3 * STAGE + 8, dtype=np.float32)
        t = np.linspace(2.5, 2.5 + run, nt).astype(np.float32)
        t[0], t[-1] = 2.5, 2.5 + run
        return s, t
    return case


def _s_alone_then_thresholds():
    s = np.arange(MERGE, dtype=np.float32)
    return s, MERGE + np.arange(5, dtype=np.float32)


def _thresholds_alone_then_s():
    t = np.arange(MERGE, dtype=np.float32)
    return 2 * MERGE + t, t


CASES = {
    "a run one short of the stage, unaligned": _run_of(STAGE - 1, TILE),
    "a run of exactly the stage, unaligned": _run_of(STAGE, TILE),
    "a run one past the stage, full tile": _run_of(STAGE + 1, TILE),
    "a run one past the stage, short tile": _run_of(STAGE + 1, 7),
    "a merge tile of s alone": _s_alone_then_thresholds,
    "a merge tile of thresholds alone": _thresholds_alone_then_s,
    "ties across tile boundaries": _ties_across_boundaries,
    "thresholds below and above all of s": _below_and_above,
    "+inf thresholds": _infinite_thresholds,
    "a tile inside one gap of s": _empty_run,
    "three thresholds over a long run of s": _long_run,
    "every threshold one value": _all_equal,
}


@pytest.mark.parametrize("form", ["bs", "merge"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_count_contract_cases(case, form):
    s, t = CASES[case]()
    port, pallas = _COUNTS[form]
    got = port(torch.as_tensor(s), torch.as_tensor(t))
    assert got.dtype == torch.int32 and got.shape == t.shape
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(s, t, side="right"))
    if np.isfinite(t).all():
        # The Pallas kernels pad s with +inf, which a +inf threshold counts:
        # that case is held against searchsorted alone.
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(pallas(jnp.asarray(s), jnp.asarray(t), interpret=True)))


SIZES = [
    (TILE - 1, TILE + 1), (TILE + 1, TILE - 1), (TILE, TILE), (1, TILE), (TILE, 1), (1, 1),
    (STAGE - 1, 7), (STAGE, 7), (STAGE + 1, 7),
    (MERGE // 2, MERGE // 2), (MERGE // 2, MERGE // 2 + 1), (MERGE - 1, 1), (5, MERGE + 1),
    (MERGE, MERGE), (MERGE + 1, 5),
]


@pytest.mark.parametrize("form", ["bs", "merge"])
@pytest.mark.parametrize("ns,nt", SIZES)
def test_merge_count_sizes_around_the_tiles(ns, nt, form):
    s = _spaced(ns, ns * 7 + nt)
    t = np.sort((np.random.default_rng(nt).random(nt) * s[-1] * 1.05).astype(np.float32))
    port, pallas = _COUNTS[form]
    got = port(torch.as_tensor(s), torch.as_tensor(t)).numpy()
    np.testing.assert_array_equal(got, np.searchsorted(s, t, side="right"))
    np.testing.assert_array_equal(
        got, np.asarray(pallas(jnp.asarray(s), jnp.asarray(t), interpret=True)))


def test_unsorted_and_nan_thresholds_count_as_searchsorted():
    # B7 takes any thresholds; a NaN counts all of s.  (B8 and the Pallas
    # kernels need nondecreasing thresholds.)
    s = _spaced(STAGE + 3, 5)
    t = np.random.default_rng(6).permutation(_spaced(TILE + 9, 7) * 4).astype(np.float32)
    t[::100] = np.nan
    got = ops.count_le_sorted_bs(torch.as_tensor(s), torch.as_tensor(t)).numpy()
    np.testing.assert_array_equal(got[::100], len(s))
    keep = ~np.isnan(t)
    np.testing.assert_array_equal(got[keep], np.searchsorted(s, t[keep], side="right"))
