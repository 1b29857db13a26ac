"""The decode and prefix contracts at the geometry of the CUDA kernels B2, B4,
B5 and B1/B6.

B2: ``anc[k] = #{j : f_j ≤ start + k}`` with ``f[M−1]`` read as the guard,
equal to ``searchsorted(f, start + arange(n_out), right=True)``.  The cases
sit where the kernel's tiles meet (sizes read from the wrappers' constants):
slot counts one short of, at and one past a tile, a tile whose run of owner
rows is one short of, exactly and one past what a block stages, one row owning
every slot, every row owning one slot, all extents 0 but the guard, many rows
of one extent inside a tile, a tile no row owns, the guard case, and each as a
window whose start is no multiple of the tile.

B4 (decode + move, whose block decodes its tile as B2's does) takes the same
cases with one and with three columns, whole and windowed; B5 (the decode by
counting) takes them whole, and sizes around a tile of its own scan and a
group of such tiles.

B1/B6: lengths one short of, at and one past a tile of the scan and a group
of tiles, and a group of groups plus one element.

On the CPU the wrappers run their plain version, which is held here against
numpy and against the JAX package's Pallas kernels in interpret mode; the
CUDA kernels meet the same cases on the card in ``chip_smoke.py``, which also
holds these constants against the built library.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from advancedps_tpu.ops import pallas_resample as pr  # noqa: E402
from advancedps_tpu_torch.ops import resample as ops  # noqa: E402

TILE, STAGE = ops.DECODE_TILE, ops.DECODE_STAGE
MOVE_TILE, DENSE_TILE = ops.DECODE_MOVE_TILE, ops.DENSE_TILE
SCAN_TILE, GROUP = ops.PREFIX_TILE, ops.PREFIX_GROUP

_SOURCE = Path(ops.__file__).resolve().parent.parent / "csrc" / "resample.cu"


def _source_constants():
    """Every ``constexpr int kName = expression;`` of the CUDA source, the
    expression evaluated over the constants before it."""
    found = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", _SOURCE.read_text()):
        found[name] = eval(expr, {"__builtins__": {}}, dict(found))  # products of names and ints
    return found


MIRRORED = {
    "COUNT_TILE": "kCountTile", "COUNT_STAGE": "kCountStage", "MERGE_TILE": "kMergeTile",
    "DECODE_TILE": "kDecodeTile", "DECODE_STAGE": "kDecodeStage", "PREFIX_TILE": "kTile",
    "DECODE_MOVE_TILE": "kDecodeMoveTile", "DENSE_TILE": "kDenseTile",
}


@pytest.mark.parametrize("name", sorted(MIRRORED))
def test_wrapper_constants_mirror_the_cuda_source(name):
    assert getattr(ops, name) == _source_constants()[MIRRORED[name]]


def test_decode_geometry_is_read_back_in_the_order_of_the_constants():
    # chip_smoke.py holds aps_decode_geometry(0..3) against these four, in turn.
    body = re.search(r"int aps_decode_geometry\(int which\) \{(.*?)\n\}", _SOURCE.read_text(),
                     re.S).group(1)
    assert re.findall(r"\? (k\w+)", body) == ["kDecodeTile", "kDecodeStage", "kDecodeMoveTile",
                                                "kDenseTile"]
    # B4's cases are B2's: both decode a tile of the same size by one function,
    # as B4 over leaves does.
    assert MOVE_TILE == TILE
    source = _SOURCE.read_text()
    assert source.count("decode_tile(f, m, guard, start + k0, nk, sh,") == 3


def test_scan_groups_are_warps():
    # A group of the cross-tile combination is scanned by one warp.
    assert GROUP == 32
    assert "idx & 31" in _SOURCE.read_text() and "idx >> 5" in _SOURCE.read_text()


# --- B2 -------------------------------------------------------------------------


def _extents(m, n, seed):
    """Nondecreasing extents of m rows for n positions, ending at n."""
    w = np.random.default_rng(seed).random(m) ** 4
    f = np.clip(np.ceil(np.cumsum(w) / w.sum() * n), 0, n).astype(np.int32)
    f[-1] = n
    return f


def _i32(*parts):
    return np.concatenate([np.asarray(p, np.int32).reshape(-1) for p in parts])


def _sizes(n):
    return lambda: (_extents(n, n, n), n, n)


def _guard_case():
    n = 3 * TILE + 17
    return _extents(n, n - 1, 5), n, n - 1


def _owner_run(run):
    # The first tile's owners are rows [3, 3 + run).
    def case():
        inside = np.sort(np.random.default_rng(run).integers(1, TILE, size=run))
        n = 2 * TILE + 5
        return _i32([0, 0, 0], inside, TILE + np.arange(TILE + 6), [n]), n, n
    return case


_M = 2 * TILE + 9


def _one_row_owns_all():
    return _i32(np.zeros(TILE + 3), np.full(_M - TILE - 3, _M)), _M, _M


def _every_row_owns_one():
    return np.arange(1, _M + 1, dtype=np.int32), _M, _M


def _zero_but_guard():
    return np.zeros(_M, np.int32), _M, _M


def _one_extent_inside_a_tile():
    return _i32([0, 0], np.full(3 * STAGE, 5), np.arange(6, _M + 1)), _M, _M


def _tile_without_owner():
    return _i32(np.arange(1, TILE + 1), [_M] * 9), _M, _M


DECODE_CASES = {
    "one slot short of a tile": _sizes(TILE - 1),
    "exactly a tile": _sizes(TILE),
    "one slot past a tile": _sizes(TILE + 1),
    "three tiles and 17": _sizes(3 * TILE + 17),
    "the guard case": _guard_case,
    "an owner run one short of the stage": _owner_run(STAGE - 1),
    "an owner run of exactly the stage": _owner_run(STAGE),
    "an owner run one past the stage": _owner_run(STAGE + 1),
    "one row owns every slot": _one_row_owns_all,
    "every row owns one slot": _every_row_owns_one,
    "all extents 0 but the guard": _zero_but_guard,
    "many rows of one extent inside a tile": _one_extent_inside_a_tile,
    "no row owns a slot of the last tile": _tile_without_owner,
}


def _as_given(f, guard):
    g = np.array(f)
    g[-1] = guard
    return g


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32).astype(np.int64)


@pytest.mark.parametrize("windowed", [False, True], ids=["whole", "window"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_contract_cases(case, windowed):
    f, n_out, guard = DECODE_CASES[case]()
    start = 0
    if windowed:
        start = 333 if n_out > 400 else 1
        n_out = n_out - start - 2
    got = ops.decode_ancestors(torch.as_tensor(f), n_out, guard=guard, start=start)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_out,)
    given = _as_given(f, guard)
    slots = start + np.arange(n_out)
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(given, slots, side="right"))
    if windowed:
        want = pr.decode_ancestors_bs(jnp.asarray(given), guard, start=start, n_out=n_out,
                                      interpret=True)
    else:
        want = pr.decode_ancestors_bs(jnp.asarray(given), n_out, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # B5 counts the same owners for the whole population.
    if not windowed:
        np.testing.assert_array_equal(
            got.numpy(), ops.decode_ancestors_dense(torch.as_tensor(f), n_out, guard=guard).numpy())


def test_decode_of_an_unaligned_slice_is_the_decode_of_its_copy():
    f = torch.as_tensor(_i32([0], _extents(2 * TILE + 3, 2 * TILE + 3, 9)))
    view = f[1:]
    assert view.data_ptr() % 16 != 0
    n = view.numel()
    assert torch.equal(ops.decode_ancestors(view, n), ops.decode_ancestors(view.clone(), n))


# --- B4 -------------------------------------------------------------------------


def _rows(m, columns, seed):
    shape = (m,) if columns == 1 else (m, columns)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _moved(given, v, slots):
    """numpy's decode + move: the clipped owners and their rows, 0 past the
    population."""
    m = given.shape[0]
    counts = np.searchsorted(given, slots, side="right")
    moved = v[np.minimum(counts, m - 1)].copy()
    moved[counts >= m] = 0
    return np.minimum(counts, m - 1).astype(np.int32), moved


@pytest.mark.parametrize("columns", [1, 3])
@pytest.mark.parametrize("windowed", [False, True], ids=["whole", "window"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_move_contract_cases(case, windowed, columns):
    f, n_out, guard = DECODE_CASES[case]()
    start = 0
    if windowed:
        start = 333 if n_out > 400 else 1
        n_out = n_out - start - 2
    v = _rows(f.shape[0], columns, 11)
    anc, moved = ops.decode_move(torch.as_tensor(f), torch.as_tensor(v), n_out, guard=guard,
                                 start=start)
    assert anc.dtype == torch.int32 and tuple(anc.shape) == (n_out,)
    assert tuple(moved.shape) == (n_out,) + v.shape[1:]
    want_anc, want_moved = _moved(_as_given(f, guard), v, start + np.arange(n_out))
    np.testing.assert_array_equal(anc.numpy(), want_anc)
    np.testing.assert_array_equal(_bits(moved.numpy()), _bits(want_moved))
    # The v1 staircase of the JAX package, which B4 replaces.
    if windowed:
        anc_j, moved_j = pr.resample_move_window_fext(jnp.asarray(f), jnp.asarray(v), guard, start,
                                                      n_out, interpret=True, version=1)
    else:
        anc_j, moved_j = pr.resample_move_f(jnp.asarray(f), jnp.asarray(v), n_out, interpret=True,
                                            version=1, guard_n=guard)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(anc_j))
    np.testing.assert_array_equal(_bits(moved.numpy()), _bits(moved_j))
    # B4 is B2 then B3.
    b2 = ops.decode_ancestors(torch.as_tensor(f), n_out, guard=guard, start=start)
    b3 = ops.move_rows(b2, torch.as_tensor(v))
    assert torch.equal(anc, b3[0]) and torch.equal(moved.view(torch.int32), b3[1].view(torch.int32))


@pytest.mark.parametrize("columns", [1, 4])
def test_decode_move_of_unaligned_slices_is_the_decode_move_of_their_copies(columns):
    m = 2 * MOVE_TILE + 3
    f = torch.as_tensor(_i32([0], _extents(m, m, 9)))[1:]
    v = torch.as_tensor(_rows(m * columns + 1, 1, 10))[1:]
    v = v if columns == 1 else v.view(m, columns)
    assert f.data_ptr() % 16 != 0 and v.data_ptr() % 16 != 0
    for start, n_out in ((0, m), (333, m - 335)):
        got = ops.decode_move(f, v, n_out, guard=m, start=start)
        want = ops.decode_move(f.clone(), v.clone(), n_out, guard=m, start=start)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


# --- B5 -------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_dense_decode_contract_cases(case):
    f, n_out, guard = DECODE_CASES[case]()
    got = ops.decode_ancestors_dense(torch.as_tensor(f), n_out, guard=guard)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_out,)
    given = _as_given(f, guard)
    np.testing.assert_array_equal(got.numpy(),
                                  np.searchsorted(given, np.arange(n_out), side="right"))
    want = pr.decode_ancestors(jnp.asarray(given), n_out, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


DENSE_SIZES = [DENSE_TILE - 1, DENSE_TILE, DENSE_TILE + 1, 3 * DENSE_TILE + 17,
               GROUP * DENSE_TILE - 1, GROUP * DENSE_TILE + 1]


@pytest.mark.parametrize("n", DENSE_SIZES)
def test_dense_decode_at_the_geometry_of_its_scan(n):
    # Rows and slots around a tile of B5's scan and a group of its tiles, the
    # guard case (one position short) beside the whole draw.
    for drawn in (n, n - 1):
        f = _extents(n, drawn, n)
        got = ops.decode_ancestors_dense(torch.as_tensor(f), n, guard=drawn).numpy()
        given = _as_given(f, drawn)
        np.testing.assert_array_equal(got, np.searchsorted(given, np.arange(n), side="right"))
        want = pr.decode_ancestors(jnp.asarray(given), n, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("slots", ["fewer than rows", "more than rows"])
def test_dense_decode_with_slots_unlike_rows(slots):
    # Extents at or past n_out mark nothing; slots from the guard on lie past
    # the population.
    m = 2 * DENSE_TILE + 9
    f = _extents(m, m, 3)
    n_out = m // 3 + 5 if slots == "fewer than rows" else 2 * m + 7
    got = ops.decode_ancestors_dense(torch.as_tensor(f), n_out, guard=m).numpy()
    np.testing.assert_array_equal(got, np.searchsorted(f, np.arange(n_out), side="right"))
    np.testing.assert_array_equal(
        got, ops.decode_ancestors(torch.as_tensor(f), n_out, guard=m).numpy())


# --- B1 / B6 ----------------------------------------------------------------------

SCAN_LENGTHS = [SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1,
                GROUP * SCAN_TILE - 1, GROUP * SCAN_TILE, GROUP * SCAN_TILE + 1]
#: The level above: a group of groups and one element.  Held against numpy
#: alone (Pallas interpret mode is slow at two million elements).
LEVEL_ABOVE = GROUP * GROUP * SCAN_TILE + 1

# The port's prefix is the float64 prefix rounded once; the Pallas kernel sums
# in float32 (log-step within a block, a Kahan carry across blocks) and is up
# to 4 ulps from it (tests/test_torch_ops.py).
B6_ULPS = 4


def _logw(length):
    logw = (np.random.default_rng(length).standard_normal(length) * 2.0).astype(np.float32)
    mx = np.float32(logw.max())
    s1 = np.float32(np.exp(logw - mx, dtype=np.float32).sum(dtype=np.float32))
    return logw, mx, s1


@pytest.mark.parametrize("length", SCAN_LENGTHS)
def test_extents_at_the_scan_geometry(length):
    logw, mx, s1 = _logw(length)
    f = ops.extents_from_logw(torch.as_tensor(logw), torch.tensor(mx), torch.tensor(s1), 0.37,
                              length).numpy()
    f_jax = np.asarray(pr.extents_from_logw(jnp.asarray(logw), jnp.float32(mx), jnp.float32(s1),
                                            0.37, length, interpret=True))
    # ±1 where n·cdf − u lies within rounding of an integer.  The Pallas
    # prefix is a float32 sum, up to B6_ULPS ulps from the rounded float64
    # prefix, and an ulp of n·cdf near n is n·2⁻²³ of a stratum: that share of
    # the entries may move, or one in a thousand (tests/test_torch_ops.py).
    diff = np.abs(f.astype(np.int64) - f_jax.astype(np.int64))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= max(1e-3, B6_ULPS * length * 2.0 ** -23)
    assert (np.diff(f) >= 0).all() and f[-1] in (length - 1, length)


@pytest.mark.parametrize("length", SCAN_LENGTHS)
def test_scaled_prefix_at_the_scan_geometry(length):
    logw, mx, s1 = _logw(length)
    scale = np.float32(length) / s1
    got = ops.scaled_prefix_from_logw(torch.as_tensor(logw), torch.tensor(mx),
                                      torch.tensor(scale)).numpy()
    want = np.asarray(pr.scaled_prefix_from_logw(jnp.asarray(logw), jnp.float32(mx),
                                                 jnp.float32(scale), interpret=True))
    assert np.abs(_bits(got) - _bits(want)).max() <= B6_ULPS
    assert (np.diff(got) >= 0).all()


@pytest.mark.parametrize("length", SCAN_LENGTHS)
def test_prefix_sum_at_the_scan_geometry(length):
    x = np.random.default_rng(length + 1).exponential(size=length).astype(np.float32)
    got = ops.prefix_sum(torch.as_tensor(x)).numpy()
    want = np.asarray(pr.prefix_sum(jnp.asarray(x), interpret=True))
    assert np.abs(_bits(got) - _bits(want)).max() <= B6_ULPS
    assert (np.diff(got) >= 0).all()
    np.testing.assert_array_equal(got, np.cumsum(x, dtype=np.float64).astype(np.float32))


@pytest.mark.parametrize("form", ["extents", "scaled prefix", "prefix sum"])
def test_scan_one_level_above_is_the_rounded_float64_prefix(form):
    logw, mx, s1 = _logw(LEVEL_ABOVE)
    e = torch.exp(torch.as_tensor(logw) - torch.tensor(mx)).numpy()
    prefix = np.cumsum(e, dtype=np.float64).astype(np.float32)
    tl, tm = torch.as_tensor(logw), torch.tensor(mx)
    if form == "extents":
        n = 1_000_000
        got = ops.extents_from_logw(tl, tm, torch.tensor(s1), 0.37, n).numpy()
        cdf = prefix * (np.float32(1.0) / s1)
        raw = np.clip(np.ceil(np.float32(n) * cdf - np.float32(0.37)), 0, n).astype(np.int32)
        np.testing.assert_array_equal(got, np.maximum.accumulate(raw))
    elif form == "scaled prefix":
        scale = np.float32(7.25)
        got = ops.scaled_prefix_from_logw(tl, tm, torch.tensor(scale)).numpy()
        np.testing.assert_array_equal(got, prefix * scale)
    else:
        got = ops.prefix_sum(torch.as_tensor(e)).numpy()
        np.testing.assert_array_equal(got, prefix)
    assert (np.diff(got) >= 0).all()


def test_a_falling_prefix_is_held_at_its_running_max_across_tiles():
    x = np.random.default_rng(3).standard_normal(5 * SCAN_TILE + 3).astype(np.float32)
    got = ops.prefix_sum(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(
        got, np.maximum.accumulate(np.cumsum(x, dtype=np.float64).astype(np.float32)))
    want = np.asarray(pr.prefix_sum(jnp.asarray(x), interpret=True))
    # The running max of two prefixes that differ by rounding: compared where
    # the prefix is well away from zero.
    big = np.abs(want) > 1.0
    np.testing.assert_allclose(got[big], want[big], rtol=1e-5)
