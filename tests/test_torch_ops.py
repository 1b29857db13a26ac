"""The port's resampling kernels (plain versions, on the CPU) against the JAX
package's Pallas kernels in interpret mode.

B1 ``extents_from_logw``, B2 ``decode_ancestors_bs`` (whole and windowed)
and its dense twin ``decode_ancestors`` (B5), B3 the v6 lookup move, B4 the
v1 staircase ``_resample_move_cols`` (whole and windowed), the versions of
``resample_move_f`` and the windowed moves, B6 ``scaled_prefix_from_logw``
and ``prefix_sum``, B7 ``count_le_sorted_bs`` and B8 ``count_le_sorted``.  On
CPU tensors the port's wrappers run the plain versions; the CUDA kernels are
compared with them on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from advancedps_tpu.ops import pallas_resample as pr  # noqa: E402
from advancedps_tpu_torch.ops import resample as ops  # noqa: E402

SIZES = [1000, 4096, 10_000]
PROFILES = ["lognormal", "uniform", "single", "survivors20"]


def _logw(profile, m, seed):
    """Log-weight profiles: random log-normal, uniform, one survivor, 20
    survivors, and zeros (90% of the weights exactly 0 in float32)."""
    rng = np.random.default_rng(seed)
    if profile == "lognormal":
        return (rng.standard_normal(m) * 2.0).astype(np.float32)
    if profile == "uniform":
        return np.zeros(m, np.float32)
    if profile == "zeros":
        logw = rng.standard_normal(m).astype(np.float32)
        logw[rng.random(m) < 0.9] = -200.0  # exp(-200 - max) is 0 in float32
        return logw
    logw = np.full(m, -80.0, np.float32)
    k = 1 if profile == "single" else 20
    logw[rng.choice(m, size=k, replace=False)] = rng.standard_normal(k).astype(np.float32)
    return logw


def _reduce(logw):
    """The sweep's (m, s1) for the extents, computed once in float32 and
    handed to both packages."""
    m = np.float32(logw.max())
    s1 = np.float32(np.exp(logw - m, dtype=np.float32).sum(dtype=np.float32))
    return m, s1


def _port_extents(logw, m, s1, u, n):
    return ops.extents_from_logw(
        torch.as_tensor(logw), torch.tensor(m), torch.tensor(s1), u, n
    ).numpy()


def _jax_extents(logw, m, s1, u, n):
    return np.asarray(
        pr.extents_from_logw(jnp.asarray(logw), jnp.float32(m), jnp.float32(s1), u, n,
                             interpret=True)
    )


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("m", SIZES)
def test_extents_match_pallas(m, profile):
    logw = _logw(profile, m, seed=m)
    mx, s1 = _reduce(logw)
    u = float(np.float32(np.random.default_rng(m + 1).random()))
    f = _port_extents(logw, mx, s1, u, m)
    f_jax = _jax_extents(logw, mx, s1, u, m)
    # Both compute the float32 prefix through different summation trees
    # (torch cumsum vs a blocked log-step scan with a Kahan carry): an extent
    # may differ by ±1 where n·cdf − u lies within rounding of an integer.
    diff = np.abs(f.astype(np.int64) - f_jax.astype(np.int64))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3
    assert (np.diff(f) >= 0).all(), "extents must be bitwise nondecreasing"
    # The last extent undershoots to m − 1 where fl32(m·cdf − u) rounds down
    # (u near 1); the decode's guard reads it as m.
    assert f.min() >= 0 and f[-1] in (m - 1, m)


def test_extents_monotone_under_undershoot():
    # The running max keeps f nondecreasing even where the raw formula is not
    # monotone; check the plain version against numpy's cumulative max.
    rng = np.random.default_rng(4)
    logw = (rng.standard_normal(5000) * 5).astype(np.float32)
    mx, s1 = _reduce(logw)
    e = torch.exp(torch.as_tensor(logw) - torch.tensor(mx))
    raw = torch.clamp(torch.ceil(5000 * (torch.cumsum(e, 0) * (1.0 / torch.tensor(s1))) - 0.3),
                      0, 5000).to(torch.int32).numpy()
    np.testing.assert_array_equal(_port_extents(logw, mx, s1, 0.3, 5000),
                                  np.maximum.accumulate(raw))


def _case(profile, m, guarded):
    """Extents as the sweep makes them: drawn for n = M positions, or for
    n = M − 1 with the guard M − 1 (the reference-slot form, whose last slot
    decodes past the drawn population)."""
    n = m - 1 if guarded else m
    logw = _logw(profile, m, seed=m + 3)
    mx, s1 = _reduce(logw)
    u = float(np.float32(np.random.default_rng(m + 7).random()))
    x = np.random.default_rng(m).standard_normal(m).astype(np.float32)
    return _port_extents(logw, mx, s1, u, n), n, x


def _jax_v6(f, x, m, guard):
    """The v6 pipeline exactly as ``resample_move_f`` runs it: ``decode_ancestors_bs``
    on the guarded extents (unclipped ancestors) and the lookup move."""
    return pr._resample_move_cols_v6(
        jnp.asarray(f), (jnp.asarray(x),), m, start=None, n_out=None, interpret=True,
        guard=guard,
    )


@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("m", SIZES)
def test_decode_matches_pallas_exactly(m, profile, guarded):
    f, n, x = _case(profile, m, guarded)
    anc = ops.decode_ancestors(torch.as_tensor(f), m, guard=n).numpy()
    anc_bs, _ = _jax_v6(f, x, m, n)
    np.testing.assert_array_equal(anc, np.asarray(anc_bs))
    # The dense staircase decoder (B5) reads f as given: guard it first.
    f_guarded = jnp.asarray(f).at[m - 1].set(n)
    np.testing.assert_array_equal(anc, np.asarray(pr.decode_ancestors(f_guarded, m, interpret=True)))
    assert anc.min() >= 0 and anc.max() <= m
    assert (anc[-1] == m) == guarded


def test_decode_reads_guard_without_writing():
    f = torch.tensor([0, 2, 2, 3], dtype=torch.int32)
    before = f.clone()
    np.testing.assert_array_equal(ops.decode_ancestors(f, 4).numpy(), [1, 1, 3, 3])
    # guard 3 < n_out: slot 3 lies past the drawn population (anc == M).
    np.testing.assert_array_equal(ops.decode_ancestors(f, 4, guard=3).numpy(), [1, 1, 3, 4])
    assert torch.equal(f, before)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("m", SIZES)
def test_move_matches_pallas_bitwise(m, profile, guarded):
    f, n, x = _case(profile, m, guarded)
    anc_c, moved = ops.move_rows(ops.decode_ancestors(torch.as_tensor(f), m, guard=n),
                                 torch.as_tensor(x))
    for version in (6, 1):  # the v6 lookup move (B3) and the v1 staircase (B4)
        anc_j, moved_j = pr.resample_move_f(
            jnp.asarray(f), jnp.asarray(x), m, interpret=True, version=version, guard_n=n
        )
        np.testing.assert_array_equal(anc_c.numpy(), np.asarray(anc_j))
        np.testing.assert_array_equal(_bits(moved.numpy()), _bits(moved_j))
    if guarded:
        # The last slot decodes past the drawn population: anc clipped, value 0.
        assert anc_c[-1] == m - 1 and moved[-1] == 0


def test_move_rows_bitwise_wide_state():
    # [M, D] rows move whole; payloads that float arithmetic would disturb
    # (negative zero, NaN payloads, denormals) move unchanged.
    m, d = 777, 5
    rng = np.random.default_rng(9)
    bits = rng.integers(-(2**31), 2**31, size=(m, d), dtype=np.int64).astype(np.int32)
    v = torch.as_tensor(bits.view(np.float32))
    anc = torch.as_tensor(np.sort(rng.integers(0, m + 1, size=600)).astype(np.int32))
    anc_c, moved = ops.move_rows(anc, v)
    a = anc.numpy()
    want = np.where((a < m)[:, None], bits[np.minimum(a, m - 1)], 0)
    np.testing.assert_array_equal(moved.numpy().view(np.int32), want)
    np.testing.assert_array_equal(anc_c.numpy(), np.minimum(a, m - 1))


def test_wrappers_check_inputs_and_never_fall_back():
    x = torch.zeros(8)
    with pytest.raises(TypeError):
        ops.decode_ancestors(torch.zeros(8, dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        ops.move_rows(torch.zeros(8, dtype=torch.int32), torch.zeros(8, 2, 2))
    with pytest.raises(ValueError):
        ops.move_rows(torch.zeros(8, dtype=torch.int32), torch.zeros(2, 8).t())
    with pytest.raises(ValueError):
        ops.extents_from_logw(x, torch.tensor(0.0), torch.tensor(8.0), 0.5, 2**24)
    # A tensor on a device without a kernel raises; it is not computed on the CPU.
    meta = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.extents_from_logw(meta, torch.zeros((), device="meta"),
                              torch.ones((), device="meta"), 0.5, 8)
    with pytest.raises(ValueError, match="different devices"):
        ops.extents_from_logw(x, torch.zeros((), device="meta"), torch.tensor(8.0), 0.5, 8)


@pytest.mark.parametrize("m", [1000, 4096])
def test_resample_systematic_and_ess_match_jax(m):
    import jax

    from advancedps_tpu import resampling as jres
    from advancedps_tpu_torch import resampling as tres
    from advancedps_tpu_torch.convert import key_from_words

    w = np.random.default_rng(m).gamma(0.5, size=m).astype(np.float32)
    w /= w.sum(dtype=np.float32)
    key = jax.random.key(m)
    want = np.asarray(jres.resample_systematic(key, jnp.asarray(w), m))
    tkey = key_from_words(np.asarray(jax.random.key_data(key)))
    got = tres.resample_systematic(tkey, torch.as_tensor(w), m).numpy()
    # Same searchsorted form and the same u; torch's and XLA's float32 cumsum
    # may round a boundary entry differently and move one slot by one.
    assert np.abs(got.astype(np.int64) - want).max() <= 1
    assert (got != want).mean() <= 1e-3
    gated = tres.ResampleWithESSThreshold()
    assert gated(tkey, torch.as_tensor(w), m).tolist() == got.tolist()
    ess = float(tres.effective_sample_size(torch.as_tensor(w)))
    np.testing.assert_allclose(ess, float(jres.effective_sample_size(jnp.asarray(w))), rtol=1e-5)
    assert bool(gated.should_resample(torch.as_tensor(w), m)) == (ess <= 0.5 * m)


def test_cpu_path_counts_no_launches():
    ops.reset_launch_counts()
    f = ops.extents_from_logw(torch.zeros(64), torch.tensor(0.0), torch.tensor(64.0), 0.5, 64)
    ops.move_rows(ops.decode_ancestors(f, 64), torch.zeros(64))
    ops.decode_move(f, torch.zeros(64), 32, guard=64, start=16)
    ops.decode_ancestors_dense(f, 64)
    s = ops.prefix_sum(torch.ones(65))
    thr = ops.scaled_prefix_from_logw(torch.zeros(64), torch.tensor(0.0), torch.tensor(1.0))
    ops.count_le_sorted_bs(s[:64], thr)
    ops.count_le_sorted(s[:64], thr)
    ops.decode_move_leaves(f, [torch.zeros(64), torch.zeros(64, 3, dtype=torch.int32)], 64)
    # The kernels with the chain axis.
    fc = ops.extents_from_logw_chains(torch.zeros(2, 64), torch.zeros(2), torch.full((2,), 64.0),
                                      torch.full((2,), 0.5), 64)
    ops.scaled_prefix_from_logw_chains(torch.zeros(2, 64), torch.zeros(2), torch.ones(2))
    ops.prefix_sum_chains(torch.ones(2, 65))
    ops.decode_move_chains(fc, torch.zeros(2, 64), 64)
    ops.decode_move_leaves_chains(fc, [torch.zeros(2, 64), torch.zeros(2, 64, 3)], 64)
    assert len(ops.KERNEL_WRAPPERS) == 15
    assert [w.launches for w in ops.KERNEL_WRAPPERS] == [0] * 15


# --- B6: the scaled prefix ----------------------------------------------------


def _ulps(a, b):
    """float32 ulp distance of nonnegative values."""
    return np.abs(_bits(a).astype(np.int64) - _bits(b).astype(np.int64))


# The port sums in float64 and rounds once (held exactly below); the Pallas
# kernel sums in float32, log-step within a block with a Kahan carry across
# blocks, and is itself up to 4 ulps from the rounded float64 prefix at these
# sizes (measured: 4 at m = 5000).  So the two are held to 4 ulps.
B6_ULPS = 4


def _exact_scaled_prefix(e, scale):
    """The port's formula in numpy on float32 summands ``e``: the float64
    prefix rounded to float32 once, times the float32 scale in float32."""
    return np.cumsum(e, dtype=np.float64).astype(np.float32) * np.float32(scale)


@pytest.mark.parametrize("m", [1000, 4096, 5000, 70])
def test_scaled_prefix_matches_pallas(m):
    rng = np.random.default_rng(m)
    logw = (rng.standard_normal(m) * 3).astype(np.float32)
    mx = np.float32(logw.max())
    for scale in (np.float32(7.25), np.float32(m) / np.exp(logw - mx).sum(dtype=np.float32)):
        got = ops.scaled_prefix_from_logw(torch.as_tensor(logw), torch.tensor(mx),
                                          torch.tensor(scale)).numpy()
        want = np.asarray(pr.scaled_prefix_from_logw(jnp.asarray(logw), jnp.float32(mx),
                                                     jnp.float32(scale), interpret=True))
        assert _ulps(got, want).max() <= B6_ULPS
        assert (np.diff(got) >= 0).all(), "the scaled prefix must be bitwise nondecreasing"
        e = torch.exp(torch.as_tensor(logw) - torch.tensor(mx)).numpy()
        np.testing.assert_array_equal(got, _exact_scaled_prefix(e, scale))


@pytest.mark.parametrize("profile", PROFILES)
def test_scaled_prefix_profiles_match_pallas(profile):
    # c = n·cdf as stratified uses it, on each weight profile, n = M and M − 1.
    m = 4096
    logw = _logw(profile, m, seed=11)
    mx, s1 = _reduce(logw)
    for n in (m, m - 1):
        scale = np.float32(n) / s1
        got = ops.scaled_prefix_from_logw(torch.as_tensor(logw), torch.tensor(mx),
                                          torch.tensor(scale)).numpy()
        want = np.asarray(pr.scaled_prefix_from_logw(jnp.asarray(logw), jnp.float32(mx),
                                                     jnp.float32(scale), interpret=True))
        assert _ulps(got, want).max() <= B6_ULPS
        assert (np.diff(got) >= 0).all()


@pytest.mark.parametrize("m", [1000, 4096, 20000])
def test_prefix_sum_matches_pallas(m):
    x = np.random.default_rng(m + 1).exponential(size=m).astype(np.float32)
    got = ops.prefix_sum(torch.as_tensor(x)).numpy()
    want = np.asarray(pr.prefix_sum(jnp.asarray(x), interpret=True))
    assert _ulps(got, want).max() <= B6_ULPS
    assert (np.diff(got) >= 0).all()
    # The port's prefix is the float64 prefix rounded once.
    np.testing.assert_array_equal(got, np.cumsum(x, dtype=np.float64).astype(np.float32))


def test_prefix_sum_is_a_running_max_for_negative_inputs():
    # As the TPU kernel, the output is nondecreasing whatever the input: a
    # prefix that falls is held at its running max.
    x = torch.tensor([1.0, -3.0, 2.0, 0.5, -0.25])
    np.testing.assert_array_equal(ops.prefix_sum(x).numpy(), [1.0, 1.0, 1.0, 1.0, 1.0])
    np.testing.assert_array_equal(
        np.asarray(pr.prefix_sum(jnp.asarray(x.numpy()), interpret=True)), [1, 1, 1, 1, 1])


# --- B7 / B8: the sorted merge-count ------------------------------------------


def _sorted_pair(ns, nt, seed):
    rng = np.random.default_rng(seed)
    s = np.sort(rng.exponential(size=ns).cumsum().astype(np.float32))
    t = np.sort((rng.random(nt) * s[-1] * 1.05).astype(np.float32))
    return s, t


_COUNTS = {"bs": (ops.count_le_sorted_bs, pr.count_le_sorted_bs),
           "merge": (ops.count_le_sorted, pr.count_le_sorted)}


@pytest.mark.parametrize("form", ["bs", "merge"])
@pytest.mark.parametrize("ns,nt", [(1000, 1000), (4096, 3000), (3000, 4096), (100, 5000)])
def test_count_le_sorted_matches_pallas(ns, nt, form):
    s, t = _sorted_pair(ns, nt, seed=ns * 3 + nt)
    port, pallas = _COUNTS[form]
    got = port(torch.as_tensor(s), torch.as_tensor(t)).numpy()
    np.testing.assert_array_equal(got, np.asarray(pallas(jnp.asarray(s), jnp.asarray(t),
                                                         interpret=True)))
    np.testing.assert_array_equal(got, np.searchsorted(s, t, side="right"))
    assert got.dtype == np.int32


@pytest.mark.parametrize("form", ["bs", "merge"])
def test_count_le_sorted_extremes_and_long_stall(form):
    port, pallas = _COUNTS[form]
    # Thresholds below every value, between, on, above every value.
    s = np.arange(1, 2049, dtype=np.float32)
    t = np.asarray([0.0, 0.5, 1.0, 1024.5, 2048.0, 9999.0], np.float32)
    got = port(torch.as_tensor(s), torch.as_tensor(t)).numpy()
    np.testing.assert_array_equal(got, [0, 0, 1, 1024, 2048, 2048])
    np.testing.assert_array_equal(got, np.asarray(pallas(jnp.asarray(s), jnp.asarray(t),
                                                         interpret=True)))
    # One tiny block of thresholds against values spanning many chunks.
    s = np.linspace(0.0, 1.0, 8192, dtype=np.float32)
    t = np.asarray([0.25, 0.5, 1.0], np.float32)
    got = port(torch.as_tensor(s), torch.as_tensor(t)).numpy()
    np.testing.assert_array_equal(got, np.searchsorted(s, t, side="right"))
    np.testing.assert_array_equal(got, np.asarray(pallas(jnp.asarray(s), jnp.asarray(t),
                                                         interpret=True)))
    # No values: every count is 0 (the reference slot's draw of PG(1)).
    assert port(torch.zeros(0), torch.as_tensor(t)).tolist() == [0, 0, 0]


def test_count_le_sorted_auto_dispatch(monkeypatch):
    s, t = (torch.as_tensor(a) for a in _sorted_pair(300, 200, seed=5))
    want = ops.count_le_sorted_ref(s, t)
    for form in ("bs", "merge"):
        monkeypatch.setattr(ops, "COUNT_LE_SORTED", form)
        assert torch.equal(ops.count_le_sorted_auto(s, t), want)
    monkeypatch.setattr(ops, "COUNT_LE_SORTED", "dense")
    with pytest.raises(ValueError, match="COUNT_LE_SORTED"):
        ops.count_le_sorted_auto(s, t)


def test_scheme_wrappers_check_inputs_and_never_fall_back():
    x = torch.zeros(8)
    with pytest.raises(TypeError):
        ops.prefix_sum(torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.prefix_sum(torch.zeros(4, 2))
    with pytest.raises(ValueError):
        ops.scaled_prefix_from_logw(x, torch.tensor(0.0), torch.ones(1))
    with pytest.raises(TypeError):
        ops.count_le_sorted_bs(x, torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.count_le_sorted(torch.zeros(16)[::2], x)
    meta = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.prefix_sum(meta)
    with pytest.raises(ValueError, match="no kernel"):
        ops.count_le_sorted(meta, meta)
    with pytest.raises(ValueError, match="different devices"):
        ops.scaled_prefix_from_logw(x, torch.zeros((), device="meta"), torch.tensor(1.0))


# --- B2 windowed, B4, B5 and the move versions ----------------------------------

WINDOW_M = 4096
WINDOW_PROFILES = ["uniform", "lognormal", "single", "zeros"]
WINDOWS = [(0, 1024), (1024, 1024), (3072, 1024), (1000, 777)]


def _as_given(f, guard):
    """``f`` with its last extent set to ``guard``, as the JAX callers pass it."""
    g = np.array(f)
    g[-1] = guard
    return g


@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("profile", WINDOW_PROFILES)
def test_windowed_decode_matches_pallas(profile, guarded):
    m = WINDOW_M
    f, n, _ = _case(profile, m, guarded)
    whole = ops.decode_ancestors(torch.as_tensor(f), m, guard=n).numpy()
    for start, n_out in WINDOWS:
        got = ops.decode_ancestors(torch.as_tensor(f), n_out, guard=n, start=start).numpy()
        want = pr.decode_ancestors_bs(jnp.asarray(_as_given(f, n)), n, start=start, n_out=n_out,
                                      interpret=True)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got, whole[start:start + n_out])


@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("profile", WINDOW_PROFILES)
def test_decode_move_matches_pallas(profile, guarded):
    # B4 against the v1 staircase, whole and windowed, on two columns ([M, 2]
    # rows in the port).
    m = WINDOW_M
    f, n, x = _case(profile, m, guarded)
    cols = (x, -2.0 * x)
    rows = torch.as_tensor(np.stack(cols, axis=1))
    for start, n_out in [(None, None), (1024, 1024), (3072, 1024)]:
        anc_j, moved_j = pr._resample_move_cols(
            jnp.asarray(f), tuple(jnp.asarray(c) for c in cols), m, start=start, n_out=n_out,
            interpret=True, guard=n,
        )
        if start is None:
            anc, moved = ops.decode_move(torch.as_tensor(f), rows, m, guard=n)
        else:
            anc, moved = ops.decode_move(torch.as_tensor(f), rows, n_out, guard=n, start=start)
        np.testing.assert_array_equal(anc.numpy(), np.minimum(np.asarray(anc_j), m - 1))
        for c in range(2):
            np.testing.assert_array_equal(_bits(moved[:, c].contiguous().numpy()),
                                          _bits(moved_j[c]))
        want = ops.decode_move_ref(torch.as_tensor(f), rows, anc.shape[0], n, start or 0)
        assert torch.equal(anc, want[0]) and torch.equal(moved, want[1])
    if guarded:  # the whole decode's last slot lies past the population
        assert anc_j[-1] == m


@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("profile", WINDOW_PROFILES)
def test_dense_decode_matches_pallas(profile, guarded):
    m = WINDOW_M
    f, n, _ = _case(profile, m, guarded)
    got = ops.decode_ancestors_dense(torch.as_tensor(f), m, guard=n).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(pr.decode_ancestors(jnp.asarray(_as_given(f, n)), m, interpret=True)))
    np.testing.assert_array_equal(got, ops.decode_ancestors(torch.as_tensor(f), m, guard=n).numpy())
    # Read as given: the JAX decode on the unguarded extents.
    as_given = ops.decode_ancestors_dense(torch.as_tensor(f), m, guard=int(f[-1])).numpy()
    np.testing.assert_array_equal(
        as_given, np.asarray(pr.decode_ancestors(jnp.asarray(f), m, interpret=True)))


def test_dense_decode_counts_run_ends():
    f = torch.tensor([0, 2, 2, 3], dtype=torch.int32)
    before = f.clone()
    np.testing.assert_array_equal(ops.decode_ancestors_dense(f, 4).numpy(), [1, 1, 3, 3])
    np.testing.assert_array_equal(ops.decode_ancestors_dense(f, 4, guard=3).numpy(), [1, 1, 3, 4])
    # Extents at or past n_out mark nothing; the slots before them count
    # only the rows below.
    np.testing.assert_array_equal(ops.decode_ancestors_dense(f, 2, guard=9).numpy(), [1, 1])
    np.testing.assert_array_equal(
        ops.decode_ancestors_dense(torch.tensor([4, 4, 4], dtype=torch.int32), 3).numpy(),
        [0, 0, 0])
    assert torch.equal(f, before)
    np.testing.assert_array_equal(ops.decode_ancestors(f, 2, guard=4, start=2).numpy(), [3, 3])


@pytest.mark.parametrize("version", [0, 1, 6])
@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("profile", WINDOW_PROFILES)
def test_resample_move_f_versions_match_pallas(profile, guarded, version):
    m = WINDOW_M
    f, n, x = _case(profile, m, guarded)
    anc, moved = ops.resample_move_f(torch.as_tensor(f), torch.as_tensor(x), m,
                                     version=version, guard_n=n)
    anc_j, moved_j = pr.resample_move_f(jnp.asarray(f), jnp.asarray(x), m, interpret=True,
                                        version=version, guard_n=n)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(anc_j))
    np.testing.assert_array_equal(_bits(moved.numpy()), _bits(moved_j))
    if guarded:
        # The slot past the drawn population: version 0 clips and gathers
        # the last row; versions 1 and 6 move 0.
        assert anc[-1] == m - 1
        assert _bits(moved[-1:].numpy())[0] == _bits(x[-1:] if version == 0 else np.zeros(1))[0]


@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("profile", WINDOW_PROFILES)
def test_default_move_version_is_the_fused_decode_move(profile, guarded):
    # The sweep's decode + move is B4 (one launch); B2 then B3, the JAX
    # package's default, gives the same bits.
    assert ops.MOVE_VERSION == 1
    m = WINDOW_M
    f, n, x = _case(profile, m, guarded)
    tf, tx = torch.as_tensor(f), torch.as_tensor(x)
    anc, moved = ops.resample_move_f(tf, tx, m, guard_n=n)
    for other in (ops.decode_move(tf, tx, m, guard=n),
                  ops.resample_move_f(tf, tx, m, version=6, guard_n=n)):
        assert torch.equal(anc, other[0])
        np.testing.assert_array_equal(_bits(moved.numpy()), _bits(other[1].numpy()))
    anc_j, moved_j = pr.resample_move_f(jnp.asarray(f), jnp.asarray(x), m, interpret=True,
                                        guard_n=n)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(anc_j))
    np.testing.assert_array_equal(_bits(moved.numpy()), _bits(moved_j))


def _dyadic_weights(profile, m, seed):
    """Normalised weights ``c_i / 2^p`` with integer ``c_i`` summing to
    ``2^p``: every float32 prefix sum is exact, so both packages' float32
    cumsums give the same systematic extents."""
    rng = np.random.default_rng(seed)
    if profile == "uniform":
        c = np.ones(m, np.int64)
    elif profile == "single":
        c = np.zeros(m, np.int64)
        c[rng.integers(m)] = 1
    elif profile == "zeros":
        c = np.where(rng.random(m) < 0.5, 0, 1).astype(np.int64)
    else:  # skewed
        c = np.floor(np.exp(2.0 * rng.standard_normal(m))).astype(np.int64)
    total = 1 << int(np.ceil(np.log2(c.sum())))
    deficit = total - c.sum()
    c += deficit // m
    c[rng.choice(m, size=int(deficit % m), replace=False)] += 1
    assert c.sum() == total
    return (c / total).astype(np.float32)


@pytest.mark.parametrize("version", [0, 1, 6])
@pytest.mark.parametrize("profile", ["uniform", "skewed", "single", "zeros"])
def test_resample_move_window_matches_pallas(profile, version):
    m = WINDOW_M
    w = _dyadic_weights(profile, m, seed=5)
    u = float(np.float32(np.random.default_rng(6).random()))
    x = np.random.default_rng(7).standard_normal(m).astype(np.float32)
    tw, tx = torch.as_tensor(w), torch.as_tensor(x)
    anc_all, moved_all = ops.resample_move(u, tw, tx, m, version=version)
    anc_pj, moved_pj = pr.resample_move(u, jnp.asarray(w), jnp.asarray(x), m, interpret=True,
                                        version=version)
    np.testing.assert_array_equal(anc_all.numpy(), np.asarray(anc_pj))
    np.testing.assert_array_equal(_bits(moved_all.numpy()), _bits(moved_pj))
    for start, n_out in [(0, 1024), (2048, 1024), (3072, 1024)]:
        anc, moved = ops.resample_move_window(u, tw, tx, m, start, n_out, version=version)
        anc_j, moved_j = pr.resample_move_window(u, jnp.asarray(w), jnp.asarray(x), m, start,
                                                 n_out, interpret=True, version=version)
        np.testing.assert_array_equal(anc.numpy(), np.asarray(anc_j))
        np.testing.assert_array_equal(_bits(moved.numpy()), _bits(moved_j))
        # The window is that slice of the whole population's draw.
        np.testing.assert_array_equal(anc.numpy(), anc_all.numpy()[start:start + n_out])
    np.testing.assert_array_equal(ops.systematic_decode(u, tw, m).numpy(),
                                  np.asarray(pr.systematic_pallas(u, jnp.asarray(w), m,
                                                                  interpret=True)))


@pytest.mark.parametrize("version", [1, 6])
@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("profile", ["uniform", "lognormal"])
def test_resample_move_window_fext_matches_pallas(profile, guarded, version):
    # The neighbour exchange's form: shard k of K = 4 decodes its window
    # against the 3L rows of shards k−1, k, k+1 (ring-wrapped, the wrapped
    # extents masked to 0 and n as the sharded sweep does).
    m, K = WINDOW_M, 4
    L = m // K
    f, n, x = _case(profile, m, guarded)
    whole_anc, whole_moved = ops.resample_move_f(torch.as_tensor(f), torch.as_tensor(x), m,
                                                 guard_n=n)
    for k in range(K):
        rows = [(k + d) % K for d in (-1, 0, 1)]
        f_ext = np.concatenate([f[r * L:(r + 1) * L] for r in rows])
        if k == 0:
            f_ext[:L] = 0
        if k == K - 1:
            f_ext[2 * L:] = n
        x_ext = np.concatenate([x[r * L:(r + 1) * L] for r in rows])
        anc, moved = ops.resample_move_window_fext(torch.as_tensor(f_ext), torch.as_tensor(x_ext),
                                                   n, k * L, L, version=version)
        anc_j, moved_j = pr.resample_move_window_fext(jnp.asarray(f_ext), jnp.asarray(x_ext), n,
                                                      k * L, L, interpret=True, version=version)
        np.testing.assert_array_equal(anc.numpy(), np.asarray(anc_j))
        np.testing.assert_array_equal(_bits(moved.numpy()), _bits(moved_j))
        # Mapped back to global ids, the window-local owners are the whole
        # population's (the neighbour predicate holds for these profiles).
        glob = np.clip((k - 1) * L + anc.numpy(), 0, m - 1)
        np.testing.assert_array_equal(glob, whole_anc.numpy()[k * L:(k + 1) * L])
        np.testing.assert_array_equal(_bits(moved.numpy()),
                                      _bits(whole_moved.numpy()[k * L:(k + 1) * L]))


def test_decode_wrappers_check_inputs_and_never_fall_back():
    f = torch.tensor([0, 2, 2, 3], dtype=torch.int32)
    # A window must name the drawn count as its guard.
    with pytest.raises(ValueError, match="guard"):
        ops.decode_ancestors(f, 2, start=1)
    with pytest.raises(ValueError, match="guard"):
        ops.decode_move(f, torch.zeros(4), 2, start=1)
    with pytest.raises(ValueError, match="start"):
        ops.decode_ancestors(f, 2, guard=4, start=-1)
    with pytest.raises(ValueError, match="rows"):
        ops.decode_move(f, torch.zeros(5), 4)
    with pytest.raises(ValueError, match="columns"):
        ops.decode_move(f[:1], torch.zeros(1, ops.MAX_DECODE_MOVE_D + 1), 1)
    with pytest.raises(ValueError, match="columns"):
        ops.decode_move(f, torch.zeros(4, 0), 4)
    with pytest.raises(ValueError, match="empty"):
        ops.decode_ancestors_dense(torch.zeros(0, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="move version"):
        ops.resample_move_f(f, torch.zeros(4), 4, version=5)
    meta_f = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.decode_ancestors_dense(meta_f, 4)
    with pytest.raises(ValueError, match="no kernel"):
        ops.decode_move(meta_f, torch.zeros(4, device="meta"), 4)
    with pytest.raises(ValueError, match="different devices"):
        ops.decode_move(f, torch.zeros(4, device="meta"), 4)
