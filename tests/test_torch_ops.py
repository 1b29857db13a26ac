"""The port's resampling kernels (plain versions, on the CPU) against the JAX
package's Pallas kernels in interpret mode.

B1 ``extents_from_logw``, B2 ``decode_ancestors_bs`` and its dense twin
``decode_ancestors`` (B5), B3 the v6 lookup move and the v1 staircase move
(B4) through ``resample_move_f``, B6 ``scaled_prefix_from_logw`` and
``prefix_sum``, B7 ``count_le_sorted_bs`` and B8 ``count_le_sorted``.  On
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
    """Log-weight profiles: random log-normal, uniform, one survivor, 20 survivors."""
    rng = np.random.default_rng(seed)
    if profile == "lognormal":
        return (rng.standard_normal(m) * 2.0).astype(np.float32)
    if profile == "uniform":
        return np.zeros(m, np.float32)
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
    anc_c, moved = ops.resample_move(ops.decode_ancestors(torch.as_tensor(f), m, guard=n),
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
    anc_c, moved = ops.resample_move(anc, v)
    a = anc.numpy()
    want = np.where((a < m)[:, None], bits[np.minimum(a, m - 1)], 0)
    np.testing.assert_array_equal(moved.numpy().view(np.int32), want)
    np.testing.assert_array_equal(anc_c.numpy(), np.minimum(a, m - 1))


def test_wrappers_check_inputs_and_never_fall_back():
    x = torch.zeros(8)
    with pytest.raises(TypeError):
        ops.decode_ancestors(torch.zeros(8, dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        ops.resample_move(torch.zeros(8, dtype=torch.int32), torch.zeros(8, 2, 2))
    with pytest.raises(ValueError):
        ops.resample_move(torch.zeros(8, dtype=torch.int32), torch.zeros(2, 8).t())
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
    ops.resample_move(ops.decode_ancestors(f, 64), torch.zeros(64))
    s = ops.prefix_sum(torch.ones(65))
    thr = ops.scaled_prefix_from_logw(torch.zeros(64), torch.tensor(0.0), torch.tensor(1.0))
    ops.count_le_sorted_bs(s[:64], thr)
    ops.count_le_sorted(s[:64], thr)
    assert len(ops.KERNEL_WRAPPERS) == 7
    assert [w.launches for w in ops.KERNEL_WRAPPERS] == [0] * 7


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
