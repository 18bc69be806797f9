"""ADC lookups of the PyTorch port (kernels K2 and K3's plain versions)
against the JAX package.

The Pallas kernels have no interpret switch, so the oracles are the
reference's own jnp paths (`_gated_adc_jnp`, `_adc_scan_jnp`, the vmapped
`gated_block_scorer_for` scorers) and a numpy loop. Tolerances:
- against the jnp paths: rtol = atol = 1e-6 (f32 sums of the same terms,
  perhaps in another order);
- against the numpy loop: exact, since both sum the same f32 terms in s
  order (the gated terms rounded to bf16, round to nearest even);
- K3's "smallest" route against `lax.top_k(-d, r)` over `_adc_scan_jnp`'s
  finalised sums: the same positions in the same order. Its tables hold
  multiples of 1/4, so the sums are exact in any order and rows tie often;
- a NumPy model of the "smallest" kernel's tiled selection against the
  plain version: the same positions in the same order; and one of its
  compaction against np.sort.
The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islands_tpu.core import pq as jpq
from islands_tpu.core.config import DistanceMetric as JM
from islands_tpu.ops.pallas_kernels import _adc_scan_jnp, _gated_adc_jnp
from islands_tpu_torch.core import pq as tpq
from islands_tpu_torch.core.config import DistanceMetric as TM
from islands_tpu_torch.ops.adc import (
    adc_scan,
    adc_scan_reference,
    adc_scan_smallest,
    adc_scan_smallest_reference,
    finalize_adc,
    gated_adc_reference,
    gated_adc_sums,
)

METRICS = ["cosine", "euclidean", "dotproduct", "manhattan"]
# (B, E, S, K): the odd shape of tests/test_static_loop_and_grouped_adc.py
# and config 4's subspaces at a small batch.
GATED_SHAPES = [(24, 70, 8, 64), (4, 120, 16, 256)]
SCAN_SHAPES = [(3, 1000, 8, 32), (4, 2000, 16, 256)]


def _inputs(seed, b, s, k, rows, dtype=np.uint8):
    """f32 tables [B, S, K] and codes [*rows, S] of `dtype` with codes 0 and
    K-1 present."""
    rng = np.random.default_rng(seed)
    tables = rng.standard_normal((b, s, k)).astype(np.float32)
    codes = rng.integers(0, k, size=(*rows, s)).astype(dtype)
    flat = codes.reshape(-1, s)
    flat[0] = 0
    flat[1] = k - 1
    return tables, codes


def _bf16(a):
    """float32 -> bf16 (round to nearest even) -> float32, in numpy."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("b,e,s,k", GATED_SHAPES)
def test_gated_adc_reference_matches_jnp(b, e, s, k):
    tables, codes = _inputs(b + e, b, s, k, (b, e))
    want = np.asarray(_gated_adc_jnp(jnp.asarray(tables), jnp.asarray(codes)))
    got = gated_adc_reference(torch.from_numpy(tables), torch.from_numpy(codes))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,e,s,k", GATED_SHAPES)
def test_gated_block_scorer_matches_reference_vmap(metric, b, e, s, k):
    tables, codes = _inputs(b * e + k, b, s, k, (b, e))
    valid = np.random.default_rng(k).random((b, e)) < 0.9
    want = jax.vmap(jpq.gated_block_scorer_for(JM(metric), "grouped"))(
        jnp.asarray(tables), jnp.asarray(codes), jnp.asarray(valid))
    args = [torch.from_numpy(a) for a in (tables, codes, valid)]
    for impl in ("grouped", "einsum"):
        got = tpq.gated_block_scorer_for(TM(metric), impl)(*args)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,e,s,k", GATED_SHAPES)
def test_gated_adc_reference_matches_numpy_loop(b, e, s, k):
    tables, codes = _inputs(7 * b, b, s, k, (b, e))
    t16 = _bf16(tables)
    want = np.zeros((b, e), np.float32)
    for j in range(s):
        want += t16[np.arange(b)[:, None], j, codes[:, :, j]]
    got = gated_adc_reference(torch.from_numpy(tables), torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,n,s,k", SCAN_SHAPES)
def test_adc_scan_reference_matches_jnp(b, n, s, k):
    tables, codes = _inputs(b + n, b, s, k, (n,))
    want = np.asarray(_adc_scan_jnp(jnp.asarray(tables), jnp.asarray(codes)))
    got = adc_scan_reference(torch.from_numpy(tables), torch.from_numpy(codes))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,n,s,k", SCAN_SHAPES)
def test_adc_scan_reference_matches_numpy_loop(b, n, s, k):
    tables, codes = _inputs(3 * n, b, s, k, (n,))
    want = np.zeros((b, n), np.float32)
    for j in range(s):
        want += tables[:, j, codes[:, j]]
    got = adc_scan_reference(torch.from_numpy(tables), torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want)


def test_adc_scan_reference_takes_int32_codes():
    # Codes of more than 256 centroids; one outside [0, K) reads entry K-1.
    tables, codes = _inputs(5, 3, 4, 512, (50,), np.int32)
    codes[2, 1], codes[3, 2] = -1, 512
    want = np.zeros((3, 50), np.float32)
    for j in range(4):
        want += tables[:, j, np.where((codes[:, j] >= 0) & (codes[:, j] < 512),
                                      codes[:, j], 511)]
    t, c = torch.from_numpy(tables), torch.from_numpy(codes)
    np.testing.assert_array_equal(adc_scan_reference(t, c).numpy(), want)
    np.testing.assert_array_equal(adc_scan(t, c).numpy(), want)


def test_wrappers_on_cpu_run_the_plain_versions_uncounted():
    tables, codes = map(torch.from_numpy, _inputs(1, 5, 8, 32, (5, 9)))
    before = gated_adc_sums.launches
    assert torch.equal(gated_adc_sums(tables, codes), gated_adc_reference(tables, codes))
    assert gated_adc_sums.launches == before
    tables, codes = map(torch.from_numpy, _inputs(2, 5, 8, 32, (40,)))
    before = adc_scan.launches
    assert torch.equal(adc_scan(tables, codes), adc_scan_reference(tables, codes))
    assert adc_scan.launches == before


@pytest.mark.parametrize("b,e", [(0, 12), (3, 0)])
def test_empty_batches(b, e):
    tables = torch.zeros((b, 8, 32))
    assert gated_adc_sums(tables, torch.zeros((b, e, 8), dtype=torch.uint8)).shape == (b, e)
    assert adc_scan(tables, torch.zeros((e, 8), dtype=torch.uint8)).shape == (b, e)


def test_wrappers_reject_bad_inputs():
    tables, codes = map(torch.from_numpy, _inputs(3, 4, 8, 32, (4, 6)))
    with pytest.raises(TypeError):
        gated_adc_sums(tables.double(), codes)
    with pytest.raises(TypeError):
        gated_adc_sums(tables, codes.int())
    with pytest.raises(ValueError):
        gated_adc_sums(tables, codes[:3])
    with pytest.raises(ValueError):
        gated_adc_sums(tables, codes[..., :4])
    with pytest.raises(TypeError):
        adc_scan(tables, codes)  # 3-D codes
    with pytest.raises(TypeError):
        adc_scan(tables, codes[0].long())
    with pytest.raises(ValueError):
        adc_scan(tables, codes[0, :, :4])


def _tied_inputs(seed, b, n, s, k, dtype=np.uint8, dup=True, neg_zero=False, signed=True):
    """Tables of multiples of 1/4 in [-2, 2), or [0, 2) unless `signed`
    (exact sums, many ties), and codes [N, S]; with `dup` some rows repeat
    earlier ones far away (equal sums at other ids), with `neg_zero` the
    tables hold -0.0 beside +0.0."""
    rng = np.random.default_rng(seed)
    tables = (rng.integers(-8 if signed else 0, 8, (b, s, k)) / 4).astype(np.float32)
    if neg_zero:
        zero = tables == 0
        tables[zero] = np.where(rng.random(np.sum(zero)) < 0.5, -0.0, 0.0)
    codes = rng.integers(0, k, (n, s)).astype(dtype)
    if dup:
        src = rng.integers(0, n, n // 7)
        dst = rng.integers(0, n, n // 7)
        codes[dst] = codes[src]
    return tables, codes


def _finalize_jnp(sums, metric):
    # islands_tpu/core/pq.py:366-369.
    if metric == "cosine":
        return 1.0 + sums
    if metric == "euclidean":
        return jnp.sqrt(jnp.maximum(sums, 0.0))
    return sums


@pytest.mark.parametrize("dtype,k", [(np.uint8, 32), (np.uint8, 256), (np.int32, 512)])
@pytest.mark.parametrize("metric", METRICS)
def test_adc_scan_smallest_reference_matches_lax_top_k(metric, dtype, k):
    tables, codes = _tied_inputs(k + len(metric), 6, 3000, 8, k, dtype)
    d = _finalize_jnp(_adc_scan_jnp(jnp.asarray(tables), jnp.asarray(codes)), metric)
    t, c = torch.from_numpy(tables), torch.from_numpy(codes)
    for r in (1, 37, 300, 3000):
        _, want = jax.lax.top_k(-d, r)
        got = adc_scan_smallest_reference(t, c, r, metric)
        assert got.dtype == torch.int64 and got.shape == (6, r)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_adc_scan_smallest_reference_orders_duplicate_rows_by_id():
    # Rows 10, 500 and 2999 share row 3's codes: equal distances at other ids.
    # Along each row the distances ascend and equal ones keep ids ascending.
    tables, codes = _tied_inputs(9, 4, 3000, 8, 64, dup=False)
    codes[[10, 500, 2999]] = codes[3]
    t, c = torch.from_numpy(tables), torch.from_numpy(codes)
    d = finalize_adc(adc_scan_reference(t, c), "dotproduct").numpy()
    got = adc_scan_smallest_reference(t, c, 3000, "dotproduct").numpy()
    for drow, row in zip(d, got):
        assert len(set(drow[[3, 10, 500, 2999]])) == 1
        dd = drow[row]
        assert np.all(dd[1:] >= dd[:-1])
        assert np.all((dd[1:] > dd[:-1]) | (row[1:] > row[:-1]))


_NO_KEY = np.iinfo(np.int64).max


def _keys(d):
    """ops/merge.py's int64 keys (sort_key(d) << 32 | position) of f32 rows."""
    b = d.astype(np.float32).view(np.int32)
    sk = b ^ ((b >> 31) & 0x7FFFFFFF)
    return (sk.astype(np.int64) << 32) | np.arange(d.shape[-1], dtype=np.int64)


def _sum_bound(key, metric):
    """csrc/adc_scan.cu's sum_bound in float32: a bound on the sums whose
    finalised distance can be <= that of `key` (NaN for no key)."""
    f32 = np.float32
    if key == _NO_KEY:
        return f32(np.nan)
    sk = np.array([key >> 32], np.int64).astype(np.int32)
    d = (sk ^ ((sk >> 31) & 0x7FFFFFFF)).view(np.float32)[0]
    with np.errstate(over="ignore", invalid="ignore"):
        if metric == "cosine":
            return (d - f32(1)) + abs(d) * f32(1e-6) + f32(1e-30)
        if metric == "euclidean":
            return d * d * (f32(1) + f32(1e-6)) + f32(1e-37)
    return d


def _bitonic_sort(x):
    """csrc/adc_scan.cu's sort_lists on one list of a power-of-two length."""
    x = x.copy()
    i = np.arange(len(x) // 2)
    k = 2
    while k <= len(x):
        j = k // 2
        while j:
            lo = 2 * i - (i & (j - 1))
            up = (lo & k) == 0
            a, b = x[lo], x[lo + j]
            swap = (a > b) == up
            x[lo[swap]], x[lo[swap] + j] = b[swap], a[swap]
            j //= 2
        k *= 2
    return x


def _compact(kept, new, r):
    """csrc/adc_scan.cu's compact on one list: kept keys [rp] (the r smallest
    so far, sorted, then empty slots) and new keys [w] (unsorted, empty slots
    as the largest int64) -> the kept keys of both. The new keys are sorted,
    a half-cleaner against the first rp of them reversed keeps the rp
    smallest of both as a bitonic sequence, and a bitonic merge sorts them."""
    rp = len(kept)
    m = np.minimum(kept, _bitonic_sort(new)[:rp][::-1])
    i = np.arange(rp // 2)
    j = rp // 2
    while j:
        lo = 2 * i - (i & (j - 1))
        a, b = m[lo].copy(), m[lo + j].copy()
        m[lo], m[lo + j] = np.minimum(a, b), np.maximum(a, b)
        j //= 2
    m[r:] = _NO_KEY
    return m


def _place(own, ws, wait, i, key):
    """A key into its warp's slots `own` (ws of them), or onto `wait` as (row,
    key) when they are full."""
    if len(own) < ws:
        own.append(key)
    else:
        wait.append((i, key))


def _tiled_smallest(sums, metric, r, tile, step, lanes=4):
    """NumPy model of csrc/adc_scan.cu's "smallest" route: per query and tile
    of `tile` rows, rp = next_pow2(r) kept keys and w = max(step, rp) slots
    of new keys under a threshold, walked `step` rows at a time by warps of
    `lanes` lanes (one row each), each warp owning w / warps of the slots. A
    row whose sum lies above the bound of the threshold from before the step
    is skipped; else its key enters below the threshold. A key that finds
    its warp's slots full waits for a compaction (_compact) and then enters
    if still below the new threshold. Then the tiles' sorted r-key lists
    (padded with the largest int64) are merged as the merge kernel does
    (_merge_lists). Returns the positions and the number of keys that
    waited."""
    rp = 1 << int(np.ceil(np.log2(r)))
    w = max(step, rp)
    warps = step // lanes
    ws = w // warps
    keys = _keys(finalize_adc(torch.from_numpy(sums), metric).numpy())
    out, waited = [], 0

    def fold(kept, slots):
        new = np.full(w, _NO_KEY, np.int64)
        for k, own in enumerate(slots):
            new[k * ws:k * ws + len(own)] = own
        return _compact(kept, new, r)

    for srow, row in zip(sums, keys):
        lists = []
        for t0 in range(0, row.shape[0], tile):
            kept, slots = np.full(rp, _NO_KEY, np.int64), [[] for _ in range(warps)]
            thr, hi = _NO_KEY, _sum_bound(_NO_KEY, metric)
            stop = min(t0 + tile, row.shape[0])
            for s0 in range(t0, stop, step):
                wait = []
                for i in range(s0, min(s0 + step, stop)):
                    if not srow[i] > hi and row[i] < thr:
                        _place(slots[(i - s0) // lanes], ws, wait, i, row[i])
                waited += len(wait)
                while wait:
                    kept, slots = fold(kept, slots), [[] for _ in range(warps)]
                    thr = kept[r - 1]
                    hi = _sum_bound(thr, metric)
                    again, wait = wait, []
                    for i, key in again:
                        if key < thr:
                            _place(slots[(i - s0) // lanes], ws, wait, i, key)
            kept = fold(kept, slots)
            lists.append(list(kept[:r]))
        out.append(_merge_lists(lists, r) & 0xFFFFFFFF)
    return np.stack(out), waited


def _merge_lists(lists, r):
    """NumPy model of csrc/adc_scan.cu's merge: sorted lists of r keys,
    padded to a power of two of next_pow2(r) slots, merged pairwise (the
    half-cleaner over one list and its partner reversed, then a bitonic
    merge of the kept half) until list 0 holds the r smallest."""
    rp = 1 << int(np.ceil(np.log2(r)))
    n = 1 << int(np.ceil(np.log2(len(lists))))
    m = np.full((n, rp), _NO_KEY, np.int64)
    for t, keys in enumerate(lists):
        m[t, :r] = keys
    st = 1
    while st < n:
        for a in range(0, n, 2 * st):
            m[a] = np.minimum(m[a], m[a + st][::-1])
            h = rp // 2
            while h:
                x = m[a].reshape(-1, 2, h)
                lo, hi = x[:, 0].copy(), x[:, 1].copy()
                x[:, 0], x[:, 1] = np.minimum(lo, hi), np.maximum(lo, hi)
                h //= 2
        st *= 2
    return m[0, :r]


@pytest.mark.parametrize("n,r,tile,step", [(1000, 5, 64, 16), (1000, 40, 128, 16),
                                           (1000, 64, 64, 16), (50, 20, 64, 16),
                                           (300, 300, 64, 16), (777, 100, 256, 32),
                                           (1000, 1, 64, 16), (1000, 37, 96, 32)])
@pytest.mark.parametrize("metric", METRICS)
def test_tiled_selection_model_matches_plain_version(n, r, tile, step, metric):
    # Duplicate rows put equal keys but for the id in other tiles; N is not a
    # multiple of the tile, N < tile and r = N occur; sums of -0.0 entries.
    # Signed tables send about half the euclidean sums to the clamp (d = 0).
    tables, codes = _tied_inputs(n + r, 3, n, 4, 16, neg_zero=True)
    t, c = torch.from_numpy(tables), torch.from_numpy(codes)
    sums = adc_scan_reference(t, c).numpy()
    got, _ = _tiled_smallest(sums, metric, r, tile, step)
    np.testing.assert_array_equal(got, adc_scan_smallest_reference(t, c, r, metric).numpy())


@pytest.mark.parametrize("n,r,tile,step", [(1000, 40, 128, 16), (1000, 64, 200, 16),
                                           (777, 100, 256, 32), (1000, 37, 96, 32)])
def test_tiled_selection_model_orders_positive_euclidean_distances(n, r, tile, step):
    # Non-negative tables, as PQ's squared-distance tables are: every
    # distance is ordered (none clamped), so the prefilter at d > 0, the
    # threshold falling across a tile and the merge all decide the result.
    tables, codes = _tied_inputs(n + r, 3, n, 4, 16, neg_zero=True, signed=False)
    t, c = torch.from_numpy(tables), torch.from_numpy(codes)
    sums = adc_scan_reference(t, c).numpy()
    assert np.all(sums >= 0)
    got, waited = _tiled_smallest(sums, "euclidean", r, tile, step)
    np.testing.assert_array_equal(
        got, adc_scan_smallest_reference(t, c, r, "euclidean").numpy())
    assert waited > 0  # keys found the new slots full and waited


def test_sum_bound_admits_every_sum_at_or_below_the_threshold():
    # The prefilter may pass rows that cannot enter, never stop one that can:
    # every sum whose finalised distance is <= d lies at or below the bound.
    rng = np.random.default_rng(12)
    scale = 10.0 ** rng.integers(-30, 30, 20000)
    s = np.concatenate([rng.standard_normal(20000) * scale,
                        [0, -1, 1, 1e-38, -1e-38, 3e38]]).astype(np.float32)
    for metric in METRICS:
        with np.errstate(over="ignore"):
            d = finalize_adc(torch.from_numpy(s), metric).numpy()
        keys = _keys(d)
        for j in rng.integers(0, len(s), 300):
            hi = _sum_bound(keys[j], metric)
            assert not np.any(s[d <= d[j]] > hi), (metric, d[j], hi)


@pytest.mark.parametrize("r,w", [(1, 16), (5, 16), (40, 64), (256, 512), (300, 512),
                                 (1000, 1024)])
def test_compaction_model_keeps_the_r_smallest(r, w):
    # Kept keys: the r smallest of an earlier batch, sorted, then empty; new
    # keys: unsorted, distinct from them (keys are unique), with empty slots.
    rng = np.random.default_rng(r + w)
    rp = 1 << int(np.ceil(np.log2(r)))
    pool = rng.choice(1 << 40, 3 * (rp + w), replace=False).astype(np.int64)
    earlier, new = pool[:rp + w], pool[rp + w:rp + 2 * w].copy()
    kept = np.full(rp, _NO_KEY, np.int64)
    kept[:r] = np.sort(earlier)[:r]
    new[rng.random(w) < 0.3] = _NO_KEY
    want = np.full(rp, _NO_KEY, np.int64)
    want[:r] = np.sort(np.concatenate([kept[:r], new]))[:r]
    np.testing.assert_array_equal(_compact(kept, new, r), want)


def test_adc_scan_smallest_on_cpu_runs_the_plain_version_uncounted():
    tables, codes = map(torch.from_numpy, _tied_inputs(4, 3, 500, 8, 32))
    before = adc_scan_smallest.launches
    for metric in METRICS:
        assert torch.equal(adc_scan_smallest(tables, codes, 50, metric),
                           adc_scan_smallest_reference(tables, codes, 50, metric))
    assert adc_scan_smallest.launches == before
    assert adc_scan_smallest(tables, codes, 0, "cosine").shape == (3, 0)
    with pytest.raises(ValueError):
        adc_scan_smallest(tables, codes, 501, "cosine")
    with pytest.raises(ValueError):
        adc_scan_smallest(tables, codes, 5, "hamming")
    with pytest.raises(TypeError):
        adc_scan_smallest(tables, codes.long(), 5, "cosine")
