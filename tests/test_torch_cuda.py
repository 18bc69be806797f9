"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA device (a kernel has no CPU
mode). The file imports neither jax nor islands_tpu, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from islands_tpu_torch.ops.adc import (
    SMALLEST_MAX_R,
    adc_scan,
    adc_scan_reference,
    adc_scan_smallest,
    adc_scan_smallest_reference,
    gated_adc_reference,
    gated_adc_sums,
    smallest_max_r,
    smallest_tiles,
)
from islands_tpu_torch.ops.gather import row_gather, row_gather_reference
from islands_tpu_torch.ops.hop_merge import HOLE, hop_merge, hop_merge_reference
from islands_tpu_torch.core.config import DistanceMetric, LeannConfig
from islands_tpu_torch.models import bert as bert_mod
from islands_tpu_torch.models import modernbert as modernbert_mod
from islands_tpu_torch.models.encoder import TextEncoder, build_model
from islands_tpu_torch.models.provider import EncoderEmbeddingProvider
from islands_tpu_torch.parallel import ArchipelagoSearcher, build_sharded, make_mesh
from islands_tpu_torch.testing import host_merge
from islands_tpu_torch.ops.pairwise import (
    pairwise_l2,
    pairwise_l2_reference,
    pairwise_neg_dot,
    pairwise_neg_dot_reference,
)


def _batch(rng, b, e, a, ties):
    """[B, E] discoveries and a [B, A] queue with the search loop's
    invariants (duplicate ids share a distance, +inf invalid slots, queue ids
    disjoint from the discoveries); `ties` puts distances on a 4-value grid."""
    n = 1 << 20
    ids = np.stack([rng.choice(n, size=e, replace=False) for _ in range(b)])
    ids[:, 1] = ids[:, 0]
    ids[:, e - 1] = ids[:, e // 2]
    d = rng.integers(0, 4, (b, e)) / 4 if ties else rng.random((b, e))
    d = d.astype(np.float32)
    d[:, 1] = d[:, 0]
    d[:, e - 1] = d[:, e // 2]
    invalid = rng.random((b, e)) < 0.25
    d = np.where(invalid, np.inf, d).astype(np.float32)
    ids = np.where(invalid, n, ids).astype(np.int32)
    aq = rng.integers(0, 4, (b, a)) / 4 if ties else rng.random((b, a))
    aqd = np.sort(aq.astype(np.float32), axis=1)
    aqd[:, a // 2 + 1:] = np.inf
    aqi = np.where(np.isinf(aqd), -1, n + 1 + np.arange(a)[None, :]).astype(np.int32)
    return [torch.from_numpy(x) for x in (d, ids, aqd, aqi)]


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("e,pw", [(120, 8), (120, 16), (120, 24), (120, 48),
                                  (240, 64), (120, 12), (7, 3)])
def test_hop_merge_kernel_matches_plain_version(e, pw, ties):
    # atol=0 and ids equal: the kernel reproduces the composition's order.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    args = [t.cuda() for t in _batch(np.random.default_rng(e + pw), 512, e, 64, ties)]
    want = hop_merge_reference(*args, pw)
    before = hop_merge.launches
    got = hop_merge(*args, pw)
    torch.cuda.synchronize()
    assert hop_merge.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _edge_batch(rng, b, e, a, kind):
    """[B, E] discoveries and a [B, A] queue at any E >= 1, distances on a
    4-value grid (ties), with one edge `kind`: "all_inf" rows, "one_id"
    rows that repeat a single id, "neg_zero" distances of -0.0 beside +0.0,
    "near_hole" ids at HOLE - 1, or "plain"."""
    n = 1 << 20
    ids = np.stack([rng.choice(n, size=e, replace=False) for _ in range(b)])
    d = (rng.integers(0, 4, (b, e)) / 4).astype(np.float32)
    if e > 1:
        ids[:, 1] = ids[:, 0]
        d[:, 1] = d[:, 0]
    if kind == "one_id":
        ids[:] = ids[:, :1]
        d[:] = d[:, :1]
    if kind == "near_hole":
        ids[:, ::2] = HOLE - 1
        d[:, ::2] = d[:, :1]
    invalid = rng.random((b, e)) < (1.0 if kind == "all_inf" else 0.25)
    d = np.where(invalid, np.inf, d).astype(np.float32)
    ids = np.where(invalid, n, ids).astype(np.int32)
    aqd = np.sort((rng.integers(0, 4, (b, a)) / 4).astype(np.float32), axis=1)
    aqd[:, a // 2 + 1:] = np.inf
    if kind == "neg_zero":
        d[:, ::2] = np.where(d[:, ::2] == 0, np.float32(-0.0), d[:, ::2])
        aqd[:, ::2] = np.where(aqd[:, ::2] == 0, np.float32(-0.0), aqd[:, ::2])
    aqi = np.where(np.isinf(aqd), -1, n + 1 + np.arange(a)[None, :]).astype(np.int32)
    return [torch.from_numpy(x).cuda() for x in (d, ids, aqd, aqi)]


def _assert_bits_equal(got, want):
    # Bit for bit: -0.0 and +0.0 differ here, as they do in the reference.
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("pw_at", ["zero", "e"])
@pytest.mark.parametrize("a", [1, 64, 128, 200])
@pytest.mark.parametrize("e", [1, 33, 100, 240])
def test_hop_merge_kernel_across_shapes(e, a, pw_at):
    # E not a power of two pads the sorts with +inf fillers; pw = 0 writes
    # no promote head, pw = E the widest one.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    pw = 0 if pw_at == "zero" else e
    args = _edge_batch(np.random.default_rng(e * 1000 + a), 300, e, a, "plain")
    want = hop_merge_reference(*args, pw)
    got = hop_merge(*args, pw)
    torch.cuda.synchronize()
    _assert_bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["all_inf", "one_id", "neg_zero", "near_hole"])
@pytest.mark.parametrize("e,a,pw", [(120, 64, 16), (240, 128, 64), (33, 1, 33), (5, 3, 2)])
def test_hop_merge_kernel_edge_rows(e, a, pw, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    args = _edge_batch(np.random.default_rng(e + a + pw), 257, e, a, kind)
    want = hop_merge_reference(*args, pw)
    got = hop_merge(*args, pw)
    torch.cuda.synchronize()
    _assert_bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("e,a,pw,route", [(120, 64, 16, "warp"), (120, 128, 24, "warp"),
                                          (256, 256, 64, "warp"), (300, 64, 16, "block"),
                                          (120, 600, 16, "block"), (1000, 24, 8, "block")])
def test_hop_merge_kernel_routes(e, a, pw, route):
    # The launcher picks the route from the shape: the warp kernel up to
    # next_pow2(E) = 256 and next_pow2(A + E) = 512, the block kernel past
    # them. The profiler names the kernel that ran.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    args = _edge_batch(np.random.default_rng(e + a), 130, e, a, "plain")
    want = hop_merge_reference(*args, pw)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = hop_merge(*args, pw)
        torch.cuda.synchronize()
    _assert_bits_equal(got, want)
    names = [ev.key for ev in prof.key_averages() if "hop_merge_" in ev.key]
    assert names and all(f"hop_merge_{route}_kernel" in k for k in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("pw", [16, 24, 32])
def test_hop_merge_kernel_at_the_two_level_queue_width(pw, ties):
    # The two-level hop runs K1 at A = aq_width = 128 (ef 128), E = 120.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    args = [t.cuda() for t in _batch(np.random.default_rng(pw), 512, 120, 128, ties)]
    want = hop_merge_reference(*args, pw)
    got = hop_merge(*args, pw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _adc_inputs(rng, b, s, k, rows, dtype=np.uint8):
    """Tables [B, S, K] and codes of `dtype` and `rows` shape + [S], with
    codes 0 and K-1 present."""
    tables = rng.standard_normal((b, s, k)).astype(np.float32)
    codes = rng.integers(0, k, size=(*rows, s)).astype(dtype)
    flat = codes.reshape(-1, s)
    if flat.shape[0] >= 2:
        flat[0] = 0
        flat[1] = k - 1
    return torch.from_numpy(tables).cuda(), torch.from_numpy(codes).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("b,e,s,k", [(4096, 120, 16, 256), (4096, 240, 16, 256),
                                     (24, 70, 8, 64), (5, 33, 16, 256), (0, 120, 16, 256),
                                     (7, 0, 16, 256)])
def test_gated_adc_kernel_matches_plain_version(b, e, s, k):
    # Bit for bit: the kernel and the plain version both round the tables
    # to bf16 and sum in f32 in s order.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    tables, codes = _adc_inputs(np.random.default_rng(b + e), b, s, k, (b, e))
    want = gated_adc_reference(tables, codes)
    before = gated_adc_sums.launches
    got = gated_adc_sums(tables, codes)
    torch.cuda.synchronize()
    assert got.shape == (b, e)
    assert gated_adc_sums.launches == before + (1 if b * e else 0)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,s,k", [(512, 1_000_000, 16, 256), (3, 1000, 8, 32),
                                     (9, 4099, 16, 256), (0, 100, 16, 256), (4, 0, 16, 256)])
def test_adc_scan_kernel_matches_plain_version(b, n, s, k):
    # Bit for bit in full f32, summed in s order.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    tables, codes = _adc_inputs(np.random.default_rng(b + n), b, s, k, (n,))
    want = adc_scan_reference(tables, codes)
    before = adc_scan.launches
    got = adc_scan(tables, codes)
    torch.cuda.synchronize()
    assert got.shape == (b, n)
    assert adc_scan.launches == before + (1 if b * n else 0)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,s,k", [(512, 100_000, 16, 512), (5, 4099, 16, 512),
                                     (3, 1000, 8, 4096)])
def test_adc_scan_kernel_takes_int32_codes(b, n, s, k):
    # The quantizer's codes above 256 centroids are int32; K3 reads them
    # too (one query per block once four tables pass its shared memory).
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    tables, codes = _adc_inputs(np.random.default_rng(k + n), b, s, k, (n,), np.int32)
    want = adc_scan_reference(tables, codes)
    before = adc_scan.launches
    got = adc_scan(tables, codes)
    torch.cuda.synchronize()
    assert adc_scan.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_adc_scan_kernel_refuses_tables_past_shared_memory():
    # 16 x 4096 f32 entries are 256 KB, past the 227 KB a block can hold.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    tables, codes = _adc_inputs(np.random.default_rng(0), 2, 16, 4096, (10,), np.int32)
    with pytest.raises(RuntimeError):
        adc_scan(tables, codes)


def _smallest_inputs(rng, b, s, k, n, dtype, kind):
    """Tables and codes [N, S] for K3's "smallest" route. "normal": randn
    tables, about half of all sums <= 0 (the euclidean clamp sends them to
    0); "square": squared randn, non-negative as PQ's squared-distance tables
    are, so the euclidean distances are positive and ordered; "tied" and
    "tied+": multiples of 1/4 in [-2, 2) and [0, 2), with -0.0 beside +0.0
    (many equal distances), and codes in which every seventh row repeats a
    row far away (equal keys but for the id, in other tiles)."""
    if kind in ("normal", "square"):
        t, c = _adc_inputs(rng, b, s, k, (n,), dtype)
        return (t * t if kind == "square" else t), c
    tables = (rng.integers(-8 if kind == "tied" else 0, 8, (b, s, k)) / 4).astype(np.float32)
    zero = tables == 0
    tables[zero] = np.where(rng.random(np.sum(zero)) < 0.5, -0.0, 0.0)
    codes = rng.integers(0, k, (n, s)).astype(dtype)
    codes[::7] = codes[rng.integers(0, n, len(codes[::7]))]
    return torch.from_numpy(tables).cuda(), torch.from_numpy(codes).cuda()


# (B, N, S, K, code type, r, metric, tables): the PQ scan's shape at rerank
# 128 and 256, N below one tile, r = N, B = 4096, int32 codes, S = 8, both
# sides of SMALLEST_MAX_R; tables as _smallest_inputs makes them. Euclidean
# cases take non-negative tables but one each of "normal" and "tied", which
# exercise the clamp.
SMALLEST_CASES = [
    (512, 1_000_000, 16, 256, np.uint8, 256, "euclidean", "square"),
    (512, 1_000_000, 16, 256, np.uint8, 128, "euclidean", "tied+"),
    (7, 5000, 16, 256, np.uint8, 100, "cosine", "tied"),
    (3, 700, 16, 256, np.uint8, 700, "dotproduct", "tied"),
    (4096, 65536, 16, 256, np.uint8, 256, "euclidean", "square"),
    (33, 40000, 16, 512, np.int32, 64, "manhattan", "tied"),
    (9, 20000, 8, 256, np.uint8, 200, "euclidean", "tied"),
    (9, 20000, 8, 256, np.uint8, 200, "euclidean", "tied+"),
    (11, 300_000, 16, 256, np.uint8, 256, "euclidean", "normal"),
    (5, 100_000, 16, 256, np.uint8, 1, "cosine", "normal"),
    (17, 50000, 16, 256, np.uint8, SMALLEST_MAX_R, "euclidean", "tied+"),
    (17, 50000, 16, 256, np.uint8, SMALLEST_MAX_R + 1, "euclidean", "tied+"),
    (6, 33000, 16, 256, np.uint8, 300, "dotproduct", "normal"),
    (6, 33000, 16, 256, np.uint8, 300, "manhattan", "tied"),
    (6, 33000, 16, 256, np.uint8, 300, "cosine", "tied"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,s,k,dtype,r,metric,tables", SMALLEST_CASES)
def test_adc_scan_smallest_kernel_matches_plain_version(b, n, s, k, dtype, r, metric, tables):
    # The same positions in the same order, ties included. r <= SMALLEST_MAX_R
    # launches the route's own kernel; a larger r the "sums" kernel.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    rng = np.random.default_rng(b + n + r)
    t, c = _smallest_inputs(rng, b, s, k, n, dtype, tables)
    want = adc_scan_smallest_reference(t, c, r, metric)
    before = adc_scan_smallest.launches, adc_scan.launches
    got = adc_scan_smallest(t, c, r, metric)
    torch.cuda.synchronize()
    own = r <= SMALLEST_MAX_R
    assert (adc_scan_smallest.launches, adc_scan.launches) == (before[0] + own,
                                                               before[1] + (not own))
    assert got.dtype == torch.int64 and got.shape == (b, r)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_adc_scan_smallest_largest_r_is_the_kernels():
    # SMALLEST_MAX_R states the kernel's kMaxR, which decides the route.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    assert smallest_max_r() == SMALLEST_MAX_R
    assert smallest_tiles(4, 5000, 16, 256, SMALLEST_MAX_R) > 0
    assert smallest_tiles(4, 5000, 16, 256, SMALLEST_MAX_R + 1) == 0


@pytest.mark.cuda
def test_adc_scan_smallest_kernel_on_empty_and_wide_inputs():
    # B = 0 and r = 0 launch nothing; int32 tables of one query per block.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    t, c = _adc_inputs(np.random.default_rng(3), 0, 16, 256, (100,))
    assert adc_scan_smallest(t, c, 10, "euclidean").shape == (0, 10)
    t, c = _adc_inputs(np.random.default_rng(4), 3, 16, 256, (100,))
    assert adc_scan_smallest(t, c, 0, "euclidean").shape == (3, 0)
    t, c = _adc_inputs(np.random.default_rng(5), 6, 8, 4096, (30000,), np.int32)
    got = adc_scan_smallest(t, c, 500, "dotproduct")
    torch.cuda.synchronize()
    assert torch.equal(got, adc_scan_smallest_reference(t, c, 500, "dotproduct"))


def _pairwise_inputs(rng, b, n, d):
    """q [B, d], x [N, d] on the card, with x's first rows equal to q's (their
    squared distances cancel to about 0 and must clamp to >= 0)."""
    q = rng.standard_normal((b, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    dup = min(b, n, 16)
    x[:dup] = q[:dup]
    return torch.from_numpy(q).cuda(), torch.from_numpy(x).cuda()


def assert_pairwise_close(got, want, q, x, mode):
    """K4 against its plain version. The two sum in different orders, so
    the squared form is held within 1e-5 * (|q|^2 + |x|^2), the sqrt form by
    the square root of that bound (|sqrt(a) - sqrt(b)| <= sqrt(|a - b|), so
    no relative error is taken near 0) and neg-dot within 1e-5 * |q| * |x|:
    about 100 float32 ulps of the terms' scale, far above the rounding of
    either order at d <= 1024."""
    qn = torch.sum(q.double() * q.double(), dim=1).float()
    xn = torch.sum(x.double() * x.double(), dim=1).float()
    if mode == "neg_dot":
        tol = 1e-5 * torch.sqrt(qn)[:, None] * torch.sqrt(xn)[None, :]
    else:
        tol = 1e-5 * (qn[:, None] + xn[None, :])
        if mode == "l2":
            tol = torch.sqrt(tol)
        assert bool((got >= 0).all())
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())


def _pairwise(mode, q, x, kernel):
    if mode == "neg_dot":
        return (pairwise_neg_dot(q, x, use_kernel=True) if kernel
                else pairwise_neg_dot_reference(q, x))
    squared = mode == "l2_squared"
    return (pairwise_l2(q, x, squared=squared, use_kernel=True) if kernel
            else pairwise_l2_reference(q, x, squared=squared))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l2", "l2_squared", "neg_dot"])
@pytest.mark.parametrize("b,n,d", [(4096, 65536, 128), (512, 20000, 128), (1000, 10000, 32),
                                   (1000, 10000, 512), (1000, 10000, 1024), (5, 7, 8),
                                   (33, 130, 13), (9, 11, 7), (0, 7, 16), (5, 0, 16)])
def test_pairwise_kernel_matches_plain_version(b, n, d, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    q, x = _pairwise_inputs(np.random.default_rng(b + n + d), b, n, d)
    wrapper = pairwise_neg_dot if mode == "neg_dot" else pairwise_l2
    before = wrapper.launches
    got = _pairwise(mode, q, x, kernel=True)
    want = _pairwise(mode, q, x, kernel=False)
    torch.cuda.synchronize()
    assert wrapper.launches == before + (1 if b * n else 0)
    assert_pairwise_close(got, want, q, x, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l2", "l2_squared", "neg_dot"])
@pytest.mark.parametrize("d", [1, 3, 4, 9, 33, 127])
def test_pairwise_kernel_at_odd_depths(d, mode):
    # d % 4 != 0 takes the kernel's 4-byte copies; d = 33 and 127 leave a
    # ragged last slice of 32; B and N are ragged against the 128 x 128 tiles.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    q, x = _pairwise_inputs(np.random.default_rng(d), 200, 333, d)
    got = _pairwise(mode, q, x, kernel=True)
    want = _pairwise(mode, q, x, kernel=False)
    torch.cuda.synchronize()
    assert_pairwise_close(got, want, q, x, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l2", "l2_squared", "neg_dot"])
@pytest.mark.parametrize("d,offset", [(16, "row"), (7, "row"), (128, "element")])
def test_pairwise_kernel_on_offset_views(d, offset, mode):
    # Contiguous views that start past their storage: one row in (16-byte
    # aligned only when d % 4 == 0) or one float in (never aligned), so
    # the kernel takes its 4-byte copy route at d = 128 too.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    rng = np.random.default_rng(d)
    b, n = 130, 260
    if offset == "row":
        q = torch.from_numpy(rng.standard_normal((b + 1, d)).astype(np.float32)).cuda()[1:]
        x = torch.from_numpy(rng.standard_normal((n + 1, d)).astype(np.float32)).cuda()[1:]
    else:
        q = torch.from_numpy(rng.standard_normal(b * d + 1).astype(np.float32)).cuda()[1:]
        x = torch.from_numpy(rng.standard_normal(n * d + 1).astype(np.float32)).cuda()[1:]
        q, x = q.view(b, d), x.view(n, d)
    assert q.is_contiguous() and x.is_contiguous()
    if offset == "element" or d % 4:
        assert q.data_ptr() % 16 and x.data_ptr() % 16
    got = _pairwise(mode, q, x, kernel=True)
    want = _pairwise(mode, q, x, kernel=False)
    torch.cuda.synchronize()
    assert_pairwise_close(got, want, q, x, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l2", "l2_squared", "neg_dot"])
@pytest.mark.parametrize("scale", [1e-3, 1e3])
@pytest.mark.parametrize("d", [128, 768])
def test_pairwise_kernel_with_scaled_operands(d, scale, mode):
    # The 3xTF32 split keeps float32's exponent range, so the error stays
    # relative to the operands' norms at either scale.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    q, x = _pairwise_inputs(np.random.default_rng(d), 300, 500, d)
    q, x = q * scale, x * scale
    got = _pairwise(mode, q, x, kernel=True)
    want = _pairwise(mode, q, x, kernel=False)
    torch.cuda.synchronize()
    assert_pairwise_close(got, want, q, x, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l2", "l2_squared", "neg_dot"])
@pytest.mark.parametrize("d", [128, 1024])
def test_pairwise_kernel_with_duplicate_rows(d, mode):
    # Every x row repeats a q row, some with large norms: their squared
    # distances cancel to about 0 and must clamp to >= 0.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    rng = np.random.default_rng(d + 1)
    qn = rng.standard_normal((256, d)).astype(np.float32)
    qn[::7] *= 1e3
    xn = qn[rng.integers(0, 256, 700)]
    q, x = torch.from_numpy(qn).cuda(), torch.from_numpy(xn).cuda()
    got = _pairwise(mode, q, x, kernel=True)
    want = _pairwise(mode, q, x, kernel=False)
    torch.cuda.synchronize()
    assert_pairwise_close(got, want, q, x, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,dtype", [(1_000_000, 128, 131072, np.float32),
                                         (1_000_000, 128, 1000, np.float32),
                                         (1000, 7, 333, np.float32), (4096, 480, 4099, np.int32),
                                         (1000, 128, 0, np.float32)])
def test_row_gather_kernel_matches_plain_version(n, d, k, dtype):
    # Bit for bit, with ids below 0 and past N clamped in both.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (n, d), dtype=np.int64)
                         .astype(np.int32).view(dtype)).cuda()
    ids = rng.integers(-5, n + 5, k).astype(np.int32)
    ids = torch.from_numpy(ids).cuda()
    before = row_gather.launches
    got = row_gather(x, ids)
    want = row_gather_reference(x, ids)
    torch.cuda.synchronize()
    assert row_gather.launches == before + (1 if k else 0)
    assert got.shape == (k, d)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dotproduct"])
def test_exact_distances_stay_full_f32_with_caller_tf32(metric):
    # A caller that turns matmul TF32 on gets the same exact distances and
    # top-k as with it off, within float32 rounding of a float64 oracle, and
    # keeps its own setting.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from islands_tpu_torch.core.config import DistanceMetric
    from islands_tpu_torch.ops.distance import brute_force_topk, pairwise_distance

    m = DistanceMetric(metric)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((256, 128), generator=gen, device="cuda") + 3.0
    x = torch.randn((20000, 128), generator=gen, device="cuda") + 3.0
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        want_d = pairwise_distance(q, x, m)
        want_topk = brute_force_topk(q, x, 10, m, batch=4096)
        torch.backends.cuda.matmul.allow_tf32 = True
        got_d = pairwise_distance(q, x, m)
        got_topk = brute_force_topk(q, x, 10, m, batch=4096)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        # What TF32 itself would give: visibly off the float64 oracle.
        tf32 = q @ x.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    torch.cuda.synchronize()
    assert torch.equal(got_d, want_d)
    assert torch.equal(got_topk[0], want_topk[0]) and torch.equal(got_topk[1], want_topk[1])
    q64, x64 = q.double(), x.double()
    dot64 = q64 @ x64.T
    if metric == "euclidean":
        exact = torch.cdist(q64, x64)
    elif metric == "cosine":
        exact = 1.0 - dot64 / (q64.norm(dim=1)[:, None] * x64.norm(dim=1)[None, :])
    else:
        exact = -dot64
    scale = max(float(exact.abs().max()), 1.0)
    assert float((got_d.double() - exact).abs().max()) <= 1e-5 * scale
    assert float((tf32.double() - dot64).abs().max()) > 1e-5 * float(dot64.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("gate,knobs", [
    ("sketch", dict(expand_width=2, promote_width=16, max_iters=12, final_rescore=64)),
    ("sketch", dict(expand_width=2, promote_width=48, max_iters=10)),
    ("exact", dict())])
def test_archipelago_on_the_card(gate, knobs):
    """Two shards on one card: the fused hop-merge (kernel K1, launched)
    equals the inline one, and the merged top-k equals a host merge of the
    per-shard results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; kernel K1 has no CPU mode")
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(64, 32))
    x = (centers[rng.integers(0, 64, 20000)] + 0.8 * rng.normal(size=(20000, 32)))
    q = (centers[rng.integers(0, 64, 256)] + 0.8 * rng.normal(size=(256, 32)))
    cfg = LeannConfig(metric=DistanceMetric.EUCLIDEAN, m=8, m0=16, ef_construction=48,
                      wave_size=1024, reverse_slack=16, intra_wave_k=8, routing_size=2048)
    idx = build_sharded(x.astype(np.float32), cfg, make_mesh(2, 1, devices=["cuda"]))
    s = ArchipelagoSearcher(idx)
    kw = dict(k=10, ef=32, gate=gate, **knobs)
    before = hop_merge.launches
    d, i = s.search(q, hop_merge="fused", **kw)
    torch.cuda.synchronize()
    assert (hop_merge.launches > before) == (gate == "sketch")
    d_in, i_in = s.search(q, hop_merge="inline", **kw)
    assert torch.equal(d, d_in) and torch.equal(i, i_in)
    want_d, want_i = host_merge(*s.search_shards(q, hop_merge="fused", **kw), idx.gids,
                                idx.counts, 10)
    np.testing.assert_array_equal(i.cpu().numpy(), want_i)
    np.testing.assert_array_equal(d.cpu().numpy(), want_d)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [[], ["--ef", "128", "--max-iters", "16",
                                        "--promote-width", "16"]])
def test_cli_query_on_the_card(knobs, tmp_path, capsys):
    """The CLI's build --pq and query on the card (its default device): the
    query launches K2 at the CLI path's E = 240 (--m 30 gives max_degree
    60, times expand_width 4) and returns the ids and distances of
    search_two_level with the same knobs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; kernel K2 has no CPU mode")
    import json

    from islands_tpu_torch import cli
    from islands_tpu_torch.core.embedding import InMemoryEmbeddingProvider
    from islands_tpu_torch.core.storage import load_index

    rng = np.random.default_rng(8)
    x = rng.standard_normal((4096, 64)).astype(np.float32)
    q = rng.standard_normal((128, 64)).astype(np.float32)
    xp, qp, out = (str(tmp_path / n) for n in ("x.npy", "q.npy", "i.leann"))
    np.save(xp, x)
    np.save(qp, q)
    assert cli.main(["build", xp, "-o", out, "--metric", "euclidean", "--pq",
                     "--pq-subquantizers", "16"]) == 0
    capsys.readouterr()
    before = gated_adc_sums.launches
    assert cli.main(["query", out, xp, qp] + knobs) == 0
    got = json.loads(capsys.readouterr().out)
    assert gated_adc_sums.launches > before
    idx = load_index(out)
    assert idx.graph.max_degree * idx.config.expand_width == 240
    kw = dict(zip(("ef", "max_iters", "promote_width"), map(int, knobs[1::2])))
    d, i = idx.search_two_level(q, k=10, provider=InMemoryEmbeddingProvider(x), **kw)
    assert got["ids"] == i.cpu().numpy().tolist()
    assert got["distances"] == d.cpu().numpy().tolist()


@pytest.mark.cuda
def test_span_waits_for_the_device():
    """span(block_on=...) over a launch queued behind ~2 ms of device work
    records at least the device time between events around it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from islands_tpu_torch.utils.tracing import metrics, span

    tables, codes = _adc_inputs(np.random.default_rng(12), 4096, 16, 256, (4096, 240))
    gated_adc_sums(tables, codes)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    with span("test.k2", block_on={"out": out}):
        start.record()
        torch.cuda._sleep(4_000_000)
        out.append(gated_adc_sums(tables, codes))
        stop.record()
    torch.cuda.synchronize()
    assert metrics.snapshot()["timings"]["test.k2"]["total_s"] * 1e3 >= start.elapsed_time(stop)


@pytest.mark.cuda
def test_modernbert_base_on_the_card():
    """modernbert-base at its published width (22 layers, hidden 768, a
    window of 128): the card's bfloat16 pooled rows against the port's
    float32 forward on the CPU from the same seeded weights, within
    chip_smoke.py's cosine bounds (smallest raw cosine 0.999, smallest
    cosine after both sides subtract the CPU rows' mean 0.99), at seq 256
    with padded rows; and the recompute provider's rows for a set of ids
    equal bert.encode of the same token rows on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = modernbert_mod.ModernBertConfig.modernbert_base()
    params = modernbert_mod.init_params(cfg, 0)
    enc = TextEncoder(params, cfg)
    cpu = build_model(params, dataclasses.replace(cfg, dtype="float32"), "cpu")
    rng = np.random.default_rng(21)
    slen = 256
    ids = rng.integers(1, cfg.vocab_size, size=(8, slen))
    lens = np.array([slen, 200, slen, 131, 64, slen, 250, 129])
    mask = (np.arange(slen)[None, :] < lens[:, None]).astype(np.int32)
    ids, mask = torch.from_numpy((ids * mask).astype(np.int32)), torch.from_numpy(mask)
    got = bert_mod.encode(enc.model, ids.cuda(), mask.cuda()).cpu().double()
    want = bert_mod.encode(cpu, ids, mask).double()
    mu = want.mean(dim=0)
    assert float(F.cosine_similarity(got, want, dim=1).min()) >= 0.999
    assert float(F.cosine_similarity(got - mu, want - mu, dim=1).min()) >= 0.99

    prov = EncoderEmbeddingProvider(enc, ids, mask)
    pick = torch.tensor([[3, 0, 5], [7, 3, 1]], device="cuda")
    rows = prov.embed(pick)
    flat = pick.reshape(-1)
    direct = bert_mod.encode(enc.model, prov.token_ids[flat], prov.token_mask[flat])
    assert rows.shape == (2, 3, cfg.hidden_size)
    assert torch.equal(rows.reshape(-1, cfg.hidden_size), direct)


# -- the sketch gate's hop replayed as a CUDA graph --------------------------

P16 = dict(gate="sketch", ef=32, promote_width=16, max_iters=12, expand_width=2)


@pytest.fixture(scope="module")
def graph_searcher():
    """A 32,768 x 128 stored index under the sketch gate, on the card, and
    4,096 queries near its rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from islands_tpu_torch.core.build import build_index_with_sketch
    from islands_tpu_torch.core.search import StoredSearcher

    rng = np.random.default_rng(17)
    centres = rng.standard_normal((256, 128)).astype(np.float32) * 4
    x = centres[rng.integers(0, 256, 32768)] + rng.standard_normal((32768, 128))
    q = centres[rng.integers(0, 256, 4096)] + rng.standard_normal((4096, 128))
    cfg = LeannConfig(metric=DistanceMetric.EUCLIDEAN, wave_size=4096, sketch_dims=48,
                      ef_construction=64, reverse_slack=20)
    x = torch.from_numpy(x.astype(np.float32)).cuda()
    graph, sketch = build_index_with_sketch(x, cfg, device="cuda")
    searcher = StoredSearcher(graph, x, cfg.metric, sketch=sketch, routing_size=4096,
                              device="cuda")
    return searcher, torch.from_numpy(q.astype(np.float32)).cuda()


def _gated_call(searcher, q, kw, monkeypatch, graphs):
    """One search through the graph cache `graphs` (None: eager). ->
    (dists, ids, n_exact, K1 launches, tracing counters)."""
    from islands_tpu_torch.core import search as search_mod
    from islands_tpu_torch.utils import tracing

    got = []
    real = search_mod.batched_sketch_gated_query

    def spy(*a, **k):
        out = real(*a, **k)
        got.append(out[2])
        return out

    monkeypatch.setattr(search_mod, "batched_sketch_gated_query", spy)
    monkeypatch.setattr(searcher, "_hop_graphs", graphs)
    before = hop_merge.launches
    tracing.reset()
    tracing.enable()
    try:
        d, ids = searcher.search(q, k=10, **kw)
        torch.cuda.synchronize()
    finally:
        tracing.disable()
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    monkeypatch.setattr(search_mod, "batched_sketch_gated_query", real)
    return d, ids, got[0], hop_merge.launches - before, counters


@pytest.mark.cuda
@pytest.mark.parametrize("final_rescore", [0, 64])
@pytest.mark.parametrize("mode", ["fused", "inline"])
@pytest.mark.parametrize("b", [1, 4096])
def test_hop_graph_answers_as_the_eager_hops(graph_searcher, b, mode, final_rescore,
                                             monkeypatch):
    """Graphed and eager StoredSearcher.search agree bit for bit (ids,
    distances, n_exact) on the capturing call and on a replaying one; the
    replays count the eager route's K1 launches, and one
    `search.hop.graphed` per `search.hops`."""
    from islands_tpu_torch.core.search import HOP_GRAPHS_KEPT
    from islands_tpu_torch.utils.graphs import GraphCache

    searcher, q = graph_searcher
    kw = dict(P16, hop_merge=mode, final_rescore=final_rescore)
    graphs = GraphCache(kept=HOP_GRAPHS_KEPT)
    for part in (q[:b], q.flip(0)[:b]):
        want = _gated_call(searcher, part, kw, monkeypatch, None)
        got = _gated_call(searcher, part, kw, monkeypatch, graphs)
        for w, g in zip(want[:3], got[:3]):
            assert torch.equal(w, g)
        assert got[3] == want[3] == (want[4]["search.hops"] if mode == "fused" else 0)
        assert got[4]["search.hop.graphed"] == got[4]["search.hops"] == want[4]["search.hops"]
        assert "search.hop.graphed" not in want[4]
    assert list(graphs._graphs) == [(b, 32, 64, 16, 2, mode)]


@pytest.mark.cuda
def test_hop_graph_per_batch_size_and_answers_outlive_the_next_call(graph_searcher,
                                                                   monkeypatch):
    from islands_tpu_torch.core.search import HOP_GRAPHS_KEPT
    from islands_tpu_torch.utils.graphs import GraphCache

    searcher, q = graph_searcher
    kw = dict(P16, hop_merge="fused")
    graphs = GraphCache(kept=HOP_GRAPHS_KEPT)
    first = _gated_call(searcher, q[:64], kw, monkeypatch, graphs)
    kept = [t.clone() for t in first[:3]]
    second = _gated_call(searcher, q[64:96], kw, monkeypatch, graphs)
    assert list(graphs._graphs) == [(64, 32, 64, 16, 2, "fused"), (32, 32, 64, 16, 2, "fused")]
    third = _gated_call(searcher, q[96:160], kw, monkeypatch, graphs)
    for t, k in zip(first[:3], kept):
        assert torch.equal(t, k)
    assert not torch.equal(third[1], first[1])
    assert second[1].shape == (32, 10)


@pytest.mark.cuda
def test_hop_graph_replays_show_hop_merge_in_the_profiler(graph_searcher, monkeypatch):
    """The benchmark's k1_roofline_pct finds K1 by name in torch.profiler's
    device events: a replayed hop's kernels must still be recorded."""
    from torch.autograd import DeviceType

    from islands_tpu_torch.core.search import HOP_GRAPHS_KEPT
    from islands_tpu_torch.utils.graphs import GraphCache

    searcher, q = graph_searcher
    kw = dict(P16, hop_merge="fused", final_rescore=64)
    graphs = GraphCache(kept=HOP_GRAPHS_KEPT)
    _gated_call(searcher, q, kw, monkeypatch, graphs)  # captures
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, _, _, launches, counters = _gated_call(searcher, q, kw, monkeypatch, graphs)
    assert counters["search.hop.graphed"] == launches > 0
    k1 = [e for e in prof.events()
          if e.device_type == DeviceType.CUDA and "hop_merge" in e.name]
    assert len(k1) == launches
    assert all(e.time_range.end > e.time_range.start for e in k1)


# -- LEANN's recompute hop replayed as two graphs around the provider --------


class _CountingProvider:
    """Counts the wrapped provider's `embed` calls, as a caller's wrapper
    (the benchmark's timed provider) would."""

    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def embed(self, ids):
        self.calls += 1
        return self.inner.embed(ids)


@pytest.fixture(scope="module", params=["bert", "modernbert"])
def recompute_index(request):
    """A 2,048-row LEANN index over a small seeded bfloat16 encoder behind the
    centred provider, on the card, and 16 centred query embeddings. Rows are
    64-token chunks of 8 to 64 valid tokens drawn around 64 prototypes; the
    ModernBERT provider packs them, reading their lengths to the host in
    every `embed`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from islands_tpu_torch.core.leann import LeannIndex
    from islands_tpu_torch.models.encoder import EncoderConfig, architecture_module

    if request.param == "modernbert":
        # heads of 32, the kernel's least head size
        mc = dataclasses.replace(modernbert_mod.ModernBertConfig.tiny_test(), hidden_size=128,
                                 intermediate_size=192)
    else:
        mc = bert_mod.BertConfig.tiny_test()
    mc = dataclasses.replace(mc, dtype="bfloat16")
    enc = TextEncoder(architecture_module(mc).init_params(mc, 3), mc,
                      config=EncoderConfig(normalize=False), device="cuda")
    rng = np.random.default_rng(23)
    protos = rng.integers(1, mc.vocab_size, size=(64, 64))

    def rows(n):
        ids = protos[rng.integers(0, 64, n)]
        ids = np.where(rng.random(ids.shape) < 0.3, rng.integers(1, mc.vocab_size, ids.shape),
                       ids)
        mask = (np.arange(64)[None, :] < rng.integers(8, 65, n)[:, None]).astype(np.int32)
        return torch.from_numpy((ids * mask).astype(np.int32)), torch.from_numpy(mask)

    prov = EncoderEmbeddingProvider(enc, *rows(2048)).with_center(sample=1024)
    assert enc.packed == (request.param == "modernbert")
    cfg = LeannConfig(metric=DistanceMetric.COSINE, wave_size=512, sketch_query=True,
                      sketch_dims=32, routing_size=1024)
    idx = LeannIndex(cfg, device="cuda").build(prov)
    q = enc.encode_tokens(*(t.cuda() for t in rows(16))) - prov.center
    return idx, prov, q


def _recompute_call(idx, q, prov):
    """One sketch-gated i36 search -> (dists, ids, counters, embed calls,
    packed tokens encoded)."""
    from islands_tpu_torch.utils import tracing

    calls, tokens = prov.calls, modernbert_mod.forward_packed.tokens_encoded
    tracing.reset()
    tracing.enable()
    try:
        d, ids = idx.search(q, k=10, provider=prov, gate="sketch", ef=48, promote_width=32,
                            max_iters=36)
        torch.cuda.synchronize()
    finally:
        tracing.disable()
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    return (d, ids, counters, prov.calls - calls,
            modernbert_mod.forward_packed.tokens_encoded - tokens)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 16])
def test_split_hop_graph_answers_as_the_eager_route(recompute_index, b):
    """LeannIndex.search's two graphs a hop around the provider's eager
    `embed` agree bit for bit with the eager hops (dists, ids, rows scored
    exactly), on the capturing call and on a replaying one; `embed` runs
    once a hop plus the route's call on both routes, and the packed
    ModernBERT provider encodes the same tokens."""
    from islands_tpu_torch.core.search import HOP_GRAPHS_KEPT
    from islands_tpu_torch.utils.graphs import GraphCache

    idx, prov, q = recompute_index
    counting = _CountingProvider(prov)
    graphs = GraphCache(kept=HOP_GRAPHS_KEPT)
    try:
        for part in (q[:b], q.flip(0)[:b]):
            idx._hop_graphs = None
            want = _recompute_call(idx, part, counting)
            idx._hop_graphs = graphs
            got = _recompute_call(idx, part, counting)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            hops = want[2]["search.hops"]
            assert got[2]["search.exact_rows"] == want[2]["search.exact_rows"]
            assert got[2]["search.hop.graphed"] == got[2]["search.hops"] == hops > 0
            assert got[3] == want[3] == hops + 1
            assert got[4] == want[4]
            assert (want[4] > 0) == prov.encoder.packed
    finally:
        idx._hop_graphs = GraphCache(kept=HOP_GRAPHS_KEPT)
    assert len(graphs._graphs) == 1


# -- the padded BERT encode replayed as one CUDA graph a shape ---------------


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 2048])
def test_encode_graph_answers_as_the_eager_encode(rows, monkeypatch):
    """MiniLM-L6's widths in bfloat16 (the codesearch cells' encoder): the
    replayed encode equals the eager one bit for bit at [rows, 64], on the
    shape's first (eager) call, the capturing call and a replaying one,
    centred (raw) and normalized. The graph holds the same kernels on the
    same buffers' shapes, so no rounding may differ. [2,048, 64] is above
    ENCODE_GRAPH_ELEMENTS, so the bound is raised for it here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from islands_tpu_torch.utils import tracing

    monkeypatch.setattr(bert_mod, "ENCODE_GRAPH_ELEMENTS", 1 << 28)

    cfg = bert_mod.BertConfig.minilm_l6()
    model = build_model(bert_mod.init_params(cfg, 0), cfg, "cuda")
    graphs = model.encode_graphs
    assert graphs is not None and graphs.kept == bert_mod.ENCODE_GRAPHS_KEPT
    rng = np.random.default_rng(rows)
    for normalize in (False, True):
        for i in range(3):
            ids = rng.integers(1000, 29000, size=(rows, 64))
            mask = (np.arange(64)[None, :] < rng.integers(32, 65, rows)[:, None])
            ids = torch.from_numpy((ids * mask).astype(np.int32)).cuda()
            mask = torch.from_numpy(mask.astype(np.int32)).cuda()
            model.encode_graphs = None
            want = bert_mod.encode(model, ids, mask, normalize)
            model.encode_graphs = graphs
            tracing.reset()
            tracing.enable()
            try:
                got = bert_mod.encode(model, ids, mask, normalize)
            finally:
                tracing.disable()
            counters = tracing.snapshot()["counters"]
            tracing.reset()
            gap = float((got - want).abs().max())
            assert torch.equal(got, want), f"largest difference {gap}"
            assert counters == ({"encoder.graphed": 1} if i else {})
    assert list(graphs._graphs) == [(rows, 64, False), (rows, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 16])
def test_split_hop_graph_with_encoder_graphs_answers_as_eager(recompute_index, b):
    """LeannIndex.search's sketch gate (hop graphs on) returns the same
    dists and ids with the encoder's graphs as without, on the capturing
    call and a replaying one; every `embed` of a BERT provider (one a hop
    and the route's) replays one encode graph but for each shape's first
    call, and the packed ModernBERT provider takes none."""
    idx, prov, q = recompute_index
    model = prov.encoder.model
    kept = getattr(model, "encode_graphs", None)
    assert (kept is None) == prov.encoder.packed
    graphs = None if kept is None else bert_mod.new_encode_graphs()
    counting = _CountingProvider(prov)
    try:
        for n, part in enumerate((q[:b], q.flip(0)[:b])):
            if graphs is not None:
                model.encode_graphs = None
            want = _recompute_call(idx, part, counting)
            if graphs is not None:
                model.encode_graphs = graphs
            got = _recompute_call(idx, part, counting)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            hops = got[2]["search.hops"]
            assert "encoder.graphed" not in want[2]
            assert got[2].get("encoder.graphed", 0) == (
                0 if graphs is None else hops - 1 if n == 0 else hops + 1)
    finally:
        if kept is not None:
            model.encode_graphs = kept


# -- Mellum: causal grouped-query varlen attention and the grouped expert GEMM --

MELLUM_LENGTHS = [1, 48, 104, 192, 17, 1100, 2500, 64]


def _seg_rel_err(got, want, lengths):
    """Each segment's ||got - want|| / ||want|| (float64)."""
    out, s = [], 0
    for n in lengths:
        g, w = got[s:s + n].double(), want[s:s + n].double()
        out.append(float((g - w).norm() / w.norm().clamp(min=1e-30)))
        s += n
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sliding_attention", "full_attention"])
def test_varlen_attn_causal_gqa_matches_plain_version(kind):
    """Mellum's attention (32 query heads, 4 key heads of 128, causal; the
    sliding kind within a window of 1,024, the full kind with YaRN's tables
    and their magnitude factor) on segments of 1-2,500 tokens against the
    plain version on the same bf16 inputs. Each segment's relative error
    stays under 5e-3, as for ModernBERT's modes (tests/test_torch_varlen_cuda.py):
    q, k after RoPE and the output are rounded to bf16 on both sides
    (2^-9 / sqrt(3) a side), and the kernel rounds the probabilities to bf16
    before the value product (about 2^-9 again). A key block dropped or the
    causal edge moved by one reads far above it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    from islands_tpu_torch.models import mellum
    from islands_tpu_torch.ops import varlen_attention as va

    cfg = mellum.MellumConfig()
    t = sum(MELLUM_LENGTHS)
    gen = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn((t, 5120), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv[:, :4096].view(t, 32, 128), qkv[:, 4096:4608].view(t, 4, 128), \
        qkv[:, 4608:].view(t, 4, 128)
    segs = va.Segments.from_lengths(MELLUM_LENGTHS, "cuda")
    rope = tuple(x.cuda() for x in mellum.rope_tables(cfg, kind, 4096))
    window = cfg.sliding_window if kind == "sliding_attention" else None
    before = va.varlen_attention.launches
    got = va.varlen_attention(q, k, v, segs, window, rope=rope, causal=True)
    want = va.varlen_attention_reference(q, k, v, segs, window, rope, causal=True)
    torch.cuda.synchronize()
    assert va.varlen_attention.launches == before + 1
    errs = _seg_rel_err(got, want, MELLUM_LENGTHS)
    assert max(errs) < 5e-3, errs
    # the power of the check: the other mode's answer is far off where the
    # window binds (2,500 tokens), and a bidirectional one everywhere
    other = va.varlen_attention_reference(q, k, v, segs, None if window else 1024, rope,
                                          causal=True)
    assert _seg_rel_err(other, want, MELLUM_LENGTHS)[6] > 0.05
    bidir = va.varlen_attention_reference(q, k, v, segs, None, rope)
    assert min(_seg_rel_err(bidir, want, MELLUM_LENGTHS)[1:4]) > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("t,h,i,e,top_k", [
    (3300, 2304, 896, 64, 8),  # a recompute hop at Mellum's published widths
    (17, 2304, 896, 64, 8),    # the compile warm-up's chunk: most experts get 1-3 rows
    (500, 256, 64, 8, 2),      # narrow blocks
])
def test_moe_gemm_matches_plain_version(t, h, i, e, top_k):
    """The grouped products and the three Triton passes against their plain
    version (one torch.mm per expert) on the same bf16 operands: each
    token's relative error under 4e-3. Both round the sorted rows, the
    [gate | up] products, the SwiGLU and the down products to bf16 at the
    same places and sum the weighted rows in float32, so they differ by the
    order of the sums, which can move a rounding by one bf16 ulp (2^-8
    relative) on a few elements. Routing and every launch read nothing back
    to the host (CUDA's sync debug mode raises on a read)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    from islands_tpu_torch.ops import moe

    gen = torch.Generator(device="cuda").manual_seed(t)
    gate_up = torch.randn((e, h, 2 * i), generator=gen, device="cuda").mul_(0.02)
    gate_up = gate_up.to(torch.bfloat16)
    down = torch.randn((e, i, h), generator=gen, device="cuda").mul_(0.02).to(torch.bfloat16)
    y = torch.randn((t, h), generator=gen, device="cuda")
    router = (torch.randn((h, e), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    moe.moe_gemm(y, moe.route(y, router, top_k), gate_up, down)  # builds the kernels
    base = torch.randn((t, h), generator=gen, device="cuda")
    out = base.clone()
    before = moe.moe_gemm.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r = moe.route(y, router, top_k)
        got = moe.moe_gemm(y, r, gate_up, down)
        moe.moe_gemm(y, r, gate_up, down, out=out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert moe.moe_gemm.launches == before + 6
    want = moe.moe_gemm_reference(y, r, gate_up, down)
    rel = ((got - want).norm(dim=1) / want.norm(dim=1)).max()
    assert float(rel) < 4e-3
    rel_out = ((out - base - want).norm(dim=1) / want.norm(dim=1)).max()
    assert float(rel_out) < 4e-3
    # each run against the next expert's weights is far off
    off = moe.moe_gemm(y, r, gate_up.roll(1, 0), down.roll(1, 0))
    assert float(((off - want).norm(dim=1) / want.norm(dim=1)).max()) > 0.1


def _mellum_forward_errors(cfg, lengths, seed):
    """The port's pooled rows of random chunks of `lengths` tokens at `cfg`
    on the card, against the benchmark's float32 reference and its float8
    control on the same weights: (program's widest relative error, the
    control's least)."""
    from benchmark.reference import mellum as ref
    from benchmark.reference.minilm import fp8_e4m3
    from islands_tpu_torch.models import mellum

    w = mellum.init_params(cfg, seed, "cuda")
    model = mellum.MellumModel(cfg, w)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    slen = max(lengths)
    table = torch.randint(1000, 29000, (len(lengths), slen), generator=gen, device="cuda",
                          dtype=torch.int32)
    lens = np.asarray(lengths)
    got = model.pooled_rows(table, torch.arange(len(lengths), device="cuda"), lens)
    want = ref.pooled_rows(w, cfg.to_hf(), table, lens)
    ctl = ref.pooled_rows(w, cfg.to_hf(), table, lens, cast=fp8_e4m3)

    def rel(a):
        return ((a - want).double().norm(dim=1) / want.double().norm(dim=1)).cpu().numpy()

    return rel(got), rel(ctl)


@pytest.mark.cuda
def test_mellum_one_period_at_published_widths_matches_the_reference():
    """Four layers (3 sliding, 1 full) of Mellum2-12B-A2.5B at its
    published widths, chunks of 48-1,100 tokens: the card's bf16 forward
    against the float32 reference within 5e-2 a row, the float8 control
    beyond it on every row. The program read 0.0064-0.026 and the control
    0.090-0.114 on the card: bf16 products over four layers move the
    router's logits enough that a near-tie in a token's top 8 goes the
    other way now and then, and the last token's state carries it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from islands_tpu_torch.models import mellum

    cfg = dataclasses.replace(mellum.MellumConfig(), num_hidden_layers=4,
                              layer_types=mellum.MellumConfig().layer_types[:4])
    prog, ctl = _mellum_forward_errors(cfg, [48, 104, 192, 77, 1100, 150], 7)
    print("one period: program", prog.tolist(), "control", ctl.tolist())
    assert prog.max() < 5e-2 < ctl.min()


@pytest.mark.cuda
def test_mellum_long_chunks_bind_the_window_and_yarn():
    """All 28 layers at the published widths on 8 chunks of 1,100-4,096
    tokens, where the sliding layers' window of 1,024 and the full layers'
    YaRN frequencies bind: the card's forward against the float32
    reference within 6e-2 a row (bf16 products through 28 layers, and the
    router's near-ties), the float8 control beyond it on every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from islands_tpu_torch.models import mellum

    lengths = [1100, 4096, 1500, 2048, 3000, 1337, 3900, 2600]
    prog, ctl = _mellum_forward_errors(mellum.MellumConfig(), lengths, 11)
    print("long chunks: program", prog.tolist(), "control", ctl.tolist())
    assert prog.max() < 6e-2 < ctl.min()
