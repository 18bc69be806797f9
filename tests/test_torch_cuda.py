"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA device (a kernel has no CPU
mode). The file imports neither jax nor islands_tpu, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from islands_tpu_torch.ops.adc import (
    adc_scan,
    adc_scan_reference,
    gated_adc_reference,
    gated_adc_sums,
)
from islands_tpu_torch.ops.hop_merge import hop_merge, hop_merge_reference


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
