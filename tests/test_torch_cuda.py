"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA device (a kernel has no CPU
mode). The file imports neither jax nor islands_tpu, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

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
