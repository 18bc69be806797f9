"""Row gather of the PyTorch port (ops/gather.py, kernel K5's plain version)
and its port of benches/gather_bench.py, against the JAX package: the
reference bench checks its kernel against `x[ids]` on a jax array, and the
plain version must equal that exactly, on the same numpy inputs. Ids outside
[0, N) are clamped (the bench's callers clamp before the call); K need not be
a multiple of the TPU kernel's 1024-row chunk."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from islands_tpu_torch.benches import gather_bench
from islands_tpu_torch.ops.gather import row_gather, row_gather_reference


def _data(n, d, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.integers(0, n, k).astype(np.int32))


@pytest.mark.parametrize("n,d,k", [(5000, 128, 2048), (5000, 128, 1000), (300, 7, 333),
                                   (64, 16, 1), (64, 16, 0)])
def test_plain_version_matches_reference(n, d, k):
    x, ids = _data(n, d, k, n + k)
    want = np.asarray(jnp.asarray(x)[jnp.asarray(ids)])
    got = row_gather_reference(torch.from_numpy(x), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    wrapped = row_gather(torch.from_numpy(x), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(wrapped, want)


def test_ids_are_clamped():
    x, _ = _data(50, 8, 0, 1)
    ids = np.array([-7, -1, 0, 49, 50, 10**6], np.int32)
    got = row_gather(torch.from_numpy(x), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, x[np.clip(ids, 0, 49)])


def test_int32_rows_and_bad_inputs():
    rng = np.random.default_rng(2)
    x = rng.integers(-2**31, 2**31 - 1, (40, 12), dtype=np.int64).astype(np.int32)
    ids = rng.integers(0, 40, 17).astype(np.int32)
    np.testing.assert_array_equal(row_gather(torch.from_numpy(x), torch.from_numpy(ids)).numpy(),
                                  x[ids])
    with pytest.raises(TypeError):
        row_gather(torch.zeros(4, 3, dtype=torch.float64), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        row_gather(torch.zeros(4, 3), torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        row_gather(torch.zeros(0, 3), torch.zeros(2, dtype=torch.int32))


def test_chains_follow_the_reference_rule():
    # One step of each chain: ids + 1 + (int(sum of the row) & 7), wrapped.
    x, ids = _data(100, 8, 20, 4)
    tx, tids = torch.from_numpy(x), torch.from_numpy(ids)
    s = x[ids].sum(axis=1).astype(np.int32)
    nxt = ids + 1 + (s & 7)
    want = np.where(nxt >= 100, nxt - 100, nxt)
    np.testing.assert_array_equal(gather_bench.chained_row_gather(tx, tids, 1).numpy(), want)
    np.testing.assert_array_equal(gather_bench.chained_kernel_gather(tx, tids, 1).numpy(), want)
    blocks = np.random.default_rng(5).integers(0, 2**31 - 1, (100, 3, 2)).astype(np.int32)
    sb = blocks[ids].astype(np.int64).sum(axis=(1, 2))
    nxt = ids + 1 + (sb & 7)
    np.testing.assert_array_equal(
        gather_bench.chained_block_gather(torch.from_numpy(blocks), tids, 1).numpy(),
        np.where(nxt >= 100, nxt - 100, nxt))


def test_bench_main_at_a_tiny_size(monkeypatch):
    # The reference bench's gather sizes, cut for the CPU.
    monkeypatch.setattr(gather_bench, "ROW_KS", (256, 512))
    monkeypatch.setattr(gather_bench, "KERNEL_K", 256)
    monkeypatch.setattr(gather_bench, "BLOCK_KS", (64,))
    out = gather_bench.main(2000, 16, device="cpu")
    assert out["device"] == "cpu" and (out["n"], out["d"]) == (2000, 16)
    assert [r["k"] for r in out["row"]] == [256, 512]
    assert [r["k"] for r in out["kernel"]] == [256] and [r["k"] for r in out["block"]] == [64]
    for r in out["row"] + out["kernel"] + out["block"]:
        assert np.isfinite(r["ms_per_iter"]) and np.isfinite(r["ns_per_row"])
