"""ADC lookups of the PyTorch port (kernels K2 and K3's plain versions)
against the JAX package.

The Pallas kernels have no interpret switch, so the oracles are the
reference's own jnp paths (`_gated_adc_jnp`, `_adc_scan_jnp`, the vmapped
`gated_block_scorer_for` scorers) and a numpy loop. Tolerances:
- against the jnp paths: rtol = atol = 1e-6 (f32 sums of the same terms,
  perhaps in another order);
- against the numpy loop: exact, since both sum the same f32 terms in s
  order (the gated terms rounded to bf16, round to nearest even).
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
