"""Pairwise distance matrices of the PyTorch port (ops/pairwise.py, kernel
K4's plain versions) against the JAX package's ops API, whose XLA route is
the oracle of tests/test_pallas_ops.py. The same numpy inputs go to both.

Tolerance: the two sum in different orders (XLA's and torch's CPU matmuls),
so the squared form is held within 1e-5 * (|q|^2 + |x|^2), the sqrt form
within the square root of that bound (no relative error near 0) and
neg-dot within 1e-5 * |q| * |x|; the tests on the card hold the kernel to
these plain versions with the same bounds. A numpy emulation of the
kernel's 3xTF32 product shows those bounds hold for its design."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from islands_tpu import ops as jops
from islands_tpu_torch import ops as tops
from islands_tpu_torch.ops.pairwise import (
    pairwise_l2,
    pairwise_l2_reference,
    pairwise_neg_dot,
    pairwise_neg_dot_reference,
)

SHAPES = [(16, 40, 32), (5, 7, 8), (33, 130, 13), (3, 9, 7), (1, 1, 1), (64, 200, 128)]
MODES = ["l2", "l2_squared", "neg_dot"]


def _inputs(b, n, d, seed):
    rng = np.random.default_rng(seed)
    q = (rng.random((b, d), dtype=np.float32) * 2 - 1)
    x = (rng.random((n, d), dtype=np.float32) * 2 - 1)
    x[: min(b, n, 4)] = q[: min(b, n, 4)]  # distances that cancel to ~0
    return q, x


def _bound(q, x, mode):
    qn = np.sum(q.astype(np.float64) ** 2, axis=1)
    xn = np.sum(x.astype(np.float64) ** 2, axis=1)
    if mode == "neg_dot":
        return 1e-5 * np.sqrt(qn)[:, None] * np.sqrt(xn)[None, :]
    tol = 1e-5 * (qn[:, None] + xn[None, :])
    return np.sqrt(tol) if mode == "l2" else tol


def _jax(q, x, mode):
    if mode == "neg_dot":
        return np.asarray(jops.pairwise_neg_dot(jnp.asarray(q), jnp.asarray(x)))
    return np.asarray(jops.pairwise_l2(jnp.asarray(q), jnp.asarray(x),
                                       squared=mode == "l2_squared"))


def _port(q, x, mode, fn):
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    if mode == "neg_dot":
        return fn[1](tq, tx).numpy()
    return fn[0](tq, tx, squared=mode == "l2_squared").numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,n,d", SHAPES)
def test_plain_versions_match_reference(b, n, d, mode):
    q, x = _inputs(b, n, d, b * 1000 + n + d)
    want = _jax(q, x, mode)
    got = _port(q, x, mode, (pairwise_l2_reference, pairwise_neg_dot_reference))
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.all(np.abs(got.astype(np.float64) - want) <= _bound(q, x, mode))
    if mode != "neg_dot":
        assert np.all(got >= 0)


@pytest.mark.parametrize("mode", MODES)
def test_cpu_wrappers_take_the_plain_version(mode):
    # On CPU tensors use_kernel changes nothing: the plain version runs and
    # nothing is launched or counted.
    q, x = _inputs(12, 30, 16, 3)
    wrappers = (lambda a, b, squared=False: pairwise_l2(a, b, squared, use_kernel=True),
                lambda a, b: pairwise_neg_dot(a, b, use_kernel=True))
    counts = (pairwise_l2.launches, pairwise_neg_dot.launches)
    got = _port(q, x, mode, wrappers)
    want = _port(q, x, mode, (pairwise_l2_reference, pairwise_neg_dot_reference))
    np.testing.assert_array_equal(got, want)
    assert counts == (pairwise_l2.launches, pairwise_neg_dot.launches)


def test_ops_api_exports_and_routing_rule():
    assert tops.pairwise_l2 is pairwise_l2 and tops.pairwise_neg_dot is pairwise_neg_dot
    assert callable(tops.adc_scan) and hasattr(tops.distance, "brute_force_topk")
    # The kernel only when asked, as the reference's off-by-default use_pallas.
    for fn in (pairwise_l2, pairwise_neg_dot):
        assert inspect.signature(fn).parameters["use_kernel"].default is False


@pytest.mark.parametrize("b,n", [(0, 5), (4, 0)])
def test_empty_shapes(b, n):
    q, x = np.zeros((b, 16), np.float32), np.zeros((n, 16), np.float32)
    for mode in MODES:
        got = _port(q, x, mode, (pairwise_l2, pairwise_neg_dot))
        assert got.shape == (b, n) == _jax(q, x, mode).shape


def test_shape_errors():
    with pytest.raises(ValueError):
        pairwise_l2(torch.zeros(3, 4), torch.zeros(5, 6))
    with pytest.raises(ValueError):
        pairwise_neg_dot(torch.zeros(3), torch.zeros(5, 3))


def _tf32(v):
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as the kernel's cvt.rna.tf32.f32."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(v):
    big = _tf32(v)
    return big, _tf32(v - big)  # v - big is exact in float32


def _emulate_kernel(q, x, mode):
    """K4's arithmetic: per k8 step q_small.x_big, q_big.x_small, then
    q_big.x_big added into float32 accumulators (products of TF32 values
    are exact in float32); row norms and epilogue in float32."""
    (qb, qs), (xb, xs) = _split(q), _split(x)
    acc = np.zeros((q.shape[0], x.shape[0]), np.float32)
    for k in range(0, q.shape[1], 8):
        for a, b in ((qs, xb), (qb, xs), (qb, xb)):
            acc = acc + a[:, k:k + 8] @ b[:, k:k + 8].T
    if mode == "neg_dot":
        return -acc
    qn = np.sum(q * q, axis=1, dtype=np.float32)
    xn = np.sum(x * x, axis=1, dtype=np.float32)
    d2 = np.maximum(qn[:, None] + xn[None, :] - np.float32(2) * acc, np.float32(0))
    return np.sqrt(d2) if mode == "l2" else d2


def test_tf32_rounding_and_split():
    # Ties round away from zero; big + small keeps v to about 2^-22 |v|.
    one = np.float32(1)
    tie = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12], np.float32)
    np.testing.assert_array_equal(_tf32(tie), np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10), one],
                                                       np.float32))
    v = np.random.default_rng(0).standard_normal(10000).astype(np.float32) * 10.0 ** \
        np.random.default_rng(1).integers(-20, 20, 10000)
    big, small = _split(v)
    assert np.all(big.view(np.uint32) & 0x1FFF == 0) and np.all(small.view(np.uint32) & 0x1FFF == 0)
    err = np.abs(v.astype(np.float64) - big.astype(np.float64) - small.astype(np.float64))
    assert np.all(err <= 2.0 ** -21 * np.abs(v.astype(np.float64)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [128, 768, 1024])
def test_3xtf32_design_within_the_kernel_bound(d, mode):
    # Normal rows, near-duplicates of q (squared distances near 0), exact
    # duplicates, and rows scaled by 1e3 and 1e-3, against the plain version.
    rng = np.random.default_rng(d)
    q = rng.standard_normal((24, d)).astype(np.float32)
    q[::5] *= np.float32(1e3)
    x = rng.standard_normal((48, d)).astype(np.float32)
    x[:8] = q[:8] + np.float32(1e-4) * rng.standard_normal((8, d)).astype(np.float32)
    x[8:12] = q[8:12]
    x[12:16] *= np.float32(1e3)
    x[16:20] *= np.float32(1e-3)
    want = _port(q, x, mode, (pairwise_l2_reference, pairwise_neg_dot_reference))
    got = _emulate_kernel(q, x, mode)
    assert got.dtype == np.float32
    assert np.all(np.abs(got.astype(np.float64) - want) <= _bound(q, x, mode))
