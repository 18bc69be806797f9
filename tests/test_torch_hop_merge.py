"""Kernel K1 (fused hop-merge) of the PyTorch port against the JAX package.

The plain version `hop_merge_reference` must equal, exactly (atol=0, ids
equal), the reference's XLA composition `_hop_merge_xla`, its Pallas kernel
run in interpret mode, and a naive numpy oracle. The CUDA kernel is held
against the plain version on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islands_tpu.ops.pallas_kernels import _hop_merge_pallas, _hop_merge_xla
from islands_tpu_torch.ops.hop_merge import hop_merge, hop_merge_reference

N = 1 << 20
# One compiled program per shape (op-by-op dispatch compiles every op).
_xla = jax.jit(_hop_merge_xla, static_argnames=("promote_width",))


def _case(rng, e=24, a=16, ties=False):
    """One query's inputs with the production invariants: a duplicated id
    carries the same distance, invalid slots are +inf, AQ ids are disjoint
    from the discoveries. `ties` draws distances from a 4-value grid, so
    different ids share distances."""
    ids = rng.choice(N, size=e, replace=False).astype(np.int32)
    ids[3] = ids[0]
    ids[7] = ids[0]
    ids[9] = ids[5]
    d = (rng.integers(0, 4, e) / 4 if ties else rng.random(e)).astype(np.float32)
    d[3] = d[0]
    d[7] = d[0]
    d[9] = d[5]
    invalid = rng.random(e) < 0.25
    d = np.where(invalid, np.inf, d).astype(np.float32)
    ids = np.where(invalid, N, ids).astype(np.int32)
    na = rng.integers(a // 2, a + 1)
    aqd = np.full(a, np.inf, np.float32)
    aq_vals = rng.integers(0, 4, na) / 4 if ties else rng.random(na)
    aqd[:na] = np.sort(aq_vals.astype(np.float32))
    aqi = np.full(a, -1, np.int32)
    aqi[:na] = N + 1 + np.arange(na)
    return d, ids, aqd, aqi


def _batch(rng, b, **kw):
    cases = [_case(rng, **kw) for _ in range(b)]
    return [np.stack([c[i] for c in cases]) for i in range(4)]


def _oracle(d, ids, aqd, aqi, pw):
    """Naive per-query oracle (the one in tests/test_pallas_ops.py)."""
    seen, ent = set(), []
    for j in range(len(ids)):
        if np.isinf(d[j]) or ids[j] in seen:
            continue
        seen.add(int(ids[j]))
        ent.append((float(d[j]), int(ids[j])))
    for j in range(len(aqi)):
        if not np.isinf(aqd[j]):
            ent.append((float(aqd[j]), int(aqi[j])))
    ent.sort()
    a = len(aqi)
    full = ent + [(np.inf, -1)] * (pw + a)
    prom, aq = full[:pw], full[pw:pw + a]
    return (np.array([p[0] for p in prom], np.float32),
            np.array([p[1] for p in prom], np.int32),
            np.array([p[0] for p in aq], np.float32),
            np.array([p[1] for p in aq], np.int32))


def _port(args, pw):
    return [t.numpy() for t in hop_merge_reference(*map(torch.from_numpy, args), pw)]


def _assert_exact(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("e,a,pw", [(24, 16, 2), (24, 16, 4), (24, 16, 8),
                                    (24, 16, 12), (16, 16, 4), (120, 64, 16)])
def test_reference_matches_xla_composition(e, a, pw, ties):
    # atol=0: the composition's order is defined on ties too (stable sorts,
    # strict swaps), and the port must reproduce it.
    args = _batch(np.random.default_rng(e * 100 + pw), 6, e=e, a=a, ties=ties)
    want = _xla(*map(jnp.asarray, args), promote_width=pw)
    _assert_exact(_port(args, pw), want)


@pytest.mark.parametrize("pw", [2, 4, 8, 12])
def test_reference_matches_numpy_oracle(pw):
    rng = np.random.default_rng(pw)
    for _ in range(4):
        args = [a[None] for a in _case(rng)]
        got = [g[0] for g in _port(args, pw)]
        _assert_exact(got, _oracle(*[a[0] for a in args], pw))


@pytest.mark.parametrize("e,a,pw", [(24, 16, 12), (16, 16, 4)])
def test_reference_matches_pallas_interpret(e, a, pw):
    # (16, 16) is the pad_between == 0 layout; pw=12 is not a multiple of 8.
    args = _batch(np.random.default_rng(7 + pw), 3, e=e, a=a)
    want = _hop_merge_pallas(*map(jnp.asarray, args), promote_width=pw,
                             q_block=8, interpret=True)
    _assert_exact(_port(args, pw), want)


def test_wrapper_on_cpu_runs_the_plain_version_uncounted():
    args = [torch.from_numpy(a) for a in _batch(np.random.default_rng(3), 4)]
    before = hop_merge.launches
    got = hop_merge(*args, 8)
    _assert_exact([t.numpy() for t in got],
                  [t.numpy() for t in hop_merge_reference(*args, 8)])
    assert hop_merge.launches == before


def test_wrapper_rejects_bad_inputs():
    nd, ni, aqd, aqi = (torch.from_numpy(a)
                        for a in _batch(np.random.default_rng(4), 2))
    with pytest.raises(TypeError):
        hop_merge(nd.double(), ni, aqd, aqi, 4)
    with pytest.raises(ValueError):
        hop_merge(nd, ni[:, :5], aqd, aqi, 4)
    with pytest.raises(ValueError):
        hop_merge(nd, ni, aqd, aqi, nd.shape[1] + 1)
