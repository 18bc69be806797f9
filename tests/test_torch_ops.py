"""Distance, merge and sketch ops of the PyTorch port against the JAX package.

Tolerances: integer paths (id packing, merges, sketch packing) are exact;
fit_scale is within 1 ulp; float distances use rtol=1e-5, atol=1e-6 because
XLA and torch sum float32 in different orders."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islands_tpu.core.config import DistanceMetric as JM
from islands_tpu.ops import distance as jd
from islands_tpu.ops import merge as jmerge
from islands_tpu.ops import proj as jproj
from islands_tpu_torch.core.config import DistanceMetric as TM
from islands_tpu_torch.ops import distance as td
from islands_tpu_torch.ops import merge as tmerge
from islands_tpu_torch.ops import proj as tproj

METRICS = ["cosine", "euclidean", "dotproduct", "manhattan"]
RTOL, ATOL = 1e-5, 1e-6
# One compiled program per shape (op-by-op dispatch compiles every op).
_j_bitonic = jax.jit(jmerge.bitonic_merge)
_j_merge = jax.jit(jmerge.merge_sorted_with_new)


def _vecs(rng, *shape):
    return (rng.random(shape, dtype=np.float32) * 2 - 1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- distance ---------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_distance(metric):
    rng = np.random.default_rng(0)
    q, x = _vecs(rng, 9, 24), _vecs(rng, 33, 24)
    x[3] = 0.0  # zero vector: cosine distance 1.0
    want = np.asarray(jd.pairwise_distance(jnp.asarray(q), jnp.asarray(x), JM(metric)))
    got = td.pairwise_distance(_t(q), _t(x), TM(metric)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_pairwise_squared_euclidean():
    rng = np.random.default_rng(1)
    q, x = _vecs(rng, 5, 16), _vecs(rng, 12, 16)
    want = np.asarray(jd.pairwise_distance(jnp.asarray(q), jnp.asarray(x),
                                           JM.EUCLIDEAN, squared=True))
    got = td.pairwise_distance(_t(q), _t(x), TM.EUCLIDEAN, squared=True).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
def test_rowwise_and_rows_distance(metric):
    rng = np.random.default_rng(2)
    q, rows = _vecs(rng, 6, 20), _vecs(rng, 6, 11, 20)
    qp = np.asarray(jd.prep_query(q, JM(metric)))
    rp = np.asarray(jd.prep_corpus(rows.reshape(-1, 20), JM(metric))).reshape(rows.shape)
    want_rows = np.asarray(jd.rows_distance(jnp.asarray(qp), jnp.asarray(rp), JM(metric)))
    want_row0 = np.asarray(jd.rowwise_distance(jnp.asarray(qp[0]), jnp.asarray(rp[0]),
                                               JM(metric)))
    got = td.rowwise_distance(td.prep_query(_t(q), TM(metric)),
                              td.prep_corpus(_t(rows), TM(metric)), TM(metric)).numpy()
    np.testing.assert_allclose(got, want_rows, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[0], want_row0, rtol=RTOL, atol=ATOL)
    assert td.rows_distance is td.rowwise_distance


def test_normalize_keeps_zero_vectors():
    rng = np.random.default_rng(3)
    v = _vecs(rng, 7, 12)
    v[2] = 0.0
    np.testing.assert_allclose(td.normalize(_t(v)).numpy(), np.asarray(jd.normalize(v)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
def test_brute_force_topk(metric):
    # Random float data has no ties at this size: ids must be equal.
    rng = np.random.default_rng(4)
    q, x = _vecs(rng, 12, 16), _vecs(rng, 300, 16)
    wd, wi = jd.brute_force_topk(jnp.asarray(q), jnp.asarray(x), 10, JM(metric), batch=64)
    gd, gi = td.brute_force_topk(_t(q), _t(x), 10, TM(metric), batch=64)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=RTOL, atol=ATOL)


# --- merge ------------------------------------------------------------------


def test_pack_id_expanded_round_trip():
    ids = np.array([-1, 0, 1, 7, (1 << 30) - 1], np.int32)
    exp = np.array([True, False, True, False, True])
    want = np.asarray(jmerge.pack_id_expanded(jnp.asarray(ids), jnp.asarray(exp)))
    got = tmerge.pack_id_expanded(_t(ids), _t(exp))
    np.testing.assert_array_equal(got.numpy(), want)
    gi, ge = tmerge.unpack_id_expanded(got)
    wi, we = jmerge.unpack_id_expanded(jnp.asarray(want))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))


def _bitonic_input(rng, b, p, e, ties):
    draw = (lambda *s: rng.integers(0, 5, s).astype(np.float32)) if ties else \
        (lambda *s: rng.random(s, dtype=np.float32))
    pool = np.sort(draw(b, p), axis=1)
    pool[:, p - 2:] = np.inf
    new = draw(b, e)
    new[:, ::5] = np.inf
    return pool, np.arange(b * p, dtype=np.int32).reshape(b, p), new, \
        (1000 + np.arange(b * e, dtype=np.int32)).reshape(b, e)


@pytest.mark.parametrize("ties", [False, True])
def test_bitonic_merge_exact(ties):
    rng = np.random.default_rng(5)
    pool, pool_i, new, new_i = _bitonic_input(rng, 4, 8, 8, ties)
    d = np.concatenate([pool, -np.sort(-new, axis=1)], axis=1)
    aux = np.concatenate([pool_i, new_i], axis=1)
    wd, wa = _j_bitonic(jnp.asarray(d), jnp.asarray(aux))
    gd, ga = tmerge.bitonic_merge(_t(d), _t(aux))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p,e", [(16, 24), (32, 32), (12, 7)])
def test_merge_sorted_with_new_exact(p, e, ties):
    rng = np.random.default_rng(p * e)
    pool, pool_i, new, new_i = _bitonic_input(rng, 5, p, e, ties)
    wd, wa = _j_merge(*map(jnp.asarray, (pool, pool_i, new, new_i)))
    gd, ga = tmerge.merge_sorted_with_new(*map(_t, (pool, pool_i, new, new_i)))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))


def test_sort_orders_match_the_reference_on_signed_zeros_and_ties():
    # lax.sort / jnp.argsort: stable, -0.0 == +0.0; lax.top_k: lower index
    # first on ties, floats in total order.
    x = np.array([0.0, -0.0, 1.0, -0.0, 0.0, -1.0, 1.0], np.float32)
    np.testing.assert_array_equal(tmerge.argsort(_t(x)).numpy(),
                                  np.asarray(jnp.argsort(jnp.asarray(x))))
    _, top = jax.lax.top_k(-jnp.asarray(x), 6)
    np.testing.assert_array_equal(tmerge.smallest_k(_t(x), 6).numpy(), np.asarray(top))
    key = tmerge.sort_key(_t(x))
    for route in (tmerge._smallest_k_sort, tmerge._smallest_k_topk):
        np.testing.assert_array_equal(route(key, 6).numpy(), np.asarray(top))


@pytest.mark.parametrize("k", [1, 37, 500])
def test_smallest_k_wide_matches_lax_top_k_on_wide_rows(k):
    # Rows far wider than k and past the top-k route's width, with ties,
    # signed zeros and +inf; both routes give lax.top_k's positions.
    x = np.random.default_rng(k).integers(-3, 4, (5, tmerge.SORT_MAX_WIDTH + 5))
    x = x.astype(np.float32) / 2
    x[:, ::7] = -0.0
    x[:, 5::11] = np.inf
    _, top = jax.lax.top_k(-jnp.asarray(x), k)
    np.testing.assert_array_equal(tmerge.smallest_k(_t(x), k).numpy(), np.asarray(top))
    key = tmerge.sort_key(_t(x))
    for route in (tmerge._smallest_k_sort, tmerge._smallest_k_topk):
        np.testing.assert_array_equal(route(key, k).numpy(), np.asarray(top))


# --- proj -------------------------------------------------------------------


def test_quantize_pack_and_unpack_exact():
    rng = np.random.default_rng(6)
    proj = rng.normal(size=(40, 16)).astype(np.float32)
    proj[0, 3] = -1.0   # top byte of word 0 negative (0x80 and up)
    proj[0, 7] = 0.5    # top byte of word 1 positive
    proj[1, :4] = [2.5, -2.5, 3.5, -3.5]   # round half to even at scale 1
    scale = np.float32(1.0)
    for s in (scale, np.asarray(jproj.fit_scale(jnp.asarray(proj)))):
        want = np.asarray(jproj.quantize_pack(jnp.asarray(proj), jnp.asarray(s)))
        got = tproj.quantize_pack(_t(proj), torch.tensor(s))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want < 0).any()  # a negative top byte was exercised
        np.testing.assert_array_equal(tproj.unpack_raw(got).numpy(),
                                      np.asarray(jproj.unpack_raw(jnp.asarray(want))))


def test_fit_scale_within_one_ulp():
    rng = np.random.default_rng(7)
    proj = rng.normal(size=(500, 48)).astype(np.float32)
    want = np.asarray(jproj.fit_scale(jnp.asarray(proj)))
    got = tproj.fit_scale(_t(proj)).numpy()
    assert abs(got - want) <= np.spacing(want)
    assert float(tproj.fit_scale(torch.zeros(3, 4))) == 1.0


def test_make_projection_is_orthonormal_and_seeded():
    w = tproj.make_projection(32, 16, seed=3)
    assert w.shape == (32, 16)
    torch.testing.assert_close(w.T @ w, torch.eye(16), rtol=0, atol=1e-5)
    assert torch.equal(w, tproj.make_projection(32, 16, seed=3))
    assert not torch.equal(w, tproj.make_projection(32, 16, seed=4))
    with pytest.raises(ValueError):
        tproj.make_projection(32, 10)


@pytest.mark.parametrize("metric", METRICS)
def test_sketch_distances(metric):
    rng = np.random.default_rng(8)
    dim, p = 32, 16
    w = np.asarray(jproj.make_projection(dim, p, seed=0))
    q = _vecs(rng, 5, dim)
    raw = rng.integers(-127, 128, (5, 9, p)).astype(np.float32)
    scale = np.float32(3.7)
    qs_j = np.asarray(jproj.sketch_query(jnp.asarray(q), jnp.asarray(w), jnp.asarray(scale)))
    qs_t = tproj.sketch_query(_t(q), _t(w), torch.tensor(scale))
    np.testing.assert_allclose(qs_t.numpy(), qs_j, rtol=RTOL, atol=ATOL)
    for i in range(5):
        want = np.asarray(jproj.sketch_distance(jnp.asarray(qs_j[i]), jnp.asarray(raw[i]),
                                                JM(metric)))
        got = tproj.sketch_distance(_t(qs_j[i:i + 1]), _t(raw[i:i + 1]), TM(metric))[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-3)
        want_c = np.asarray(jproj.sketch_distance_calibrated(
            jnp.asarray(qs_j[i]), jnp.asarray(raw[i]), JM(metric), jnp.asarray(scale), dim))
        got_c = tproj.sketch_distance_calibrated(_t(qs_j[i:i + 1]), _t(raw[i:i + 1]),
                                                 TM(metric), torch.tensor(scale), dim)[0]
        np.testing.assert_allclose(got_c.numpy(), want_c, rtol=RTOL, atol=ATOL)


def test_build_sketch_index_with_the_reference_projection():
    rng = np.random.default_rng(9)
    x = _vecs(rng, 64, 32)
    nbrs = rng.integers(-1, 64, (64, 6)).astype(np.int32)
    ref = jproj.build_sketch_index(jnp.asarray(x), jnp.asarray(nbrs), proj_dims=16, seed=0)
    got = tproj.build_sketch_index(_t(x), _t(nbrs), proj_dims=16, w=_t(np.asarray(ref.w)))
    np.testing.assert_array_equal(got.node_sketch.numpy(), np.asarray(ref.node_sketch))
    np.testing.assert_array_equal(got.nbr_sketch.numpy(), np.asarray(ref.nbr_sketch))
    assert got.storage_bytes() == ref.storage_bytes()
    assert got.proj_dims == ref.proj_dims == 16
