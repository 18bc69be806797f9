"""Product quantization of the PyTorch port against the JAX package.

k-means++ draws from jax.random in the reference and from a torch.Generator
in the port, so codebooks trained by the two differ; the parity tests carry
the reference's codebook across (islands_tpu_torch.convert.pq_from_numpy).
Tolerances:
- `_sq_dists` and `_lloyd_step` from the same start (empty cluster
  included): atol 1e-5 (f32 matmuls summed in another order);
- the port's own training: mean squared quantization error within 1% of the
  reference's at the same config;
- on the reference's codebook: encode equal on >= 99.5% of entries (an f32
  near-tie between centroids may flip the argmin), decode exact, ADC tables
  of all four metrics, table_distance, asymmetric_distance and pq_scan
  within rtol = atol = 1e-5, inline code blocks exact, storage_bytes equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from islands_tpu.core import pq as jpq
from islands_tpu.core.config import ConfigError as JConfigError
from islands_tpu.core.config import DistanceMetric as JM
from islands_tpu.core.config import PQConfig as JPQConfig
from islands_tpu_torch.convert import pq_from_numpy
from islands_tpu_torch.core import pq as tpq
from islands_tpu_torch.core.config import ConfigError as TConfigError
from islands_tpu_torch.core.config import DistanceMetric as TM
from islands_tpu_torch.core.config import PQConfig as TPQConfig

N, DIM = 2000, 32
CFG = dict(num_subquantizers=8, num_centroids=64, training_iterations=10, seed=3)
METRICS = ["cosine", "euclidean", "dotproduct", "manhattan"]


def _data(n=N, d=DIM, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def carried():
    """(reference PQ, port PQ on the reference's codebook, port codes,
    reference codes, x, queries)."""
    x, q = _data(), _data(16, seed=1)
    ref = jpq.ProductQuantizer(JPQConfig(**CFG)).train(x)
    jcodes = np.asarray(ref.encode(x))
    port, tcodes = pq_from_numpy(np.asarray(ref.codebook.centroids), jcodes,
                                 TPQConfig(**CFG), device="cpu")
    return ref, port, tcodes, jcodes, x, q


def test_sq_dists_matches():
    rng = np.random.default_rng(4)
    p, c = rng.standard_normal((2, 50, 6)), rng.standard_normal((2, 9, 6))
    want = jax.vmap(jpq._sq_dists)(jnp.asarray(p, jnp.float32), jnp.asarray(c, jnp.float32))
    got = tpq._sq_dists(torch.tensor(p, dtype=torch.float32), torch.tensor(c, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("empty", [False, True])
def test_lloyd_step_matches_reference(empty):
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((3, 300, 4)).astype(np.float32)
    cents = pts[:, :12].copy()
    if empty:
        # Far-away centroids win no point: they are reseeded to the points
        # farthest from their assigned centroid, in rank order.
        cents[:, 3] = 100.0
        cents[:, 7] = -100.0
    want = jax.vmap(jpq._lloyd_step)(jnp.asarray(pts), jnp.asarray(cents))
    got = tpq._lloyd_step(torch.from_numpy(pts), torch.from_numpy(cents))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if empty:
        assert np.all(np.abs(got.numpy()[:, [3, 7]]) < 50)


def test_kmeans_pp_init_picks_distinct_points_deterministically():
    pts = torch.from_numpy(_data(500, 4, seed=6)).reshape(1, 500, 4).expand(2, 500, 4)
    a = tpq._kmeans_pp_init(torch.Generator().manual_seed(0), pts.contiguous(), 16)
    b = tpq._kmeans_pp_init(torch.Generator().manual_seed(0), pts.contiguous(), 16)
    assert torch.equal(a, b)
    for s in range(2):
        rows = {tuple(r) for r in a[s].tolist()}
        assert len(rows) == 16
        assert rows <= {tuple(r) for r in pts[s].tolist()}


def test_kmeans_more_clusters_than_distinct_points():
    pts = torch.from_numpy(np.repeat(_data(3, 4, seed=7), 10, axis=0))[None]
    cents, assign = tpq.kmeans(torch.Generator().manual_seed(0), pts, 8, iterations=3)
    assert cents.shape == (1, 8, 4) and assign.shape == (1, 30)
    assert torch.isfinite(cents).all()


@pytest.mark.parametrize("n,d,s,k,iters", [(4096, 32, 8, 32, 10), (4096, 64, 16, 64, 15)])
def test_own_training_quantization_error_within_1pct(n, d, s, k, iters):
    x = _data(n, d, seed=8)
    cfg = dict(num_subquantizers=s, num_centroids=k, training_iterations=iters, seed=0)
    ref = jpq.ProductQuantizer(JPQConfig(**cfg)).train(x)
    e_ref = float(np.mean((np.asarray(ref.decode(ref.encode(x))) - x) ** 2))
    port = tpq.ProductQuantizer(TPQConfig(**cfg), device="cpu").train(x)
    e_port = float(((port.decode(port.encode(x)) - torch.from_numpy(x)) ** 2).mean())
    assert abs(e_port - e_ref) <= 0.01 * e_ref, (e_port, e_ref)


def test_training_is_seeded_and_subsamples():
    x = _data(600, 16, seed=9)
    cfg = TPQConfig(num_subquantizers=4, num_centroids=16, training_iterations=3, seed=1)
    a = tpq.ProductQuantizer(cfg, device="cpu").train(x, max_train_points=256)
    b = tpq.ProductQuantizer(cfg, device="cpu").train(x, max_train_points=256)
    assert torch.equal(a.codebook.centroids, b.codebook.centroids)
    assert a.codebook.centroids.shape == (4, 16, 4)


def test_encode_on_reference_codebook(carried):
    ref, port, _, jcodes, x, _ = carried
    got = port.encode(x, chunk=512)
    assert got.dtype == torch.uint8 and got.shape == jcodes.shape
    assert np.mean(got.numpy() == jcodes) >= 0.995
    assert torch.equal(port.encode(x[5]), got[5])


def test_decode_exact(carried):
    ref, port, tcodes, jcodes, _, _ = carried
    np.testing.assert_array_equal(port.decode(tcodes).numpy(), np.asarray(ref.decode(jcodes)))
    np.testing.assert_array_equal(port.decode(tcodes[3]).numpy(),
                                  np.asarray(ref.decode(jcodes[3])))


@pytest.mark.parametrize("metric", METRICS)
def test_metric_tables_match(carried, metric):
    ref, port, _, _, _, q = carried
    cents = ref.codebook.centroids
    want = jpq._build_metric_tables(jnp.asarray(q), cents, metric)
    got = tpq._build_metric_tables(torch.from_numpy(q), port.codebook.centroids, metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    got = tpq.gated_prep_for(TM(metric))(port.codebook.centroids, torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_distance_tables_and_distances_match(carried):
    ref, port, tcodes, jcodes, _, q = carried
    np.testing.assert_allclose(port.build_distance_tables(q).numpy(),
                               np.asarray(ref.build_distance_tables(q)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.build_distance_tables(q[0]).numpy(),
                               np.asarray(ref.build_distance_tables(q[0])), rtol=1e-5, atol=1e-5)
    tables = ref.build_distance_tables(q)
    np.testing.assert_allclose(port.table_distance(np.asarray(tables), tcodes).numpy(),
                               np.asarray(ref.table_distance(tables, jcodes)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.table_distance(np.asarray(tables[1]), tcodes[4]).numpy(),
                               np.asarray(ref.table_distance(tables[1], jcodes[4])),
                               rtol=1e-5, atol=1e-5)
    for qq, cc, jc in ((q, tcodes, jcodes), (q[2], tcodes, jcodes), (q, tcodes[7], jcodes[7])):
        np.testing.assert_allclose(port.asymmetric_distance(qq, cc).numpy(),
                                   np.asarray(ref.asymmetric_distance(qq, jc)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
def test_pq_scan_matches(carried, metric):
    ref, port, tcodes, jcodes, _, q = carried
    want = jpq.pq_scan(ref, q, jcodes, metric=JM(metric))
    got = tpq.pq_scan(port, torch.from_numpy(q), tcodes, metric=TM(metric))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_make_pq_scorer_matches(carried):
    ref, port, tcodes, jcodes, _, q = carried
    ids = np.random.default_rng(10).integers(-1, N, (q.shape[0], 24)).astype(np.int32)
    valid = ids >= 0
    jprep, jscore = jpq.make_pq_scorer(ref, jcodes)
    want = jax.vmap(jscore)(jprep(q), jnp.asarray(ids), jnp.asarray(valid))
    tprep, tscore = tpq.make_pq_scorer(port, tcodes)
    got = tscore(tprep(torch.from_numpy(q)), torch.from_numpy(ids), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_inline_codes_and_storage_match(carried):
    ref, port, tcodes, jcodes, _, _ = carried
    rng = np.random.default_rng(11)
    nbrs = rng.integers(0, N, (N, 6)).astype(np.int32)
    nbrs[::3, 4:] = -1
    want = jpq.build_inline_codes(jnp.asarray(nbrs), jnp.asarray(jcodes))
    got = tpq.build_inline_codes(torch.from_numpy(nbrs), tcodes)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert port.storage_bytes(N) == ref.storage_bytes(N)


def test_more_than_256_centroids_use_int32_codes():
    x = _data(700, 8, seed=12)
    cfg = dict(num_subquantizers=2, num_centroids=300, training_iterations=2, seed=0)
    ref = jpq.ProductQuantizer(JPQConfig(**cfg)).train(x)
    jcodes = np.asarray(ref.encode(x))
    port, tcodes = pq_from_numpy(np.asarray(ref.codebook.centroids), jcodes,
                                 TPQConfig(**cfg), device="cpu")
    assert port.code_dtype == torch.int32 and tcodes.dtype == torch.int32
    assert np.mean(port.encode(x).numpy() == jcodes) >= 0.995
    np.testing.assert_array_equal(port.decode(tcodes).numpy(), np.asarray(ref.decode(jcodes)))
    want = jpq.pq_scan(ref, x[:4], jcodes, metric=JM.EUCLIDEAN)
    got = tpq.pq_scan(port, torch.from_numpy(x[:4]), tcodes, metric=TM.EUCLIDEAN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert port.storage_bytes(700) == ref.storage_bytes(700)
    # The reference's inline blocks wrap such codes to uint8; the port refuses.
    with pytest.raises(tpq.PQError):
        tpq.build_inline_codes(torch.zeros((4, 2), dtype=torch.int32), tcodes)


@pytest.mark.parametrize("cfg,dim", [((8, 256, 25, None), 64), ((16, 300, 5, 1), 768),
                                     ((0, 256, 5, 0), 64), ((7, 256, 5, 0), 64),
                                     ((4, 0, 5, 0), 64), ((4, 70000, 5, 0), 64)])
def test_config_matches(cfg, dim):
    j, t = JPQConfig(*cfg), TPQConfig(*cfg)
    assert t.bytes_per_vector == j.bytes_per_vector
    try:
        j.validate(dim)
    except JConfigError:
        with pytest.raises(TConfigError):
            t.validate(dim)
    else:
        t.validate(dim)


def test_errors():
    port = tpq.ProductQuantizer(TPQConfig(num_subquantizers=4, num_centroids=16), device="cpu")
    with pytest.raises(tpq.PQError):
        port.encode(_data(4, 16))
    with pytest.raises(tpq.PQError):
        port.train(_data(8, 16))  # fewer vectors than centroids
    with pytest.raises(tpq.PQError):
        port.train(_data(32, 16)[None])
    port.train(_data(64, 16), max_train_points=64)
    with pytest.raises(tpq.PQError):
        port.encode(_data(4, 12))
    with pytest.raises(ValueError):
        tpq.gated_block_scorer_for(TM.EUCLIDEAN, "nope")
