"""Property tests of the port's scalar `distance` (mirrors the metric axioms
of tests/test_properties.py) and its parity with the JAX package's, and
`search_stored` against StoredSearcher.search and the reference's
search_stored on one graph."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra.numpy import arrays

from islands_tpu.core import search as jsearch
from islands_tpu.core.config import DistanceMetric as JMetric
from islands_tpu.core.csr import CsrGraph as JGraph
from islands_tpu.ops import distance as jdist
from islands_tpu_torch.core.config import DistanceMetric
from islands_tpu_torch.core.csr import CsrGraph
from islands_tpu_torch.core.search import StoredSearcher, search_stored
from islands_tpu_torch.ops import distance as tdist

SETTLE = settings(max_examples=20, deadline=None,
                  suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])


def finite_vec(d):
    return arrays(np.float32, (d,),
                  elements=st.floats(-10, 10, width=32, allow_nan=False, allow_infinity=False))


def dist(a, b, metric):
    return float(tdist.distance(torch.from_numpy(a), torch.from_numpy(b), metric))


@SETTLE
@given(a=finite_vec(16), b=finite_vec(16))
def test_non_negative_and_symmetric(a, b):
    for metric in (DistanceMetric.EUCLIDEAN, DistanceMetric.MANHATTAN, DistanceMetric.COSINE):
        dab, dba = dist(a, b, metric), dist(b, a, metric)
        assert dab >= -1e-5
        assert abs(dab - dba) <= 1e-4 * max(abs(dab), 1.0)


@SETTLE
@given(a=finite_vec(16))
def test_identity(a):
    for metric in (DistanceMetric.EUCLIDEAN, DistanceMetric.MANHATTAN):
        assert abs(dist(a, a, metric)) < 1e-3


@SETTLE
@given(a=finite_vec(16), b=finite_vec(16), c=finite_vec(16))
def test_triangle_inequality_l2(a, b, c):
    m = DistanceMetric.EUCLIDEAN
    assert dist(a, c, m) <= dist(a, b, m) + dist(b, c, m) + 1e-3


@SETTLE
@given(a=finite_vec(16), b=finite_vec(16))
def test_cosine_bounds(a, b):
    assert -1e-5 <= dist(a, b, DistanceMetric.COSINE) <= 2.0 + 1e-5


@SETTLE
@given(v=finite_vec(16))
def test_normalize_unit_or_zero(v):
    norm = np.linalg.norm(tdist.normalize(torch.from_numpy(v)).numpy())
    assert abs(norm - 1.0) < 1e-4 or norm == 0.0


@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_distance_matches_reference(metric):
    rng = np.random.default_rng(0)
    for _ in range(10):
        a, b = rng.standard_normal((2, 24)).astype(np.float32)
        want = float(jdist.distance(jnp.asarray(a), jnp.asarray(b), JMetric(metric.value)))
        got = tdist.distance(torch.from_numpy(a), torch.from_numpy(b), metric)
        assert got.dim() == 0 and got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-5, abs=1e-5)
    zero = np.zeros(24, np.float32)
    assert dist(zero, a, DistanceMetric.COSINE) == pytest.approx(
        float(jdist.distance(jnp.asarray(zero), jnp.asarray(a), JMetric.COSINE)))


def _knn_graph(x, k):
    d = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    return np.argsort(d, axis=1, kind="stable")[:, :k].tolist()


@pytest.mark.parametrize("metric", [DistanceMetric.COSINE, DistanceMetric.EUCLIDEAN])
def test_search_stored(metric):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((12, 16)).astype(np.float32)
    adj = _knn_graph(x, 10)
    graph = CsrGraph.from_adjacency(adj, device="cpu")
    d, ids = search_stored(q, graph, x, k=5, ef=32, metric=metric, device="cpu")
    d2, ids2 = StoredSearcher(graph, x, metric, device="cpu").search(q, k=5, ef=32)
    assert torch.equal(ids, ids2) and torch.equal(d, d2)
    jd, jids = jsearch.search_stored(jnp.asarray(q), JGraph.from_adjacency(adj), jnp.asarray(x),
                                     k=5, ef=32, metric=JMetric(metric.value))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5, rtol=0)
