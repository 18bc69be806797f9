"""The port's sharded build and extend against the JAX package's (run on
the 8 virtual CPU devices of tests/conftest.py).

With the reference's projection, a build then an extend must give the
reference's gids, counts, entry points and n_local exactly, graphs that
keep tests/test_build.py's invariants on every shard, and merged recall
within +-0.01. Shards that tie exactly, hold fewer than k rows or none
must search as the reference's do."""

import numpy as np
import pytest

from islands_tpu.core.config import DistanceMetric as JM
from islands_tpu.core.config import LeannConfig as JConfig
from islands_tpu.ops import distance as jdist
from islands_tpu.parallel import mesh as jmesh
from islands_tpu.parallel import sharded as js
from islands_tpu_torch.parallel import sharded as ts
from islands_tpu_torch.parallel.mesh import make_mesh
from islands_tpu_torch.testing import graph_invariants, host_merge

from test_torch_sharded import SMALL, K, assert_same, carry, clustered, to_port_config

M0 = SMALL["m0"]


@pytest.fixture(scope="module")
def short():
    """Shard 1 repeats shard 0's rows, so the merge sees exact ties across
    shards; shard 2 holds fewer than k rows and shard 3 none. Built by both
    packages (the port with the reference's projection)."""
    base = clustered(M0 + 2, 16, seed=44)  # n_local = m0 + 2 rows
    x = np.concatenate([base, base, clustered(4, 16, seed=45)])
    q = np.concatenate([base[:6] + 0.01, clustered(6, 16, seed=46)])
    cfg = JConfig(metric=JM.EUCLIDEAN, **SMALL)
    jidx = js.build_sharded(x, cfg, jmesh.make_mesh(4, 1), with_sketch=True)
    tidx = ts.build_sharded(x, to_port_config(cfg), make_mesh(4, 1, devices=["cpu"]),
                            with_sketch=True, w=np.asarray(jidx.sketch_w))
    return x, q, jidx, tidx


@pytest.mark.parametrize("gate", ["exact", "sketch"])
def test_ties_across_shards_and_short_shards_match_reference(gate, short):
    """The lower merge position comes first on a tie across shards, and
    unfilled slots stay (+inf, SENTINEL)."""
    x, q, jidx, tidx = short
    assert list(np.asarray(jidx.counts)) == list(tidx.counts) == [M0 + 2, M0 + 2, 4, 0]
    want = js.ArchipelagoSearcher(jidx).search(q, k=K, ef=64, gate=gate)
    for idx in (tidx, carry(jidx, make_mesh(4, 1, devices=["cpu"]))):
        got = ts.ArchipelagoSearcher(idx).search(q, k=K, ef=64, gate=gate)
        assert_same(got, want)
    ids = got[1].numpy()
    assert np.all((ids >= 0) & (ids < len(x)))
    # Each tied pair (row r in shard 0, its copy r + m0 + 2 in shard 1):
    # shard 0's, the lower merge position, comes first.
    pairs = 0
    for row in ids[:6].tolist():
        for a in row:
            if a < M0 + 2 and a + M0 + 2 in row:
                assert row.index(a) < row.index(a + M0 + 2)
                pairs += 1
    assert pairs > 0
    k_big = len(x) + 5
    got = ts.ArchipelagoSearcher(tidx).search(q, k=k_big, ef=k_big, gate=gate)
    assert_same(got, js.ArchipelagoSearcher(jidx).search(q, k=k_big, ef=k_big, gate=gate))
    assert np.all(got[1].numpy()[:, -5:] == -1) and np.all(np.isinf(got[0].numpy()[:, -5:]))


@pytest.mark.parametrize("gate", ["exact", "sketch"])
def test_merge_equals_host_merge(gate, short):
    """The merged top-k equals the numpy host merge that chip_smoke.py holds
    it to, on exact ties across shards and with unfilled slots."""
    x, q, _, tidx = short
    searcher = ts.ArchipelagoSearcher(tidx)
    for k in (K, len(x) + 5):
        d, i = searcher.search(q, k=k, ef=k, gate=gate)
        want_d, want_i = host_merge(*searcher.search_shards(q, k=k, ef=k, gate=gate),
                                    tidx.gids, tidx.counts, k)
        np.testing.assert_array_equal(i.numpy(), want_i)
        np.testing.assert_array_equal(d.numpy(), want_d)


def _recall(ids, tids):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / tids.shape[1]
                    for a, b in zip(ids, tids)])


def test_build_and_extend_match_reference():
    n0, n1, dim = 600, 102, 16
    x = clustered(n0 + n1, dim, seed=47)
    q = clustered(24, dim, seed=48)
    cfg = JConfig(metric=JM.EUCLIDEAN, **SMALL)
    jidx = js.build_sharded(x[:n0], cfg, jmesh.make_mesh(4, 1), with_sketch=True)
    jidx = js.extend_sharded(jidx, x[n0:])
    tmesh = make_mesh(4, 1, devices=["cpu"])
    tidx = ts.build_sharded(x[:n0], to_port_config(cfg), tmesh, with_sketch=True,
                            w=np.asarray(jidx.sketch_w))
    tidx = ts.extend_sharded(tidx, x[n0:])
    assert tidx.n_local == jidx.n_local
    np.testing.assert_array_equal(tidx.counts, np.asarray(jidx.counts))
    np.testing.assert_array_equal(tidx.entries, np.asarray(jidx.entries))
    np.testing.assert_array_equal(tidx.gids.numpy(), np.asarray(jidx.gids))
    assert tidx.num_vectors == n0 + n1
    for s in range(4):
        assert tidx.neighbors.shape[2] == cfg.m0
        graph_invariants(tidx.neighbors[s], tidx.degrees[s], int(tidx.counts[s]), f"shard {s}")
    _, tids = jdist.brute_force_topk(q, x, K, cfg.metric)
    tids = np.asarray(tids)
    for gate in ("exact", "sketch"):
        _, ji = js.ArchipelagoSearcher(jidx).search(q, k=K, ef=64, gate=gate)
        _, ti = ts.ArchipelagoSearcher(tidx).search(q, k=K, ef=64, gate=gate)
        r_ref, r_port = _recall(np.asarray(ji), tids), _recall(ti.numpy(), tids)
        assert abs(r_port - r_ref) <= 0.01, (gate, r_port, r_ref)
        assert r_port >= 0.85
        assert np.any(ti.numpy() >= n0)  # the appended rows are reachable
