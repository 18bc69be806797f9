"""The port's sharded archipelago (islands_tpu_torch/parallel) against the
JAX package's, which runs on the 8 virtual CPU devices of tests/conftest.py.

On an index carried across from the reference (convert.sharded_from_numpy)
every gate and knob must give the reference's ids, and distances within
atol 1e-5, rtol 1e-6, as tests/test_torch_search.py holds them; so must
`_merge_topk` on tied inputs and a multislice mesh, and the recompute gate.
Saved files are byte for byte the reference's, and each package loads the
other's. The build and extend are held in test_torch_sharded_build.py, the
gloo runs in test_torch_dryrun.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from islands_tpu.core import search as jsearch
from islands_tpu.core.config import DistanceMetric as JM
from islands_tpu.core.config import LeannConfig as JConfig
from islands_tpu.core.storage import StorageError as JStorageError
from islands_tpu.parallel import mesh as jmesh
from islands_tpu.parallel import sharded as js
from islands_tpu_torch.convert import sharded_from_numpy
from islands_tpu_torch.core.config import DistanceMetric as TM
from islands_tpu_torch.core.config import LeannConfig as TConfig
from islands_tpu_torch.core.embedding import InMemoryEmbeddingProvider
from islands_tpu_torch.core.search import make_recompute_scorer
from islands_tpu_torch.core.storage import StorageError
from islands_tpu_torch.parallel import sharded as ts
from islands_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh

SMALL = dict(m=8, m0=16, ef_construction=48, ef_search=48, wave_size=64, intra_wave_k=8,
             reverse_slack=16)
K = 10
SEARCHES = {
    "exact_routed": dict(gate="exact"),
    "exact_narrow": dict(gate="exact", expand_width=2, max_iters=7),
    "sketch": dict(gate="sketch"),
    "sketch_fused": dict(gate="sketch", hop_merge="fused", expand_width=2, promote_width=16,
                         max_iters=12, final_rescore=64),
    "sketch_static": dict(gate="sketch", expand_width=2, promote_width=12, max_iters=10,
                          static_loop=True),
}


def clustered(n, dim, seed=0, n_centers=16, sigma=0.8):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, dim)).astype(np.float32)
    assign = rng.integers(0, n_centers, size=n)
    return (centers[assign] + sigma * rng.normal(size=(n, dim))).astype(np.float32)


def to_port_config(cfg: JConfig) -> TConfig:
    d = dataclasses.asdict(cfg)
    d["metric"] = TM(cfg.metric.value)
    d.pop("pruning_strategy")
    return TConfig(**d)


def carry(jidx, mesh, sketch: bool = True):
    """The port's ShardedIndex holding a reference ShardedIndex's arrays."""
    sk = None
    if sketch and jidx.has_sketch:
        sk = dict(w=np.asarray(jidx.sketch_w), scale=float(jidx.sketch_scale),
                  node_sketch=np.asarray(jidx.node_sketch),
                  nbr_sketch=np.asarray(jidx.nbr_sketch), routing=np.asarray(jidx.routing))
    return sharded_from_numpy(
        mesh, TM(jidx.metric.value), to_port_config(jidx.config) if jidx.config else None,
        np.asarray(jidx.neighbors), np.asarray(jidx.degrees), np.asarray(jidx.entries),
        np.asarray(jidx.x_prepped), np.asarray(jidx.counts), np.asarray(jidx.gids), sk)


def on_mesh(jidx, mesh):
    """The reference index's arrays placed on another reference mesh."""
    spec = js._shard_spec

    def put(a, *rest):
        return jax.device_put(np.asarray(a), spec(mesh, *rest))

    def whole(a):
        return jax.device_put(np.asarray(a), NamedSharding(mesh, P()))

    return dataclasses.replace(
        jidx, neighbors=put(jidx.neighbors, None, None), degrees=put(jidx.degrees, None),
        entries=put(jidx.entries), x_prepped=put(jidx.x_prepped, None, None),
        counts=put(jidx.counts), gids=put(jidx.gids, None), mesh=mesh,
        node_sketch=put(jidx.node_sketch, None, None),
        nbr_sketch=put(jidx.nbr_sketch, None, None), routing=put(jidx.routing, None),
        sketch_w=whole(jidx.sketch_w), sketch_scale=whole(jidx.sketch_scale))


def assert_same(got, want):
    (td, ti), (jd, ji) = got, want
    ti, ji = ti.numpy(), np.asarray(ji)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=1e-6)


@pytest.fixture(scope="module")
def ref():
    """A reference archipelago: 4 shards of 300 clustered rows (waves run
    past the 64-row seed set), sketch state included, and 32 queries."""
    x = clustered(1200, 32, seed=40)
    q = clustered(32, 32, seed=41)
    cfg = JConfig(metric=JM.EUCLIDEAN, **SMALL)
    return x, q, js.build_sharded(x, cfg, jmesh.make_mesh(4, 1), with_sketch=True)


@pytest.fixture(scope="module")
def port_mesh():
    return make_mesh(4, 1, devices=["cpu"])


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_carried_index_gates_match_reference(name, ref, port_mesh):
    _, q, jidx = ref
    kw = SEARCHES[name]
    want = js.ArchipelagoSearcher(jidx).search(q, k=K, ef=64, **kw)
    got = ts.ArchipelagoSearcher(carry(jidx, port_mesh)).search(q, k=K, ef=64, **kw)
    assert_same(got, want)


def test_unrouted_exact_gate_matches_reference(ref, port_mesh):
    _, q, jidx = ref
    bare = dataclasses.replace(jidx, node_sketch=None, nbr_sketch=None, routing=None,
                               sketch_w=None, sketch_scale=None)
    want = js.ArchipelagoSearcher(bare).search(q, k=K, ef=48)
    tidx = carry(jidx, port_mesh, sketch=False)
    assert not tidx.has_sketch
    assert_same(ts.ArchipelagoSearcher(tidx).search(q, k=K, ef=48), want)


def test_config_max_iters_default_matches_reference(ref, port_mesh):
    """LeannConfig.max_search_iters is the search default; a per-call
    max_iters wins over it."""
    _, q, jidx = ref
    jidx2 = dataclasses.replace(jidx, config=dataclasses.replace(jidx.config,
                                                                 max_search_iters=2))
    searcher = ts.ArchipelagoSearcher(carry(jidx2, port_mesh))
    got = searcher.search(q, k=5, ef=32, gate="exact")
    assert_same(got, js.ArchipelagoSearcher(jidx2).search(q, k=5, ef=32, gate="exact"))
    assert torch.equal(got[1], searcher.search(q, k=5, ef=32, gate="exact", max_iters=2)[1])
    assert not torch.equal(got[1], searcher.search(q, k=5, ef=32, gate="exact", max_iters=20)[1])


def _merge_inputs(s, b, kk, n_l, seed):
    rng = np.random.default_rng(seed)
    d = (rng.integers(0, 5, (s, b, kk)) / 4).astype(np.float32)
    d[rng.random((s, b, kk)) < 0.1] = -0.0
    d[rng.random((s, b, kk)) < 0.1] = np.inf
    i = rng.integers(-1, n_l + 2, (s, b, kk)).astype(np.int32)
    gids = np.stack([rng.permutation(10 * n_l)[:n_l] for _ in range(s)]).astype(np.int32)
    counts = rng.integers(0, n_l + 1, (s,)).astype(np.int32)
    return d, i, gids, counts


@pytest.mark.parametrize("layout", ["flat", "multislice"])
def test_merge_topk_matches_reference(layout):
    """Tied distances (a 5-value grid, -0.0 beside +0.0, +inf), ids past
    each shard's count and SENTINEL: equal ids and distances."""
    s, b, kk, n_l, k = 8, 16, 12, 40, 10
    d, i, gids, counts = _merge_inputs(s, b, kk, n_l, seed=7)
    if layout == "flat":
        jm, tm = jmesh.make_mesh(8, 1), make_mesh(8, 1, devices=["cpu"])
        axes = ("shards",)
    else:
        jm = jmesh.make_multislice_mesh(2, 4, 1)
        tm = make_multislice_mesh(2, 4, 1, devices=["cpu"])
        axes = ("shards", "slice")
    spec = P(js._shard_axes(jm))
    ref_fn = jax.jit(jax.shard_map(
        lambda d_, i_, g_, c_: js._merge_topk(d_[0], i_[0], g_[0], c_[0], k, axes),
        mesh=jm, in_specs=(spec,) * 4, out_specs=(P(), P()), check_vma=False))
    wd, wi = ref_fn(d, i, gids, counts)
    gd, gi = ts._merge_topk(*map(torch.from_numpy, (d, i, gids)), torch.from_numpy(counts),
                            k, tm)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_multislice_mesh_matches_reference(ref):
    """A (slice 2, shards 2, dp 2) mesh merges over shards, then slices."""
    _, q, jidx = ref
    jms = jmesh.make_multislice_mesh(2, 2, 2)
    tms = make_multislice_mesh(2, 2, 2, devices=["cpu"])
    assert tms.axis_names == ("slice", "shards", "dp") and tms.num_shards == 4
    jidx_ms = on_mesh(jidx, jms)
    tidx = carry(jidx, tms)
    for gate in ("exact", "sketch"):
        want = js.ArchipelagoSearcher(jidx_ms).search(q, k=K, ef=64, gate=gate)
        assert_same(ts.ArchipelagoSearcher(tidx).search(q, k=K, ef=64, gate=gate), want)


def test_save_bytes_match_reference_and_cross_load(ref, port_mesh, tmp_path):
    _, q, jidx = ref
    tidx = carry(jidx, port_mesh)
    jpath, tpath = tmp_path / "ref.shrd", tmp_path / "port.shrd"
    js.save_sharded(jidx, jpath)
    nbytes = ts.save_sharded(tidx, tpath)
    assert tpath.stat().st_size == nbytes
    assert tpath.read_bytes() == jpath.read_bytes()
    loaded = ts.load_sharded(jpath, port_mesh)
    assert loaded.config == tidx.config and loaded.n_local == tidx.n_local
    for gate in ("exact", "sketch"):
        assert_same(ts.ArchipelagoSearcher(loaded).search(q, k=K, ef=64, gate=gate),
                    js.ArchipelagoSearcher(jidx).search(q, k=K, ef=64, gate=gate))
    back = js.load_sharded(tpath, jmesh.make_mesh(4, 1))
    for field in ("neighbors", "degrees", "entries", "counts", "gids", "x_prepped",
                  "node_sketch", "nbr_sketch", "routing"):
        np.testing.assert_array_equal(np.asarray(getattr(back, field)),
                                      np.asarray(getattr(jidx, field)))
    # The default mesh takes the file's shard count.
    assert ts.load_sharded(tpath, make_mesh(4, 1, devices=["cpu"])).num_shards == 4


def test_mesh_mismatch_raises(ref, port_mesh, tmp_path):
    _, _, jidx = ref
    p = tmp_path / "a.shrd"
    ts.save_sharded(carry(jidx, port_mesh), p)
    with pytest.raises(StorageError):
        ts.load_sharded(p, make_mesh(2, 2, devices=["cpu"]))
    with pytest.raises(JStorageError):
        js.load_sharded(p, jmesh.make_mesh(2, 1))


def test_recompute_gate_matches_reference(ref, port_mesh):
    """Exact distances through a caller's scorer and per-shard ctx: a list
    of per-shard providers, and a tuple whose first leaf every shard
    shares."""
    _, q, jidx = ref

    def embed_fn(table, ids):
        return table[jax.numpy.clip(ids, 0, table.shape[0] - 1)]

    jscorer = jsearch.make_recompute_scorer(embed_fn, jidx.metric)
    want = js.ArchipelagoSearcher(jidx, exact_scorer=jscorer, exact_ctx=jidx.x_prepped).search(
        q, k=K, ef=64, gate="sketch")
    tidx = carry(jidx, port_mesh)
    providers = [InMemoryEmbeddingProvider(tidx.x_prepped[s], device="cpu").embed
                 for s in range(4)]
    got = ts.ArchipelagoSearcher(tidx, exact_scorer=make_recompute_scorer(TM.EUCLIDEAN),
                                 exact_ctx=providers).search(q, k=K, ef=64, gate="sketch")
    assert_same(got, want)
    stored = ts.ArchipelagoSearcher(tidx).search(q, k=K, ef=64, gate="sketch")
    assert torch.equal(got[1], stored[1]) and torch.equal(got[0], stored[0])

    recompute = make_recompute_scorer(TM.EUCLIDEAN)

    def scorer(ctx, qp, ids, valid):
        proj, table = ctx
        return recompute(lambda i: table[torch.clamp(i.long(), 0, table.shape[0] - 1)] @ proj,
                         qp, ids, valid)

    shared = ts.ArchipelagoSearcher(tidx, exact_scorer=scorer,
                                    exact_ctx=(torch.eye(32), tidx.x_prepped),
                                    ctx_specs=(False, True))
    assert_same(shared.search(q, k=K, ef=64, gate="sketch"), want)


def test_mesh_layout():
    m = make_mesh(4, 2, devices=["cpu"])
    assert (m.axis_names, m.shape, m.local_shards) == (("shards", "dp"), {"shards": 4, "dp": 2},
                                                        (0, 1, 2, 3))
    assert not m.distributed and m.device == torch.device("cpu")
    assert make_mesh(devices=["cpu"]).num_shards == 1
    ms = make_multislice_mesh(2, 3, 1, devices=["cpu"])
    assert ms.num_shards == 6 and ms.local_shards == tuple(range(6))
    with pytest.raises(ValueError):
        make_mesh(0, 1, devices=["cpu"])


def test_queries_must_split_over_dp(ref):
    _, q, jidx = ref
    tidx = carry(jidx, make_mesh(4, 2, devices=["cpu"]))
    with pytest.raises(ValueError):
        ts.ArchipelagoSearcher(tidx).search(q[:3], k=5)
    with pytest.raises(ValueError):
        ts.ArchipelagoSearcher(tidx).search(q, k=5, gate="exakt")
