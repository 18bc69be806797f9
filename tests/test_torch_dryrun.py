"""The archipelago on torch.distributed (gloo, on the CPU) against one
process, the analogue of __graft_entry__.dryrun_multichip.

The ranks are spawned processes that rendezvous through a FileStore; each
builds its shard, extends it (the per-repo re-index) and searches with both
gates and the operating-point knobs. They import this module, which imports
the port and not jax."""

import multiprocessing
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from islands_tpu_torch.core.config import LeannConfig
from islands_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh
from islands_tpu_torch.parallel.sharded import ArchipelagoSearcher, build_sharded, extend_sharded

CONFIG = LeannConfig(m=4, m0=8, ef_construction=16, ef_search=16, wave_size=32, intra_wave_k=4,
                     reverse_slack=8, routing_size=16)
ROWS_PER_SHARD, EXTRA, DIM, QUERIES = 48, 32, 32, 8
SEARCHES = {
    "exact": dict(gate="exact"),
    "sketch": dict(gate="sketch"),
    "sketch_static": dict(gate="sketch", expand_width=2, promote_width=12, max_iters=10,
                          static_loop=True),
    "sketch_fr": dict(gate="sketch", expand_width=2, promote_width=8, max_iters=10,
                      final_rescore=16),
}
RANK_TIMEOUT_S = 120


def run(n_shards: int, n_dp: int, n_slices: int = 1) -> dict:
    """Build, extend and search on the CPU mesh of this process (distributed
    when a process group is initialised), with `n_shards` shards over all
    slices; -> {name: array} of the results."""
    devices = ["cpu"] * (n_shards * n_dp)
    mesh = (make_mesh(n_shards, n_dp, devices) if n_slices == 1 else
            make_multislice_mesh(n_slices, n_shards // n_slices, n_dp, devices))
    rng = np.random.default_rng(0)
    n = n_shards * ROWS_PER_SHARD
    x = rng.standard_normal((n + EXTRA, DIM)).astype(np.float32)
    q = rng.standard_normal((QUERIES, DIM)).astype(np.float32)
    idx = extend_sharded(build_sharded(x[:n], CONFIG, mesh, with_sketch=True), x[n:])
    searcher = ArchipelagoSearcher(idx)
    out = {}
    for name, kw in SEARCHES.items():
        d, i = searcher.search(q, k=5, ef=16, **kw)
        out[f"{name}_d"], out[f"{name}_i"] = d.numpy(), i.numpy()
    return out


def _rank_main(rank: int, world: int, n_dp: int, n_slices: int, store: str, result: str) -> None:
    torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        out = run(world // n_dp, n_dp, n_slices)
        out["imports_jax"] = np.array("jax" in sys.modules or "islands_tpu" in sys.modules)
        np.savez(result, **out)
    finally:
        dist.destroy_process_group()


def spawn(world: int, n_dp: int, n_slices: int, workdir: Path) -> list[dict]:
    """Run `run` in `world` spawned ranks; -> each rank's results. Fails if
    a rank fails or outlives RANK_TIMEOUT_S (it is then killed)."""
    ctx = multiprocessing.get_context("spawn")
    results = [workdir / f"rank{r}.npz" for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, n_dp, n_slices, str(workdir / "store"), str(results[r])))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(RANK_TIMEOUT_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        assert not hung and not failed, f"ranks {hung} hung, ranks {failed} failed"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [dict(np.load(f)) for f in results]


@pytest.mark.parametrize("world,n_dp,n_slices", [(2, 1, 1), (4, 2, 1), (4, 1, 2)])
def test_gloo_ranks_match_the_in_process_archipelago(world, n_dp, n_slices, tmp_path):
    """`world` spawned ranks (one shard each: 2 shards x 1 dp, 2 x 2, and
    2 slices x 2 shards) rendezvous through a FileStore, build, extend and
    search on gloo; every rank's results equal one process's, and no rank
    imported jax or the JAX package."""
    want = run(world // n_dp, n_dp, n_slices)
    got = spawn(world, n_dp, n_slices, tmp_path)
    assert len(got) == world
    for res in got:
        assert not res.pop("imports_jax")
        assert res.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(res[key], want[key], err_msg=key)
