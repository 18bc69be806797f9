"""The sharded archipelago index over a shard mesh (one process, or one
shard per rank under torch.distributed)."""

from islands_tpu_torch.parallel.mesh import Mesh, make_mesh, make_multislice_mesh
from islands_tpu_torch.parallel.sharded import (
    ArchipelagoSearcher,
    ShardedIndex,
    build_sharded,
    extend_sharded,
    load_sharded,
    save_sharded,
)

__all__ = ["ArchipelagoSearcher", "Mesh", "ShardedIndex", "build_sharded", "extend_sharded",
           "load_sharded", "make_mesh", "make_multislice_mesh", "save_sharded"]
