"""Shard meshes for the archipelago index.

Port of islands_tpu/parallel/mesh.py. The reference lays devices out as a
jax Mesh with axes ("shards", "dp") or ("slice", "shards", "dp"), and
shard_map runs one program per device. Here a `Mesh` records the axis
sizes, which shards this process holds and on which device, and, under
`torch.distributed`, the process groups of the shard, slice and dp axes:

- Without `torch.distributed` every shard lives in the one process, on one
  device, and several shards may share it (the reference gives each shard a
  device of its own). NCCL puts at most one rank on a card, so this is how
  an archipelago runs on a single GPU.
- Under `torch.distributed` rank r holds global shard r // n_dp and dp
  slice r % n_dp: the reference's `devices.reshape(n_shards, n_dp)` with
  slices first, so rank = (slice * shards_per_slice + shard) * n_dp + dp.
  The world size must equal the mesh's size.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from islands_tpu_torch.device import resolve_device


@dataclasses.dataclass
class Mesh:
    """Axis sizes, this process's shards and device, and (distributed) the
    axis groups that hold this rank."""

    axis_names: tuple[str, ...]
    shape: dict[str, int]
    device: torch.device
    local_shards: tuple[int, ...]  # global shard indices held here, ascending
    dp_index: int = 0  # this rank's position on the dp axis
    groups: dict | None = None  # axis -> ProcessGroup (distributed only)

    @property
    def num_shards(self) -> int:
        """Shards over all slices."""
        return self.shape.get("slice", 1) * self.shape["shards"]

    @property
    def distributed(self) -> bool:
        return self.groups is not None


def _build(axis_names, sizes, devices) -> Mesh:
    shape = dict(zip(axis_names, sizes))
    if min(sizes) < 1:
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    n_dp, used = shape["dp"], math.prod(sizes)
    if not dist.is_initialized():
        device = resolve_device(devices[0] if devices else None)
        return Mesh(tuple(axis_names), shape, device,
                    tuple(range(used // n_dp)))
    world, rank = dist.get_world_size(), dist.get_rank()
    if used != world:
        raise ValueError(f"mesh needs {used} ranks, the process group has {world}")
    device = resolve_device(devices[rank] if devices else None)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    # Every rank creates every group, in one order, as new_group requires.
    spp = shape["shards"]
    n_slices = shape.get("slice", 1)
    layouts = {
        "shards": [[(sl * spp + sh) * n_dp + dp for sh in range(spp)]
                   for sl in range(n_slices) for dp in range(n_dp)],
        "dp": [[g * n_dp + dp for dp in range(n_dp)] for g in range(n_slices * spp)],
    }
    if "slice" in shape:
        layouts["slice"] = [[(sl * spp + sh) * n_dp + dp for sl in range(n_slices)]
                            for sh in range(spp) for dp in range(n_dp)]
    groups = {}
    for axis, rank_lists in layouts.items():
        for ranks in rank_lists:
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return Mesh(tuple(axis_names), shape, device, (rank // n_dp,), rank % n_dp, groups)


def make_mesh(n_shards: int | None = None, n_dp: int = 1, devices: list | None = None) -> Mesh:
    """A (shards, dp) mesh. `devices[r]` is rank r's device under
    torch.distributed; in one process every shard lives on `devices[0]`.
    The default device is CUDA (raising without a card). `n_shards`
    defaults to the world size over n_dp, or to 1 in one process."""
    if n_shards is None:
        n_shards = max(dist.get_world_size() // n_dp, 1) if dist.is_initialized() else 1
    return _build(("shards", "dp"), (n_shards, n_dp), devices)


def make_multislice_mesh(n_slices: int, shards_per_slice: int | None = None, n_dp: int = 1,
                         devices: list | None = None) -> Mesh:
    """A (slice, shards, dp) mesh. The archipelago merges its per-shard
    top-k over 'shards' first, then only each slice's top-k over 'slice'
    (the reference's ICI-then-DCN order)."""
    if shards_per_slice is None:
        world = dist.get_world_size() if dist.is_initialized() else n_slices * n_dp
        shards_per_slice = world // (n_slices * n_dp)
    return _build(("slice", "shards", "dp"), (n_slices, shards_per_slice, n_dp), devices)
