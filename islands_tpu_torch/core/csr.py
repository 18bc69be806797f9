"""Proximity graph: padded fixed-degree device layout + true CSR interop.

Port of islands_tpu/core/csr.py. On the device the graph is a padded
[N, M] int32 neighbor matrix with SENTINEL (-1) padding; `to_csr_arrays`
and `from_csr_arrays` convert to the reference's ragged on-disk layout.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from islands_tpu_torch.device import resolve_device

SENTINEL = -1


@dataclasses.dataclass
class CsrGraph:
    """Device-resident proximity graph.

    - neighbors: int32 [N, max_degree], row i = neighbor ids of node i,
      padded with SENTINEL.
    - degrees: int32 [N], valid entries per row.
    - levels: int32 [N], level per node (only the entry point depends on it).
    - entry_point: int, SENTINEL if empty.
    - max_level: int.
    """

    neighbors: torch.Tensor
    degrees: torch.Tensor
    levels: torch.Tensor
    entry_point: int
    max_level: int

    @staticmethod
    def empty(num_nodes: int, max_degree: int, device=None) -> "CsrGraph":
        dev = resolve_device(device)
        return CsrGraph(
            neighbors=torch.full((num_nodes, max_degree), SENTINEL,
                                 dtype=torch.int32, device=dev),
            degrees=torch.zeros((num_nodes,), dtype=torch.int32, device=dev),
            levels=torch.zeros((num_nodes,), dtype=torch.int32, device=dev),
            entry_point=SENTINEL,
            max_level=0,
        )

    @staticmethod
    def from_adjacency(
        adjacency: Sequence[Sequence[int]],
        levels: Sequence[int] | None = None,
        max_degree: int | None = None,
        device=None,
    ) -> "CsrGraph":
        """Build from a host adjacency list (test/interop path)."""
        n = len(adjacency)
        if max_degree is None:
            max_degree = max((len(a) for a in adjacency), default=0)
        max_degree = max(max_degree, 1)
        nbrs = np.full((n, max_degree), SENTINEL, dtype=np.int32)
        degs = np.zeros((n,), dtype=np.int32)
        for i, row in enumerate(adjacency):
            row = list(row)[:max_degree]
            nbrs[i, : len(row)] = row
            degs[i] = len(row)
        lvls = np.asarray(levels if levels is not None else np.zeros(n), dtype=np.int32)
        if n > 0:
            max_level = int(lvls.max())
            # First node with the max level (strict `level > max_level`
            # update rule of sequential insertion).
            entry = int(np.argmax(lvls == max_level))
        else:
            max_level, entry = 0, SENTINEL
        dev = resolve_device(device)
        return CsrGraph(
            neighbors=torch.from_numpy(nbrs).to(dev),
            degrees=torch.from_numpy(degs).to(dev),
            levels=torch.from_numpy(lvls).to(dev),
            entry_point=entry,
            max_level=max_level,
        )

    @property
    def num_nodes(self) -> int:
        return self.neighbors.shape[0]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.neighbors.device

    def get_neighbors(self, node_id: int) -> np.ndarray:
        row = self.neighbors[node_id].cpu().numpy()
        return row[row != SENTINEL]

    def validate(self) -> None:
        """Structural invariants: ids in range, no self-loops, degrees
        consistent with the sentinel layout, entry point valid. Raises
        ValueError on violation."""
        nbrs = self.neighbors.cpu().numpy()
        degs = self.degrees.cpu().numpy()
        n, md = nbrs.shape
        if n == 0:
            return
        valid_mask = np.arange(md)[None, :] < degs[:, None]
        vals = nbrs[valid_mask]
        if vals.size and (vals.min() < 0 or vals.max() >= n):
            raise ValueError("neighbor id out of range")
        if np.any(nbrs[~valid_mask] != SENTINEL):
            raise ValueError("non-sentinel entry beyond row degree")
        rows, _ = np.nonzero(nbrs == np.arange(n)[:, None])
        if rows.size:
            raise ValueError(f"self-loop at node {rows[0]}")
        if not 0 <= int(self.entry_point) < n:
            raise ValueError(f"entry point {self.entry_point} out of range")

    def storage_bytes(self) -> int:
        """True CSR storage: 4 bytes/edge + offsets + levels."""
        num_edges = int(self.degrees.sum())
        return 4 * num_edges + 4 * (self.num_nodes + 1) + 4 * self.num_nodes

    def to_csr_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(node_offsets [N+1] int64, flat_neighbors [E] int32, levels [N]
        int32): the ragged layout."""
        nbrs = self.neighbors.cpu().numpy()
        degs = self.degrees.cpu().numpy()
        offsets = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.cumsum(degs, out=offsets[1:])
        valid = np.arange(self.max_degree)[None, :] < degs[:, None]
        flat = nbrs[valid].astype(np.int32)
        return offsets, flat, self.levels.cpu().numpy()

    @staticmethod
    def from_csr_arrays(
        offsets: np.ndarray,
        flat_neighbors: np.ndarray,
        levels: np.ndarray,
        entry_point: int,
        max_level: int,
        max_degree: int | None = None,
        device=None,
    ) -> "CsrGraph":
        n = len(offsets) - 1
        degs = np.diff(offsets).astype(np.int32)
        md = int(degs.max()) if (max_degree is None and n > 0) else (max_degree or 1)
        md = max(md, 1)
        nbrs = np.full((n, md), SENTINEL, dtype=np.int32)
        valid = np.arange(md)[None, :] < degs[:, None]
        nbrs[valid] = np.asarray(flat_neighbors, dtype=np.int32)
        dev = resolve_device(device)
        return CsrGraph(
            neighbors=torch.from_numpy(nbrs).to(dev),
            degrees=torch.from_numpy(degs).to(dev),
            levels=torch.as_tensor(np.asarray(levels, dtype=np.int32)).to(dev),
            entry_point=int(entry_point),
            max_level=int(max_level),
        )
