"""Carry islands_tpu state across to the port.

The caller hands over the JAX package's CsrGraph, SketchIndex and PQ fields
as numpy arrays (`np.asarray(field)`); these functions build the port's
objects from them, so the port's search can run on the reference's own
graph, sketch and codebook (k-means++ draws from jax.random, which torch
cannot redo).
"""

from __future__ import annotations

import numpy as np
import torch

from islands_tpu_torch.core.config import LeannConfig, PQConfig
from islands_tpu_torch.core.csr import CsrGraph
from islands_tpu_torch.core.leann import LeannIndex
from islands_tpu_torch.core.pq import PQCodebook, ProductQuantizer
from islands_tpu_torch.device import resolve_device, to_device
from islands_tpu_torch.ops.proj import SketchIndex


def graph_from_numpy(neighbors, degrees, levels, entry_point, max_level,
                     device=None) -> CsrGraph:
    dev = resolve_device(device)
    return CsrGraph(
        neighbors=to_device(neighbors, dev, torch.int32),
        degrees=to_device(degrees, dev, torch.int32),
        levels=to_device(levels, dev, torch.int32),
        entry_point=int(entry_point),
        max_level=int(max_level),
    )


def sketch_from_numpy(w, scale, node_sketch, nbr_sketch, device=None) -> SketchIndex:
    dev = resolve_device(device)
    return SketchIndex(
        w=to_device(w, dev, torch.float32),
        scale=to_device(scale, dev, torch.float32),
        node_sketch=to_device(node_sketch, dev, torch.int32),
        nbr_sketch=to_device(nbr_sketch, dev, torch.int32),
    )


def pq_from_numpy(centroids, codes, pq_config: PQConfig,
                  device=None) -> tuple[ProductQuantizer, torch.Tensor]:
    """A trained ProductQuantizer holding the reference's codebook
    (centroids [S, K, sub_dim]), and its codes [n, S] in the port's code
    dtype (uint8 up to 256 centroids, int32 above)."""
    dev = resolve_device(device)
    pq = ProductQuantizer(pq_config, device=dev)
    c = to_device(centroids, dev, torch.float32)
    pq.codebook = PQCodebook(centroids=c)
    pq._dimension = c.shape[0] * c.shape[2]
    return pq, to_device(np.asarray(codes).astype(np.int64), dev, pq.code_dtype)


def leann_from_numpy(config: LeannConfig, dimension: int, graph: dict, pq: dict | None = None,
                     sketch: dict | None = None, device=None) -> LeannIndex:
    """A port LeannIndex assembled from the reference's state as numpy
    arrays: `graph` holds graph_from_numpy's arguments, `pq` holds
    (centroids, codes, pq_config) and `sketch` sketch_from_numpy's, by name."""
    dev = resolve_device(device)
    idx = LeannIndex(config, device=dev)
    idx.dimension = int(dimension)
    idx.graph = graph_from_numpy(**graph, device=dev)
    if sketch is not None:
        idx.sketch = sketch_from_numpy(**sketch, device=dev)
    idx._init_routing()
    if pq is not None:
        idx.pq, idx.pq_codes = pq_from_numpy(**pq, device=dev)
    return idx
