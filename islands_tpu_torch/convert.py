"""Carry islands_tpu state across to the port.

The caller hands over the JAX package's CsrGraph, SketchIndex, PQ and HNSW
fields as numpy arrays (`np.asarray(field)`); these functions build the
port's objects from them, so the port's search can run on the reference's
own graph, sketch, codebook and layers (k-means++ and the projection draw
from jax.random, which torch cannot redo). `sharded_from_numpy` carries a
ShardedIndex's arrays across onto a port mesh.

`bert_from_numpy` and `modernbert_from_numpy` turn encoder parameters in
the reference's layout (dense weights [in, out], q/k/v fused, layers
stacked on axis 0; what `models.*.init_params` and `load_hf_checkpoint`
return) into the port's modules. They own every transpose: nn.Linear keeps
its weight as [out, in].
"""

from __future__ import annotations

import numpy as np
import torch

from islands_tpu_torch.core.config import HnswConfig, LeannConfig, PQConfig
from islands_tpu_torch.core.csr import CsrGraph
from islands_tpu_torch.core.hnsw import HnswIndex, HnswLayer
from islands_tpu_torch.core.leann import LeannIndex
from islands_tpu_torch.core.pq import PQCodebook, ProductQuantizer
from islands_tpu_torch.device import resolve_device, to_device
from islands_tpu_torch.models.bert import BertConfig, BertModel
from islands_tpu_torch.models.modernbert import ModernBertConfig, ModernBertModel
from islands_tpu_torch.ops.proj import SketchIndex
from islands_tpu_torch.parallel.sharded import sharded_from_numpy

__all__ = ["bert_from_numpy", "graph_from_numpy", "hnsw_from_numpy", "leann_from_numpy",
           "modernbert_from_numpy", "pq_from_numpy", "sharded_from_numpy", "sketch_from_numpy"]


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


def hnsw_from_numpy(config: HnswConfig, x, levels, layer0: dict, layers: list,
                    device=None) -> HnswIndex:
    """A port HnswIndex assembled from the reference's state as numpy
    arrays: `x` its stored prepped vectors [N, d], `levels` [N], `layer0`
    graph_from_numpy's arguments, `layers` one (ids, neighbors) pair per
    upper layer, layer 1 first."""
    dev = resolve_device(device)
    idx = HnswIndex(config, device=dev)
    idx.x = to_device(x, dev, torch.float32)
    idx.dimension = int(idx.x.shape[1])
    idx.levels = np.asarray(levels, dtype=np.int32)
    idx.layer0 = graph_from_numpy(**layer0, device=dev)
    idx.entry_point, idx.max_level = idx.layer0.entry_point, idx.layer0.max_level
    idx.layers = [HnswLayer(np.asarray(ids, dtype=np.int32), to_device(nbrs, dev, torch.int32),
                            idx.x) for ids, nbrs in layers]
    return idx


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


def _set(param: torch.nn.Parameter, value, transpose: bool = False) -> None:
    """Copy `value` ([in, out] when `transpose`) into `param` in its own
    dtype (the compute dtype for dense weights)."""
    t = torch.from_numpy(np.array(value, dtype=np.float32))
    param.copy_(t.T if transpose else t)


def _frozen(model: torch.nn.Module) -> torch.nn.Module:
    return model.requires_grad_(False).eval()


@torch.no_grad()
def bert_from_numpy(params: dict, config: BertConfig, device=None) -> BertModel:
    """A BertModel holding the reference-layout parameters `params`."""
    dev = resolve_device(device)
    model = BertModel(config, device=dev)
    emb, lay = params["embeddings"], params["layers"]
    _set(model.word.weight, emb["word"])
    _set(model.position.weight, emb["position"])
    _set(model.token_type.weight, emb["token_type"])
    _set(model.emb_ln.weight, emb["ln_scale"])
    _set(model.emb_ln.bias, emb["ln_bias"])
    for i, layer in enumerate(model.layers):
        for lin, name in ((layer.qkv, "qkv"), (layer.o, "o"), (layer.ffn_in, "ffn_in"),
                          (layer.ffn_out, "ffn_out")):
            _set(lin.weight, lay[f"{name}_w"][i], transpose=True)
            _set(lin.bias, lay[f"{name}_b"][i])
        for norm, name in ((layer.attn_ln, "attn_ln"), (layer.ffn_ln, "ffn_ln")):
            _set(norm.weight, lay[f"{name}_scale"][i])
            _set(norm.bias, lay[f"{name}_bias"][i])
    return _frozen(model)


@torch.no_grad()
def modernbert_from_numpy(params: dict, config: ModernBertConfig,
                          device=None) -> ModernBertModel:
    """A ModernBertModel holding the reference-layout parameters `params`
    (layer 0's attn_ln_scale slot is unused: its attention norm is the
    identity)."""
    dev = resolve_device(device)
    model = ModernBertModel(config, device=dev)
    lay = params["layers"]
    _set(model.word.weight, params["embeddings"]["word"])
    _set(model.emb_norm.weight, params["embeddings"]["ln_scale"])
    _set(model.final_norm.weight, params["final_ln_scale"])
    for i, layer in enumerate(model.layers):
        for lin, name in ((layer.wqkv, "qkv_w"), (layer.wo, "o_w"), (layer.wi, "wi_w"),
                          (layer.mlp_wo, "wo_w")):
            _set(lin.weight, lay[name][i], transpose=True)
        if layer.attn_norm is not None:
            _set(layer.attn_norm.weight, lay["attn_ln_scale"][i])
        _set(layer.mlp_norm.weight, lay["mlp_ln_scale"][i])
    return _frozen(model)
