"""BERT-family sentence encoder.

Port of islands_tpu/models/bert.py: tokenize (encoder.py), BERT forward,
attention-mask-weighted mean pooling, optional L2 normalization.

Numerics follow the reference:
- matmul operands in the compute dtype (bfloat16 by default) with float32
  accumulation; the bias is added in float32 inside the product's epilogue
  before the one downcast (the bias itself is held in the compute dtype,
  which F.linear requires);
- LayerNorm statistics in float32 with the output in the input's dtype, so
  the residual stream is in the compute dtype after every LayerNorm;
- softmax statistics in float32, exact-erf GELU;
- an additive -1e9 padding bias in the compute dtype, not a boolean mask: a
  row whose keys are all masked gets uniform weights, not NaN.

The reference's `attn_impl` variants ("slice"/"fold"/"dtl"/"onepass") are
TPU memory layouts of one function; the field is kept and every value runs
the same `scaled_dot_product_attention`.

`init_params` returns the reference's parameter layout as numpy arrays
(dense weights [in, out], fused q/k/v, layers stacked on axis 0), drawn from
the same seeded generator in the same order; `convert.bert_from_numpy` turns
them into a `BertModel` and owns every transpose. Weights load from a local
HuggingFace checkpoint directory (model.safetensors or pytorch_model.bin).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import struct
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from islands_tpu_torch.utils.graphs import GraphCache, capture_cuda_graph
from islands_tpu_torch.utils.tracing import count

#: Shapes whose padded encode a CUDA BertModel keeps as CUDA graphs
#: (`encode`), the least recently used out first: a text query at each of
#: the encoder's four length buckets, a recompute index's hop and route
#: shapes, and two more (a batch of texts, a build's chunk).
ENCODE_GRAPHS_KEPT = 8
#: The largest encode graphed, as rows x length x intermediate_size. Above
#: it the forward is not dispatch-bound, and its activations would stay in
#: the graphs' pool for the model's life: through MiniLM 32 x 256 tokens
#: (1.3e7) is graphed; 2,048 x 64 (2.0e8) ran 18.8 ms eager and 18.7 as a
#: graph on an H100, whose pool then held 2.1 GB.
ENCODE_GRAPH_ELEMENTS = 1 << 24


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Architecture hyperparameters (HF bert config.json subset)."""

    vocab_size: int = 30522
    hidden_size: int = 384
    num_hidden_layers: int = 6
    num_attention_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # compute dtype for matmuls; embeddings, LayerNorm parameters and the
    # pooled output stay float32
    dtype: str = "bfloat16"
    # the reference's attention layout on the TPU; one attention here
    attn_impl: str = "slice"

    @staticmethod
    def minilm_l6() -> "BertConfig":
        """all-MiniLM-L6-v2 (384-d, 6 layers)."""
        return BertConfig(attn_impl="dtl")

    @staticmethod
    def minilm_l12() -> "BertConfig":
        return BertConfig(num_hidden_layers=12)

    @staticmethod
    def bge_small() -> "BertConfig":
        """bge-small-en-v1.5 (384-d, 12 layers)."""
        return BertConfig(hidden_size=384, num_hidden_layers=12, intermediate_size=1536)

    @staticmethod
    def bge_base() -> "BertConfig":
        """bge-base-en-v1.5 (768-d)."""
        return BertConfig(hidden_size=768, num_hidden_layers=12,
                          num_attention_heads=12, intermediate_size=3072)

    @staticmethod
    def bge_large() -> "BertConfig":
        """bge-large-en-v1.5 (1024-d)."""
        return BertConfig(hidden_size=1024, num_hidden_layers=24,
                          num_attention_heads=16, intermediate_size=4096)

    @staticmethod
    def tiny_test() -> "BertConfig":
        """Small config for tests."""
        return BertConfig(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=128,
                          max_position_embeddings=128, dtype="float32")

    @staticmethod
    def from_json(path: str | Path) -> "BertConfig":
        raw = json.loads(Path(path).read_text())
        return BertConfig(
            vocab_size=raw.get("vocab_size", 30522),
            hidden_size=raw.get("hidden_size", 384),
            num_hidden_layers=raw.get("num_hidden_layers", 6),
            num_attention_heads=raw.get("num_attention_heads", 12),
            intermediate_size=raw.get("intermediate_size", 1536),
            max_position_embeddings=raw.get("max_position_embeddings", 512),
            type_vocab_size=raw.get("type_vocab_size", 2),
            layer_norm_eps=raw.get("layer_norm_eps", 1e-12),
            pad_token_id=raw.get("pad_token_id", 0),
        )


def compute_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def init_params(config: BertConfig, seed: int = 0) -> dict:
    """Random-init parameters in the reference's layout, as float32 numpy
    arrays: the same draws from np.random.default_rng(seed) in the same
    order, so both packages build the same weights."""
    rng = np.random.default_rng(seed)
    h, i, L = config.hidden_size, config.intermediate_size, config.num_hidden_layers

    def w(*shape, scale=0.02):
        return rng.standard_normal(shape).astype(np.float32) * scale

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    return {
        "embeddings": {
            "word": w(config.vocab_size, h),
            "position": w(config.max_position_embeddings, h),
            "token_type": w(config.type_vocab_size, h),
            "ln_scale": ones(h),
            "ln_bias": zeros(h),
        },
        "layers": {
            "qkv_w": w(L, h, 3 * h), "qkv_b": zeros(L, 3 * h),
            "o_w": w(L, h, h), "o_b": zeros(L, h),
            "attn_ln_scale": ones(L, h), "attn_ln_bias": zeros(L, h),
            "ffn_in_w": w(L, h, i), "ffn_in_b": zeros(L, i),
            "ffn_out_w": w(L, i, h), "ffn_out_b": zeros(L, h),
            "ffn_ln_scale": ones(L, h), "ffn_ln_bias": zeros(L, h),
        },
    }


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in float32 with float32 parameters, its output rounded
    once to x's dtype (CUDA's F.layer_norm takes no mixed dtypes)."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return y.to(x.dtype)


def padding_bias(attention_mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, 1, 1, L] additive bias: 0 for real tokens, -1e9 for padding."""
    m = attention_mask[:, None, None, :] > 0
    return torch.where(m, 0.0, -1e9).to(dtype)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype, device):
        super().__init__()
        h, i, eps = config.hidden_size, config.intermediate_size, config.layer_norm_eps
        lin = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.heads = config.num_attention_heads
        self.qkv = nn.Linear(h, 3 * h, **lin)
        self.o = nn.Linear(h, h, **lin)
        self.attn_ln = nn.LayerNorm(h, eps=eps, **f32)
        self.ffn_in = nn.Linear(h, i, **lin)
        self.ffn_out = nn.Linear(i, h, **lin)
        self.ffn_ln = nn.LayerNorm(h, eps=eps, **f32)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, slen, h = x.shape
        nh = self.heads
        # [B, L, 3, H, D] -> three [B, H, L, D] views of the fused product
        q, k, v = self.qkv(x).view(b, slen, 3, nh, h // nh).permute(2, 0, 3, 1, 4)
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        ctx = ctx.transpose(1, 2).reshape(b, slen, h)
        x = layer_norm(x + self.o(ctx), self.attn_ln)
        ff = self.ffn_out(F.gelu(self.ffn_in(x)))
        return layer_norm(x + ff, self.ffn_ln)


class BertModel(nn.Module):
    """BERT encoder: [B, L] ids + [B, L] mask -> hidden states [B, L, H]
    float32. Built by `convert.bert_from_numpy`."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        self.config = config
        self.dtype = compute_dtype(config.dtype)
        h = config.hidden_size
        f32 = dict(dtype=torch.float32, device=device)
        self.word = nn.Embedding(config.vocab_size, h, **f32)
        self.position = nn.Embedding(config.max_position_embeddings, h, **f32)
        self.token_type = nn.Embedding(config.type_vocab_size, h, **f32)
        self.emb_ln = nn.LayerNorm(h, eps=config.layer_norm_eps, **f32)
        self.layers = nn.ModuleList(BertLayer(config, self.dtype, device)
                                    for _ in range(config.num_hidden_layers))
        # On CUDA `encode` replays this forward as CUDA graphs, one a shape.
        cuda = device is not None and torch.device(device).type == "cuda"
        self.encode_graphs = new_encode_graphs() if cuda else None

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        slen = input_ids.shape[1]
        x = (self.word(input_ids.long()) + self.position.weight[:slen][None]
             + self.token_type.weight[0][None, None])
        x = layer_norm(x, self.emb_ln).to(self.dtype)
        bias = padding_bias(attention_mask, self.dtype)
        for layer in self.layers:
            x = layer(x, bias)
        return x.float()


def mean_pool_normalize(hidden: torch.Tensor, attention_mask: torch.Tensor,
                        normalize: bool = True) -> torch.Tensor:
    """Attention-mask-weighted mean pooling + optional L2 norm."""
    mask = attention_mask.float()[:, :, None]
    summed = torch.sum(hidden * mask, dim=1)
    counts = torch.clamp(torch.sum(mask, dim=1), min=1e-9)
    pooled = summed / counts
    if normalize:
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        pooled = pooled / torch.clamp(norm, min=1e-12)
    return pooled


def new_encode_graphs(capture=None) -> GraphCache:
    """A BertModel's captured encodes, at most ENCODE_GRAPHS_KEPT shapes,
    each captured on its second call. By default CUDA graphs that share one
    memory pool: `encode` replays them one at a time, so the shapes kept
    hold one set of activations."""
    if capture is None:
        capture = functools.partial(capture_cuda_graph, pool=torch.cuda.graph_pool_handle())
    return GraphCache(capture, kept=ENCODE_GRAPHS_KEPT, after=2)


class _EncodeGraph:
    """The padded forward, mean pooling and optional L2 norm of one shape,
    captured over static ids and mask buffers. A call copies its rows in,
    replays, and clones the pooled rows out, so nothing it returns aliases
    the graph's output."""

    def __init__(self, model: nn.Module, input_ids, attention_mask, normalize: bool, capture):
        self.ids, self.mask = input_ids.clone(), attention_mask.clone()

        def run():
            return mean_pool_normalize(model(self.ids, self.mask), self.mask, normalize)

        self.replay, self.out = capture(run, input_ids.device)

    def __call__(self, input_ids, attention_mask) -> torch.Tensor:
        self.ids.copy_(input_ids)
        self.mask.copy_(attention_mask)
        self.replay()
        return self.out.clone()


@torch.inference_mode()
def encode(model: nn.Module, input_ids: torch.Tensor, attention_mask: torch.Tensor,
           normalize: bool = True) -> torch.Tensor:
    """ids + mask (on the model's device) -> sentence embeddings [B, H]
    float32. `model` is a BertModel or a ModernBertModel: the forward is
    the module's own, so the pipeline follows the encoder's architecture. A
    BertModel runs its padded forward and is mean pooled here; a model with
    a `pooled(ids, mask)` method (ModernBERT's packed forward) pools its own
    rows.

    A BertModel built on CUDA replays its padded forward, pooling and norm
    as one CUDA graph per (rows, length, normalize), captured on the second
    call of a shape and kept in `model.encode_graphs` (at most
    ENCODE_GRAPHS_KEPT); each replay counts "encoder.graphed". Elsewhere,
    on a shape's first call, at zero rows and above ENCODE_GRAPH_ELEMENTS,
    the forward runs eagerly."""
    pooled = getattr(model, "pooled", None)
    if pooled is not None:
        out = pooled(input_ids, attention_mask)
        return F.normalize(out, dim=-1, eps=1e-12) if normalize else out
    graphs = getattr(model, "encode_graphs", None)
    rows, slen = input_ids.shape
    if graphs is not None and 0 < rows * slen * model.config.intermediate_size \
            <= ENCODE_GRAPH_ELEMENTS:
        # One lock from the copy in to the clone out: the graphs share a pool.
        with graphs.lock:
            graph = graphs.get((rows, slen, normalize), lambda: _EncodeGraph(
                model, input_ids, attention_mask, normalize, graphs.capture))
            if graph is not None:
                out = graph(input_ids, attention_mask)
                count("encoder.graphed", 1)
                return out
    return mean_pool_normalize(model(input_ids, attention_mask), attention_mask, normalize)


# ---------------------------------------------------------------------------
# HF checkpoint loading (local path)
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
              "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """A safetensors file as numpy arrays: an 8-byte little-endian header
    length, a JSON header of {name: {dtype, shape, data_offsets}}, then the
    raw little-endian buffers. BF16 widens to float32."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack_from("<Q", data, 0)
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        buf = data[base + start:base + end]
        if info["dtype"] == "BF16":
            a = (np.frombuffer(buf, "<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            a = np.frombuffer(buf, _ST_DTYPES[info["dtype"]])
        out[name] = a.reshape(info["shape"])
    return out


def read_checkpoint(path: Path) -> dict[str, np.ndarray]:
    """model.safetensors, else pytorch_model.bin, as numpy arrays."""
    st = path / "model.safetensors"
    if st.exists():
        return read_safetensors(st)
    sd = torch.load(path / "pytorch_model.bin", map_location="cpu", weights_only=True)
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in sd.items()}


_HF_LAYER_KEYS = {
    "o_w": "attention.output.dense.weight", "o_b": "attention.output.dense.bias",
    "attn_ln_scale": "attention.output.LayerNorm.weight",
    "attn_ln_bias": "attention.output.LayerNorm.bias",
    "ffn_in_w": "intermediate.dense.weight", "ffn_in_b": "intermediate.dense.bias",
    "ffn_out_w": "output.dense.weight", "ffn_out_b": "output.dense.bias",
    "ffn_ln_scale": "output.LayerNorm.weight", "ffn_ln_bias": "output.LayerNorm.bias",
}


def load_hf_checkpoint(path: str | Path) -> tuple[dict, BertConfig]:
    """Load a BERT checkpoint from a local HF model directory
    (model.safetensors or pytorch_model.bin + config.json) into the
    reference's parameter layout (numpy float32; dense weights [in, out],
    q/k/v fused in that column order)."""
    path = Path(path)
    config = BertConfig.from_json(path / "config.json")
    raw = {k.removeprefix("bert."): v for k, v in read_checkpoint(path).items()}

    def get(name):
        return np.asarray(raw[name], dtype=np.float32)

    params = {
        "embeddings": {
            "word": get("embeddings.word_embeddings.weight"),
            "position": get("embeddings.position_embeddings.weight"),
            "token_type": get("embeddings.token_type_embeddings.weight"),
            "ln_scale": get("embeddings.LayerNorm.weight"),
            "ln_bias": get("embeddings.LayerNorm.bias"),
        },
        "layers": {},
    }
    L = config.num_hidden_layers
    for ours, theirs in _HF_LAYER_KEYS.items():
        stacked = np.stack([get(f"encoder.layer.{i}.{theirs}") for i in range(L)])
        if ours.endswith("_w"):
            stacked = stacked.transpose(0, 2, 1)  # HF stores [out, in]
        params["layers"][ours] = np.ascontiguousarray(stacked)
    qkv_w, qkv_b = [], []
    for i in range(L):
        base = f"encoder.layer.{i}.attention.self"
        qkv_w.append(np.concatenate(
            [get(f"{base}.{p}.weight").T for p in ("query", "key", "value")], axis=1))
        qkv_b.append(np.concatenate([get(f"{base}.{p}.bias") for p in ("query", "key", "value")]))
    params["layers"]["qkv_w"] = np.stack(qkv_w)
    params["layers"]["qkv_b"] = np.stack(qkv_b)
    return params, config
