"""Encoder models: BERT-family and ModernBERT sentence encoders, Mellum (a
mixture-of-experts decoder pooled at its last token) and the
encoder-backed embedding provider (recompute during search)."""

from islands_tpu_torch.models.bert import BertConfig, BertModel, encode, init_params
from islands_tpu_torch.models.encoder import (
    IMPLEMENTED_ARCHITECTURES,
    PRESETS,
    EncoderConfig,
    HashEmbedder,
    ModelArchitecture,
    SimpleTokenizer,
    TextEncoder,
)
from islands_tpu_torch.models.mellum import MellumConfig, MellumModel
from islands_tpu_torch.models.modernbert import ModernBertConfig, ModernBertModel
from islands_tpu_torch.models.provider import EncoderEmbeddingProvider

__all__ = [
    "BertConfig",
    "BertModel",
    "EncoderConfig",
    "EncoderEmbeddingProvider",
    "HashEmbedder",
    "IMPLEMENTED_ARCHITECTURES",
    "MellumConfig",
    "MellumModel",
    "ModelArchitecture",
    "ModernBertConfig",
    "ModernBertModel",
    "PRESETS",
    "SimpleTokenizer",
    "TextEncoder",
    "encode",
    "init_params",
]
