"""Encoder models: BERT-family and ModernBERT sentence encoders and the
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
from islands_tpu_torch.models.modernbert import ModernBertConfig, ModernBertModel
from islands_tpu_torch.models.provider import EncoderEmbeddingProvider

__all__ = [
    "BertConfig",
    "BertModel",
    "EncoderConfig",
    "EncoderEmbeddingProvider",
    "HashEmbedder",
    "IMPLEMENTED_ARCHITECTURES",
    "ModelArchitecture",
    "ModernBertConfig",
    "ModernBertModel",
    "PRESETS",
    "SimpleTokenizer",
    "TextEncoder",
    "encode",
    "init_params",
]
