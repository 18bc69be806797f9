"""Text encoder facade: tokenization, length buckets, batched forward.

Port of islands_tpu/models/encoder.py: model presets with dimensions,
`embed_texts`, mean pooling + L2 normalize, and the architecture families
(BERT, ModernBERT and Mellum run; the others are recognized and raise). The
`HashEmbedder` is the device-free stand-in embedder.

`tokenize` pads to the reference's length buckets, so ids and masks equal
the reference's; `embed_texts` groups texts by bucket. A ModernBERT encoder
takes texts up to its `max_position_embeddings` tokens (8,192 for
modernbert-base) and runs them unpadded: `embed_texts` lays their tokens
end to end on the host for `modernbert.forward_packed`, and `bert.encode`
(so `encode_tokens`) packs each padded row's valid tokens; `tokenize` pads
to the batch's longest text, not to a bucket. Runs on CUDA unless `device="cpu"`.

Mellum (models/mellum.py, a mixture-of-experts decoder pooled at its last
token) takes the packed route as ModernBERT does. Its weights are device
tensors: `TextEncoder(weights, MellumConfig(...), device=...)` keeps the
dict it is given (moving a tensor only if it lies on another device), and
`from_preset` draws them on the encoder's device, so its 11.9B parameters
never pass through the host. The port has no loader of Mellum's published
checkpoint (`from_pretrained` raises for it).
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import itertools
import json
from pathlib import Path

import numpy as np
import torch

from islands_tpu_torch import convert
from islands_tpu_torch.device import resolve_device, to_device
from islands_tpu_torch.models import bert as bert_mod
from islands_tpu_torch.models import mellum as mellum_mod
from islands_tpu_torch.models import modernbert as modernbert_mod
from islands_tpu_torch.utils.tracing import region


class ModelArchitecture(str, enum.Enum):
    """Embedder architecture families. BERT, ModernBERT and Mellum have
    forwards (models/bert.py, models/modernbert.py, models/mellum.py); the
    others are recognized and raise until an implementation lands."""

    BERT = "bert"
    MODERNBERT = "modernbert"
    MELLUM = "mellum"
    JINA_BERT = "jina-bert"
    CLIP = "clip"
    COLBERT = "colbert"
    COLPALI = "colpali"
    SPLADE = "splade"

    @staticmethod
    def detect(name: str) -> "ModelArchitecture":
        """Name-based detection from a model id or path; BERT by default."""
        n = name.lower()
        for pat, arch in (
            ("modernbert", ModelArchitecture.MODERNBERT),
            ("mellum", ModelArchitecture.MELLUM),
            ("colpali", ModelArchitecture.COLPALI),
            ("colbert", ModelArchitecture.COLBERT),
            ("splade", ModelArchitecture.SPLADE),
            ("clip", ModelArchitecture.CLIP),
            ("jina", ModelArchitecture.JINA_BERT),
        ):
            if pat in n:
                return arch
        return ModelArchitecture.BERT


IMPLEMENTED_ARCHITECTURES = frozenset(
    {ModelArchitecture.BERT, ModelArchitecture.MODERNBERT, ModelArchitecture.MELLUM}
)

#: Model presets: name -> (config factory, embedding dimension)
PRESETS = {
    "minilm-l6": (bert_mod.BertConfig.minilm_l6, 384),
    "minilm-l12": (bert_mod.BertConfig.minilm_l12, 384),
    "bge-small": (bert_mod.BertConfig.bge_small, 384),
    "bge-base": (bert_mod.BertConfig.bge_base, 768),
    "bge-large": (bert_mod.BertConfig.bge_large, 1024),
    "tiny-test": (bert_mod.BertConfig.tiny_test, 64),
    "modernbert-base": (modernbert_mod.ModernBertConfig.modernbert_base, 768),
    "modernbert-large": (modernbert_mod.ModernBertConfig.modernbert_large, 1024),
    "modernbert-tiny-test": (modernbert_mod.ModernBertConfig.tiny_test, 64),
    "mellum2-12b-a2.5b": (mellum_mod.MellumConfig.mellum2_12b_a2_5b, 2304),
    "mellum-tiny-test": (mellum_mod.MellumConfig.tiny_test, 64),
}

#: Sequence-length buckets (the largest is the max_seq_length of 256).
DEFAULT_BUCKETS = (32, 64, 128, 256)


class SimpleTokenizer:
    """Deterministic hash tokenizer: lowercase, split on whitespace and
    punctuation, each token -> a stable hash bucket in [reserved, vocab).
    Needs no files; gives the reference's ids exactly."""

    CLS, SEP, PAD = 101, 102, 0
    _RESERVED = 999

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size

    def _token_id(self, token: str) -> int:
        h = int.from_bytes(hashlib.md5(token.encode()).digest()[:4], "little")
        return self._RESERVED + h % (self.vocab_size - self._RESERVED)

    def encode(self, text: str, max_length: int) -> list[int]:
        out = [self.CLS]
        word = []
        for ch in text.lower():
            if ch.isalnum():
                word.append(ch)
            else:
                if word:
                    out.append(self._token_id("".join(word)))
                    word = []
                if not ch.isspace() and ch != "":
                    out.append(self._token_id(ch))
            if len(out) >= max_length - 1:
                break
        if word and len(out) < max_length - 1:
            out.append(self._token_id("".join(word)))
        out.append(self.SEP)
        return out[:max_length]


class HfTokenizer:
    """Local HuggingFace tokenizer (a path only, never a download).
    `transformers` is imported here, at construction."""

    def __init__(self, path: str | Path):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(str(path), local_files_only=True)
        self.vocab_size = self._tok.vocab_size

    def encode(self, text: str, max_length: int) -> list[int]:
        return self._tok.encode(text, truncation=True, max_length=max_length)


@dataclasses.dataclass
class EncoderConfig:
    """Encoding knobs: batch size, max length, normalization, buckets.
    `max_seq_length` None is the architecture's own limit: 256 tokens (the
    largest bucket) for BERT, `max_position_embeddings` for the packed
    architectures (ModernBERT, Mellum)."""

    max_seq_length: int | None = None
    batch_size: int = 64
    normalize: bool = True
    buckets: tuple[int, ...] = DEFAULT_BUCKETS


def _architecture(model_config) -> ModelArchitecture:
    if isinstance(model_config, modernbert_mod.ModernBertConfig):
        return ModelArchitecture.MODERNBERT
    if isinstance(model_config, mellum_mod.MellumConfig):
        return ModelArchitecture.MELLUM
    return ModelArchitecture.BERT


def architecture_module(model_config):
    """models/modernbert.py for a ModernBertConfig, models/mellum.py for a
    MellumConfig, else models/bert.py: the module whose `init_params` draws
    the architecture's weights (and, for the packed ones, whose
    `token_chunks` and `forward_packed` the text encoder packs with)."""
    return {ModelArchitecture.MODERNBERT: modernbert_mod,
            ModelArchitecture.MELLUM: mellum_mod}.get(_architecture(model_config), bert_mod)


def build_model(params: dict, model_config, device=None) -> torch.nn.Module:
    """The architecture's module for its parameters: reference-layout numpy
    arrays for BERT and ModernBERT, a dict of tensors kept as given for
    Mellum."""
    arch = _architecture(model_config)
    if arch is ModelArchitecture.MELLUM:
        return mellum_mod.MellumModel(model_config, params, device)
    if arch is ModelArchitecture.MODERNBERT:
        return convert.modernbert_from_numpy(params, model_config, device)
    return convert.bert_from_numpy(params, model_config, device)


def _pad(seqs: list[list[int]], length: int) -> tuple[np.ndarray, np.ndarray]:
    """Token lists cut or zero-padded to `length` -> (ids, mask) int32 [n, length]."""
    ids = np.zeros((len(seqs), length), dtype=np.int32)
    mask = np.zeros((len(seqs), length), dtype=np.int32)
    for i, sq in enumerate(seqs):
        sq = sq[:length]
        ids[i, : len(sq)] = sq
        mask[i, : len(sq)] = 1
    return ids, mask


class TextEncoder:
    """Batched sentence encoder.

    `TextEncoder.from_preset("minilm-l6")` gives a random-init model;
    `TextEncoder.from_pretrained(path)` loads local HF weights. `params` are
    in the reference's layout (numpy); the module is built from them on
    `device` (CUDA unless `device="cpu"`).
    """

    def __init__(self, params: dict, model_config, tokenizer=None,
                 config: EncoderConfig | None = None, device=None):
        self.device = resolve_device(device)
        self.model_config = model_config
        self.architecture = _architecture(model_config)
        self.model = build_model(params, model_config, self.device)
        self.tokenizer = tokenizer or SimpleTokenizer(model_config.vocab_size)
        config = config or EncoderConfig()
        limit = config.max_seq_length
        if limit is None:
            limit = model_config.max_position_embeddings if self.packed else DEFAULT_BUCKETS[-1]
        self.config = dataclasses.replace(
            config,
            max_seq_length=min(limit, model_config.max_position_embeddings),
            buckets=tuple(b for b in config.buckets
                          if b <= model_config.max_position_embeddings)
            or (model_config.max_position_embeddings,),
        )

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_preset(name: str, seed: int = 0, config: EncoderConfig | None = None,
                    device=None) -> "TextEncoder":
        if name not in PRESETS:
            raise ValueError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
        factory, _ = PRESETS[name]
        mc = factory()
        if isinstance(mc, mellum_mod.MellumConfig):  # drawn where it runs
            params = mellum_mod.init_params(mc, seed, resolve_device(device))
        else:
            params = architecture_module(mc).init_params(mc, seed)
        return TextEncoder(params, mc, config=config, device=device)

    @staticmethod
    def from_pretrained(path: str | Path, config: EncoderConfig | None = None,
                        device=None) -> "TextEncoder":
        """Load a local HF checkpoint directory; the architecture comes from
        config.json's model_type, else from the path's name. Unimplemented
        architectures raise."""
        path = Path(path)
        model_type = ""
        cfg_path = path / "config.json"
        if cfg_path.exists():
            model_type = json.loads(cfg_path.read_text()).get("model_type", "")
        arch = ModelArchitecture.detect(model_type or str(path))
        if arch is ModelArchitecture.MELLUM:
            raise NotImplementedError(
                "architecture 'mellum' runs from weights handed to TextEncoder; the port "
                "has no loader of its published checkpoint")
        if arch not in IMPLEMENTED_ARCHITECTURES:
            raise NotImplementedError(
                f"architecture {arch.value!r} is recognized but has no forward "
                f"yet; implemented: "
                f"{sorted(a.value for a in IMPLEMENTED_ARCHITECTURES)}")
        mod = modernbert_mod if arch is ModelArchitecture.MODERNBERT else bert_mod
        params, mc = mod.load_hf_checkpoint(path)
        try:
            tok = HfTokenizer(path)
        except Exception:  # no tokenizer files or no transformers: the hash tokenizer
            tok = SimpleTokenizer(mc.vocab_size)
        return TextEncoder(params, mc, tokenizer=tok, config=config, device=device)

    # -- properties --------------------------------------------------------

    @property
    def dimension(self) -> int:
        """Embedding dimension: the architecture's hidden size."""
        return self.model_config.hidden_size

    @property
    def packed(self) -> bool:
        """True where the model runs unpadded (ModernBERT, Mellum)."""
        return self.architecture in (ModelArchitecture.MODERNBERT, ModelArchitecture.MELLUM)

    # -- tokenization ------------------------------------------------------

    def _bucket_for(self, length: int) -> int:
        for b in self.config.buckets:
            if length <= b:
                return b
        return self.config.buckets[-1]

    def tokenize(self, texts: list[str],
                 pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Encode and pad a batch to a bucket length (a packed encoder: the
        longest text), or to `pad_to`. Returns (ids [B, L], mask [B, L])
        int32 numpy."""
        seqs = [self.tokenizer.encode(t, self.config.max_seq_length) for t in texts]
        max_len = max((len(s) for s in seqs), default=1)
        return _pad(seqs, pad_to or (max_len if self.packed else self._bucket_for(max_len)))

    # -- encoding ----------------------------------------------------------

    def encode_tokens(self, ids, mask) -> torch.Tensor:
        """ids + mask [B, L] -> embeddings [B, d] float32 on the encoder's
        device (traced as the region "encoder.forward")."""
        with region("encoder.forward"):
            return bert_mod.encode(self.model, to_device(ids, self.device),
                                   to_device(mask, self.device), self.config.normalize)

    def embed_texts(self, texts: list[str]) -> np.ndarray:
        """Batch-encode texts -> [n, dim] float32. Batches are grouped by
        length bucket, then put back in input order; a packed encoder packs
        them instead (`_embed_packed`)."""
        if not texts:
            return np.zeros((0, self.dimension), dtype=np.float32)
        seqs = [self.tokenizer.encode(t, self.config.max_seq_length) for t in texts]
        if self.packed:
            return self._embed_packed(seqs)
        order = sorted(range(len(texts)), key=lambda i: len(seqs[i]))
        out = np.zeros((len(texts), self.dimension), dtype=np.float32)
        bs = self.config.batch_size
        for s in range(0, len(order), bs):
            idxs = order[s : s + bs]
            bucket = self._bucket_for(max(len(seqs[i]) for i in idxs))
            ids, mask = _pad([seqs[i] for i in idxs], bucket)
            out[idxs] = self.encode_tokens(ids, mask).cpu().numpy()
        return out

    def _embed_packed(self, seqs: list[list[int]]) -> np.ndarray:
        """Token lists -> [n, dim] float32 through the packed forward: each
        run of whole texts of at most the architecture's `PACK_TOKENS`
        tokens (its `token_chunks`) is laid end to end on the host and sent
        to the device as one flat [tokens] table (traced as
        "encoder.pack"), never a padded one."""
        mod = architecture_module(self.model_config)
        lens = np.array([len(sq) for sq in seqs], dtype=np.int64)
        out = np.zeros((len(seqs), self.dimension), dtype=np.float32)
        for s, e in mod.token_chunks(lens):
            with region("encoder.pack"):
                flat = np.fromiter(itertools.chain.from_iterable(seqs[s:e]), dtype=np.int32,
                                   count=int(lens[s:e].sum()))
                ids = to_device(flat, self.device, torch.int32)
                segs = modernbert_mod.Segments.from_lengths(lens[s:e], self.device)
            with region("encoder.forward"):
                pooled = mod.forward_packed(self.model, ids, segs)
            if self.config.normalize:
                pooled = torch.nn.functional.normalize(pooled, dim=-1, eps=1e-12)
            out[s:e] = pooled.cpu().numpy()
        return out

    def embed_text(self, text: str) -> np.ndarray:
        return self.embed_texts([text])[0]


class HashEmbedder:
    """Deterministic text -> vector embedder with no model: stable feature
    hashing + L2 norm, the device-free stand-in for the cloud and test
    embedders."""

    def __init__(self, dimension: int = 384, seed: int = 0):
        self._dimension = dimension
        self._seed = seed

    @property
    def dimension(self) -> int:
        return self._dimension

    def embed_texts(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self._dimension), dtype=np.float32)
        for i, t in enumerate(texts):
            for word in t.lower().split():
                h = hashlib.md5(f"{self._seed}:{word}".encode()).digest()
                idx = int.from_bytes(h[:4], "little") % self._dimension
                sign = 1.0 if h[4] % 2 == 0 else -1.0
                out[i, idx] += sign
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-12)

    def embed_text(self, text: str) -> np.ndarray:
        return self.embed_texts([text])[0]
