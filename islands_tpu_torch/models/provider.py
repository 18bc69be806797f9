"""Encoder-backed embedding provider: the id -> text -> embedding bridge.

Port of islands_tpu/models/provider.py. Texts are tokenized once into an
[N, L] token table on the encoder's device, and `embed(ids)` gathers the
ids' token rows and runs the encoder on them: LEANN's per-hop recompute.

The reference's provider always runs the BERT forward, whatever the
encoder's architecture, so a provider over a ModernBERT encoder fails there.
This one runs the encoder's own module (models/bert.encode takes either).

Over a packed encoder (`TextEncoder.packed`: ModernBERT, Mellum) the rows
are not padded: `embed` reads the gathered rows' lengths to the host once,
and the model's `pooled_rows` packs their valid tokens end to end
(`modernbert.pack_rows`) and runs its `forward_packed` on chunks of whole
rows of at most its `PACK_TOKENS` tokens (mean pooled for ModernBERT, the
last token's state for Mellum). A BERT encoder
keeps its padded rows and its chunks of EMBED_CHUNK_BATCHES batches; on
CUDA a chunk of a recurring, small enough shape replays `bert.encode`'s
graph of it.
`with_center`, and so the build, take the same route as `embed`.

Tracing (utils/tracing): `embed` is the region "provider.embed" and counts
"provider.rows", the rows it encodes; each encoder call inside it is a
region "encoder.forward"; on the packed route the length read, and inside
"encoder.forward" each chunk's packing, are regions "encoder.pack".
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from islands_tpu_torch.device import to_device
from islands_tpu_torch.models.bert import encode
from islands_tpu_torch.models.encoder import TextEncoder
from islands_tpu_torch.utils.tracing import count, region

#: `embed` runs the encoder on at most EncoderConfig.batch_size times this
#: many rows at once (4096 rows at the default batch size of 64); a hop that
#: asks for more is encoded in chunks.
EMBED_CHUNK_BATCHES = 64


class EncoderEmbeddingProvider:
    """EmbeddingProvider over (encoder, token table).

    `from_texts` tokenizes the corpus up front and keeps only int32 token
    ids on the device. With a `center` (see `with_center`) the corpus mean
    is subtracted from every pooled output and the in-encode L2 norm is
    skipped: centring acts on the raw pooled output, and the metric's prep
    normalizes again for cosine.
    """

    def __init__(self, encoder: TextEncoder, token_ids, token_mask, center=None):
        self.encoder = encoder
        dev = encoder.device
        self.token_ids = to_device(token_ids, dev, torch.int32)
        self.token_mask = to_device(token_mask, dev, torch.int32)
        self._n = int(self.token_ids.shape[0])
        self.center = (to_device(center, dev, torch.float32) if center is not None
                       else torch.zeros((encoder.dimension,), dtype=torch.float32, device=dev))
        self._centered = center is not None
        self._normalize = encoder.config.normalize and not self._centered
        # Packed route: each row's valid tokens (its mask is a prefix of ones).
        self._lengths = self.token_mask.sum(dim=1) if encoder.packed else None

    def _encode_rows(self, ids: torch.Tensor, normalize: bool) -> torch.Tensor:
        """Pooled outputs [n, d] of the token rows `ids` (clamped into
        range), in chunks of the encoder's batch size x EMBED_CHUNK_BATCHES."""
        safe = torch.clamp(ids.reshape(-1).long(), 0, max(self._n, 1) - 1)
        if self._lengths is not None:
            return self._encode_packed(safe, normalize)
        chunk = self.encoder.config.batch_size * EMBED_CHUNK_BATCHES
        parts = []
        for s in range(0, safe.numel(), chunk):
            rows = safe[s:s + chunk]
            with region("encoder.forward"):
                parts.append(encode(self.encoder.model, self.token_ids[rows],
                                    self.token_mask[rows], normalize))
        if len(parts) == 1:
            return parts[0]  # encode's own fresh tensor
        return (torch.cat(parts) if parts else
                torch.empty((0, self.dimension), dtype=torch.float32, device=self.device))

    def _encode_packed(self, rows: torch.Tensor, normalize: bool) -> torch.Tensor:
        """Pooled outputs [n, d] of the token rows `rows` (in range), their
        valid tokens packed, in chunks of at most PACK_TOKENS tokens."""
        with region("encoder.pack"):
            lens = self._lengths[rows].cpu().numpy()
        with region("encoder.forward"):
            pooled = self.encoder.model.pooled_rows(self.token_ids, rows, lens)
        return F.normalize(pooled, dim=-1, eps=1e-12) if normalize else pooled

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        """ids [...] -> embeddings [..., d] float32 on the provider's device.
        Out-of-range ids are clamped (callers mask them)."""
        with region("provider.embed"):
            ids = to_device(ids, self.device)
            count("provider.rows", ids.numel())
            rows = self._encode_rows(ids, self._normalize) - self.center
            return rows.view(*ids.shape, self.dimension)

    def with_center(self, sample: int = 8192, batch: int = 256) -> "EncoderEmbeddingProvider":
        """A provider that subtracts the corpus mean from every embedding,
        the standard anisotropy correction: random-init transformer
        sentence embeddings share a dominant component that compresses
        cosine contrast. The mean is over the raw (un-normalized) pooled
        outputs of the first `sample` items, summed `batch` at a time."""
        take = min(sample, max(self._n, 1))
        acc = torch.zeros((self.dimension,), dtype=torch.float32, device=self.device)
        for s in range(0, take, batch):
            ids = torch.arange(s, min(s + batch, take), device=self.device)
            acc = acc + torch.sum(self._encode_rows(ids, normalize=False), dim=0)
        return EncoderEmbeddingProvider(self.encoder, self.token_ids, self.token_mask,
                                        center=acc / take)

    @staticmethod
    def from_texts(encoder: TextEncoder, texts: list[str],
                   pad_to: int | None = None) -> "EncoderEmbeddingProvider":
        L = pad_to or (None if encoder.packed else encoder.config.max_seq_length)
        ids, mask = encoder.tokenize(texts, pad_to=L)
        return EncoderEmbeddingProvider(encoder, ids, mask)

    @property
    def dimension(self) -> int:
        return self.encoder.dimension

    @property
    def num_items(self) -> int:
        return self._n

    @property
    def device(self) -> torch.device:
        return self.encoder.device

    def compute_embedding(self, item_id: int) -> np.ndarray:
        return self.compute_embeddings_batch([item_id])[0]

    def compute_embeddings_batch(self, ids) -> np.ndarray:
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.int32)
        return self.embed(ids).cpu().numpy()
