"""Quantized projection sketches: the approximate-distance gate.

Port of islands_tpu/ops/proj.py. Every node keeps an int8-quantized random
orthonormal projection of its vector, packed 4 components per int32, and
every graph row keeps an inline copy of its neighbours' sketches, so a hop
reads a few contiguous blocks instead of scattered embedding rows.

The QUERY side is pre-multiplied by the quantization scale, so stored int8
values are compared raw. Sketch distances are monotone surrogates of the
true metric, used to rank only; survivors are always rescored exactly.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from islands_tpu_torch.core.config import DistanceMetric

# Components are packed 4-per-int32.
PACK = 4


def make_projection(dim: int, proj_dims: int, seed: int = 0,
                    device=None) -> torch.Tensor:
    """Random orthonormal projection [dim, proj_dims]: QR of a Gaussian
    matrix drawn from a CPU `torch.Generator` seeded with `seed`.

    The reference draws from `jax.random`, which torch cannot reproduce, so
    the same seed gives another (equally valid) matrix; callers that need
    the reference's matrix pass it in (build_index_with_sketch(w=...))."""
    if proj_dims % PACK != 0:
        raise ValueError(f"proj_dims must be a multiple of {PACK}")
    if proj_dims > dim:
        raise ValueError("proj_dims must be <= dim")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    g = torch.randn((dim, proj_dims), generator=gen, dtype=torch.float32)
    q, _ = torch.linalg.qr(g)
    return q[:, :proj_dims].contiguous().to(device or "cpu")


def fit_scale(proj: torch.Tensor) -> torch.Tensor:
    """Global int8 quantization scale: map 4 sigma to the int8 range. The
    mean of squares accumulates in float64, so the float32 result sits
    within an ulp of the exact value, as the reference's does."""
    rms = torch.sqrt(torch.mean(proj.double() ** 2).float())
    return torch.where(rms > 0, 127.0 / (4.0 * rms), torch.ones_like(rms))


def quantize_pack(proj: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """[..., P] f32 -> [..., P/4] int32 (4 int8 components per word, the
    first in the low byte).

    The reference sums the shifted bytes in int32, which wraps when the top
    byte is >= 0x80; the words are assembled here in int64 with OR and cut
    back to int32 with the same wrap-around. torch.round rounds half to
    even, as jnp.round does."""
    p = proj.shape[-1]
    v = torch.clamp(torch.round(proj * scale), -127, 127).to(torch.int64) & 0xFF
    v = v.reshape(*proj.shape[:-1], p // PACK, PACK)
    word = v[..., 0] | (v[..., 1] << 8) | (v[..., 2] << 16) | (v[..., 3] << 24)
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def unpack_raw(packed: torch.Tensor) -> torch.Tensor:
    """[..., P/4] int32 -> [..., P] f32 of RAW int8 values (not dequantized).
    Bytes come out with an arithmetic shift and are sign-extended."""
    # Shifts 0, 8, 16, 24 made on the device: a host list copied there would
    # synchronise the stream on every hop.
    shifts = torch.arange(0, 8 * PACK, 8, dtype=torch.int32, device=packed.device)
    b = (packed[..., None] >> shifts) & 0xFF
    b = b - ((b & 0x80) << 1)
    return b.float().reshape(*packed.shape[:-1], packed.shape[-1] * PACK)


def sketch_query(q_prepped: torch.Tensor, w: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """Project prepped queries and pre-multiply by the quantization scale."""
    return (q_prepped.float() @ w) * scale


def uses_dot(metric: DistanceMetric) -> bool:
    return metric in (DistanceMetric.COSINE, DistanceMetric.DOT_PRODUCT)


def _bcast(qs: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """qs [B, P] viewed to broadcast against raw [B, ..., P]."""
    return qs.reshape(qs.shape[0], *([1] * (raw.dim() - 2)), qs.shape[-1])


def sketch_distance(qs: torch.Tensor, raw: torch.Tensor,
                    metric: DistanceMetric) -> torch.Tensor:
    """Approximate distances: qs [B, P] (scaled query sketches) vs raw
    [B, ..., P] unpacked int8 values -> [B, ...]. Ranking only."""
    qs = _bcast(qs, raw)
    if uses_dot(metric):
        return -torch.sum(raw * qs, dim=-1)
    diff = raw - qs
    return torch.sum(diff * diff, dim=-1)


def sketch_distance_calibrated(qs: torch.Tensor, raw: torch.Tensor,
                               metric: DistanceMetric, scale: torch.Tensor,
                               dim: int) -> torch.Tensor:
    """Approximate distances on the TRUE metric's scale (for an orthonormal
    W [dim, P], E|W^T v|^2 = (P/dim)|v|^2; both sides carry one factor of
    `scale`). Manhattan uses the Gaussian L1/L2 ratio sqrt(2 dim / pi)."""
    p = raw.shape[-1]
    inv = (dim / p) / (scale * scale)
    qs = _bcast(qs, raw)
    if metric == DistanceMetric.DOT_PRODUCT:
        return -torch.sum(raw * qs, dim=-1) * inv
    if metric == DistanceMetric.COSINE:
        return 1.0 - torch.sum(raw * qs, dim=-1) * inv
    diff = raw - qs
    l2 = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1) * inv, min=0.0))
    if metric == DistanceMetric.MANHATTAN:
        # A device fill, not a host copy, so a CUDA graph can capture it.
        return l2 * torch.sqrt(torch.full((), 2.0 * dim / math.pi,
                                          dtype=torch.float32, device=l2.device))
    return l2


@dataclasses.dataclass
class SketchIndex:
    """Sketch bundle for gated search over a built graph.

    - w: [dim, P] projection
    - scale: f32 scalar tensor, the quantization scale
    - node_sketch: [N, P/4] int32 packed per-node sketches
    - nbr_sketch: [N, M * P/4] int32 inline neighbour sketches, row-aligned
      with CsrGraph.neighbors (row i is the [M, P/4] block flattened)
    """

    w: torch.Tensor
    scale: torch.Tensor
    node_sketch: torch.Tensor
    nbr_sketch: torch.Tensor

    @property
    def proj_dims(self) -> int:
        return self.w.shape[1]

    def storage_bytes(self) -> int:
        return (4 * self.w.numel() + 4 + 4 * self.node_sketch.numel()
                + 4 * self.nbr_sketch.numel())


def build_sketch_index(x_prepped: torch.Tensor, neighbors: torch.Tensor,
                       proj_dims: int = 16, seed: int = 0,
                       w: torch.Tensor | None = None) -> SketchIndex:
    """Derive a SketchIndex for an existing graph (one gather pass). `w`
    overrides the projection drawn from `seed`."""
    if w is None:
        w = make_projection(x_prepped.shape[1], proj_dims, seed, x_prepped.device)
    w = w.to(x_prepped.device, torch.float32)
    proj = x_prepped.float() @ w
    scale = fit_scale(proj)
    node_sketch = quantize_pack(proj, scale)
    n = x_prepped.shape[0]
    nbr_sketch = node_sketch[torch.clamp(neighbors.long(), 0, n - 1)].reshape(n, -1)
    return SketchIndex(w=w, scale=scale, node_sketch=node_sketch,
                       nbr_sketch=nbr_sketch)
