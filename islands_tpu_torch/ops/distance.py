"""Batched distance functions.

Port of islands_tpu/ops/distance.py, batch-major:
- cosine(a, b)   = 1 - a.b / (|a||b|), zero vectors -> 1.0
- euclidean      = sqrt(sum (a-b)^2)
- dotproduct     = -a.b
- manhattan      = sum |a-b|

The reference runs these matmuls at Precision.HIGHEST (full float32). So
`pairwise_distance` and `rowwise_distance` (and `brute_force_topk` and the
search scorers through them) turn TF32 off for their own products only
(`full_f32`), and leave the caller's setting as they found it. TF32 keeps
~3 decimal digits and would reorder near neighbours on the exact-distance
paths.
"""

from __future__ import annotations

import contextlib

import torch

from islands_tpu_torch.core.config import DistanceMetric
from islands_tpu_torch.ops.merge import smallest_k


@contextlib.contextmanager
def full_f32():
    """CUDA float32 matmuls at full precision inside the block (or the
    decorated function); the process-wide TF32 setting is restored on the
    way out."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """L2-normalize; zero vectors stay zero."""
    norm = torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True))
    return torch.where(norm > eps, v / torch.clamp(norm, min=1e-30),
                       torch.zeros_like(v))


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


@full_f32()
def pairwise_distance(q: torch.Tensor, x: torch.Tensor,
                      metric: DistanceMetric = DistanceMetric.COSINE,
                      squared: bool = False) -> torch.Tensor:
    """Distance matrix between q [..., B, d] and x [..., N, d] -> [..., B, N]
    float32 (leading dims batch). `squared=True` skips the EUCLIDEAN sqrt."""
    q = q.float()
    x = x.float()
    if metric == DistanceMetric.COSINE:
        return 1.0 - normalize(q) @ normalize(x).transpose(-1, -2)
    if metric == DistanceMetric.EUCLIDEAN:
        d2 = (_sq_norms(q)[..., :, None] + _sq_norms(x)[..., None, :]
              - 2.0 * (q @ x.transpose(-1, -2)))
        d2 = torch.clamp(d2, min=0.0)
        return d2 if squared else torch.sqrt(d2)
    if metric == DistanceMetric.DOT_PRODUCT:
        return -(q @ x.transpose(-1, -2))
    if metric == DistanceMetric.MANHATTAN:
        return torch.sum(torch.abs(q[..., :, None, :] - x[..., None, :, :]), dim=-1)
    raise ValueError(f"unknown metric: {metric}")


@full_f32()
def rowwise_distance(q: torch.Tensor, rows: torch.Tensor,
                     metric: DistanceMetric = DistanceMetric.COSINE) -> torch.Tensor:
    """Per-query distances to gathered rows: q [B, d] vs rows [B, E, d] ->
    [B, E]. Inputs are prepped (prep_query/prep_corpus), so COSINE is
    1 - dot. The reference's `rowwise_distance` (one query, vmapped) and
    `rows_distance` (already batched) are this one function batch-major."""
    q = q.float()
    rows = rows.float()
    if metric in (DistanceMetric.COSINE, DistanceMetric.DOT_PRODUCT):
        sim = torch.bmm(rows, q[:, :, None])[..., 0]
        return 1.0 - sim if metric == DistanceMetric.COSINE else -sim
    if metric == DistanceMetric.EUCLIDEAN:
        diff = rows - q[:, None, :]
        return torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=0.0))
    if metric == DistanceMetric.MANHATTAN:
        return torch.sum(torch.abs(rows - q[:, None, :]), dim=-1)
    raise ValueError(f"unknown metric: {metric}")


rows_distance = rowwise_distance


def distance(a: torch.Tensor, b: torch.Tensor,
             metric: DistanceMetric = DistanceMetric.COSINE) -> torch.Tensor:
    """Scalar distance between two vectors [d] (a 0-d tensor). EUCLIDEAN
    and MANHATTAN take the difference of the vectors, so distance(a, a) is
    0: the reference's |a|^2 + |b|^2 - 2 a.b gives 0 there only because
    XLA rounds its norms and its dot alike, which torch's sum and matmul
    do not."""
    if metric in (DistanceMetric.EUCLIDEAN, DistanceMetric.MANHATTAN):
        return rowwise_distance(a[None, :], b[None, None, :], metric)[0, 0]
    return pairwise_distance(a[None, :], b[None, :], metric)[0, 0]


def prep_query(q: torch.Tensor, metric: DistanceMetric) -> torch.Tensor:
    """Normalize for COSINE (so rowwise_distance is a dot); identity else."""
    q = q.float()
    return normalize(q) if metric == DistanceMetric.COSINE else q


def prep_corpus(x: torch.Tensor, metric: DistanceMetric) -> torch.Tensor:
    x = x.float()
    return normalize(x) if metric == DistanceMetric.COSINE else x


def brute_force_topk(q: torch.Tensor, x: torch.Tensor, k: int,
                     metric: DistanceMetric = DistanceMetric.COSINE,
                     batch: int = 8192, dist_fn=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by full scan, the recall oracle. Returns (dists [B, k],
    ids [B, k]) ascending; scans `x` in chunks of `batch` rows. Each chunk's
    distance matrix is `pairwise_distance` under `metric`, or
    `dist_fn(q, chunk)` when given (the ops API's kernels, say).

    The reference keeps the best k with lax.top_k, which puts the lower
    index first on ties; `smallest_k` of [best ++ chunk] keeps the same
    entries in the same order (torch.topk promises no tie order)."""
    if dist_fn is None:
        def dist_fn(a, c):
            return pairwise_distance(a, c, metric)
    n = x.shape[0]
    b = q.shape[0]
    best_d = torch.full((b, k), float("inf"), dtype=torch.float32, device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    for start in range(0, n, batch):
        stop = min(start + batch, n)
        d = dist_fn(q, x[start:stop])
        ids = torch.arange(start, stop, dtype=torch.int32,
                           device=q.device)[None, :].expand(b, -1)
        all_d = torch.cat([best_d, d], dim=1)
        all_i = torch.cat([best_i, ids], dim=1)
        pos = smallest_k(all_d, k)
        best_d = all_d.gather(1, pos)
        best_i = all_i.gather(1, pos)
    return best_d, best_i
