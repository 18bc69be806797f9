"""Exact nearest neighbours by brute force, in blocks of queries.

Candidates come from a float32 scan with TF32 off; their distances are
then computed again in float64 and the best k kept, so ties and rounding
in the scan cannot change the top k. `tf32_topk` is the control: the same
scan with its product's operands rounded to TF32, as a tensor core takes
them, and no float64 pass.
"""

from __future__ import annotations

import torch

EUCLIDEAN, COSINE = "euclidean", "cosine"


def full_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def distances64(q: torch.Tensor, rows: torch.Tensor, metric: str) -> torch.Tensor:
    """q [Q, d] against rows [Q, k, d] -> [Q, k] float64."""
    q, rows = q.double(), rows.double()
    if metric == EUCLIDEAN:
        return torch.sqrt(torch.sum((rows - q[:, None, :]) ** 2, dim=-1))
    if metric == COSINE:
        dot = torch.sum(rows * q[:, None, :], dim=-1)
        norms = torch.linalg.vector_norm(rows, dim=-1) * torch.linalg.vector_norm(q, dim=-1)[:, None]
        return 1.0 - dot / norms
    raise ValueError(f"unknown metric {metric!r}")


def _scores(q: torch.Tensor, x: torch.Tensor, x_sq: torch.Tensor, metric: str, cast) -> torch.Tensor:
    """Distances (squared for EUCLIDEAN) of q [B, d] to every row of x."""
    prod = cast(q) @ cast(x).T
    if metric == EUCLIDEAN:
        return torch.clamp(torch.sum(q * q, dim=1)[:, None] + x_sq[None, :] - 2.0 * prod, min=0.0)
    return 1.0 - prod


def _prep(x: torch.Tensor, metric: str) -> torch.Tensor:
    x = x.float()
    if metric == COSINE:
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x


def exact_topk(q: torch.Tensor, x: torch.Tensor, k: int, metric: str, block: int = 2048,
               candidates: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """(float64 distances [Q, k], ids [Q, k] int64), ascending."""
    full_f32()
    qp, xp = _prep(q, metric), _prep(x, metric)
    x_sq = torch.sum(xp * xp, dim=1)
    c = min(candidates, x.shape[0])
    out_d, out_i = [], []
    for s in range(0, q.shape[0], block):
        sc = _scores(qp[s:s + block], xp, x_sq, metric, lambda t: t)
        cand = torch.topk(sc, c, dim=1, largest=False).indices
        d = distances64(q[s:s + block], x[cand], metric)
        d, order = torch.sort(d, dim=1, stable=True)
        out_d.append(d[:, :k])
        out_i.append(cand.gather(1, order[:, :k]))
    return torch.cat(out_d), torch.cat(out_i)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 stored mantissa bits (to nearest)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_topk(q: torch.Tensor, x: torch.Tensor, k: int, metric: str,
              block: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """The control: top k of a scan whose product runs on TF32 operands,
    with the distances that scan gives (float32; EUCLIDEAN's square root
    taken). Returns (distances [Q, k], ids [Q, k] int64)."""
    full_f32()
    qp, xp = _prep(q, metric), _prep(x, metric)
    x_sq = torch.sum(xp * xp, dim=1)
    out_d, out_i = [], []
    for s in range(0, q.shape[0], block):
        sc = _scores(qp[s:s + block], xp, x_sq, metric, round_tf32)
        d, ids = torch.topk(sc, k, dim=1, largest=False)
        out_d.append(torch.sqrt(d) if metric == EUCLIDEAN else d)
        out_i.append(ids)
    return torch.cat(out_d), torch.cat(out_i)
