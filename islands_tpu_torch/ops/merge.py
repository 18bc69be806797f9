"""Fixed-shape sorted-pool maintenance for the search hop loops.

Port of islands_tpu/ops/merge.py. The pool is a fixed-width ascending list
per query; each hop's discoveries are sorted descending, laid after the pool
with +inf padding between the runs (a bitonic sequence), and merged in
log2(L) compare-exchange stages.

Order rules the port must keep to match the reference bit for bit:
- `jax.lax.sort` and `jnp.argsort` are stable and compare floats as numbers
  (-0.0 == +0.0): `argsort` is a stable sort with zeros made equal.
- `lax.top_k` puts the lower index first on ties but compares floats in IEEE
  total order (-0.0 below +0.0 when negated): `smallest_k` sorts the int32
  keys of `sort_key` stably. `torch.topk` promises no tie order.
- The merge swaps a pair only when lo > hi, strictly: equal distances keep
  their slots, so ids on ties come out as the reference's do.

Distances must be non-NaN (inf padding is fine).
"""

from __future__ import annotations

import torch


def pack_id_expanded(ids: torch.Tensor, expanded: torch.Tensor) -> torch.Tensor:
    """Pack (id int32 < 2^30, expanded bool) into one int32: id*2 + expanded.
    SENTINEL (-1) ids with expanded=True pack to -1 and round-trip."""
    return (ids.to(torch.int32) << 1) | expanded.to(torch.int32)


def unpack_id_expanded(code: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of pack_id_expanded: -> (ids, expanded)."""
    return code >> 1, (code & 1).bool()


def sort_key(d: torch.Tensor) -> torch.Tensor:
    """int32 keys whose order is the IEEE total order of float32 `d`."""
    k = d.to(torch.float32).contiguous().view(torch.int32)
    return k ^ ((k >> 31) & 0x7FFFFFFF)


def argsort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Stable ascending argsort along `dim`, as jnp.argsort / lax.sort order:
    equal keys keep their input order and -0.0 equals +0.0 (x + 0.0 turns
    -0.0 into +0.0 whatever the backend's sort does with signed zeros)."""
    return torch.argsort(x + 0.0 if x.is_floating_point() else x, dim=dim, stable=True)


def smallest_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest entries along the last axis, in the order
    `lax.top_k(-x, k)` returns them: ascending, lower index first on ties,
    floats in total order."""
    key = sort_key(x) if x.is_floating_point() else x
    return torch.argsort(key, dim=-1, stable=True)[..., :k]


def bitonic_merge(d: torch.Tensor, aux: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort a BITONIC sequence (ascending run then descending run) of
    power-of-two length L ascending along the last axis, carrying `aux`.

    At stage half-size h, element j is compared with j+h inside each 2h
    block; a pair swaps only when lo > hi."""
    L = d.shape[-1]
    if L & (L - 1):
        raise ValueError(f"bitonic_merge needs power-of-two length, got {L}")
    lead = d.shape[:-1]
    h = L // 2
    while h >= 1:
        ds = d.reshape(*lead, L // (2 * h), 2, h)
        as_ = aux.reshape(*lead, L // (2 * h), 2, h)
        lo, hi = ds[..., 0, :], ds[..., 1, :]
        alo, ahi = as_[..., 0, :], as_[..., 1, :]
        swap = lo > hi
        d = torch.stack([torch.where(swap, hi, lo), torch.where(swap, lo, hi)],
                        dim=-2).reshape(*lead, L)
        aux = torch.stack([torch.where(swap, ahi, alo), torch.where(swap, alo, ahi)],
                          dim=-2).reshape(*lead, L)
        h //= 2
    return d, aux


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def merge_sorted_with_new(
    pool_d: torch.Tensor, pool_aux: torch.Tensor,
    new_d: torch.Tensor, new_aux: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge an ASCENDING pool [..., P] with UNSORTED discoveries [..., E]
    (invalid entries at +inf), returning the first P+E entries ascending.

    The discoveries are sorted descending with the reference's stable sort
    of -d (equal distances keep their input order), so asc(pool) ++ +inf pad
    ++ desc(new) is bitonic and one merge finishes."""
    p = pool_d.shape[-1]
    e = new_d.shape[-1]
    total = next_pow2(p + e)
    pad = total - p - e
    order = argsort(-new_d)
    new_d = new_d.gather(-1, order)
    new_aux = new_aux.gather(-1, order)
    lead = pool_d.shape[:-1]
    inf_pad = pool_d.new_full((*lead, pad), float("inf"))
    aux_pad = pool_aux.new_full((*lead, pad), -1)
    d = torch.cat([pool_d, inf_pad, new_d], dim=-1)
    aux = torch.cat([pool_aux, aux_pad, new_aux], dim=-1)
    d, aux = bitonic_merge(d, aux)
    return d[..., : p + e], aux[..., : p + e]
