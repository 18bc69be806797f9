"""ADC (asymmetric distance) table lookups of the PQ paths: kernels K2 and K3.

Port of islands_tpu/ops/pallas_kernels.py's two ADC ops:
- `gated_adc_sums` (K2, `_gated_adc_kernel`): each query scores its OWN
  candidates, out[b, e] = sum_s bf16(tables[b, s, codes[b, e, s]]) with the
  sum in f32. The two-level hop's approximate scorer.
- `adc_scan` (K3, `_adc_kernel`): every query scores every code row,
  out[b, i] = sum_s tables[b, s, codes[i, s]] in full f32 (route "sums").
- `adc_scan_smallest` (K3, route "smallest"): the PQ scan's selection,
  the positions of each query's r smallest finalised sums
  (`finalize_adc`), in `lax.top_k(-d, r)` order, without the [B, N] sums.

Both sums run over s = 0..S-1 in order, starting from 0, so each CUDA kernel
(`csrc/gated_adc.cu`, `csrc/adc_scan.cu`) equals its plain version here bit
for bit. K2 takes uint8 codes (<= 256 centroids), K3 uint8 or int32 (the
quantizer's codes above 256 centroids). A code outside [0, K) reads entry
K-1 in both the kernel and the plain version (the reference's one-hot reads
0 there; a trained quantizer never emits such a code).

The wrappers launch the kernel on CUDA tensors and run the plain version
only on CPU tensors; each counts its kernel launches in `.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from islands_tpu_torch.ops import _cuda
from islands_tpu_torch.ops.merge import smallest_k

# The largest r that adc_scan_smallest's own kernel takes, as the CPU sees
# it: csrc/adc_scan.cu's kMaxR (set by the per-query key lists in shared
# memory) decides the route, and smallest_max_r() reads it on the card. A
# larger r takes the "sums" route and smallest_k.
SMALLEST_MAX_R = 1024
# csrc/adc_scan.cu's metric codes for the finalise.
METRIC_CODES = {"cosine": 0, "euclidean": 1, "dotproduct": 2, "manhattan": 3}


def _check(name: str, tables: torch.Tensor, codes: torch.Tensor, codes_dim: int,
           code_dtypes: tuple = (torch.uint8,)) -> None:
    if tables.dim() != 3 or tables.dtype != torch.float32:
        raise TypeError(f"{name} wants float32 tables [B, S, K], got "
                        f"{tables.dtype} {tuple(tables.shape)}")
    if codes.dim() != codes_dim or codes.dtype not in code_dtypes:
        raise TypeError(f"{name} wants {'/'.join(map(str, code_dtypes))} codes of "
                        f"{codes_dim} dims, got {codes.dtype} {tuple(codes.shape)}")
    if codes.shape[-1] != tables.shape[1]:
        raise ValueError(f"{name}: codes have {codes.shape[-1]} subspaces, "
                         f"tables {tables.shape[1]}")
    if tables.device != codes.device:
        raise ValueError(f"{name} inputs must share one device")
    if tables.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {tables.device}")


def _table_index(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Codes as int64 table indices; a code outside [0, k) reads k-1."""
    c = codes.long()
    return torch.where((c >= 0) & (c < k), c, k - 1)


def rows_table_sums(tables: torch.Tensor, codes: torch.Tensor,
                    round_bf16: bool = False) -> torch.Tensor:
    """Each query's lookups in its own table: tables [B, S, K] f32, code
    rows [B, E, S] int -> [B, E] f32 sums over s in order, from 0. With
    `round_bf16` the table values are first rounded to bf16 (round to
    nearest even)."""
    b, s, k = tables.shape
    t = tables.to(torch.bfloat16).float() if round_bf16 else tables
    c = _table_index(codes, k)
    acc = torch.zeros(codes.shape[:2], dtype=torch.float32, device=tables.device)
    for j in range(s):
        acc = acc + t[:, j, :].gather(1, c[:, :, j])
    return acc


def gated_adc_reference(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: tables [B, S, K] f32, codes [B, E, S] int ->
    [B, E] f32. The table values are rounded to bf16, as the reference's
    bf16 one-hot einsum rounds them, and summed in f32 in s order."""
    return rows_table_sums(tables, codes, round_bf16=True)


def adc_scan_reference(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: tables [B, S, K] f32, codes [N, S] int ->
    [B, N] f32, summed in full f32 in s order."""
    b, s, k = tables.shape
    c = _table_index(codes, k)
    acc = torch.zeros((b, codes.shape[0]), dtype=torch.float32, device=tables.device)
    for j in range(s):
        acc = acc + tables[:, j, :].index_select(1, c[:, j])
    return acc


def finalize_adc(s: torch.Tensor, metric_name: str) -> torch.Tensor:
    """ADC sums -> distances on the exact metric's scale (the reference's
    pq_scan finalise)."""
    if metric_name == "cosine":
        return 1.0 + s
    if metric_name == "euclidean":
        return torch.sqrt(torch.clamp(s, min=0.0))
    return s  # dotproduct / manhattan: sums already on the metric scale


def adc_scan_smallest_reference(tables: torch.Tensor, codes: torch.Tensor, r: int,
                                metric_name: str) -> torch.Tensor:
    """Plain version of K3's "smallest" route: the positions [B, r] int64 of
    each query's r smallest finalised sums, ascending in IEEE total order,
    the lower position first on ties (`lax.top_k(-d, r)`)."""
    return smallest_k(finalize_adc(adc_scan_reference(tables, codes), metric_name), r)


def gated_adc_sums(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """K2 on tables [B, S, K] f32 and uint8 codes [B, E, S] -> [B, E] f32;
    see gated_adc_reference. Launches the kernel on CUDA tensors (counted in
    `gated_adc_sums.launches`)."""
    _check("gated_adc_sums", tables, codes, 3)
    if codes.shape[0] != tables.shape[0]:
        raise ValueError("gated_adc_sums: tables and codes differ in batch")
    if tables.device.type == "cpu":
        return gated_adc_reference(tables, codes)
    b, s, k = tables.shape
    e = codes.shape[1]
    tables, codes = tables.contiguous(), codes.contiguous()
    out = torch.empty((b, e), dtype=torch.float32, device=tables.device)
    if b == 0 or e == 0:
        return out
    fn = _cuda.entry("gated_adc", "gated_adc_launch",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(tables.data_ptr(), codes.data_ptr(), out.data_ptr(), b, e, s, k, stream)
    _cuda.check("gated_adc", status)
    gated_adc_sums.launches += 1
    return out


gated_adc_sums.launches = 0


def adc_scan(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """K3 on tables [B, S, K] f32 and uint8 or int32 codes [N, S] -> [B, N]
    f32; see adc_scan_reference. Launches the kernel on CUDA tensors
    (counted in `adc_scan.launches`); raises for tables too large for its
    shared memory (S*K > 58,112)."""
    _check("adc_scan", tables, codes, 2, (torch.uint8, torch.int32))
    if tables.device.type == "cpu":
        return adc_scan_reference(tables, codes)
    b, s, k = tables.shape
    n = codes.shape[0]
    tables, codes = tables.contiguous(), codes.contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=tables.device)
    if b == 0 or n == 0:
        return out
    fn = _cuda.entry("adc_scan", "adc_scan_launch",
                     [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p])
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(tables.data_ptr(), codes.data_ptr(), codes.element_size(),
                    out.data_ptr(), b, n, s, k, stream)
    _cuda.check("adc_scan", status)
    adc_scan.launches += 1
    return out


adc_scan.launches = 0


def _smallest_plan(b: int, n: int, s: int, k: int, r: int):
    """csrc/adc_scan.cu's plan of K3's "smallest" route at these shapes (six
    int64s for its launch), or None when the route does not take them (r
    above the kernel's largest, SMALLEST_MAX_R, or tables too wide for
    shared memory beside the lists). The C plan is the one place that
    decides the route. Builds the kernel's library."""
    plan = (ctypes.c_int64 * 6)()
    fn = _cuda.entry("adc_scan", "adc_scan_smallest_plan",
                     [ctypes.c_int, ctypes.c_int64] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                     ctypes.c_int64)
    return plan if fn(b, n, s, k, r, plan) > 0 else None


def smallest_tiles(b: int, n: int, s: int, k: int, r: int) -> int:
    """The tiles (so r-key lists per query) that K3's "smallest" kernel
    writes for B queries over N code rows of S subspaces and K centroids;
    0 when that route does not take the shapes. Builds the kernel's library."""
    plan = _smallest_plan(b, n, s, k, r)
    return plan[3] if plan is not None else 0


def smallest_max_r() -> int:
    """The largest r of the "smallest" kernel (csrc/adc_scan.cu kMaxR), which
    SMALLEST_MAX_R states for the CPU. Builds the kernel's library."""
    return _cuda.entry("adc_scan", "adc_scan_smallest_max_r", [])()


def adc_scan_smallest(tables: torch.Tensor, codes: torch.Tensor, r: int,
                      metric_name: str) -> torch.Tensor:
    """K3's "smallest" route on tables [B, S, K] f32 and uint8 or int32 codes
    [N, S] -> positions [B, r] int64; see adc_scan_smallest_reference, which
    it equals bit for bit. On CUDA tensors with r <= SMALLEST_MAX_R (and
    tables that fit beside the key lists) it launches its scan, which keeps
    each tile's r smallest keys, and its merge of the tiles' lists (counted
    once in `adc_scan_smallest.launches`); a larger r takes the "sums" route
    (adc_scan) and smallest_k."""
    _check("adc_scan_smallest", tables, codes, 2, (torch.uint8, torch.int32))
    if metric_name not in METRIC_CODES:
        raise ValueError(f"unknown metric: {metric_name}")
    b, s, k = tables.shape
    n = codes.shape[0]
    if not 0 <= r <= n:
        raise ValueError(f"adc_scan_smallest: r = {r} outside [0, {n}]")
    if tables.device.type == "cpu":
        return adc_scan_smallest_reference(tables, codes, r, metric_name)
    if b == 0 or r == 0:
        return torch.empty((b, r), dtype=torch.int64, device=tables.device)
    plan = _smallest_plan(b, n, s, k, r)
    if plan is None:
        return smallest_k(finalize_adc(adc_scan(tables, codes), metric_name), r)
    tables, codes = tables.contiguous(), codes.contiguous()
    keys = torch.empty((b, plan[3] * r), dtype=torch.int64, device=tables.device)
    pos = torch.empty((b, r), dtype=torch.int64, device=tables.device)
    fn = _cuda.entry("adc_scan", "adc_scan_smallest_launch",
                     [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                     + [ctypes.c_int, ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(tables.data_ptr(), codes.data_ptr(), codes.element_size(),
                    ctypes.addressof(plan), keys.data_ptr(), pos.data_ptr(), b, n, s, k, r,
                    METRIC_CODES[metric_name], stream)
    _cuda.check("adc_scan_smallest", status)
    adc_scan_smallest.launches += 1
    return pos


adc_scan_smallest.launches = 0
