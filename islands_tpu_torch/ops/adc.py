"""ADC (asymmetric distance) table lookups of the PQ paths: kernels K2 and K3.

Port of islands_tpu/ops/pallas_kernels.py's two ADC ops:
- `gated_adc_sums` (K2, `_gated_adc_kernel`): each query scores its OWN
  candidates, out[b, e] = sum_s bf16(tables[b, s, codes[b, e, s]]) with the
  sum in f32. The two-level hop's approximate scorer.
- `adc_scan` (K3, `_adc_kernel`): every query scores every code row,
  out[b, i] = sum_s tables[b, s, codes[i, s]] in full f32. The PQ scan.

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
    fn = _cuda.load("gated_adc").gated_adc_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
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
    fn = _cuda.load("adc_scan").adc_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(tables.data_ptr(), codes.data_ptr(), codes.element_size(),
                    out.data_ptr(), b, n, s, k, stream)
    _cuda.check("adc_scan", status)
    adc_scan.launches += 1
    return out


adc_scan.launches = 0
