"""Row gather: kernel K5.

Port of the row gather of benches/gather_bench.py (`pallas_gather`, kernel
`_gather_kernel`): out[i] = x[ids[i]] for x [N, D] of 4-byte elements
(float32 or int32) and int32 ids [K]. Both the kernel (`csrc/row_gather.cu`)
and the plain version clamp ids to [0, N-1], as the bench's callers do
before the call, so they agree bit for bit on every input; unlike the TPU
kernel, every K is taken (it writes no row past its last full 1024-row
chunk).

`row_gather` runs the plain version on CPU tensors and launches the kernel
on CUDA tensors, counted in `row_gather.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from islands_tpu_torch.ops import _cuda


def _check(x: torch.Tensor, ids: torch.Tensor) -> None:
    if x.dim() != 2 or x.element_size() != 4:
        raise TypeError(f"row_gather copies rows of 4-byte elements [N, D], got "
                        f"{x.dtype} {tuple(x.shape)}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise TypeError(f"row_gather wants int32 ids [K], got {ids.dtype} "
                        f"{tuple(ids.shape)}")
    if x.device != ids.device:
        raise ValueError("row_gather inputs must share one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"row_gather runs on cuda or cpu, not {x.device}")
    if x.shape[0] == 0 and ids.numel() > 0:
        raise ValueError("row_gather: no rows to gather from")


def row_gather_reference(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: x[clamp(ids, 0, N-1)]."""
    return x[torch.clamp(ids.long(), 0, max(x.shape[0] - 1, 0))]


def row_gather(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """K5: x [N, D] (4-byte elements), int32 ids [K] -> [K, D], ids clamped
    to [0, N-1]."""
    _check(x, ids)
    if x.device.type == "cpu":
        return row_gather_reference(x, ids)
    x, ids = x.contiguous(), ids.contiguous()
    k = ids.shape[0]
    n, d = x.shape
    out = torch.empty((k, d), dtype=x.dtype, device=x.device)
    if k == 0 or d == 0:
        return out
    fn = _cuda.entry("row_gather", "row_gather_launch",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), ids.data_ptr(), out.data_ptr(), k, n, d, stream)
    _cuda.check("row_gather", status)
    row_gather.launches += 1
    return out


row_gather.launches = 0
