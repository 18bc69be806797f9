"""Pairwise distance matrices of the ops API: kernel K4.

Port of islands_tpu/ops/pallas_kernels.py's `pairwise_l2` and
`pairwise_neg_dot`. The kernel runs only when asked (`use_kernel`, the
reference's off-by-default `use_pallas`); otherwise the plain version, which
is also XLA's default route in the reference. Unlike the reference, whose
TPU tile needs d >= 8, the kernel takes every d >= 1. The kernel
(`csrc/pairwise.cu`) computes |q|^2 + |x|^2 - 2 q.x (clamped at 0, sqrt
unless `squared`) or -q.x to float32 accuracy, one template for the three
modes: q.x is three TF32 products on the tensor cores (3xTF32, as the
reference's Precision.HIGHEST is bf16 passes on the MXU), the norms float32
sums.

The wrappers run the plain version on CPU tensors. On CUDA tensors with
`use_kernel` they launch the kernel, counted in `.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from islands_tpu_torch.core.config import DistanceMetric
from islands_tpu_torch.ops import _cuda
from islands_tpu_torch.ops.distance import pairwise_distance

_MODES = {"l2": 0, "l2_squared": 1, "neg_dot": 2}


def pairwise_l2_reference(q: torch.Tensor, x: torch.Tensor,
                          squared: bool = False) -> torch.Tensor:
    """Plain version of K4a: q [B, d], x [N, d] -> [B, N] float32,
    max(|q|^2 + |x|^2 - 2 q.x, 0), sqrt unless `squared` (the euclidean
    matrix of ops/distance.py, the reference's formula)."""
    return pairwise_distance(q, x, DistanceMetric.EUCLIDEAN, squared=squared)


def pairwise_neg_dot_reference(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K4b: q [B, d], x [N, d] -> -q.x [B, N] float32."""
    return pairwise_distance(q, x, DistanceMetric.DOT_PRODUCT)


def _check(name: str, q: torch.Tensor, x: torch.Tensor) -> None:
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"{name} wants q [B, d] and x [N, d], got {tuple(q.shape)} "
                         f"and {tuple(x.shape)}")
    if q.device != x.device:
        raise ValueError(f"{name} inputs must share one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")


def _launch(q: torch.Tensor, x: torch.Tensor, mode: str) -> torch.Tensor:
    q = q.float().contiguous()
    x = x.float().contiguous()
    b, d = q.shape
    n = x.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    if b == 0 or n == 0:
        return out
    fn = _cuda.entry("pairwise", "pairwise_launch",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), x.data_ptr(), out.data_ptr(), b, n, d, _MODES[mode],
                    stream)
    _cuda.check("pairwise", status)
    return out


def _kernel_route(q: torch.Tensor, use_kernel: bool) -> bool:
    return use_kernel and q.device.type == "cuda"


def pairwise_l2(q: torch.Tensor, x: torch.Tensor, squared: bool = False,
                use_kernel: bool = False) -> torch.Tensor:
    """L2 distance matrix [B, N] of q [B, d] and x [N, d] (squared when
    `squared`). Kernel K4a when `use_kernel` and on the card."""
    _check("pairwise_l2", q, x)
    if not _kernel_route(q, use_kernel):
        return pairwise_l2_reference(q, x, squared)
    out = _launch(q, x, "l2_squared" if squared else "l2")
    if out.numel():
        pairwise_l2.launches += 1
    return out


pairwise_l2.launches = 0


def pairwise_neg_dot(q: torch.Tensor, x: torch.Tensor,
                     use_kernel: bool = False) -> torch.Tensor:
    """Negative-dot-product matrix [B, N]. Kernel K4b when `use_kernel` and
    on the card."""
    _check("pairwise_neg_dot", q, x)
    if not _kernel_route(q, use_kernel):
        return pairwise_neg_dot_reference(q, x)
    out = _launch(q, x, "neg_dot")
    if out.numel():
        pairwise_neg_dot.launches += 1
    return out


pairwise_neg_dot.launches = 0
