"""Fused hop-merge of the sketch-gated search loop: kernel K1.

Per query: dedup the hop's discoveries by id, sort the rest by distance
descending, bitonic-merge them into the ascending approximate queue (AQ) and
split off the promote head. Port of islands_tpu/ops/pallas_kernels.py
(`_hop_merge_kernel`, `_hop_merge_xla`).

`hop_merge` launches the CUDA kernel `csrc/hop_merge.cu` on a CUDA tensor
and runs `hop_merge_reference`, the plain PyTorch composition, only on a CPU
tensor. `hop_merge.launches` counts kernel launches. The launcher picks the
kernel's route from the shape: one warp per query with its entries in
registers up to next_pow2(E) = 256 and next_pow2(A + E) = 512, one block
per query in shared memory past them.
"""

from __future__ import annotations

import ctypes

import torch

from islands_tpu_torch.ops import _cuda
from islands_tpu_torch.ops.merge import merge_sorted_with_new

# Invalid discoveries take this id so the adjacent-duplicate test never pairs
# them with a real id; it sorts after every real id, so ids must be < 2^30.
HOLE = 0x3FFFFFFF
SENTINEL = -1


def hop_merge_reference(nd: torch.Tensor, ni: torch.Tensor, aqd: torch.Tensor,
                        aqi: torch.Tensor, promote_width: int):
    """Plain version of K1, the reference's `_hop_merge_xla` composition.

    nd/ni [B, E]: approximate distances (+inf invalid) and ids; aqd/aqi [B, A]
    the sorted approximate queue. Returns (prom_d [B, pw], prom_i [B, pw],
    aq_d [B, A], aq_i [B, A]) with id -1 wherever the distance is +inf."""
    ni = torch.where(torch.isinf(nd), HOLE, ni.to(torch.int32))
    # Stable sort by id: duplicates keep their slot order, the first wins.
    sorted_ids, order = torch.sort(ni, dim=-1, stable=True)
    d_sorted = nd.gather(-1, order)
    prev = torch.cat([sorted_ids.new_full((*sorted_ids.shape[:-1], 1), -2),
                      sorted_ids[..., :-1]], dim=-1)
    keep = (d_sorted < float("inf")) & (sorted_ids != prev)
    new_ids = torch.where(keep, sorted_ids, SENTINEL)
    new_d = torch.where(keep, d_sorted, float("inf"))
    mg_d, mg_i = merge_sorted_with_new(aqd, aqi, new_d, new_ids)
    mg_i = torch.where(torch.isinf(mg_d), SENTINEL, mg_i)
    pw, a = promote_width, aqd.shape[-1]
    return (mg_d[..., :pw], mg_i[..., :pw],
            mg_d[..., pw:pw + a], mg_i[..., pw:pw + a])


def hop_merge(nd: torch.Tensor, ni: torch.Tensor, aqd: torch.Tensor,
              aqi: torch.Tensor, promote_width: int):
    """K1 on [B, E] discoveries and a [B, A] queue; see hop_merge_reference.
    Launches the kernel on CUDA tensors (counted in `hop_merge.launches`)."""
    if nd.dim() != 2 or ni.shape != nd.shape or aqd.dim() != 2 \
            or aqi.shape != aqd.shape or aqd.shape[0] != nd.shape[0]:
        raise ValueError("hop_merge wants nd/ni [B, E] and aqd/aqi [B, A]")
    b, e = nd.shape
    a = aqd.shape[1]
    if not 0 <= promote_width <= e:
        raise ValueError(f"promote_width {promote_width} outside [0, E={e}]")
    for t, dt in ((nd, torch.float32), (ni, torch.int32),
                  (aqd, torch.float32), (aqi, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"hop_merge wants float32 distances and int32 ids, "
                            f"got {t.dtype}")
        if t.device != nd.device:
            raise ValueError("hop_merge inputs must share one device")
    if nd.device.type == "cpu":
        return hop_merge_reference(nd, ni, aqd, aqi, promote_width)
    if nd.device.type != "cuda":
        raise ValueError(f"hop_merge runs on cuda or cpu, not {nd.device}")
    nd, ni, aqd, aqi = (t.contiguous() for t in (nd, ni, aqd, aqi))
    pd = torch.empty((b, promote_width), dtype=torch.float32, device=nd.device)
    pi = torch.empty((b, promote_width), dtype=torch.int32, device=nd.device)
    od = torch.empty((b, a), dtype=torch.float32, device=nd.device)
    oi = torch.empty((b, a), dtype=torch.int32, device=nd.device)
    if b == 0:
        return pd, pi, od, oi
    fn = _cuda.entry("hop_merge", "hop_merge_launch",
                     [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(nd.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(nd.data_ptr(), ni.data_ptr(), aqd.data_ptr(), aqi.data_ptr(),
                    pd.data_ptr(), pi.data_ptr(), od.data_ptr(), oi.data_ptr(),
                    b, e, a, promote_width, stream)
    _cuda.check("hop_merge", status)
    hop_merge.launches += 1
    return pd, pi, od, oi


hop_merge.launches = 0
