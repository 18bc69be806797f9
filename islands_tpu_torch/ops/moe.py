"""Mixture-of-experts MLP: the router and the grouped expert products.

Mellum's sparse MLP (models/mellum.py): each token's MLP is the sum of
`top_k` of `E` SwiGLU experts, weighted by the renormalised softmax of a
router over all of them,

    moe(y) = sum_{e in topk} w_e * down_e(silu(gate_e(y)) * up_e(y)).

It replaces no TPU kernel: nothing in the JAX package routes tokens to
experts. Two steps, both on the device and neither reading anything back
to the host inside a forward (one read a layer would be 28 round trips a
Mellum forward):

- `route`: the router's product in float32, the top k logits and their
  softmax (the softmax over all E renormalised over the top k is the
  softmax of the top k logits); then the T x k assignments sorted by
  expert (stable, so each expert's rows keep token order), each expert's
  first sorted row, and each assignment's sorted row. No host read.
- `moe_gemm`: five launches a layer. The expert products are PyTorch's
  grouped GEMM (`torch._grouped_mm`, one CUTLASS launch over all experts'
  runs, the runs' ends on the device), once for gate and up together
  (`gate_up_w` [E, h, 2i], gate's columns first) and once for down. Around
  them three Triton passes, each one read and one write of its rows:
  `moe_gemm_gather` casts the tokens' float32 rows to the weights' dtype
  in sorted order; `moe_gemm_swiglu` turns each [gate | up] row into
  silu(gate) * up, in float32, rounded to the weights' dtype;
  `moe_gemm_combine` sums each token's k rows times their routing weights
  in float32, into `out` (the residual stream) when one is given. The
  three passes' trace names begin with "moe_gemm".

What bounds it on the card. Per layer the two products read every routed
expert's weights once (3 x h x i x 2 bytes: 12.4 MB an expert at Mellum's
2,304 x 896) and do 6 x h x i FLOPs an assignment; the passes move the
permuted rows. At a recompute hop's ~3,300 tokens (26,400 assignments,
~415 an expert) that is 415 FLOPs a weight byte, at the H100's ridge:
weights and tensor cores bound it about equally.

`moe_gemm` launches the passes on CUDA tensors, counted in
`moe_gemm.launches` (three a call: the hand-written passes, not the
library's products), and runs `moe_gemm_reference`, one `torch.mm` per
expert and projection, only on CPU tensors. Triton is imported, and the
passes built, at the first launch.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


#: Rows and columns a program of each pass takes (a [ROWS, COLS] tile).
ROWS = 16
COLS = 256


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass
class Routing:
    """T tokens' assignments to their top-k experts, all on the device.
    `weights` float32 [T, k] (renormalised) and `experts` int64 [T, k];
    `order` int64 [A]: the assignment index (token x k + slot) of each row
    sorted by expert; `offsets` int64 [E + 1]: each expert's first sorted
    row, and A; `position` int64 [A]: each assignment's sorted row (the
    inverse of `order`)."""

    weights: torch.Tensor
    experts: torch.Tensor
    order: torch.Tensor
    offsets: torch.Tensor
    position: torch.Tensor

    @property
    def top_k(self) -> int:
        return int(self.experts.shape[1])

    @property
    def assignments(self) -> int:
        return int(self.order.shape[0])

    @property
    def n_experts(self) -> int:
        return int(self.offsets.shape[0]) - 1


def route(y: torch.Tensor, router_w: torch.Tensor, top_k: int,
          norm_topk: bool = True) -> Routing:
    """Router over y [T, h] (float32) with weights [h, E]: float32 logits,
    the top `top_k` experts of each token and their softmax weights
    (renormalised to sum to 1 with `norm_topk`), sorted into per-expert
    runs. Reads nothing back to the host."""
    n_exp = router_w.shape[1]
    logits = y.float() @ router_w.float()
    top, experts = torch.topk(logits, top_k, dim=-1)
    if norm_topk:
        weights = torch.softmax(top, dim=-1)
    else:
        weights = torch.softmax(logits, dim=-1).gather(1, experts)
    flat, order = torch.sort(experts.reshape(-1), stable=True)
    offsets = torch.searchsorted(flat, torch.arange(n_exp + 1, device=y.device))
    position = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=y.device))
    return Routing(weights, experts, order, offsets, position)


def moe_gemm_reference(x: torch.Tensor, r: Routing, gate_up_w: torch.Tensor,
                       down_w: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of `moe_gemm`: x's rows in sorted order rounded to the
    weights' dtype; per expert one `torch.mm` of its rows by gate and up
    and one by down (float32 sums of the operands' values, each product
    rounded to the weights' dtype, as the grouped GEMM writes it), the
    SwiGLU in float32 rounded likewise; then each token's k rows times
    their routing weights summed in float32 -> [T, h] float32, added into
    `out` if given. x [T, h]; gate_up_w [E, h, 2i]; down_w [E, i, h]."""
    k, dt, i = r.top_k, gate_up_w.dtype, down_w.shape[1]
    rows = x[r.order // k].to(dt)
    y = torch.empty((r.assignments, x.shape[1]), dtype=dt, device=x.device)
    bounds = r.offsets.tolist()
    for e in range(gate_up_w.shape[0]):
        s, t = bounds[e], bounds[e + 1]
        if s == t:
            continue
        gu = torch.mm(rows[s:t].float(), gate_up_w[e].float()).to(dt).float()
        mid = (F.silu(gu[:, :i]) * gu[:, i:]).to(dt)
        y[s:t] = torch.mm(mid.float(), down_w[e].float()).to(dt)
    w = r.weights.reshape(-1, k, 1)
    total = (y[r.position].float().view(-1, k, x.shape[1]) * w).sum(dim=1)
    if out is None:
        return total
    return out.add_(total)


def _check(x, r, gate_up_w, down_w, out) -> None:
    e, h, i2 = gate_up_w.shape
    if x.dim() != 2 or x.shape[1] != h or i2 % 2 or down_w.shape != (e, i2 // 2, h):
        raise ValueError(f"moe_gemm wants x [T, h], gate_up [E, h, 2i], down [E, i, h]; got "
                         f"{tuple(x.shape)}, {tuple(gate_up_w.shape)}, {tuple(down_w.shape)}")
    if r.assignments != x.shape[0] * r.top_k or r.n_experts != e:
        raise ValueError(f"routing of {r.assignments} assignments to {r.n_experts} experts "
                         f"for {x.shape[0]} tokens and {e} experts")
    if down_w.dtype != gate_up_w.dtype or any(
            t.device != x.device for t in (gate_up_w, down_w)):
        raise TypeError("moe_gemm wants the weights of one dtype on x's device")
    if out is not None and (out.shape != x.shape or out.dtype != torch.float32):
        raise ValueError(f"moe_gemm's out is float32 {tuple(x.shape)}, got "
                         f"{out.dtype} {tuple(out.shape)}")


_kernels = None


def _build_kernels():
    """The Triton passes `moe_gemm_gather`, `moe_gemm_swiglu` and
    `moe_gemm_combine`, built once per process."""
    global _kernels
    if _kernels is not None:
        return _kernels
    import triton
    import triton.language as tl

    @triton.jit
    def moe_gemm_gather(x_ptr, order_ptr, rows_ptr, n_rows, width, stride_x, stride_r,
                        TOP_K: tl.constexpr, ROWS: tl.constexpr, COLS: tl.constexpr):
        r = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        c = tl.program_id(1) * COLS + tl.arange(0, COLS)
        ok = (r < n_rows)[:, None] & (c < width)[None, :]
        token = tl.load(order_ptr + r, mask=r < n_rows, other=0) // TOP_K
        v = tl.load(x_ptr + token.to(tl.int64)[:, None] * stride_x + c[None, :], mask=ok)
        tl.store(rows_ptr + r.to(tl.int64)[:, None] * stride_r + c[None, :],
                 v.to(rows_ptr.dtype.element_ty), mask=ok)

    @triton.jit
    def moe_gemm_swiglu(gu_ptr, mid_ptr, n_rows, width, stride_gu, stride_mid,
                        ROWS: tl.constexpr, COLS: tl.constexpr):
        r = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        c = tl.program_id(1) * COLS + tl.arange(0, COLS)
        ok = (r < n_rows)[:, None] & (c < width)[None, :]
        at = gu_ptr + r.to(tl.int64)[:, None] * stride_gu + c[None, :]
        g = tl.load(at, mask=ok, other=0.0).to(tl.float32)
        u = tl.load(at + width, mask=ok, other=0.0).to(tl.float32)
        tl.store(mid_ptr + r.to(tl.int64)[:, None] * stride_mid + c[None, :],
                 (g / (1.0 + tl.exp(-g)) * u).to(mid_ptr.dtype.element_ty), mask=ok)

    @triton.jit
    def moe_gemm_combine(y_ptr, position_ptr, weight_ptr, out_ptr, n_tokens, width,
                         stride_y, stride_out, TOP_K: tl.constexpr, ACCUMULATE: tl.constexpr,
                         ROWS: tl.constexpr, COLS: tl.constexpr):
        t = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        c = tl.program_id(1) * COLS + tl.arange(0, COLS)
        live = t < n_tokens
        ok = live[:, None] & (c < width)[None, :]
        out_at = out_ptr + t.to(tl.int64)[:, None] * stride_out + c[None, :]
        if ACCUMULATE:
            acc = tl.load(out_at, mask=ok, other=0.0)
        else:
            acc = tl.zeros([ROWS, COLS], tl.float32)
        total = tl.zeros([ROWS, COLS], tl.float32)
        for s in tl.static_range(TOP_K):
            p = tl.load(position_ptr + t * TOP_K + s, mask=live, other=0)
            w = tl.load(weight_ptr + t * TOP_K + s, mask=live, other=0.0)
            v = tl.load(y_ptr + p.to(tl.int64)[:, None] * stride_y + c[None, :], mask=ok,
                        other=0.0)
            total += v.to(tl.float32) * w[:, None]
        tl.store(out_at, acc + total, mask=ok)

    _kernels = (moe_gemm_gather, moe_gemm_swiglu, moe_gemm_combine)
    return _kernels


def moe_gemm(x: torch.Tensor, r: Routing, gate_up_w: torch.Tensor, down_w: torch.Tensor,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """The routed experts' weighted sum for each token of x [T, h] (float32
    or the weights' dtype) -> [T, h] float32, added into `out` (float32
    [T, h]) when given: `torch._grouped_mm` and the three passes on CUDA
    (bf16 or fp16 weights, h and i multiples of 8), `moe_gemm_reference` on
    the CPU. gate_up_w [E, h, 2i] (gate's columns, then up's) and down_w
    [E, i, h], each expert's matrices contiguous."""
    _check(x, r, gate_up_w, down_w, out)
    if x.device.type == "cpu":
        return moe_gemm_reference(x, r, gate_up_w, down_w, out)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gemm runs on cuda or cpu, not {x.device}")
    dt = gate_up_w.dtype
    if dt not in (torch.bfloat16, torch.float16):
        raise TypeError(f"moe_gemm's grouped products take bf16 or fp16, got {dt}")
    t, h = x.shape
    i, k, a = down_w.shape[1], r.top_k, r.assignments
    if h % 8 or i % 8 or not (gate_up_w.is_contiguous() and down_w.is_contiguous()) \
            or x.stride(1) != 1:
        raise ValueError("moe_gemm takes contiguous weights of widths that are multiples of 8 "
                         "and x's rows contiguous")
    if out is None:
        out = torch.empty((t, h), dtype=torch.float32, device=x.device)
        accumulate = False
    else:
        accumulate = True
    if t == 0:
        return out if accumulate else out.zero_()
    gather, swiglu, combine = _build_kernels()
    rows = torch.empty((a, h), dtype=dt, device=x.device)
    mid = torch.empty((a, i), dtype=dt, device=x.device)
    ends = r.offsets[1:].to(torch.int32)
    with torch.cuda.device(x.device):
        gather[(_cdiv(a, ROWS), _cdiv(h, COLS))](
            x, r.order, rows, a, h, x.stride(0), rows.stride(0), TOP_K=k, ROWS=ROWS, COLS=COLS)
        gu = torch._grouped_mm(rows, gate_up_w, offs=ends)
        swiglu[(_cdiv(a, ROWS), _cdiv(i, COLS))](
            gu, mid, a, i, gu.stride(0), mid.stride(0), ROWS=ROWS, COLS=COLS)
        y = torch._grouped_mm(mid, down_w, offs=ends)
        combine[(_cdiv(t, ROWS), _cdiv(h, COLS))](
            y, r.position, r.weights.reshape(-1), out, t, h, y.stride(0), out.stride(0),
            TOP_K=k, ACCUMULATE=accumulate, ROWS=ROWS, COLS=COLS)
    moe_gemm.launches += 3
    return out


moe_gemm.launches = 0
