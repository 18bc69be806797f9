"""Attention over packed variable-length segments, global or in a band,
bidirectional or causal, with as many or fewer key heads than query heads.

ModernBERT's encoder on unpadded sequences: the tokens of n segments lie
end to end in [T, heads, d] tensors, segment j holding rows
[cu_seqlens[j], cu_seqlens[j+1]) of a `Segments` (built from the lengths
on the host, so nothing reads the device back). A query attends only to keys of its own
segment; with `window` w (a local layer) only to those at positions p with
|p - its own| <= w, the band edges of the JAX package's
`modernbert_forward`, |q - k| <= local_attention // 2 (ModernBERT's
`local_attention` of 128 is w = 64). With `rope=(cos, sin)`
(float32 tables [P, d] in the duplicated-half layout, row = position in the
segment) q and k are rotated first, in float32, and rounded to their dtype,
as the JAX package's forward rotates them. Scale 1/sqrt(d); softmax
statistics and the sums in float32; the output in the inputs' dtype.

Mellum's decoder (models/mellum.py) takes the same kernel in two more
modes. `causal=True`: a query at position i attends to keys j <= i, and
with `window` w only to those with i - j < w (HF's sliding window: w keys,
the query's own among them). Grouped-query attention: k and v may carry
fewer heads than q, their count dividing q's; query head h reads key head
h // (q heads / k heads). RoPE tables may carry a magnitude factor (YaRN's
`attention_factor` multiplies cos and sin, so the scores by its square).

It replaces no TPU kernel: the JAX package computes every ModernBERT layer
as dense attention over a padded batch with a [B, 1, L, L] band bias
(islands_tpu/models/modernbert.py). Here no [L, L] tensor is built.

`varlen_attention` launches the Triton kernel `varlen_attn` (its name in a
profiler's trace) on CUDA tensors, counted in `varlen_attention.launches`,
and runs `varlen_attention_reference`, the plain PyTorch version, only on
CPU tensors. Triton is imported, and the kernel built, at the first launch.

What bounds it on the card. Per layer and token it reads q, k and v and
writes the output once (4 x heads x d x 2 bytes in bf16, 6 KB at
modernbert-base's 12 x 64), and does 4 x heads x d FLOPs for each key it
attends to. A global layer over a segment of s tokens does s keys a query:
at s = 1,088 (the token-weighted mean of the benchmark's code chunks) that
is 544 FLOPs a byte, past the H100's 295, so the tensor cores bound it. A
local layer does 129 keys a query, 64 FLOPs a byte: HBM bounds it.

Design (FlashAttention-2's forward over a block table). One program takes
one head and one block of BLOCK_M queries of one segment; a table of
(segment, first query) pairs, built on the host from the segment lengths,
lists exactly the blocks that hold queries, so no program idles on a short
segment. The program streams K and V in blocks of BLOCK_N rows from HBM,
keeps the running row maximum, the running sum and the [BLOCK_M, d]
accumulator in registers, and writes the output once: nothing of size
[L, L] exists anywhere. Both products run on the tensor cores (bf16
operands, float32 sums). A local layer visits only the key blocks that meet
[first query - w, last query + w], so its work is the band's and not the
segment's, and takes BLOCK_M = 64 so that the band covers most of what it
loads; a global layer takes BLOCK_M = 128 to reuse each K/V block over more
queries. RoPE: q is rotated in the attention program as its block is
loaded (the rotate-half partner is a second load of the same rows, served
from the cache); k, which every query block of the segment loads again, is
rotated once a layer by a small kernel, `varlen_attn_rope_k`, into a
[T, heads, d] buffer (its trace name begins with the attention kernel's, so
the attention's time counts it). Rotating k inside the attention loop was
measured 1.7x slower for a global layer: the rotated tile has to pass
through registers, which stops its loads from streaming into shared memory.
A causal program visits only the key blocks at or before its last query
(and, with a window, not below its first query - w + 1), and masks the
diagonal block, so a causal segment costs about half a global one. Causal
and grouped-query modes are `tl.constexpr` flags: ModernBERT's launches
(bidirectional, one key head per query head) compile to the code they
compiled to before the flags existed.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

#: Queries and keys a program takes at a time, by kind of layer (see the
#: module's note), and tokens a program of the k rotation takes.
BLOCK_M_GLOBAL, BLOCK_N_GLOBAL = 128, 64
BLOCK_M_LOCAL, BLOCK_N_LOCAL = 64, 32
BLOCK_M_CAUSAL, BLOCK_N_CAUSAL = 64, 64
ROPE_BLOCK_T = 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass
class Segments:
    """n packed segments, their lengths on the host and their offsets on the
    device. `cu_seqlens` int32 [n + 1]; `positions` int64 [T] (each token's
    place in its segment) and `segment_ids` int64 [T]; `blocks(m)` the
    kernel's table of (segment, first query) int32 [nb, 2] for blocks of m
    queries."""

    lengths: np.ndarray  # int64 [n], host
    cu_seqlens: torch.Tensor
    positions: torch.Tensor
    segment_ids: torch.Tensor
    _blocks: dict = dataclasses.field(default_factory=dict)

    @property
    def count(self) -> int:
        return int(self.lengths.shape[0])

    @property
    def tokens(self) -> int:
        return int(self.lengths.sum())

    @property
    def max_len(self) -> int:
        return int(self.lengths.max()) if self.count else 0

    @staticmethod
    def from_lengths(lengths, device) -> "Segments":
        """Segments of the given lengths (host integers, zeros allowed), laid
        end to end in that order, with their offsets on `device`. Nothing
        here reads the device."""
        lens = np.asarray(lengths, dtype=np.int64).reshape(-1)
        if (lens < 0).any():
            raise ValueError("segment lengths must be >= 0")
        cu = np.zeros(lens.shape[0] + 1, dtype=np.int64)
        np.cumsum(lens, out=cu[1:])
        total = int(cu[-1])
        dev = torch.device(device)
        cu_dev = torch.from_numpy(cu).to(dev, non_blocking=True)
        lens_dev = torch.from_numpy(lens).to(dev, non_blocking=True)
        seg = torch.repeat_interleave(torch.arange(lens.shape[0], device=dev), lens_dev,
                                      output_size=total)
        pos = torch.arange(total, device=dev) - cu_dev[seg]
        return Segments(lens, cu_dev.to(torch.int32), pos, seg)

    def blocks(self, block_m: int) -> torch.Tensor:
        if block_m not in self._blocks:
            nb = -(-self.lengths // block_m)
            seg = np.repeat(np.arange(self.count, dtype=np.int64), nb)
            first = np.zeros(nb.shape[0] + 1, dtype=np.int64)
            np.cumsum(nb, out=first[1:])
            start = (np.arange(seg.shape[0], dtype=np.int64) - np.repeat(first[:-1], nb)) * block_m
            table = np.stack([seg, start], axis=1).astype(np.int32)
            self._blocks[block_m] = torch.from_numpy(table).to(self.cu_seqlens.device,
                                                               non_blocking=True)
        return self._blocks[block_m]


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE in float32 on [s, heads, d] with tables [s, d] (rotate-half),
    rounded back to x's dtype."""
    xf = x.float()
    half = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[:, None, :] + rot * sin[:, None, :]).to(x.dtype)


def varlen_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               segs: Segments, window: int | None = None,
                               rope: tuple | None = None, causal: bool = False) -> torch.Tensor:
    """Plain version: per segment, RoPE (if given), dense float32 scores
    with keys outside the segment's band (or, `causal`, after the query or
    `window` or more before it) set to -inf, softmax, the weighted sum of v,
    rounded to q's dtype. q [T, heads, d]; k, v [T, heads / g, d], query
    head h reading key head h // g."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    scale = 1.0 / math.sqrt(q.shape[-1])
    group = q.shape[1] // k.shape[1]
    start = 0
    for s in segs.lengths.tolist():
        if s == 0:
            continue
        sl = slice(start, start + s)
        qs, ks = q[sl], k[sl]
        if rope is not None:
            qs, ks = _rotate(qs, rope[0][:s], rope[1][:s]), _rotate(ks, rope[0][:s], rope[1][:s])
        ks, vs = ks.repeat_interleave(group, dim=1), v[sl].repeat_interleave(group, dim=1)
        scores = torch.einsum("qhd,khd->hqk", qs.float(), ks.float()) * scale
        pos = torch.arange(s, device=q.device)
        gap = pos[:, None] - pos[None, :]
        if causal:
            far = (gap < 0) if window is None else (gap < 0) | (gap >= window)
        else:
            far = None if window is None else gap.abs() > window
        if far is not None:
            scores = scores.masked_fill(far[None], float("-inf"))
        p = torch.softmax(scores, dim=-1)
        out[sl] = torch.einsum("hqk,khd->qhd", p, vs.float()).to(q.dtype)
        start += s
    return out


def _check(q, k, v, window, rope, causal) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2] or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"varlen_attention wants q [T, heads, d] and k, v [T, kv_heads, d] "
                         f"with kv_heads dividing heads, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("varlen_attention wants q, k, v of one dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("varlen_attention inputs must share one device")
    if window is not None and (window < 0 or (causal and window < 1)):
        raise ValueError(f"window must be >= 0 (>= 1 causal) or None, got {window}")
    if rope is not None:
        for t in rope:
            if t.dim() != 2 or t.shape[1] != q.shape[2] or t.dtype != torch.float32 \
                    or t.device != q.device:
                raise ValueError("rope tables must be float32 [P, d] on q's device")


_kernel = None


def _build_kernel():
    """The Triton kernel `varlen_attn`, built once per process."""
    global _kernel
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit
    def varlen_attn(q_ptr, k_ptr, v_ptr, o_ptr, cu_ptr, blocks_ptr, cos_ptr, sin_ptr,
                    stride_qt, stride_qh, stride_kt, stride_kh, stride_vt, stride_vh,
                    stride_ot, stride_oh, qk_scale, window,
                    LOCAL: tl.constexpr, ROPE: tl.constexpr, HEAD_DIM: tl.constexpr,
                    BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr,
                    CAUSAL: tl.constexpr = False, GROUP: tl.constexpr = 1):
        blk = tl.program_id(0)
        head = tl.program_id(1)
        if GROUP > 1:
            kv_head = head // GROUP
        else:
            kv_head = head
        seg = tl.load(blocks_ptr + 2 * blk)
        q0 = tl.load(blocks_ptr + 2 * blk + 1)
        start = tl.load(cu_ptr + seg)
        seqlen = tl.load(cu_ptr + seg + 1) - start
        offs_m = q0 + tl.arange(0, BLOCK_M)  # query positions in the segment
        offs_d = tl.arange(0, HEAD_DIM)
        # rotate-half: element j takes -x[j + d/2] (first half) or x[j - d/2]
        offs_sw = (offs_d + HEAD_DIM // 2) % HEAD_DIM
        sign = tl.where(offs_d < HEAD_DIM // 2, -1.0, 1.0)
        m_ok = offs_m < seqlen
        q_rows = (start + offs_m).to(tl.int64)
        q_at = q_ptr + q_rows[:, None] * stride_qt + head * stride_qh
        q = tl.load(q_at + offs_d[None, :], mask=m_ok[:, None], other=0.0)
        if ROPE:
            q_sw = tl.load(q_at + offs_sw[None, :], mask=m_ok[:, None], other=0.0)
            rq_at = offs_m.to(tl.int64)[:, None] * HEAD_DIM + offs_d[None, :]
            cq = tl.load(cos_ptr + rq_at, mask=m_ok[:, None], other=0.0)
            sq = tl.load(sin_ptr + rq_at, mask=m_ok[:, None], other=0.0)
            q = (q.to(tl.float32) * cq + sign[None, :] * q_sw.to(tl.float32) * sq
                 ).to(q_ptr.dtype.element_ty)
        if CAUSAL:
            hi = tl.minimum(q0 + BLOCK_M, seqlen)
            if LOCAL:
                lo = tl.maximum(q0 - window + 1, 0)
                lo = (lo // BLOCK_N) * BLOCK_N
            else:
                lo = 0
        elif LOCAL:
            lo = tl.maximum(q0 - window, 0)
            lo = (lo // BLOCK_N) * BLOCK_N
            hi = tl.minimum(q0 + BLOCK_M + window, seqlen)
        else:
            lo = 0
            hi = seqlen
        m_i = tl.full([BLOCK_M], float("-inf"), tl.float32)
        l_i = tl.zeros([BLOCK_M], tl.float32)
        acc = tl.zeros([BLOCK_M, HEAD_DIM], tl.float32)
        for n0 in range(lo, hi, BLOCK_N):
            offs_n = n0 + tl.arange(0, BLOCK_N)
            n_ok = offs_n < seqlen
            k_rows = (start + offs_n).to(tl.int64)
            k_at = k_ptr + k_rows[:, None] * stride_kt + kv_head * stride_kh
            kt = tl.load(k_at + offs_d[None, :], mask=n_ok[:, None], other=0.0)
            qk = tl.dot(q, tl.trans(kt)) * qk_scale
            keep = n_ok[None, :]
            if CAUSAL:
                gap = offs_m[:, None] - offs_n[None, :]
                keep = keep & (gap >= 0)
                if LOCAL:
                    keep = keep & (gap < window)
            elif LOCAL:
                gap = offs_m[:, None] - offs_n[None, :]
                keep = keep & (gap <= window) & (gap >= -window)
            qk = tl.where(keep, qk, float("-inf"))
            m_new = tl.maximum(m_i, tl.max(qk, 1))
            m_use = tl.where(m_new == float("-inf"), 0.0, m_new)
            alpha = tl.exp2(m_i - m_use)
            p = tl.exp2(qk - m_use[:, None])
            l_i = l_i * alpha + tl.sum(p, 1)
            v_at = v_ptr + k_rows[:, None] * stride_vt + kv_head * stride_vh + offs_d[None, :]
            vt = tl.load(v_at, mask=n_ok[:, None], other=0.0)
            acc = tl.dot(p.to(vt.dtype), vt, acc * alpha[:, None])
            m_i = m_new
        acc = acc / tl.where(l_i > 0, l_i, 1.0)[:, None]
        o_at = o_ptr + q_rows[:, None] * stride_ot + head * stride_oh + offs_d[None, :]
        tl.store(o_at, acc.to(o_ptr.dtype.element_ty), mask=m_ok[:, None])

    @triton.jit
    def varlen_attn_rope_k(k_ptr, out_ptr, pos_ptr, cos_ptr, sin_ptr, t,
                           stride_kt, stride_kh, stride_ot, stride_oh,
                           HEAD_DIM: tl.constexpr, BLOCK_T: tl.constexpr):
        """k rotated once a layer, for the attention programs to share."""
        offs_t = tl.program_id(0) * BLOCK_T + tl.arange(0, BLOCK_T)
        head = tl.program_id(1)
        offs_d = tl.arange(0, HEAD_DIM)
        offs_sw = (offs_d + HEAD_DIM // 2) % HEAD_DIM
        sign = tl.where(offs_d < HEAD_DIM // 2, -1.0, 1.0)
        ok = (offs_t < t)[:, None]
        rows = offs_t.to(tl.int64)[:, None]
        at = k_ptr + rows * stride_kt + head * stride_kh
        x = tl.load(at + offs_d[None, :], mask=ok, other=0.0).to(tl.float32)
        x_sw = tl.load(at + offs_sw[None, :], mask=ok, other=0.0).to(tl.float32)
        pos = tl.load(pos_ptr + offs_t, mask=offs_t < t, other=0)
        r_at = pos.to(tl.int64)[:, None] * HEAD_DIM + offs_d[None, :]
        c = tl.load(cos_ptr + r_at, mask=ok, other=0.0)
        sn = tl.load(sin_ptr + r_at, mask=ok, other=0.0)
        y = x * c + sign[None, :] * x_sw * sn
        tl.store(out_ptr + rows * stride_ot + head * stride_oh + offs_d[None, :],
                 y.to(out_ptr.dtype.element_ty), mask=ok)

    _kernel = (varlen_attn, varlen_attn_rope_k)
    return _kernel


def varlen_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, segs: Segments,
                     window: int | None = None, rope: tuple | None = None,
                     causal: bool = False) -> torch.Tensor:
    """Attention of q [T, heads, d] over k, v [T, kv_heads, d] (kv_heads
    dividing heads) within each packed segment of `segs` (which holds the
    offsets and the block tables): over the whole segment (`window` None)
    or a band of +/- `window` positions; with `causal`, over the keys at or
    before the query (and, with `window`, fewer than `window` before it).
    RoPE first if `rope` is given. -> [T, heads, d] in q's dtype. q, k and
    v may be strided views (the columns of one fused product); the last
    axis must be contiguous."""
    _check(q, k, v, window, rope, causal)
    if segs.tokens != q.shape[0]:
        raise ValueError(f"segments hold {segs.tokens} tokens, q has {q.shape[0]}")
    if rope is not None and rope[0].shape[0] < segs.max_len:
        raise ValueError(f"rope tables of {rope[0].shape[0]} positions, a segment of "
                         f"{segs.max_len}")
    if q.device.type == "cpu":
        return varlen_attention_reference(q, k, v, segs, window, rope, causal)
    if q.device.type != "cuda":
        raise ValueError(f"varlen_attention runs on cuda or cpu, not {q.device}")
    t, heads, d = q.shape
    kv_heads = k.shape[1]
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"the varlen_attn kernel takes bf16 or fp16, got {q.dtype}")
    if d not in (32, 64, 128) or any(x.stride(2) != 1 for x in (q, k, v)):
        raise ValueError(f"the varlen_attn kernel takes d in (32, 64, 128) with a "
                         f"contiguous last axis, got d={d}")
    out = torch.empty((t, heads, d), dtype=q.dtype, device=q.device)
    if t == 0:
        return out
    local = window is not None
    if causal:
        block_m, block_n, warps = BLOCK_M_CAUSAL, BLOCK_N_CAUSAL, 4
    elif local:
        block_m, block_n, warps = BLOCK_M_LOCAL, BLOCK_N_LOCAL, 4
    else:
        block_m, block_n, warps = BLOCK_M_GLOBAL, BLOCK_N_GLOBAL, 8
    blocks = segs.blocks(block_m)
    attn, rope_k = _build_kernel()
    # ModernBERT's launches pass neither flag, so they compile as before.
    modes = {} if not causal and kv_heads == heads else \
        {"CAUSAL": causal, "GROUP": heads // kv_heads}
    with torch.cuda.device(q.device):
        if rope is None:
            cos = sin = out  # never read
        else:
            cos, sin = (x.contiguous() for x in rope)
            k_rot = torch.empty((t, kv_heads, d), dtype=k.dtype, device=k.device)
            rope_k[(_cdiv(t, ROPE_BLOCK_T), kv_heads)](
                k, k_rot, segs.positions, cos, sin, t, k.stride(0), k.stride(1),
                k_rot.stride(0), k_rot.stride(1), HEAD_DIM=d, BLOCK_T=ROPE_BLOCK_T,
                num_warps=4)
            k = k_rot
        attn[(blocks.shape[0], heads)](
            q, k, v, out, segs.cu_seqlens, blocks, cos, sin,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            (1.0 / math.sqrt(d)) * 1.4426950408889634, int(window or 0),
            LOCAL=local, ROPE=rope is not None, HEAD_DIM=d,
            BLOCK_M=block_m, BLOCK_N=block_n, num_warps=warps, num_stages=3, **modes)
    varlen_attention.launches += 1
    return out


varlen_attention.launches = 0
