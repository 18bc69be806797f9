"""The varlen attention kernel and ModernBERT's packed forward, on the card.

The card tests are marked `cuda` and skip without a CUDA device (the Triton
kernel has no CPU mode). The file imports neither jax nor islands_tpu:

    python -m pytest --noconftest tests/test_torch_varlen_cuda.py -q

- The kernel against its plain version and against SDPA with the band mask
  (per segment, the yardstick only), global and local, with and without
  RoPE, at modernbert-base's 12 heads of 64 on segments of up to 2,048
  tokens. Each segment's relative error (norm of the difference over the
  norm of the plain version's output) stays under SEGMENT_REL_ERR = 5e-3.
  All three round q and k to bf16 after RoPE and the output to bf16 (a
  relative error of about 2^-9 / sqrt(3) = 1.1e-3 a side); the kernel and
  SDPA also round the probabilities to bf16 before the value product, an
  unbiased relative error of about 2^-9 on each term of an average, about
  1e-3 again.
- The check's power, on the CPU: outputs with a planted fault (the last key
  block of every segment dropped, as a kernel that stops one block short
  would; or a band one key narrower on each side) read well over that
  limit against the plain version at the same shapes.
- The packed forward at modernbert-base's widths against the plain float32
  reference of the benchmark on seeded random weights: the widest relative
  L2 error of the pooled rows under 2e-2. The bf16 products of 22 layers
  read 0.0109-0.0119 here and in the benchmark's runs; the reference in
  float8 (the benchmark's control) reads 0.072-0.078.
- `varlen_attention.launches` grows by 22 per forward, and the packed route
  calls no SDPA.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import modernbert as ref
from islands_tpu_torch import convert
from islands_tpu_torch.models import bert as bert_mod
from islands_tpu_torch.models import modernbert as mb
from islands_tpu_torch.ops import varlen_attention as va

LENGTHS = [2048, 1, 700, 129, 64, 2048, 17, 1300]
SEGMENT_REL_ERR = 5e-3


def _inputs(device, window, with_rope):
    """q, k, v [T, 12, 64] bf16 (strided, as the fused product's columns),
    the RoPE tables of the layer's kind (or None) and the Segments."""
    g = torch.Generator(device=device).manual_seed(7)
    t = sum(LENGTHS)
    qkv = torch.randn((t, 3, 12, 64), generator=g, device=device).to(torch.bfloat16)
    rope = None
    if with_rope:
        cos, sin = mb.rope_tables(8192, 64, 160000.0 if window is None else 10000.0)
        rope = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))
    return qkv[:, 0], qkv[:, 1], qkv[:, 2], rope, va.Segments.from_lengths(LENGTHS, device)


def _worst_segment_rel_err(got, want) -> float:
    """The largest ||got - want|| / ||want|| over the segments of LENGTHS."""
    worst, start = 0.0, 0
    for n in LENGTHS:
        a, b = got[start:start + n].double(), want[start:start + n].double()
        worst = max(worst, float((a - b).norm() / b.norm()))
        start += n
    return worst


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")


def _sdpa(q, k, v, lengths, window, rope):
    """SDPA per segment with a boolean band mask (the yardstick)."""
    out, start = torch.empty_like(q), 0
    for n in lengths:
        sl = slice(start, start + n)
        qs, ks = q[sl], k[sl]
        if rope is not None:
            qs, ks = va._rotate(qs, rope[0][:n], rope[1][:n]), va._rotate(ks, rope[0][:n], rope[1][:n])
        mask = None
        if window is not None:
            pos = torch.arange(n, device=q.device)
            mask = (pos[:, None] - pos[None, :]).abs() <= window
        o = F.scaled_dot_product_attention(qs.transpose(0, 1), ks.transpose(0, 1),
                                           v[sl].transpose(0, 1), attn_mask=mask)
        out[sl] = o.transpose(0, 1)
        start += n
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("with_rope", [False, True])
def test_varlen_kernel_matches_plain_version_and_sdpa(window, with_rope):
    _card()
    q, k, v, rope, segs = _inputs("cuda", window, with_rope)
    before = va.varlen_attention.launches
    got = va.varlen_attention(q, k, v, segs, window, rope)
    torch.cuda.synchronize()
    assert va.varlen_attention.launches == before + 1
    plain = va.varlen_attention_reference(q, k, v, segs, window, rope)
    assert _worst_segment_rel_err(got, plain) < SEGMENT_REL_ERR
    assert _worst_segment_rel_err(got, _sdpa(q, k, v, LENGTHS, window, rope)) < SEGMENT_REL_ERR


def _faulty(q, k, v, window, rope, fault):
    """The plain computation with a planted fault: "short" drops the last
    key block (the kernel's BLOCK_N keys) of every longer segment, "narrow"
    takes a band one key narrower on each side."""
    block = va.BLOCK_N_GLOBAL if window is None else va.BLOCK_N_LOCAL
    out, start = torch.empty_like(q), 0
    for n in LENGTHS:
        sl = slice(start, start + n)
        qs, ks = q[sl], k[sl]
        if rope is not None:
            qs, ks = va._rotate(qs, rope[0][:n], rope[1][:n]), va._rotate(ks, rope[0][:n], rope[1][:n])
        s = torch.einsum("qhd,khd->hqk", qs.float(), ks.float()) / 8.0
        pos = torch.arange(n)
        keep = torch.ones((n, n), dtype=torch.bool)
        if window is not None:
            keep &= (pos[:, None] - pos[None, :]).abs() <= window - (fault == "narrow")
        if fault == "short" and n > block:
            keep &= pos[None, :] < n - block
        p = torch.softmax(s.masked_fill(~keep[None], float("-inf")), dim=-1)
        out[sl] = torch.einsum("hqk,khd->qhd", p, v[sl].float()).to(q.dtype)
        start += n
    return out


@pytest.mark.parametrize("window,fault", [(None, "short"), (64, "short"), (64, "narrow")])
def test_the_kernel_check_fails_on_a_planted_fault(window, fault):
    q, k, v, rope, segs = _inputs("cpu", window, True)
    plain = va.varlen_attention_reference(q, k, v, segs, window, rope)
    assert _worst_segment_rel_err(_faulty(q, k, v, window, rope, None), plain) < 1e-3
    assert _worst_segment_rel_err(_faulty(q, k, v, window, rope, fault), plain) > \
        4 * SEGMENT_REL_ERR


def _weights(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    p = mb.init_params(cfg, seed)

    def draw(a, name):
        noise = rng.standard_normal(a.shape, dtype=np.float32)
        return 1.0 + 0.05 * noise if "ln_scale" in name else 0.02 * noise

    out = {g: {k: draw(v, k) for k, v in d.items()} for g, d in p.items() if isinstance(d, dict)}
    out["final_ln_scale"] = draw(p["final_ln_scale"], "final_ln_scale")
    return out


@pytest.mark.cuda
def test_packed_modernbert_base_against_the_float32_reference(monkeypatch):
    _card()
    cfg = mb.ModernBertConfig.modernbert_base()
    w = _weights(cfg, 1)
    model = convert.modernbert_from_numpy(w, cfg, "cuda")
    rng = np.random.default_rng(2)
    lens = [2048, 1100, 700, 300, 129, 128]
    table = torch.zeros((len(lens), 2048), dtype=torch.int32)
    for i, n in enumerate(lens):
        table[i, :n] = torch.from_numpy(rng.integers(1000, 29000, size=n).astype(np.int32))
    mask = (torch.arange(2048)[None, :] < torch.tensor(lens)[:, None]).to(torch.int32)
    monkeypatch.setattr(F, "scaled_dot_product_attention",
                        lambda *a, **k: pytest.fail("SDPA on the packed route"))
    before = va.varlen_attention.launches
    got = bert_mod.encode(model, table.cuda(), mask.cuda(), normalize=False)
    torch.cuda.synchronize()
    assert va.varlen_attention.launches - before == cfg.num_hidden_layers
    monkeypatch.undo()
    tw = {g: ({k: torch.from_numpy(v).cuda() for k, v in d.items()} if isinstance(d, dict)
              else torch.from_numpy(d).cuda()) for g, d in w.items()}
    want = ref.pooled_rows(tw, dataclasses.asdict(cfg), table.cuda(), lens)
    err = ((got.double() - want.double()).norm(dim=1) / want.double().norm(dim=1)).max()
    print(f"packed modernbert-base vs float32 reference: widest relative error {float(err):.5f}")
    assert float(err) < 2e-2
