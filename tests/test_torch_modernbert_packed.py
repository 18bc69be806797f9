"""ModernBERT's packed forward, the varlen attention module, and the packed
route of the text encoder and the recompute provider, on the CPU.

- The packed forward against the plain float32 reference of the benchmark
  (`benchmark/reference/modernbert.py`, written independently from the
  published model) on seeded random weights at tiny-test widths with a band
  of +/- 16 (local_attention 32), on segments of 1, 7, 16, 17, 40 and 96
  tokens packed side by side: per-token hidden states and pooled rows
  within atol 2e-5. Both sides compute in float32; they differ in the
  order of sums and in the RoPE tables (the port's angles in float64, the
  reference's in float32, as HF's), which moves the outputs by ~1e-6.
- The kernel module's plain version against one dense masked softmax over
  the whole packed batch (block-diagonal by segment, banded for a local
  layer), with and without RoPE, within 1e-5.
- The packed route's pooled rows (`bert.encode`) against the reference's
  pooled rows of the same padded batch, an empty row among them (atol
  1e-5); the packed route calls no SDPA.
- The provider's packed `embed` against `bert.encode` of the same rows, also
  cut into several packed forwards by a small token budget.
- A ModernBERT `TextEncoder` takes a 1,000-token text whole (against the
  reference's pooled rows, atol 1e-5), and
  `embed_texts` hands the device flat runs of whole texts, never a table
  padded to the longest text.
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
from islands_tpu_torch.models import encoder as encoder_mod
from islands_tpu_torch.models.encoder import EncoderConfig, TextEncoder
from islands_tpu_torch.models.provider import EncoderEmbeddingProvider
from islands_tpu_torch.ops import varlen_attention as va
from islands_tpu_torch.utils import tracing

LENGTHS = [1, 7, 16, 17, 40, 96]
CFG = dataclasses.replace(mb.ModernBertConfig.tiny_test(), local_attention=32)


def weights(cfg, seed=3) -> dict:
    """Reference-layout float32 weights: N(0, 0.02^2), LayerNorm scales
    1 + N(0, 0.05^2), so every parameter counts."""
    rng = np.random.default_rng(seed)
    p = mb.init_params(cfg, seed)

    def draw(a, name):
        noise = rng.standard_normal(a.shape).astype(np.float32)
        return 1.0 + 0.05 * noise if "ln_scale" in name else 0.02 * noise

    out = {g: {k: draw(v, k) for k, v in d.items()} for g, d in p.items() if isinstance(d, dict)}
    out["final_ln_scale"] = draw(p["final_ln_scale"], "final_ln_scale")
    return out


def ref_cfg(cfg) -> dict:
    return dataclasses.asdict(cfg)


def as_torch(w: dict) -> dict:
    return {g: ({k: torch.from_numpy(v) for k, v in d.items()} if isinstance(d, dict)
                else torch.from_numpy(d)) for g, d in w.items()}


@pytest.fixture(scope="module")
def tiny():
    w = weights(CFG)
    model = convert.modernbert_from_numpy(w, CFG, "cpu")
    rng = np.random.default_rng(5)
    segs = [rng.integers(1, CFG.vocab_size, size=n).astype(np.int32) for n in LENGTHS]
    return w, model, segs


def test_packed_forward_matches_the_float32_reference(tiny):
    w, model, segs = tiny
    ids = torch.from_numpy(np.concatenate(segs))
    packed = mb.Segments.from_lengths(LENGTHS, "cpu")
    with torch.inference_mode():
        hidden = model.hidden_packed(ids, packed)
    pooled = mb.forward_packed(model, ids, packed)
    tw, start = as_torch(w), 0
    for n, seg in zip(LENGTHS, segs):
        want = ref.hidden(tw, ref_cfg(CFG), torch.from_numpy(seg)[None])[0]
        torch.testing.assert_close(hidden[start:start + n], want, atol=2e-5, rtol=0)
        start += n
    want_rows = ref.pooled_rows(tw, ref_cfg(CFG), torch.from_numpy(
        np.stack([np.pad(s, (0, 96 - len(s))) for s in segs])), LENGTHS)
    torch.testing.assert_close(pooled, want_rows, atol=2e-5, rtol=0)


def test_the_band_changes_the_output(tiny):
    """A band wider than every segment gives another result, so the band
    is exercised (and the reference's blocked band agrees with the port's)."""
    w, model, segs = tiny
    wide_cfg = dataclasses.replace(CFG, local_attention=512)
    wide = convert.modernbert_from_numpy(w, wide_cfg, "cpu")
    ids = torch.from_numpy(np.concatenate(segs))
    packed = mb.Segments.from_lengths(LENGTHS, "cpu")
    narrow, broad = mb.forward_packed(model, ids, packed), mb.forward_packed(wide, ids, packed)
    assert float((narrow[-1] - broad[-1]).abs().max()) > 1e-3
    torch.testing.assert_close(narrow[:4], broad[:4], atol=1e-6, rtol=0)  # all within +/-16
    want = ref.pooled(as_torch(w), ref_cfg(wide_cfg), torch.from_numpy(segs[-1])[None])
    torch.testing.assert_close(broad[-1:], want, atol=2e-5, rtol=0)


def dense_masked(q, k, v, lengths, window, rope):
    """One softmax over the whole packed batch with a [T, T] mask."""
    seg = torch.repeat_interleave(torch.arange(len(lengths)), torch.tensor(lengths))
    pos = torch.cat([torch.arange(n) for n in lengths])
    if rope is not None:
        cos, sin = rope[0][pos], rope[1][pos]
        half = q.shape[-1] // 2

        def rot(x):
            r = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
            return x * cos[:, None] + r * sin[:, None]

        q, k = rot(q), rot(k)
    ok = seg[:, None] == seg[None, :]
    if window is not None:
        ok &= (pos[:, None] - pos[None, :]).abs() <= window
    s = torch.einsum("qhd,khd->hqk", q, k) / q.shape[-1] ** 0.5
    p = torch.softmax(s.masked_fill(~ok[None], float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v)


@pytest.mark.parametrize("window", [None, 0, 3, 16])
@pytest.mark.parametrize("with_rope", [False, True])
def test_plain_varlen_attention_is_a_masked_softmax(window, with_rope):
    g = torch.Generator().manual_seed(11)
    t, h, d = sum(LENGTHS), 3, 16
    q, k, v = (torch.randn((t, h, d), generator=g) for _ in range(3))
    rope = None
    if with_rope:
        cos, sin = mb.rope_tables(128, d, 10000.0)
        rope = (torch.from_numpy(cos), torch.from_numpy(sin))
    got = va.varlen_attention(q, k, v, va.Segments.from_lengths(LENGTHS, "cpu"), window, rope)
    torch.testing.assert_close(got, dense_masked(q, k, v, LENGTHS, window, rope),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("lengths,block,want", [
    ([5, 0, 130, 64], 64, [(0, 0), (2, 0), (2, 64), (2, 128), (3, 0)]),
    ([128, 129], 128, [(0, 0), (1, 0), (1, 128)]),
    ([0, 0], 64, []),
])
def test_block_table_lists_every_block_that_holds_queries(lengths, block, want):
    segs = va.Segments.from_lengths(lengths, "cpu")
    assert segs.blocks(block).tolist() == [list(x) for x in want]
    assert segs.cu_seqlens.tolist() == np.cumsum([0] + lengths).tolist()
    pos = [p for n in lengths for p in range(n)]
    assert segs.positions.tolist() == pos and segs.tokens == sum(lengths)


@pytest.mark.parametrize("lengths,budget,want", [
    ([3, 4, 5], 7, [(0, 2), (2, 3)]),
    ([3, 4, 5], 12, [(0, 3)]),
    ([9, 1, 1], 4, [(0, 1), (1, 3)]),
    ([], 4, []),
])
def test_token_chunks_cut_at_whole_segments(lengths, budget, want):
    assert mb.token_chunks(np.array(lengths, dtype=np.int64), budget) == want


def _padded(segs, slen=None):
    slen = slen or max(len(s) for s in segs)
    ids = np.zeros((len(segs), slen), np.int32)
    mask = np.zeros((len(segs), slen), np.int32)
    for i, s in enumerate(segs):
        ids[i, :len(s)], mask[i, :len(s)] = s, 1
    return torch.from_numpy(ids), torch.from_numpy(mask)


def _refuse(*args, **kwargs):
    raise AssertionError("the packed route must not reach this")


def _reference_rows(w, cfg, ids, mask, normalize=True):
    """The reference's mean pooled rows of a padded batch (an empty row
    gives zeros), L2-normalised if asked."""
    rows = ref.pooled_rows(as_torch(w), ref_cfg(cfg), ids, mask.sum(1).numpy())
    return F.normalize(rows, dim=-1, eps=1e-12) if normalize else rows


@pytest.mark.parametrize("normalize", [False, True])
def test_packed_route_equals_the_reference(tiny, monkeypatch, normalize):
    w, model, segs = tiny
    ids, mask = _padded(segs + [np.zeros(0, np.int32)])  # and an empty row
    want = _reference_rows(w, CFG, ids, mask, normalize)
    calls = []
    real = va.varlen_attention
    monkeypatch.setattr(mb, "varlen_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(F, "scaled_dot_product_attention", _refuse)
    got = bert_mod.encode(model, ids, mask, normalize)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert float(got[-1].abs().max()) == 0.0
    assert len(calls) == CFG.num_hidden_layers


def _provider(tiny):
    w, _, segs = tiny
    enc = TextEncoder(w, CFG, config=EncoderConfig(normalize=False), device="cpu")
    ids, mask = _padded(segs * 3, slen=128)
    return EncoderEmbeddingProvider(enc, ids, mask)


@pytest.mark.parametrize("budget", [mb.PACK_TOKENS, 40])
def test_provider_packed_embed_equals_encode_of_the_rows(tiny, monkeypatch, budget):
    monkeypatch.setattr(mb, "PACK_TOKENS", budget)
    monkeypatch.setattr(mb.token_chunks, "__defaults__", (budget,))
    prov = _provider(tiny)
    pick = torch.tensor([[3, 0, 17], [5, 5, 11]])
    flat = pick.reshape(-1)
    before = mb.forward_packed.tokens_encoded
    rows = prov.embed(pick)
    tokens = int(prov.token_mask[flat].sum())
    assert mb.forward_packed.tokens_encoded - before == tokens
    want = bert_mod.encode(prov.encoder.model, prov.token_ids[flat], prov.token_mask[flat],
                           normalize=False)
    assert rows.shape == (2, 3, CFG.hidden_size)
    torch.testing.assert_close(rows.reshape(-1, CFG.hidden_size), want, atol=1e-6, rtol=0)
    centred = prov.with_center(sample=18, batch=7)
    every = bert_mod.encode(prov.encoder.model, prov.token_ids, prov.token_mask, False)
    torch.testing.assert_close(centred.center, every.mean(0), atol=1e-6, rtol=0)


def test_provider_traces_the_packing_and_counts_tokens(tiny):
    prov = _provider(tiny)
    pick = torch.tensor([1, 2, 4])
    tracing.reset()
    tracing.enable()
    try:
        prov.embed(pick)
    finally:
        tracing.disable()
    snap = tracing.snapshot()
    names = [r.name for r in snap["records"]]
    assert "encoder.pack" in names and "encoder.forward" in names
    assert snap["counters"]["encoder.tokens"] == 7 + 16 + 40
    assert snap["counters"]["encoder.segments"] == 3
    tracing.reset()


def test_modernbert_text_encoder_takes_a_long_text_whole():
    cfg = dataclasses.replace(CFG, max_position_embeddings=1024)
    w = weights(cfg)
    enc = TextEncoder(w, cfg, device="cpu")
    assert enc.packed and enc.config.max_seq_length == 1024
    text = " ".join(f"w{i % 300}" for i in range(998))
    ids, mask = enc.tokenize([text, "short text"])
    assert ids.shape == (2, 1000) and mask[0].sum() == 1000 and mask[1].sum() == 4
    got = enc.embed_texts([text, "short text"])
    want = _reference_rows(w, cfg, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(enc.encode_tokens(ids, mask).numpy(), want, atol=1e-5, rtol=0)
    cut = enc.embed_texts([" ".join(f"w{i % 300}" for i in range(254))])
    assert np.abs(cut[0] - got[0]).max() > 1e-3
    bert = TextEncoder.from_preset("tiny-test", device="cpu")
    assert not bert.packed and bert.config.max_seq_length == 128


def test_packed_embed_texts_sends_flat_tokens_to_the_device(monkeypatch):
    """One 8,192-token text among 300 short ones: the packed forward gets
    their tokens end to end in runs of whole texts under the budget (the
    long text alone), in input order, and nothing the size of 301 rows of
    8,192 tokens."""
    cfg = dataclasses.replace(CFG, max_position_embeddings=8192)
    enc = TextEncoder(weights(cfg), cfg, device="cpu")
    assert enc.config.max_seq_length == 8192
    texts = [f"w{i} w{i + 1}" for i in range(150)] + [
        " ".join(f"w{i % 300}" for i in range(9000))] + [f"v{i}" for i in range(150)]
    want_lens = [4] * 150 + [8192] + [3] * 150
    calls = []

    def fake(model, ids, segs):
        calls.append((ids.shape, segs.lengths.tolist()))
        assert ids.dtype == torch.int32 and ids.dim() == 1
        rows = torch.zeros((segs.count, cfg.hidden_size))
        rows[:, 0] = torch.from_numpy(segs.lengths).float()
        rows[:, 1] = 1.0
        return rows

    moved = []
    real_to_device = encoder_mod.to_device

    def to_device(a, *args, **kwargs):
        moved.append(np.asarray(a).size)
        return real_to_device(a, *args, **kwargs)

    monkeypatch.setattr(mb, "forward_packed", fake)
    monkeypatch.setattr(mb.token_chunks, "__defaults__", (1000,))
    monkeypatch.setattr(encoder_mod, "to_device", to_device)
    got = enc.embed_texts(texts)
    assert moved and max(moved) == 8192  # the long text's run; no [301, 8192] table
    sent = [n for _, lens in calls for n in lens]
    assert sent == want_lens
    assert [shape[0] for shape, _ in calls] == [sum(lens) for _, lens in calls]
    assert sum(shape[0] for shape, _ in calls) == sum(want_lens)
    assert max(shape[0] for shape, _ in calls) == 8192
    assert all(shape[0] <= 1000 for shape, lens in calls if len(lens) > 1)
    norm = np.hypot(np.array(want_lens, dtype=np.float32), 1.0)
    np.testing.assert_allclose(got[:, 0], np.array(want_lens) / norm, rtol=1e-6)
