"""Mellum (models/mellum.py) and its ops on the CPU, at `mellum-tiny-test`.

The port's packed forward, its pooled rows and the recompute provider's
`embed` are held to the benchmark's plain float32 reference
(benchmark/reference/mellum.py) on seeded random weights; YaRN's tables to
a direct evaluation of the formula (and to HF transformers' own function);
the router and the plain grouped GEMM to dense per-token sums; the causal
and grouped-query modes of `varlen_attention_reference` to a dense masked
softmax. The tiny preset is float32 throughout, so the forward and the
reference differ only in the order of their sums: 2e-5 bounds that at
these widths (the float32 rounding of 4 layers of 64-wide sums, ~1e-6,
with room).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import mellum as reference
from islands_tpu_torch.models import (
    IMPLEMENTED_ARCHITECTURES,
    PRESETS,
    EncoderEmbeddingProvider,
    ModelArchitecture,
    TextEncoder,
)
from islands_tpu_torch.models import mellum
from islands_tpu_torch.models.bert import encode
from islands_tpu_torch.models.modernbert import Segments
from islands_tpu_torch.ops import moe
from islands_tpu_torch.ops import varlen_attention as va
from islands_tpu_torch.utils import tracing

TINY = mellum.MellumConfig.tiny_test()
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def weights():
    return mellum.init_params(TINY, 3, "cpu")


@pytest.fixture(scope="module")
def model(weights):
    return mellum.MellumModel(TINY, weights)


def _table(n, slen, seed):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(5, TINY.vocab_size, (n, slen), generator=g, dtype=torch.int32)
    lens = torch.randint(1, slen + 1, (n,), generator=g).numpy()
    lens[0] = slen
    return ids * (torch.arange(slen)[None, :] < torch.as_tensor(lens)[:, None]), lens


# -- the forward against the reference --------------------------------------


@pytest.mark.parametrize("slen", [1, 7, 8, 9, 40])
def test_packed_forward_matches_the_reference(model, weights, slen):
    """Segments of one length up to 40 tokens against the reference's
    batch, at the window's edges (8) and five windows long."""
    gen = torch.Generator().manual_seed(slen)
    ids = torch.randint(5, TINY.vocab_size, (3, slen), generator=gen)
    segs = Segments.from_lengths([slen] * 3, "cpu")
    got = model.hidden_packed(ids.reshape(-1), segs)
    want = reference.hidden(weights, TINY.to_hf(), ids).reshape(3 * slen, -1)
    torch.testing.assert_close(got, want, **TOL)


def test_pooled_rows_are_the_last_tokens_of_each_segment(model, weights):
    ids, lens = _table(12, 40, 1)
    got = model.pooled_rows(ids, torch.arange(12), lens)
    want = reference.pooled_rows(weights, TINY.to_hf(), ids, lens)
    torch.testing.assert_close(got, want, **TOL)
    # packed together or one at a time, the same rows
    alone = torch.cat([model.pooled_rows(ids, torch.tensor([j]), lens[j:j + 1])
                       for j in range(12)])
    torch.testing.assert_close(got, alone, **TOL)


def test_the_window_binds_at_test_lengths(weights):
    """A window of 8 changes a 40-token segment's last token; a window of
    40 gives the full layers' causal attention on the sliding ones."""
    ids = torch.randint(5, TINY.vocab_size, (1, 40), generator=torch.Generator().manual_seed(2))
    segs = Segments.from_lengths([40], "cpu")
    base = mellum.MellumModel(TINY, weights).hidden_packed(ids[0], segs)
    wide_cfg = dataclasses.replace(TINY, sliding_window=40)
    wide = mellum.MellumModel(wide_cfg, weights).hidden_packed(ids[0], segs)
    torch.testing.assert_close(base[:8], wide[:8], **TOL)  # within the window: the same
    assert float((base[-1] - wide[-1]).norm() / wide[-1].norm()) > 1e-2
    ref_wide = reference.hidden(weights, wide_cfg.to_hf(), ids)[0]
    torch.testing.assert_close(wide, ref_wide, **TOL)


def test_provider_embed_matches_the_reference(weights):
    enc = TextEncoder(weights, TINY, device="cpu")
    assert enc.packed and enc.architecture is ModelArchitecture.MELLUM
    ids, lens = _table(20, 40, 4)
    mask = (torch.arange(40)[None, :] < torch.as_tensor(lens)[:, None]).to(torch.int32)
    prov = EncoderEmbeddingProvider(enc, ids, mask)
    pick = torch.tensor([[3, 0, 5], [19, 3, 1]])
    before = mellum.forward_packed.tokens_encoded
    rows = prov.embed(pick)
    assert mellum.forward_packed.tokens_encoded - before == int(lens[pick.reshape(-1)].sum())
    want = F.normalize(reference.pooled_rows(weights, TINY.to_hf(), ids, lens), dim=-1)
    torch.testing.assert_close(rows.reshape(6, -1), want[pick.reshape(-1)], **TOL)
    # the padded entry point pools the same rows
    torch.testing.assert_close(encode(enc.model, ids, mask), want, **TOL)


def test_text_encoder_packs_texts_as_the_provider_does(weights):
    enc = TextEncoder(weights, TINY, device="cpu")
    texts = ["def f(x):\n    return x + 1", "class A:\n    pass", "import os " * 9]
    got = enc.embed_texts(texts)
    ids, mask = enc.tokenize(texts)
    want = encode(enc.model, torch.as_tensor(ids), torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    prov = EncoderEmbeddingProvider.from_texts(enc, texts)
    np.testing.assert_allclose(prov.compute_embeddings_batch([0, 1, 2]), want,
                               rtol=2e-5, atol=2e-5)


def test_the_model_keeps_the_tensors_it_is_given(weights):
    m = mellum.MellumModel(TINY, weights)
    assert m.w["down_w"].data_ptr() == weights["layers"]["down_w"].data_ptr()
    assert m.w["embed"] is weights["embed"]


@pytest.mark.parametrize("fault", ["missing", "shape", "dtype"])
def test_the_model_refuses_weights_of_another_layout(weights, fault):
    bad = {"embed": weights["embed"], "final_norm": weights["final_norm"],
           "layers": dict(weights["layers"])}
    if fault == "missing":
        del bad["layers"]["router_w"]
    elif fault == "shape":
        bad["layers"]["gate_up_w"] = bad["layers"]["gate_up_w"][:, :4]
    else:
        bad["layers"]["attn_norm"] = bad["layers"]["attn_norm"].double()
    with pytest.raises((ValueError, TypeError)):
        mellum.MellumModel(TINY, bad)


def test_init_params_draws_from_the_seed_in_the_configs_dtype():
    a, b = mellum.init_params(TINY, 5), mellum.init_params(TINY, 5)
    c = mellum.init_params(TINY, 6)
    assert torch.equal(a["layers"]["gate_up_w"], b["layers"]["gate_up_w"])
    assert not torch.equal(a["layers"]["gate_up_w"], c["layers"]["gate_up_w"])
    bf = mellum.init_params(dataclasses.replace(TINY, dtype="bfloat16"), 5)
    assert bf["layers"]["qkv_w"].dtype == torch.bfloat16
    assert bf["layers"]["mlp_norm"].dtype == torch.float32
    assert abs(float(a["layers"]["down_w"].std()) - 0.02) < 2e-3
    assert abs(float(a["layers"]["attn_norm"].mean()) - 1.0) < 2e-2


# -- configuration, presets, dispatch -----------------------------------------


def test_presets_and_the_published_config():
    cfg = PRESETS["mellum2-12b-a2.5b"][0]()
    assert PRESETS["mellum2-12b-a2.5b"][1] == 2304 and PRESETS["mellum-tiny-test"][1] == 64
    assert (cfg.num_hidden_layers, cfg.num_attention_heads, cfg.num_key_value_heads,
            cfg.head_dim, cfg.num_experts, cfg.num_experts_per_tok,
            cfg.moe_intermediate_size, cfg.sliding_window) == (28, 32, 4, 128, 64, 8, 896, 1024)
    assert [i for i, t in enumerate(cfg.layer_types) if t == mellum.FULL] == list(range(3, 28, 4))
    assert mellum.MellumConfig.from_hf(cfg.to_hf()) == cfg
    assert mellum.MellumConfig.from_hf(TINY.to_hf()) == TINY
    # the parameters: 11.9B, 396M of each layer's 418M in its experts
    shapes = mellum.param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    experts = sum(math.prod(shapes[("layers", n)]) for n in ("gate_up_w", "down_w"))
    assert round(total / 1e9, 1) == 11.9 and round(experts / 28 / 1e6) == 396


def test_architecture_detection_and_dispatch():
    assert ModelArchitecture.detect("JetBrains/Mellum2-12B-A2.5B-Instruct") is \
        ModelArchitecture.MELLUM
    assert ModelArchitecture.MELLUM in IMPLEMENTED_ARCHITECTURES
    enc = TextEncoder.from_preset("mellum-tiny-test", device="cpu")
    assert enc.packed and enc.dimension == 64
    assert enc.config.max_seq_length == TINY.max_position_embeddings


def test_from_pretrained_has_no_mellum_loader(tmp_path):
    (tmp_path / "config.json").write_text('{"model_type": "mellum"}')
    with pytest.raises(NotImplementedError, match="mellum"):
        TextEncoder.from_pretrained(tmp_path, device="cpu")


def test_from_hf_refuses_what_it_does_not_compute():
    raw = TINY.to_hf()
    raw["mlp_layer_types"] = ["dense"] + raw["mlp_layer_types"][1:]
    with pytest.raises(ValueError):
        mellum.MellumConfig.from_hf(raw)
    raw = TINY.to_hf()
    raw["rope_parameters"][mellum.FULL]["rope_type"] = "linear"
    with pytest.raises(ValueError):
        mellum.MellumConfig.from_hf(raw)


# -- RoPE and YaRN --------------------------------------------------------------


def _yarn_direct(dim, base, factor, orig, beta_fast, beta_slow):
    """YaRN (Peng et al., arXiv:2309.00071) in float64: the dimensions whose
    wavelength fits more than beta_fast times in the original context keep
    their frequency, those fitting fewer than beta_slow times are divided
    by the factor, and a linear ramp between (the bounds floored and
    ceiled) blends the two."""
    j = np.arange(dim // 2, dtype=np.float64)
    theta = base ** (-2 * j / dim)

    def dim_of(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    lo, hi = max(math.floor(dim_of(beta_fast)), 0), min(math.ceil(dim_of(beta_slow)), dim - 1)
    ramp = np.clip((j - lo) / ((hi + 0.001 if lo == hi else hi) - lo), 0, 1)
    return theta / factor * ramp + theta * (1 - ramp)


@pytest.mark.parametrize("cfg", [mellum.MellumConfig(), TINY], ids=["published", "tiny"])
def test_yarn_tables_match_the_formula(cfg):
    inv, scale = mellum.yarn_inv_freq(cfg)
    want = _yarn_direct(cfg.head_dim, cfg.rope_theta, cfg.yarn_factor,
                        cfg.yarn_original_max_position_embeddings, cfg.yarn_beta_fast,
                        cfg.yarn_beta_slow)
    np.testing.assert_allclose(inv.double().numpy(), want, rtol=1e-6)
    assert scale == pytest.approx(0.1 * math.log(cfg.yarn_factor) + 1.0)
    cos, sin = mellum.rope_tables(cfg, mellum.FULL, 64)
    pos = np.arange(64, dtype=np.float64)[:, None] * np.concatenate([want, want])[None, :]
    np.testing.assert_allclose(cos.double().numpy(), np.cos(pos) * scale, atol=2e-5)
    np.testing.assert_allclose(sin.double().numpy(), np.sin(pos) * scale, atol=2e-5)
    # the sliding layers' plain tables carry no factor
    c, s = mellum.rope_tables(cfg, mellum.SLIDING, 64)
    torch.testing.assert_close(c * c + s * s, torch.ones_like(c))
    ref_inv, ref_scale = reference.inv_freq(cfg.to_hf(), mellum.FULL)
    torch.testing.assert_close(ref_inv, inv)
    assert ref_scale == scale


def test_yarn_matches_hf_transformers():
    """HF's own `_compute_yarn_parameters` on the published config."""
    tr = pytest.importorskip("transformers")
    from transformers.modeling_rope_utils import _compute_yarn_parameters

    cfg = mellum.MellumConfig()
    hf = tr.PretrainedConfig()
    hf.rope_theta, hf.head_dim, hf.hidden_size = cfg.rope_theta, cfg.head_dim, cfg.hidden_size
    hf.num_attention_heads, hf.max_position_embeddings = (cfg.num_attention_heads,
                                                          cfg.max_position_embeddings)
    hf.rope_scaling = cfg.to_hf()["rope_parameters"][mellum.FULL]
    hf.rope_parameters = hf.rope_scaling
    try:
        inv, scale = _compute_yarn_parameters(hf, torch.device("cpu"))
    except (AttributeError, KeyError, TypeError) as exc:
        pytest.skip(f"this transformers reads another config layout: {exc}")
    got, got_scale = mellum.yarn_inv_freq(cfg)
    torch.testing.assert_close(got, inv.float())
    assert got_scale == pytest.approx(scale)


# -- the router and the plain grouped GEMM ------------------------------------


def test_route_takes_the_top_k_renormalised():
    g = torch.Generator().manual_seed(8)
    y, w = torch.randn((50, 16), generator=g), torch.randn((16, 8), generator=g)
    r = moe.route(y, w, 3)
    probs = torch.softmax(y @ w, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True)
    assert torch.equal(torch.sort(r.experts, dim=-1).values,
                       torch.sort(top.indices[:, :3], dim=-1).values)
    torch.testing.assert_close(r.weights, top.values[:, :3] / top.values[:, :3].sum(-1, True))
    torch.testing.assert_close(r.weights.sum(-1), torch.ones(50))
    un = moe.route(y, w, 3, norm_topk=False)
    torch.testing.assert_close(un.weights, top.values[:, :3])


def test_route_resolves_a_near_tie_by_the_larger_logit():
    """Two logits 1e-6 apart at the edge of the top 2: the larger one is
    taken, in float32 from a bf16-looking router, and its weight is the
    renormalised softmax's."""
    w = torch.zeros((4, 4))
    w[0] = torch.tensor([3.0, 1.0 + 1e-6, 1.0, -2.0])
    y = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    r = moe.route(y, w, 2)
    assert r.experts[0].tolist() == [0, 1]
    p = torch.softmax(torch.tensor([3.0, 1.0 + 1e-6, 1.0, -2.0]), 0)
    torch.testing.assert_close(r.weights[0], p[:2] / p[:2].sum())
    w[0, 2] += 2e-6  # the other side of the tie
    assert moe.route(y, w, 2).experts[0].tolist() == [0, 2]


@pytest.mark.parametrize("t,e,k", [(1, 8, 2), (37, 8, 2), (300, 16, 4), (5, 64, 8)])
def test_sorted_runs_and_positions(t, e, k):
    """Each expert's run holds its assignments in token order, and
    `position` is the sorted row of each assignment."""
    g = torch.Generator().manual_seed(t)
    r = moe.route(torch.randn((t, 32), generator=g), torch.randn((32, e), generator=g), k)
    flat = r.experts.reshape(-1)
    counts = torch.bincount(flat, minlength=e)
    assert torch.equal(r.offsets, F.pad(torch.cumsum(counts, 0), (1, 0)))
    assert torch.equal(flat[r.order], torch.sort(flat, stable=True).values)
    for ex in range(e):
        run = r.order[r.offsets[ex]:r.offsets[ex + 1]]
        assert torch.all(run[1:] > run[:-1])
    assert torch.equal(r.order[r.position], torch.arange(t * k))
    assert torch.equal(r.position[r.order], torch.arange(t * k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_grouped_gemm_is_the_dense_per_token_sum(dtype):
    """Token by token, slot by slot: the rows rounded to the weights' dtype
    where the grouped products write them, the weighted sum in float32;
    added into `out` when one is given."""
    g = torch.Generator().manual_seed(11)
    t, h, i, e, k = 29, 32, 16, 8, 2
    y = torch.randn((t, h), generator=g)
    gate_up = torch.randn((e, h, 2 * i), generator=g).mul(0.2).to(dtype)
    down = torch.randn((e, i, h), generator=g).mul(0.2).to(dtype)
    r = moe.route(y, torch.randn((h, e), generator=g), k)
    got = moe.moe_gemm(y, r, gate_up, down)
    want = torch.zeros((t, h))
    for tok in range(t):
        for slot in range(k):
            ex = int(r.experts[tok, slot])
            a = y[tok].to(dtype).float()
            gu = (a @ gate_up[ex].float()).to(dtype).float()
            mid = (F.silu(gu[:i]) * gu[i:]).to(dtype).float()
            row = (mid @ down[ex].float()).to(dtype).float()
            want[tok] += row * r.weights[tok, slot]
    # float32: only the order of the sums differs; bf16: that order can move
    # a rounding by one ulp (2^-8 relative) on a few elements
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-3)
    torch.testing.assert_close(got, want, **tol)
    base = torch.randn((t, h), generator=g)
    out = base.clone()
    assert moe.moe_gemm(y, r, gate_up, down, out=out) is out
    torch.testing.assert_close(out, base + want, **tol)


def test_moe_gemm_refuses_mismatched_widths():
    g = torch.Generator().manual_seed(1)
    y = torch.randn((4, 16), generator=g)
    r = moe.route(y, torch.randn((16, 4), generator=g), 2)
    gate_up = torch.zeros((4, 16, 16))
    with pytest.raises(ValueError):
        moe.moe_gemm(y, r, gate_up, torch.zeros((4, 16, 8)))
    with pytest.raises(ValueError):
        moe.moe_gemm(y[:3], r, gate_up, torch.zeros((4, 8, 16)))
    with pytest.raises(ValueError):
        moe.moe_gemm(y, r, gate_up, torch.zeros((4, 8, 16)), out=torch.zeros((4, 16),
                                                                              dtype=torch.float64))


# -- causal and grouped-query attention, plain version ------------------------


def _dense(q, k, v, lengths, mask_fn):
    """Dense masked softmax per segment, every head's keys its group's."""
    out, s = [], 0
    g = q.shape[1] // k.shape[1]
    for n in lengths:
        qs, ks, vs = (x[s:s + n].double() for x in (q, k, v))
        ks, vs = ks.repeat_interleave(g, 1), vs.repeat_interleave(g, 1)
        sc = torch.einsum("qhd,khd->hqk", qs, ks) / math.sqrt(q.shape[-1])
        i, j = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
        sc = sc.masked_fill(~mask_fn(i, j)[None], float("-inf"))
        out.append(torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1), vs))
        s += n
    return torch.cat(out).float()


@pytest.mark.parametrize("window", [None, 1, 5])
@pytest.mark.parametrize("kv_heads", [4, 2, 1])
def test_causal_gqa_reference_matches_a_dense_masked_softmax(window, kv_heads):
    lengths = [1, 9, 23, 4]
    t = sum(lengths)
    g = torch.Generator().manual_seed(kv_heads)
    q = torch.randn((t, 4, 8), generator=g)
    k, v = torch.randn((t, kv_heads, 8), generator=g), torch.randn((t, kv_heads, 8), generator=g)
    got = va.varlen_attention(q, k, v, Segments.from_lengths(lengths, "cpu"), window,
                              causal=True)
    want = _dense(q, k, v, lengths,
                  lambda i, j: (j <= i) if window is None else (j <= i) & (i - j < window))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_gqa_reads_each_query_heads_group():
    """Query head h reads key head h // 2 (4 query heads over 2 key heads):
    the same as giving every query head its own copy."""
    lengths = [6, 11]
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((17, n, 8), generator=g) for n in (4, 2, 2))
    segs = Segments.from_lengths(lengths, "cpu")
    got = va.varlen_attention(q, k, v, segs, None)
    want = va.varlen_attention(q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1), segs)
    torch.testing.assert_close(got, want)
    with pytest.raises(ValueError):
        va.varlen_attention(q, k[:, :1].expand(17, 3, 8), v[:, :1].expand(17, 3, 8), segs)


# -- tracing ------------------------------------------------------------------------


def test_tracing_counts_tokens_and_assignments(model):
    ids, lens = _table(5, 30, 9)
    tracing.reset()
    tracing.enable()
    try:
        model.pooled_rows(ids, torch.arange(5), lens)
    finally:
        tracing.disable()
    snap = tracing.snapshot()
    tracing.reset()
    names = [r.name for r in snap["records"]]
    assert names.count("moe.route") == names.count("moe.experts") == TINY.num_hidden_layers
    tokens = int(lens.sum())
    assert snap["counters"]["encoder.tokens"] == tokens
    assert snap["counters"]["encoder.segments"] == 5
    assert snap["counters"]["moe.assignments"] == tokens * TINY.num_experts_per_tok * 4
