"""models/bert.py and models/modernbert.py of the port against the JAX
package's, on the same numpy-seeded weights and ids. BERT's padded forward
is compared at every position; ModernBERT's forward, which runs each
row's valid tokens packed and leaves zeros at the padding, at the valid
positions.

Tolerances:
- init_params: equal array for array (the same numpy draws);
- float32 forwards and encode: within atol 1e-5 of bert_forward /
  modernbert_forward (the same arithmetic in another order);
- bfloat16: the smallest per-row cosine of the pooled outputs >= 0.999 (the
  port's attention keeps its probabilities in float32 registers where the
  reference rounds them to bfloat16);
- the padded encode replayed as a graph (EagerCapture standing in for
  CUDA graph capture): equal to the eager encode bit for bit;
- HF parity (mirrors tests/test_models.py's TestHFParity and
  TestModernBertHFParity): within 1e-4 of transformers' forward on a
  checkpoint it saved to a tmp dir, loaded from safetensors and from .bin.
"""

import dataclasses as dc
import json
import os
import shutil
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islands_tpu.models import bert as jbert
from islands_tpu.models import modernbert as jmb
from islands_tpu_torch import convert
from islands_tpu_torch.models import PRESETS, ModelArchitecture, TextEncoder
from islands_tpu_torch.models import bert as tbert
from islands_tpu_torch.models import modernbert as tmb
from islands_tpu_torch.ops import varlen_attention as va
from islands_tpu_torch.utils import tracing

from torch_graph_capture import EagerCapture

# transformers' torch models are all these tests use; skip its TensorFlow
# and Flax imports (most of its import time).
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_FLAX", "0")

ARCHS = {
    "bert": (jbert, tbert, jbert.BertConfig.tiny_test(), jbert.bert_forward,
             convert.bert_from_numpy),
    "modernbert": (jmb, tmb, jmb.ModernBertConfig.tiny_test(), jmb.modernbert_forward,
                   convert.modernbert_from_numpy),
}


def _ids(seed=3, b=4, slen=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1024, size=(b, slen)).astype(np.int32)
    mask = np.ones((b, slen), dtype=np.int32)
    mask[1, 16:] = 0
    mask[3, 8:] = 0
    return ids * mask, mask


def _port(arch, cfg, params=None):
    jmod, tmod, _, _, conv = ARCHS[arch]
    return conv(params if params is not None else tmod.init_params(cfg, 0), cfg, "cpu")


def _cos_min(a, b):
    return float(np.min(np.sum(a * b, 1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_params_equal(arch):
    jmod, tmod, cfg, _, _ = ARCHS[arch]
    want = jmod.init_params(cfg, seed=5)
    got = tmod.init_params(cfg, seed=5)

    def leaves(d, prefix=""):
        for k, v in sorted(d.items()):
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + ".")
            else:
                yield prefix + k, v

    w, g = dict(leaves(want)), dict(leaves(got))
    assert w.keys() == g.keys()
    for k in w:
        assert g[k].dtype == np.float32
        np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_and_encode_f32(arch):
    jmod, tmod, cfg, jfwd, _ = ARCHS[arch]
    params = jmod.init_params(cfg, 0)
    model = _port(arch, cfg)
    ids, mask = _ids()
    want = np.asarray(jfwd(params, jnp.asarray(ids), jnp.asarray(mask), cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if arch == "modernbert":
        assert not got[mask == 0].any()
        got, want = got[mask > 0], want[mask > 0]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for normalize in (True, False):
        want_e = np.asarray(jmod.encode(params, jnp.asarray(ids), jnp.asarray(mask), cfg,
                                        normalize=normalize))
        got_e = tmod.encode(model, torch.from_numpy(ids), torch.from_numpy(mask),
                            normalize).numpy()
        np.testing.assert_allclose(got_e, want_e, atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["slice", "fold", "dtl", "onepass"])
def test_bert_attn_impl_values_compute_one_attention(impl):
    cfg = dc.replace(jbert.BertConfig.tiny_test(), attn_impl=impl)
    params = jbert.init_params(cfg, 0)
    ids, mask = _ids(seed=7)
    want = np.asarray(jbert.encode(params, jnp.asarray(ids), jnp.asarray(mask), cfg))
    got = tbert.encode(_port("bert", cfg), torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_bf16_two_layers(arch):
    jmod, tmod, cfg, _, _ = ARCHS[arch]
    cfg = dc.replace(cfg, num_hidden_layers=2, dtype="bfloat16")
    params = jmod.init_params(cfg, 0)
    model = _port(arch, cfg)
    assert model.layers[0].__class__.__name__.endswith("Layer")
    ids, mask = _ids(seed=11, b=16, slen=32)
    want = np.asarray(jmod.encode(params, jnp.asarray(ids), jnp.asarray(mask), cfg))
    got = tmod.encode(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.all(np.isfinite(got))
    assert _cos_min(got, want) >= 0.999


def test_bf16_weights_and_residual_dtype():
    """Dense weights in the compute dtype, embeddings and LayerNorm
    parameters float32, the residual stream bfloat16 between layers."""
    cfg = dc.replace(jbert.BertConfig.tiny_test(), dtype="bfloat16")
    model = _port("bert", cfg)
    layer = model.layers[0]
    assert layer.qkv.weight.dtype == torch.bfloat16
    assert layer.attn_ln.weight.dtype == torch.float32
    assert model.word.weight.dtype == torch.float32
    seen = []
    hook = layer.register_forward_hook(lambda m, a, out: seen.append(out.dtype))
    ids, mask = _ids()
    model(torch.from_numpy(ids), torch.from_numpy(mask))
    hook.remove()
    assert seen == [torch.bfloat16]


def test_fully_masked_row_is_uniform_not_nan():
    """The additive -1e9 bias gives a row whose keys are all masked uniform
    weights, as the reference's does; a boolean mask would give NaN."""
    cfg = jbert.BertConfig.tiny_test()
    params = jbert.init_params(cfg, 0)
    ids, mask = _ids()
    mask[2] = 0
    want = np.asarray(jbert.bert_forward(params, jnp.asarray(ids), jnp.asarray(mask), cfg))
    with torch.no_grad():
        got = _port("bert", cfg)(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_padding_invariance(arch):
    _, tmod, cfg, _, _ = ARCHS[arch]
    model = _port(arch, cfg)
    ids, mask = _ids(slen=24)
    a = tmod.encode(model, torch.from_numpy(ids), torch.from_numpy(mask))
    ids64 = np.pad(ids, ((0, 0), (0, 40)))
    mask64 = np.pad(mask, ((0, 0), (0, 40)))
    b = tmod.encode(model, torch.from_numpy(ids64), torch.from_numpy(mask64))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


@pytest.mark.parametrize("theta", [10000.0, 160000.0])
def test_rope_tables_and_rotate_half(theta):
    """The RoPE tables equal the reference's; so does the rotate-half of
    the varlen attention's plain version (its RoPE with cos 0 and sin 1)."""
    cos, sin = tmb.rope_tables(40, 16, theta)
    jcos, jsin = jmb._rope_tables(40, 16, theta)
    np.testing.assert_array_equal(cos, np.asarray(jcos))
    np.testing.assert_array_equal(sin, np.asarray(jsin))
    x = np.random.default_rng(0).standard_normal((3, 5, 16)).astype(np.float32)
    rotated = va._rotate(torch.from_numpy(x), torch.zeros(3, 16), torch.ones(3, 16))
    np.testing.assert_array_equal(rotated.numpy(), np.asarray(jmb._rotate_half(jnp.asarray(x))))


def test_local_band_bias():
    """The local layers' band: the keys the reference's additive bias leaves
    open (islands_tpu/models/modernbert.py, modernbert_forward: the padding
    bias plus -1e9 outside |q - k| <= local_attention // 2) at each row's
    valid queries, against the keys the plain varlen attention lets a
    query see at window local_attention // 2 on the rows' valid tokens."""
    cfg = jmb.ModernBertConfig.tiny_test()
    _, mask = _ids(slen=40)
    pad = jnp.where(jnp.asarray(mask)[:, None, None, :] > 0, 0.0, -1e9)
    pos = jnp.arange(40)
    in_window = jnp.abs(pos[:, None] - pos[None, :]) <= cfg.local_attention // 2
    bias = np.asarray(pad + jnp.where(in_window, 0.0, -1e9)[None, None])
    lens = mask.sum(1)
    t = int(lens.sum())
    want = np.zeros((t, t), dtype=bool)
    for row, (start, n) in enumerate(zip(np.cumsum(lens) - lens, lens)):
        want[start:start + n, start:start + n] = bias[row, 0, :n, :n] == 0
    # Equal scores and one-hot values: query i's output is nonzero at
    # exactly the keys it attends to.
    out = va.varlen_attention(torch.zeros((t, 1, t)), torch.zeros((t, 1, t)),
                              torch.eye(t)[:, None, :], va.Segments.from_lengths(lens, "cpu"),
                              cfg.local_attention // 2)
    np.testing.assert_array_equal(out[:, 0].numpy() > 0, want)
    assert not want[:40, :40].all()  # the band cuts the 40-token rows
    assert [layer.is_global for layer in _port("modernbert", cfg).layers] == [
        True, False, False, True]


def test_presets():
    assert {k: v[1] for k, v in PRESETS.items()} == {
        "minilm-l6": 384, "minilm-l12": 384, "bge-small": 384, "bge-base": 768,
        "bge-large": 1024, "tiny-test": 64, "modernbert-base": 768,
        "modernbert-large": 1024, "modernbert-tiny-test": 64,
        "mellum2-12b-a2.5b": 2304, "mellum-tiny-test": 64}
    for name in ("minilm_l6", "minilm_l12", "bge_small", "bge_base", "bge_large", "tiny_test"):
        assert dc.asdict(getattr(tbert.BertConfig, name)()) == \
            dc.asdict(getattr(jbert.BertConfig, name)())
    for name in ("modernbert_base", "modernbert_large", "tiny_test"):
        assert dc.asdict(getattr(tmb.ModernBertConfig, name)()) == \
            dc.asdict(getattr(jmb.ModernBertConfig, name)())
    assert tbert.BertConfig.bge_base().hidden_size == 768
    assert tmb.ModernBertConfig.modernbert_large().num_hidden_layers == 28


# -- HF checkpoints ----------------------------------------------------------


@pytest.fixture(scope="module")
def bert_ckpt(tmp_path_factory):
    from transformers import BertConfig as HFBertConfig, BertModel

    hf_cfg = HFBertConfig(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=128,
                          max_position_embeddings=128, type_vocab_size=2)
    torch.manual_seed(0)
    model = BertModel(hf_cfg).eval()
    d = tmp_path_factory.mktemp("hf_bert")
    model.save_pretrained(str(d))
    return model, d


@pytest.fixture(scope="module")
def mb_ckpt(tmp_path_factory):
    from transformers import ModernBertConfig as HFMBConfig, ModernBertModel

    hf_cfg = HFMBConfig(vocab_size=1024, hidden_size=64, num_hidden_layers=4,
                        num_attention_heads=4, intermediate_size=96,
                        max_position_embeddings=128, local_attention=16,
                        global_attn_every_n_layers=3, pad_token_id=0,
                        attn_implementation="eager", reference_compile=False)
    torch.manual_seed(1)
    model = ModernBertModel(hf_cfg).eval()
    d = tmp_path_factory.mktemp("hf_mb")
    model.save_pretrained(str(d))
    return model, d


def _bin_copy(model, d, dst):
    dst.mkdir()
    shutil.copy(d / "config.json", dst / "config.json")
    torch.save(model.state_dict(), dst / "pytorch_model.bin")
    return dst


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("arch", ["bert", "modernbert"])
def test_hf_parity(arch, fmt, bert_ckpt, mb_ckpt, tmp_path):
    model, d = bert_ckpt if arch == "bert" else mb_ckpt
    if fmt == "bin":
        d = _bin_copy(model, d, tmp_path / "bin")
    tmod = tbert if arch == "bert" else tmb
    params, cfg = tmod.load_hf_checkpoint(d)
    cfg = dc.replace(cfg, dtype="float32")
    ids, mask = _ids(seed=3 if arch == "bert" else 5)
    with torch.no_grad():
        hf_out = model(input_ids=torch.tensor(ids, dtype=torch.long),
                       attention_mask=torch.tensor(mask, dtype=torch.long))
        hf_out = hf_out.last_hidden_state.numpy()
        ours = _port(arch, cfg, params)(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    on = mask.astype(bool)
    np.testing.assert_allclose(ours[on], hf_out[on], atol=1e-4, rtol=1e-4)
    m = mask[:, :, None].astype(np.float32)
    hf_pooled = (hf_out * m).sum(1) / np.maximum(m.sum(1), 1e-9)
    hf_pooled /= np.maximum(np.linalg.norm(hf_pooled, axis=-1, keepdims=True), 1e-12)
    got = tmod.encode(_port(arch, cfg, params), torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), hf_pooled, atol=1e-4, rtol=1e-4)
    # The loaded layout is the reference loader's, array for array.
    jmod = jbert if arch == "bert" else jmb
    jparams, jcfg = jmod.load_hf_checkpoint(d)
    assert dc.asdict(jcfg) == dc.asdict(dc.replace(cfg, dtype=jcfg.dtype))
    for group in ("embeddings", "layers"):
        for k, v in jparams[group].items():
            np.testing.assert_array_equal(params[group][k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("arch", ["bert", "modernbert"])
def test_from_pretrained_dispatches_architecture(arch, bert_ckpt, mb_ckpt):
    _, d = bert_ckpt if arch == "bert" else mb_ckpt
    enc = TextEncoder.from_pretrained(d, device="cpu")
    want = ModelArchitecture.BERT if arch == "bert" else ModelArchitecture.MODERNBERT
    assert enc.architecture is want
    assert enc.dimension == 64
    out = enc.embed_texts(["fn main() {}", "def f(): pass"])
    assert out.shape == (2, 64) and np.all(np.isfinite(out))


def test_safetensors_reader(tmp_path, bert_ckpt):
    from safetensors.numpy import load_file, save_file

    _, d = bert_ckpt
    want = load_file(str(d / "model.safetensors"))
    got = tbert.read_safetensors(d / "model.safetensors")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rng = np.random.default_rng(0)
    mixed = {"f16": rng.standard_normal((3, 4)).astype(np.float16),
             "f64": rng.standard_normal((2,)),
             "i64": rng.integers(-5, 5, (2, 3)), "i32": np.arange(6, dtype=np.int32),
             "u8": np.arange(4, dtype=np.uint8), "scalar": np.array(2.5, dtype=np.float32)}
    save_file(mixed, str(tmp_path / "m.safetensors"), metadata={"format": "np"})
    want = load_file(str(tmp_path / "m.safetensors"))
    got = tbert.read_safetensors(tmp_path / "m.safetensors")
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_safetensors_reader_bf16(tmp_path):
    """BF16 tensors widen to float32 (numpy has no bfloat16)."""
    from safetensors.torch import save_file

    x = torch.randn(5, 3).to(torch.bfloat16)
    save_file({"w": x}, str(tmp_path / "b.safetensors"))
    got = tbert.read_safetensors(tmp_path / "b.safetensors")["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.float().numpy())


def test_from_json_configs(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(
        {"hidden_size": 32, "num_hidden_layers": 3, "local_attention": 8}))
    assert dc.asdict(tbert.BertConfig.from_json(tmp_path / "config.json")) == \
        dc.asdict(jbert.BertConfig.from_json(tmp_path / "config.json"))
    assert dc.asdict(tmb.ModernBertConfig.from_json(tmp_path / "config.json")) == \
        dc.asdict(jmb.ModernBertConfig.from_json(tmp_path / "config.json"))


def _preset_window_config(**kw):
    """modernbert-base's attention pattern (window 128, every third layer
    global, RoPE theta 160,000 / 10,000) on a narrow model of 6 layers."""
    base = jmb.ModernBertConfig.modernbert_base()
    cfg = dc.replace(base, vocab_size=1024, hidden_size=64, num_hidden_layers=6,
                     num_attention_heads=4, intermediate_size=96,
                     max_position_embeddings=512, pad_token_id=0, dtype="float32")
    return dc.replace(cfg, **kw)


def test_modernbert_at_the_preset_window_f32():
    """The port's forward and encode against modernbert_forward at the
    valid positions and encode at seq 320, where the +/-64 band of the
    local layers cuts, with padded rows; within atol 1e-5 in float32, as
    the other float32 cases. A window wide enough to cover the sequence
    changes the output, so the band is exercised."""
    cfg = _preset_window_config()
    assert (cfg.local_attention, cfg.global_attn_every_n_layers, cfg.global_rope_theta,
            cfg.local_rope_theta) == (128, 3, 160000.0, 10000.0)
    params = jmb.init_params(cfg, 0)
    model = _port("modernbert", cfg)
    rng = np.random.default_rng(17)
    slen = 320
    ids = rng.integers(1, cfg.vocab_size, size=(3, slen)).astype(np.int32)
    mask = (np.arange(slen)[None, :] < np.array([[slen], [250], [90]])).astype(np.int32)
    ids = ids * mask
    want = np.asarray(jmb.modernbert_forward(params, jnp.asarray(ids), jnp.asarray(mask), cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    on = mask.astype(bool)
    np.testing.assert_allclose(got[on], want[on], atol=1e-5, rtol=0)
    for normalize in (True, False):
        want_e = np.asarray(jmb.encode(params, jnp.asarray(ids), jnp.asarray(mask), cfg,
                                       normalize=normalize))
        got_e = tmb.encode(model, torch.from_numpy(ids), torch.from_numpy(mask),
                           normalize).numpy()
        np.testing.assert_allclose(got_e, want_e, atol=1e-5, rtol=0)
    wide = _port("modernbert", _preset_window_config(local_attention=2 * slen), params)
    with torch.no_grad():
        unbanded = wide(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.abs(unbanded[0] - got[0]).max() > 1e-3


# -- the padded encode replayed as CUDA graphs ---------------------------------
#
# On the CPU `EagerCapture` stands in for CUDA graph capture: each "replay"
# runs the captured forward again over the graph's buffers. The graph route
# must answer as the eager route bit for bit.


def _rows64(rows, seed=5, slen=64):
    """[rows, slen] ids and a prefix mask of 1 to slen valid tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1024, size=(rows, slen)).astype(np.int32)
    lens = rng.integers(1, slen + 1, size=rows)
    mask = (np.arange(slen)[None, :] < lens[:, None]).astype(np.int32)
    return torch.from_numpy(ids * mask), torch.from_numpy(mask)


def _traced_encode(model, ids, mask, normalize=True):
    """tbert.encode with the program's tracing on -> (rows, counters)."""
    tracing.reset()
    tracing.enable()
    try:
        out = tbert.encode(model, ids, mask, normalize)
    finally:
        tracing.disable()
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    return out, counters


def _eager(model, ids, mask, normalize=True):
    graphs, model.encode_graphs = model.encode_graphs, None
    try:
        return tbert.encode(model, ids, mask, normalize)
    finally:
        model.encode_graphs = graphs


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("rows,dtype", [(1, "float32"), (32, "float32"), (2048, "float32"),
                                        (32, "bfloat16")])
def test_encode_graph_answers_as_the_eager_route(rows, dtype, normalize):
    cfg = dc.replace(jbert.BertConfig.tiny_test(), dtype=dtype)
    model = _port("bert", cfg)
    assert model.encode_graphs is None  # built on the CPU: the eager route
    capture = EagerCapture()
    model.encode_graphs = tbert.new_encode_graphs(capture)
    # the first call of a shape runs eagerly, the second captures, the
    # third (other rows) only replays
    for seed in (5, 6, 7):
        ids, mask = _rows64(rows, seed)
        want = _eager(model, ids, mask, normalize)
        got, counters = _traced_encode(model, ids, mask, normalize)
        assert torch.equal(got, want)
        assert counters == ({} if seed == 5 else {"encoder.graphed": 1})
    assert capture.captures == 1
    assert list(model.encode_graphs._graphs) == [(rows, 64, normalize)]


def test_encode_graph_per_shape_and_the_bound(monkeypatch):
    monkeypatch.setattr(tbert, "ENCODE_GRAPHS_KEPT", 2)
    model = _port("bert", jbert.BertConfig.tiny_test())
    capture = EagerCapture()
    graphs = model.encode_graphs = tbert.new_encode_graphs(capture)
    assert graphs.kept == 2

    def call(rows, slen=64, normalize=True, seed=5, times=1):
        ids, mask = _rows64(rows, seed, slen)
        for _ in range(times):
            assert torch.equal(tbert.encode(model, ids, mask, normalize),
                               _eager(model, ids, mask, normalize))

    call(4)  # first call of a shape: eager, nothing captured
    assert capture.captures == 0 and not graphs._graphs
    call(4, seed=6)  # second: captured
    call(4, seed=7)  # same shape: replayed
    assert capture.captures == 1
    call(8, times=2)
    call(4, normalize=False, times=2)  # the norm is part of the key
    assert capture.captures == 3
    assert list(graphs._graphs) == [(8, 64, True), (4, 64, False)]  # (4, 64, True) out
    call(8)  # touched: now the latest
    call(4, slen=32, times=2)
    assert capture.captures == 4
    assert list(graphs._graphs) == [(8, 64, True), (4, 32, True)]
    call(4)  # evicted: a first call again, eager
    assert capture.captures == 4
    call(4)  # and captured on the second
    assert capture.captures == 5
    call(16)  # a shape asked for once evicts nothing
    assert capture.captures == 5 and (16, 64, True) not in graphs._graphs
    # no rows: the eager route, nothing captured
    ids, mask = _rows64(0)
    assert tbert.encode(model, ids, mask).shape == (0, 64)
    assert capture.captures == 5


def test_encode_graph_bound_holds_the_text_and_recompute_shapes():
    """A text query at each length bucket, a recompute index's hop and
    route shapes, a batch of texts and a build chunk stay captured under
    the default bound, in any order: after each shape's second call none is
    captured again."""
    model = _port("bert", jbert.BertConfig.tiny_test())
    capture = EagerCapture()
    model.encode_graphs = tbert.new_encode_graphs(capture)
    # (the tiny model's positions stop at 128: its buckets are 16 to 128)
    shapes = [(1, b) for b in (16, 32, 64, 128)] + [(64, 128), (2, 128), (64, 64),
                                                    (256, 128)]
    assert len(set(shapes)) == tbert.ENCODE_GRAPHS_KEPT
    rng = np.random.default_rng(0)
    for i in range(6):
        for j in rng.permutation(len(shapes)):
            rows, slen = shapes[j]
            tbert.encode(model, *_rows64(rows, i, slen))
        if i == 1:
            assert capture.captures == len(shapes)
    assert capture.captures == len(shapes)


def test_encode_graph_leaves_large_encodes_eager(monkeypatch):
    """Above ENCODE_GRAPH_ELEMENTS (rows x length x intermediate_size) the
    encode runs eagerly: it is not dispatch-bound, and its activations
    would stay in the graphs' pool."""
    model = _port("bert", jbert.BertConfig.tiny_test())
    ffn = model.config.intermediate_size
    monkeypatch.setattr(tbert, "ENCODE_GRAPH_ELEMENTS", 32 * 64 * ffn)
    capture = EagerCapture()
    model.encode_graphs = tbert.new_encode_graphs(capture)
    for rows, graphed in ((33, False), (32, True)):
        ids, mask = _rows64(rows)
        for _ in range(3):
            got, counters = _traced_encode(model, ids, mask)
        assert torch.equal(got, _eager(model, ids, mask))
        assert counters == ({"encoder.graphed": 1} if graphed else {})
    assert list(model.encode_graphs._graphs) == [(32, 64, True)]


def test_encode_graph_returns_no_view_of_its_output():
    model = _port("bert", jbert.BertConfig.tiny_test())
    capture = EagerCapture()
    model.encode_graphs = tbert.new_encode_graphs(capture)
    tbert.encode(model, *_rows64(32, 4))  # the shape's first call: eager
    first = tbert.encode(model, *_rows64(32, 5))
    kept = first.clone()
    second = tbert.encode(model, *_rows64(32, 6))
    assert torch.equal(first, kept) and not torch.equal(first, second)
    assert first.data_ptr() != second.data_ptr() and capture.captures == 1


def test_packed_modernbert_takes_no_encode_graph():
    model = _port("modernbert", jmb.ModernBertConfig.tiny_test())
    assert not hasattr(model, "encode_graphs")
    ids, mask = _rows64(8, slen=32)
    want = tmb.encode(model, ids, mask)
    capture = EagerCapture()
    model.encode_graphs = tbert.new_encode_graphs(capture)  # the packed route ignores it
    _traced_encode(model, ids, mask)
    got, counters = _traced_encode(model, ids, mask)
    assert torch.equal(got, want)
    assert capture.captures == 0 and len(model.encode_graphs._graphs) == 0
    assert "encoder.graphed" not in counters and counters["encoder.tokens"] > 0


def test_encode_graphs_shared_by_threads():
    """Threads encoding through one model's graphs each get their own rows:
    the lock spans the copy in, the replay and the clone out."""
    model = _port("bert", jbert.BertConfig.tiny_test())
    inputs = [_rows64(rows, seed, slen=16) for seed in range(6) for rows in (2, 3)]
    wants = [tbert.encode(model, ids, mask) for ids, mask in inputs]
    capture = EagerCapture()
    model.encode_graphs = tbert.new_encode_graphs(capture)
    errors = []

    def work(k):
        try:
            for i in range(20):
                j = (k + i) % len(inputs)
                if not torch.equal(tbert.encode(model, *inputs[j]), wants[j]):
                    errors.append(j)
        except Exception as e:  # a thread's failure, reported by the assert below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert capture.captures == 2
