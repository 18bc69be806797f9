"""models/encoder.py of the port against the JAX package's: tokenizer ids
and masks exactly, embed_texts within 1e-5 (float32 tiny presets), the
HashEmbedder exactly, the architecture table, and the local HF tokenizer on
a vocabulary written to a tmp dir."""

import dataclasses as dc
import json
import os

import numpy as np
import pytest

from islands_tpu.models import encoder as jenc
from islands_tpu_torch.models import encoder as tenc

# Only transformers' tokenizers and torch models are used here.
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_FLAX", "0")

TEXTS = [
    "def search_layer(query, entry, ef): pass",
    "fn insert_node(&mut self, vector: Vec<f32>)",
    "class IndexerService: handles repository cloning",
    "SELECT * FROM repositories WHERE indexed = false",
    "import jax.numpy as jnp",
    "the quick brown fox jumps over the lazy dog",
    "Ünïcödé — dashes, tabs\tand\nnewlines 123abc",
    "",
    " ".join(["word"] * 300),
]


@pytest.fixture(scope="module")
def encoders():
    return (jenc.TextEncoder.from_preset("tiny-test", seed=0),
            tenc.TextEncoder.from_preset("tiny-test", seed=0, device="cpu"))


@pytest.mark.parametrize("vocab,max_len", [(30522, 256), (1024, 16), (1024, 3), (50368, 64)])
def test_simple_tokenizer_ids_exact(vocab, max_len):
    j, t = jenc.SimpleTokenizer(vocab), tenc.SimpleTokenizer(vocab)
    for text in TEXTS:
        got = t.encode(text, max_len)
        assert got == j.encode(text, max_len)
        assert got[0] == t.CLS and len(got) <= max_len
        assert all(0 <= i < vocab for i in got)


@pytest.mark.parametrize("pad_to", [None, 64, 8])
def test_tokenize_ids_and_masks_exact(encoders, pad_to):
    j, t = encoders
    for texts in (TEXTS, TEXTS[:2], ["short text"], [" ".join(["tok"] * 60)]):
        jids, jmask = j.tokenize(texts, pad_to=pad_to)
        tids, tmask = t.tokenize(texts, pad_to=pad_to)
        assert tids.dtype == np.int32 and tmask.dtype == np.int32
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(tmask, jmask)


def test_encoder_config_clamped_like_reference():
    cfg = tenc.EncoderConfig(max_seq_length=512, buckets=(32, 64, 128, 256, 512))
    j = jenc.TextEncoder.from_preset("tiny-test", config=jenc.EncoderConfig(
        max_seq_length=512, buckets=(32, 64, 128, 256, 512)))
    t = tenc.TextEncoder.from_preset("tiny-test", config=cfg, device="cpu")
    assert dc.asdict(t.config) == dc.asdict(j.config)
    assert t.config.max_seq_length == 128 and t.config.buckets == (32, 64, 128)


def test_embed_texts_matches_reference(encoders):
    j, t = encoders
    np.testing.assert_allclose(t.embed_texts(TEXTS), j.embed_texts(TEXTS), atol=1e-5, rtol=0)


def test_embed_texts_order_and_batching(encoders):
    """Length-bucketed batches come back in input order: batched rows equal
    one-by-one rows."""
    _, t = encoders
    texts = [" ".join(["w"] * (3 + 7 * (i % 9))) for i in range(20)]
    small = tenc.TextEncoder.from_preset("tiny-test", device="cpu",
                                         config=tenc.EncoderConfig(batch_size=3))
    one_by_one = np.stack([t.embed_text(x) for x in texts])
    np.testing.assert_allclose(t.embed_texts(texts), one_by_one, atol=2e-5)
    np.testing.assert_allclose(small.embed_texts(texts), one_by_one, atol=2e-5)
    assert t.embed_texts([]).shape == (0, t.dimension)


def test_unnormalized_option():
    cfg = dict(normalize=False)
    t = tenc.TextEncoder.from_preset("tiny-test", device="cpu", config=tenc.EncoderConfig(**cfg))
    j = jenc.TextEncoder.from_preset("tiny-test", config=jenc.EncoderConfig(**cfg))
    out = t.embed_texts(TEXTS[:3])
    assert not np.allclose(np.linalg.norm(out, axis=1), 1.0)
    np.testing.assert_allclose(out, j.embed_texts(TEXTS[:3]), atol=1e-5, rtol=0)


def test_modernbert_encoder_matches_reference():
    j = jenc.TextEncoder.from_preset("modernbert-tiny-test", seed=0)
    t = tenc.TextEncoder.from_preset("modernbert-tiny-test", seed=0, device="cpu")
    assert t.architecture is tenc.ModelArchitecture.MODERNBERT
    got = t.embed_texts(TEXTS)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, j.embed_texts(TEXTS), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dim,seed", [(64, 0), (384, 3)])
def test_hash_embedder_equal(dim, seed):
    got = tenc.HashEmbedder(dim, seed).embed_texts(TEXTS)
    np.testing.assert_array_equal(got, jenc.HashEmbedder(dim, seed).embed_texts(TEXTS))
    assert tenc.HashEmbedder(dim, seed).dimension == dim


@pytest.mark.parametrize("name", [
    "answerdotai/ModernBERT-base", "openai/clip-vit-base-patch32", "colbert-ir/colbertv2.0",
    "vidore/colpali-v1.2", "naver/splade-v3", "jinaai/jina-embeddings-v2",
    "sentence-transformers/all-MiniLM-L6-v2", "BAAI/bge-base-en-v1.5", "modernbert", "bert"])
def test_architecture_detect(name):
    assert tenc.ModelArchitecture.detect(name).value == jenc.ModelArchitecture.detect(name).value
    # the port implements the reference's architectures and Mellum, which
    # the reference does not know
    assert {a.value for a in tenc.IMPLEMENTED_ARCHITECTURES} == \
        {a.value for a in jenc.IMPLEMENTED_ARCHITECTURES} | {"mellum"}


@pytest.mark.parametrize("model_type", ["clip", "colbert", "colpali", "splade", "jina"])
def test_unimplemented_architectures_raise(tmp_path, model_type):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": model_type}))
    with pytest.raises(NotImplementedError, match=model_type):
        tenc.TextEncoder.from_pretrained(tmp_path, device="cpu")


def test_unknown_preset_raises():
    with pytest.raises(ValueError):
        tenc.TextEncoder.from_preset("nope", device="cpu")


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "def", "search", "query", "index",
         "the", "quick", "fox", "(", ")", ":", ",", "_", "##s", "layer", "pass", "entry"]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny BERT checkpoint with a WordPiece vocabulary, saved by
    transformers into a tmp dir."""
    import torch
    from transformers import BertConfig as HFBertConfig, BertModel

    d = tmp_path_factory.mktemp("hf_tok")
    torch.manual_seed(0)
    BertModel(HFBertConfig(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=1,
                           num_attention_heads=2, intermediate_size=64,
                           max_position_embeddings=64)).save_pretrained(str(d))
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True}))
    return d


def test_hf_tokenizer(hf_dir):
    t, j = tenc.HfTokenizer(hf_dir), jenc.HfTokenizer(hf_dir)
    assert t.vocab_size == j.vocab_size == len(VOCAB)
    for text in ("def search_layer(query, entry): pass", "The quick fox", "unknown words"):
        for max_len in (64, 5):
            assert t.encode(text, max_len) == j.encode(text, max_len)
    ids = t.encode("def search", 64)
    assert ids == [VOCAB.index(w) for w in ("[CLS]", "def", "search", "[SEP]")]


def test_from_pretrained_tokenizers(hf_dir, tmp_path):
    enc = tenc.TextEncoder.from_pretrained(hf_dir, device="cpu")
    assert isinstance(enc.tokenizer, tenc.HfTokenizer)
    assert enc.architecture is tenc.ModelArchitecture.BERT and enc.dimension == 32
    # A checkpoint's config.json loads at the default bfloat16: the smallest
    # per-row cosine against the reference's rows.
    assert enc.model_config.dtype == "bfloat16"
    got = enc.embed_texts(TEXTS[:4])
    want = jenc.TextEncoder.from_pretrained(hf_dir).embed_texts(TEXTS[:4])
    assert float(np.min(np.sum(got * want, axis=1))) >= 0.999
    # A weights-only directory falls back to the hash tokenizer.
    weights_only = tmp_path / "weights_only"
    weights_only.mkdir()
    for name in ("config.json", "model.safetensors"):
        (weights_only / name).write_bytes((hf_dir / name).read_bytes())
    enc = tenc.TextEncoder.from_pretrained(weights_only, device="cpu")
    assert isinstance(enc.tokenizer, tenc.SimpleTokenizer)
    assert enc.tokenizer.vocab_size == len(VOCAB)
