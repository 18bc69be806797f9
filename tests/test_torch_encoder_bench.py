"""The port's encoder bench against benches/encoder_bench.py, and ModernBERT
behind the indexer service as a user configures it.

- FLOP counts: equal to the reference bench's, integer for integer, for
  minilm-l6, bge-base and modernbert-base at seq 256 (the reference bench is
  imported by path; its top level needs no jax).
- The bench's rows at tiny-test / modernbert-tiny-test on the CPU carry the
  keys of the rows the reference bench returns (its row code is the same
  for every architecture; it runs once, at modernbert-tiny-test).
- The service built from Config(embedding_kind="encoder",
  embedding_model="modernbert-tiny-test").indexer_config() returns the hits
  of the JAX package's service in stored mode on the same directory (the
  reference runs ModernBERT only there: its recompute provider raises),
  scores within atol 1e-5 (float32 encoders, the same graph).
- In recompute mode the port's service returns its stored-mode hits, scores
  within atol 1e-5: both modes run each chunk's valid tokens through the
  packed forward (the stored rows from the texts, the recomputed ones
  packed from the provider's token table), in batches of other chunks, so
  they differ only in the order of float sums; a reorder is allowed only
  between scores that tie within it.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from islands_tpu.config import Config as JConfig
from islands_tpu.indexer import IndexerService as JIndexerService
from islands_tpu.models import modernbert as jmb
from islands_tpu_torch.benches import encoder_bench
from islands_tpu_torch.config import Config
from islands_tpu_torch.indexer import IndexerService
from islands_tpu_torch.models import PRESETS, ModelArchitecture
from islands_tpu_torch.models.provider import EncoderEmbeddingProvider

REPO = pathlib.Path(__file__).resolve().parent.parent
SCORE_ATOL = 1e-5
QUERIES = ["distance between two vectors", "parse the config file",
           "merge sorted lists of candidates", "open a socket and send bytes",
           "train the codebook"]


def _reference_bench():
    spec = importlib.util.spec_from_file_location(
        "reference_encoder_bench", REPO / "benches" / "encoder_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_bench():
    return _reference_bench()


@pytest.mark.parametrize("fn", ["model_flops_per_token", "modernbert_flops_per_token"])
@pytest.mark.parametrize("preset", ["minilm-l6", "bge-base", "modernbert-base"])
def test_flop_counts_equal_the_reference_bench(ref_bench, preset, fn):
    cfg = PRESETS[preset][0]()
    got = getattr(encoder_bench, fn)(cfg, encoder_bench.SEQ)
    assert got == getattr(ref_bench, fn)(cfg, 256)
    assert isinstance(got, int) and got > 0


@pytest.mark.parametrize("preset", ["minilm-l6", "bge-base", "modernbert-base"])
def test_bench_counts_each_architecture_as_the_reference_does(ref_bench, preset):
    """The reference bench's main passes modernbert_flops_per_token for
    ModernBERT and model_flops_per_token for the BERTs."""
    cfg = PRESETS[preset][0]()
    fn = ref_bench.modernbert_flops_per_token if preset.startswith("modernbert") \
        else ref_bench.model_flops_per_token
    assert encoder_bench.flops_per_token(cfg, 256) == fn(cfg, 256)


def test_modes_are_the_reference_benchs():
    assert encoder_bench.MODES == {
        "default": [("minilm-l6", (64, 256, 1024)), ("bge-base", (64, 256, 512))],
        "modernbert": [("modernbert-base", (64,))]}
    assert encoder_bench.SEQ == 256


@pytest.fixture(scope="module")
def ref_row(ref_bench):
    """One row of the reference bench (its row code is the same for every
    architecture), at modernbert-tiny-test."""
    return ref_bench.bench_config("modernbert-tiny-test", jmb.ModernBertConfig.tiny_test(), 32,
                                  (2,), reps=1, chains=(1, 2), module=jmb,
                                  flops_fn=ref_bench.modernbert_flops_per_token)[0]


@pytest.mark.parametrize("preset", ["tiny-test", "modernbert-tiny-test"])
def test_rows_carry_the_reference_keys(ref_row, preset):
    got = encoder_bench.bench_config(preset, (2, 3), seq=32, device="cpu")
    assert [list(r) for r in got] == [list(ref_row)] * 2
    assert [(r["model"], r["batch"], r["seq"]) for r in got] == [(preset, 2, 32),
                                                                 (preset, 3, 32)]
    for r in got:
        assert r["mfu"] is None  # no device share from a CPU run
        assert r["tokens_per_s"] == pytest.approx(r["texts_per_s"] * 32)
        assert r["ms_per_batch"] == pytest.approx(1e3 * r["batch"] / r["texts_per_s"])


def test_bench_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encoder_bench.bench_config("tiny-test", (2,), seq=32)


def _tree(root: pathlib.Path) -> pathlib.Path:
    """24 small source files, each chunk's text distinct."""
    rng = np.random.default_rng(4)
    words = ("vector distance merge sorted list socket bytes config parse file "
             "codebook train graph search query index shard encode token layer "
             "window rotary global local").split()
    for f in range(24):
        lines = [f"def f{f}_{i}({', '.join(rng.choice(words, 3))}):\n"
                 f"    return {' + '.join(rng.choice(words, 4))}  # {f}.{i}\n"
                 for i in range(6)]
        (root / f"mod{f:02d}.py").write_text("".join(lines))
    return root


def _keys(hits):
    return [(h["index"], h["path"], h["start_line"], h["end_line"]) for h in hits]


def _assert_same_hits(got, want):
    """Scores within SCORE_ATOL position by position; a hit may differ from
    the other side's at its position only where the two scores there tie
    within SCORE_ATOL with the hit's own score on the other side."""
    gs, ws = [h["score"] for h in got], [h["score"] for h in want]
    np.testing.assert_allclose(gs, ws, atol=SCORE_ATOL, rtol=0)
    wk = {k: s for k, s in zip(_keys(want), ws)}
    for k, s, w in zip(_keys(got), gs, _keys(want)):
        assert k == w or (k in wk and abs(wk[k] - s) <= SCORE_ATOL), (k, w)


def _config(config_cls, tmp_path, name, **kw):
    return config_cls(base_path=str(tmp_path / name), embedding_kind="encoder",
                      embedding_model="modernbert-tiny-test", **kw).indexer_config()


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    return _tree(tmp_path_factory.mktemp("src"))


def test_modernbert_service_matches_the_reference_service_stored(src, tmp_path):
    port = IndexerService(_config(Config, tmp_path, "port"), device="cpu")
    ref = JIndexerService(_config(JConfig, tmp_path, "ref"))
    info, jinfo = port.index_local_path(src, "proj"), ref.index_local_path(src, "proj")
    assert port.embedder.architecture is ModelArchitecture.MODERNBERT
    assert (info.num_chunks, info.num_files, info.dimension, info.mode) == (
        jinfo.num_chunks, jinfo.num_files, jinfo.dimension, jinfo.mode) == (
        info.num_chunks, 24, 64, "stored")
    assert info.num_chunks >= 24
    for q in QUERIES:
        got, want = port.search(q, top_k=5), ref.search(q, top_k=5)
        assert len(got) == 5
        _assert_same_hits(got, want)


def test_modernbert_service_recompute_matches_stored(src, tmp_path):
    stored = IndexerService(_config(Config, tmp_path, "stored"), device="cpu")
    recompute = IndexerService(_config(Config, tmp_path, "recompute", embedding_recompute=True),
                               device="cpu")
    stored.index_local_path(src, "proj")
    info = recompute.index_local_path(src, "proj")
    assert info.mode == "recompute"
    assert isinstance(recompute.indexes["proj"].provider, EncoderEmbeddingProvider)
    for q in QUERIES:
        _assert_same_hits(recompute.search(q, top_k=5), stored.search(q, top_k=5))
