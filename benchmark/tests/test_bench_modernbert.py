"""The ModernBERT cells' pieces on the CPU: the work counts against hand
counts, the plain reference against the port's padded ModernBERT, and a
tiny `leann_recompute_packed` cell run whole, sound and with its encoder's
output altered."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark.drivers import leann_recompute_packed as drv
from benchmark.harness import data, modernbert_work, peaks, runner, spec
from benchmark.reference import modernbert as reference
from benchmark.tests import tiny
from islands_tpu_torch.models import modernbert as port_mb

WD = modernbert_work.Widths(hidden=8, intermediate=4, layers=4, global_every=3, window=2)


@pytest.mark.parametrize("lengths,pairs_local", [
    # |q - k| <= 2 inside each segment, counted by hand
    ([1], [1]),            # the token itself
    ([3], [9]),            # 3 x 3: every pair is within 2
    ([5, 2], [19, 4]),     # 5: 3 + 4 + 5 + 4 + 3; 2: 2 x 2
])
def test_work_counts_match_a_hand_count(lengths, pairs_local):
    assert modernbert_work.band_pairs(lengths, 2).tolist() == pairs_local
    assert (WD.global_layers, WD.local_layers) == (2, 2)  # layers 0 and 3 are global
    dense = 2 * 4 * (4 * 8 * 8 + 3 * 8 * 4)  # 2 x layers x (Wqkv, Wo, Wi, Wo) weights
    assert modernbert_work.dense_flops_per_token(WD) == dense
    want = [s * dense + 4 * 8 * (2 * s * s + 2 * p) for s, p in zip(lengths, pairs_local)]
    assert modernbert_work.segment_flops(lengths, WD).tolist() == want
    nbytes = 4 * sum(lengths) * 8 * 2
    by_kind = [4 * 8 * sum(s * s for s in lengths), 4 * 8 * sum(pairs_local)]
    bound = sum(2 * max(f / peaks.BF16_TC_FLOPS_PER_S, nbytes / peaks.HBM_BYTES_PER_S)
                for f in by_kind)
    assert modernbert_work.attention_bound_s(lengths, WD) == pytest.approx(bound, rel=1e-12)


def test_modernbert_base_work_per_token():
    """modernbert-base's 110.3M matrix weights give 220.6 MFLOP a token."""
    enc = spec.find_cell("mbcode16k.single").config["encoder"]
    wd = modernbert_work.Widths.from_config(enc)
    assert (wd.global_layers, wd.local_layers, wd.window) == (8, 14, 64)
    assert modernbert_work.dense_flops_per_token(wd) == 2 * 110_297_088


TINY_ENC = {"architecture": "modernbert", "vocab_size": 1024, "hidden_size": 64,
            "num_hidden_layers": 4, "num_attention_heads": 4, "intermediate_size": 96,
            "max_position_embeddings": 128, "norm_eps": 1e-05, "pad_token_id": 0,
            "global_rope_theta": 160000.0, "local_rope_theta": 10000.0, "local_attention": 16,
            "global_attn_every_n_layers": 3, "dtype": "float32"}


def test_reference_matches_the_ports_padded_modernbert_on_the_cpu():
    from islands_tpu_torch import convert
    from islands_tpu_torch.models.bert import encode

    gen = data.generator(9, "cpu")
    w = drv.modernbert_weights(gen, 1024, 64, 4, 96)
    protos = data.prototypes(gen, 8, 64, 5, 1000)
    ids, mask, lens = drv.chunk_rows(gen, protos, 24, 0.3, 5, 1000, 8)
    cfg = port_mb.ModernBertConfig(**{k: TINY_ENC[k] for k in drv.MODEL_KEYS})
    model = convert.modernbert_from_numpy(drv._numpy(w), cfg, "cpu")
    with torch.inference_mode():
        port = port_mb.mean_pool_normalize(model(ids, mask), mask, normalize=False)
    ref = reference.pooled_rows(w, TINY_ENC, ids, lens)
    torch.testing.assert_close(port, ref, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(encode(model, ids, mask, normalize=False), ref,
                               rtol=2e-5, atol=2e-5)
    assert sorted(lens.tolist()) == modernbert_work.log_uniform_lengths(24, 8, 64).tolist()
    assert float((port - port.mean(0)).norm(dim=1).min()) > 0.05  # rows differ


CODE = {
    "name": "mbcode-tiny", "driver": "leann_recompute_packed", "metric": "cosine",
    "encoder": TINY_ENC,
    "corpus": {"rows": 256, "seq_len": 64, "min_len": 8, "prototypes": 16, "noise": 0.3,
               "id_lo": 10, "id_hi": 1000},
    "centre_rows": 64,
    "index": {"wave_size": 128, "sketch_query": True, "sketch_dims": 32, "routing_size": 128},
}
TRAFFIC = {"queries_per_call": 1, "pool": 16, "k": 10, "warm_calls": 1, "sample_every": 2,
           "trace_start": 0.1, "trace_seconds": 0.2,
           "search": {"gate": "sketch", "ef": 48, "promote_width": 32, "max_iters": 36}}
LIMITS = {"query_emb_err": 1e-4, "row_emb_err": 1e-4, "centre_err": 1e-4,
          "dist_gap_worst_query": 1e-4}


def _cell(tmp_path):
    bench = tiny._skeleton(tmp_path)
    manifest = json.loads(spec.MANIFEST.read_text())
    manifest["configs"], manifest["workloads"] = [], []
    tiny._add(bench, manifest, "mbcode-tiny.single", CODE, TRAFFIC, LIMITS)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        m.pop("workloads", None)
    tiny.write(tmp_path / "BENCHMARK.json", manifest)
    return spec.find_cell("mbcode-tiny.single", tmp_path / "BENCHMARK.json", bench)


def _run(tmp_path, traced=False):
    return runner.run_cell(_cell(tmp_path), seed=2**31 + 5, seconds=0.4, traced=traced,
                           device="cpu")


def test_a_sound_tiny_run_is_correct_and_counts_its_tokens(tmp_path):
    out = _run(tmp_path, traced=True)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0, out["checks"]
    # the pool's chunks hold 8-64 tokens; every call re-encodes rows too
    assert out["metrics"]["mb_tokens_per_query"]["value"] > 64
    assert out["metrics"]["mb_step_mfu_pct"]["value"] > 0
    assert "mb_attn_roofline_pct" not in out["metrics"]  # no kernel runs on the CPU


def _hidden_altered(inner):
    """The first token's final hidden state moved, as a wrong value written
    where the packed forward produces it."""
    def hidden_packed(self, ids, segs):
        h = inner(self, ids, segs).clone()
        h[0] += 0.5 * h[0].abs().mean()
        return h
    return hidden_packed


def test_an_altered_encoder_output_is_not_correct(tmp_path, monkeypatch):
    cls = port_mb.ModernBertModel
    monkeypatch.setattr(cls, "hidden_packed", _hidden_altered(cls.hidden_packed))
    out = _run(tmp_path)
    assert out["correct"] is False, out["checks"]


def test_the_cell_runs_modernbert_base_whole():
    """The cell's checks are the tiny cell's, its widths modernbert-base's,
    nothing is cut, and its lengths average 692 tokens."""
    cell = spec.find_cell("mbcode16k.single")
    assert set(cell.limits) == set(LIMITS)
    base = dataclasses.asdict(port_mb.ModernBertConfig.modernbert_base())
    enc = cell.config["encoder"]
    assert {k: enc[k] for k in base} == base
    assert cell.config["reduced"] == [] and cell.chips == 1
    assert np.mean(modernbert_work.log_uniform_lengths(16384, 128, 2048)) == pytest.approx(692.5, abs=1.0)
