"""The plain references against NumPy and against the port on the CPU."""

import numpy as np
import pytest
import torch

from benchmark.harness import data
from benchmark.reference import exact, minilm


@pytest.mark.parametrize("metric", [exact.EUCLIDEAN, exact.COSINE])
def test_exact_topk_matches_numpy_brute_force(metric):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((50, 32)).astype(np.float32)
    if metric == exact.EUCLIDEAN:
        d = np.sqrt(((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1))
    else:
        x64, q64 = x.astype(np.float64), q.astype(np.float64)
        xn = x64 / np.linalg.norm(x64, axis=1, keepdims=True)
        qn = q64 / np.linalg.norm(q64, axis=1, keepdims=True)
        d = 1.0 - qn @ xn.T
    want = np.argsort(d, axis=1, kind="stable")[:, :10]
    got_d, got_i = exact.exact_topk(torch.from_numpy(q), torch.from_numpy(x), 10, metric, block=16)
    np.testing.assert_array_equal(got_i.numpy(), want)
    np.testing.assert_allclose(got_d.numpy(), np.take_along_axis(d, want, 1), rtol=1e-9, atol=1e-12)


def test_round_tf32_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -13, 1.0 + 2 ** -12, -3.0 - 2 ** -9])
    got = exact.round_tf32(t)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, -3.0 - 2 ** -9]


def test_fp8_control_rounds_to_three_mantissa_bits():
    t = torch.linspace(-2.0, 2.0, 1001)
    err = (minilm.fp8_e4m3(t) - t).abs() / t.abs().clamp(min=0.1)
    assert 0.01 < float(err.max()) < 0.07


def test_plain_minilm_matches_the_ports_bert_in_float32_on_the_cpu():
    from islands_tpu_torch.models.bert import BertConfig, encode
    from islands_tpu_torch.models.encoder import TextEncoder

    gen = data.generator(9, "cpu")
    cfg = BertConfig(vocab_size=500, hidden_size=96, num_hidden_layers=3, num_attention_heads=6,
                     intermediate_size=192, max_position_embeddings=64, dtype="float32")
    w = data.bert_weights(gen, 500, 96, 3, 192, 64, 2)
    protos = data.prototypes(gen, 8, 24, 5, 500)
    ids, mask = data.token_rows(gen, protos, 40, 0.3, 5, 500, 6)
    port = encode(TextEncoder(data.to_numpy(w), cfg, device="cpu").model, ids, mask,
                  normalize=False)
    ref = minilm.pooled(w, ids, mask, heads=6, eps=cfg.layer_norm_eps)
    torch.testing.assert_close(port, ref, rtol=2e-5, atol=2e-5)
    assert float((port - port.mean(0)).norm(dim=1).min()) > 0.1  # rows differ


def test_token_rows_have_one_length_multiset_for_every_seed():
    lens = []
    for seed in (1, 2**40 + 3):
        gen = data.generator(seed, "cpu")
        _, mask = data.token_rows(gen, data.prototypes(gen, 4, 64, 10, 99), 330, 0.3, 10, 99, 32)
        lens.append(sorted(mask.sum(1).tolist()))
    assert lens[0] == lens[1] and min(lens[0]) == 32 and max(lens[0]) == 64
