"""The Mellum cell's pieces on the CPU: the work counts against hand counts,
the plain reference against the port's packed Mellum, and a tiny
`leann_recompute_moe` cell run whole, sound and with its timed path broken."""

import json

import numpy as np
import pytest
import torch

from benchmark.drivers import leann_recompute_moe as drv
from benchmark.harness import data, moe_work, peaks, runner, spec, stats, trace
from benchmark.reference import mellum as reference
from benchmark.tests import tiny
from islands_tpu_torch.models import mellum as port
from islands_tpu_torch.models.modernbert import Segments
from islands_tpu_torch.ops import moe

TYPES = ["sliding_attention"] * 3 + ["full_attention"]
WD = moe_work.Widths(hidden=8, heads=4, kv_heads=2, head_dim=2, experts=6, top_k=2,
                     expert_width=4, window=3, layer_types=tuple(TYPES))


@pytest.mark.parametrize("lengths,full,sliding", [
    # causal pairs (i >= j) and those with i - j < 3, counted by hand
    ([1], [1], [1]),            # the token itself
    ([3], [6], [6]),            # 1 + 2 + 3: the window holds all three
    ([5, 2], [15, 3], [12, 3]),  # 5: 1 + 2 + 3 + 3 + 3; 2: 1 + 2
])
def test_work_counts_match_a_hand_count(lengths, full, sliding):
    assert moe_work.causal_pairs(lengths).tolist() == full
    assert moe_work.causal_pairs(lengths, 3).tolist() == sliding
    assert (WD.full_layers, WD.sliding_layers) == (1, 3)
    # q, k, v (8 x (4 + 2 x 2) x 2) and o (4 x 2 x 8), the router (8 x 6),
    # two experts' gate, up and down (3 x 8 x 4 each)
    per_layer = 8 * 8 * 2 + 8 * 8 + 8 * 6 + 2 * 3 * 8 * 4
    assert moe_work.dense_flops_per_token(WD) == 2 * 4 * per_layer
    want = [s * 2 * 4 * per_layer + 4 * 4 * 2 * (f + 3 * w)
            for s, f, w in zip(lengths, full, sliding)]
    assert moe_work.segment_flops(lengths, WD).tolist() == want
    t = sum(lengths)
    a = 2 * t
    flops = 6 * a * 8 * 4
    nbytes = 2 * (min(6, a) * 3 * 8 * 4 + t * 8 + a * (8 + 2 * 4))
    bound = 4 * max(flops / peaks.BF16_TC_FLOPS_PER_S, nbytes / peaks.HBM_BYTES_PER_S)
    assert moe_work.experts_bound_s(t, WD) == pytest.approx(bound, rel=1e-12)
    qkvo = 2 * t * 2 * (2 * 4 + 2 * 2)
    attn = sum(n * max(4 * 4 * 2 * p / peaks.BF16_TC_FLOPS_PER_S, qkvo / peaks.HBM_BYTES_PER_S)
               for n, p in ((1, sum(full)), (3, sum(sliding))))
    assert moe_work.attention_bound_s(lengths, WD) == pytest.approx(attn, rel=1e-12)


def test_mellum_work_per_token():
    """Mellum2-12B-A2.5B: 1.986B active matrix weights a token (3.97 GFLOP),
    1.387B of them the experts'; at a hop's 3,300 tokens the grouped GEMM
    is bound by its FLOPs (327 GFLOP a layer) just above its bytes."""
    wd = moe_work.Widths.from_config(spec.find_cell("mellum8k.single").config)
    assert (wd.full_layers, wd.sliding_layers, wd.window) == (7, 21, 1024)
    assert moe_work.active_params_per_layer(wd) * 28 == 1_985_937_408
    assert 28 * 8 * 3 * 2304 * 896 == 1_387_266_048
    per_layer = moe_work.experts_bound_s(3300, wd) / 28
    assert per_layer == pytest.approx(6 * 26400 * 2304 * 896 / peaks.BF16_TC_FLOPS_PER_S)


TINY = port.MellumConfig.tiny_test()


def _weights(seed=4):
    return port.init_params(TINY, seed, "cpu")


def test_reference_matches_the_ports_packed_mellum_on_the_cpu():
    """float32 both sides: only the order of sums differs."""
    gen = data.generator(9, "cpu")
    w = _weights()
    protos = data.prototypes(gen, 8, 40, 5, 1000)
    ids, mask, lens = drv.packed.chunk_rows(gen, protos, 24, 0.3, 5, 1000, 6)
    model = port.MellumModel(TINY, w)
    got = model.pooled_rows(ids, torch.arange(24), lens)
    want = reference.pooled_rows(w, TINY.to_hf(), ids, lens)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert lens.max() > TINY.sliding_window * 4  # the window binds
    assert float((got - got.mean(0)).norm(dim=1).min()) > 0.05  # rows differ


def test_reference_pools_the_last_token_of_its_hidden_states():
    w = _weights()
    ids = torch.randint(5, 1000, (3, 20), generator=torch.Generator().manual_seed(1))
    cfg = TINY.to_hf()
    h = reference.hidden(w, cfg, ids)
    torch.testing.assert_close(reference.pooled(w, cfg, ids), h[:, -1])
    model = port.MellumModel(TINY, w)
    segs = Segments.from_lengths([20, 20, 20], "cpu")
    torch.testing.assert_close(model.hidden_packed(ids.reshape(-1), segs), h.reshape(60, -1),
                               rtol=2e-5, atol=2e-5)


def _config():
    return {"name": "mellum-tiny", "driver": "leann_recompute_moe", "metric": "cosine",
            **TINY.to_hf(),
            "corpus": {"rows": 256, "seq_len": 40, "min_len": 6, "prototypes": 16,
                       "noise": 0.3, "id_lo": 10, "id_hi": 1000},
            "centre_rows": 64,
            "index": {"wave_size": 128, "sketch_query": True, "sketch_dims": 32,
                      "routing_size": 128}}


TRAFFIC = {"queries_per_call": 1, "pool": 16, "k": 10, "warm_calls": 1, "sample_every": 2,
           "trace_start": 0.1, "trace_seconds": 0.2,
           "search": {"gate": "sketch", "ef": 48, "promote_width": 32, "max_iters": 36}}
LIMITS = {"query_emb_err": 1e-4, "row_emb_err": 1e-4, "centre_err": 1e-4,
          "dist_gap_worst_query": 1e-4}


def _cell(tmp_path):
    bench = tiny._skeleton(tmp_path)
    manifest = json.loads(spec.MANIFEST.read_text())
    manifest["configs"], manifest["workloads"] = [], []
    tiny._add(bench, manifest, "mellum-tiny.single", _config(), TRAFFIC, LIMITS)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        m.pop("workloads", None)
    tiny.write(tmp_path / "BENCHMARK.json", manifest)
    return spec.find_cell("mellum-tiny.single", tmp_path / "BENCHMARK.json", bench)


def _run(tmp_path, traced=False):
    return runner.run_cell(_cell(tmp_path), seed=2**31 + 17, seconds=0.4, traced=traced,
                           device="cpu")


def test_a_sound_tiny_run_is_correct_and_counts_its_work(tmp_path):
    out = _run(tmp_path, traced=True)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0, out["checks"]
    assert out["metrics"]["mellum_step_mfu_pct"]["value"] > 0
    assert "moe_gemm_roofline_pct" not in out["metrics"]  # no kernel runs on the CPU


def _hidden_altered(inner):
    """The last token's final hidden state moved, as a wrong value written
    where the packed forward produces it."""
    def hidden_packed(self, ids, segs):
        h = inner(self, ids, segs).clone()
        h[-1] += 0.5 * h[-1].abs().mean()
        return h
    return hidden_packed


def _router_off_by_one(inner):
    """Every token routed to the expert after each one it chose."""
    def route(y, router_w, top_k, norm_topk=True):
        r = inner(y, router_w, top_k, norm_topk)
        e = (r.experts + 1) % router_w.shape[1]
        flat, order = torch.sort(e.reshape(-1), stable=True)
        offsets = torch.searchsorted(flat, torch.arange(router_w.shape[1] + 1))
        position = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel()))
        return moe.Routing(r.weights, e, order, offsets, position)
    return route


@pytest.mark.parametrize("fault", ["encoder output altered", "experts misrouted"])
def test_a_broken_path_is_not_correct(tmp_path, monkeypatch, fault):
    if fault == "encoder output altered":
        cls = port.MellumModel
        monkeypatch.setattr(cls, "hidden_packed", _hidden_altered(cls.hidden_packed))
    else:
        monkeypatch.setattr(moe, "route", _router_off_by_one(moe.route))
    out = _run(tmp_path)
    assert out["correct"] is False, out["checks"]


def test_the_cell_runs_mellum_whole():
    """The configuration holds every number of the published config.json
    under its own key, nothing is cut, the checks are the tiny cell's, and
    the lengths average 104 tokens."""
    cell = spec.find_cell("mellum8k.single")
    cfg = cell.config
    assert port.MellumConfig.from_hf(cfg) == port.MellumConfig.mellum2_12b_a2_5b()
    assert cfg["reduced"] == [] and cell.chips == 1
    assert (cfg["num_experts"], cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]) == \
        (64, 8, 896)
    assert set(cell.limits) == set(LIMITS)
    lens = drv.packed.modernbert_work.log_uniform_lengths(8192, 48, 192)
    assert np.mean(lens) == pytest.approx(104.0, abs=1.0)
    assert {m["name"] for m in cell.per_layer} >= {"moe_gemm_roofline_pct",
                                                   "mellum_step_mfu_pct",
                                                   "device_idle_pct.single"}


def test_the_driver_hands_the_port_its_own_weight_tensors():
    """No second copy: the model's tensors are the driver's, and the
    weights come from the seed."""
    def weights(seed):
        d = drv.Driver(_config(), TRAFFIC, seed, torch.device("cpu"), spans=None)
        d.make_inputs()
        d.make_weights()
        return d

    d = weights(3)
    for name in ("embed", "final_norm"):
        assert d.encoder.model.w[name].data_ptr() == d.weights[name].data_ptr()
    for name, t in d.weights["layers"].items():
        assert d.encoder.model.w[name].data_ptr() == t.data_ptr()
    torch.testing.assert_close(weights(3).weights["layers"]["gate_up_w"],
                               d.weights["layers"]["gate_up_w"], rtol=0, atol=0)
    assert not torch.equal(weights(4).weights["layers"]["gate_up_w"],
                           d.weights["layers"]["gate_up_w"])
    # the driver draws them itself, not through the port's init_params
    import inspect

    assert "init_params" not in inspect.getsource(drv)
    gen = data.generator((3 + drv.WEIGHT_SEED) % 2**63, "cpu")
    own = drv.mellum_weights(gen, _config(), torch.device("cpu"))
    for name, t in own["layers"].items():
        assert torch.equal(t, d.weights["layers"][name]), name
    assert torch.equal(own["embed"], d.weights["embed"])


def test_the_import_guard_covers_the_mellum_files():
    """The guard of test_bench_imports loads every file of these folders;
    the Mellum cell's are among them, and the reference imports nothing of
    the port or of JAX."""
    import ast

    bench = spec.BENCH_DIR
    for path in ("drivers/leann_recompute_moe.py", "reference/mellum.py", "harness/moe_work.py",
                 "metrics/moe_gemm_roofline_pct.py", "metrics/mellum_step_mfu_pct.py"):
        assert (bench / path).is_file(), path
    tree = ast.parse((bench / "reference" / "mellum.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names} | \
        {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {n for n in names if n.split(".")[0] in ("jax", "islands_tpu", "islands_tpu_torch",
                                                        "triton")}
    assert names <= {"__future__", "math", "numpy", "torch", "torch.nn.functional",
                     "benchmark.reference.exact"}


def test_the_experts_roofline_reads_the_passes_and_the_grouped_gemm():
    """Its time is the three passes' and the grouped GEMM's together; a
    slice without the grouped kernel reads nothing, and other GEMMs are not
    the experts'."""
    reader = spec.load_reader("moe_gemm_roofline_pct")
    calls = [stats.CallRecord(0.0, 1.0, 1, {"moe_bound_s": 0.002}, profiled=True),
             stats.CallRecord(1.0, 2.0, 1, {"moe_bound_s": 0.001}, profiled=False)]
    ops = {"moe_gemm_gather": (28, 0.001), "moe_gemm_swiglu": (28, 0.001),
           "moe_gemm_combine": (28, 0.001),
           "void cutlass::device_kernel<cutlass::gemm::kernel::GemmUniversal<cutlass::gemm::"
           "GroupProblemShape<cute::tuple<int, int, int> >": (56, 0.004),
           "nvjet_tst_256x136_64x4_1x2_h_bz_coopA_NNT": (56, 0.5)}

    def run(ops_):
        s = trace.TraceSummary(window_s=1.0, busy_s=0.5, ops=ops_, idle={})
        return runner.Run(setup_s=1.0, build_s=1.0, build_rows=1, calls=calls, window_s=2.0,
                          recall=1.0, spans={}, info={}, trace=s)

    assert reader.read(run(ops)) == pytest.approx(100.0 * 0.002 / 0.007)
    assert reader.read(run({k: v for k, v in ops.items() if "cutlass" not in k})) is None
    assert reader.read(run({k: v for k, v in ops.items() if "moe_gemm" not in k})) is None
