"""Tiny cells on the CPU for the tests: the real drivers, readers and
references in a copy of the benchmark's layout, at sizes a test can hold."""

from __future__ import annotations

import json
import pathlib
import shutil

from benchmark.harness import spec

SIFT = {
    "name": "sift-tiny", "driver": "stored_sketch", "metric": "euclidean",
    "corpus": {"rows": 2048, "dim": 128, "centres": 32, "sigma": 0.8},
    "index": {"wave_size": 512, "sketch_dims": 48, "ef_construction": 64, "reverse_slack": 20},
    "routing_size": 512,
}
SIFT_TRAFFIC = {"queries_per_call": 64, "pool": 256, "k": 10, "warm_calls": 1,
                "trace_start": 0.1, "trace_seconds": 0.2,
                "search": {"gate": "sketch", "ef": 32, "promote_width": 16, "max_iters": 12,
                           "expand_width": 2, "final_rescore": 64, "hop_merge": "fused"}}
CODE = {
    "name": "code-tiny", "driver": "leann_recompute", "metric": "cosine",
    "encoder": {"vocab_size": 1024, "hidden_size": 64, "num_hidden_layers": 2,
                "num_attention_heads": 4, "intermediate_size": 128,
                "max_position_embeddings": 128, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
                "dtype": "float32"},
    "corpus": {"rows": 1024, "seq_len": 16, "prototypes": 32, "noise": 0.3, "id_lo": 10,
               "id_hi": 1000, "min_len": 8},
    "centre_rows": 256,
    "index": {"wave_size": 256, "sketch_query": True, "sketch_dims": 32, "routing_size": 256},
}
CODE_TRAFFIC = {"queries_per_call": 8, "pool": 64, "k": 10, "warm_calls": 1, "sample_every": 2,
                "trace_start": 0.1, "trace_seconds": 0.2,
                "search": {"gate": "sketch", "ef": 48, "promote_width": 32, "max_iters": 36}}
SIFT_LIMITS = {"dist_rel_err": 1e-5}
CODE_LIMITS = {"query_emb_err": 1e-4, "row_emb_err": 1e-4, "centre_err": 1e-4,
               "dist_gap_worst_query": 1e-4}


def _skeleton(tmp: pathlib.Path) -> pathlib.Path:
    """A benchmark folder under tmp with the real drivers and readers."""
    bench = tmp / "benchmark"
    for sub in ("drivers", "metrics"):
        shutil.copytree(spec.BENCH_DIR / sub, bench / sub)
    for sub in ("configs", "traffic", "workloads"):
        (bench / sub).mkdir(parents=True)
    return bench


def _add(bench: pathlib.Path, manifest: dict, cell: str, cfg: dict, traffic: dict,
         limits: dict) -> None:
    """Files and manifest entries of one cell, its configuration and mix
    named after it."""
    write(bench / "configs" / f"{cell}.json", cfg)
    write(bench / "traffic" / f"{cell}.json", traffic)
    write(bench / "workloads" / f"{cell}.json", {"limits": limits})
    manifest["configs"].append({"name": cell, "source": "tests", "reduced": [], "why": "tests",
                                "file": f"benchmark/configs/{cell}.json"})
    manifest["workloads"].append({"name": cell, "config": cell, "traffic": cell, "chips": 1,
                                  "why": "tests"})


def layout(tmp: pathlib.Path) -> tuple[pathlib.Path, pathlib.Path]:
    """The tiny cells "sift-tiny.batch" and "code-tiny.batch" under tmp,
    every metric reported by both. Returns (manifest path, folder)."""
    bench = _skeleton(tmp)
    manifest = json.loads(spec.MANIFEST.read_text())
    manifest["configs"], manifest["workloads"] = [], []
    _add(bench, manifest, "sift-tiny.batch", SIFT, SIFT_TRAFFIC, SIFT_LIMITS)
    _add(bench, manifest, "code-tiny.batch", CODE, CODE_TRAFFIC, CODE_LIMITS)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        m.pop("workloads", None)
    write(tmp / "BENCHMARK.json", manifest)
    return tmp / "BENCHMARK.json", bench


def write(path: pathlib.Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def cell(tmp: pathlib.Path, name: str) -> spec.Cell:
    manifest, bench = layout(tmp)
    return spec.find_cell(name, manifest, bench)


def real_cell(tmp: pathlib.Path, name: str, rows: int, pool: int) -> spec.Cell:
    """A cell of BENCHMARK.json at its own widths, limits and knobs, with
    its corpus cut to `rows` and its pool to `pool` queries."""
    real = spec.find_cell(name)
    cfg = json.loads(json.dumps(real.config))
    cfg["corpus"]["rows"] = rows
    cfg["centre_rows"] = min(cfg.get("centre_rows", rows), rows)
    traffic = dict(real.traffic, pool=pool,
                   queries_per_call=min(real.traffic["queries_per_call"], pool))
    bench = _skeleton(tmp)
    manifest = json.loads(spec.MANIFEST.read_text())
    manifest["configs"], manifest["workloads"] = [], []
    _add(bench, manifest, name, cfg, traffic, real.limits)
    write(tmp / "BENCHMARK.json", manifest)
    return spec.find_cell(name, tmp / "BENCHMARK.json", bench)
