"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # every phase, corpora of 1,000,000 vectors
    python3 chip_smoke.py --n 262144 # a smaller config-2 corpus (depth cut only;
                                     # phases 5-7 and 10 reuse it)

Phases, each fatal on failure:
1. set-up: the card's name and power limit; build the port's CUDA kernels
   from islands_tpu_torch/csrc (one nvcc per source, all at once), with
   ptxas's registers and shared memory per kernel.
2. each kernel against its plain PyTorch version on the card, bit for bit,
   at its paths' shapes (ties and edge codes included), with its device time
   (torch.profiler, beside the CUDA-event time of the wrapper calls), the
   plain version's time, its bound and the time of one PyTorch library call
   that computes the same function, where there is one. K1 (hop-merge) is
   held bit for bit on both of its routes, K3 on both of its routes ("sums",
   and "smallest", which selects each query's r best candidates without
   writing the [B, N] sums; its time beside the chain it replaces), K4 (pairwise tiles, 3xTF32 on
   the tensor cores) within 1e-5 of the operands' squared norms (see
   assert_pairwise_close), K5 (row gather) bit for bit, V1 (varlen attention,
   Triton) at a mbcode16k recompute hop's 32 segments, global and local, each
   segment within 5e-3 of the plain version by norm, its library call
   flex_attention compiled with a segment (+ band) block mask; V1's causal
   grouped-query mode at Mellum's widths (32 query and 4 key heads of 128,
   32 segments of 48-192 tokens, sliding layers' window 1,024 and full
   layers' YaRN tables), each segment within 5e-3 by norm, its library
   call flex_attention with a causal segment (+ window) mask and shared key
   heads; M1 (`ops/moe.moe_gemm`: the expert products by
   torch._grouped_mm between the Triton gather, SwiGLU and combine passes)
   at Mellum's 2,304 x 896, 64 experts, top 8, at a recompute hop's 3,300
   tokens and the build's 32,768, each token within 4e-3 of its plain
   version by norm, its library call the two bare grouped products. Then smallest_k's two
   routes (stable sort, top-k on unique keys) at the paths' row widths: equal
   positions, and the time of each, which sets merge.SORT_MAX_WIDTH.
3. config 2, the main path of bench.py on the port: a seeded
   Gaussian-mixture corpus (4096 centres, sigma 0.8) made on the card,
   build_index_with_sketch at bench.py's LeannConfig, brute_force_topk
   ground truth, StoredSearcher(routing_size=65536) and the five primary
   rungs with the fused hop-merge: recall@10 and QPS (median of 5 passes,
   with the spread) per rung.
4. config 4, bench_extra.py's PQ path on the port: 1,000,000 x 768 from the
   same mixture, LeannIndex.build_from_embeddings with 16 x 256 PQ, the
   two-level ladder of bench_extra.py (routing 65536, grouped ADC, fused
   hop-merge) and search_pq_scan at rerank 128 and 256 (K3's "smallest"
   route) and 2048 (past its r, the "sums" route): recall@10 and QPS per
   rung, exact distances, grouped == einsum and fused == inline, and
   search_pq_scan's results equal to those of the chain it replaced (K3
   "sums" + finalise + smallest_k), with the peak device memory of each.
5. the gather bench (islands_tpu_torch.benches.gather_bench.main at the
   reference bench's sizes, kernel K5) and the ops API: brute-force top-10
   of phase 3's queries through ops.pairwise_l2 / pairwise_neg_dot with
   use_kernel=True (kernel K4), against brute_force_topk: the same ids on
   every row but swaps of candidates whose distances agree within K4's
   tolerance, which are counted.
6. the index lifecycle at phase 3's corpus and LeannConfig:
   LeannIndex.build_from_embeddings on 934,464 rows, extend to all rows (one
   65,536-row re-index), save_index (with and without the sketch),
   load_index, and LeannIndex.search (gate "none" at ef 64 and 128, the
   sketch gate at the headline knobs) on the loaded and the in-memory index,
   which must agree exactly; a StoredSearcher over the extended graph at
   phase 3's headline rung must keep recall@10 >= 0.90.
7. HNSW on the first 262,144 rows of the same corpus (a depth cut, for the
   time limit; its own ground truth): HnswIndex build, search at ef 64 and
   128, save_hnsw / load_hnsw (identical results), and Searcher ==
   index.search.
8. config 3, LEANN recompute search with the encoder on the card
   (bench_extra.py's config 3, nothing cut): 131,072 seeded chunks of 64
   token ids, minilm-l6 in bfloat16 behind the centred
   EncoderEmbeddingProvider, LeannIndex.build, then the sketch gate at ef 48
   / promote 32 / 36, 33 and 30 hops and gate "none" at ef 64: recall@10,
   QPS (median of 3 passes), recompute fraction and encodes/s per rung
   (i36 must reach 0.90, gate "none" 0.98); a profile of one gated pass; the
   encoder alone (texts/s, tokens/s, share of the bf16 peak); the card's
   encode of 256 rows against the port's float32 forward on the CPU.
9. config 1, the checkout's own source (bench_extra.py's config 1): the
   native loader's chunks equal to the Python chunker's (the loader must
   build), bge-base in bfloat16, LeannIndex.build and the sketch gate at
   ef 96 on the first 128 chunks (a depth cut from 256, for the time
   limit): recall@10 (>= 0.90), QPS, recompute fraction, encodes/s; the
   card's encode of 64 rows against the CPU's.
10. config 5, the sharded archipelago (islands_tpu_torch.parallel) over
   phase 3's corpus as 2 shards on the one card (cut from 10M on 8 chips):
   build_sharded on the first 934,464 rows and extend_sharded by 65,536
   (gids equal row ids), with the build and extend seconds in total and per
   shard; the sketch gate p16 and p48 with the fused hop-merge (K1) and the
   routed exact gate at ef 64 / i24: recall@10 (p16 and exact >= 0.90), QPS,
   per-shard and merge ms (CUDA events); at every rung the merged top-10
   equals a host merge of the per-shard results; fused == inline, the
   recompute gate over per-shard InMemoryEmbeddingProviders == the stored
   gate, save_sharded / load_sharded (identical results), bytes/vector, a
   profile of one p16 pass.
10b. refine: build_index_with_sketch on the first 131,072 rows with
   refine_passes 0 and 1 (sketch path): both keep the build invariants, the
   pass rewrites some rows, and the refined graph's recall@10 loses at most
   0.02 at the exact gate's ef 64 and ef 10 and at config 5's p16 rung (K1).
11. the indexer service on the card: IndexerService with minilm-l6 over the
   checkout, stored and recompute: index_local_path, 16 text queries, the
   same hits from a fresh service on the base path; a local git origin
   added (add_repository), committed to and synced (sync_repository
   re-indexes).
12. the CLI (islands_tpu_torch.cli.main), on the card by default:
   12a. `build --pq --pq-subquantizers 16 --metric euclidean` on the first
   131,072 rows of phase 4's corpus (a depth cut for the time limit) and
   `query` / `eval` with its 4,096 queries at the CLI's default knobs and at
   config 4's first rung (--ef 128 --max-iters 16 --promote-width 16): K2
   (at E = 240) is the only kernel launched; query's ids and distances equal
   a direct load_index(...).search_two_level(...) with the same knobs, and
   eval's recall is their recall against brute_force_topk (within 1e-4);
   build s, vec/s, recall, QPS and K2's device ms per launch on the path.
   12b. the repository commands over a minilm-l6 service, from a config file
   the fallback YAML parser reads: add (a local git origin), sync after a
   commit (of a tracked clone of it), workspace create/add-repo/list/delete,
   list, status, search (JSON equal to IndexerService.search on the base
   path), config show, ask with the mock LLM.
   12c. `python -m islands_tpu_torch.cli --config <file> mcp` as a
   subprocess over pipes: initialize, notifications/initialized, tools/list,
   islands_search (the hits of 12b's search), islands_list, islands_status,
   a malformed line and shutdown; it exits 0 and its stdout holds JSON-RPC
   responses alone; ms per islands_search call.
   12d. utils.tracing.span(block_on=...) around one K2 launch at 12a's shape
   records at least its CUDA-event time, alone and behind 2 ms of device work.
13. ModernBERT (modernbert-base at its published width, random-init, bf16),
   on its packed route: every forward on the card launches V1 once a layer.
   13a. the encoder bench (islands_tpu_torch.benches.encoder_bench.main, both
   modes: minilm-l6 and bge-base, then modernbert-base, at seq 256): tokens/s,
   texts/s, share of the bf16 peak by the reference bench's FLOP counts; the
   card's encode against the CPU's float32 forward on 16 rows at seq 256 with
   padded rows (phase 8's cosine bounds); one encode at the recompute
   provider's chunk: its attention kernels and the memory it adds.
   13b. config 1 as in phase 9 with modernbert-base in place of bge-base, on
   its 128 queries and one timed pass: recall@10 (>= 0.90), QPS,
   recompute fraction, encodes/s, peak device memory.
   13c. the service from Config(embedding_kind="encoder",
   embedding_model="modernbert-base").indexer_config() over
   islands_tpu_torch/core, stored and recompute: 16 text queries, the same
   hits from a fresh service; index s, ms per query.
The kernels' launch counts are zeroed just before each path and read just
after it; phases 8, 9 and 11 launch none of them, phase 12 K2 alone, and
phase 13 V1 alone, once a layer of each packed forward on the card (it
fails otherwise).

Prints a JSON line of path figures, one of kernel figures, the card's name
and power limit, and last `{"ok": true, "device": {...}}`. Exits non-zero,
with no result, when no CUDA device is present or the port cannot be
imported.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import queue
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import unittest.mock

import numpy as np
import torch
import torch.nn.functional as F

import islands_tpu_torch
from benchmark.harness import modernbert_work, moe_work
from islands_tpu_torch import cli, ops
from islands_tpu_torch.benches import encoder_bench, gather_bench
from islands_tpu_torch.config import Config, _parse_simple_yaml
from islands_tpu_torch.core.build import build_index_with_sketch
from islands_tpu_torch.core.config import (
    DistanceMetric,
    HnswConfig,
    LeannConfig,
    PQConfig,
    SearchConfig,
)
from islands_tpu_torch.core.embedding import InMemoryEmbeddingProvider, materialize_embeddings
from islands_tpu_torch.core.hnsw import HnswIndex
from islands_tpu_torch.core import leann as leann_mod
from islands_tpu_torch.core.leann import LeannIndex
from islands_tpu_torch.core.pq import pq_scan, pq_scan_smallest
from islands_tpu_torch.core.search import StoredSearcher, make_recompute_scorer
from islands_tpu_torch.core.searchapi import Searcher
from islands_tpu_torch.core.storage import load_hnsw, load_index, save_hnsw, save_index
from islands_tpu_torch.indexer.files import chunk_files, collect_files
from islands_tpu_torch.indexer.native import collect_chunks_native
from islands_tpu_torch.indexer.service import EmbeddingConfig, IndexerConfig, IndexerService
from islands_tpu_torch.models import bert as bert_mod
from islands_tpu_torch.models import mellum
from islands_tpu_torch.models.encoder import ModelArchitecture, TextEncoder, architecture_module
from islands_tpu_torch.models.modernbert import ModernBertModel, rope_tables
from islands_tpu_torch.models.provider import EMBED_CHUNK_BATCHES, EncoderEmbeddingProvider
from islands_tpu_torch.ops import _cuda, merge
from islands_tpu_torch.ops import proj as proj_ops
from islands_tpu_torch.ops.adc import (
    SMALLEST_MAX_R,
    adc_scan,
    adc_scan_reference,
    adc_scan_smallest,
    adc_scan_smallest_reference,
    finalize_adc,
    gated_adc_reference,
    gated_adc_sums,
    smallest_max_r,
    smallest_tiles,
)
from islands_tpu_torch.ops.distance import brute_force_topk, prep_corpus, rowwise_distance
from islands_tpu_torch.ops.gather import row_gather, row_gather_reference
from islands_tpu_torch.ops.hop_merge import hop_merge, hop_merge_reference
from islands_tpu_torch.ops import moe
from islands_tpu_torch.ops import varlen_attention as va
from islands_tpu_torch.ops.pairwise import (
    pairwise_l2,
    pairwise_l2_reference,
    pairwise_neg_dot,
    pairwise_neg_dot_reference,
)
from islands_tpu_torch.parallel import sharded as sharded_mod
from islands_tpu_torch.parallel.mesh import make_mesh
from islands_tpu_torch.parallel.sharded import (
    ArchipelagoSearcher,
    build_sharded,
    extend_sharded,
    load_sharded,
    save_sharded,
)
from islands_tpu_torch.testing import graph_invariants, host_merge
from islands_tpu_torch.utils.tracing import metrics, span

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, the
# non-tensor-core float32 rate and the dense TF32 and bfloat16 tensor-core
# rates, used for a kernel's bound and the encoder's share of the peak. A
# shared-memory lookup runs at 32 per SM per clock (one 4-byte word per
# bank).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_TC_OPS_PER_S = 494.7e12
BF16_TC_OPS_PER_S = 989e12
SMEM_LOOKUPS_PER_SM_CLOCK = 32

# Each kernel: its wrapper (whose `launches` counts launches), source, the
# TPU kernel it replaces and the CUDA kernel's name in the profiler (K1's
# timed shapes take its warp route). K4a and K4b are two modes of one source,
# K3's "sums" and "smallest" two routes of one. V1 (varlen attention) is
# Triton, built at its first launch, and replaces no TPU kernel; its name
# also prefixes its k rotation's, `varlen_attn_rope_k`. M1 (the experts)
# replaces none either: its wrapper counts its three Triton passes, whose
# names begin with "moe_gemm"; its products are torch._grouped_mm's.
KERNELS = {
    "hop_merge": (hop_merge, "islands_tpu_torch/csrc/hop_merge.cu",
                  "islands_tpu/ops/pallas_kernels.py:412", "hop_merge_warp_kernel"),
    "gated_adc": (gated_adc_sums, "islands_tpu_torch/csrc/gated_adc.cu",
                  "islands_tpu/ops/pallas_kernels.py:135", "gated_adc_kernel"),
    "adc_scan": (adc_scan, "islands_tpu_torch/csrc/adc_scan.cu",
                 "islands_tpu/ops/pallas_kernels.py:52", "adc_scan_kernel"),
    "adc_scan_smallest": (adc_scan_smallest, "islands_tpu_torch/csrc/adc_scan.cu",
                          "islands_tpu/ops/pallas_kernels.py:52", "adc_scan_smallest_kernel"),
    "pairwise_l2": (pairwise_l2, "islands_tpu_torch/csrc/pairwise.cu",
                    "islands_tpu/ops/pallas_kernels.py:248", "pairwise_kernel<0>"),
    "pairwise_neg_dot": (pairwise_neg_dot, "islands_tpu_torch/csrc/pairwise.cu",
                         "islands_tpu/ops/pallas_kernels.py:262", "pairwise_kernel<2>"),
    "row_gather": (row_gather, "islands_tpu_torch/csrc/row_gather.cu",
                   "benches/gather_bench.py:71", "row_gather_kernel"),
    "varlen_attention": (va.varlen_attention, "islands_tpu_torch/ops/varlen_attention.py",
                         "none", "varlen_attn"),
    "moe_gemm": (moe.moe_gemm, "islands_tpu_torch/ops/moe.py", "none", "moe_gemm"),
}
SOURCES = sorted({pathlib.Path(src).stem for _, src, _, _ in KERNELS.values()
                  if src.endswith(".cu")})

# bench.py's five primary rungs: (ef, promote, max_iters, expand_width,
# final_rescore).
RUNGS = [(32, 8, 12, 2, 64), (32, 16, 12, 2, 64), (32, 24, 12, 2, 64),
         (32, 48, 10, 2, 0), (32, 64, 10, 4, 0)]
HEADLINE = (32, 16, 12, 2, 64)
DIM, QUERIES = 128, 4096  # bench.py's width and query batch
C2_CONFIG = LeannConfig(metric=DistanceMetric.EUCLIDEAN, wave_size=4096, sketch_dims=48,
                        ef_construction=64, reverse_slack=20)  # bench.py's
QPS_PASSES = 5
MIN_HEADLINE_RECALL = 0.90

# Config 4 (bench_extra.py:222-348): 1M x 768, 16 x 256 PQ, 4096 queries,
# and the first four rungs of its ladder (bench_extra.py:287-290) as
# (ef, max_iters, expand_width, promote_width, final_rescore); the first
# rung at recall@10 >= 0.90 is reported.
C4_N, C4_DIM, C4_QUERIES = 1_000_000, 768, 4096
C4_PQ = PQConfig(num_subquantizers=16, num_centroids=256, training_iterations=15, seed=0)
C4_RUNGS = [(128, 16, 2, 16, 64), (128, 14, 2, 24, 64), (128, 18, 2, 16, 64),
            (128, 20, 2, None, 0)]
C4_ROUTING = 65536
# search_pq_scan's reranks: 128 and 256 take K3's "smallest" route, 2048
# (past SMALLEST_MAX_R) the "sums" route and smallest_k.
PQ_SCAN_QUERIES, PQ_SCAN_RERANKS = 512, (128, 256, 2048)
AB_QUERIES = 512  # queries for the grouped/einsum and fused/inline checks

# K4's shapes (B, N, d): brute_force_topk's chunks at configs 2 and 4, the
# reference's own timing shape (pallas_kernels.py:313-315), the reference
# vector-ops bench's widths (benches/vector_ops_bench.py:36-53), ragged and
# empty edges. The first two are timed.
PAIRWISE_SHAPES = [(4096, 65536, 128), (4096, 65536, 768), (512, 20000, 128),
                   (1000, 10000, 32), (1000, 10000, 512), (1000, 10000, 1024),
                   (5, 7, 8), (33, 70, 7), (0, 7, 16), (5, 0, 16)]
PAIRWISE_TIMED = PAIRWISE_SHAPES[:2]
PAIRWISE_MODES = ("l2", "l2_squared", "neg_dot")
# K5's shapes: the gather bench's corpus and gather sizes, and a ragged K.
GATHER_N, GATHER_D, GATHER_KS, GATHER_TIMED = 1_000_000, 128, (131072, 1048576, 1000), (131072,
                                                                                         1048576)
# V1's shapes: a mbcode16k recompute hop, 32 chunks drawn (seed 0) from the
# cell's log-uniform length law on [128, 2,048] (16,384 rows), at
# modernbert-base's 12 heads of 64 in bf16; a local layer keeps +/- 64 keys.
# Each segment's output within VARLEN_REL_ERR of the plain version's, by
# norm (tests/test_torch_varlen_cuda.py gives the reason).
VARLEN_ROWS, VARLEN_HEADS, VARLEN_DIM, VARLEN_WINDOW = 32, 12, 64, 64
VARLEN_LAW = (16384, 128, 2048)
VARLEN_REL_ERR = 5e-3
# V1's causal grouped-query mode at Mellum's widths: 32 chunks of the
# mellum8k law (log-uniform on [48, 192], seed 3), 32 query and 4 key heads
# of 128, each sliding layer's window 1,024 and the full layers' YaRN.
GQA_ROWS, GQA_HEADS, GQA_KV_HEADS, GQA_DIM = 32, 32, 4, 128
GQA_LAW = (8192, 48, 192)
# M1 at Mellum's widths (hidden, expert width, experts, top k): a recompute
# hop's tokens and the build's packed chunk; each token's output within
# MOE_REL_ERR of the plain version's by norm (tests/test_torch_cuda.py's
# test_moe_gemm_matches_plain_version gives the reason).
MOE_WIDTHS = (2304, 896, 64, 8)
MOE_TOKENS = (3300, 32768)
MOE_REL_ERR = 4e-3

# Phase 6: the prefix built before one 65,536-row re-index, the searches
# run on the loaded and the in-memory index, and phase 3's headline knobs.
LIFE_REINDEX = 65536
LIFE_SEARCHES = [("none/ef64", dict(gate="none", ef=64)),
                 ("none/ef128", dict(gate="none", ef=128)),
                 ("sketch/ef32/p16/i12/x2", dict(gate="sketch", ef=32, promote_width=16,
                                                 max_iters=12, expand_width=2))]
HNSW_EFS = (64, 128)
HNSW_N = 262144  # phase 7 runs on the first rows of phase 3's corpus (a depth cut)
SEARCHER_QUERIES = 64

# Config 3 (bench_extra.py:114-219), nothing cut: 131,072 chunks of 64
# token ids, minilm-l6 in bfloat16, the centred provider, and its rungs as
# (name, gate, query batch, queries, ef, promote_width, max_iters). The i30
# rung is printed below its margin and not gated.
C3_N, C3_L, C3_QUERIES = 131072, 64, 256
C3_CONFIG = LeannConfig(metric=DistanceMetric.COSINE, wave_size=4096, sketch_query=True,
                        sketch_dims=32, routing_size=16384)
C3_RUNGS = [("gated i36", "sketch", 64, 256, 48, 32, 36),
            ("gated i33", "sketch", 64, 256, 48, 32, 33),
            ("gated i30 (below margin)", "sketch", 64, 256, 48, 32, 30),
            ("per-hop", "none", 16, 32, 64, None, None)]
C3_MIN_RECALL = {"gated i36": 0.90, "per-hop": 0.98}
C3_QPS_PASSES = 3
ENCODER_BATCH = 2048  # rows per encoder call when the encoder is timed alone
ENCODER_CALL_ROWS = (512, 1024, 4096, 8192)  # and the other call sizes timed
# Config 1 (bench_extra.py:53-111): the running tree's own source, chunked
# 512/64, bge-base, its queries the first min(256, n) chunks.
C1_EXTS = ("py", "md", "cpp", "toml", "yaml")
C1_CONFIG = LeannConfig(metric=DistanceMetric.COSINE, wave_size=1024, sketch_query=True)
C1_QUERIES, C1_BATCH, C1_EF, C1_PAD = 128, 32, 96, 128  # queries cut from 256
C1_QPS_PASSES = 2
C1_MIN_RECALL = 0.90
# Config 5 (BASELINE.json config 5; benches/sharded_chip.py:40-41): the
# archipelago over phase 3's corpus, cut from 10M on 8 chips to 1M as 2
# shards on the one card: built on the first 934,464 rows, then one
# 65,536-row re-index (extend_sharded), so global ids equal row ids. Rungs
# (name, gate, knobs): the sketch gate p16 and p48 with the fused hop-merge
# (kernel K1), and the routed exact gate.
C5_SHARDS, C5_REINDEX = 2, 65536
C5_CONFIG = dataclasses.replace(C2_CONFIG, routing_size=65536)
C5_RUNGS = [("p16", dict(gate="sketch", ef=32, promote_width=16, max_iters=12, expand_width=2,
                         final_rescore=64, hop_merge="fused")),
            ("p48", dict(gate="sketch", ef=32, promote_width=48, max_iters=10, expand_width=2,
                         final_rescore=0, hop_merge="fused")),
            ("exact ef64/i24", dict(gate="exact", ef=64, max_iters=24))]
C5_MIN_RECALL = {"p16": 0.90, "exact ef64/i24": 0.90}
# Refine (phase 10b): the first 131,072 rows, phase 3's LeannConfig with
# refine_passes 0 and 1; the refined graph may lose at most 0.02 of
# recall@10 at any of the points: the exact gate at ef 64, where the
# unrefined graph is near 1, and the lowest ef and config 5's p16 rung,
# where a graph's quality shows.
REFINE_N, REFINE_MAX_LOSS = 131072, 0.02
REFINE_POINTS = [("exact ef64", dict(gate="exact", ef=64)),
                 ("exact ef10", dict(gate="exact", ef=10)),
                 ("p16", dict(C5_RUNGS[0][1]))]
# The service (phase 11): minilm-l6 over the checkout, 16 text queries.
SERVICE_QUERIES = [
    "sharded archipelago merge of per-shard top-k", "hop merge kernel warp per query",
    "product quantizer codebook training", "brute force ground truth top-k",
    "save index to disk and load it back", "extend the graph with new vectors",
    "sketch gated search with promote width", "encoder layer norm in bfloat16",
    "git clone and fetch a repository", "webhook push event triggers sync",
    "chunk files with overlap", "routing entries from the sketch",
    "pairwise distance tiles on tensor cores", "refine pass re-selects rows",
    "row gather benchmark", "recompute embeddings during search"]
# Phase 12, the CLI. 12a: `build --pq` (16 x 256, config 4's width) on the
# first 131,072 rows of phase 4's 1M x 768 corpus (a depth cut for the time
# limit: at 262,144 rows phase 12 took 99 s on an H100 80GB HBM3 at 700 W)
# and its 4,096 queries, then `query` and `eval` at the CLI's default knobs
# and at config 4's first rung where the CLI has the flag; each as (name,
# flags, the same knobs as search_two_level's keywords). The CLI's build sets m0 = 2 * --m = 60 and
# search keeps expand_width 4, so kernel K2 scores E = 240 neighbours a hop.
# 12b-c: the repository commands and the MCP server over a minilm-l6
# service; the queries are the service's first.
CLI_N = 131072
CLI_E = 240
CLI_BUILD_FLAGS = ["--metric", "euclidean", "--pq", "--pq-subquantizers", "16"]
CLI_KNOBS = [("defaults", [], dict(ef=64)),
             ("config 4's first rung", ["--ef", "128", "--max-iters", "16",
                                        "--promote-width", "16"],
              dict(ef=128, max_iters=16, promote_width=16))]
CLI_QUERIES = SERVICE_QUERIES[:4]
MCP_TIMEOUT_S = 300
SPAN_DELAY_CYCLES = 4_000_000  # about 2 ms of device time queued before the launch

# Phase 13, ModernBERT at modernbert-base's published width (22 layers,
# hidden 768, 12 heads, GeGLU intermediate 1152, a window of 128 with every
# third layer global, RoPE theta 160,000 global / 10,000 local), random-init
# from seed 0. 13a: the encoder bench's two modes; the card's encode against
# the CPU's float32 forward on MB_CHECK_ROWS rows at seq 256 drawn as the bench
# draws them, every other row padded; one encode at the recompute provider's
# chunk (4,096 rows at config 1's 128 tokens): its attention kernels and the
# memory it adds. 13b: config 1 with modernbert-base in place of bge-base,
# phase 9's 128 queries, one timed pass and no CPU check (13a's holds the
# encoder). On the padded forward the queries were cut to 32 for the time
# limit; at 32 the first queries of today's larger checkout read recall@10
# .8812 on the padded route and .8875 on the packed one, at 128 .9430 and
# .9477 (H100 80GB HBM3, 700 W), and the packed route runs 1.8x the
# queries a second. 13c: the
# service configured by Config(embedding_model="modernbert-base") over one
# package directory of the checkout (a depth cut), stored and recompute.
MB_PRESET = "modernbert-base"
MB_CHECK_ROWS, MB_CHECK_SEQ = 16, 256
MB_C1_QUERIES, MB_C1_PASSES = C1_QUERIES, 1
MB_SERVICE_DIR = "islands_tpu_torch/core"

# The card's bfloat16 encode against the port's float32 forward on the CPU:
# the smallest per-row cosine of the pooled rows, raw and after both sides
# subtract the CPU rows' mean (random-init embeddings share a dominant
# direction that would hide a fault in the raw cosine).
ENCODER_MIN_COS, ENCODER_MIN_CENTRED_COS = 0.999, 0.99

# smallest_k's row shapes on the paths, (rows, width, k): _pop over the
# config-2 and config-4 queues, the build's pools and [W, W] intra-wave
# matrix, brute_force_topk's [best ++ 65,536-row chunk], the PQ scan's
# full-corpus rows; and widths between, to place the crossover.
TOPK_SHAPES = [(4096, 64, 2), (4096, 128, 2), (4096, 512, 128), (4096, 1024, 10),
               (4096, 2048, 10), (4096, 4096, 60), (4096, 4097, 10), (4096, 8192, 10), (4096, 16384, 10),
               (4096, 65546, 10), (512, 1_000_000, 128), (512, 1_000_000, 256)]


def log(msg: str) -> None:
    print(msg, flush=True)


def zero_launches() -> None:
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: wrapper.launches for name, (wrapper, *_) in KERNELS.items()}


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    """The first card's `nvidia-smi --query-gpu` line."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
                         check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events, after
    two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_events(fn, reps: int) -> list:
    """torch.profiler's device kernels over `reps` calls of fn, after one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def kernel_device_ms(fn, kernel: str, reps: int) -> float:
    """Mean device time per launch of the CUDA kernel whose name contains
    `kernel`, over `reps` calls of fn, from torch.profiler. Raises if the
    profiler saw no such kernel."""
    hits = [e for e in _device_events(fn, reps) if kernel in e.key]
    count = sum(e.count for e in hits)
    if count == 0:
        raise AssertionError(f"the profiler saw no launch of {kernel}")
    return sum(e.self_device_time_total for e in hits) / count / 1e3


def call_device_ms(fn, kernel: str, reps: int) -> tuple[float, float]:
    """Device time per call of fn, all its kernels together, and that of the
    kernels whose name contains `kernel`, from torch.profiler."""
    events = _device_events(fn, reps)
    hits = [e for e in events if kernel in e.key]
    if not hits:
        raise AssertionError(f"the profiler saw no launch of {kernel}")
    return (sum(e.self_device_time_total for e in events) / reps / 1e3,
            sum(e.self_device_time_total for e in hits) / reps / 1e3)


def hop_merge_inputs(gen, b, e, a, ties):
    """Discoveries and queue shaped as the gated loop hands them to K1:
    +inf invalid slots, duplicated ids sharing a distance, an ascending
    queue with a +inf tail."""
    dev = "cuda"
    if ties:
        nd = torch.randint(0, 4, (b, e), generator=gen, device=dev).float() / 4
    else:
        nd = torch.rand((b, e), generator=gen, device=dev)
    ni = torch.randint(0, 1 << 20, (b, e), generator=gen, device=dev, dtype=torch.int32)
    ni[:, 1::7] = ni[:, 0:1]
    nd[:, 1::7] = nd[:, 0:1]
    invalid = torch.rand((b, e), generator=gen, device=dev) < 0.25
    nd = torch.where(invalid, float("inf"), nd)
    ni = torch.where(invalid, 1 << 20, ni)
    if ties:
        aq = torch.randint(0, 4, (b, a), generator=gen, device=dev).float() / 4
    else:
        aq = torch.rand((b, a), generator=gen, device=dev)
    aqd = torch.sort(aq, dim=1).values
    aqd[:, a // 2 + 1:] = float("inf")
    aqi = torch.where(torch.isinf(aqd), -1,
                      (1 << 20) + 1 + torch.arange(a, device=dev, dtype=torch.int32)[None, :])
    return nd.contiguous(), ni.contiguous(), aqd.contiguous(), aqi.to(torch.int32).contiguous()


def hop_merge_bound_ms(b, e, a, pw) -> float:
    """Least time for K1's work: each input read once, each output written
    once, over HBM; the compare-exchanges over the f32 rate. The larger."""
    ep = 1 << max(e - 1, 0).bit_length()
    L = 1 << (a + e - 1).bit_length()
    lg_ep, lg_l = ep.bit_length() - 1, L.bit_length() - 1
    exchanges = b * (2 * (ep // 2) * lg_ep * (lg_ep + 1) // 2 + (L // 2) * lg_l)
    bytes_moved = b * ((e + a) * 8 + (pw + a) * 8)
    return max(bytes_moved / HBM_BYTES_PER_S, exchanges / F32_OPS_PER_S) * 1e3


def phase_hop_merge() -> dict:
    """K1 against its plain version at both gated paths' shapes, exactly:
    config 2 (A = 64) and the two-level hop of config 4 (A = 128) on the
    warp route, and one shape past it (E = 300) on the block route."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b = 4096
    max_err = 0.0
    for e, a, pw, ties in [(120, 64, 8, False), (120, 64, 16, False), (120, 64, 24, False),
                           (120, 64, 48, False), (240, 64, 64, False), (120, 64, 16, True),
                           (240, 64, 64, True), (120, 128, 16, False), (120, 128, 24, False),
                           (120, 128, 32, False), (120, 128, 16, True), (120, 128, 24, True),
                           (120, 128, 32, True), (300, 64, 16, True)]:
        args = hop_merge_inputs(gen, b, e, a, ties)
        got = hop_merge(*args, pw)
        want = hop_merge_reference(*args, pw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"hop_merge differs from its plain version at "
                                     f"E={e} A={a} pw={pw} ties={ties}")
        fin = torch.isfinite(want[0])
        if fin.any():
            max_err = max(max_err, float((got[0][fin] - want[0][fin]).abs().max()))
        log(f"  hop_merge == plain version at B={b} E={e} A={a} pw={pw} ties={ties}")
    out = dict(max_abs_err=max_err)
    for a, key in ((64, ""), (128, "_two_level")):
        e, pw = 120, 16
        args = hop_merge_inputs(gen, b, e, a, False)
        event_ms = time_ms(lambda: hop_merge(*args, pw), 200)
        ms = kernel_device_ms(lambda: hop_merge(*args, pw), KERNELS["hop_merge"][3], 200)
        plain_ms = time_ms(lambda: hop_merge_reference(*args, pw), 20)
        bound = hop_merge_bound_ms(b, e, a, pw)
        log(f"  hop_merge B={b} E={e} A={a} pw={pw}: kernel {ms:.4f} ms on the device "
            f"({event_ms:.4f} ms per wrapper call by CUDA events), plain "
            f"{plain_ms:.4f} ms, bound {bound:.5f} ms (bytes), library: none")
        out.update({f"ms{key}": ms, f"event_ms{key}": event_ms,
                    f"plain_ms{key}": plain_ms, f"bound_ms{key}": bound})
    return dict(out, bound_by="bytes", library_ms=None)


def adc_inputs(gen, b, s, k, rows, dtype=torch.uint8):
    """Tables [B, S, K] f32 and codes [*rows, S] of `dtype` on the card,
    with the codes 0 and K-1 present."""
    tables = torch.randn((b, s, k), generator=gen, device="cuda")
    codes = torch.randint(0, k, (*rows, s), generator=gen, device="cuda",
                          dtype=torch.int32).to(dtype)
    flat = codes.view(-1, s)
    flat[0] = 0
    flat[1] = k - 1
    return tables, codes


def gated_adc_bound_ms(b, e, s, k) -> tuple[float, str]:
    """K2's least time: tables, codes and output over HBM against its f32
    adds over the f32 rate; the larger, and which."""
    bytes_ms = (b * s * k * 4 + b * e * s + b * e * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = b * e * s / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def adc_scan_bound_ms(b, n, s, k, sms, clock_hz) -> tuple[float, str]:
    """K3's least time: tables, codes and output over HBM against its
    B*N*S shared-memory lookups at 32 per SM per clock; the larger, and which."""
    bytes_ms = (b * s * k * 4 + n * s + b * n * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = b * n * s / (SMEM_LOOKUPS_PER_SM_CLOCK * sms * clock_hz) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def gated_adc_library(tables, codes):
    """One PyTorch call computing K2's function: embedding_bag(mode="sum")
    over the bf16-rounded tables as one column, with each code offset to its
    (query, subspace) row. Indices and weight are built here, beforehand."""
    b, s, k = tables.shape
    e = codes.shape[1]
    weight = tables.to(torch.bfloat16).float().reshape(-1, 1)
    dev = tables.device
    offs = (torch.arange(b, device=dev)[:, None, None] * s
            + torch.arange(s, device=dev)[None, None, :]) * k
    idx = (codes.long() + offs).reshape(b * e, s)
    return lambda: F.embedding_bag(idx, weight, mode="sum").view(b, e)


def adc_scan_library(tables, codes):
    """One PyTorch call computing K3's function (transposed): embedding_bag
    over the tables as [S*K, B] rows, codes offset by s*K, giving out.T."""
    b, s, k = tables.shape
    weight = tables.reshape(b, s * k).T.contiguous()
    idx = codes.long() + torch.arange(s, device=tables.device)[None, :] * k
    return lambda: F.embedding_bag(idx, weight, mode="sum")


def check_adc(name, fn, plain, cases) -> float:
    """fn == plain bit for bit on every case; returns the largest |diff| (0)."""
    max_err = 0.0
    for desc, (tables, codes) in cases:
        got, want = fn(tables, codes), plain(tables, codes)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its plain version at {desc}")
        max_err = max(max_err, float((got - want).abs().max()) if got.numel() else 0.0)
        log(f"  {name} == plain version at {desc}")
    return max_err


def phase_adc(sms: int, clock_hz: float) -> tuple[dict, dict]:
    """K2 and K3 against their plain versions at config 4's shapes, the CLI
    path's (K2 at E = 240) and odd ones, bit for bit; then their times
    beside bound, plain and library, K2's at both E."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    k2_cases = [(f"B={b} E={e} S={s} K={k}", adc_inputs(gen, b, s, k, (b, e)))
                for b, e, s, k in [(4096, 120, 16, 256), (4096, CLI_E, 16, 256),
                                   (24, 70, 8, 64)]]
    k3_cases = [(f"B={b} N={n} S={s} K={k} {dt}", adc_inputs(gen, b, s, k, (n,), dt))
                for b, n, s, k, dt in [(512, 1_000_000, 16, 256, torch.uint8),
                                       (3, 1000, 8, 32, torch.uint8),
                                       (5, 4099, 16, 512, torch.int32)]]
    k2_err = check_adc("gated_adc", gated_adc_sums, gated_adc_reference, k2_cases)
    k3_err = check_adc("adc_scan", adc_scan, adc_scan_reference, k3_cases)
    del k2_cases[2:], k3_cases[1:]

    out = []
    for name, fn, plain, library, kernel, (desc, (tables, codes)), err, bound in [
            ("gated_adc", gated_adc_sums, gated_adc_reference, gated_adc_library,
             "gated_adc_kernel", k2_cases[0], k2_err,
             gated_adc_bound_ms(4096, 120, 16, 256)),
            ("gated_adc", gated_adc_sums, gated_adc_reference, gated_adc_library,
             "gated_adc_kernel", k2_cases[1], k2_err,
             gated_adc_bound_ms(4096, CLI_E, 16, 256)),
            ("adc_scan", adc_scan, adc_scan_reference, adc_scan_library,
             "adc_scan_kernel", k3_cases[0], k3_err,
             adc_scan_bound_ms(512, 1_000_000, 16, 256, sms, clock_hz))]:
        reps = 200 if name == "gated_adc" else 20
        event_ms = time_ms(lambda: fn(tables, codes), reps)
        ms = kernel_device_ms(lambda: fn(tables, codes), kernel, reps)
        plain_ms = time_ms(lambda: plain(tables, codes), 5)
        lib = library(tables, codes)
        lib_out = lib()
        want = plain(tables, codes)
        lib_err = float(((lib_out.T if name == "adc_scan" else lib_out) - want).abs().max())
        if lib_err > 1e-4:
            raise AssertionError(f"{name}'s library yardstick computes another function "
                                 f"(max |diff| {lib_err})")
        del lib_out, want
        library_ms = time_ms(lib, reps)
        log(f"  {name} {desc}: kernel {ms:.4f} ms on the device ({event_ms:.4f} ms per "
            f"wrapper call by CUDA events), plain {plain_ms:.4f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]}), library embedding_bag {library_ms:.4f} ms "
            f"(max |diff| to plain {lib_err:.2e})")
        out.append(dict(max_abs_err=err, ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                        bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms,
                        library="torch.nn.functional.embedding_bag(mode='sum')"))
    # K2's row keeps config 4's E = 120 figures; the CLI path's E = 240 ones
    # sit beside them with the suffix _cli.
    k2 = dict(out[0], **{f"{key}_cli": out[1][key] for key in
                         ("ms", "event_ms", "plain_ms", "bound_ms", "library_ms")},
              e=120, e_cli=CLI_E)
    return k2, out[2]


# K3 "smallest" against its plain version, (B, N, S, K, code type, r,
# metric, tables): the PQ scan's shape at rerank 128 and 256, N below one
# tile of the kernel, r = N, B = 4096, int32 codes at K = 512, S = 8, each
# metric, both sides of SMALLEST_MAX_R (r past it takes the "sums" route).
# Tables as smallest_inputs makes them: the euclidean cases take
# non-negative ones, as PQ's squared-distance tables are, but for one
# "tied" case whose negative sums exercise the clamp.
SMALLEST_CASES = [
    (512, 1_000_000, 16, 256, torch.uint8, 256, "euclidean", "square"),
    (512, 1_000_000, 16, 256, torch.uint8, 128, "euclidean", "tied+"),
    (7, 5000, 16, 256, torch.uint8, 100, "cosine", "tied"),
    (3, 700, 16, 256, torch.uint8, 700, "dotproduct", "tied"),
    (4096, 65536, 16, 256, torch.uint8, 256, "euclidean", "square"),
    (33, 40000, 16, 512, torch.int32, 64, "manhattan", "tied"),
    (9, 20000, 8, 256, torch.uint8, 200, "euclidean", "tied"),
    (9, 20000, 8, 256, torch.uint8, 200, "euclidean", "tied+"),
    (6, 33000, 16, 256, torch.uint8, 300, "cosine", "normal"),
    (6, 33000, 16, 256, torch.uint8, 300, "dotproduct", "tied"),
    (6, 33000, 16, 256, torch.uint8, 300, "manhattan", "normal"),
    (17, 50000, 16, 256, torch.uint8, SMALLEST_MAX_R, "euclidean", "tied+"),
    (17, 50000, 16, 256, torch.uint8, SMALLEST_MAX_R + 1, "euclidean", "tied+"),
]


def smallest_inputs(gen, b, s, k, n, dtype, kind):
    """Tables [B, S, K] and codes [N, S] on the card for K3's "smallest"
    route. "normal": adc_inputs' randn tables; "square": their squares,
    non-negative as PQ's squared-distance tables are, so euclidean distances
    are positive and ordered; "tied" and "tied+": multiples of 1/4 in [-2, 2)
    and [0, 2) holding -0.0 beside +0.0 (many equal distances), with codes in
    which every seventh row repeats a random row: equal keys but for the id,
    inside and across the kernel's tiles."""
    if kind in ("normal", "square"):
        tables, codes = adc_inputs(gen, b, s, k, (n,), dtype)
        return (tables * tables if kind == "square" else tables), codes
    dev = "cuda"
    low = -8 if kind == "tied" else 0
    tables = torch.randint(low, 8, (b, s, k), generator=gen, device=dev).float() / 4
    neg = (tables == 0) & (torch.rand((b, s, k), generator=gen, device=dev) < 0.5)
    tables = torch.where(neg, -0.0, tables)
    codes = torch.randint(0, k, (n, s), generator=gen, device=dev, dtype=torch.int32).to(dtype)
    dup = codes[::7].shape[0]
    codes[::7] = codes[torch.randint(0, n, (dup,), generator=gen, device=dev)]
    return tables, codes


def smallest_err(tables, codes, got, want, metric) -> float:
    """The largest |d[got] - d[want]| over the rows of positions got and
    want, d being the plain finalised distances: 0 when the two select
    equally far candidates."""
    if not got.numel():
        return 0.0
    d = finalize_adc(adc_scan_reference(tables, codes), metric)
    return float((d.gather(1, got) - d.gather(1, want)).abs().max())


def adc_scan_smallest_bound_ms(b, n, s, k, r, sms, clock_hz) -> tuple[float, str]:
    """K3 "smallest"'s least time: its B*N*S lookups (as adc_scan_bound_ms)
    against the tables, codes, the tiles' key lists and the positions over
    HBM; the larger, and which."""
    lists = b * smallest_tiles(b, n, s, k, r) * r * 8
    bytes_ms = (b * s * k * 4 + n * s + lists + b * r * 8) / HBM_BYTES_PER_S * 1e3
    ops_ms = b * n * s / (SMEM_LOOKUPS_PER_SM_CLOCK * sms * clock_hz) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def smallest_chain(tables, codes, r, metric):
    """What K3 "smallest" replaces: K3 "sums", the finalise and smallest_k."""
    return merge.smallest_k(finalize_adc(adc_scan(tables, codes), metric), r)


def phase_adc_smallest(sms: int, clock_hz: float) -> dict:
    """K3's "smallest" route against its plain version, bit for bit (the same
    positions in the same order) at SMALLEST_CASES, with the route each case
    launched; then its device time at the PQ scan's shape, merge included,
    beside its bound, its plain version and the chain it replaces."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    max_err = 0.0
    for b, n, s, k, dt, r, metric, kind in SMALLEST_CASES:
        tables, codes = smallest_inputs(gen, b, s, k, n, dt, kind)
        before = adc_scan_smallest.launches
        got = adc_scan_smallest(tables, codes, r, metric)
        want = adc_scan_smallest_reference(tables, codes, r, metric)
        torch.cuda.synchronize()
        route = "smallest" if adc_scan_smallest.launches > before else "sums"
        desc = f"B={b} N={n} S={s} K={k} {dt} r={r} {metric} {kind}"
        if route != ("smallest" if r <= SMALLEST_MAX_R else "sums"):
            raise AssertionError(f"adc_scan_smallest took the {route} route at {desc}")
        if not torch.equal(got, want):
            raise AssertionError(f"adc_scan_smallest differs from its plain version at {desc}")
        max_err = max(max_err, smallest_err(tables, codes, got, want, metric))
        log(f"  adc_scan_smallest == plain version at {desc} ({route} route)")
        del tables, codes, got, want
    if smallest_max_r() != SMALLEST_MAX_R:
        raise AssertionError(f"the kernel's largest r is {smallest_max_r()}, not {SMALLEST_MAX_R}")
    b, n, s, k = 512, 1_000_000, 16, 256
    tables, codes = smallest_inputs(gen, b, s, k, n, torch.uint8, "square")
    timings = []
    for r in PQ_SCAN_RERANKS[:2]:
        def fn():
            return adc_scan_smallest(tables, codes, r, "euclidean")

        def chain():
            return smallest_chain(tables, codes, r, "euclidean")

        got, want = fn(), chain()
        if not torch.equal(got, want):
            raise AssertionError(f"adc_scan_smallest differs from the chain at r={r}")
        max_err = max(max_err, smallest_err(tables, codes, got, want, "euclidean"))
        del got, want
        event_ms = time_ms(fn, 20)
        ms, kernel_ms = call_device_ms(fn, KERNELS["adc_scan_smallest"][3], 20)
        chain_ms = time_ms(chain, 5)
        chain_device_ms, _ = call_device_ms(chain, KERNELS["adc_scan"][3], 5)
        plain_ms = time_ms(lambda: adc_scan_smallest_reference(tables, codes, r, "euclidean"), 2)
        bound = adc_scan_smallest_bound_ms(b, n, s, k, r, sms, clock_hz)
        log(f"  adc_scan_smallest B={b} N={n} S={s} K={k} r={r} (squared randn tables): "
            f"{ms:.4f} ms on the device (kernel {kernel_ms:.4f}, merge {ms - kernel_ms:.4f}; "
            f"{event_ms:.4f} ms per wrapper call by CUDA events), plain {plain_ms:.4f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]}), the chain it replaces {chain_device_ms:.4f} ms on "
            f"the device ({chain_device_ms / ms:.2f}x) and {chain_ms:.4f} ms by CUDA events "
            f"({chain_ms / event_ms:.2f}x), library: none")
        timings.append(dict(r=r, ms=ms, kernel_ms=kernel_ms, merge_ms=ms - kernel_ms,
                            event_ms=event_ms, plain_ms=plain_ms, chain_ms=chain_ms,
                            chain_device_ms=chain_device_ms, bound_ms=bound[0],
                            bound_by=bound[1]))
    t = timings[-1]
    return dict(max_abs_err=max_err, ms=t["ms"], kernel_ms=t["kernel_ms"],
                merge_ms=t["merge_ms"], event_ms=t["event_ms"], plain_ms=t["plain_ms"],
                chain_ms=t["chain_ms"], chain_device_ms=t["chain_device_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
                library="none: no single PyTorch call computes it",
                shape=[b, n, s, k, t["r"]], timings=timings)


def phase_smallest_k() -> list:
    """smallest_k's two routes on the same int32 keys at TOPK_SHAPES: equal
    positions (ties included), and the time of each by CUDA events."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for rows, width, k in TOPK_SHAPES:
        # Distances on a 1/1024 grid, so rows hold ties.
        x = torch.randint(0, 1024, (rows, width), generator=gen, device="cuda").float() / 1024
        key = merge.sort_key(x)
        if not torch.equal(merge._smallest_k_sort(key, k), merge._smallest_k_topk(key, k)):
            raise AssertionError(f"smallest_k's routes disagree at [{rows}, {width}], k={k}")
        reps = 5 if width > 100_000 else 20
        sort_ms = time_ms(lambda: merge._smallest_k_sort(key, k), reps)
        topk_ms = time_ms(lambda: merge._smallest_k_topk(key, k), reps)
        route = "sort" if width <= merge.SORT_MAX_WIDTH else "top-k"
        log(f"  smallest_k [{rows}, {width}] k={k}: sort {sort_ms:.4f} ms, top-k "
            f"{topk_ms:.4f} ms; routed to {route}")
        out.append(dict(rows=rows, width=width, k=k, sort_ms=sort_ms, topk_ms=topk_ms,
                        route=route))
        del x, key
    return out


def pairwise_bound_ms(b, n, d) -> tuple[float, str]:
    """K4's least time for float32-accurate work on the tensor cores: three
    TF32 products (3xTF32), 6*B*N*d flops at the dense TF32 rate, against
    q, x and the output over HBM; the larger, and which."""
    ops_ms = 6 * b * n * d / TF32_TC_OPS_PER_S * 1e3
    bytes_ms = (b * d + n * d + b * n) * 4 / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def pairwise_simt_bound_ms(b, n, d) -> float:
    """The same work on the CUDA cores: 2*B*N*d flops at the f32 rate, or
    the bytes; the larger (K4's bound before it used the tensor cores)."""
    return max(2 * b * n * d / F32_OPS_PER_S,
               (b * d + n * d + b * n) * 4 / HBM_BYTES_PER_S) * 1e3


def assert_pairwise_close(got, want, q, x, mode, what) -> float:
    """K4 against its plain version: the two sum in different orders, so the
    squared form is held within 1e-5 * (|q|^2 + |x|^2), the sqrt form within
    the square root of that bound (|sqrt(a) - sqrt(b)| <= sqrt(|a - b|): no
    relative error near 0), neg-dot within 1e-5 * |q| * |x|; l2 outputs must
    be >= 0. Returns the largest |got - want|."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    qn = torch.sum(q.double() * q.double(), dim=1).float()
    xn = torch.sum(x.double() * x.double(), dim=1).float()
    if mode == "neg_dot":
        tol = 1e-5 * torch.sqrt(qn)[:, None] * torch.sqrt(xn)[None, :]
    else:
        tol = 1e-5 * (qn[:, None] + xn[None, :])
        if mode == "l2":
            tol = torch.sqrt(tol)
        if not bool((got >= 0).all()):
            raise AssertionError(f"{what}: negative distances")
    err = (got - want).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{what}: off its plain version beyond the bound "
                             f"(max |diff| {float(err.max()):.3e})")
    return float(err.max())


def _pairwise_call(mode, kernel):
    if mode == "neg_dot":
        return ((lambda q, x: pairwise_neg_dot(q, x, use_kernel=True)) if kernel
                else pairwise_neg_dot_reference)
    sq = mode == "l2_squared"
    return ((lambda q, x: pairwise_l2(q, x, squared=sq, use_kernel=True)) if kernel
            else (lambda q, x: pairwise_l2_reference(q, x, squared=sq)))


def pairwise_inputs(gen, b, n, d):
    """q [B, d], x [N, d] ~ N(0, 1) on the card, x's first rows equal to q's
    (squared distances that cancel to about 0)."""
    q = torch.randn((b, d), generator=gen, device="cuda")
    x = torch.randn((n, d), generator=gen, device="cuda")
    dup = min(b, n, 64)
    x[:dup] = q[:dup]
    return q, x


def phase_pairwise() -> tuple[dict, dict]:
    """K4a (l2, l2 squared) and K4b (neg dot) against their plain versions at
    PAIRWISE_SHAPES, in all three modes. Then times at PAIRWISE_TIMED beside bound,
    plain version and library call (torch.cdist for l2, torch.mm for the
    dot, TF32 off as ops/distance.py sets it)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    errs = {m: 0.0 for m in PAIRWISE_MODES}
    for b, n, d in PAIRWISE_SHAPES:
        q, x = pairwise_inputs(gen, b, n, d)
        for mode in PAIRWISE_MODES:
            got = _pairwise_call(mode, True)(q, x)
            want = _pairwise_call(mode, False)(q, x)
            torch.cuda.synchronize()
            errs[mode] = max(errs[mode], assert_pairwise_close(
                got, want, q, x, mode, f"pairwise {mode} at B={b} N={n} d={d}"))
            del got, want
        log(f"  pairwise l2 / l2 squared / neg dot within bound at B={b} N={n} d={d}")
        del q, x

    timings = []
    for b, n, d in PAIRWISE_TIMED:
        q, x = pairwise_inputs(gen, b, n, d)
        bound = pairwise_bound_ms(b, n, d)
        simt_bound = pairwise_simt_bound_ms(b, n, d)
        for mode, kname in (("l2", "pairwise_kernel<0>"), ("l2_squared", "pairwise_kernel<1>"),
                            ("neg_dot", "pairwise_kernel<2>")):
            fn, plain = _pairwise_call(mode, True), _pairwise_call(mode, False)
            event_ms = time_ms(lambda: fn(q, x), 10)
            ms = kernel_device_ms(lambda: fn(q, x), kname, 10)
            plain_ms = time_ms(lambda: plain(q, x), 5)
            library, lib_name = {
                "l2": (lambda: torch.cdist(q, x, compute_mode="use_mm_for_euclid_dist"),
                       "torch.cdist(compute_mode='use_mm_for_euclid_dist')"),
                "l2_squared": (None, None),
                "neg_dot": (lambda: torch.mm(q, x.T), "torch.mm(q, x.T) (the dot, unnegated)"),
            }[mode]
            library_ms = None
            if library is not None:
                lib_out = library()
                want = plain(q, x)
                if mode == "neg_dot":
                    lib_out = -lib_out
                assert_pairwise_close(lib_out, want, q, x, mode, f"library {lib_name}")
                del lib_out, want
                library_ms = time_ms(library, 10)
            log(f"  pairwise {mode} B={b} N={n} d={d}: kernel {ms:.4f} ms on the device "
                f"({event_ms:.4f} ms per wrapper call by CUDA events), plain {plain_ms:.4f} "
                f"ms, bound {bound[0]:.4f} ms ({bound[1]}; {100 * bound[0] / ms:.1f}% of it), "
                f"SIMT bound {simt_bound:.4f} ms, library "
                + (f"{lib_name} {library_ms:.4f} ms" if library_ms is not None else "none"))
            timings.append(dict(b=b, n=n, d=d, mode=mode, ms=ms, event_ms=event_ms,
                                plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                                simt_bound_ms=simt_bound, library_ms=library_ms,
                                library=lib_name))
        del q, x
    head = {m: next(t for t in timings if t["mode"] == m) for m in PAIRWISE_MODES}

    def fig(mode, others):
        t = head[mode]
        return dict(max_abs_err=max(errs[m] for m in (mode, *others)), ms=t["ms"],
                    event_ms=t["event_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], simt_bound_ms=t["simt_bound_ms"],
                    library_ms=t["library_ms"],
                    library=t["library"], shape=[t["b"], t["n"], t["d"]],
                    timings=[x for x in timings if x["mode"] in (mode, *others)])

    return fig("l2", ("l2_squared",)), fig("neg_dot", ())


def row_gather_bound_ms(k, d) -> tuple[float, str]:
    """K5's least time: K rows read and written and the ids read, over HBM."""
    return (2 * k * d * 4 + 4 * k) / HBM_BYTES_PER_S * 1e3, "bytes"


def phase_row_gather() -> dict:
    """K5 against its plain version bit for bit at the gather bench's corpus
    (N = 1,000,000, D = 128) and K in GATHER_KS, ids past both ends
    included; times at GATHER_TIMED beside bound, plain version and
    torch.index_select."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((GATHER_N, GATHER_D), generator=gen, device="cuda")
    max_err = 0.0
    for k in GATHER_KS:
        ids = torch.randint(-5, GATHER_N + 5, (k,), generator=gen, device="cuda",
                            dtype=torch.int32)
        got, want = row_gather(x, ids), row_gather_reference(x, ids)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"row_gather differs from its plain version at K={k}")
        max_err = max(max_err, float((got - want).abs().max()))
        log(f"  row_gather == plain version at N={GATHER_N} D={GATHER_D} K={k}")
    timings = []
    for k in GATHER_TIMED:
        ids = torch.randint(0, GATHER_N, (k,), generator=gen, device="cuda", dtype=torch.int32)
        bound = row_gather_bound_ms(k, GATHER_D)
        event_ms = time_ms(lambda: row_gather(x, ids), 50)
        ms = kernel_device_ms(lambda: row_gather(x, ids), "row_gather_kernel", 50)
        plain_ms = time_ms(lambda: row_gather_reference(x, ids), 50)
        library_ms = time_ms(lambda: torch.index_select(x, 0, ids), 50)
        log(f"  row_gather N={GATHER_N} D={GATHER_D} K={k}: kernel {ms:.4f} ms on the device "
            f"({event_ms:.4f} ms per wrapper call by CUDA events), plain {plain_ms:.4f} ms, "
            f"bound {bound[0]:.4f} ms (bytes), library torch.index_select {library_ms:.4f} ms")
        timings.append(dict(n=GATHER_N, d=GATHER_D, k=k, ms=ms, event_ms=event_ms,
                            plain_ms=plain_ms, bound_ms=bound[0], library_ms=library_ms))
    t = timings[0]
    return dict(max_abs_err=max_err, ms=t["ms"], event_ms=t["event_ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by="bytes", library_ms=t["library_ms"],
                library="torch.index_select(x, 0, ids)", shape=[GATHER_N, GATHER_D, t["k"]],
                timings=timings)


def segment_rel_err(got, want, lengths) -> float:
    """The largest ||got - want|| / ||want|| over packed segments."""
    worst, start = 0.0, 0
    for n in lengths:
        a, b = got[start:start + n].double(), want[start:start + n].double()
        worst = max(worst, float((a - b).norm() / b.norm()))
        start += n
    return worst


def varlen_library(q, k, v, segs, window, rope, causal=False):
    """One library call that computes V1's function: flex_attention,
    compiled, with a block mask of segment (and band, or with `causal` of
    keys at or before the query and within the window) over the packed
    tokens, key heads shared by their query heads' groups. q and k are
    rotated here, outside what is timed. -> (the call, its output
    [T, heads, d])."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    cos, sin = rope[0][segs.positions], rope[1][segs.positions]
    qr, kr = va._rotate(q, cos, sin), va._rotate(k, cos, sin)
    doc, pos = segs.segment_ids, segs.positions

    def mask_mod(b, h, qi, ki):
        keep = doc[qi] == doc[ki]
        if causal:
            keep = keep & (pos[ki] <= pos[qi])
            if window is not None:
                keep = keep & (pos[qi] - pos[ki] < window)
        elif window is not None:
            keep = keep & ((pos[qi] - pos[ki]).abs() <= window)
        return keep

    t = q.shape[0]
    mask = create_block_mask(mask_mod, None, None, t, t, device=q.device)
    fn = torch.compile(flex_attention, dynamic=False)
    args = [x.transpose(0, 1).unsqueeze(0).contiguous() for x in (qr, kr, v)]
    gqa = q.shape[1] != k.shape[1]

    def call():
        return fn(*args, block_mask=mask, enable_gqa=gqa)

    return call, call()[0].transpose(0, 1)


def phase_varlen() -> dict:
    """V1 against its plain version at a recompute hop's 32 segments of the
    mbcode16k law, global (RoPE theta 160,000) and local (+/- 64, theta
    10,000), RoPE in the kernel as the model runs it: each segment's output
    within VARLEN_REL_ERR by norm. Times: the kernel's device time per call
    (both its programs, torch.profiler) and by CUDA events, the plain
    version's, its bound (the larger of 4 x heads x d FLOPs a pair attended
    at the bf16 peak and q, k, v read and the output written once at HBM's
    rate), and flex_attention's (one compiled library call, RoPE applied
    before it)."""
    lens = np.random.default_rng(0).choice(modernbert_work.log_uniform_lengths(*VARLEN_LAW),
                                           size=VARLEN_ROWS, replace=False)
    t, h, d = int(lens.sum()), VARLEN_HEADS, VARLEN_DIM
    gen = torch.Generator(device="cuda").manual_seed(9)
    qkv = torch.randn((t, 3, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # strided, as the fused product's columns
    segs = va.Segments.from_lengths(lens, "cuda")
    kinds = []
    for kind, window, theta in (("global", None, 160000.0), ("local", VARLEN_WINDOW, 10000.0)):
        rope = tuple(torch.from_numpy(x).cuda() for x in rope_tables(VARLEN_LAW[2], d, theta))
        before = va.varlen_attention.launches
        got = va.varlen_attention(q, k, v, segs, window, rope)
        torch.cuda.synchronize()
        if va.varlen_attention.launches != before + 1:
            raise AssertionError("varlen_attention did not count its launch")
        plain = va.varlen_attention_reference(q, k, v, segs, window, rope)
        err = segment_rel_err(got, plain, lens.tolist())
        if not err < VARLEN_REL_ERR:
            raise AssertionError(f"varlen_attention ({kind}) is {err:.2e} from its plain "
                                 f"version, past {VARLEN_REL_ERR}")
        log(f"  varlen_attention ({kind}) within {err:.2e} of its plain version by segment "
            f"norm, {VARLEN_ROWS} segments, {t} tokens")

        def fn():
            return va.varlen_attention(q, k, v, segs, window, rope)

        event_ms = time_ms(fn, 50)
        _, ms = call_device_ms(fn, KERNELS["varlen_attention"][3], 50)
        plain_ms = time_ms(lambda: va.varlen_attention_reference(q, k, v, segs, window, rope), 3)
        pairs = float((lens * lens).sum() if window is None
                      else modernbert_work.band_pairs(lens, window).sum())
        flops, nbytes = 4.0 * h * d * pairs, 4.0 * t * h * d * 2
        bound = 1e3 * max(flops / BF16_TC_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
        bound_by = "operations" if flops / BF16_TC_OPS_PER_S >= nbytes / HBM_BYTES_PER_S \
            else "bytes"
        library_ms, library_err, library_note = None, None, None
        try:
            call, lib_out = varlen_library(q, k, v, segs, window, rope)
            torch.cuda.synchronize()
            library_err = segment_rel_err(lib_out, plain, lens.tolist())
            library_ms = time_ms(call, 50)
        except Exception as exc:  # the yardstick only: record why it did not run
            library_note = f"{type(exc).__name__}: {str(exc)[:200]}"
        log(f"  varlen_attention {kind} at {t} tokens: kernel {ms:.4f} ms on the device "
            f"({event_ms:.4f} ms per wrapper call by CUDA events), {100 * bound / ms:.1f}% "
            f"of its bound {bound:.4f} ms ({bound_by}), plain {plain_ms:.3f} ms, library "
            + (f"flex_attention with a segment{'' if window is None else ' + band'} block "
               f"mask {library_ms:.4f} ms ({library_err:.2e} from the plain version)"
               if library_ms is not None else f"not measured ({library_note})"))
        kinds.append(dict(kind=kind, window=window, tokens=t, segments=VARLEN_ROWS,
                          max_rel_err=err, ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=bound_by, roofline_pct=100 * bound / ms,
                          library_ms=library_ms, library_rel_err=library_err,
                          library_note=library_note))
    head = kinds[0]
    return dict(max_rel_err=max(x["max_rel_err"] for x in kinds), ms=head["ms"],
                event_ms=head["event_ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"],
                library="torch.compile(flex_attention) with a segment (+ band) block mask",
                shape=[t, h, d], kinds=kinds)


def phase_varlen_gqa() -> list:
    """V1's causal grouped-query mode at Mellum's widths against its plain
    version: 32 segments of the mellum8k law, 32 query heads reading 4 key
    heads of 128, a sliding layer (window 1,024, plain RoPE) and a full one
    (YaRN tables): each segment's output within VARLEN_REL_ERR by norm, one
    launch counted a call. Times as phase_varlen's; the bound counts the
    causal pairs (moe_work.causal_pairs) and q (32 heads), k and v (4 heads
    each) read and the output written once; the library call is
    flex_attention with a causal segment (+ window) mask and enable_gqa."""
    lens = np.random.default_rng(3).choice(modernbert_work.log_uniform_lengths(*GQA_LAW),
                                           size=GQA_ROWS, replace=False)
    t, h, hk, d = int(lens.sum()), GQA_HEADS, GQA_KV_HEADS, GQA_DIM
    cfg = mellum.MellumConfig()
    gen = torch.Generator(device="cuda").manual_seed(13)
    qkv = torch.randn((t, (h + 2 * hk) * d), generator=gen, device="cuda").to(torch.bfloat16)
    q = qkv[:, :h * d].view(t, h, d)  # strided, as the fused product's columns
    k = qkv[:, h * d:(h + hk) * d].view(t, hk, d)
    v = qkv[:, (h + hk) * d:].view(t, hk, d)
    segs = va.Segments.from_lengths(lens, "cuda")
    kinds = []
    for kind in (mellum.SLIDING, mellum.FULL):
        window = cfg.sliding_window if kind == mellum.SLIDING else None
        rope = tuple(x.cuda() for x in mellum.rope_tables(cfg, kind, 1024))
        va.varlen_attention.launches = 0
        got = va.varlen_attention(q, k, v, segs, window, rope=rope, causal=True)
        torch.cuda.synchronize()
        if va.varlen_attention.launches != 1:
            raise AssertionError("causal varlen_attention did not count its launch")
        plain = va.varlen_attention_reference(q, k, v, segs, window, rope, causal=True)
        err = segment_rel_err(got, plain, lens.tolist())
        if not err < VARLEN_REL_ERR:
            raise AssertionError(f"causal GQA varlen_attention ({kind}) is {err:.2e} from its "
                                 f"plain version, past {VARLEN_REL_ERR}")

        def fn():
            return va.varlen_attention(q, k, v, segs, window, rope=rope, causal=True)

        event_ms = time_ms(fn, 50)
        _, ms = call_device_ms(fn, KERNELS["varlen_attention"][3], 50)
        plain_ms = time_ms(lambda: va.varlen_attention_reference(
            q, k, v, segs, window, rope, causal=True), 3)
        pairs = float(moe_work.causal_pairs(lens, window).sum())
        flops, nbytes = 4.0 * h * d * pairs, 2.0 * t * d * (2 * h + 2 * hk)
        bound = 1e3 * max(flops / BF16_TC_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
        bound_by = "operations" if flops / BF16_TC_OPS_PER_S >= nbytes / HBM_BYTES_PER_S \
            else "bytes"
        library_ms, library_err, library_note = None, None, None
        try:
            call, lib_out = varlen_library(q, k, v, segs, window, rope, causal=True)
            torch.cuda.synchronize()
            library_err = segment_rel_err(lib_out, plain, lens.tolist())
            library_ms = time_ms(call, 50)
        except Exception as exc:  # the yardstick only: record why it did not run
            library_note = f"{type(exc).__name__}: {str(exc)[:200]}"
        log(f"  varlen_attention causal GQA {kind} at {t} tokens: within {err:.2e} of its plain "
            f"version, kernel {ms:.4f} ms on the device ({event_ms:.4f} ms per wrapper call by "
            f"CUDA events), {100 * bound / ms:.1f}% of its bound {bound:.4f} ms ({bound_by}), "
            f"plain {plain_ms:.3f} ms, library "
            + (f"flex_attention {library_ms:.4f} ms ({library_err:.2e} from the plain version)"
               if library_ms is not None else f"not measured ({library_note})"))
        kinds.append(dict(kind=f"causal GQA {kind}", window=window, tokens=t, segments=GQA_ROWS,
                          heads=[h, hk, d], max_rel_err=err, ms=ms, event_ms=event_ms,
                          plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                          roofline_pct=100 * bound / ms, library_ms=library_ms,
                          library_rel_err=library_err, library_note=library_note))
    return kinds


def moe_library(rows, ends, gate_up_w, down_w):
    """The library's part of M1 alone: the two bare grouped products on the
    sorted rows (no gather, SwiGLU, weighting or combine, so its figure is
    the more favourable)."""
    i = down_w.shape[1]

    def call():
        gu = torch._grouped_mm(rows, gate_up_w, offs=ends)
        return torch._grouped_mm(gu[:, :i].contiguous(), down_w, offs=ends)

    return call


def phase_moe() -> dict:
    """M1 against its plain version at Mellum's widths (MOE_WIDTHS) and
    MOE_TOKENS tokens, on bf16 weights N(0, 0.02^2) and a bf16 router:
    each token's output within MOE_REL_ERR of moe_gemm_reference's by norm,
    three Triton launches counted a call. Times: the whole call's device
    time (every kernel, torch.profiler) and its three passes' alone, by CUDA
    events, the plain version's (one torch.mm per expert), the library's
    two bare products, and the bound (harness/moe_work.experts_bound_s for
    one layer: 6 x A x h x i FLOPs at the bf16 peak, or the routed
    experts' weights and the activations once at HBM's rate). Also each
    device kernel of one call by name, for the trace's readers."""
    h, i, e, top_k = MOE_WIDTHS
    wd = moe_work.Widths(h, 32, 4, 128, e, top_k, i, 1024, (mellum.FULL,))
    gen = torch.Generator(device="cuda").manual_seed(17)
    gate_up = torch.randn((e, h, 2 * i), generator=gen, device="cuda").mul_(0.02)
    gate_up = gate_up.to(torch.bfloat16)
    down = torch.randn((e, i, h), generator=gen, device="cuda").mul_(0.02).to(torch.bfloat16)
    router = (torch.randn((h, e), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    rows_out = []
    for tokens in MOE_TOKENS:
        y = torch.randn((tokens, h), generator=gen, device="cuda")
        r = moe.route(y, router, top_k)
        moe.moe_gemm.launches = 0
        got = moe.moe_gemm(y, r, gate_up, down)
        torch.cuda.synchronize()
        if moe.moe_gemm.launches != 3:
            raise AssertionError(f"moe_gemm counted {moe.moe_gemm.launches} launches, not 3")
        want = moe.moe_gemm_reference(y, r, gate_up, down)
        err = float(((got - want).norm(dim=1) / want.norm(dim=1)).max())
        if not err < MOE_REL_ERR:
            raise AssertionError(f"moe_gemm at {tokens} tokens is {err:.2e} from its plain "
                                 f"version, past {MOE_REL_ERR}")
        off = moe.moe_gemm(y, r, gate_up.roll(1, 0), down.roll(1, 0))
        off_err = float(((off - want).norm(dim=1) / want.norm(dim=1)).max())
        if not off_err > 0.1:
            raise AssertionError(f"moe_gemm on the next expert's weights is only {off_err:.2e} "
                                 "off: the check cannot tell a misrouted kernel")

        def fn():
            return moe.moe_gemm(y, r, gate_up, down)

        event_ms = time_ms(fn, 20)
        ms, passes_ms = call_device_ms(fn, KERNELS["moe_gemm"][3], 20)
        by_kernel: dict = {}
        for ev in _device_events(fn, 1):
            by_kernel[ev.key[:160]] = by_kernel.get(ev.key[:160], 0.0) + \
                ev.self_device_time_total / 1e3
        plain_ms = time_ms(lambda: moe.moe_gemm_reference(y, r, gate_up, down), 3)
        rows = y[r.order // top_k].to(torch.bfloat16)
        library_ms = time_ms(moe_library(rows, r.offsets[1:].to(torch.int32), gate_up, down), 20)
        a = tokens * top_k
        flops = 6.0 * a * h * i
        bound = 1e3 * moe_work.experts_bound_s(tokens, wd)
        bound_by = "operations" if 1e3 * flops / BF16_TC_OPS_PER_S >= bound else "bytes"
        log(f"  moe_gemm at {tokens} tokens ({a} assignments, {e} experts, {h} x {i}): within "
            f"{err:.2e} of its plain version (next expert's weights {off_err:.2e}), "
            f"{ms:.4f} ms on the device, its passes {passes_ms:.4f} ({event_ms:.4f} ms per call "
            f"by CUDA events), {100 * bound / ms:.1f}% of its bound {bound:.4f} ms "
            f"({bound_by}), plain {plain_ms:.3f} ms, library (two bare torch._grouped_mm) "
            f"{library_ms:.4f} ms; kernels {json.dumps(by_kernel)}")
        rows_out.append(dict(tokens=tokens, assignments=a, max_rel_err=err,
                             next_expert_rel_err=off_err, ms=ms, passes_ms=passes_ms,
                             event_ms=event_ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by=bound_by, roofline_pct=100 * bound / ms,
                             library_ms=library_ms, kernels_ms=by_kernel))
        del y, r, got, want, off, rows
    head = rows_out[0]
    return dict(max_rel_err=max(x["max_rel_err"] for x in rows_out), ms=head["ms"],
                event_ms=head["event_ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"],
                library="torch._grouped_mm twice (gate and up, then down), bare",
                shape=[head["tokens"], h, i, e, top_k], sizes=rows_out)


def make_corpus(n, dim, n_queries, seed=0):
    """bench.py's workload: overlapping Gaussian mixture (centres ~ N(0, I),
    sigma 0.8), drawn on the card from a seeded generator."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_centers = max(min(4096, n // 64), 1)
    centers = torch.randn((n_centers, dim), generator=gen, device="cuda")
    assign = torch.randint(0, n_centers, (n,), generator=gen, device="cuda")
    x = centers[assign] + 0.8 * torch.randn((n, dim), generator=gen, device="cuda")
    q_assign = torch.randint(0, n_centers, (n_queries,), generator=gen, device="cuda")
    queries = centers[q_assign] + 0.8 * torch.randn((n_queries, dim), generator=gen,
                                                    device="cuda")
    return x, queries


def recall_at_10(ids, true_ids) -> float:
    hits = (ids[:, :, None] == true_ids[:, None, :]).any(dim=2) & (ids >= 0)
    return float(hits.sum()) / (10.0 * ids.shape[0])


def profile_pass(fn, top=10) -> dict:
    """Device time by kernel for one call of fn, from torch.profiler, and
    the device's busy share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    rows = [dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3, count=e.count)
            for e in kernels[:top]]
    log(f"  profile of one headline pass: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} kernel names")
    for r in rows:
        log(f"    {r['ms']:9.3f} ms  x{r['count']:<5d} {r['kernel']}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, top=rows)


def phase_main_path(n) -> tuple[dict, tuple]:
    """Config 2; also returns its corpus, queries and ground truth, which
    phases 5-7 reuse."""
    dim, n_queries = DIM, QUERIES
    metric = C2_CONFIG.metric
    cfg = C2_CONFIG
    x, queries = make_corpus(n, dim, n_queries)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launches()
    t0 = time.perf_counter()
    graph, sketch = build_index_with_sketch(x, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"  build {n}x{dim}: {build_s:.3f} s = {n / build_s:.1f} vectors/s")

    t0 = time.perf_counter()
    _, true_ids = brute_force_topk(queries, x, 10, metric, batch=65536)
    torch.cuda.synchronize()
    log(f"  ground truth: {time.perf_counter() - t0:.3f} s")

    searcher = StoredSearcher(graph, x, metric, sketch=sketch,
                                         routing_size=65536)

    def run(ef, pw, it, xw, fr, hop="fused", q=queries):
        return searcher.search(q, k=10, ef=ef, expand_width=xw, gate="sketch",
                               promote_width=pw, max_iters=it, final_rescore=fr,
                               hop_merge=hop)

    rungs = []
    for ef, pw, it, xw, fr in RUNGS:
        name = f"p{pw}/i{it}/x{xw}/fr{fr}"
        before = hop_merge.launches
        d, ids = run(ef, pw, it, xw, fr)
        hops = hop_merge.launches - before  # one K1 launch per hop
        rec = recall_at_10(ids, true_ids)
        err = check_results(name, d, ids, x, queries, metric)
        qps = timed_qps(lambda: run(ef, pw, it, xw, fr), n_queries)
        rungs.append(dict(rung=name, ef=ef, promote=pw, max_iters=it, expand_width=xw,
                          final_rescore=fr, recall=rec, qps=qps[len(qps) // 2],
                          qps_runs=qps, qps_spread=qps[-1] / qps[0] - 1, hops=hops,
                          max_abs_dist_err=err))
        log(f"  rung {name}: recall@10 {rec:.4f}, "
            f"QPS median {qps[len(qps) // 2]:.1f}, min {qps[0]:.1f}, max {qps[-1]:.1f} "
            f"(spread {100 * (qps[-1] / qps[0] - 1):.1f}%), {hops} hops")
    launches = read_launches()
    profile = profile_pass(lambda: run(*HEADLINE))

    # The fused and inline hop-merges give identical results.
    sub = queries[:AB_QUERIES]
    d_f, i_f = run(*HEADLINE, "fused", sub)
    d_i, i_i = run(*HEADLINE, "inline", sub)
    if not (torch.equal(i_f, i_i) and torch.equal(d_f, d_i)):
        raise AssertionError("fused and inline hop-merge disagree")
    log(f"  fused == inline on {AB_QUERIES} queries; returned distances exact at every rung")

    head = next(r for r in rungs if (r["ef"], r["promote"], r["max_iters"],
                                      r["expand_width"], r["final_rescore"]) == HEADLINE)
    if head["recall"] < MIN_HEADLINE_RECALL:
        raise AssertionError(f"headline rung recall {head['recall']:.4f} "
                             f"< {MIN_HEADLINE_RECALL}")
    if launches["hop_merge"] <= 0:
        raise AssertionError("the config-2 path never launched the hop_merge kernel")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  kernel launches on the config-2 path: {launches}; peak device "
        f"memory {peak_gb:.2f} GB")
    return dict(n=n, dim=dim, queries=n_queries, build_seconds=build_s,
                build_vectors_per_s=n / build_s,
                index_bytes_per_vector=(graph.storage_bytes()
                                        + 4 * sketch.node_sketch.numel()
                                        + 4 * sketch.w.numel() + 4) / n,
                peak_device_gb=peak_gb, rungs=rungs, headline_recall=head["recall"],
                headline_profile=profile, launches=launches), (x, queries, true_ids)


def timed_qps(fn, n_queries) -> list:
    """QPS of QPS_PASSES synchronised calls of fn, ascending."""
    times = []
    for _ in range(QPS_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(n_queries / t for t in times)


def check_results(what, d, ids, x, queries, metric, k=10) -> float:
    """Finite, ascending [B, k] results whose distances are the exact
    distances of the returned ids; returns the largest |error|."""
    if d.shape != (queries.shape[0], k) or not torch.isfinite(d).all():
        raise AssertionError(f"{what}: results not finite [B, {k}]")
    if not bool((d[:, 1:] >= d[:, :-1]).all()):
        raise AssertionError(f"{what}: distances not ascending")
    exact = rowwise_distance(queries, x[ids.long()], metric)
    err = float((exact - d).abs().max())
    if err > 1e-3:
        raise AssertionError(f"{what}: returned distances off the exact ones by {err}")
    return err


def phase_config4() -> dict:
    """bench_extra.py's config 4 on the port: build, two-level ladder,
    PQ scan and the A/B identities."""
    n, dim, n_queries = C4_N, C4_DIM, C4_QUERIES
    metric = DistanceMetric.EUCLIDEAN
    x, queries = make_corpus(n, dim, n_queries, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launches()
    t0 = time.perf_counter()
    idx = LeannIndex(LeannConfig(metric=metric, wave_size=4096))
    idx.build_from_embeddings(x, with_pq=C4_PQ)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"  build {n}x{dim} with PQ {C4_PQ.num_subquantizers}x{C4_PQ.num_centroids}: "
        f"{build_s:.3f} s = {n / build_s:.1f} vectors/s")

    t0 = time.perf_counter()
    _, true_ids = brute_force_topk(queries, x, 10, metric, batch=65536)
    torch.cuda.synchronize()
    log(f"  ground truth: {time.perf_counter() - t0:.3f} s")
    provider = InMemoryEmbeddingProvider(x)

    def run(ef, it, xw, pw, fr, q=queries, adc="grouped", hop="fused"):
        return idx.search_two_level(q, k=10, provider=provider, ef=ef, rerank_ratio=0.25,
                                    max_iters=it, routing_size=C4_ROUTING, expand_width=xw,
                                    promote_width=pw, final_rescore=fr, adc_impl=adc,
                                    hop_merge=hop)

    rungs = []
    for ef, it, xw, pw, fr in C4_RUNGS:
        name = f"ef{ef}/i{it}/x{xw}/p{pw}/fr{fr}"
        before = hop_merge.launches
        d, ids = run(ef, it, xw, pw, fr)
        hops = hop_merge.launches - before  # one K1 launch per hop
        frac = idx.last_recompute_fraction
        rec = recall_at_10(ids, true_ids)
        err = check_results(name, d, ids, x, queries, metric)
        qps = timed_qps(lambda: run(ef, it, xw, pw, fr), n_queries)
        rungs.append(dict(rung=name, ef=ef, max_iters=it, expand_width=xw, promote=pw,
                          final_rescore=fr, recall=rec, qps=qps[len(qps) // 2],
                          qps_runs=qps, qps_spread=qps[-1] / qps[0] - 1, hops=hops,
                          recompute_fraction=frac, max_abs_dist_err=err))
        log(f"  rung {name}: recall@10 {rec:.4f}, QPS median {qps[len(qps) // 2]:.1f}, "
            f"min {qps[0]:.1f}, max {qps[-1]:.1f} (spread {100 * (qps[-1] / qps[0] - 1):.1f}%), "
            f"{hops} hops, recompute fraction {frac:.6f}")
    reported = next((r for r in rungs if r["recall"] >= MIN_HEADLINE_RECALL), None)
    if reported is None:
        raise AssertionError(f"no config-4 rung reached recall@10 {MIN_HEADLINE_RECALL}")
    log(f"  reported rung (first at recall >= {MIN_HEADLINE_RECALL}): {reported['rung']}")

    q_scan, t_scan = queries[:PQ_SCAN_QUERIES], true_ids[:PQ_SCAN_QUERIES]
    scans = []
    for rerank in PQ_SCAN_RERANKS:
        d, ids = idx.search_pq_scan(q_scan, k=10, provider=provider, rerank=rerank)
        rec = recall_at_10(ids, t_scan)
        err = check_results(f"pq scan rerank {rerank}", d, ids, x, q_scan, metric)
        qps = timed_qps(lambda: idx.search_pq_scan(q_scan, k=10, provider=provider,
                                                   rerank=rerank), PQ_SCAN_QUERIES)
        scans.append(dict(rerank=rerank, queries=PQ_SCAN_QUERIES, recall=rec,
                          qps=qps[len(qps) // 2], qps_runs=qps,
                          qps_spread=qps[-1] / qps[0] - 1, max_abs_dist_err=err))
        log(f"  pq scan, {PQ_SCAN_QUERIES} queries, rerank {rerank}: recall@10 {rec:.4f}, "
            f"QPS median {qps[len(qps) // 2]:.1f}, min {qps[0]:.1f}, max {qps[-1]:.1f}")
    launches = read_launches()
    log(f"  kernel launches on the config-4 path: {launches}")
    # K3 "smallest" at rerank 128 and 256, K3 "sums" at 2048.
    for name in ("hop_merge", "gated_adc", "adc_scan_smallest", "adc_scan"):
        if launches[name] <= 0:
            raise AssertionError(f"the config-4 path never launched the {name} kernel")

    head = (reported["ef"], reported["max_iters"], reported["expand_width"],
            reported["promote"], reported["final_rescore"])
    profile = profile_pass(lambda: run(*head))
    sub = queries[:AB_QUERIES]
    grouped, einsum = run(*head, q=sub), run(*head, q=sub, adc="einsum")
    fused, inline = grouped, run(*head, q=sub, hop="inline")
    for what, (a, b) in (("grouped and einsum ADC", (grouped, einsum)),
                         ("fused and inline hop-merge", (fused, inline))):
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"{what} disagree")
    log(f"  grouped == einsum and fused == inline on {AB_QUERIES} queries")

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bpv = idx.storage_bytes() / n
    log(f"  index bytes/vector {bpv:.2f}; peak device memory {peak_gb:.2f} GB")
    against_chain = pq_scan_against_chain(idx, q_scan, provider)
    return dict(n=n, dim=dim, queries=n_queries, pq=dict(subquantizers=16, centroids=256),
                build_seconds=build_s, build_vectors_per_s=n / build_s,
                index_bytes_per_vector=bpv, peak_device_gb=peak_gb, rungs=rungs,
                reported_rung=reported["rung"], pq_scan=scans,
                pq_scan_against_chain=against_chain, headline_profile=profile,
                launches=launches)


def _chain_candidates(pq, q, codes, r, metric=None):
    """search_pq_scan's selection before K3's "smallest" route: pq_scan's
    [B, N] distances (K3 "sums", finalised), then smallest_k."""
    return merge.smallest_k(pq_scan(pq, q, codes, metric=metric), r)


def pq_scan_against_chain(idx, q, provider) -> list:
    """search_pq_scan at the reranks of K3's "smallest" route against the
    same call selecting by the chain it replaced: the same ids and
    distances, and the device memory each call adds at its peak, which must
    stay below one [B, N] f32 matrix."""
    out = []
    metric = idx.config.metric
    for rerank in PQ_SCAN_RERANKS[:2]:
        cand = pq_scan_smallest(idx.pq, q, idx.pq_codes, rerank, metric=metric)
        if not torch.equal(cand, _chain_candidates(idx.pq, q, idx.pq_codes, rerank, metric)):
            raise AssertionError(f"pq_scan_smallest differs from the chain at rerank {rerank}")
        del cand
        results, peaks = {}, {}
        for what in ("smallest", "chain"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with (unittest.mock.patch.object(leann_mod, "pq_scan_smallest", _chain_candidates)
                  if what == "chain" else contextlib.nullcontext()):
                results[what] = idx.search_pq_scan(q, k=10, provider=provider, rerank=rerank)
            torch.cuda.synchronize()
            peaks[what] = (torch.cuda.max_memory_allocated() - base) / 1e9
        (d, ids), (cd, cids) = results["smallest"], results["chain"]
        if not (torch.equal(d, cd) and torch.equal(ids, cids)):
            raise AssertionError(f"search_pq_scan differs from the chain at rerank {rerank}")
        matrix_gb = q.shape[0] * idx.num_nodes * 4 / 1e9
        if peaks["smallest"] >= matrix_gb:
            raise AssertionError(f"search_pq_scan at rerank {rerank} added "
                                 f"{peaks['smallest']:.3f} GB, a [B, N] matrix's worth")
        log(f"  search_pq_scan == the chain on {q.shape[0]} queries at rerank {rerank}; "
            f"peak device memory added {peaks['smallest']:.3f} GB, the chain's "
            f"{peaks['chain']:.3f} GB ([B, N] f32: {matrix_gb:.3f} GB); candidates equal")
        out.append(dict(rerank=rerank, peak_added_gb=peaks["smallest"],
                        chain_peak_added_gb=peaks["chain"]))
    return out


def phase_gather_bench() -> dict:
    """The port of benches/gather_bench.py at its own sizes (K5's path)."""
    zero_launches()
    out = gather_bench.main(GATHER_N, GATHER_D)
    launches = read_launches()
    if launches["row_gather"] <= 0:
        raise AssertionError("the gather bench never launched the row_gather kernel")
    log(f"  kernel launches on the gather-bench path: {launches}")
    return dict(out, launches=launches)


def swapped_rows(d, ids, want_d, want_ids, queries, x, mode) -> int:
    """Rows whose top-10 ids differ from the oracle's; raises unless, rank
    by rank, the two rows' distances agree within K4's tolerance (near-ties
    that the kernel's and the plain version's sums order differently)."""
    rows = torch.nonzero(~torch.all(ids == want_ids, dim=1)).squeeze(1)
    if rows.numel() == 0:
        return 0
    qn = torch.sum(queries[rows].double() ** 2, dim=1)[:, None]
    xn = torch.maximum(torch.sum(x[ids[rows].long()].double() ** 2, dim=-1),
                       torch.sum(x[want_ids[rows].long()].double() ** 2, dim=-1))
    tol = (1e-5 * torch.sqrt(qn * xn) if mode == "neg_dot"
           else torch.sqrt(1e-5 * (qn + xn)))
    gap = (d[rows].double() - want_d[rows].double()).abs()
    if not bool((gap <= tol).all()):
        raise AssertionError(f"ops API {mode} top-10 differs from the oracle's beyond K4's "
                             f"tolerance (largest gap {float(gap.max()):.3e})")
    return rows.numel()


def phase_ops_api(x, queries) -> dict:
    """K4's path: exact top-10 of phase 3's queries over its corpus through
    the ops API with the kernel (pairwise_l2 for euclidean, pairwise_neg_dot
    for the dot product), held to brute_force_topk's: the same ids on every
    row but swaps within K4's tolerance (swapped_rows), counted."""
    zero_launches()
    out = {}
    for name, dist, metric in (
            ("l2", lambda a, b: ops.pairwise_l2(a, b, use_kernel=True),
             DistanceMetric.EUCLIDEAN),
            ("neg_dot", lambda a, b: ops.pairwise_neg_dot(a, b, use_kernel=True),
             DistanceMetric.DOT_PRODUCT)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, ids = brute_force_topk(queries, x, 10, metric, batch=65536, dist_fn=dist)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        want_d, want = brute_force_topk(queries, x, 10, metric, batch=65536)
        rec = recall_at_10(ids, want)
        same = float(torch.all(ids == want, dim=1).float().mean())
        swaps = swapped_rows(d, ids, want_d, want, queries, x, name)
        log(f"  ops API {name} top-10 over {x.shape[0]}x{x.shape[1]}: {secs:.3f} s, recall@10 "
            f"{rec:.5f} against brute_force_topk, identical rows {same:.5f}; rows with "
            f"swaps within K4's tolerance: {swaps}")
        out[name] = dict(seconds=secs, recall=rec, identical_rows=same, swapped_rows=swaps)
    launches = read_launches()
    for kname in ("pairwise_l2", "pairwise_neg_dot"):
        if launches[kname] <= 0:
            raise AssertionError(f"the ops-API path never launched the {kname} kernel")
    log(f"  kernel launches on the ops-API path: {launches}")
    return dict(out, launches=launches)


def qps_line(qps) -> str:
    return (f"QPS median {qps[len(qps) // 2]:.1f}, min {qps[0]:.1f}, max {qps[-1]:.1f} "
            f"(spread {100 * (qps[-1] / qps[0] - 1):.1f}%)")


def phase_lifecycle(x, queries, true_ids, metric, cfg, headline_recall) -> dict:
    """Build on the first N - 65,536 rows, extend to N, save (with and
    without the sketch), load, search loaded and in-memory alike."""
    n, n_queries = x.shape[0], queries.shape[0]
    n_prefix = n - LIFE_REINDEX
    provider = InMemoryEmbeddingProvider(x)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = LeannIndex(cfg).build_from_embeddings(x[:n_prefix])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.extend(provider)
    torch.cuda.synchronize()
    extend_s = time.perf_counter() - t0
    log(f"  build {n_prefix}x{x.shape[1]}: {build_s:.3f} s; extend by {LIFE_REINDEX} to {n}: "
        f"{extend_s:.3f} s = {LIFE_REINDEX / extend_s:.1f} vectors/s")
    if idx.num_nodes != n:
        raise AssertionError(f"extended index holds {idx.num_nodes} nodes, not {n}")
    idx.graph.validate()

    scratch = pathlib.Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        full_bytes = save_index(idx, pathlib.Path(tmp) / "full.leann")
        save_s = time.perf_counter() - t0
        parity_bytes = save_index(idx, pathlib.Path(tmp) / "parity.leann", persist_sketch=False)
        t0 = time.perf_counter()
        loaded = load_index(pathlib.Path(tmp) / "full.leann")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        parity = load_index(pathlib.Path(tmp) / "parity.leann")
    log(f"  save_index {save_s:.3f} s, load_index {load_s:.3f} s; file bytes/vector "
        f"{full_bytes / n:.2f} with the sketch, {parity_bytes / n:.2f} without; "
        f"storage_bytes()/N {idx.storage_bytes() / n:.2f}")
    # Storage-parity mode: the sketch rederived from the seed is the saved one.
    sk = proj_ops.build_sketch_index(prep_corpus(x, metric), parity.graph.neighbors,
                                     proj_dims=idx.sketch.proj_dims, seed=cfg.seed)
    if parity.sketch is not None or not (
            torch.equal(sk.node_sketch, idx.sketch.node_sketch)
            and torch.equal(sk.nbr_sketch, idx.sketch.nbr_sketch)
            and float(sk.scale) == float(idx.sketch.scale)):
        raise AssertionError("the sketch rederived in storage-parity mode is not the saved one")
    del parity, sk
    log("  storage-parity mode: the sketch rederived from the seed equals the saved one")

    searches = []
    for name, kw in LIFE_SEARCHES:
        a = loaded.search(queries, k=10, provider=provider, **kw)
        frac_loaded = loaded.last_recompute_fraction
        b = idx.search(queries, k=10, provider=provider, **kw)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"loaded and in-memory index differ at {name}")
        err = check_results(f"lifecycle {name}", b[0], b[1], x, queries, metric)
        rec = recall_at_10(b[1], true_ids)
        frac = idx.last_recompute_fraction if kw["gate"] == "sketch" else None
        if kw["gate"] == "sketch" and frac != frac_loaded:
            raise AssertionError(f"recompute fractions differ at {name}")
        qps_loaded = timed_qps(lambda: loaded.search(queries, k=10, provider=provider, **kw),
                               n_queries)
        qps_mem = timed_qps(lambda: idx.search(queries, k=10, provider=provider, **kw),
                            n_queries)
        log(f"  search {name}: recall@10 {rec:.4f}, loaded == in-memory, "
            + "loaded " + qps_line(qps_loaded) + "; in-memory " + qps_line(qps_mem)
            + (f"; recompute fraction {frac:.6f}" if frac is not None else ""))
        searches.append(dict(search=name, **kw, recall=rec, max_abs_dist_err=err,
                             qps_loaded=qps_loaded[len(qps_loaded) // 2],
                             qps_loaded_runs=qps_loaded, qps=qps_mem[len(qps_mem) // 2],
                             qps_runs=qps_mem, recompute_fraction=frac))
    del loaded

    searcher = StoredSearcher(idx.graph, x, metric, sketch=idx.sketch, routing_size=65536)
    ef, pw, it, xw, fr = HEADLINE
    d, ids = searcher.search(queries, k=10, ef=ef, expand_width=xw, gate="sketch",
                             promote_width=pw, max_iters=it, final_rescore=fr,
                             hop_merge="fused")
    check_results("lifecycle StoredSearcher", d, ids, x, queries, metric)
    stored_rec = recall_at_10(ids, true_ids)
    log(f"  StoredSearcher over the extended index, headline rung p{pw}/i{it}/x{xw}/fr{fr}: "
        f"recall@10 {stored_rec:.4f} (phase 3's index: {headline_recall:.4f})")
    if stored_rec < MIN_HEADLINE_RECALL:
        raise AssertionError(f"extended index headline recall {stored_rec:.4f} "
                             f"< {MIN_HEADLINE_RECALL}")
    launches = read_launches()
    log(f"  kernel launches on the lifecycle path: {launches}")
    return dict(n_prefix=n_prefix, n=n, build_seconds=build_s, extend_seconds=extend_s,
                file_bytes_per_vector=full_bytes / n, parity_file_bytes_per_vector=parity_bytes / n,
                storage_bytes_per_vector=idx.storage_bytes() / n, save_seconds=save_s,
                load_seconds=load_s, searches=searches, stored_headline_recall=stored_rec,
                phase3_headline_recall=headline_recall, launches=launches)


def phase_hnsw(x, queries, true_ids, metric) -> dict:
    """HnswIndex on phase 3's corpus: build, search, save/load, Searcher."""
    n_queries = queries.shape[0]
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = HnswIndex(HnswConfig(metric=metric, wave_size=4096)).build(x)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sizes = [index.num_nodes] + [len(layer.ids) for layer in index.layers]
    log(f"  HNSW build {x.shape[0]}x{x.shape[1]}: {build_s:.3f} s = "
        f"{x.shape[0] / build_s:.1f} vectors/s; layer sizes {sizes}")
    index.layer0.validate()
    results, searches = {}, []
    for ef in HNSW_EFS:
        d, ids = index.search(queries, k=10, ef=ef)
        err = check_results(f"hnsw ef{ef}", d, ids, x, queries, metric)
        rec = recall_at_10(ids, true_ids)
        qps = timed_qps(lambda: index.search(queries, k=10, ef=ef), n_queries)
        log(f"  HNSW ef {ef}: recall@10 {rec:.4f}, " + qps_line(qps))
        results[ef] = (d, ids)
        searches.append(dict(ef=ef, recall=rec, max_abs_dist_err=err,
                             qps=qps[len(qps) // 2], qps_runs=qps,
                             qps_spread=qps[-1] / qps[0] - 1))
    scratch = pathlib.Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        nbytes = save_hnsw(index, pathlib.Path(tmp) / "index.hnsw")
        loaded = load_hnsw(pathlib.Path(tmp) / "index.hnsw")
    for ef, (d, ids) in results.items():
        d2, ids2 = loaded.search(queries, k=10, ef=ef)
        if not (torch.equal(d, d2) and torch.equal(ids, ids2)):
            raise AssertionError(f"loaded HNSW index differs at ef {ef}")
    del loaded
    log(f"  save_hnsw / load_hnsw: {nbytes / x.shape[0]:.2f} file bytes/vector; loaded == "
        f"in-memory at ef {HNSW_EFS}")
    sub = queries[:SEARCHER_QUERIES]
    hits = Searcher(index, SearchConfig(top_k=10, ef=128)).search(sub)
    d, ids = index.search(sub, k=10, ef=128)
    want = [[(int(i), float(v)) for v, i in zip(dr.tolist(), ir.tolist())
             if i >= 0 and math.isfinite(v)]
            for dr, ir in zip(d.cpu(), ids.cpu())]
    if [[(h.id, h.distance) for h in row] for row in hits] != want:
        raise AssertionError("Searcher's hits differ from HnswIndex.search")
    log(f"  Searcher(top_k=10, ef=128) == HnswIndex.search on {SEARCHER_QUERIES} queries")
    launches = read_launches()
    log(f"  kernel launches on the HNSW path: {launches}")
    return dict(build_seconds=build_s, build_vectors_per_s=x.shape[0] / build_s,
                layer_sizes=sizes, searches=searches, file_bytes_per_vector=nbytes / x.shape[0],
                launches=launches)


def config3_tokens():
    """bench_extra.py's config-3 token table, drawn exactly as there:
    2048 prototypes of 64 ids, 30% of ids replaced, lengths in [32, 64]."""
    n, slen = C3_N, C3_L
    rng = np.random.default_rng(0)
    protos = rng.integers(1000, 29000, size=(2048, slen))
    assign = rng.integers(0, 2048, size=n)
    token_ids = protos[assign].copy()
    noise = rng.random((n, slen)) < 0.3
    token_ids[noise] = rng.integers(1000, 29000, size=int(noise.sum()))
    lens = rng.integers(slen // 2, slen + 1, size=n)
    mask = (np.arange(slen)[None, :] < lens[:, None]).astype(np.int32)
    return (token_ids * mask).astype(np.int32), mask


def encoder_flops_per_token(enc: TextEncoder, slen: int) -> float:
    """Forward FLOPs per token: 2 x the non-embedding parameters (every
    weight multiplies once per token) + 4 x L x h per layer (the q.k scores
    and the probability-weighted values over L keys)."""
    cfg = enc.model_config
    params = sum(p.numel() for p in enc.model.layers.parameters())
    return 2.0 * params + 4.0 * slen * cfg.hidden_size * cfg.num_hidden_layers


def encoder_alone(enc: TextEncoder, ids, mask) -> dict:
    """The encoder on the corpus rows, ENCODER_BATCH rows per call:
    texts/s, tokens/s (padded tokens, which it computes) and its share of
    the card's dense bfloat16 peak; and tokens/s at the other call sizes of
    ENCODER_CALL_ROWS, which place the provider's chunk size."""
    ids, mask = ids.cuda(), mask.cuda()
    n, slen = ids.shape
    flops = encoder_flops_per_token(enc, slen)
    by_rows = {}
    for rows in sorted({ENCODER_BATCH, *ENCODER_CALL_ROWS}):
        bert_mod.encode(enc.model, ids[:rows], mask[:rows])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(0, n, rows):
            bert_mod.encode(enc.model, ids[s:s + rows], mask[s:s + rows])
        torch.cuda.synchronize()
        by_rows[rows] = n * slen / (time.perf_counter() - t0)
    tokens_s = by_rows[ENCODER_BATCH]
    share = tokens_s * flops / BF16_TC_OPS_PER_S
    log(f"  encoder alone, {n} rows x {slen} tokens in calls of {ENCODER_BATCH}: "
        f"{tokens_s / slen:.1f} texts/s, {tokens_s:.1f} tokens/s, {flops / 1e6:.2f} "
        f"MFLOP/token, {100 * share:.2f}% of the bf16 peak ({BF16_TC_OPS_PER_S / 1e12:.0f} "
        f"TFLOP/s); tokens/s by rows per call: "
        + ", ".join(f"{r}: {t:.1f}" for r, t in by_rows.items()))
    return dict(rows=n, seq_len=slen, batch_rows=ENCODER_BATCH, texts_per_s=tokens_s / slen,
                tokens_per_s=tokens_s, flops_per_token=flops, bf16_peak_share=share,
                tokens_per_s_by_call_rows=by_rows)


def encoder_card_vs_cpu(enc: TextEncoder, ids, mask, what: str) -> dict:
    """The card's bfloat16 pooled rows against the port's own float32
    forward on the CPU, from the same seeded weights."""
    cfg = dataclasses.replace(enc.model_config, dtype="float32")
    cpu = TextEncoder(architecture_module(cfg).init_params(cfg, 0), cfg, device="cpu")
    got = bert_mod.encode(enc.model, ids.cuda(), mask.cuda()).cpu().double()
    want = bert_mod.encode(cpu.model, ids, mask).double()
    mu = want.mean(dim=0)
    raw = float(F.cosine_similarity(got, want, dim=1).min())
    centred = float(F.cosine_similarity(got - mu, want - mu, dim=1).min())
    log(f"  {what}: card bf16 vs CPU float32 on {ids.shape[0]} rows: smallest cosine "
        f"{raw:.6f} (bound {ENCODER_MIN_COS}), centred {centred:.6f} "
        f"(bound {ENCODER_MIN_CENTRED_COS})")
    if not (raw >= ENCODER_MIN_COS and centred >= ENCODER_MIN_CENTRED_COS):
        raise AssertionError(f"{what}: the card's encoder disagrees with the CPU forward")
    return dict(rows=int(ids.shape[0]), min_cosine=raw, min_centred_cosine=centred)


def recompute_pass(idx, q, provider, bs, **knobs):
    """idx.search over q in query batches of `bs` (a recompute search holds
    a hop's encoder activations for the whole batch); returns the ids and
    the recompute fraction averaged over the queries (None for gate "none",
    which does not count it)."""
    outs, fracs = [], []
    for s in range(0, q.shape[0], bs):
        idx.last_recompute_fraction = None
        _, ids = idx.search(q[s:s + bs], k=10, provider=provider, **knobs)
        outs.append(ids)
        fracs.append(idx.last_recompute_fraction)
    ids = torch.cat(outs)
    if None in fracs:
        return ids, None
    return ids, sum(f * o.shape[0] for f, o in zip(fracs, outs)) / ids.shape[0]


def recompute_rung(name, idx, q, true_ids, provider, bs, passes, **knobs) -> dict:
    n = idx.num_nodes
    ids, frac = recompute_pass(idx, q, provider, bs, **knobs)
    rec = recall_at_10(ids, true_ids)
    qps = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recompute_pass(idx, q, provider, bs, **knobs)
        torch.cuda.synchronize()
        qps.append(q.shape[0] / (time.perf_counter() - t0))
    qps.sort()
    med = qps[len(qps) // 2]
    enc_s = med * frac * n if frac is not None else None
    log(f"  {name}: {q.shape[0]} queries in batches of {bs}, recall@10 {rec:.4f}, "
        f"{qps_line(qps)}, recompute fraction "
        + (f"{frac:.6f}, encodes/s {enc_s:.1f}" if frac is not None else "not counted (gate none)"))
    return dict(rung=name, queries=int(q.shape[0]), batch=bs, recall=rec, qps=med, qps_runs=qps,
                recompute_fraction=frac, encodes_per_s=enc_s, **knobs)


def phase_config3() -> dict:
    """BASELINE config 3: LEANN recompute search at 131,072 chunks with the
    encoder on the card."""
    ids_np, mask_np = config3_tokens()
    ids, mask = torch.from_numpy(ids_np), torch.from_numpy(mask_np)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    enc = TextEncoder.from_preset("minilm-l6", seed=0)
    provider = EncoderEmbeddingProvider(enc, ids, mask).with_center()
    idx = LeannIndex(C3_CONFIG).build(provider, num_vectors=C3_N)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bpv = idx.storage_bytes() / C3_N
    log(f"  build {C3_N} chunks x {C3_L} tokens, minilm-l6 bf16 (encoder set-up, centre, "
        f"embeddings, graph): {build_s:.3f} s; index bytes/vector {bpv:.2f}; embed chunk "
        f"{enc.config.batch_size * EMBED_CHUNK_BATCHES} rows")

    emb = materialize_embeddings(provider, C3_N)
    q = emb[:C3_QUERIES].clone()
    _, true_ids = brute_force_topk(q, emb, 10, C3_CONFIG.metric, batch=C3_N)
    del emb
    rungs = []
    for name, gate, bs, nq, ef, pw, it in C3_RUNGS:
        rungs.append(recompute_rung(name, idx, q[:nq], true_ids[:nq], provider, bs,
                                    C3_QPS_PASSES, ef=ef, gate=gate, promote_width=pw,
                                    max_iters=it))
    launches = read_launches()
    name, gate, bs, nq, ef, pw, it = C3_RUNGS[0]
    profile = profile_pass(lambda: recompute_pass(idx, q, provider, bs, ef=ef, gate=gate,
                                                  promote_width=pw, max_iters=it))
    alone = encoder_alone(enc, ids, mask)
    check = encoder_card_vs_cpu(enc, ids[:256], mask[:256], "minilm-l6")
    for r in rungs:
        floor = C3_MIN_RECALL.get(r["rung"])
        if floor is not None and r["recall"] < floor:
            raise AssertionError(f"config 3 {r['rung']}: recall@10 {r['recall']:.4f} < {floor}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  kernel launches on the config-3 path: {launches}; peak device memory "
        f"{peak_gb:.2f} GB")
    return dict(n=C3_N, seq_len=C3_L, encoder="minilm-l6", build_seconds=build_s,
                index_bytes_per_vector=bpv, rungs=rungs, encoder_alone=alone,
                encoder_check=check, gated_profile=profile, peak_device_gb=peak_gb,
                launches=launches)


def phase_config1(root: pathlib.Path, preset: str = "bge-base", queries: int = C1_QUERIES,
                  passes: int = C1_QPS_PASSES, check_rows: int | None = 64) -> dict:
    """BASELINE config 1: the checkout's own source, chunked by the native
    loader and by the Python chunker (which must agree), indexed with the
    `preset` encoder on the card and searched with recompute; the card's
    encode of the first `check_rows` token rows against the CPU's (None:
    no check)."""
    t0 = time.perf_counter()
    chunks = chunk_files(collect_files(root, C1_EXTS), 512, 64)
    py_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = collect_chunks_native(root, C1_EXTS, 512, 64)
    native_s = time.perf_counter() - t0
    if native is None:
        raise AssertionError("the native loader did not build or failed")
    if [dataclasses.astuple(c) for c in native] != [dataclasses.astuple(c) for c in chunks]:
        raise AssertionError(f"native chunks ({len(native)}) differ from the Python "
                             f"chunker's ({len(chunks)})")
    n = len(chunks)
    log(f"  {n} chunks of {root}: native == Python chunker (native {native_s:.3f} s, "
        f"Python {py_s:.3f} s)")

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    enc = TextEncoder.from_preset(preset, seed=0)
    provider = EncoderEmbeddingProvider.from_texts(enc, [c.text for c in chunks],
                                                   pad_to=C1_PAD).with_center()
    idx = LeannIndex(C1_CONFIG).build(provider)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bpv = idx.storage_bytes() / n
    log(f"  build {n} chunks x {C1_PAD} tokens, {preset} bf16 (tokenize, centre, embeddings, "
        f"graph): {build_s:.3f} s; index bytes/vector {bpv:.2f}")
    emb = materialize_embeddings(provider, n)
    qn = min(queries, n)
    q = emb[:qn].clone()
    _, true_ids = brute_force_topk(q, emb, 10, C1_CONFIG.metric)
    rung = recompute_rung(f"ef{C1_EF}/gate auto", idx, q, true_ids, provider, C1_BATCH,
                          passes, ef=C1_EF, gate="auto")
    launches = read_launches()
    check = (encoder_card_vs_cpu(enc, provider.token_ids[:check_rows].cpu(),
                                 provider.token_mask[:check_rows].cpu(), preset)
             if check_rows else None)
    if rung["recall"] < C1_MIN_RECALL:
        raise AssertionError(f"config 1 ({preset}): recall@10 {rung['recall']:.4f} < "
                             f"{C1_MIN_RECALL}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  kernel launches on the config-1 path ({preset}): {launches}; peak device memory "
        f"{peak_gb:.2f} GB")
    return dict(n_chunks=n, native_equals_python=True, encoder=preset, seq_len=C1_PAD,
                build_seconds=build_s, index_bytes_per_vector=bpv, rung=rung,
                encoder_check=check, peak_device_gb=peak_gb, launches=launches)


@contextlib.contextmanager
def timed_per_shard(names):
    """Wrap sharded.py's functions `names` so each call records CUDA events
    around itself; yields the list of (name, start, stop)."""
    events = []

    def wrap(name, fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            events.append((name, start, stop))
            return out
        return timed

    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(unittest.mock.patch.object(
                sharded_mod, name, wrap(name, getattr(sharded_mod, name))))
        yield events


def event_ms(events, name, n_shards):
    """ms per call of `name` from timed_per_shard's events, by shard when
    the calls cycle over the shards (n_shards > 1)."""
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for n, a, b in events if n == name]
    return [float(np.mean(ms[s::n_shards])) for s in range(n_shards)]


def phase_sharded(x, queries, true_ids) -> dict:
    """Config 5 on one card: build_sharded, extend_sharded, the rungs, the
    identities (fused == inline, merge == host merge, recompute == stored,
    loaded == in-memory) and a profile of one p16 pass."""
    n, n_queries = x.shape[0], queries.shape[0]
    n_prefix = n - C5_REINDEX
    metric = C5_CONFIG.metric
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(C5_SHARDS)
    with timed_per_shard(["_build_shard"]) as events:
        t0 = time.perf_counter()
        idx = build_sharded(x[:n_prefix], C5_CONFIG, mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_shard_s = [ms / 1e3 for ms in event_ms(events, "_build_shard", C5_SHARDS)]
    with timed_per_shard(["_extend_shard"]) as events:
        t0 = time.perf_counter()
        idx = extend_sharded(idx, x[n_prefix:])
        torch.cuda.synchronize()
        extend_s = time.perf_counter() - t0
        extend_shard_s = [ms / 1e3 for ms in event_ms(events, "_extend_shard", C5_SHARDS)]
    log(f"  build_sharded {n_prefix}x{x.shape[1]} as {C5_SHARDS} shards: {build_s:.3f} s = "
        f"{n_prefix / build_s:.1f} vectors/s (per shard {build_shard_s[0]:.3f} / "
        f"{build_shard_s[1]:.3f} s); extend_sharded by {C5_REINDEX}: {extend_s:.3f} s = "
        f"{C5_REINDEX / extend_s:.1f} vectors/s (per shard {extend_shard_s[0]:.3f} / "
        f"{extend_shard_s[1]:.3f} s)")
    gids = idx.gids.cpu().numpy()
    real = np.concatenate([gids[s, :c] for s, c in enumerate(idx.counts)])
    if idx.num_vectors != n or not np.array_equal(np.sort(real), np.arange(n)):
        raise AssertionError("the archipelago's global ids are not the corpus rows")
    for s, c in enumerate(idx.counts):
        graph_invariants(idx.neighbors[s], idx.degrees[s], int(c), f"shard {s}")
    graph_bytes = sum(t.numel() * t.element_size() for t in (
        idx.neighbors, idx.degrees, idx.gids, idx.node_sketch, idx.nbr_sketch, idx.routing))
    log(f"  counts {list(map(int, idx.counts))}, n_local {idx.n_local}; graph + gids + sketches "
        f"{graph_bytes / n:.2f} B/vector in memory (stored rows {4 * x.shape[1]} B more)")

    searcher = ArchipelagoSearcher(idx)
    rungs = []
    for name, kw in C5_RUNGS:
        before = hop_merge.launches
        d, ids = searcher.search(queries, k=10, **kw)
        hops = hop_merge.launches - before
        rec = recall_at_10(ids, true_ids)
        err = check_results(f"config 5 {name}", d, ids, x, queries, metric)
        want_d, want_i = host_merge(*searcher.search_shards(queries, k=10, **kw), idx.gids,
                                    idx.counts, 10)
        if not (np.array_equal(ids.cpu().numpy(), want_i)
                and np.array_equal(d.cpu().numpy(), want_d)):
            raise AssertionError(f"config 5 {name}: the merged top-10 differs from the host "
                                 "merge of the per-shard results")
        qps = timed_qps(lambda: searcher.search(queries, k=10, **kw), n_queries)
        with timed_per_shard(["batched_sketch_gated_query", "batched_search",
                              "_merge_topk"]) as events:
            for _ in range(3):
                searcher.search(queries, k=10, **kw)
            shard_fn = "batched_sketch_gated_query" if kw["gate"] == "sketch" else "batched_search"
            shard_ms = event_ms(events, shard_fn, C5_SHARDS)
            merge_ms = event_ms(events, "_merge_topk", 1)[0]
        rungs.append(dict(rung=name, **kw, recall=rec, qps=qps[len(qps) // 2], qps_runs=qps,
                          qps_spread=qps[-1] / qps[0] - 1, hops_k1=hops,
                          shard_ms=shard_ms, merge_ms=merge_ms, max_abs_dist_err=err))
        log(f"  rung {name}: recall@10 {rec:.4f}, " + qps_line(qps)
            + f"; per-shard ms {shard_ms[0]:.3f} / {shard_ms[1]:.3f}, merge ms {merge_ms:.4f} "
            f"(CUDA events); {hops} K1 launches; merged == host merge")
        if name in C5_MIN_RECALL and rec < C5_MIN_RECALL[name]:
            raise AssertionError(f"config 5 {name}: recall@10 {rec:.4f} < {C5_MIN_RECALL[name]}")
    kw16 = dict(C5_RUNGS[0][1])
    profile = profile_pass(lambda: searcher.search(queries, k=10, **kw16))

    sub = queries[:AB_QUERIES]
    fused = searcher.search(sub, k=10, **kw16)
    inline = searcher.search(sub, k=10, **dict(kw16, hop_merge="inline"))
    if not (torch.equal(fused[0], inline[0]) and torch.equal(fused[1], inline[1])):
        raise AssertionError("config 5: fused and inline hop-merge disagree")
    stored = searcher.search(queries, k=10, **kw16)
    providers = [InMemoryEmbeddingProvider(idx.x_prepped[s]).embed for s in range(C5_SHARDS)]
    recompute = ArchipelagoSearcher(idx, exact_scorer=make_recompute_scorer(metric),
                                    exact_ctx=providers).search(queries, k=10, **kw16)
    if not (torch.equal(stored[0], recompute[0]) and torch.equal(stored[1], recompute[1])):
        raise AssertionError("config 5: the recompute gate differs from the stored gate")
    log(f"  fused == inline on {AB_QUERIES} queries; the recompute gate over per-shard "
        "InMemoryEmbeddingProviders == the stored gate")
    launches = read_launches()

    scratch = pathlib.Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    free_gb = shutil.disk_usage(scratch).free / 1e9
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        path = pathlib.Path(tmp) / "archipelago.shrd"
        t0 = time.perf_counter()
        nbytes = save_sharded(idx, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_sharded(path, mesh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    loaded_searcher = ArchipelagoSearcher(loaded)
    for name, kw in (C5_RUNGS[0], C5_RUNGS[2]):
        a = loaded_searcher.search(queries, k=10, **kw)
        b = searcher.search(queries, k=10, **kw)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"config 5: the loaded archipelago differs at {name}")
    del loaded, loaded_searcher
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  save_sharded {save_s:.3f} s, load_sharded {load_s:.3f} s, {nbytes / n:.2f} file "
        f"bytes/vector ({free_gb:.1f} GB free before); loaded == in-memory at p16 and exact; "
        f"peak device memory {peak_gb:.2f} GB")
    log(f"  kernel launches on the config-5 path: {launches}")
    if launches["hop_merge"] <= 0:
        raise AssertionError("the config-5 path never launched the hop_merge kernel")
    return dict(n=n, shards=C5_SHARDS, n_prefix=n_prefix, reindex=C5_REINDEX,
                n_local=idx.n_local, build_seconds=build_s, build_shard_seconds=build_shard_s,
                extend_seconds=extend_s, extend_shard_seconds=extend_shard_s,
                graph_bytes_per_vector=graph_bytes / n, file_bytes_per_vector=nbytes / n,
                save_seconds=save_s, load_seconds=load_s, rungs=rungs, headline_profile=profile,
                peak_device_gb=peak_gb, launches=launches)


def phase_refine(x, queries) -> dict:
    """One refine pass on the sketch path against none, at REFINE_N rows:
    the invariants, the share of rows the pass rewrote, and recall@10 at
    REFINE_POINTS, the low ones where the unrefined graph is short of 1."""
    xs = x[:REFINE_N]
    metric = C2_CONFIG.metric
    _, true_ids = brute_force_topk(queries, xs, 10, metric, batch=65536)
    zero_launches()
    out, graphs = {}, []
    for passes in (0, 1):
        cfg = dataclasses.replace(C2_CONFIG, refine_passes=passes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph, sketch = build_index_with_sketch(xs, cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        graph.validate()
        graph_invariants(graph.neighbors, graph.degrees, REFINE_N, f"refine_passes={passes}")
        graphs.append(graph)
        searcher = StoredSearcher(graph, xs, metric, sketch=sketch, routing_size=65536)
        recalls = {}
        for name, kw in REFINE_POINTS:
            d, ids = searcher.search(queries, k=10, **kw)
            check_results(f"refine_passes={passes} {name}", d, ids, xs, queries, metric)
            recalls[name] = recall_at_10(ids, true_ids)
        out[passes] = dict(build_seconds=build_s, recall=recalls)
        log(f"  refine_passes={passes}: build {build_s:.3f} s, invariants hold, recall@10 "
            + ", ".join(f"{k} {v:.4f}" for k, v in recalls.items()))
    rewritten = float((graphs[0].neighbors != graphs[1].neighbors).any(dim=1).float().mean())
    gains = {name: out[1]["recall"][name] - out[0]["recall"][name] for name, _ in REFINE_POINTS}
    log(f"  the refine pass rewrote {rewritten:.4f} of the rows; recall gains "
        + ", ".join(f"{k} {v:+.4f}" for k, v in gains.items())
        + " (the reference read +0.035 at 131k on its chip)")
    if rewritten == 0.0:
        raise AssertionError("the refine pass left every row as it was")
    for name, gain in gains.items():
        if gain < -REFINE_MAX_LOSS:
            raise AssertionError(f"the refined graph loses {-gain:.4f} of recall at {name}")
    return dict(n=REFINE_N, passes=out, rows_rewritten=rewritten, recall_gain=gains,
                launches=read_launches())


def _git(args, cwd) -> None:
    subprocess.run(["git", *args], cwd=cwd, check=True, capture_output=True, timeout=120,
                   env={"GIT_AUTHOR_NAME": "smoke", "GIT_AUTHOR_EMAIL": "smoke@localhost",
                        "GIT_COMMITTER_NAME": "smoke", "GIT_COMMITTER_EMAIL": "smoke@localhost",
                        "PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(cwd)})


def service_round(cfg: IndexerConfig, src: pathlib.Path, name: str, mode: str) -> dict:
    """A service on `cfg` indexes `src` and answers SERVICE_QUERIES at top
    10 (finite hits); a fresh service on the base path must answer the
    same."""
    svc = IndexerService(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = svc.index_local_path(src, name)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hits = [svc.search(q, top_k=10) for q in SERVICE_QUERIES]
    query_ms = (time.perf_counter() - t0) * 1e3 / len(SERVICE_QUERIES)
    if not all(len(h) == 10 and all(math.isfinite(r["score"]) for r in h) for h in hits):
        raise AssertionError(f"service ({mode}): a query did not return 10 finite hits")
    fresh = IndexerService(cfg)
    if [fresh.search(q, top_k=10) for q in SERVICE_QUERIES] != hits:
        raise AssertionError(f"service ({mode}): a fresh service answers differently")
    log(f"  {mode}: indexed {info.num_files} files, {info.num_chunks} chunks in "
        f"{index_s:.3f} s; {query_ms:.1f} ms per query (16 queries, top 10); "
        f"index.leann {info.size_bytes / info.num_chunks:.2f} B/chunk; a fresh "
        "service on the base path returns identical hits")
    return dict(chunks=info.num_chunks, files=info.num_files, index_seconds=index_s,
                query_ms=query_ms, size_bytes=info.size_bytes)


def phase_service(root: pathlib.Path) -> dict:
    """IndexerService with minilm-l6 on the card over the checkout, stored
    and recompute: index, 16 queries, the same answers from a fresh service
    on the base path; then a local git origin added, committed to and
    synced (which re-indexes)."""
    zero_launches()
    out = {}
    scratch = root / "build"
    scratch.mkdir(exist_ok=True)
    # A hidden directory, which the file walker skips: the service's own
    # files stay out of the corpus it indexes.
    with tempfile.TemporaryDirectory(dir=scratch, prefix=".service-") as tmp:
        for mode in ("stored", "recompute"):
            cfg = IndexerConfig(base_path=str(pathlib.Path(tmp) / mode), embedding=EmbeddingConfig(
                kind="encoder", model="minilm-l6", recompute=mode == "recompute"))
            out[mode] = service_round(cfg, root, "checkout", mode)
        origin = pathlib.Path(tmp) / "origin"
        shutil.copytree(root / "islands_tpu_torch" / "indexer", origin,
                        ignore=shutil.ignore_patterns("__pycache__"))
        _git(["init", "-b", "main"], origin)
        _git(["add", "-A"], origin)
        _git(["commit", "-m", "init"], origin)
        svc = IndexerService(IndexerConfig(base_path=str(pathlib.Path(tmp) / "git"),
                                           embedding=EmbeddingConfig(kind="encoder",
                                                                     model="minilm-l6")))
        t0 = time.perf_counter()
        info = svc.add_repository("github:smoke/origin", clone_url=str(origin))
        add_s = time.perf_counter() - t0
        (origin / "extra_feature.py").write_text("def extra_feature():\n    return 'synced'\n")
        _git(["add", "-A"], origin)
        _git(["commit", "-m", "feature"], origin)
        t0 = time.perf_counter()
        if svc.sync_repository("smoke/origin") is not True:
            raise AssertionError("service: sync after a commit did not re-index")
        sync_s = time.perf_counter() - t0
        info2 = svc.get_index("smoke_origin")
        if info2.commit == info.commit or info2.num_chunks <= info.num_chunks:
            raise AssertionError("service: the re-index missed the new commit")
        if svc.sync_repository("smoke/origin") is not False:
            raise AssertionError("service: a sync with no new commit re-indexed")
        log(f"  git: add_repository {add_s:.3f} s ({info.num_chunks} chunks), commit, "
            f"sync_repository re-indexed in {sync_s:.3f} s ({info2.num_chunks} chunks)")
        out["git"] = dict(add_seconds=add_s, sync_seconds=sync_s, chunks=info2.num_chunks)
    out["launches"] = read_launches()
    log(f"  kernel launches on the service path: {out['launches']}")
    return out


def run_cli(argv) -> str:
    """islands_tpu_torch.cli.main(argv) in this process; its stdout. Fails
    unless it exits 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"islands-tpu-torch {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def phase_cli_engine(tmp: pathlib.Path) -> dict:
    """12a: the CLI's build, query and eval at config 4's width, on the
    card; then the same searches called directly, and the ground truth."""
    x_all, queries = make_corpus(C4_N, C4_DIM, C4_QUERIES, seed=1)
    x = x_all[:CLI_N].clone()
    del x_all
    xp, qp, idxp = str(tmp / "x.npy"), str(tmp / "q.npy"), str(tmp / "index.leann")
    np.save(xp, x.cpu().numpy())
    np.save(qp, queries.cpu().numpy())
    torch.cuda.synchronize()

    zero_launches()
    t0 = time.perf_counter()
    line = run_cli(["build", xp, "-o", idxp] + CLI_BUILD_FLAGS)
    build_wall_s = time.perf_counter() - t0
    m = re.search(r"built (\d+) vectors in ([\d.]+)s \((\d+) vec/s\)", line)
    if m is None or int(m.group(1)) != CLI_N:
        raise AssertionError(f"build printed {line!r}")
    log(f"  build {CLI_N}x{C4_DIM} --pq 16x256: {line.strip()} (wall {build_wall_s:.3f} s "
        f"with the load and save)")
    runs = []
    for name, flags, kw in CLI_KNOBS:
        t0 = time.perf_counter()
        got = json.loads(run_cli(["query", idxp, xp, qp] + flags))
        query_wall_s = time.perf_counter() - t0
        ev = json.loads(run_cli(["eval", idxp, xp, qp] + flags))
        runs.append(dict(name=name, flags=flags, kw=kw, query=got, eval=ev,
                         query_wall_s=query_wall_s))
        log(f"  {name} {' '.join(flags)}: eval {json.dumps(ev)}; query command "
            f"{query_wall_s:.3f} s wall")
    launches = read_launches()
    log(f"  kernel launches on the CLI's engine commands: {launches}")
    if launches["gated_adc"] <= 0:
        raise AssertionError("the CLI's query/eval never launched kernel K2")
    if any(n for name, n in launches.items() if name != "gated_adc"):
        raise AssertionError(f"the CLI's path launched kernels besides K2: {launches}")

    # The same searches called directly, and the ground truth eval uses.
    idx = load_index(idxp)
    provider = InMemoryEmbeddingProvider(x)
    _, true_ids = brute_force_topk(queries, x, 10, DistanceMetric.EUCLIDEAN, batch=65536)
    out = dict(n=CLI_N, dim=C4_DIM, queries=C4_QUERIES, e=CLI_E,
               build_printed=line.strip(), build_seconds=float(m.group(2)),
               build_vectors_per_s=int(m.group(3)), build_wall_seconds=build_wall_s,
               launches=launches, rungs=[])
    for run in runs:
        d, ids = idx.search_two_level(queries, k=10, provider=provider, **run["kw"])
        got_ids = torch.tensor(run["query"]["ids"], dtype=torch.int32)
        got_d = torch.tensor(run["query"]["distances"], dtype=torch.float32)
        if not (torch.equal(got_ids, ids.cpu()) and torch.equal(got_d, d.cpu())):
            raise AssertionError(f"{run['name']}: the CLI's query differs from "
                                 "search_two_level with the same knobs")
        err = check_results(f"cli {run['name']}", d, ids, x, queries, DistanceMetric.EUCLIDEAN)
        rec = recall_at_10(ids, true_ids)
        if abs(run["eval"]["recall"] - rec) > 1e-4:
            raise AssertionError(f"{run['name']}: eval's recall {run['eval']['recall']} is not "
                                 f"the recall of query's ids, {rec:.6f}")
        out["rungs"].append(dict(name=run["name"], flags=run["flags"], recall=rec,
                                 eval_recall=run["eval"]["recall"], qps=run["eval"]["qps"],
                                 query_wall_seconds=run["query_wall_s"], max_abs_dist_err=err))
        log(f"  {run['name']}: query == search_two_level (ids and distances), recall@10 "
            f"{rec:.4f} == eval's {run['eval']['recall']}, QPS {run['eval']['qps']}")
    # K2's device time per launch on this path (real codes at E = 240).
    kw = CLI_KNOBS[-1][2]
    events = _device_events(lambda: idx.search_two_level(queries, k=10, provider=provider,
                                                         **kw), 1)
    hits = [e for e in events if "gated_adc_kernel" in e.key]
    count = sum(e.count for e in hits)
    if count == 0:
        raise AssertionError("the profiler saw no K2 launch in the CLI's search")
    out["k2_ms_per_launch"] = sum(e.self_device_time_total for e in hits) / count / 1e3
    out["k2_launches_per_search"] = count
    log(f"  K2 on the path (B={C4_QUERIES}, E={CLI_E}, S=16, K=256): "
        f"{out['k2_ms_per_launch']:.4f} ms per launch on the device, {count} launches in "
        f"one search at {CLI_KNOBS[-1][0]}")
    return out


def phase_cli_repo(root: pathlib.Path, tmp: pathlib.Path) -> tuple[dict, pathlib.Path, dict]:
    """12b: the repository commands over a minilm-l6 service on the card,
    from a config file the fallback YAML parser reads. Returns the figures,
    the config file and the search hits per query."""
    base = tmp / "islands"
    cfg_path = tmp / "islands.yaml"
    text = (f"# phase 12b\nbase_path: {base}\nembedding_kind: encoder\n"
            "embedding_model: minilm-l6\n")
    cfg_path.write_text(text)
    if _parse_simple_yaml(text) != {"base_path": str(base), "embedding_kind": "encoder",
                                    "embedding_model": "minilm-l6"}:
        raise AssertionError("the fallback YAML parser misreads the config file")
    cfg = Config.from_file(cfg_path)
    g = ["--config", str(cfg_path)]
    origin = tmp / "origin"
    shutil.copytree(root / "islands_tpu_torch" / "indexer", origin,
                    ignore=shutil.ignore_patterns("__pycache__"))
    _git(["init", "-b", "main"], origin)
    _git(["add", "-A"], origin)
    _git(["commit", "-m", "init"], origin)

    zero_launches()
    t0 = time.perf_counter()
    line = run_cli(g + ["add", str(origin)])
    add_s = time.perf_counter() - t0
    if "indexed origin:" not in line:
        raise AssertionError(f"add printed {line!r}")
    # `add` clones only from a provider URL, so the tracked clone that `sync`
    # follows is made here, from the local origin.
    IndexerService(cfg.indexer_config()).add_repository("github:smoke/origin",
                                                        clone_url=str(origin))
    (origin / "extra_feature.py").write_text("def extra_feature():\n    return 'synced'\n")
    _git(["add", "-A"], origin)
    _git(["commit", "-m", "feature"], origin)
    outs = {}
    for key, argv in [
            ("sync one", ["sync", "smoke_origin"]), ("sync all", ["sync"]),
            ("ws create", ["workspace", "create", "ws", "--description", "smoke"]),
            ("ws add-repo", ["workspace", "add-repo", "ws", "smoke/origin"]),
            ("ws list", ["workspace", "list"]), ("ws delete", ["workspace", "delete", "ws"]),
            ("list", ["list", "--format", "json"]), ("status", ["status", "--format", "json"]),
            ("config", ["config", "show"])]:
        outs[key] = run_cli(g + argv)
    for key, want in [("sync one", "smoke_origin: re-indexed"),
                      ("sync all", "synced all; 0 re-indexed"), ("ws list", "ws: 1 repos")]:
        if want not in outs[key]:
            raise AssertionError(f"{key} printed {outs[key]!r}")
    names = sorted(i["name"] for i in json.loads(outs["list"]))
    status = json.loads(outs["status"])
    if names != ["origin", "smoke_origin"] or status["num_indexes"] != 2:
        raise AssertionError(f"list/status disagree with the two indexes: {names}, {status}")
    if outs["config"] != cfg.to_yaml() + "\n":
        raise AssertionError("config show printed another config than the file's")
    hits, search_s = {}, []
    for q in CLI_QUERIES:
        t0 = time.perf_counter()
        hits[q] = json.loads(run_cli(g + ["search", q, "--format", "json"]))
        search_s.append(time.perf_counter() - t0)
    with unittest.mock.patch.dict(os.environ):
        os.environ.pop("OPENAI_API_KEY", None)
        answer = run_cli(g + ["ask", "how is a repository cloned and synced"])
    if "(mock)" not in answer:
        raise AssertionError(f"ask printed {answer!r}")
    launches = read_launches()
    svc = IndexerService(cfg.indexer_config())
    for q in CLI_QUERIES:
        want = json.loads(json.dumps(svc.search(q, top_k=10)))
        if hits[q] != want or len(want) != 10:
            raise AssertionError(f"search {q!r}: the CLI's JSON differs from "
                                 "IndexerService.search on the same base path")
    log(f"  add {add_s:.3f} s; sync re-indexed after a commit; workspace, list, status, "
        f"config show and ask (mock LLM) as expected; {len(CLI_QUERIES)} search commands "
        f"{1e3 * sum(search_s) / len(search_s):.1f} ms each (a fresh service each), JSON == "
        f"IndexerService.search; kernel launches: {launches}")
    return (dict(add_seconds=add_s, search_command_ms=[1e3 * t for t in search_s],
                 indexes=names, chunks=status["total_chunks"], launches=launches),
            cfg_path, hits)


MCP_HIT = re.compile(r"^## (.+):(\d+) \(score (-?\d+\.\d+), index (.+)\)$")


def phase_mcp(root: pathlib.Path, cfg_path: pathlib.Path, hits: dict) -> dict:
    """12c: `python -m islands_tpu_torch.cli --config <file> mcp` as a
    subprocess on the card over pipes: the protocol's requests, a malformed
    line and shutdown; stdout holds JSON-RPC lines alone, and islands_search
    returns 12b's hits."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("ISLANDS_") and k != "OPENAI_API_KEY"}
    err_path = cfg_path.parent / "mcp.stderr"
    lines: queue.Queue = queue.Queue()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "islands_tpu_torch.cli", "--config", str(cfg_path), "mcp"],
            cwd=root, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
            text=True, bufsize=1)
    reader = threading.Thread(target=lambda: [lines.put(l) for l in proc.stdout] + [
        lines.put(None)], daemon=True)
    reader.start()

    def request(obj_or_text, want_reply=True):
        text = obj_or_text if isinstance(obj_or_text, str) else json.dumps(obj_or_text)
        proc.stdin.write(text + "\n")
        proc.stdin.flush()
        if not want_reply:
            return None
        line = lines.get(timeout=MCP_TIMEOUT_S)
        if line is None:
            raise AssertionError(f"the MCP server closed stdout (see {err_path})")
        resp = json.loads(line)  # a stray non-JSON line fails here
        if resp.get("jsonrpc") != "2.0" or ("result" in resp) == ("error" in resp):
            raise AssertionError(f"the MCP server wrote a line that is no JSON-RPC "
                                 f"response: {line!r}")
        return resp

    def call(id, name, arguments=None):
        return request({"jsonrpc": "2.0", "id": id, "method": "tools/call",
                        "params": {"name": name, "arguments": arguments or {}}})

    def searched(resp):
        text = resp["result"]["content"][0]["text"]
        return [MCP_HIT.match(l).groups() for l in text.splitlines() if l.startswith("## ")]

    try:
        t0 = time.perf_counter()
        init = request({"jsonrpc": "2.0", "id": 1, "method": "initialize",
                        "params": {"protocolVersion": "2024-11-05"}})
        start_s = time.perf_counter() - t0
        if init.get("id") != 1 or init["result"]["protocolVersion"] != "2024-11-05":
            raise AssertionError(f"initialize answered {init}")
        request({"jsonrpc": "2.0", "method": "notifications/initialized"}, want_reply=False)
        tools = request({"jsonrpc": "2.0", "id": 2, "method": "tools/list"})
        if tools.get("id") != 2 or len(tools["result"]["tools"]) != 6:
            raise AssertionError(f"tools/list answered {tools}")
        call_ms, first_ms = [], None
        for rep in range(2):  # the first pass loads the encoder and the indexes
            for i, q in enumerate(CLI_QUERIES):
                t0 = time.perf_counter()
                resp = call(100 * (rep + 1) + i, "islands_search", {"query": q, "top_k": 10})
                ms = (time.perf_counter() - t0) * 1e3
                if rep == 0 and i == 0:
                    first_ms = ms
                elif rep == 1:
                    call_ms.append(ms)
                want = [(h["path"], str(h["start_line"]), f"{h['score']:.3f}", h["index"])
                        for h in hits[q]]
                if resp["result"].get("isError") or searched(resp) != want:
                    raise AssertionError(f"islands_search {q!r} answered other hits than "
                                         "the CLI's search")
        listed = call(300, "islands_list")
        status = json.loads(call(301, "islands_status")["result"]["content"][0]["text"])
        bad = request("{not json")
        if ("origin" not in listed["result"]["content"][0]["text"]
                or status["num_indexes"] != 2 or bad["error"]["code"] != -32700
                or bad["id"] is not None):
            raise AssertionError(f"islands_list/status or the parse error answered wrong: "
                                 f"{listed}, {status}, {bad}")
        down = request({"jsonrpc": "2.0", "id": 999, "method": "shutdown"})
        if down != {"jsonrpc": "2.0", "id": 999, "result": None}:
            raise AssertionError(f"shutdown answered {down}")
        rc = proc.wait(timeout=60)
        rest = []
        while (line := lines.get(timeout=60)) is not None:
            rest.append(line)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0 or rest:
        raise AssertionError(f"the MCP server exited {rc} with {len(rest)} stray stdout "
                             f"lines (see {err_path})")
    out = dict(start_to_initialize_ms=start_s * 1e3, first_search_ms=first_ms,
               search_call_ms=call_ms,
               search_call_ms_mean=sum(call_ms) / len(call_ms), exit_code=rc)
    log(f"  MCP subprocess: initialize answered after {start_s * 1e3:.1f} ms; "
        f"tools/call islands_search {out['search_call_ms_mean']:.1f} ms per call warm "
        f"({first_ms:.1f} ms for the first, which loads the encoder and indexes), hits == "
        "the CLI's; list, status, a parse error and shutdown as expected; exit 0, "
        "stdout JSON-RPC only")
    return out


def phase_span() -> dict:
    """12d: a span with block_on around one K2 launch at the CLI path's
    shape records at least the launch's device time by CUDA events, alone
    and with about 2 ms of device work queued before it."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    tables, codes = adc_inputs(gen, C4_QUERIES, 16, 256, (C4_QUERIES, CLI_E))
    gated_adc_sums(tables, codes)
    out = {}
    for name, delay in (("alone", 0), ("after a delay", SPAN_DELAY_CYCLES)):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        key = f"chip_smoke.k2 {name}"
        result = []
        with span(key, block_on=result):
            start.record()
            if delay:
                torch.cuda._sleep(delay)
            result.append(gated_adc_sums(tables, codes))
            stop.record()
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(stop)
        span_ms = metrics.snapshot()["timings"][key]["total_s"] * 1e3
        if span_ms < event_ms:
            raise AssertionError(f"span {name}: {span_ms:.4f} ms < the device's "
                                 f"{event_ms:.4f} ms: it did not wait for the card")
        out[name] = dict(span_ms=span_ms, event_ms=event_ms)
        log(f"  span over one K2 launch {name}: {span_ms:.4f} ms >= {event_ms:.4f} ms by "
            "CUDA events")
    return out


def phase_cli(root: pathlib.Path) -> dict:
    """Phase 12: 12a-d in a hidden temporary directory under build/, with
    no ISLANDS_* or OPENAI_API_KEY variable from the caller's environment."""
    scratch = root / "build"
    scratch.mkdir(exist_ok=True)
    with unittest.mock.patch.dict(os.environ), \
            tempfile.TemporaryDirectory(dir=scratch, prefix=".cli-") as tmp:
        for k in [k for k in os.environ if k.startswith("ISLANDS_") or k == "OPENAI_API_KEY"]:
            del os.environ[k]
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        engine = phase_cli_engine(tmp)
        torch.cuda.empty_cache()
        log(f"  12a: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        repo, cfg_path, hits = phase_cli_repo(root, tmp)
        log(f"  12b: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mcp = phase_mcp(root, cfg_path, hits)
        log(f"  12c: {time.perf_counter() - t0:.1f} s")
        traced = phase_span()
    launches = {k: engine["launches"][k] + repo["launches"][k] for k in engine["launches"]}
    return dict(engine=engine, repository=repo, mcp=mcp, span=traced, launches=launches)


def modernbert_check_tokens(vocab: int):
    """MB_CHECK_ROWS rows of MB_CHECK_SEQ ids drawn as the encoder bench
    draws them; every other row is padded to a length in [seq / 2, seq)."""
    rows, slen = MB_CHECK_ROWS, MB_CHECK_SEQ
    rng = np.random.default_rng(13)
    ids = rng.integers(1, vocab, size=(rows, slen))
    lens = np.where(np.arange(rows) % 2 == 0, slen, rng.integers(slen // 2, slen, rows))
    mask = (np.arange(slen)[None, :] < lens[:, None]).astype(np.int32)
    return torch.from_numpy((ids * mask).astype(np.int32)), torch.from_numpy(mask)


def provider_chunk_probe(enc: TextEncoder, slen: int) -> dict:
    """One encode at the recompute provider's chunk (batch size x
    EMBED_CHUNK_BATCHES rows of `slen` tokens): the device memory it adds at
    its peak, its attention kernels (V1's on ModernBERT's packed route, or
    the backend scaled_dot_product_attention took) and its largest
    kernels."""
    rows = enc.config.batch_size * EMBED_CHUNK_BATCHES
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(1, enc.model_config.vocab_size, (rows, slen), generator=gen,
                        device="cuda", dtype=torch.int32)
    mask = torch.ones_like(ids)
    mask[1::2, slen // 2:] = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bert_mod.encode(enc.model, ids, mask)
    torch.cuda.synchronize()
    added_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    events = sorted(_device_events(lambda: bert_mod.encode(enc.model, ids, mask), 1),
                    key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    attention = [dict(kernel=e.key[:120], ms=e.self_device_time_total / 1e3, count=e.count)
                 for e in events if re.search(r"varlen_attn|attention|fmha|flash|cudnn|softmax", e.key, re.I)]
    top = [dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3, count=e.count)
           for e in events[:8]]
    log(f"  one encode at the provider's chunk, {rows} x {slen} tokens (every other row "
        f"half padding): adds {added_gb:.3f} GB at its peak; device {busy_ms:.3f} ms")
    for r in attention:
        log(f"    attention: {r['ms']:9.3f} ms  x{r['count']:<4d} {r['kernel']}")
    for r in top:
        log(f"    {r['ms']:9.3f} ms  x{r['count']:<5d} {r['kernel']}")
    if not attention:
        raise AssertionError("the profiler saw no attention kernel in the encode")
    return dict(rows=rows, seq_len=slen, added_peak_gb=added_gb, device_ms=busy_ms,
                attention=attention, top=top)


def phase_modernbert_encoder() -> dict:
    """13a: the encoder bench in both modes; modernbert-base on the card
    against the CPU's float32 forward; the provider's chunk."""
    zero_launches()
    bench = {mode: encoder_bench.main(mode) for mode in ("default", "modernbert")}
    for row in bench["default"]["rows"] + bench["modernbert"]["rows"]:
        if not (row["tokens_per_s"] > 0 and math.isfinite(row["mfu"])):
            raise AssertionError(f"encoder bench: a bad row {row}")
        log(f"  bench {row['model']} b={row['batch']} seq {row['seq']}: "
            f"{row['tokens_per_s']:.1f} tokens/s, {row['texts_per_s']:.2f} texts/s, "
            f"{row['ms_per_batch']:.3f} ms a batch, {100 * row['mfu']:.2f}% of "
            f"{encoder_bench.PEAK_BF16 / 1e12:.0f} TFLOP/s")
    enc = TextEncoder.from_preset(MB_PRESET, seed=0)
    cfg = enc.model_config
    kinds = ["global" if layer.is_global else "local" for layer in enc.model.layers]
    if (enc.architecture is not ModelArchitecture.MODERNBERT or cfg.hidden_size != 768
            or len(kinds) != 22 or cfg.local_attention != 128 or cfg.intermediate_size != 1152):
        raise AssertionError(f"{MB_PRESET}: not the published width: {cfg}")
    log(f"  {MB_PRESET}: {len(kinds)} layers ({kinds.count('global')} global, "
        f"{kinds.count('local')} local, window {cfg.local_attention}), hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, GeGLU {cfg.intermediate_size}, "
        f"RoPE theta {cfg.global_rope_theta:.0f} / {cfg.local_rope_theta:.0f}, "
        f"{enc.model.dtype}")
    ids, mask = modernbert_check_tokens(cfg.vocab_size)
    check = encoder_card_vs_cpu(enc, ids, mask, f"{MB_PRESET} at seq {MB_CHECK_SEQ}")
    probe = provider_chunk_probe(enc, C1_PAD)
    launches = read_launches()
    log(f"  kernel launches on the encoder path: {launches}")
    return dict(bench=bench, layers=kinds, encoder_check=check, provider_chunk=probe,
                launches=launches)


def phase_modernbert_service(root: pathlib.Path) -> dict:
    """13c: the service that Config(embedding_model="modernbert-base")
    configures, stored and recompute, over MB_SERVICE_DIR."""
    zero_launches()
    out = {}
    scratch = root / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch, prefix=".service-mb-") as tmp:
        for mode in ("stored", "recompute"):
            cfg = Config(base_path=str(pathlib.Path(tmp) / mode), embedding_kind="encoder",
                         embedding_model=MB_PRESET,
                         embedding_recompute=mode == "recompute").indexer_config()
            out[mode] = service_round(cfg, root / MB_SERVICE_DIR, "core", mode)
    out["launches"] = read_launches()
    log(f"  kernel launches on the service path: {out['launches']}")
    return out


@contextlib.contextmanager
def counting_packed_layers():
    """Counts, in the list it yields, the packed forwards ModernBERT runs on
    the card and their layers (one V1 launch each)."""
    real = ModernBertModel.hidden_packed
    seen = [0, 0]

    def hidden_packed(self, ids, segs):
        if ids.is_cuda and ids.numel():
            seen[0] += 1
            seen[1] += len(self.layers)
        return real(self, ids, segs)

    with unittest.mock.patch.object(ModernBertModel, "hidden_packed", hidden_packed):
        yield seen


def phase_modernbert(root: pathlib.Path) -> dict:
    """Phase 13: ModernBERT on the card through the bench, config 1 and the
    service; each of the three runs the packed forward, launches V1 once a
    layer of each forward (22 a forward) and no other kernel of the port."""
    out = {}
    for label, part, run in (
            ("13a", "encoder", phase_modernbert_encoder),
            ("13b", "config1", lambda: phase_config1(root, MB_PRESET, MB_C1_QUERIES,
                                                     MB_C1_PASSES, check_rows=None)),
            ("13c", "service", lambda: phase_modernbert_service(root))):
        t0 = time.perf_counter()
        log(f"  {label}: {part}")
        with counting_packed_layers() as seen:
            out[part] = run()
        torch.cuda.empty_cache()
        launches = out[part]["launches"]
        forwards, layers = seen
        others = {name: n for name, n in launches.items() if name != "varlen_attention" and n}
        if others or forwards == 0 or launches["varlen_attention"] != layers:
            raise AssertionError(f"phase {label}: {forwards} packed forwards of {layers} "
                                 f"layers on the card, kernel launches {launches}")
        out[part]["packed_forwards"] = forwards
        log(f"  {label}: {time.perf_counter() - t0:.1f} s, {forwards} packed forwards, "
            f"{layers} varlen_attention launches ({layers / forwards:.0f} a forward), no "
            f"other kernel launched")
    return out


def build_kernels() -> None:
    """nvcc every source at once (one process each) and log what ptxas says
    of its kernels' registers and shared memory."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        outs = dict(zip(SOURCES, pool.map(_cuda.build, SOURCES)))
    log(f"  nvcc built {', '.join(SOURCES)} in {time.perf_counter() - t0:.2f} s")
    # Dynamic shared memory per block, as each launcher sizes it at the
    # paths' shapes (ptxas reports static shared memory only).
    smem = {"hop_merge": ("none on the warp route (E=120, A=64 or 128: registers and "
                          "shuffles); E*12 + L*8 B on the block route"),
            "gated_adc": f"{16 * 256 * 4} B at S=16, K=256",
            "adc_scan": (f"route sums: {4 * 16 * 256 * 4} B at 4 queries per block, S=16, "
                         f"K=256; route smallest: the same tables and 4 lists of "
                         f"next_pow2(r) kept and max(512, next_pow2(r)) new 8-byte keys "
                         f"({4 * 16 * 256 * 4 + 4 * 768 * 8} B at r = 256, "
                         f"{4 * 16 * 256 * 4 + 4 * 2048 * 8} B at r = 1024), its merge "
                         f"next_pow2(tiles) lists of next_pow2(r) keys "
                         f"({2 * 256 * 8} B at B = 512, N = 1M, r = 256: 2 tiles)"),
            "pairwise": (f"{3 * 2 * 128 * 32 * 4 + 2 * 128 * 32 * 4 + 128 * 4 + 1024} B: "
                         "three stages of 128x32 q and x slices, two x small tiles, the x "
                         "norms and 1 KB of alignment (one block per SM)"),
            "row_gather": "none"}
    for name, out in outs.items():
        for line in out.splitlines():
            if any(w in line for w in ("registers", "smem", "spill", "wgmma", "Warning")):
                log(f"  {name}: {line.strip()}")
        log(f"  {name}: dynamic shared memory {smem[name]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="corpus size: a depth cut for quick checks")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the GPU",
              file=sys.stderr)
        return 1
    # The port under test is the one beside this script, not an installed copy.
    here = pathlib.Path(__file__).resolve().parent
    if pathlib.Path(islands_tpu_torch.__file__).resolve().parent.parent != here:
        print(f"chip_smoke: islands_tpu_torch at {islands_tpu_torch.__file__} is not "
              f"the checkout's ({here})", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("phase 1: build the kernels")
    build_kernels()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6
    log(f"  {sms} SMs, max SM clock {clock_hz / 1e6:.0f} MHz")

    log("phase 2: kernels against their plain versions")
    k1 = phase_hop_merge()
    k2, k3 = phase_adc(sms, clock_hz)
    k3s = phase_adc_smallest(sms, clock_hz)
    k4a, k4b = phase_pairwise()
    k5 = phase_row_gather()
    v1 = phase_varlen()
    v1["kinds"] += phase_varlen_gqa()
    m1 = phase_moe()
    topk = phase_smallest_k()
    torch.cuda.empty_cache()
    log(f"  phases 1-2: {time.perf_counter() - t_start:.1f} s")

    log(f"phase 3: config 2 at {args.n}x{DIM}, {QUERIES} queries")
    config2, (x, queries, true_ids) = phase_main_path(args.n)
    torch.cuda.empty_cache()
    log(f"phase 4: config 4 at {C4_N}x{C4_DIM}, {C4_QUERIES} queries")
    config4 = phase_config4()
    torch.cuda.empty_cache()
    log(f"  phases 1-4: {time.perf_counter() - t_start:.1f} s")
    log(f"phase 5: the gather bench at {GATHER_N}x{GATHER_D}; the ops API over phase 3's corpus")
    bench = phase_gather_bench()
    torch.cuda.empty_cache()
    ops_api = phase_ops_api(x, queries)
    log(f"  phases 1-5: {time.perf_counter() - t_start:.1f} s")
    metric = C2_CONFIG.metric
    log(f"phase 6: the index lifecycle at {x.shape[0]}x{DIM}")
    lifecycle = phase_lifecycle(x, queries, true_ids, metric, C2_CONFIG,
                                config2["headline_recall"])
    torch.cuda.empty_cache()
    log(f"  phases 1-6: {time.perf_counter() - t_start:.1f} s")
    hn = min(HNSW_N, x.shape[0])
    log(f"phase 7: HNSW at {hn}x{DIM} (the first rows of phase 3's corpus)")
    _, hnsw_true_ids = brute_force_topk(queries, x[:hn], 10, metric, batch=65536)
    hnsw = phase_hnsw(x[:hn], queries, hnsw_true_ids, metric)
    del hnsw_true_ids
    torch.cuda.empty_cache()
    log(f"  phases 1-7: {time.perf_counter() - t_start:.1f} s")
    t_phase = time.perf_counter()
    log(f"phase 8: config 3, recompute search at {C3_N} chunks x {C3_L} tokens, minilm-l6")
    config3 = phase_config3()
    torch.cuda.empty_cache()
    log(f"  phase 8: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    log("phase 9: config 1, the checkout's own source, bge-base")
    config1 = phase_config1(here)
    torch.cuda.empty_cache()
    log(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    log(f"phase 10: config 5, the archipelago at {x.shape[0]}x{DIM} as {C5_SHARDS} shards "
        "on one card")
    config5 = phase_sharded(x, queries, true_ids)
    torch.cuda.empty_cache()
    log(f"  phase 10: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    log(f"phase 10b: refine_passes 0 and 1 at {REFINE_N}x{DIM}")
    refine = phase_refine(x, queries)
    del x, queries, true_ids
    torch.cuda.empty_cache()
    log(f"  phase 10b: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    log("phase 11: the indexer service on the card, minilm-l6 over the checkout")
    service = phase_service(here)
    log(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    log(f"phase 12: the CLI at config 4's width ({CLI_N}x{C4_DIM}, PQ 16x256), its "
        "repository commands, the MCP server and a span")
    cli_path = phase_cli(here)
    log(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    log(f"phase 13: ModernBERT ({MB_PRESET}, full width): the encoder bench, config 1, "
        "the service")
    modernbert = phase_modernbert(here)
    log(f"  phase 13: {time.perf_counter() - t_phase:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    paths = {"config2": config2, "config4": config4, "ops_api": ops_api,
             "gather_bench": bench, "lifecycle": lifecycle, "hnsw": hnsw,
             "config3": config3, "config1": config1, "config5": config5, "refine": refine,
             "service": service, "cli": cli_path,
             **{f"modernbert_{part}": out for part, out in modernbert.items()}}
    kernels = []
    for name, fig in (("hop_merge", k1), ("gated_adc", k2), ("adc_scan", k3),
                      ("adc_scan_smallest", k3s), ("pairwise_l2", k4a), ("pairwise_neg_dot", k4b), ("row_gather", k5),
                      ("varlen_attention", v1), ("moe_gemm", m1)):
        _, source, replaces, _ = KERNELS[name]
        by_path = {path: out["launches"][name] for path, out in paths.items()}
        route = "cuda" if source.endswith(".cu") else "triton"
        kernels.append(dict(name=name, route=route, source=source, replaces=replaces,
                            launches=sum(by_path.values()), launches_by_path=by_path, **fig))
    print(json.dumps(dict(paths, smallest_k=topk, card=card,
                          seconds=time.perf_counter() - t_start)), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
