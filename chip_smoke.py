"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # config 2 at 1,000,000 x 128, config 4 at 1,000,000 x 768
    python3 chip_smoke.py --n 262144 # a smaller config-2 corpus (depth cut only)

Phases, each fatal on failure:
1. set-up: the card's name and power limit; build the port's three CUDA
   kernels from islands_tpu_torch/csrc (one nvcc each, all at once), with
   ptxas's registers and shared memory per kernel.
2. each kernel against its plain PyTorch version on the card, bit for bit,
   at its paths' shapes (ties and edge codes included), with its device time
   (torch.profiler, beside the CUDA-event time of the wrapper calls), the
   plain version's time, its bound and the time of one PyTorch library call
   that computes the same function, where there is one. Then smallest_k's two
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
   hop-merge) and search_pq_scan at rerank 128 and 256: recall@10 and QPS
   per rung, exact distances, grouped == einsum and fused == inline.
The kernels' launch counts are zeroed just before each path and read just
after it.

Prints a JSON line of path figures, one of kernel figures, the card's name
and power limit, and last `{"ok": true, "device": {...}}`. Exits non-zero,
with no result, when no CUDA device is present or the port cannot be
imported.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import pathlib
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

import islands_tpu_torch
from islands_tpu_torch.core.build import build_index_with_sketch
from islands_tpu_torch.core.config import DistanceMetric, LeannConfig, PQConfig
from islands_tpu_torch.core.embedding import InMemoryEmbeddingProvider
from islands_tpu_torch.core.leann import LeannIndex
from islands_tpu_torch.core.search import StoredSearcher
from islands_tpu_torch.ops import _cuda, merge
from islands_tpu_torch.ops.adc import (
    adc_scan,
    adc_scan_reference,
    gated_adc_reference,
    gated_adc_sums,
)
from islands_tpu_torch.ops.distance import brute_force_topk, rowwise_distance
from islands_tpu_torch.ops.hop_merge import hop_merge, hop_merge_reference

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and the
# non-tensor-core float32 rate, used for a kernel's bound. A shared-memory
# lookup runs at 32 per SM per clock (one 4-byte word per bank).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SMEM_LOOKUPS_PER_SM_CLOCK = 32

# Each kernel: its wrapper (whose `launches` counts launches), source, the
# TPU kernel it replaces and the CUDA kernel's name in the profiler.
KERNELS = {
    "hop_merge": (hop_merge, "islands_tpu_torch/csrc/hop_merge.cu",
                  "islands_tpu/ops/pallas_kernels.py:412", "hop_merge_kernel"),
    "gated_adc": (gated_adc_sums, "islands_tpu_torch/csrc/gated_adc.cu",
                  "islands_tpu/ops/pallas_kernels.py:135", "gated_adc_kernel"),
    "adc_scan": (adc_scan, "islands_tpu_torch/csrc/adc_scan.cu",
                 "islands_tpu/ops/pallas_kernels.py:52", "adc_scan_kernel"),
}

# bench.py's five primary rungs: (ef, promote, max_iters, expand_width,
# final_rescore).
RUNGS = [(32, 8, 12, 2, 64), (32, 16, 12, 2, 64), (32, 24, 12, 2, 64),
         (32, 48, 10, 2, 0), (32, 64, 10, 4, 0)]
HEADLINE = (32, 16, 12, 2, 64)
DIM, QUERIES = 128, 4096  # bench.py's width and query batch
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
PQ_SCAN_QUERIES, PQ_SCAN_RERANKS = 512, (128, 256)
AB_QUERIES = 512  # queries for the grouped/einsum and fused/inline checks

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


def kernel_device_ms(fn, kernel: str, reps: int) -> float:
    """Mean device time per launch of the CUDA kernel whose name contains
    `kernel`, over `reps` calls of fn, from torch.profiler. Raises if the
    profiler saw no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    count = sum(e.count for e in hits)
    if count == 0:
        raise AssertionError(f"the profiler saw no launch of {kernel}")
    return sum(e.self_device_time_total for e in hits) / count / 1e3


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
    config 2 (A = 64) and the two-level hop of config 4 (A = 128)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b = 4096
    max_err = 0.0
    for e, a, pw, ties in [(120, 64, 8, False), (120, 64, 16, False), (120, 64, 24, False),
                           (120, 64, 48, False), (240, 64, 64, False), (120, 64, 16, True),
                           (240, 64, 64, True), (120, 128, 16, False), (120, 128, 24, False),
                           (120, 128, 32, False), (120, 128, 16, True), (120, 128, 24, True),
                           (120, 128, 32, True)]:
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
        ms = kernel_device_ms(lambda: hop_merge(*args, pw), "hop_merge_kernel", 200)
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
    """K2 and K3 against their plain versions at config 4's shapes and odd
    ones, bit for bit; then their times beside bound, plain and library."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    k2_cases = [(f"B={b} E={e} S={s} K={k}", adc_inputs(gen, b, s, k, (b, e)))
                for b, e, s, k in [(4096, 120, 16, 256), (4096, 240, 16, 256), (24, 70, 8, 64)]]
    k3_cases = [(f"B={b} N={n} S={s} K={k} {dt}", adc_inputs(gen, b, s, k, (n,), dt))
                for b, n, s, k, dt in [(512, 1_000_000, 16, 256, torch.uint8),
                                       (3, 1000, 8, 32, torch.uint8),
                                       (5, 4099, 16, 512, torch.int32)]]
    k2_err = check_adc("gated_adc", gated_adc_sums, gated_adc_reference, k2_cases)
    k3_err = check_adc("adc_scan", adc_scan, adc_scan_reference, k3_cases)
    del k2_cases[1:], k3_cases[1:]

    out = []
    for name, fn, plain, library, kernel, (desc, (tables, codes)), err, bound in [
            ("gated_adc", gated_adc_sums, gated_adc_reference, gated_adc_library,
             "gated_adc_kernel", k2_cases[0], k2_err,
             gated_adc_bound_ms(4096, 120, 16, 256)),
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
    return out[0], out[1]


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


def phase_main_path(n) -> dict:
    dim, n_queries = DIM, QUERIES
    metric = DistanceMetric.EUCLIDEAN
    cfg = LeannConfig(metric=metric, wave_size=4096, sketch_dims=48,
                              ef_construction=64, reverse_slack=20)
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
                peak_device_gb=peak_gb, rungs=rungs, headline_profile=profile,
                launches=launches)


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
    for name, count in launches.items():
        if count <= 0:
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
    return dict(n=n, dim=dim, queries=n_queries, pq=dict(subquantizers=16, centroids=256),
                build_seconds=build_s, build_vectors_per_s=n / build_s,
                index_bytes_per_vector=bpv, peak_device_gb=peak_gb, rungs=rungs,
                reported_rung=reported["rung"], pq_scan=scans, headline_profile=profile,
                launches=launches)


def build_kernels() -> None:
    """nvcc every kernel at once (one process each) and log what ptxas says
    of its registers and shared memory."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        outs = dict(zip(KERNELS, pool.map(_cuda.build, KERNELS)))
    log(f"  nvcc built {', '.join(KERNELS)} in {time.perf_counter() - t0:.2f} s")
    # Dynamic shared memory per block, as each launcher sizes it at the
    # paths' shapes (ptxas reports static shared memory only).
    smem = {"hop_merge": f"{128 * 12 + 256 * 8} B at E=120, A=64 or 128",
            "gated_adc": f"{16 * 256 * 4} B at S=16, K=256",
            "adc_scan": f"{4 * 16 * 256 * 4} B at 4 queries per block, S=16, K=256"}
    for name, out in outs.items():
        for line in out.splitlines():
            if "registers" in line or "smem" in line:
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
    topk = phase_smallest_k()

    log(f"phase 3: config 2 at {args.n}x{DIM}, {QUERIES} queries")
    config2 = phase_main_path(args.n)
    torch.cuda.empty_cache()
    log(f"phase 4: config 4 at {C4_N}x{C4_DIM}, {C4_QUERIES} queries")
    config4 = phase_config4()
    log(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, fig in (("hop_merge", k1), ("gated_adc", k2), ("adc_scan", k3)):
        _, source, replaces, _ = KERNELS[name]
        by_path = {"config2": config2["launches"][name], "config4": config4["launches"][name]}
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=sum(by_path.values()), launches_by_path=by_path, **fig))
    print(json.dumps({"config2": config2, "config4": config4, "smallest_k": topk,
                      "card": card}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
