"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # 1,000,000 x 128, 4096 queries
    python3 chip_smoke.py --n 262144 # a smaller corpus (depth cut only)

Phases, each fatal on failure:
1. set-up: the card's name and power limit; build the port's CUDA kernel
   from islands_tpu_torch/csrc.
2. the kernel against its plain PyTorch version on the card, exactly, at
   the main path's shapes (ties included), with its device time (from
   torch.profiler, beside the CUDA-event time of the wrapper calls), the
   plain version's time and its bound.
3. the main path of bench.py on the port: a seeded Gaussian-mixture corpus
   (4096 centres, sigma 0.8) made on the card, build_index_with_sketch at
   bench.py's LeannConfig, brute_force_topk ground truth,
   StoredSearcher(routing_size=65536) and the five primary rungs with the
   fused hop-merge: recall@10 and QPS (median of 5 passes, with the
   spread) per rung. The kernels' launch counts are zeroed just before and
   read just after.

Prints a JSON line of kernel figures, the card's name and power limit, and
last `{"ok": true, "device": {...}}`. Exits non-zero, with no result, when
no CUDA device is present or the port cannot be imported.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

import islands_tpu_torch
from islands_tpu_torch.core.build import build_index_with_sketch
from islands_tpu_torch.core.config import DistanceMetric, LeannConfig
from islands_tpu_torch.core.search import StoredSearcher
from islands_tpu_torch.ops import _cuda
from islands_tpu_torch.ops.distance import brute_force_topk
from islands_tpu_torch.ops.hop_merge import hop_merge, hop_merge_reference

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and the
# non-tensor-core float32 rate, used for a kernel's bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# bench.py's five primary rungs: (ef, promote, max_iters, expand_width,
# final_rescore).
RUNGS = [(32, 8, 12, 2, 64), (32, 16, 12, 2, 64), (32, 24, 12, 2, 64),
         (32, 48, 10, 2, 0), (32, 64, 10, 4, 0)]
HEADLINE = (32, 16, 12, 2, 64)
DIM, QUERIES = 128, 4096  # bench.py's width and query batch
QPS_PASSES = 5
MIN_HEADLINE_RECALL = 0.90


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
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


def phase_kernels() -> dict:
    """K1 against its plain version at the main path's shapes, exactly."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, a = 4096, 64
    max_err = 0.0
    for e, pw, ties in [(120, 8, False), (120, 16, False), (120, 24, False),
                        (120, 48, False), (240, 64, False), (120, 16, True),
                        (240, 64, True)]:
        args = hop_merge_inputs(gen, b, e, a, ties)
        got = hop_merge(*args, pw)
        want = hop_merge_reference(*args, pw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"hop_merge differs from its plain version at "
                                     f"E={e} pw={pw} ties={ties}")
        fin = torch.isfinite(want[0])
        if fin.any():
            max_err = max(max_err, float((got[0][fin] - want[0][fin]).abs().max()))
        log(f"  hop_merge == plain version at B={b} E={e} A={a} pw={pw} ties={ties}")
    e, pw = 120, 16
    args = hop_merge_inputs(gen, b, e, a, False)
    event_ms = time_ms(lambda: hop_merge(*args, pw), 200)
    ms = kernel_device_ms(lambda: hop_merge(*args, pw), "hop_merge_kernel", 200)
    plain_ms = time_ms(lambda: hop_merge_reference(*args, pw), 20)
    bound = hop_merge_bound_ms(b, e, a, pw)
    log(f"  hop_merge B={b} E={e} A={a} pw={pw}: kernel {ms:.4f} ms on the device "
        f"({event_ms:.4f} ms per wrapper call by CUDA events), plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes)")
    return dict(name="hop_merge", route="cuda",
                source="islands_tpu_torch/csrc/hop_merge.cu",
                replaces="islands_tpu/ops/pallas_kernels.py:412",
                max_abs_err=max_err, ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", library_ms=None)


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

    hop_merge.launches = 0
    t0 = time.perf_counter()
    graph, sketch = build_index_with_sketch(x, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"  build {n}x{dim}: {build_s:.3f} s = {n / build_s:.1f} vectors/s")

    t0 = time.perf_counter()
    true_d, true_ids = brute_force_topk(queries, x, 10, metric, batch=65536)
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
        before = hop_merge.launches
        d, ids = run(ef, pw, it, xw, fr)
        hops = hop_merge.launches - before  # one K1 launch per hop
        rec = recall_at_10(ids, true_ids)
        times = []
        for _ in range(QPS_PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(ef, pw, it, xw, fr)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        qps = sorted(n_queries / t for t in times)
        rungs.append(dict(rung=f"p{pw}/i{it}/x{xw}/fr{fr}", ef=ef, promote=pw,
                          max_iters=it, expand_width=xw, final_rescore=fr,
                          recall=rec, qps=qps[len(qps) // 2], qps_runs=qps,
                          qps_spread=qps[-1] / qps[0] - 1, hops=hops))
        log(f"  rung p{pw}/i{it}/x{xw}/fr{fr}: recall@10 {rec:.4f}, "
            f"QPS median {qps[len(qps) // 2]:.1f}, min {qps[0]:.1f}, max {qps[-1]:.1f} "
            f"(spread {100 * (qps[-1] / qps[0] - 1):.1f}%), {hops} hops")
        if d.shape != (n_queries, 10) or not torch.isfinite(d).all():
            raise AssertionError(f"rung {pw}/{it}: results not finite [B, 10]")
        if not bool((d[:, 1:] >= d[:, :-1]).all()):
            raise AssertionError(f"rung {pw}/{it}: distances not ascending")
    launches = hop_merge.launches
    profile = profile_pass(lambda: run(*HEADLINE))

    # Returned distances are the exact distances of the returned ids.
    ef, pw, it, xw, fr = HEADLINE
    d, ids = run(ef, pw, it, xw, fr)
    exact = torch.linalg.vector_norm(x[ids.long()] - queries[:, None, :], dim=-1)
    err = float((exact - d).abs().max())
    if err > 1e-3:
        raise AssertionError(f"returned distances off the exact ones by {err}")
    # The fused and inline hop-merges give identical results.
    sub = queries[:512]
    d_f, i_f = run(ef, pw, it, xw, fr, "fused", sub)
    d_i, i_i = run(ef, pw, it, xw, fr, "inline", sub)
    if not (torch.equal(i_f, i_i) and torch.equal(d_f, d_i)):
        raise AssertionError("fused and inline hop-merge disagree")
    log("  fused == inline on 512 queries; returned distances exact "
        f"(max |err| {err:.2e})")

    head = next(r for r in rungs if (r["ef"], r["promote"], r["max_iters"],
                                      r["expand_width"], r["final_rescore"]) == HEADLINE)
    if head["recall"] < MIN_HEADLINE_RECALL:
        raise AssertionError(f"headline rung recall {head['recall']:.4f} "
                             f"< {MIN_HEADLINE_RECALL}")
    if launches <= 0:
        raise AssertionError("the main path never launched the hop_merge kernel")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  hop_merge launches on the main path: {launches}; peak device "
        f"memory {peak_gb:.2f} GB")
    return dict(n=n, dim=dim, queries=n_queries, build_seconds=build_s,
                build_vectors_per_s=n / build_s,
                index_bytes_per_vector=(graph.storage_bytes()
                                        + 4 * sketch.node_sketch.numel()
                                        + 4 * sketch.w.numel() + 4) / n,
                peak_device_gb=peak_gb, rungs=rungs, headline_profile=profile,
                launches={"hop_merge": launches})


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
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("phase 1: build the kernel")
    t0 = time.perf_counter()
    out = _cuda.build("hop_merge")
    log(f"  nvcc built hop_merge in {time.perf_counter() - t0:.2f} s")
    for line in out.splitlines():
        if "registers" in line:  # ptxas: registers and shared memory per kernel
            log(f"  hop_merge: {line.strip()}")

    log("phase 2: kernels against their plain versions")
    k1 = phase_kernels()

    log(f"phase 3: main path at {args.n}x{DIM}, {QUERIES} queries")
    main_path = phase_main_path(args.n)
    k1["launches"] = main_path["launches"]["hop_merge"]
    log(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"main_path": main_path, "card": card}), flush=True)
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
