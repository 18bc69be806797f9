"""Gather microbenchmark: torch's row gather against the row-gather kernel
(K5), and the block gather of the inline-sketch layout.

Port of benches/gather_bench.py. Each measurement chains data-dependent
gathers: every iteration's ids come from the rows the previous one fetched,
so no gather starts before the last has finished. A chain of I1 = 10 and
one of I2 = 50 iterations are timed and the difference over I2 - I1 gives
the time per iteration, free of the fixed cost of a call. On the card each
chain is captured once as a CUDA graph and its replay timed with CUDA
events, so that, as the reference's chains inside one jit, the figures
hold no host dispatch (the wrapper counts a captured launch once, at
capture; the replays run without it). On the CPU (tests only)
the chains run eagerly under the host clock, and the figures then say
nothing of a device.

    python -m islands_tpu_torch.benches.gather_bench            # 1,000,000 x 128
    python -m islands_tpu_torch.benches.gather_bench --n 100000

Sizes are the reference bench's: row gathers of k = 131,072 and 1,048,576
rows of f32 [N, D]; the kernel at k = 131,072, checked bit for bit against
x[ids] first; block gathers of k = 4,096 and 16,384 [60, 8] int32 blocks.
The block gather stays torch indexing: it is XLA's native gather in the
reference, with no kernel of its own.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from islands_tpu_torch.device import resolve_device
from islands_tpu_torch.ops.gather import row_gather

I1, I2 = 10, 50
ROW_KS = (131072, 1048576)
KERNEL_K = 131072
BLOCK_KS = (4096, 16384)
BLOCK_BW, BLOCK_P4 = 60, 8


def _next_ids(ids: torch.Tensor, s: torch.Tensor, n: int) -> torch.Tensor:
    nxt = ids + 1 + (s.to(torch.int32) & 7)
    return torch.where(nxt >= n, nxt - n, nxt)


def chained_row_gather(x: torch.Tensor, ids: torch.Tensor, iters: int) -> torch.Tensor:
    n = x.shape[0]
    for _ in range(iters):
        rows = x[torch.clamp(ids, 0, n - 1).long()]
        ids = _next_ids(ids, torch.sum(rows, dim=1), n)
    return ids


def chained_kernel_gather(x: torch.Tensor, ids: torch.Tensor, iters: int) -> torch.Tensor:
    n = x.shape[0]
    for _ in range(iters):
        rows = row_gather(x, torch.clamp(ids, 0, n - 1))
        ids = _next_ids(ids, torch.sum(rows, dim=1), n)
    return ids


def chained_block_gather(blocks: torch.Tensor, ids: torch.Tensor, iters: int) -> torch.Tensor:
    n = blocks.shape[0]
    for _ in range(iters):
        rows = blocks[torch.clamp(ids, 0, n - 1).long()]
        # The reference's int32 sum wraps; the low 3 bits agree either way.
        ids = _next_ids(ids, torch.sum(rows, dim=(1, 2)), n)
    return ids


def _elapsed_s(chain, data, ids0, iters: int, dev: torch.device) -> float:
    """Seconds of one chain of `iters` iterations: on the card the replay
    of its CUDA graph under CUDA events (one replay first as a warm-up), on
    the CPU an eager run under the host clock."""
    if dev.type == "cuda":
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            chain(data, ids0, iters)
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    chain(data, ids0, iters)
    return time.perf_counter() - t0


def bench(chain, data, ids0, label: str, per: int, dev: torch.device) -> dict:
    """Time per iteration of `chain` by the difference of an I2 and an I1
    chain (each run eagerly once before, as a warm-up)."""
    chain(data, ids0, I1)
    chain(data, ids0, I2)
    t_a = _elapsed_s(chain, data, ids0, I1, dev)
    t_b = _elapsed_s(chain, data, ids0, I2, dev)
    dt = (t_b - t_a) / (I2 - I1)
    print(f"{label}: {dt * 1e3:.4f} ms/iter ({dt / per * 1e9:.3f} ns/row)", flush=True)
    return dict(label=label, k=per, ms_per_iter=dt * 1e3, ns_per_row=dt / per * 1e9)


def main(n: int = 1_000_000, d: int = 128, device=None) -> dict:
    """Run every chain at corpus size n x d; returns the figures with the
    device they ran on."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, d), generator=gen, device=dev)

    def ids_of(k, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, n, (k,), generator=g, device=dev, dtype=torch.int32)

    out = dict(n=n, d=d, device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               i1=I1, i2=I2, row=[], kernel=[], block=[])
    for k in ROW_KS:
        out["row"].append(bench(chained_row_gather, x, ids_of(k, k),
                                f"torch row gather f32[{n},{d}] k={k}", k, dev))

    ids0 = ids_of(KERNEL_K, 3)
    if not torch.equal(row_gather(x, ids0), x[ids0.long()]):
        raise AssertionError("row_gather differs from x[ids]")
    out["kernel"].append(bench(chained_kernel_gather, x, ids0,
                               f"row_gather kernel k={KERNEL_K}", KERNEL_K, dev))
    del x

    blocks = torch.randint(0, 2**31 - 1, (n, BLOCK_BW, BLOCK_P4), generator=gen, device=dev,
                           dtype=torch.int32)
    for k in BLOCK_KS:
        out["block"].append(bench(chained_block_gather, blocks, ids_of(k, k + 7),
                                  f"block gather i32[{n},{BLOCK_BW},{BLOCK_P4}] k={k}", k, dev))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    args = ap.parse_args()
    print(json.dumps(main(args.n, args.d)))
