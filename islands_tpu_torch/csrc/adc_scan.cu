// Full-corpus ADC scan for Hopper (sm_90a): kernel K3, one lookup core with
// two epilogues.
//
// Replaces islands_tpu/ops/pallas_kernels.py::_adc_kernel (launched there by
// _adc_scan_pallas through adc_scan). For every query b and code row i the
// core computes
//   sum[b, i] = sum over s = 0..S-1 of tables[b, s, codes[i, s]]
// in full f32, in s order, starting from 0. The TPU kernel computes the same
// sum as one-hot matmuls at Precision.HIGHEST so that the selection is
// exact; here it is a lookup, with no bf16 anywhere.
//
// Route "sums" (adc_scan_launch) writes out[b, i] = sum[b, i], the TPU
// kernel's output. Route "smallest" (adc_scan_smallest_launch) writes no
// [B, N] matrix: it finalises each sum as the PQ scan does (1 + s for cosine,
// sqrt(max(s, 0)) for euclidean, s for the dot product and manhattan) and
// keeps, per query and per tile of code rows, the r smallest keys
// (sort_key(d) << 32 | i), the keys of ops/merge.py's top-k route: unique,
// so ties go to the lower row. Every row of the global r smallest is among
// its own tile's r smallest, so merging the tiles' lists is exact; a second
// kernel (adc_scan_merge_kernel, a block per query) merges them and writes
// each query's r positions.
//
// What bounds it on the card: the lookups. At B=512, N=1,000,000, S=16,
// K=256 the core makes B*N*S = 8.2e9 shared-memory lookups (about 0.98 ms at
// 32 per SM per clock on 132 SMs at 1.98 GHz). Route "sums" also writes
// 2.05 GB of [B, N] f32 (0.61 ms at 3.35 TB/s); route "smallest" writes
// B * tiles * r keys (2.1 MB at r = 256). The codes (16 MB) and tables
// (8 MB) fit in L2.
//
// Design of the core: a block stages the tables of kQB = 4 queries in shared
// memory, interleaved by query (tab[(s * K + c) * kQB + q], 64 KB at S=16,
// K=256), then walks a tile of code rows. Each thread reads one code row at
// a time (16 bytes in one load when S = 16; neighbouring threads on
// neighbouring rows) and, per subspace, fetches its code's kQB table entries
// with one 16-byte shared-memory load, so a lookup serves all of the block's
// queries. Random codes make those loads conflict in banks: an 8-lane phase
// reads 8 random 16-byte slots, and the busiest of the 8 slot groups holds
// about 2.6 of them where 1 is the floor. That, not the HBM, sets both
// routes' time. A layout of 8 queries in which the lanes of a code row read
// 8-byte slices of different queries conflicts less per load (about 2.1),
// but its tables take 128 KB, so one block fits an SM; it measured slower.
//
// Route "smallest": each block keeps, per query, a list in shared memory:
// rp = next_pow2(r) slots of kept keys (the r smallest so far, sorted) and w
// = max(step, rp) slots of new keys, w / warps of them each warp's, with a
// threshold, the r-th kept key (none until r are kept). A row's key enters
// only below the threshold, so after the first rows few do (about
// r * ln(T / r) per tile of T rows). A compaction sorts the new keys and
// merges them into the kept ones (a half-cleaner and a bitonic merge),
// which lowers the threshold. It runs only when a key finds its warp's new
// slots full; that key waits in its lane for the compaction and then enters
// if it is still below the threshold.
//
// Every step ends in a block barrier, so a step takes as long as its
// slowest warp, and the selection's cost is mostly the time warps wait
// there for a warp that inserts. What keeps it near the lookups':
// - a warp places its keys in its own slots by a ballot: no atomic and no
//   shuffle, whose shared-memory round trips queue behind the lookups and
//   hold the other warps at the barrier (one atomic per warp and list
//   measured much slower on the H100);
// - few long tiles: as many per query group as keep the grid within one
//   wave of resident blocks (2 at B = 512 on 132 SMs: tiles of 500,224
//   rows), since each tile pays its lists' first fill and compactions;
// - compactions sort only the new keys (w, not the whole list) and come
//   only when a warp's slots overflow, not when they may;
// - a sum is first held to a bound on the sums the threshold admits
//   (sum_bound, loose by 1e-6), so a row's key is finalised and built only
//   when it may enter: the prefilter of a step uses the threshold from
//   before it, whose rows all come before the step's, so a sum above the
//   bound cannot enter.
// Two rows per thread per step (half the barriers, twice the slots)
// measured slower.
// At the tile's end a last compaction leaves the r smallest kept keys, which
// are written (the sign bit flipped, so that int64 order is the key order; a
// tile of fewer than r rows pads with the largest int64). The finalise is
// bit-exact: __fadd_rn and __fsqrt_rn, no fast math. A sum is never -0.0
// (it starts from +0.0, and +0.0 + -0.0 is +0.0), so the clamp needs no sign
// rule.
//
// Codes are uint8 (at most 256 centroids) or int32 (more: the quantizer's
// wider code type); int32 rows are read one code at a time. Either is read
// unsigned and clamped to K-1, so no lookup leaves the block's tables. Code
// rows are addressed with 64-bit offsets. Tables of more than 14,528 entries
// per query (S*K*16 B > 227 KB) take one query per block; more than 58,112
// (227 KB) are refused. Route "smallest" takes r <= kMaxR, takes one query
// per block when kQB queries' tables and lists do not fit, and refuses
// tables that do not fit beside one query's list.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQB = 4;                 // queries per block
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 64;     // route "sums": code rows per thread per block
constexpr int kMaxSmem = 227 * 1024;   // per block on sm_90
// Route "smallest": threads per block of kQB queries (a step walks as many
// rows), the shortest tile, and the largest r (ops/adc.SMALLEST_MAX_R).
constexpr int kSelThreads = 512;
constexpr int64_t kMinTileRows = 16384;
constexpr int kMaxR = 1024;
constexpr size_t kStaticSmem = 128;    // route "smallest": its static shared memory, rounded up
constexpr uint64_t kNoKey = ~0ull;     // an empty list slot, above every row's key

// Adds the QB table entries at tab[idx * QB ...] to acc, in query order.
template <int QB>
__device__ __forceinline__ void lookup(const float* tab, int idx, float acc[QB]) {
  if constexpr (QB % 4 == 0) {
    const float4* t4 = reinterpret_cast<const float4*>(tab + idx * QB);
#pragma unroll
    for (int h = 0; h < QB / 4; ++h) {
      float4 v = t4[h];
      acc[4 * h] += v.x;
      acc[4 * h + 1] += v.y;
      acc[4 * h + 2] += v.z;
      acc[4 * h + 3] += v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < QB; ++q) acc[q] += tab[idx * QB + q];
  }
}

// Stages the tables of queries b0 .. b0 + nq - 1 in shared memory,
// interleaved by query (zeros past nq). The caller synchronises.
template <int QB>
__device__ __forceinline__ void stage_tables(const float* __restrict__ tables, float* tab, int b0,
                                             int nq, int sk) {
  for (int j = threadIdx.x; j < sk * QB; j += blockDim.x) {
    const int q = j % QB;
    tab[j] = q < nq ? tables[static_cast<int64_t>(b0 + q) * sk + j / QB] : 0.0f;
  }
}

// The sums of code row i against the block's QB tables, in s order from 0.
template <int QB, bool kS16, typename Code>
__device__ __forceinline__ void row_sums(const float* tab, const Code* __restrict__ codes,
                                         int64_t i, int S, int K, float acc[QB]) {
  const uint32_t kmax = K - 1;
#pragma unroll
  for (int q = 0; q < QB; ++q) acc[q] = 0.0f;
  if constexpr (kS16) {
    static_assert(sizeof(Code) == 1, "16-code loads take uint8 codes");
    const uint4 v = *reinterpret_cast<const uint4*>(codes + i * 16);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      uint32_t c = (w[s >> 2] >> (8 * (s & 3))) & 0xFFu;
      c = c < kmax ? c : kmax;
      lookup<QB>(tab, s * K + static_cast<int>(c), acc);
    }
  } else {
    const Code* row = codes + i * S;
    for (int s = 0; s < S; ++s) {
      uint32_t c = static_cast<uint32_t>(row[s]);
      c = c < kmax ? c : kmax;
      lookup<QB>(tab, s * K + static_cast<int>(c), acc);
    }
  }
}

template <int QB, bool kS16, typename Code>
__global__ void adc_scan_kernel(const float* __restrict__ tables,
                                const Code* __restrict__ codes,
                                float* __restrict__ out, int B, int64_t N, int S, int K) {
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);  // [S * K, QB]
  const int b0 = blockIdx.y * QB;
  const int nq = B - b0 < QB ? B - b0 : QB;
  stage_tables<QB>(tables, tab, b0, nq, S * K);
  __syncthreads();

  const int64_t tile = static_cast<int64_t>(kThreads) * kRowsPerThread;
  const int64_t start = blockIdx.x * tile;
  const int64_t stop = start + tile < N ? start + tile : N;
  for (int64_t i = start + threadIdx.x; i < stop; i += blockDim.x) {
    float acc[QB];
    row_sums<QB, kS16, Code>(tab, codes, i, S, K, acc);
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      if (q < nq) out[static_cast<int64_t>(b0 + q) * N + i] = acc[q];
    }
  }
}

// A sum finalised onto the metric's scale, as ops/adc.finalize_adc does it:
// metric 0 cosine (1 + s), 1 euclidean (sqrt(max(s, 0)), NaN passes), else
// the sum itself (dot product, manhattan).
__device__ __forceinline__ float finalize(float s, int metric) {
  if (metric == 0) return __fadd_rn(1.0f, s);
  if (metric == 1) return __fsqrt_rn(s < 0.0f ? 0.0f : s);
  return s;
}

// (sort_key(d) << 32 | i) with the sign bit flipped, so that unsigned order
// is the order of ops/merge.py's signed int64 keys: IEEE total order of d,
// then the row.
__device__ __forceinline__ uint64_t row_key(float d, uint32_t i) {
  const int32_t b = __float_as_int(d);
  const uint32_t k = static_cast<uint32_t>(b ^ ((b >> 31) & 0x7FFFFFFF)) ^ 0x80000000u;
  return (static_cast<uint64_t>(k) << 32) | i;
}

// A bound on the sums whose finalised distance can be <= that of `key`
// (NaN, so no bound, for kNoKey). finalize is monotone, so a row whose sum
// lies above it cannot have a key below `key` when its id is larger; the
// bound is loose by a relative 1e-6 (above the finalise's rounding), so it
// only spares the exact key of rows that cannot enter.
__device__ __forceinline__ float sum_bound(uint64_t key, int metric) {
  const int32_t k = static_cast<int32_t>(static_cast<uint32_t>(key >> 32) ^ 0x80000000u);
  const float d = __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
  if (metric == 0) return (d - 1.0f) + fabsf(d) * 1e-6f + 1e-30f;
  if (metric == 1) return d * d * (1.0f + 1e-6f) + 1e-37f;
  return d;
}

// Sorts, in each of the QB lists (`stride` keys apart), the `len` keys (a
// power of two) from offset `off` ascending, by a bitonic network over the
// whole block. Ends synchronised.
template <int QB>
__device__ void sort_lists(uint64_t* buf, int stride, int off, int len) {
  const int half = len / 2, sh = __ffs(half) - 1;
  for (int k = 2; k <= len; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < QB * half; t += blockDim.x) {
        uint64_t* l = buf + (t >> sh) * stride + off;
        const int u = t & (half - 1);
        const int lo = 2 * u - (u & (j - 1));  // bit j of lo is clear
        const bool up = (lo & k) == 0;
        const uint64_t x = l[lo], y = l[lo + j];
        if ((x > y) == up) {
          l[lo] = y;
          l[lo + j] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Folds each list's new keys (the w = cap - rp slots from rp, unsorted) into
// its kept keys (the rp slots from 0: the r smallest so far, sorted, then
// empty slots). The new keys are sorted; a half-cleaner of the kept keys
// against the first rp new ones reversed keeps the rp smallest of both in
// the kept slots, as a bitonic sequence, and a bitonic merge sorts them.
// Then the slots from r on are emptied and the threshold set to the r-th
// key (none while fewer are kept). Starts and ends synchronised.
template <int QB>
__device__ void compact(uint64_t* buf, int cap, int rp, int r, uint64_t* thr) {
  sort_lists<QB>(buf, cap, rp, cap - rp);
  const int sh = __ffs(rp) - 1;
  for (int t = threadIdx.x; t < QB * rp; t += blockDim.x) {
    uint64_t* l = buf + (t >> sh) * cap;
    const int e = t & (rp - 1);
    const uint64_t y = l[2 * rp - 1 - e];
    if (y < l[e]) l[e] = y;
  }
  __syncthreads();
  for (int j = rp >> 1; j > 0; j >>= 1) {
    for (int t = threadIdx.x; t < QB * rp / 2; t += blockDim.x) {
      uint64_t* l = buf + (t >> (sh - 1)) * cap;
      const int u = t & (rp / 2 - 1);
      const int lo = 2 * u - (u & (j - 1));
      const uint64_t x = l[lo], y = l[lo + j];
      if (x > y) {
        l[lo] = y;
        l[lo + j] = x;
      }
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < QB * (cap - r); t += blockDim.x) {
    const int q = t / (cap - r);
    buf[q * cap + r + t - q * (cap - r)] = kNoKey;
  }
  if (threadIdx.x < QB) thr[threadIdx.x] = buf[threadIdx.x * cap + r - 1];
  __syncthreads();
}

// Appends `key`, where `take`, to the warp's own `ws` new slots of a list,
// `used` of which the warp has taken (the same in every lane): a ballot
// places the lanes' keys after them, with no atomic and no shuffle, so no
// insert waits on shared memory. Advances `used`; returns whether this
// lane's key found no slot. Called by the whole warp.
__device__ __forceinline__ bool insert(uint64_t* slots, int& used, int ws, bool take,
                                       uint64_t key) {
  const unsigned m = __ballot_sync(0xFFFFFFFFu, take);
  if (m == 0) return false;
  const int pos = used + __popc(m & ((1u << (threadIdx.x & 31)) - 1));
  used += __popc(m);
  if (take && pos < ws) slots[pos] = key;
  return take && pos >= ws;
}

// Route "smallest". A block of T threads serves QB queries, a thread per
// code row; a step walks T rows, the block tile_rows rows from
// blockIdx.x * tile_rows. Each list has cap slots: rp = next_pow2(r) kept,
// then w = cap - rp >= T new, ws = w / warps of them each warp's.
template <int QB, int T, bool kS16, typename Code>
__global__ void __launch_bounds__(T, 2)
adc_scan_smallest_kernel(const float* __restrict__ tables, const Code* __restrict__ codes,
                         int64_t* __restrict__ out, int B, int64_t N, int S, int K, int r,
                         int rp, int cap, int64_t tile_rows, int metric) {
  extern __shared__ float4 smem4[];
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem4);                         // [QB, cap]
  float* tab = reinterpret_cast<float*>(buf + static_cast<size_t>(QB) * cap);  // [S * K, QB]
  __shared__ uint64_t thr_s[QB];
  const int b0 = blockIdx.y * QB;
  const int nq = B - b0 < QB ? B - b0 : QB;
  const int ws = (cap - rp) / (T / 32);
  uint64_t* own = buf + rp + (threadIdx.x >> 5) * ws;  // the warp's new slots of list 0
  stage_tables<QB>(tables, tab, b0, nq, S * K);
  for (int j = threadIdx.x; j < QB * cap; j += blockDim.x) buf[j] = kNoKey;
  __syncthreads();

  uint64_t thr[QB];
  float hi[QB];
  int used[QB];
#pragma unroll
  for (int q = 0; q < QB; ++q) {
    thr[q] = kNoKey;
    hi[q] = sum_bound(kNoKey, metric);
    used[q] = 0;
  }
  const int64_t start = blockIdx.x * tile_rows;
  const int64_t stop = start + tile_rows < N ? start + tile_rows : N;
  // A key that finds its warp's new slots full waits in its lane (as its
  // sum) for a compaction, then enters if it is still below the threshold.
  // After a compaction no list holds new keys, so a warp's keys of one step
  // (at most 32 <= ws) fit. A compaction mid-step lowers the threshold to a key that may
  // come from this step, but the prefilter only serves the next steps,
  // whose rows come after every kept row: a sum above the threshold's bound
  // cannot enter there.
  for (int64_t base = start; base < stop; base += T) {
    const int64_t i = base + threadIdx.x;
    float acc[QB];
    row_sums<QB, kS16, Code>(tab, codes, i < stop ? i : stop - 1, S, K, acc);
    unsigned wait = 0;  // bit q: this lane's key for list q found no slot
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      uint64_t key = kNoKey;
      if (i < stop && q < nq && !(acc[q] > hi[q])) {
        key = row_key(finalize(acc[q], metric), static_cast<uint32_t>(i));
      }
      wait |= static_cast<unsigned>(insert(own + q * cap, used[q], ws, key < thr[q], key)) << q;
    }
    while (__syncthreads_or(wait)) {
      compact<QB>(buf, cap, rp, r, thr_s);
      const unsigned again = wait;
      wait = 0;
#pragma unroll
      for (int q = 0; q < QB; ++q) {
        thr[q] = thr_s[q];
        hi[q] = sum_bound(thr[q], metric);
        used[q] = 0;
        uint64_t key = kNoKey;
        if ((again >> q) & 1u) key = row_key(finalize(acc[q], metric), static_cast<uint32_t>(i));
        wait |= static_cast<unsigned>(insert(own + q * cap, used[q], ws, key < thr[q], key)) << q;
      }
    }
  }
  compact<QB>(buf, cap, rp, r, thr_s);

  const int64_t tiles = gridDim.x;
  for (int j = threadIdx.x; j < nq * r; j += blockDim.x) {
    const int q = j / r;
    const int e = j - q * r;
    out[((b0 + q) * tiles + blockIdx.x) * r + e] =
        static_cast<int64_t>(buf[q * cap + e] ^ (1ull << 63));
  }
}

// Route "smallest"'s merge: query blockIdx.x's `tiles` sorted lists of r
// keys (the scan's output, [B, tiles, r]) become its r smallest positions,
// ascending. The lists, padded to `lists` (a power of two) of rp =
// next_pow2(r) slots, sit in shared memory; each round pairs the lists st
// apart, keeps the rp smallest of each pair in the first (one half-cleaner
// stage over the first list and the second reversed, which leaves a bitonic
// sequence) and sorts them (a bitonic merge), until list 0 holds the result.
__global__ void adc_scan_merge_kernel(const int64_t* __restrict__ keys, int64_t* __restrict__ pos,
                                      int tiles, int r, int rp, int lists) {
  extern __shared__ float4 smem4[];
  uint64_t* m = reinterpret_cast<uint64_t*>(smem4);  // [lists, rp]
  const int64_t b = blockIdx.x;
  for (int j = threadIdx.x; j < lists * rp; j += blockDim.x) {
    const int t = j / rp, e = j % rp;
    m[j] = t < tiles && e < r ? static_cast<uint64_t>(keys[(b * tiles + t) * r + e]) ^ (1ull << 63)
                              : kNoKey;
  }
  __syncthreads();
  for (int st = 1; st < lists; st *= 2) {
    const int pairs = lists / (2 * st);
    for (int j = threadIdx.x; j < pairs * rp; j += blockDim.x) {
      uint64_t* a = m + static_cast<size_t>(j / rp) * 2 * st * rp;
      const int e = j % rp;
      const uint64_t x = a[e], y = a[st * rp + rp - 1 - e];
      if (y < x) a[e] = y;
    }
    __syncthreads();
    for (int h = rp / 2; h > 0; h >>= 1) {
      for (int j = threadIdx.x; j < pairs * rp / 2; j += blockDim.x) {
        uint64_t* a = m + static_cast<size_t>(j / (rp / 2)) * 2 * st * rp;
        const int t = j % (rp / 2);
        const int lo = 2 * t - (t & (h - 1));
        const uint64_t x = a[lo], y = a[lo + h];
        if (x > y) {
          a[lo] = y;
          a[lo + h] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < r; e += blockDim.x) {
    pos[b * r + e] = static_cast<int64_t>(m[e] & 0xFFFFFFFFu);
  }
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int QB, bool kS16, typename Code>
cudaError_t launch(const float* tables, const Code* codes, float* out, int B, int64_t N,
                   int S, int K, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(S) * K * QB * sizeof(float);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(adc_scan_kernel<QB, kS16, Code>), smem);
  if (err != cudaSuccess) return err;
  const int64_t tile = static_cast<int64_t>(kThreads) * kRowsPerThread;
  const int64_t tiles = (N + tile - 1) / tile;
  const int groups = (B + QB - 1) / QB;
  if (tiles > 0x7FFFFFFF || groups > 65535) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(groups));
  adc_scan_kernel<QB, kS16, Code><<<grid, kThreads, smem, stream>>>(tables, codes, out, B, N,
                                                                    S, K);
  return cudaGetLastError();
}

// Four queries per block when their tables fit in shared memory, else one.
template <bool kS16, typename Code>
cudaError_t launch_fit(bool wide, const float* tables, const Code* codes, float* out, int B,
                       int64_t N, int S, int K, cudaStream_t stream) {
  return wide ? launch<kQB, kS16, Code>(tables, codes, out, B, N, S, K, stream)
              : launch<1, kS16, Code>(tables, codes, out, B, N, S, K, stream);
}

// Route "smallest"'s launch: queries per block, list slots and tiles; the
// merge's lists (tiles padded to a power of two) of rp = next_pow2(r) keys.
struct Plan {
  int qb;
  int cap;
  int64_t tile_rows;
  int64_t tiles;
  int rp;
  int lists;
};

int pow2_at_least(int64_t n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// A list's slots: next_pow2(r) kept, then as many new, at least one step's.
int list_cap(int r, int step) {
  const int rp = pow2_at_least(r);
  return rp + (step > rp ? step : rp);
}

// The blocks of `threads` threads and `smem` bytes of dynamic shared memory
// that the current device holds at once (0 if it cannot be asked).
int64_t resident_blocks(int threads, size_t smem) {
  int dev = 0, sms = 0, smem_sm = 0, reserved = 0, threads_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&threads_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev) !=
          cudaSuccess) {
    return 0;
  }
  const int64_t by_smem = smem_sm / static_cast<int64_t>(smem + kStaticSmem + reserved);
  const int64_t by_threads = threads_sm / threads;
  return sms * (by_smem < by_threads ? by_smem : by_threads);
}

// Plans route "smallest" at these shapes: kQB queries per block when
// their tables and lists fit in shared memory, else one; as many tiles per
// query group as keep the grid within one wave of resident blocks (at least
// one, and tiles of at least kMinTileRows rows, a whole step's multiple, no
// more than the merge holds in shared memory). Each tile pays its lists'
// first fill and compactions, which grow only with the log of its rows, so
// few long tiles cost least. False when the route does not take the shapes.
bool plan_smallest(int B, int64_t N, int S, int K, int r, Plan* p) {
  if (B < 1 || N < 1 || N > 0x7FFFFFFF || S < 1 || K < 1 || r < 1 || r > kMaxR || r > N) {
    return false;
  }
  const size_t table = static_cast<size_t>(S) * K * sizeof(float);
  int step = kSelThreads;  // rows a step walks
  p->qb = kQB;
  p->cap = list_cap(r, step);
  if (kQB * (p->cap * sizeof(uint64_t) + table) + kStaticSmem > kMaxSmem) {
    step = kThreads;
    p->qb = 1;
    p->cap = list_cap(r, step);
    if (p->cap * sizeof(uint64_t) + table + kStaticSmem > kMaxSmem) return false;
  }
  const int64_t groups = (B + p->qb - 1) / p->qb;
  if (groups > 65535) return false;
  p->rp = pow2_at_least(r);
  int merge_lists = 1;  // the most lists of rp keys the merge holds
  while (2 * merge_lists * p->rp * sizeof(uint64_t) <= static_cast<size_t>(kMaxSmem)) {
    merge_lists *= 2;
  }
  const size_t smem = p->qb * (p->cap * sizeof(uint64_t) + table);
  int64_t tiles = resident_blocks(p->qb == kQB ? kSelThreads : kThreads, smem) / groups;
  tiles = tiles > 1 ? tiles : 1;
  const int64_t most = (N + kMinTileRows - 1) / kMinTileRows;
  tiles = tiles < most ? tiles : most;
  tiles = tiles < merge_lists ? tiles : merge_lists;
  int64_t rows = (N + tiles - 1) / tiles;
  rows = (rows + step - 1) / step * step;
  p->tile_rows = rows;
  p->tiles = (N + rows - 1) / rows;
  p->lists = pow2_at_least(p->tiles);
  return true;
}

// The scan into `keys` ([B, tiles, r]), then the merge into `pos` ([B, r]).
template <int QB, int T, bool kS16, typename Code>
cudaError_t launch_smallest(const Plan& p, const float* tables, const Code* codes,
                            int64_t* keys, int64_t* pos, int B, int64_t N, int S, int K, int r,
                            int metric, cudaStream_t stream) {
  const size_t smem = QB * (p.cap * sizeof(uint64_t) + static_cast<size_t>(S) * K * sizeof(float));
  cudaError_t err = set_smem(
      reinterpret_cast<const void*>(adc_scan_smallest_kernel<QB, T, kS16, Code>), smem);
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(p.tiles), static_cast<unsigned>((B + QB - 1) / QB));
  adc_scan_smallest_kernel<QB, T, kS16, Code><<<grid, T, smem, stream>>>(
      tables, codes, keys, B, N, S, K, r, p.rp, p.cap, p.tile_rows, metric);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t merge_smem = static_cast<size_t>(p.lists) * p.rp * sizeof(uint64_t);
  err = set_smem(reinterpret_cast<const void*>(adc_scan_merge_kernel), merge_smem);
  if (err != cudaSuccess) return err;
  const int half = p.lists * p.rp / 2;
  const int threads = half < 512 ? (half + 32) / 32 * 32 : 512;
  adc_scan_merge_kernel<<<B, threads, merge_smem, stream>>>(keys, pos, static_cast<int>(p.tiles),
                                                             r, p.rp, p.lists);
  return cudaGetLastError();
}

template <bool kS16, typename Code>
cudaError_t launch_smallest_fit(const Plan& p, const float* tables, const Code* codes,
                                int64_t* keys, int64_t* pos, int B, int64_t N, int S, int K, int r,
                                int metric, cudaStream_t stream) {
  return p.qb == kQB ? launch_smallest<kQB, kSelThreads, kS16, Code>(
                           p, tables, codes, keys, pos, B, N, S, K, r, metric, stream)
                     : launch_smallest<1, kThreads, kS16, Code>(p, tables, codes, keys, pos, B, N,
                                                               S, K, r, metric, stream);
}

// 16-byte code loads need 16-byte rows at a 16-byte-aligned base.
bool s16_rows(const void* codes, int code_bytes, int S) {
  return code_bytes == 1 && S == 16 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
}

}  // namespace

// Route "sums". Launches on `stream` with uint8 (code_bytes 1) or int32
// (code_bytes 4) codes; returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int adc_scan_launch(const float* tables, const void* codes, int code_bytes,
                               float* out, int B, int64_t N, int S, int K,
                               void* stream) {
  if (B < 0 || N < 0 || S < 1 || K < 1 || (code_bytes != 1 && code_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || N == 0) return 0;
  const size_t per_query = static_cast<size_t>(S) * K * sizeof(float);
  if (per_query > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = per_query * kQB <= static_cast<size_t>(kMaxSmem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (code_bytes == 4) {
    err = launch_fit<false>(wide, tables, static_cast<const int32_t*>(codes), out, B, N, S, K,
                            st);
  } else {
    const uint8_t* c8 = static_cast<const uint8_t*>(codes);
    err = s16_rows(codes, code_bytes, S)
              ? launch_fit<true>(wide, tables, c8, out, B, N, S, K, st)
              : launch_fit<false>(wide, tables, c8, out, B, N, S, K, st);
  }
  return static_cast<int>(err);
}

// Route "smallest"'s largest r (kMaxR), for the wrapper's tests.
extern "C" int adc_scan_smallest_max_r() { return kMaxR; }

// Route "smallest"'s plan at these shapes, the one place that decides
// whether the route takes them: writes plan[0..6) (queries per block, list
// slots, tile rows, tiles, merge list width, merge lists) for
// adc_scan_smallest_launch and returns the number of tiles, so of r-key
// lists per query; returns 0 when the route does not take the shapes (r
// outside [1, min(N, kMaxR)], B < 1, N >= 2^31, or tables too wide for
// shared memory beside one list).
extern "C" int64_t adc_scan_smallest_plan(int B, int64_t N, int S, int K, int r, int64_t* plan) {
  Plan p;
  if (!plan_smallest(B, N, S, K, r, &p)) return 0;
  const int64_t fields[6] = {p.qb, p.cap, p.tile_rows, p.tiles, p.rp, p.lists};
  for (int j = 0; j < 6; ++j) plan[j] = fields[j];
  return p.tiles;
}

// Route "smallest". Writes pos[b, 0..r) (int64, [B, r]): the positions of
// query b's r smallest finalised sums, ascending by key; `plan` is what
// adc_scan_smallest_plan wrote for the same shapes, and `keys` ([B, tiles,
// r] int64) is scratch for each tile's r smallest keys. metric: 0 cosine, 1
// euclidean, 2 dot product, 3 manhattan. Returns cudaGetLastError() (0 on
// success) or cudaErrorInvalidValue for a code width or metric it does not
// take.
extern "C" int adc_scan_smallest_launch(const float* tables, const void* codes, int code_bytes,
                                        const int64_t* plan, int64_t* keys, int64_t* pos, int B,
                                        int64_t N, int S, int K, int r, int metric, void* stream) {
  if ((code_bytes != 1 && code_bytes != 4) || metric < 0 || metric > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p{static_cast<int>(plan[0]), static_cast<int>(plan[1]), plan[2], plan[3],
               static_cast<int>(plan[4]), static_cast<int>(plan[5])};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (code_bytes == 4) {
    err = launch_smallest_fit<false>(p, tables, static_cast<const int32_t*>(codes), keys, pos,
                                     B, N, S, K, r, metric, st);
  } else {
    const uint8_t* c8 = static_cast<const uint8_t*>(codes);
    err = s16_rows(codes, code_bytes, S)
              ? launch_smallest_fit<true>(p, tables, c8, keys, pos, B, N, S, K, r, metric, st)
              : launch_smallest_fit<false>(p, tables, c8, keys, pos, B, N, S, K, r, metric, st);
  }
  return static_cast<int>(err);
}
