// Fused hop-merge for the sketch-gated search loop, for Hopper (sm_90a).
//
// Replaces islands_tpu/ops/pallas_kernels.py::_hop_merge_kernel (launched
// there by _hop_merge_pallas through hop_merge_op_for). Per query it
//   1. sorts the hop's E discoveries by (id, slot), so duplicate ids sit
//      next to each other in their original slot order (a stable sort by id);
//   2. keeps an entry where its distance is finite and its id differs from
//      the previous one; dropped entries become (+inf, -1);
//   3. sorts the survivors by the key (-d, id), which is the
//      order a stable descending sort by distance gives on the id-sorted
//      list (equal distances in ascending id order);
//   4. lays out aq ++ (+inf, -1) pad ++ desc(new) at length next_pow2(A + E)
//      and runs the bitonic merge of ops/merge.bitonic_merge, swapping a pair
//      only when lo > hi (strictly), so equal distances keep their slots;
//   5. writes the first pw entries as the promote head and the next A as the
//      new approximate queue, with id -1 wherever the distance is +inf.
// That is the XLA composition _hop_merge_xla bit for bit, ties included.
//
// What bounds it on the card: bytes. A query reads (E + A) * 8 B and writes
// (pw + A) * 8 B; at B=4096, E=120, A=64, pw=16 that is ~8.6 MB, ~2.6 us at
// 3.35 TB/s. Its sort networks are some 60 stages of compare-exchange per
// query, so the stages, not the bytes, set the time unless each costs a
// few instructions.
//
// Design (the warp route, Ep = next_pow2(E) <= 256 and L <= 512). One warp
// owns a query, four queries to a block. A lane holds P = max(Ep, 32) / 32
// entries of the sorts and Q = max(L, 32) / 32 of the merge, in arrays
// unrolled at compile time (the kernel is a template on P and Q). The sorts
// keep entry i in lane i / P, register i % P, so the stages at distances
// below P (13 of the 28 at Ep = 128) exchange two registers of one lane and
// the others one __shfl_xor_sync; the merge keeps entry i in lane i % 32,
// register i / 32 (its queue loads and stores coalesce), and P * P shuffles
// move the sorted run across. No shared memory and no __syncthreads()
// anywhere. The sorts compare one 64-bit key: step 1 packs
// (id, slot), and the distance comes back by its slot from the row just
// read (in L1); step 3 packs (float_key(-d), id + 1) and one bit for -0.0,
// an invertible key, so d and id come back from it with no payload. The
// sorts run on 32 * P >= Ep entries; the extra entries are (hole, slot)
// fillers that drop in step 2, and since the keys that matter are unique,
// any sort gives the same order. The merge keeps the reference's network
// exactly (its length L decides where ties land); the run's last E entries
// are its last E.
// Rows too wide for registers take the wide route: one block per query with
// the whole state in shared memory and a __syncthreads() between stages.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHole = 0x3FFFFFFF;  // sorts after every real id (n < 2^30)
constexpr int kSentinel = -1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;   // queries per block on the warp route
constexpr int kMaxSortPerLane = 8;  // warp route: Ep <= 256
constexpr int kMaxMergePerLane = 16;  // warp route: L <= 512
constexpr int kMaxThreads = 512;   // wide route
constexpr int kMaxPerThread = 8;   // discoveries a thread holds in step 2 (wide route)

__device__ __forceinline__ int float_key(float f) {
  // Signed-int key with the order of the float values, -0.0 equal to +0.0
  // (adding +0.0 turns -0.0 into +0.0), as jax.lax.sort compares floats.
  int k = __float_as_int(f + 0.0f);
  return k ^ ((k >> 31) & 0x7FFFFFFF);
}

// ---------------------------------------------------------------- warp route

// Step 1's key: (id, slot), signed id order.
__device__ __forceinline__ uint64_t id_slot_key(int id, int slot) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(id) ^ 0x80000000u) << 32) |
         static_cast<uint32_t>(slot);
}

__device__ __forceinline__ int key_id(uint64_t k) {
  return static_cast<int>(static_cast<uint32_t>(k >> 32) ^ 0x80000000u);
}

// Step 3's key: ascending order is d descending (-0.0 equal to +0.0), then
// id ascending (-1 <= id < 2^31 - 1). The low bit keeps -0.0 apart from
// +0.0 for decoding only; the (d, id) pairs that reach it are unique.
__device__ __forceinline__ uint64_t desc_key(float d, int id) {
  const uint32_t hi = static_cast<uint32_t>(float_key(-d)) ^ 0x80000000u;
  const uint32_t neg_zero = (d == 0.0f && signbit(d)) ? 1u : 0u;
  const uint32_t lo = ((static_cast<uint32_t>(id) + 1u) << 1) | neg_zero;
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

__device__ __forceinline__ void desc_key_decode(uint64_t k, float& d, int& id) {
  const int fk = static_cast<int>(static_cast<uint32_t>(k >> 32) ^ 0x80000000u);
  d = -__int_as_float(fk >= 0 ? fk : fk ^ 0x7FFFFFFF);
  const uint32_t lo = static_cast<uint32_t>(k);
  if (d == 0.0f) d = (lo & 1u) ? -0.0f : 0.0f;
  id = static_cast<int>(lo >> 1) - 1;
}

__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) { return a < b ? a : b; }
__device__ __forceinline__ uint64_t umax64(uint64_t a, uint64_t b) { return a < b ? b : a; }

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v >> 1); }

// Ascending bitonic sort of the warp's 32 * P keys; entry lane * P + r is
// k[r]. Distances below P exchange registers, larger ones shuffle.
template <int P>
__device__ __forceinline__ void warp_sort(uint64_t (&k)[P], int lane) {
  constexpr int kLog = 5 + ilog2(P);
#pragma unroll
  for (int sk = 1; sk <= kLog; ++sk) {
    const int size = 1 << sk;
#pragma unroll
    for (int sj = sk - 1; sj >= 0; --sj) {
      const int j = 1 << sj;
      if (j < P) {
#pragma unroll
        for (int r = 0; r < P; ++r) {
          if (r & j) continue;
          const int p = r | j;
          const bool asc = (((lane * P) | r) & size) == 0;
          const uint64_t lo = umin64(k[r], k[p]);
          const uint64_t hi = umax64(k[r], k[p]);
          k[r] = asc ? lo : hi;
          k[p] = asc ? hi : lo;
        }
      } else {
        const int jl = j / P;  // lane distance; size > j >= P > r
        const bool take_min = ((lane & jl) == 0) == (((lane * P) & size) == 0);
#pragma unroll
        for (int r = 0; r < P; ++r) {
          const uint64_t other = __shfl_xor_sync(kFull, k[r], jl);
          k[r] = take_min ? umin64(k[r], other) : umax64(k[r], other);
        }
      }
    }
  }
}

// At most 64 registers a thread, so 8 blocks (32 queries) fit an SM and a
// batch of 4096 queries runs in one wave on 132 SMs.
template <int P, int Q>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 8)
hop_merge_warp_kernel(const float* __restrict__ nd, const int* __restrict__ ni,
                      const float* __restrict__ aqd, const int* __restrict__ aqi,
                      float* __restrict__ pd, int* __restrict__ pi,
                      float* __restrict__ od, int* __restrict__ oi,
                      int B, int E, int A, int pw, int L) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const float inf = __int_as_float(0x7F800000);
  const float* ndr = nd + b * E;
  const int* nir = ni + b * E;

  // 1. (id, slot) keys; +inf slots and the fillers take the hole id.
  uint64_t key[P];
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int j = lane * P + r;
    int id = kHole;
    if (j < E) {
      const float d = ndr[j];
      if (!isinf(d)) id = nir[j];
    }
    key[r] = id_slot_key(id, j);
  }
  warp_sort<P>(key, lane);

  // 2. keep the first entry of each id with a finite distance, read back by
  // its slot; 3. re-key the survivors by (-d, id) and sort.
  int ids[P];
#pragma unroll
  for (int r = 0; r < P; ++r) ids[r] = key_id(key[r]);
  const int up = __shfl_up_sync(kFull, ids[P - 1], 1);  // the previous lane's last
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int prev = r > 0 ? ids[r - 1] : (lane == 0 ? -2 : up);
    const int slot = static_cast<int>(static_cast<uint32_t>(key[r]));
    const float d = slot < E ? ndr[slot] : inf;
    const bool keep = d < inf && ids[r] != prev;
    key[r] = desc_key(keep ? d : inf, keep ? ids[r] : kSentinel);
  }
  warp_sort<P>(key, lane);

  // The run into the merge's layout: run[rs] is entry rs * 32 + lane, from
  // lane (rs * 32 + lane) / P, register lane % P.
  uint64_t run[P];
#pragma unroll
  for (int rs = 0; rs < P; ++rs) {
    const int src = rs * (32 / P) + lane / P;
    uint64_t v = 0;
#pragma unroll
    for (int c = 0; c < P; ++c) {
      const uint64_t other = __shfl_sync(kFull, key[c], src);
      if ((lane % P) == c) v = other;
    }
    run[rs] = v;
  }

  // 4. aq ++ pad ++ the last E entries of the descending run (entry s of the
  // run is merge entry s + L - 32P), then the reference's merge network.
  float md[Q];
  int mi[Q];
  uint64_t shifted = 0;
  if (Q == 1) shifted = __shfl_sync(kFull, run[0], (lane + 32 - L) & 31);
#pragma unroll
  for (int r = 0; r < Q; ++r) {
    const int m = r * 32 + lane;
    float dv = inf;
    int iv = kSentinel;
    if (m < A) {
      dv = aqd[b * A + m];
      iv = aqi[b * A + m];
    } else if (m >= L - E && m < L) {
      const int rs = r - (Q - P);  // L = 32Q when Q > 1
      desc_key_decode(Q == 1 ? shifted : run[rs < 0 ? 0 : rs], dv, iv);
    }
    md[r] = dv;
    mi[r] = iv;
  }
#pragma unroll
  for (int hr = Q / 2; hr >= 1; hr >>= 1) {
#pragma unroll
    for (int r = 0; r < Q; ++r) {
      if (r & hr) continue;
      const int p = r | hr;
      if (md[r] > md[p]) {  // strict: equal distances never swap
        const float c = md[r]; md[r] = md[p]; md[p] = c;
        const int a = mi[r]; mi[r] = mi[p]; mi[p] = a;
      }
    }
  }
#pragma unroll
  for (int h = (Q > 1 ? 32 : L) >> 1; h >= 1; h >>= 1) {
    const bool lower = (lane & h) == 0;
#pragma unroll
    for (int r = 0; r < Q; ++r) {
      const float d_other = __shfl_xor_sync(kFull, md[r], h);
      const int i_other = __shfl_xor_sync(kFull, mi[r], h);
      if (lower ? md[r] > d_other : d_other > md[r]) {
        md[r] = d_other;
        mi[r] = i_other;
      }
    }
  }

  // 5. promote head and new queue; +inf slots carry the sentinel id.
#pragma unroll
  for (int r = 0; r < Q; ++r) {
    const int m = r * 32 + lane;
    const float dv = md[r];
    const int iv = isinf(dv) ? kSentinel : mi[r];
    if (m < pw) {
      pd[b * pw + m] = dv;
      pi[b * pw + m] = iv;
    } else if (m < pw + A) {
      od[b * A + (m - pw)] = dv;
      oi[b * A + (m - pw)] = iv;
    }
  }
}

// ---------------------------------------------------------------- wide route

__device__ __forceinline__ bool key_less(int a0, int a1, int b0, int b1) {
  return a0 < b0 || (a0 == b0 && a1 < b1);
}

// Ascending bitonic sort of n (a power of two) entries keyed by (k0, k1),
// carrying d. The keys are unique among the entries whose order matters.
__device__ void bitonic_sort(int* k0, int* k1, float* d, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        int i = 2 * j * (t / j) + (t % j);  // bit j of i is clear
        int p = i + j;
        bool up = (i & k) == 0;
        bool p_less = key_less(k0[p], k1[p], k0[i], k1[i]);
        bool i_less = key_less(k0[i], k1[i], k0[p], k1[p]);
        if (up ? p_less : i_less) {
          int a = k0[i]; k0[i] = k0[p]; k0[p] = a;
          int b = k1[i]; k1[i] = k1[p]; k1[p] = b;
          float c = d[i]; d[i] = d[p]; d[p] = c;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void hop_merge_block_kernel(const float* __restrict__ nd,
                                       const int* __restrict__ ni,
                                       const float* __restrict__ aqd,
                                       const int* __restrict__ aqi,
                                       float* __restrict__ pd, int* __restrict__ pi,
                                       float* __restrict__ od, int* __restrict__ oi,
                                       int E, int A, int pw, int Ep, int L) {
  extern __shared__ int smem[];
  int* s_k0 = smem;                                   // [Ep]
  int* s_k1 = s_k0 + Ep;                              // [Ep]
  float* s_d = reinterpret_cast<float*>(s_k1 + Ep);   // [Ep]
  float* m_d = s_d + Ep;                              // [L]
  int* m_i = reinterpret_cast<int*>(m_d + L);         // [L]

  const int64_t b = blockIdx.x;
  const float inf = __int_as_float(0x7F800000);

  // Load the discoveries; invalid (+inf) slots take the hole id, and the
  // power-of-two tail is (+inf, hole).
  for (int j = threadIdx.x; j < Ep; j += blockDim.x) {
    float d = inf;
    int id = kHole;
    if (j < E) {
      d = nd[b * E + j];
      id = isinf(d) ? kHole : ni[b * E + j];
    }
    s_k0[j] = id;
    s_k1[j] = j;
    s_d[j] = d;
  }
  __syncthreads();

  // 1. by (id, slot): a stable sort by id.
  bitonic_sort(s_k0, s_k1, s_d, Ep);

  // 2. adjacent-duplicate mask, then re-key for the descending sort.
  int keep_id[kMaxPerThread];
  float keep_d[kMaxPerThread];
  int r = 0;
  for (int j = threadIdx.x; j < Ep; j += blockDim.x, ++r) {
    int id = s_k0[j];
    int prev = j > 0 ? s_k0[j - 1] : -2;
    float d = s_d[j];
    bool keep = d < inf && id != prev;
    keep_id[r] = keep ? id : kSentinel;
    keep_d[r] = keep ? d : inf;
  }
  __syncthreads();
  r = 0;
  for (int j = threadIdx.x; j < Ep; j += blockDim.x, ++r) {
    s_k0[j] = float_key(-keep_d[r]);
    s_k1[j] = keep_id[r];
    s_d[j] = keep_d[r];
  }
  __syncthreads();

  // 3. by (-d, id): distances descending, ties by id.
  bitonic_sort(s_k0, s_k1, s_d, Ep);

  // 4. aq ++ pad ++ the last E entries of the descending run. The first
  // Ep - E entries of that run are +inf fillers, so its last E entries carry
  // the same distances as a descending sort of the E discoveries alone.
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    float d;
    int id;
    if (j < A) {
      d = aqd[b * A + j];
      id = aqi[b * A + j];
    } else if (j < L - E) {
      d = inf;
      id = kSentinel;
    } else {
      int src = j - (L - E) + (Ep - E);
      d = s_d[src];
      id = s_k1[src];
    }
    m_d[j] = d;
    m_i[j] = id;
  }
  __syncthreads();
  for (int h = L >> 1; h > 0; h >>= 1) {
    for (int t = threadIdx.x; t < L / 2; t += blockDim.x) {
      int i = 2 * h * (t / h) + (t % h);
      int p = i + h;
      if (m_d[i] > m_d[p]) {  // strict: equal distances never swap
        float c = m_d[i]; m_d[i] = m_d[p]; m_d[p] = c;
        int a = m_i[i]; m_i[i] = m_i[p]; m_i[p] = a;
      }
    }
    __syncthreads();
  }

  // 5. promote head and new queue; +inf slots carry the sentinel id.
  for (int j = threadIdx.x; j < pw + A; j += blockDim.x) {
    float d = m_d[j];
    int id = isinf(d) ? kSentinel : m_i[j];
    if (j < pw) {
      pd[b * pw + j] = d;
      pi[b * pw + j] = id;
    } else {
      od[b * A + (j - pw)] = d;
      oi[b * A + (j - pw)] = id;
    }
  }
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

struct Args {
  const float* nd;
  const int* ni;
  const float* aqd;
  const int* aqi;
  float* pd;
  int* pi;
  float* od;
  int* oi;
  int B, E, A, pw, L;
};

template <int P, int Q>
int launch_warp(const Args& a, cudaStream_t s) {
  const int64_t blocks = (static_cast<int64_t>(a.B) + kWarpsPerBlock - 1) / kWarpsPerBlock;
  hop_merge_warp_kernel<P, Q><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, s>>>(
      a.nd, a.ni, a.aqd, a.aqi, a.pd, a.pi, a.od, a.oi, a.B, a.E, a.A, a.pw, a.L);
  return static_cast<int>(cudaGetLastError());
}

// Q >= P always (L >= Ep); only those pairs are built.
template <int P>
int launch_warp_q(int Q, const Args& a, cudaStream_t s) {
  switch (Q) {
    case 1: if constexpr (P <= 1) return launch_warp<P, 1>(a, s); break;
    case 2: if constexpr (P <= 2) return launch_warp<P, 2>(a, s); break;
    case 4: if constexpr (P <= 4) return launch_warp<P, 4>(a, s); break;
    case 8: if constexpr (P <= 8) return launch_warp<P, 8>(a, s); break;
    case 16: return launch_warp<P, 16>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue for shapes the kernel does not take. The shape picks
// the route: the warp route up to Ep = 256 and L = 512, else the wide route
// (Ep <= 8 * 512 and Ep * 12 + L * 8 <= 48 KB).
extern "C" int hop_merge_launch(const float* nd, const int* ni,
                                const float* aqd, const int* aqi, float* pd,
                                int* pi, float* od, int* oi, int B, int E,
                                int A, int pw, void* stream) {
  if (B < 0 || E < 1 || A < 1 || pw < 0 || pw > E) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  int Ep = next_pow2(E);
  int L = next_pow2(A + E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Ep <= 32 * kMaxSortPerLane && L <= 32 * kMaxMergePerLane) {
    const Args a{nd, ni, aqd, aqi, pd, pi, od, oi, B, E, A, pw, L};
    const int Q = (L < 32 ? 32 : L) / 32;
    switch ((Ep < 32 ? 32 : Ep) / 32) {
      case 1: return launch_warp_q<1>(Q, a, s);
      case 2: return launch_warp_q<2>(Q, a, s);
      case 4: return launch_warp_q<4>(Q, a, s);
      case 8: return launch_warp_q<8>(Q, a, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int work = (Ep > L ? Ep : L) / 2;
  int threads = work < 32 ? 32 : (work > kMaxThreads ? kMaxThreads : work);
  if (Ep > kMaxPerThread * threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = static_cast<size_t>(Ep) * 12 + static_cast<size_t>(L) * 8;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  hop_merge_block_kernel<<<B, threads, smem, s>>>(nd, ni, aqd, aqi, pd, pi, od, oi,
                                                  E, A, pw, Ep, L);
  return static_cast<int>(cudaGetLastError());
}
