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
// 3.35 TB/s. The sort work is under 70 stages of a few hundred
// compare-exchanges per query, all in shared memory. This first version is
// one block per query with the whole state in shared memory (<= 7 KB at the
// main path's shapes) and a __syncthreads() between stages; it reads [B, E]
// and [B, A] row-major and writes [B, pw] and [B, A] directly, so the
// element-major transpose the TPU kernel needed is gone. Its stage count,
// not its bytes, sets its time today.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHole = 0x3FFFFFFF;  // sorts after every real id (n < 2^30)
constexpr int kSentinel = -1;
constexpr int kMaxThreads = 512;
constexpr int kMaxPerThread = 8;  // discoveries a thread holds in step 2

__device__ __forceinline__ int float_key(float f) {
  // Signed-int key with the order of the float values, -0.0 equal to +0.0
  // (adding +0.0 turns -0.0 into +0.0), as jax.lax.sort compares floats.
  int k = __float_as_int(f + 0.0f);
  return k ^ ((k >> 31) & 0x7FFFFFFF);
}

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

__global__ void hop_merge_kernel(const float* __restrict__ nd,
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

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue for shapes the kernel does not take.
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
  int work = (Ep > L ? Ep : L) / 2;
  int threads = work < 32 ? 32 : (work > kMaxThreads ? kMaxThreads : work);
  if (Ep > kMaxPerThread * threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = static_cast<size_t>(Ep) * 12 + static_cast<size_t>(L) * 8;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  hop_merge_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      nd, ni, aqd, aqi, pd, pi, od, oi, E, A, pw, Ep, L);
  return static_cast<int>(cudaGetLastError());
}
