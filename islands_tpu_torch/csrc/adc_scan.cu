// Full-corpus ADC scan for Hopper (sm_90a): kernel K3.
//
// Replaces islands_tpu/ops/pallas_kernels.py::_adc_kernel (launched there by
// _adc_scan_pallas through adc_scan). For every query b and code row i:
//   out[b, i] = sum over s = 0..S-1 of tables[b, s, codes[i, s]]
// in full f32, in s order, starting from 0. The TPU kernel computes the same
// sum as one-hot matmuls at Precision.HIGHEST so that the selection is
// exact; here it is a lookup, with no bf16 anywhere.
//
// What bounds it on the card: the lookups, then the output. At B=512,
// N=1,000,000, S=16, K=256 it makes B*N*S = 8.2e9 shared-memory lookups
// (about 0.98 ms at 32 per SM per clock on 132 SMs at 1.98 GHz) and writes
// 2.05 GB of [B, N] f32 (0.61 ms at 3.35 TB/s). The codes (16 MB) and
// tables (8 MB) fit in L2.
//
// Design: a block stages the tables of kQB = 4 queries in shared memory,
// interleaved by query (tab[(s * K + c) * kQB + q], 64 KB at S=16, K=256,
// so three blocks fit on an SM), then walks a tile of code rows. Each
// thread reads one code row at a time (16 bytes in one load when S = 16;
// neighbouring threads on neighbouring rows) and, per subspace, fetches its
// code's kQB table entries with one 16-byte shared-memory load, so a lookup
// serves all of the block's queries. It writes out[b, i] for those queries:
// a warp writes 128 contiguous bytes per query. Random codes make the
// shared-memory loads conflict in banks; that, not the HBM, sets its time.
// Offsets into out are 64-bit (B*N passes 2^31 at B=4096).
//
// Codes are uint8 (at most 256 centroids) or int32 (more: the quantizer's
// wider code type); int32 rows are read one code at a time. Either is read
// unsigned and clamped to K-1, so no lookup leaves the block's tables.
// Tables of more than 14,528 entries per query (S*K*16 B > 227 KB) take one
// query per block; more than 58,112 (227 KB) are refused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQB = 4;                 // queries per block
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 64;     // code rows per thread per block
constexpr int kMaxSmem = 227 * 1024;   // per block on sm_90

// Adds the kQB table entries at tab[idx * QB ...] to acc, in query order.
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

template <int QB, bool kS16, typename Code>
__global__ void adc_scan_kernel(const float* __restrict__ tables,
                                const Code* __restrict__ codes,
                                float* __restrict__ out, int B, int64_t N, int S, int K) {
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);  // [S * K, QB]
  const int b0 = blockIdx.y * QB;
  const int nq = B - b0 < QB ? B - b0 : QB;
  const int sk = S * K;
  for (int j = threadIdx.x; j < sk * QB; j += blockDim.x) {
    const int q = j % QB;
    tab[j] = q < nq ? tables[static_cast<int64_t>(b0 + q) * sk + j / QB] : 0.0f;
  }
  __syncthreads();

  const uint32_t kmax = K - 1;
  const int64_t tile = static_cast<int64_t>(kThreads) * kRowsPerThread;
  const int64_t start = blockIdx.x * tile;
  const int64_t stop = start + tile < N ? start + tile : N;
  for (int64_t i = start + threadIdx.x; i < stop; i += blockDim.x) {
    float acc[QB];
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
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      if (q < nq) out[static_cast<int64_t>(b0 + q) * N + i] = acc[q];
    }
  }
}

template <int QB, bool kS16, typename Code>
cudaError_t launch(const float* tables, const Code* codes, float* out, int B, int64_t N,
                   int S, int K, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(S) * K * QB * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(adc_scan_kernel<QB, kS16, Code>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
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

}  // namespace

// Launches on `stream` with uint8 (code_bytes 1) or int32 (code_bytes 4)
// codes; returns cudaGetLastError() (0 on success) or cudaErrorInvalidValue
// for shapes the kernel does not take.
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
    // 16-byte code loads need 16-byte rows at a 16-byte-aligned base.
    const uint8_t* c8 = static_cast<const uint8_t*>(codes);
    const bool s16 = S == 16 && reinterpret_cast<uintptr_t>(c8) % 16 == 0;
    err = s16 ? launch_fit<true>(wide, tables, c8, out, B, N, S, K, st)
              : launch_fit<false>(wide, tables, c8, out, B, N, S, K, st);
  }
  return static_cast<int>(err);
}
