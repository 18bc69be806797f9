// Gated ADC of the two-level PQ hop, for Hopper (sm_90a): kernel K2.
//
// Replaces islands_tpu/ops/pallas_kernels.py::_gated_adc_kernel (launched
// there by _gated_adc_pallas through gated_adc_sums). Per query b and
// candidate e:
//   out[b, e] = sum over s = 0..S-1 of float(bf16(tables[b, s, codes[b, e, s]]))
// with the table values rounded to bf16 (round to nearest even) and the sum
// taken in f32 in s order, starting from 0. That is the function of the TPU
// kernel and of _gated_adc_jnp; the one-hot "dilution" matmul, the group-of-8
// block diagonal and the padding of codes with K there are MXU workarounds.
// On Hopper it is a table lookup.
//
// What bounds it on the card: bytes. Each query's [S, K] f32 table is read
// once (16 KB at S=16, K=256), so at B=4096, E=120 the kernel moves 67 MB of
// tables, 7.9 MB of codes and 2 MB of output: ~0.023 ms at 3.35 TB/s. The
// whole table is streamed, with 16-byte loads, because a 4-byte entry
// gathered at random from device memory costs a 32-byte sector; 120
// candidates x 16 lookups per query touch most of the table anyway.
//
// This first design is one block per query. The block stages the query's
// table in shared memory as f32 values already rounded to bf16, then each
// thread takes one candidate, reads its S code bytes (one 16-byte load per
// 16 codes when the rows are 16-byte aligned) and sums the S entries in
// order. Codes are read as unsigned bytes (no sign extension) and clamped to
// K-1, so a code past the table reads its last entry and never leaves the
// block's shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 227 * 1024;  // per block on sm_90

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Up to 16 code bytes of one row into four little-endian words (byte j in
// bits 8*(j%4) of word j/4): one 16-byte load when `vec16`, else byte loads.
__device__ __forceinline__ void load_codes16(const uint8_t* p, int cnt, int vec16,
                                             uint32_t w[4]) {
  if (vec16) {
    uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
    return;
  }
  w[0] = w[1] = w[2] = w[3] = 0u;
  for (int j = 0; j < cnt; ++j) w[j >> 2] |= static_cast<uint32_t>(p[j]) << (8 * (j & 3));
}

__global__ void gated_adc_kernel(const float* __restrict__ tables,
                                 const uint8_t* __restrict__ codes,
                                 float* __restrict__ out, int E, int S, int K,
                                 int vec16) {
  extern __shared__ float table[];  // [S * K], bf16-rounded
  const int64_t b = blockIdx.x;
  const int sk = S * K;
  const float* tb = tables + b * sk;
  if ((sk & 3) == 0 && (reinterpret_cast<uintptr_t>(tb) & 15) == 0) {
    const float4* tb4 = reinterpret_cast<const float4*>(tb);
    for (int j = threadIdx.x; j < sk / 4; j += blockDim.x) {
      float4 v = tb4[j];
      table[4 * j] = round_bf16(v.x);
      table[4 * j + 1] = round_bf16(v.y);
      table[4 * j + 2] = round_bf16(v.z);
      table[4 * j + 3] = round_bf16(v.w);
    }
  } else {
    for (int j = threadIdx.x; j < sk; j += blockDim.x) table[j] = round_bf16(tb[j]);
  }
  __syncthreads();

  const int kmax = K - 1;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const uint8_t* row = codes + (b * E + e) * S;
    float acc = 0.0f;
    for (int s0 = 0; s0 < S; s0 += 16) {
      const int cnt = S - s0 < 16 ? S - s0 : 16;
      uint32_t w[4];
      load_codes16(row + s0, cnt, vec16, w);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j < cnt) {
          int code = static_cast<int>((w[j >> 2] >> (8 * (j & 3))) & 0xFFu);
          code = code < kmax ? code : kmax;
          acc += table[(s0 + j) * K + code];
        }
      }
    }
    out[b * E + e] = acc;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int gated_adc_launch(const float* tables, const uint8_t* codes,
                                float* out, int B, int E, int S, int K,
                                void* stream) {
  if (B < 0 || E < 0 || S < 1 || K < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || E == 0) return 0;
  size_t smem = static_cast<size_t>(S) * K * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gated_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 16-byte code loads need 16-byte rows at a 16-byte-aligned base.
  int vec16 = (S % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  int threads = ((E + 31) / 32) * 32;
  threads = threads < 64 ? 64 : (threads > 256 ? 256 : threads);
  gated_adc_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      tables, codes, out, E, S, K, vec16);
  return static_cast<int>(cudaGetLastError());
}
