// Row gather for Hopper (sm_90a): kernel K5.
//
// Replaces benches/gather_bench.py::_gather_kernel (launched there by
// pallas_gather): out[i] = x[ids[i]] for x [N, D] of 4-byte elements and
// int32 ids [K]. Ids are clamped to [0, N-1], as the bench's callers clamp
// them before the call, so the kernel and its plain version agree on every
// input. The TPU kernel walks K in 1024-row chunks (grid k // 1024) and
// never writes the rows past the last full chunk; this kernel takes any K.
//
// What bounds it on the card: bytes. K rows read at random and written in
// order, plus the ids: 2*K*D*4 + 4*K bytes, 0.040 ms at K = 131,072 and
// D = 128 at 3.35 TB/s. A random row is a whole number of 32-byte sectors
// (512 bytes at D = 128), so no sector is fetched for a single word.
//
// Design: the TPU kernel keeps 16 row DMAs in flight per chunk; here the
// warps do. A warp takes 32 rows at a time: each lane loads one id (one
// coalesced 128-byte read), clamps it, and the ids are passed around with
// shuffles. A row is copied by the whole warp, each lane moving 16 bytes
// (one instruction covers a 512-byte row), four rows at once so that every
// lane has four independent loads in flight before it stores. Rows whose
// width is not a multiple of 4 elements, or whose base is not 16-byte
// aligned, go through the same loop 4 bytes a lane. The grid strides over
// K, so any K launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// T is the unit a lane moves: uint4 (16 bytes) or unsigned int (4 bytes);
// `w` is the row width in units.
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const T* __restrict__ x, const int* __restrict__ ids,
                  T* __restrict__ out, int64_t K, int N, int w) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t base = warp * 32; base < K; base += warps * 32) {
    const int64_t i = base + lane;
    int id = i < K ? ids[i] : 0;
    id = id < 0 ? 0 : (id > N - 1 ? N - 1 : id);
    const int cnt = K - base < 32 ? static_cast<int>(K - base) : 32;
    for (int r = 0; r < cnt; r += 4) {
      int64_t src[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        src[u] = static_cast<int64_t>(__shfl_sync(kFull, id, (r + u) & 31)) * w;
      }
      for (int c = lane; c < w; c += 32) {
        T v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (r + u < cnt) v[u] = x[src[u] + c];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (r + u < cnt) out[(base + r + u) * w + c] = v[u];
        }
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue for shapes the kernel does not take (N < 1 with
// K > 0, D < 1).
extern "C" int row_gather_launch(const void* x, const int* ids, void* out, int64_t K,
                                 int N, int D, void* stream) {
  if (K < 0 || N < 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) return 0;
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (K + kThreads - 1) / kThreads;  // 8 warps x 32 rows a block
  blocks = blocks < 1 ? 1 : (blocks > 65535 ? 65535 : blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (D % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec) {
    row_gather_kernel<uint4><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const uint4*>(x), ids, static_cast<uint4*>(out), K, N, D / 4);
  } else {
    row_gather_kernel<unsigned int><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const unsigned int*>(x), ids, static_cast<unsigned int*>(out), K, N, D);
  }
  return static_cast<int>(cudaGetLastError());
}
