// Pairwise distance tiles for Hopper (sm_90a): kernel K4.
//
// Replaces islands_tpu/ops/pallas_kernels.py::_l2_kernel (K4a) and
// ::_dot_kernel (K4b), launched there by _pairwise_pallas through
// pairwise_l2 / pairwise_neg_dot with use_pallas=True. For q [B, d] and
// x [N, d] float32 it writes out [B, N] float32:
//   mode 0 (l2):          sqrt(max(|q|^2 + |x|^2 - 2 q.x, 0))
//   mode 1 (l2 squared):  max(|q|^2 + |x|^2 - 2 q.x, 0)
//   mode 2 (neg dot):     -q.x
// in full float32, as the reference's Precision.HIGHEST: FMAs on the CUDA
// cores, no TF32.
//
// What bounds it on the card: operations. 2*B*N*d flops at the 67 TFLOP/s
// float32 rate is 1.03 ms at [4096, 65536, 128], against 0.33 ms for the
// bytes ((B*d + N*d + B*N) * 4 at 3.35 TB/s, the [B, N] output dominating).
// Each output is written once; q and x tiles are read from device memory
// once per tile pair and reused from shared memory 128 times.
//
// This first design is a classic register-tiled SGEMM. A block computes a
// 128 x 128 output tile with 256 threads, 8 x 8 outputs per thread in two
// 4-wide strips (rows ty*4 and 64 + ty*4, columns likewise), so that the
// 16-byte shared-memory reads of a warp do not conflict. The K loop walks d
// in slices of 8: the block stages q[128, 8] and x[128, 8] transposed
// (k-major, rows padded to 132 floats) in shared memory, then every thread
// runs 64 FMAs per k. The row norms |q|^2 and |x|^2 are summed from the same
// staged slices, as the TPU kernel does in its body: threads 0..127 each own
// one q row, threads 128..255 one x row. The epilogue (clamp at 0, sqrt)
// runs in registers before the single write of the output. The kernel masks
// ragged B, N and d itself (zeros are staged past the edges), with no padded
// copies, and output offsets are 64-bit. tf32 splitting on the tensor
// cores, wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kDepth = 8;
constexpr int kThreads = 256;
constexpr int kStride = kTile + 4;  // padded row of a staged slice

template <int MODE>
__global__ void __launch_bounds__(kThreads)
pairwise_kernel(const float* __restrict__ q, const float* __restrict__ x,
                float* __restrict__ out, int B, int N, int d, int vec) {
  __shared__ __align__(16) float qs[kDepth * kStride];
  __shared__ __align__(16) float xs[kDepth * kStride];
  __shared__ float qn_s[kTile];
  __shared__ float xn_s[kTile];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kTile;

  // Staging: each thread moves 4 consecutive k of one q row and one x row.
  const int lr = tid >> 1;
  const int lk = (tid & 1) * 4;
  const bool q_ok = row0 + lr < B;
  const bool x_ok = col0 + lr < N;
  const float* q_row = q + (q_ok ? (row0 + lr) * d : 0);
  const float* x_row = x + (x_ok ? (col0 + lr) * d : 0);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  float norm = 0.0f;  // |q|^2 of row tid, or |x|^2 of row tid - 128

  for (int k0 = 0; k0 < d; k0 += kDepth) {
    const int kb = k0 + lk;
    float qv[4], xv[4];
    if (vec && kb < d) {
      // d % 4 == 0 and 16-byte aligned rows: kb..kb+3 all lie inside d.
      float4 a = q_ok ? *reinterpret_cast<const float4*>(q_row + kb) : make_float4(0, 0, 0, 0);
      float4 b = x_ok ? *reinterpret_cast<const float4*>(x_row + kb) : make_float4(0, 0, 0, 0);
      qv[0] = a.x; qv[1] = a.y; qv[2] = a.z; qv[3] = a.w;
      xv[0] = b.x; xv[1] = b.y; xv[2] = b.z; xv[3] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = (q_ok && kb + j < d) ? q_row[kb + j] : 0.0f;
        xv[j] = (x_ok && kb + j < d) ? x_row[kb + j] : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      qs[(lk + j) * kStride + lr] = qv[j];
      xs[(lk + j) * kStride + lr] = xv[j];
    }
    __syncthreads();

    {
      const float* src = tid < kTile ? qs : xs;
      const int r = tid & (kTile - 1);
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        const float v = src[k * kStride + r];
        norm = fmaf(v, v, norm);
      }
    }

#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&qs[k * kStride + ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&qs[k * kStride + 64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&xs[k * kStride + tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&xs[k * kStride + 64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if (tid < kTile) {
    qn_s[tid] = norm;
  } else {
    xn_s[tid - kTile] = norm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4);
    const int64_t grow = row0 + r;
    if (grow >= B) continue;
    const float qn = qn_s[r];
    float* orow = out + grow * static_cast<int64_t>(N);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
      const int64_t gcol = col0 + c;
      if (gcol >= N) continue;
      float v = acc[i][j];
      if (MODE == 2) {
        v = -v;
      } else {
        const float d2 = fmaxf(qn + xn_s[c] - 2.0f * v, 0.0f);
        v = (MODE == 0) ? sqrtf(d2) : d2;
      }
      orow[gcol] = v;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue for shapes the kernel does not take (B past
// 65535 * 128 rows, d < 1, an unknown mode).
extern "C" int pairwise_launch(const float* q, const float* x, float* out, int B,
                               int N, int d, int mode, void* stream) {
  if (B < 0 || N < 0 || d < 1 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || N == 0) return 0;
  const dim3 grid((N + kTile - 1) / kTile, (B + kTile - 1) / kTile);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    pairwise_kernel<0><<<grid, kThreads, 0, s>>>(q, x, out, B, N, d, vec);
  } else if (mode == 1) {
    pairwise_kernel<1><<<grid, kThreads, 0, s>>>(q, x, out, B, N, d, vec);
  } else {
    pairwise_kernel<2><<<grid, kThreads, 0, s>>>(q, x, out, B, N, d, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
