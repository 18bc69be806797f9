// Pairwise distance tiles for Hopper (sm_90a): kernel K4.
//
// Replaces islands_tpu/ops/pallas_kernels.py::_l2_kernel (K4a) and
// ::_dot_kernel (K4b), launched there by _pairwise_pallas through
// pairwise_l2 / pairwise_neg_dot with use_pallas=True. For q [B, d] and
// x [N, d] float32 it writes out [B, N] float32:
//   mode 0 (l2):          sqrt(max(|q|^2 + |x|^2 - 2 q.x, 0))
//   mode 1 (l2 squared):  max(|q|^2 + |x|^2 - 2 q.x, 0)
//   mode 2 (neg dot):     -q.x
// to float32 accuracy, as the reference's Precision.HIGHEST, which the TPU
// reaches with bf16 passes on the MXU.
//
// What bounds it on the card: the tensor cores. Hopper reaches float32
// accuracy there by 3xTF32: each operand v splits into big = rna_tf32(v)
// and small = rna_tf32(v - big) (v - big is exact), and
// q.x ~= q_small.x_big + q_big.x_small + q_big.x_big, the small products
// first, in float32 accumulators. That is 3 * 2*B*N*d flops at 495 TFLOP/s
// (TF32, dense): 0.42 ms at [4096, 65536, 128], against 0.33 ms for the
// bytes ((B*d + N*d + B*N) * 4 at 3.35 TB/s, the [B, N] output dominating).
//
// Design. A block of two warpgroups computes a 128 x 128 output tile: each
// warpgroup runs wgmma.mma_async m64n128k8 (tf32) on 64 q rows. d is walked
// in slices of 32 floats (128 bytes, one row of the 128-byte swizzle): a ring
// of three stages of q and x slices is filled by cp.async ahead of the
// products, 16 bytes a copy where d % 4 == 0 and both pointers are 16-byte
// aligned, else 4 bytes a copy; rows past B or N and columns past d are
// zero-filled, so ragged edges need no padded copies. x is split once in
// shared memory (big in place, small into one of two swizzled tiles), and
// both tiles feed wgmma as K-major operands through shared-memory
// descriptors; slice k + 1 is split while slice k's products run. q is
// split in registers: each thread loads its A fragments (rows g and g + 8 of
// its warp's 16, columns t and t + 4 of each k8 step) straight from the
// staged slice. The tensor cores' float32 accumulation drops low bits on
// every add, an error that grows with the adds times the sum's size: with
// one accumulator over the whole d, dots of 1024 terms missed the
// 1e-5 * |q| * |x| the kernel is held to on an H100. So each slice's 12 products go into a fresh accumulator, which is
// added into a float32 sum in registers (round to nearest) once they have
// completed. The row norms are summed in float32 from the raw staged values
// (x by the split, q from the A fragments, which sit in the rows of the
// thread's accumulators). The epilogue applies norms, clamp at 0 and sqrt in
// registers, stages the tile in shared memory (rows padded to 136 floats)
// and writes whole 512-byte rows, 16 bytes a lane, once. Tiles walk B
// fastest, so the blocks in flight share x tiles in L2. One block per SM
// (132,608 B of shared memory, two sets of 64 accumulators a thread).
// Output offsets are 64-bit; every d >= 1 launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 128;    // q rows per block: two warpgroups of 64
constexpr int kTileN = 128;    // x rows per block: the wgmma N
constexpr int kDepth = 32;     // floats of d per slice: one 128-byte swizzle row
constexpr int kThreads = 256;
constexpr int kSteps = kDepth / 8;                      // k8 wgmma steps per slice
constexpr int kStages = 3;                              // the cp.async ring
constexpr int kTileBytes = kTileM * kDepth * 4;         // one staged q or x slice
constexpr int kStageBytes = 2 * kTileBytes;             // q slice, then x slice
constexpr int kSmallOffset = kStages * kStageBytes;     // two x small tiles, after the ring
constexpr int kNormOffset = kSmallOffset + 2 * kTileBytes;  // x row norms
constexpr int kOutStride = kTileN + 8;                  // floats per staged output row
constexpr int kSmemBytes = kNormOffset + kTileN * 4 + 1024;  // + 1024-byte alignment
static_assert(kTileM * kOutStride * 4 <= kNormOffset, "output stage overlaps the norms");

// Byte offset of (row, k) in a staged slice: rows of 128 B, the 16-byte
// chunk index XOR (row % 8), the 128-byte swizzle that wgmma reads.
__device__ __forceinline__ int swz(int row, int k) {
  return row * 128 + ((((k >> 2) ^ row) & 7) << 4) + ((k & 3) << 2);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages rows [row0, row0 + 128) x columns [k0, k0 + 32) of src [rows, d]
// into the swizzled slice at shared address `tile`, zeros past rows and d.
__device__ __forceinline__ void load_slice(uint32_t tile, const float* src, int64_t row0,
                                           int rows, int d, int k0, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int i = 0; i < kTileM * kDepth / 4 / kThreads; ++i) {
      const int c = tid + i * kThreads;  // 16-byte chunk: 8 per row
      const int r = c >> 3;
      const int k = (c & 7) * 4;
      const bool ok = row0 + r < rows && k0 + k < d;
      const float* g = ok ? src + (row0 + r) * d + k0 + k : src;
      cp_async16(tile + swz(r, k), g, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kTileM * kDepth / kThreads; ++i) {
      const int e = tid + i * kThreads;  // one float: 32 per row
      const int r = e >> 5;
      const int k = e & 31;
      const bool ok = row0 + r < rows && k0 + k < d;
      const float* g = ok ? src + (row0 + r) * d + k0 + k : src;
      cp_async4(tile + swz(r, k), g, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small + O(2^-22 |v|): big rounds v to TF32 (nearest, ties away),
// small rounds the exact remainder.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(__fsub_rn(v, __uint_as_float(big)));
}

// Shared-memory descriptor of a K-major operand under the 128-byte swizzle:
// 8-row groups 1024 B apart (the stride byte offset); the leading byte
// offset is unused for this layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// c[64] = A (64 x 8 tf32: this thread's fragment a) * B (8 x 128 tf32,
// K-major in shared memory at desc), plus c unless accumulate is 0. Warp w
// of the warpgroup owns rows 16w + g and 16w + g + 8; c[4i + 2h + e] is row
// 16w + g + 8h, column 8i + 2t + e.
__device__ __forceinline__ void wgmma_m64n128k8(float (&c)[64], const uint32_t (&a)[4],
                                                uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]), "+f"(c[5]), "+f"(c[6]),
        "+f"(c[7]), "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]), "+f"(c[12]), "+f"(c[13]),
        "+f"(c[14]), "+f"(c[15]), "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]), "+f"(c[24]), "+f"(c[25]),
        "+f"(c[26]), "+f"(c[27]), "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31]),
        "+f"(c[32]), "+f"(c[33]), "+f"(c[34]), "+f"(c[35]), "+f"(c[36]), "+f"(c[37]),
        "+f"(c[38]), "+f"(c[39]), "+f"(c[40]), "+f"(c[41]), "+f"(c[42]), "+f"(c[43]),
        "+f"(c[44]), "+f"(c[45]), "+f"(c[46]), "+f"(c[47]), "+f"(c[48]), "+f"(c[49]),
        "+f"(c[50]), "+f"(c[51]), "+f"(c[52]), "+f"(c[53]), "+f"(c[54]), "+f"(c[55]),
        "+f"(c[56]), "+f"(c[57]), "+f"(c[58]), "+f"(c[59]), "+f"(c[60]), "+f"(c[61]),
        "+f"(c[62]), "+f"(c[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// Splits row `row` of the staged x slice at `xt` (16 floats from this
// thread's half): big in place, small into `small`; adds their squares to xn.
template <int MODE>
__device__ __forceinline__ void split_x_slice(uint8_t* xt, uint8_t* small, int row, int half,
                                              float& xn) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int off = swz(row, (half * 4 + j) * 4);
    const float4 v = *reinterpret_cast<const float4*>(xt + off);
    if (MODE != 2) {
      xn = fmaf(v.x, v.x, xn);
      xn = fmaf(v.y, v.y, xn);
      xn = fmaf(v.z, v.z, xn);
      xn = fmaf(v.w, v.w, xn);
    }
    uint4 big, sm;
    split_tf32(v.x, big.x, sm.x);
    split_tf32(v.y, big.y, sm.y);
    split_tf32(v.z, big.z, sm.z);
    split_tf32(v.w, big.w, sm.w);
    *reinterpret_cast<uint4*>(xt + off) = big;
    *reinterpret_cast<uint4*>(small + off) = sm;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
pairwise_kernel(const float* __restrict__ q, const float* __restrict__ x,
                float* __restrict__ out, int B, int N, int d, int tiles_b, int vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw_s & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + pad;  // 1024-byte aligned, as the swizzle wants
  const uint32_t smem_s = raw_s + pad;
  float* xn_s = reinterpret_cast<float*>(smem + kNormOffset);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x % tiles_b) * kTileM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x / tiles_b) * kTileN;
  const int arow = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // and arow + 8
  const int xrow = tid >> 1;                                 // the x row this thread splits
  const int num_k = (d + kDepth - 1) / kDepth;

  float acc[64];   // the float32 sum over slices
  float part[64];  // one slice's products, from the tensor cores
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  float qn_lo = 0.0f, qn_hi = 0.0f, xn = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < num_k) {
      load_slice(smem_s + s * kStageBytes, q, row0, B, d, s * kDepth, vec);
      load_slice(smem_s + s * kStageBytes + kTileBytes, x, col0, N, d, s * kDepth, vec);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // slice 0 has landed
  __syncthreads();
  split_x_slice<MODE>(smem + kTileBytes, smem + kSmallOffset, xrow, tid & 1, xn);

  for (int kt = 0; kt < num_k; ++kt) {
    const int slot = kt % kStages;
    const float* qt = reinterpret_cast<const float*>(smem + slot * kStageBytes);
    const uint32_t xt_s = smem_s + slot * kStageBytes + kTileBytes;
    const uint32_t small_s = smem_s + kSmallOffset + (kt & 1) * kTileBytes;
    fence_proxy_async();  // slice kt's split tiles are read by wgmma (the async proxy)
    __syncthreads();

    // Two sets of A registers: a step's fragments stay untouched until its
    // group has completed (wait_group 1 after the next commit).
    uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int k = ks * 8 + t;
      const float v[4] = {qt[swz(arow, k) >> 2], qt[swz(arow + 8, k) >> 2],
                          qt[swz(arow, k + 4) >> 2], qt[swz(arow + 8, k + 4) >> 2]};
      if (MODE != 2) {
        qn_lo = fmaf(v[0], v[0], qn_lo);
        qn_lo = fmaf(v[2], v[2], qn_lo);
        qn_hi = fmaf(v[1], v[1], qn_hi);
        qn_hi = fmaf(v[3], v[3], qn_hi);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], a_big[ks & 1][i], a_small[ks & 1][i]);
      wgmma_fence();
      const uint32_t koff = ks * 32;  // bytes: 8 floats of each 128-byte row
      wgmma_m64n128k8(part, a_small[ks & 1], smem_desc(xt_s + koff), ks > 0);
      wgmma_m64n128k8(part, a_big[ks & 1], smem_desc(small_s + koff), 1);
      wgmma_m64n128k8(part, a_big[ks & 1], smem_desc(xt_s + koff), 1);
      wgmma_commit();
      wgmma_wait<1>();
    }

    // While the last products run: split slice kt + 1 (its small tile was
    // read by slice kt - 1's products, which have completed).
    if (kt + 1 < num_k) {
      cp_async_wait<kStages - 2>();  // slice kt + 1 has landed
      __syncthreads();
      const int next = (kt + 1) % kStages;
      split_x_slice<MODE>(smem + next * kStageBytes + kTileBytes,
                          smem + kSmallOffset + ((kt + 1) & 1) * kTileBytes, xrow, tid & 1, xn);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      asm volatile("" : "+f"(part[i])::"memory");
      acc[i] += part[i];
    }
    __syncthreads();  // every warpgroup is done with this slot
    if (kt + kStages < num_k) {
      load_slice(smem_s + slot * kStageBytes, q, row0, B, d, (kt + kStages) * kDepth, vec);
      load_slice(xt_s, x, col0, N, d, (kt + kStages) * kDepth, vec);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (MODE != 2) {
    // Rows arow and arow + 8: the four lanes of a group hold disjoint columns.
    qn_lo += __shfl_xor_sync(0xffffffffu, qn_lo, 1);
    qn_lo += __shfl_xor_sync(0xffffffffu, qn_lo, 2);
    qn_hi += __shfl_xor_sync(0xffffffffu, qn_hi, 1);
    qn_hi += __shfl_xor_sync(0xffffffffu, qn_hi, 2);
    xn += __shfl_xor_sync(0xffffffffu, xn, 1);
    if ((tid & 1) == 0) xn_s[xrow] = xn;
  }
  __syncthreads();

  // Epilogue in registers, then one staged, coalesced write of the tile.
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * i + 2 * h];
      float v1 = acc[4 * i + 2 * h + 1];
      if (MODE == 2) {
        v0 = -v0;
        v1 = -v1;
      } else {
        const float qn = h ? qn_hi : qn_lo;
        v0 = fmaxf(qn + xn_s[col] - 2.0f * v0, 0.0f);
        v1 = fmaxf(qn + xn_s[col + 1] - 2.0f * v1, 0.0f);
        if (MODE == 0) {
          v0 = sqrtf(v0);
          v1 = sqrtf(v1);
        }
      }
      *reinterpret_cast<float2*>(stage + (arow + 8 * h) * kOutStride + col) =
          make_float2(v0, v1);
    }
  }
  __syncthreads();

  const bool vec_out = (N & 3) == 0;
  for (int r = warp; r < kTileM; r += kThreads / 32) {
    const int64_t grow = row0 + r;
    if (grow >= B) break;
    float* orow = out + grow * N + col0;
    const float* srow = stage + r * kOutStride;
    if (vec_out) {
      const int c = lane * 4;
      if (col0 + c < N) {
        __stcs(reinterpret_cast<float4*>(orow + c), *reinterpret_cast<const float4*>(srow + c));
      }
    } else {
      for (int c = lane; c < kTileN; c += 32) {
        if (col0 + c < N) __stcs(orow + c, srow[c]);
      }
    }
  }
}

template <int MODE>
int launch(const float* q, const float* x, float* out, int B, int N, int d, int vec,
           cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles_b = (B + kTileM - 1) / kTileM;
  const int64_t blocks = tiles_b * ((N + kTileN - 1) / kTileN);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  pairwise_kernel<MODE><<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, s>>>(
      q, x, out, B, N, d, static_cast<int>(tiles_b), vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns a CUDA error code (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take (d < 1, an
// unknown mode, more than 2^31 - 1 tiles).
extern "C" int pairwise_launch(const float* q, const float* x, float* out, int B,
                               int N, int d, int mode, void* stream) {
  if (B < 0 || N < 0 || d < 1 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || N == 0) return 0;
  const int vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch<0>(q, x, out, B, N, d, vec, s);
  if (mode == 1) return launch<1>(q, x, out, B, N, d, vec, s);
  return launch<2>(q, x, out, B, N, d, vec, s);
}
