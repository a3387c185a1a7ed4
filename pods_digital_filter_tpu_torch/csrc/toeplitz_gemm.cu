// K2: the two filter products of a slab on given noise, for Hopper (sm_90a):
//   out[i] = ByM @ cast(cast(noise[i]) @ BzT)
// with noise (total, jn, kn) in f32 or bf16, BzT (kn, kma) and ByM (jma, jn)
// both f32 or both bf16, and out (total, jma, kma) f32.  The noise is cast to
// the tap dtype before the first product and t = noise @ BzT to ByM's dtype
// before the second; products are summed in f32.
//
// Replaces the Pallas body _kernel_gemms of
// benchmarks/exp_two_kernel_pipeline.py:59-63, which split_pipeline (noise in
// HBM from a first kernel), gemm_only and xla_rng_pipeline run (rows 5 and 6
// of the kernel table in PERF.md).  The matrices are taken as general dense
// matrices: no band is assumed (the banded form of the same work is K1's
// noise-in mode).
//
// Design: one block per (slab, 64-column strip of the output).  Phase 1
// computes the strip's t[:, strip] = x @ BzT[:, strip] (jn x 64) into shared
// memory, 64 rows at a time; phase 2 computes out[:, strip] = ByM @ t, 64
// rows at a time, with t read from shared memory.  t never reaches device
// memory; the noise slab is read once per strip (8 times per slab at kma =
// 512, from L2 after the first).
//   bf16 taps: mma.sync m16n8k16 bf16 x bf16 -> f32 on the tensor cores;
//     eight warps, each 16 rows x 32 columns of a 64 x 64 step; t is kept
//     transposed in bf16 (64 x jn), which is the layout the second product's
//     B operand wants.
//   f32 taps: f32 FMAs, 16 x 16 threads with 4 x 4 outputs each; t in f32.
//
// What bounds it: 2 (jn kn kma + jma jn kma) FLOP per slab, 0.56 GFLOP at
// 512x512 nf=8, 134 GFLOP per 240-slab experiment window and 1.75 TFLOP per
// 3 x 1,040 window.  At the H100's 989 TFLOP/s dense bf16 that is 1.8 ms per
// 1,040 x 3 window; at 67 TFLOP/s f32 without tensor cores, 26 ms.  Most of
// those FLOPs multiply zeros of the Toeplitz band: K1 does the same filter in
// (2nf+1)/jn of them.  Device-memory traffic is small beside it (the noise,
// 3.5 GB f32 per window, and the f32 output, 3.3 GB).  This first version
// loads its operands with scalar loads and single buffering, and the tensor
// cores wait on that staging: about 69 ms per 1,040 x 3 window with bf16
// taps (2.5 % of the peak) and 143 ms with f32 taps, against 42 ms and 35 ms
// for cuBLAS f32 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC (ops/_build.py); plain C entry points for ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 64;      // output columns per block
constexpr int kRows = 64;       // rows per product step
constexpr int kMaxGridY = 65535;

// f32 path
constexpr int kBk = 16;         // depth per shared-memory step
constexpr int kLdA = kRows + 4; // A^T chunk row stride (floats)

// bf16 path
constexpr int kBkH = 32;        // depth per shared-memory step (two mma k16)
constexpr int kLdH = kBkH + 8;  // row stride of the A and B^T chunks (bf16)

struct Params {
  const void* noise;   // (total, jn, kn)
  const void* bzT;     // (kn, kma)
  const void* byM;     // (jma, jn)
  float* out;          // (total, jma, kma)
  int jn, kn, jma, kma, total;
};

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ __nv_bfloat16 as_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ __nv_bfloat16 as_bf16(__nv_bfloat16 v) { return v; }

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

template <typename NoiseT>
__global__ void __launch_bounds__(kThreads) gemm_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int jn_pad = round_up(p.jn, kBk);
  float* t = smem;                       // (jn_pad, kStrip)
  float* As = t + jn_pad * kStrip;       // (kBk, kLdA): A^T chunk
  float* Bs = As + kBk * kLdA;           // (kBk, kStrip)
  const NoiseT* noise = static_cast<const NoiseT*>(p.noise);
  const float* bzT = static_cast<const float*>(p.bzT);
  const float* byM = static_cast<const float*>(p.byM);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kStrip;

  for (int slab = blockIdx.y; slab < p.total; slab += gridDim.y) {
    const NoiseT* x = noise + static_cast<size_t>(slab) * p.jn * p.kn;
    // phase 1: t[m, n] = sum_k x[m, k] bzT[k, n0 + n]
    for (int m0 = 0; m0 < jn_pad; m0 += kRows) {
      float acc[4][4] = {};
      for (int k0 = 0; k0 < p.kn; k0 += kBk) {
        __syncthreads();
        for (int i = tid; i < kRows * kBk; i += kThreads) {
          const int mm = i / kBk, kk = i % kBk;
          const int m = m0 + mm, k = k0 + kk;
          As[kk * kLdA + mm] =
              (m < p.jn && k < p.kn) ? as_float(x[static_cast<size_t>(m) * p.kn + k]) : 0.f;
        }
        for (int i = tid; i < kBk * kStrip; i += kThreads) {
          const int kk = i / kStrip, nn = i % kStrip;
          const int k = k0 + kk, n = n0 + nn;
          Bs[i] = (k < p.kn && n < p.kma) ? bzT[static_cast<size_t>(k) * p.kma + n] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBk; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(As + kk * kLdA + ty * 4);
          const float4 b = *reinterpret_cast<const float4*>(Bs + kk * kStrip + tx * 4);
          const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty * 4 + i;
        if (m < jn_pad)
#pragma unroll
          for (int j = 0; j < 4; ++j) t[m * kStrip + tx * 4 + j] = acc[i][j];
      }
    }
    // phase 2: out[m, n0 + n] = sum_k byM[m, k] t[k, n]
    float* dst = p.out + static_cast<size_t>(slab) * p.jma * p.kma;
    for (int m0 = 0; m0 < p.jma; m0 += kRows) {
      float acc[4][4] = {};
      for (int k0 = 0; k0 < jn_pad; k0 += kBk) {
        __syncthreads();  // also: phase 1's t is complete
        for (int i = tid; i < kRows * kBk; i += kThreads) {
          const int mm = i / kBk, kk = i % kBk;
          const int m = m0 + mm, k = k0 + kk;
          As[kk * kLdA + mm] =
              (m < p.jma && k < p.jn) ? byM[static_cast<size_t>(m) * p.jn + k] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBk; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(As + kk * kLdA + ty * 4);
          const float4 b = *reinterpret_cast<const float4*>(t + (k0 + kk) * kStrip + tx * 4);
          const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty * 4 + i;
        if (m >= p.jma) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx * 4 + j;
          if (n < p.kma) dst[static_cast<size_t>(m) * p.kma + n] = acc[i][j];
        }
      }
    }
    __syncthreads();  // t and As are reused by the next slab
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A (16x16, row) * B (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows r, r+8 and columns c..c+1, c+8..c+9 of a row-major chunk
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* A,
                                       int ld, int r, int c) {
  a[0] = ld32(A + r * ld + c);
  a[1] = ld32(A + (r + 8) * ld + c);
  a[2] = ld32(A + r * ld + c + 8);
  a[3] = ld32(A + (r + 8) * ld + c + 8);
}

template <typename NoiseT>
__global__ void __launch_bounds__(kThreads) gemm_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int jn_pad = round_up(p.jn, kRows);
  const int ldt = jn_pad + 8;
  __nv_bfloat16* tT = smem;                  // (kStrip, ldt): t transposed
  __nv_bfloat16* As = tT + kStrip * ldt;     // (kRows, kLdH)
  __nv_bfloat16* Bs = As + kRows * kLdH;     // (kStrip, kLdH): B^T chunk
  const NoiseT* noise = static_cast<const NoiseT*>(p.noise);
  const __nv_bfloat16* bzT = static_cast<const __nv_bfloat16*>(p.bzT);
  const __nv_bfloat16* byM = static_cast<const __nv_bfloat16*>(p.byM);
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp % 4, wn = warp / 4;    // 16-row x 32-column warp tile
  const int n0 = blockIdx.x * kStrip;

  for (int slab = blockIdx.y; slab < p.total; slab += gridDim.y) {
    const NoiseT* x = noise + static_cast<size_t>(slab) * p.jn * p.kn;
    // phase 1: tT[n, m] = bf16(sum_k x[m, k] bzT[k, n0 + n])
    for (int m0 = 0; m0 < jn_pad; m0 += kRows) {
      float c[4][4] = {};
      for (int k0 = 0; k0 < p.kn; k0 += kBkH) {
        __syncthreads();
        for (int i = tid; i < kRows * kBkH; i += kThreads) {
          const int mm = i / kBkH, kk = i % kBkH;
          const int m = m0 + mm, k = k0 + kk;
          As[mm * kLdH + kk] = (m < p.jn && k < p.kn)
                                   ? as_bf16(x[static_cast<size_t>(m) * p.kn + k])
                                   : __float2bfloat16_rn(0.f);
        }
        for (int i = tid; i < kBkH * kStrip; i += kThreads) {
          const int kk = i / kStrip, nn = i % kStrip;
          const int k = k0 + kk, n = n0 + nn;
          Bs[nn * kLdH + kk] = (k < p.kn && n < p.kma)
                                   ? bzT[static_cast<size_t>(k) * p.kma + n]
                                   : __float2bfloat16_rn(0.f);
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < kBkH; ks += 16) {
          uint32_t a[4];
          load_a(a, As, kLdH, wm * 16 + g, ks + 2 * q);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const __nv_bfloat16* b = Bs + (wn * 32 + j * 8 + g) * kLdH + ks + 2 * q;
            mma_bf16(c[j], a, ld32(b), ld32(b + 8));
          }
        }
      }
      const int m = m0 + wm * 16 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + 2 * q;
        tT[n * ldt + m] = __float2bfloat16_rn(c[j][0]);
        tT[(n + 1) * ldt + m] = __float2bfloat16_rn(c[j][1]);
        tT[n * ldt + m + 8] = __float2bfloat16_rn(c[j][2]);
        tT[(n + 1) * ldt + m + 8] = __float2bfloat16_rn(c[j][3]);
      }
    }
    // phase 2: out[m, n0 + n] = sum_k byM[m, k] t[k, n]
    float* dst = p.out + static_cast<size_t>(slab) * p.jma * p.kma;
    for (int m0 = 0; m0 < p.jma; m0 += kRows) {
      float c[4][4] = {};
      for (int k0 = 0; k0 < jn_pad; k0 += kBkH) {
        __syncthreads();  // also: phase 1's tT is complete
        for (int i = tid; i < kRows * kBkH; i += kThreads) {
          const int mm = i / kBkH, kk = i % kBkH;
          const int m = m0 + mm, k = k0 + kk;
          As[mm * kLdH + kk] = (m < p.jma && k < p.jn)
                                   ? byM[static_cast<size_t>(m) * p.jn + k]
                                   : __float2bfloat16_rn(0.f);
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < kBkH; ks += 16) {
          uint32_t a[4];
          load_a(a, As, kLdH, wm * 16 + g, ks + 2 * q);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const __nv_bfloat16* b = tT + (wn * 32 + j * 8 + g) * ldt + k0 + ks + 2 * q;
            mma_bf16(c[j], a, ld32(b), ld32(b + 8));
          }
        }
      }
      const int m = m0 + wm * 16 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {       // rows m, m + 8
          const int mr = m + 8 * h;
          if (mr >= p.jma) continue;
          if (n < p.kma) dst[static_cast<size_t>(mr) * p.kma + n] = c[j][2 * h];
          if (n + 1 < p.kma) dst[static_cast<size_t>(mr) * p.kma + n + 1] = c[j][2 * h + 1];
        }
      }
    }
    __syncthreads();  // tT and As are reused by the next slab
  }
}

int smem_bytes(int jn, int bf16_taps) {
  if (bf16_taps)
    return static_cast<int>(sizeof(__nv_bfloat16)) *
           (kStrip * (round_up(jn, kRows) + 8) + kRows * kLdH + kStrip * kLdH);
  return static_cast<int>(sizeof(float)) *
         (round_up(jn, kBk) * kStrip + kBk * kLdA + kBk * kStrip);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.kma + kStrip - 1) / kStrip,
                  static_cast<unsigned int>(p.total < kMaxGridY ? p.total : kMaxGridY));
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int toeplitz_gemm_smem_bytes(int jn, int bf16_taps) { return smem_bytes(jn, bf16_taps); }

// Launches K2 on `stream`; returns the cudaError_t of the launch.
int toeplitz_gemm_launch(int bf16_taps, int noise_bf16, const void* noise,
                         const void* bzT, const void* byM, float* out, int jn,
                         int kn, int jma, int kma, int total, void* stream) {
  Params p{noise, bzT, byM, out, jn, kn, jma, kma, total};
  const int smem = smem_bytes(jn, bf16_taps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16_taps)
    err = noise_bf16 ? launch(gemm_bf16_kernel<__nv_bfloat16>, p, smem, s)
                     : launch(gemm_bf16_kernel<float>, p, smem, s);
  else
    err = noise_bf16 ? launch(gemm_f32_kernel<__nv_bfloat16>, p, smem, s)
                     : launch(gemm_f32_kernel<float>, p, smem, s);
  return static_cast<int>(err);
}

}  // extern "C"
