// K5: the generation tail after K1, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this tail to XLA, which
// fuses it on the TPU.  The port ran it as plain PyTorch (the dense
// Toeplitz FIR, Lund's elementwise ops and their stack, the pack, the
// rotation's product and the centring), six passes over the block with
// three transposing copies; K5 does it in one.
//
// What it computes, from K1's spatially filtered slabs z (3, S, np) f32,
// S = nsteps + 2nfx, np = jma * kma, the finished packed block
// out (3 np, nsteps) with row c np + p and time innermost:
//   x_c  = sum_i bx[i] z[c, t + i, p], one fmaf chain in ascending i from 0
//          (K4's order);
//   Lund: u = a00 x0 + U, v = a10 x0 + a11 x1 + V,
//         w = a20 x0 + a21 x1 + a22 x2 + W, from the six Cholesky factors
//         that lund.lund_cholesky computes, each product and sum rounded
//         on its own, as the plain chain's separate elementwise ops round
//         them (no contraction into fma);
//   rotation (optional): o_c = sum_d R[c, d] (u, v, w)_d, one fmaf chain;
//   centring (optional): o_c - center[c np + p].
// It equals the plain chain (ops/fused_tail.py) up to the summation order
// of the FIR and of the rotation, which the plain chain leaves to cuBLAS.
//
// bfloat16 output (the generator's bf16 route): the same work, rounded
// to bf16 (to nearest even) wherever the plain bf16 chain rounds, and at
// no other point: the FIR's f32 sum once; each of Lund's products and sums
// on its own (the factors, means, rotation and centre arrive as f32 that
// hold bf16 values, so every product is exact in f32 before it is
// rounded); the rotation's 3-term f32 sum once; the centring.  The tile
// stays f32 in shared memory and leaves it as 16-byte runs of 8 bf16.
//
// What bounds it: bytes.  It must read the slabs once and write the block
// once, 4 * 3 np (S + nsteps) bytes (6.54 GB at 1024 x 512, 512 steps, nf 8:
// 1.95 ms at 3.35 TB/s; in bf16 3 np (4 S + 2 nsteps), 4.88 GB at 512 x 512,
// 1,024 steps: 1.46 ms), against 3 (2nfx + 1) FMAs and about 20 other
// operations a point and step (0.6 ms of the f32 issue rate at that shape).
// What the design does about it:
//  * a block owns 128 consecutive points, one a thread, and a chunk of
//    output steps; each thread walks time for its point with all three
//    components at once, so Lund and the rotation see the whole vector.  At
//    nfx = 8 (the cells' nf) the last 2nfx slabs of each component stay in
//    registers with the next 8, so every slab value is read from device
//    memory once, the warp's 32 neighbouring points as one 128-byte load;
//    each group of 8 steps issues its 24 loads together (128 registers a
//    thread, four 128-thread blocks an SM; asking L2 for the slabs of the
//    group 2 to 8 groups ahead made it 17-32 % slower, one group ahead
//    changed nothing, so nothing is prefetched);
//  * the results go through shared memory, a (3, 128, 32-step) tile with
//    rows 36 floats apart (float4 stores from the threads meet no bank
//    conflict), and leave it as float4 runs of 32 steps of one row: every
//    warp store writes four whole 128-byte lines;
//  * any other nfx reads its taps' slabs through the cache (no register
//    window), with the same arithmetic in the same order.
// Nothing block-sized but z and out touches device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kTailThreads = 128;  // points of a block, one a thread
constexpr int kTailSteps = 32;     // output steps of a tile
constexpr int kGroup = 8;          // output steps a thread computes at once
constexpr int kRow = kTailSteps + 4;  // pitch of a tile row, in floats
constexpr int kMaxGridY = 65535;

struct Params {
  const float* z;        // (3, num_slabs, np) K1's slabs
  void* out;             // (3 np, nsteps) of the kernel's output type
  const float* factors;  // (6, np): a00, a10, a11, a20, a21, a22
  const float* means;    // (3, np)
  const float* center;   // (3 np,) or nullptr
  const float* bx;       // (2 nfx + 1,)
  const float* rot;      // (3, 3) row-major, or nullptr
  long long np;
  int nfx;
  int nsteps;
  int num_slabs;
  int chunk;             // output steps of a block, a multiple of kTailSteps
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

int smem_bytes(int nfx) {
  return static_cast<int>(sizeof(float)) *
         (3 * kTailThreads * kRow + round4(2 * nfx + 1) + 12);
}

// one point's Lund factors, means and centre
struct Point {
  float a00, a10, a11, a20, a21, a22;
  float mu, mv, mw;
  float cu, cv, cw;
};

// x as the block's type rounds it (to the nearest bf16, ties to even), as
// an f32; for a float block x itself, so the float32 mode's code is as if
// there were no rounding at all
template <typename OutT>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (std::is_same<OutT, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// Lund, the rotation and the centring of one point and step, rounded to
// OutT as the plain chain in that type rounds: every elementwise result on
// its own, the rotation's 3-term sum once
template <typename OutT>
__device__ __forceinline__ void finish(const Point& q, const float* rot,
                                       bool centre, float x0, float x1,
                                       float x2, float (&o)[3]) {
  const auto r = [](float x) { return rnd<OutT>(x); };
  x0 = r(x0);
  x1 = r(x1);
  x2 = r(x2);
  const float u = r(__fadd_rn(r(__fmul_rn(q.a00, x0)), q.mu));
  const float v = r(__fadd_rn(
      r(__fadd_rn(r(__fmul_rn(q.a10, x0)), r(__fmul_rn(q.a11, x1)))), q.mv));
  const float w = r(__fadd_rn(
      r(__fadd_rn(r(__fadd_rn(r(__fmul_rn(q.a20, x0)), r(__fmul_rn(q.a21, x1)))),
                  r(__fmul_rn(q.a22, x2)))),
      q.mw));
  if (rot != nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o[c] = r(fmaf(rot[3 * c + 2], w, fmaf(rot[3 * c + 1], v, __fmul_rn(rot[3 * c], u))));
  } else {
    o[0] = u;
    o[1] = v;
    o[2] = w;
  }
  if (centre) {
    o[0] = r(__fsub_rn(o[0], q.cu));
    o[1] = r(__fsub_rn(o[1], q.cv));
    o[2] = r(__fsub_rn(o[2], q.cw));
  }
}

// two steps as bf16, the first in the low half (the lower address)
__device__ __forceinline__ unsigned int pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  unsigned int u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// the tile's steps [n, n1) of the block's points to out, as 16-byte runs
// (4 f32 or 8 bf16) where every row starts 16-byte aligned (nsteps a
// multiple of the run), else one value at a time
template <typename OutT>
__device__ __forceinline__ void store_tile(const Params& p, const float* tile,
                                           long long pt0, int n, int n1) {
  constexpr bool kBf16 = std::is_same<OutT, __nv_bfloat16>::value;
  constexpr int kRun = 16 / static_cast<int>(sizeof(OutT));  // values a run
  OutT* out = static_cast<OutT*>(p.out);
  const int cols = min(kTailSteps, n1 - n);
  const int pts = static_cast<int>(min(static_cast<long long>(kTailThreads), p.np - pt0));
  const size_t T = static_cast<size_t>(p.nsteps);
  if ((p.nsteps & (kRun - 1)) == 0) {
    constexpr int kVec = kTailSteps / kRun;
    for (int f = threadIdx.x; f < 3 * kTailThreads * kVec; f += kTailThreads) {
      const int row = f / kVec, v = f % kVec;
      const int c = row / kTailThreads, q = row % kTailThreads;
      if (q >= pts || kRun * v >= cols) continue;
      const float* src = tile + row * kRow + kRun * v;
      OutT* dst = out + (static_cast<size_t>(c) * p.np + pt0 + q) * T + n + kRun * v;
      if constexpr (kBf16) {
        // the values are bf16 already: the conversion is exact
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 b = *reinterpret_cast<const float4*>(src + 4);
        *reinterpret_cast<uint4*>(dst) = make_uint4(pack2(a.x, a.y), pack2(a.z, a.w),
                                                    pack2(b.x, b.y), pack2(b.z, b.w));
      } else {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      }
    }
  } else {
    for (int f = threadIdx.x; f < 3 * kTailThreads * kTailSteps; f += kTailThreads) {
      const int row = f / kTailSteps, t = f % kTailSteps;
      const int c = row / kTailThreads, q = row % kTailThreads;
      if (q >= pts || t >= cols) continue;
      const float val = tile[row * kRow + t];
      OutT* dst = out + (static_cast<size_t>(c) * p.np + pt0 + q) * T + n + t;
      if constexpr (kBf16) {
        *dst = __float2bfloat16_rn(val);
      } else {
        *dst = val;
      }
    }
  }
}

// NX = nfx known at compile time (register window), or 0 (any nfx); OutT
// float or __nv_bfloat16, the block's type
template <int NX, typename OutT>
__global__ void __launch_bounds__(kTailThreads) tail_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);  // (3, kTailThreads, kRow)
  const int ntaps = 2 * p.nfx + 1;
  float* staps = tile + 3 * kTailThreads * kRow;
  float* srot = staps + round4(ntaps);
  for (int i = threadIdx.x; i < ntaps; i += kTailThreads) staps[i] = p.bx[i];
  if (p.rot != nullptr && threadIdx.x < 9) srot[threadIdx.x] = p.rot[threadIdx.x];
  const float* rot = p.rot != nullptr ? srot : nullptr;
  const bool centre = p.center != nullptr;

  const long long np = p.np;
  const long long pt0 = static_cast<long long>(blockIdx.x) * kTailThreads;
  const long long pt = pt0 + threadIdx.x;
  const bool live = pt < np;
  const long long pc = live ? pt : np - 1;  // a dead thread reads a live point
  Point q;
  q.a00 = p.factors[pc];
  q.a10 = p.factors[np + pc];
  q.a11 = p.factors[2 * np + pc];
  q.a20 = p.factors[3 * np + pc];
  q.a21 = p.factors[4 * np + pc];
  q.a22 = p.factors[5 * np + pc];
  q.mu = p.means[pc];
  q.mv = p.means[np + pc];
  q.mw = p.means[2 * np + pc];
  q.cu = centre ? p.center[pc] : 0.f;
  q.cv = centre ? p.center[np + pc] : 0.f;
  q.cw = centre ? p.center[2 * np + pc] : 0.f;

  const size_t slab = static_cast<size_t>(np);
  const size_t comp = static_cast<size_t>(p.num_slabs) * slab;
  const float* zp = p.z + pc;
  auto ld = [&](int c, int s) -> float {
    return s < p.num_slabs ? __ldg(zp + c * comp + s * slab) : 0.f;
  };
  const int n0 = blockIdx.y * p.chunk;
  const int n1 = min(p.nsteps, n0 + p.chunk);
  constexpr int W = NX > 0 ? 2 * NX + kGroup : 1;
  float w[3][W];
  if constexpr (NX > 0) {
#pragma unroll
    for (int i = 0; i < 2 * NX; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) w[c][i] = ld(c, n0 + i);
  }
  __syncthreads();  // the taps and the rotation are in shared memory

  for (int n = n0; n < n1; n += kTailSteps) {
#pragma unroll 1
    for (int g = 0; g < kTailSteps && n + g < n1; g += kGroup) {
      const int s0 = n + g + 2 * p.nfx;  // the group's first new slab
      float acc[3][kGroup];
#pragma unroll
      for (int e = 0; e < kGroup; ++e)
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c][e] = 0.f;
      if constexpr (NX > 0) {
#pragma unroll
        for (int e = 0; e < kGroup; ++e)
#pragma unroll
          for (int c = 0; c < 3; ++c) w[c][2 * NX + e] = ld(c, s0 + e);
#pragma unroll
        for (int i = 0; i <= 2 * NX; ++i) {
          const float b = staps[i];
#pragma unroll
          for (int e = 0; e < kGroup; ++e)
#pragma unroll
            for (int c = 0; c < 3; ++c) acc[c][e] = fmaf(b, w[c][e + i], acc[c][e]);
        }
#pragma unroll
        for (int i = 0; i < 2 * NX; ++i)
#pragma unroll
          for (int c = 0; c < 3; ++c) w[c][i] = w[c][i + kGroup];
      } else {
        for (int i = 0; i < ntaps; ++i) {
          const float b = staps[i];
#pragma unroll
          for (int e = 0; e < kGroup; ++e)
#pragma unroll
            for (int c = 0; c < 3; ++c) acc[c][e] = fmaf(b, ld(c, n + g + e + i), acc[c][e]);
        }
      }
#pragma unroll
      for (int e = 0; e < kGroup; e += 4) {
        float o[4][3];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          finish<OutT>(q, rot, centre, acc[0][e + k], acc[1][e + k], acc[2][e + k], o[k]);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          *reinterpret_cast<float4*>(tile + (c * kTailThreads + threadIdx.x) * kRow + g + e) =
              make_float4(o[0][c], o[1][c], o[2][c], o[3][c]);
      }
    }
    __syncthreads();  // the tile is whole
    store_tile<OutT>(p, tile, pt0, n, n1);
    __syncthreads();  // the tile is free
  }
}

const void* pick(int nfx, int bf16) {
  if (bf16)
    return nfx == 8 ? reinterpret_cast<const void*>(tail_kernel<8, __nv_bfloat16>)
                    : reinterpret_cast<const void*>(tail_kernel<0, __nv_bfloat16>);
  return nfx == 8 ? reinterpret_cast<const void*>(tail_kernel<8, float>)
                  : reinterpret_cast<const void*>(tail_kernel<0, float>);
}

}  // namespace

extern "C" {

// Dynamic shared memory of a K5 block, in bytes.
int fused_tail_smem_bytes(int nfx) { return smem_bytes(nfx); }

// K5 blocks the card holds at once (its SMs times the blocks an SM holds),
// or -(cudaError_t) on failure; bf16: the bfloat16-output kernel.
int fused_tail_slots(int nfx, int bf16, int device) {
  const void* kernel = pick(nfx, bf16);
  const int smem = smem_bytes(nfx);
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kTailThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms * per_sm;
}

// Launches K5 on `stream` (center and rot may be null); out is float, or
// __nv_bfloat16 with bf16 != 0.  Returns the cudaError_t of the launch.
int fused_tail_launch(int bf16, const float* z, void* out, const float* factors,
                      const float* means, const float* center, const float* bx,
                      const float* rot, int nfx, long long np, int nsteps,
                      int chunk, void* stream) {
  if (np < 1 || nsteps < 1 || nfx < 0 || chunk < kTailSteps ||
      chunk % kTailSteps != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long gx = (np + kTailThreads - 1) / kTailThreads;
  const int gy = (nsteps + chunk - 1) / chunk;
  if (gx > 0x7fffffffLL || gy > kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.z = z;
  p.out = out;
  p.factors = factors;
  p.means = means;
  p.center = center;
  p.bx = bx;
  p.rot = rot;
  p.np = np;
  p.nfx = nfx;
  p.nsteps = nsteps;
  p.num_slabs = nsteps + 2 * nfx;
  p.chunk = chunk;
  const void* kernel = pick(nfx, bf16);
  const int smem = smem_bytes(nfx);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  err = cudaLaunchKernel(kernel, dim3(static_cast<unsigned int>(gx), gy),
                         dim3(kTailThreads), args, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
