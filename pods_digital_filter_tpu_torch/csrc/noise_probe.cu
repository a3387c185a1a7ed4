// K3: the noise-draw probes of the TPU experiments, for Hopper (sm_90a).
//
// Replaces the Pallas bodies of benchmarks/exp_two_kernel_pipeline.py that
// ask where a noise kernel's time goes (_NOISE_BODIES, _noise_body_batched,
// _store2d_body: rows 7, 8 and 9 of the kernel table in PERF.md).  Each mode asks its body's question with the port's
// counter-based Philox4x32-10 in place of the TPU's on-core PRNG:
//   kNoise      -- the TPU's production 16-bit draw (pallas_filter.py:180-184):
//                  word (j, m), m < kn/2, gives lo = (w & 0xFFFF) - 32768 at
//                  column m and hi = int32(w) >> 16 at column m + kn/2,
//                  each times float32(2sqrt3/65536); counter (m>>2, j, slab,
//                  comp), word m&3
//   kNoise16b   -- the same draw, halves interleaved along j (int16 bitcast):
//                  word (r, k), r < jn/2, gives int16(w) at row 2r and
//                  int16(w >> 16) at row 2r+1; counter (k>>2, r, slab, comp)
//   kNoise1Seed -- one key for the launch, counter = flat word index f over
//                  (C*S, jn, kn/2) as (f>>2, 0, 0, 0), word f&3; the
//                  stream is not keyed by slab (measurement only, as the
//                  TPU body seeded once)
//   kNoPrng     -- float32(int32(k * (cs+1))) * float32(2sqrt3*2^-32): the
//                  casts, scale and store with no generator at all
//   kNoiseMin   -- kNoise16b's int16 value converted once, no scale
//   kStoreOnly  -- the constant 0.5
//   kBatched    -- G slabs per group from one key per group: key (seed lo +
//                  stream * 0x9E3779B9, seed hi), stream = comp*2^22 + group,
//                  counter (m>>2, j, slab in group, 0); halves as kNoise
//   kStore2d    -- the constant 0.5 into the (jma, C*S*kma) layout
// The TPU's 32-bit draw (noise32) is K1's raw mode, not a mode here.
// Output f32 or bf16 (round to nearest even); store2d is f32.
//
// What bounds it: every mode writes C*S*jn*kn values and reads nothing, so
// the floor is the write: 3 * 80 * 528 * 528 * 2 B = 134 MB in bf16 at the
// experiments' 512x512 plane, about 0.04 ms at 3.35 TB/s.  Philox costs 10
// rounds of two 32x32->64 multiplies per four words; the 16-bit modes need
// half the words.  One thread per group of four words, grid-stride over the
// launch with 32-bit indices; consecutive threads write consecutive groups.
// Each value is stored on its own (2 bytes in bf16), so the Philox bodies
// take 0.23-0.32 ms there and the constant store 0.08-0.1 ms (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md).

#include "filter_tile.cuh"

namespace {

using namespace podfs;

enum Probe : int {
  kNoise = 0,
  kNoise16b = 1,
  kNoise1Seed = 2,
  kNoPrng = 3,
  kNoiseMin = 4,
  kStoreOnly = 5,
  kBatched = 6,
  kStore2d = 7,
};

struct Params {
  void* out;
  int jn, kn;          // one slab's field (store2d: jma, kma)
  int num_cs;          // components * slabs
  int num_slabs;       // slabs per component
  int group;           // kBatched: slabs per group
  uint32_t t0, key0, key1;
  float scale16, scale32;
};

template <typename OutT>
__device__ __forceinline__ void put(void* out, size_t i, float v);
template <>
__device__ __forceinline__ void put<float>(void* out, size_t i, float v) {
  static_cast<float*>(out)[i] = v;
}
template <>
__device__ __forceinline__ void put<__nv_bfloat16>(void* out, size_t i, float v) {
  static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int32_t lo_half(uint32_t w) {
  return static_cast<int32_t>(w & 0xFFFFu) - 32768;
}
__device__ __forceinline__ int32_t hi_half(uint32_t w) {
  return static_cast<int32_t>(w) >> 16;
}

template <int MODE, typename OutT>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const __grid_constant__ Params p) {
  // 32-bit indices (the wrapper refuses fields of 2^32 values or more):
  // a 64-bit division costs several times a 32-bit one on the card
  const uint32_t stride = gridDim.x * kThreads;
  const uint32_t first = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t plane = static_cast<uint32_t>(p.jn) * p.kn;
  const int half = p.kn / 2;
  if constexpr (MODE == kNoise || MODE == kBatched) {
    const int groups = (half + 3) / 4;
    const uint32_t items = static_cast<uint32_t>(p.num_cs) * p.jn * groups;
    for (uint32_t it = first; it < items; it += stride) {
      const int g = static_cast<int>(it % groups);
      const uint32_t rest = it / groups;
      const int j = static_cast<int>(rest % p.jn);
      const int cs = static_cast<int>(rest / p.jn);
      Words w;
      if constexpr (MODE == kNoise) {
        const uint32_t comp = static_cast<uint32_t>(cs / p.num_slabs);
        const uint32_t slab = p.t0 + static_cast<uint32_t>(cs % p.num_slabs);
        w = philox4x32_10(static_cast<uint32_t>(g), static_cast<uint32_t>(j),
                          slab, comp, p.key0, p.key1);
      } else {
        const int gi = cs / p.group;              // group launch index
        const int groups_per_comp = p.num_cs / p.group / (p.num_cs / p.num_slabs);
        const uint32_t comp = static_cast<uint32_t>(gi / groups_per_comp);
        const uint32_t grp = p.t0 + static_cast<uint32_t>(gi % groups_per_comp);
        const uint32_t stream = comp * (1u << 22) + grp;
        w = philox4x32_10(static_cast<uint32_t>(g), static_cast<uint32_t>(j),
                          static_cast<uint32_t>(cs % p.group), 0u,
                          p.key0 + stream * 0x9E3779B9u, p.key1);
      }
      const size_t row = static_cast<size_t>(cs) * plane + static_cast<size_t>(j) * p.kn;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = 4 * g + q;
        if (m >= half) break;
        put<OutT>(p.out, row + m, __fmul_rn(__int2float_rn(lo_half(w.w[q])), p.scale16));
        put<OutT>(p.out, row + m + half, __fmul_rn(__int2float_rn(hi_half(w.w[q])), p.scale16));
      }
    }
  } else if constexpr (MODE == kNoise16b || MODE == kNoiseMin) {
    const int groups = (p.kn + 3) / 4;
    const int rows = p.jn / 2;
    const uint32_t items = static_cast<uint32_t>(p.num_cs) * rows * groups;
    for (uint32_t it = first; it < items; it += stride) {
      const int g = static_cast<int>(it % groups);
      const uint32_t rest = it / groups;
      const int r = static_cast<int>(rest % rows);
      const int cs = static_cast<int>(rest / rows);
      const uint32_t comp = static_cast<uint32_t>(cs / p.num_slabs);
      const uint32_t slab = p.t0 + static_cast<uint32_t>(cs % p.num_slabs);
      const Words w = philox4x32_10(static_cast<uint32_t>(g), static_cast<uint32_t>(r),
                                    slab, comp, p.key0, p.key1);
      const size_t row0 = static_cast<size_t>(cs) * plane + static_cast<size_t>(2 * r) * p.kn;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 4 * g + q;
        if (k >= p.kn) break;
        const float lo = static_cast<float>(static_cast<int16_t>(w.w[q] & 0xFFFFu));
        const float hi = static_cast<float>(static_cast<int16_t>(w.w[q] >> 16));
        if constexpr (MODE == kNoise16b) {
          put<OutT>(p.out, row0 + k, __fmul_rn(lo, p.scale16));
          put<OutT>(p.out, row0 + p.kn + k, __fmul_rn(hi, p.scale16));
        } else {
          put<OutT>(p.out, row0 + k, lo);
          put<OutT>(p.out, row0 + p.kn + k, hi);
        }
      }
    }
  } else if constexpr (MODE == kNoise1Seed) {
    const uint32_t words = static_cast<uint32_t>(p.num_cs) * p.jn * half;
    const uint32_t items = (words + 3) / 4;
    for (uint32_t it = first; it < items; it += stride) {
      const Words w = philox4x32_10(it, 0u, 0u, 0u, p.key0, p.key1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t f = 4 * it + q;
        if (f >= words) break;
        const int m = static_cast<int>(f % half);
        const size_t row = static_cast<size_t>(f / half) * p.kn;  // (cs*jn + j) * kn
        put<OutT>(p.out, row + m, __fmul_rn(__int2float_rn(lo_half(w.w[q])), p.scale16));
        put<OutT>(p.out, row + m + half, __fmul_rn(__int2float_rn(hi_half(w.w[q])), p.scale16));
      }
    }
  } else if constexpr (MODE == kNoPrng) {
    const uint32_t items = static_cast<uint32_t>(p.num_cs) * plane;
    for (uint32_t it = first; it < items; it += stride) {
      const uint32_t k = it % p.kn;
      const uint32_t cs = it / plane;
      const int32_t v = static_cast<int32_t>(k * (cs + 1u));
      put<OutT>(p.out, it, __fmul_rn(__int2float_rn(v), p.scale32));
    }
  } else if constexpr (MODE == kStoreOnly) {
    const uint32_t items = static_cast<uint32_t>(p.num_cs) * plane;
    for (uint32_t it = first; it < items; it += stride) put<OutT>(p.out, it, 0.5f);
  } else {  // kStore2d: block pid of (jma, kma) at column pid * kma
    const uint32_t items = static_cast<uint32_t>(p.num_cs) * plane;
    for (uint32_t it = first; it < items; it += stride)
      static_cast<float*>(p.out)[it] = 0.5f;
  }
}

template <int MODE>
cudaError_t launch(const Params& p, int out_bf16, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>(sms * 8));  // grid-stride
  if (out_bf16)
    probe_kernel<MODE, __nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
  else
    probe_kernel<MODE, float><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches probe `mode` on `stream`; returns the cudaError_t of the launch.
int noise_probe_launch(int mode, int out_bf16, void* out, int jn, int kn,
                       int num_components, int num_slabs, int group,
                       unsigned int t0, unsigned int key0, unsigned int key1,
                       float scale16, float scale32, void* stream) {
  Params p;
  p.out = out;
  p.jn = jn;
  p.kn = kn;
  p.num_cs = num_components * num_slabs;
  p.num_slabs = num_slabs;
  p.group = group;
  p.t0 = t0;
  p.key0 = key0;
  p.key1 = key1;
  p.scale16 = scale16;
  p.scale32 = scale32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kNoise: err = launch<kNoise>(p, out_bf16, s); break;
    case kNoise16b: err = launch<kNoise16b>(p, out_bf16, s); break;
    case kNoise1Seed: err = launch<kNoise1Seed>(p, out_bf16, s); break;
    case kNoPrng: err = launch<kNoPrng>(p, out_bf16, s); break;
    case kNoiseMin: err = launch<kNoiseMin>(p, out_bf16, s); break;
    case kStoreOnly: err = launch<kStoreOnly>(p, out_bf16, s); break;
    case kBatched: err = launch<kBatched>(p, out_bf16, s); break;
    case kStore2d: err = launch<kStore2d>(p, 0, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
