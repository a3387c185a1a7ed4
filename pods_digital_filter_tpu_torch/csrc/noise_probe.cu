// K3: the noise-draw probes of the TPU experiments, for Hopper (sm_90a).
//
// Replaces the Pallas bodies of benchmarks/exp_two_kernel_pipeline.py that
// ask where a noise kernel's time goes (_NOISE_BODIES, _noise_body_batched,
// _store2d_body: rows 7, 8 and 9 of the kernel table in PERF.md).  Each mode
// asks its body's question with the port's counter-based Philox4x32-10 in
// place of the TPU's on-core PRNG:
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
// experiments' 512x512 plane, 0.040 ms at 3.35 TB/s (268 MB, 0.080 ms, in
// f32; store2d 252 MB, 0.075 ms).  Philox costs 10 rounds of two 32x32->64
// multiplies per four words; the 16-bit modes need half the words.
//
// Design: each thread handles 8 consecutive output columns of a row (the
// Philox modes draw two groups of four words for it, so that the lo and hi
// halves each fill 8 columns) and writes them with 16-byte stores: one for 8
// bf16 values, two for 8 f32 values.  Where those 8 columns do not start on a
// 16-byte boundary (a row offset such as kn/2 = 67), or run past the row's
// end, they are stored one value at a time.  The constant modes store the
// flat output with no index arithmetic but the piece number: 16 bytes a
// store, four stores a thread, consecutive threads on consecutive pieces
// (with 8-value items and their divisions they were bound by instructions,
// not bytes: 0.23 ms for storeonly f32).  Grid-stride over the launch with
// 32-bit indices.  The first version stored every value on its own (2
// bytes in bf16) and took 0.23-0.32 ms for the Philox bodies and 0.08-0.12
// ms for the stores (with the host's launch overhead).  This one, device
// time (NVIDIA H100 80GB HBM3, 700 W; PERF.md): the Philox bodies in bf16
// 0.047-0.058 ms, storeonly 0.0428 ms (bf16) and 0.0835 ms (f32), store2d
// 0.0786 ms, against 0.0431, 0.0836 and 0.0788 ms for torch.full.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC (ops/_build.py); plain C entry points for ctypes.

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

__device__ __forceinline__ int32_t lo_half(uint32_t w) {
  return static_cast<int32_t>(w & 0xFFFFu) - 32768;
}
__device__ __forceinline__ int32_t hi_half(uint32_t w) {
  return static_cast<int32_t>(w) >> 16;
}
__device__ __forceinline__ float scaled(int32_t v, float s) {
  return __fmul_rn(__int2float_rn(v), s);
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
  float lo[8], hi[8];
  if constexpr (MODE == kNoise || MODE == kBatched) {
    const int groups = (half + 7) / 8;
    const uint32_t items = static_cast<uint32_t>(p.num_cs) * p.jn * groups;
    for (uint32_t it = first; it < items; it += stride) {
      const int g = static_cast<int>(it % groups);
      const uint32_t rest = it / groups;
      const int j = static_cast<int>(rest % p.jn);
      const int cs = static_cast<int>(rest / p.jn);
      Words w[2];
      if constexpr (MODE == kNoise) {
        const uint32_t comp = static_cast<uint32_t>(cs / p.num_slabs);
        const uint32_t slab = p.t0 + static_cast<uint32_t>(cs % p.num_slabs);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          w[h] = philox4x32_10(static_cast<uint32_t>(2 * g + h), static_cast<uint32_t>(j),
                               slab, comp, p.key0, p.key1);
      } else {
        const int gi = cs / p.group;              // group launch index
        const int groups_per_comp = p.num_cs / p.group / (p.num_cs / p.num_slabs);
        const uint32_t comp = static_cast<uint32_t>(gi / groups_per_comp);
        const uint32_t grp = p.t0 + static_cast<uint32_t>(gi % groups_per_comp);
        const uint32_t stream = comp * (1u << 22) + grp;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          w[h] = philox4x32_10(static_cast<uint32_t>(2 * g + h), static_cast<uint32_t>(j),
                               static_cast<uint32_t>(cs % p.group), 0u,
                               p.key0 + stream * 0x9E3779B9u, p.key1);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        lo[e] = scaled(lo_half(w[e >> 2].w[e & 3]), p.scale16);
        hi[e] = scaled(hi_half(w[e >> 2].w[e & 3]), p.scale16);
      }
      const int m0 = 8 * g, n = half - m0 < 8 ? half - m0 : 8;
      const size_t row = static_cast<size_t>(cs) * plane + static_cast<size_t>(j) * p.kn;
      put8<OutT>(p.out, row + m0, lo, n);
      put8<OutT>(p.out, row + m0 + half, hi, n);
    }
  } else if constexpr (MODE == kNoise16b || MODE == kNoiseMin) {
    const int groups = (p.kn + 7) / 8;
    const int rows = p.jn / 2;
    const uint32_t items = static_cast<uint32_t>(p.num_cs) * rows * groups;
    for (uint32_t it = first; it < items; it += stride) {
      const int g = static_cast<int>(it % groups);
      const uint32_t rest = it / groups;
      const int r = static_cast<int>(rest % rows);
      const int cs = static_cast<int>(rest / rows);
      const uint32_t comp = static_cast<uint32_t>(cs / p.num_slabs);
      const uint32_t slab = p.t0 + static_cast<uint32_t>(cs % p.num_slabs);
      Words w[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        w[h] = philox4x32_10(static_cast<uint32_t>(2 * g + h), static_cast<uint32_t>(r),
                             slab, comp, p.key0, p.key1);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t word = w[e >> 2].w[e & 3];
        lo[e] = static_cast<float>(static_cast<int16_t>(word & 0xFFFFu));
        hi[e] = static_cast<float>(static_cast<int16_t>(word >> 16));
        if constexpr (MODE == kNoise16b) {
          lo[e] = __fmul_rn(lo[e], p.scale16);
          hi[e] = __fmul_rn(hi[e], p.scale16);
        }
      }
      const int k0 = 8 * g, n = p.kn - k0 < 8 ? p.kn - k0 : 8;
      const size_t row0 = static_cast<size_t>(cs) * plane + static_cast<size_t>(2 * r) * p.kn;
      put8<OutT>(p.out, row0 + k0, lo, n);
      put8<OutT>(p.out, row0 + p.kn + k0, hi, n);
    }
  } else if constexpr (MODE == kNoise1Seed) {
    const uint32_t words = static_cast<uint32_t>(p.num_cs) * p.jn * half;
    const uint32_t items = (words + 7) / 8;
    for (uint32_t it = first; it < items; it += stride) {
      Words w[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) w[h] = philox4x32_10(2 * it + h, 0u, 0u, 0u, p.key0, p.key1);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        lo[e] = scaled(lo_half(w[e >> 2].w[e & 3]), p.scale16);
        hi[e] = scaled(hi_half(w[e >> 2].w[e & 3]), p.scale16);
      }
      const uint32_t f0 = 8 * it;
      if (half % 8 == 0 && f0 + 8 <= words) {    // 8 words of one row
        const size_t row = static_cast<size_t>(f0 / half) * p.kn;   // (cs*jn + j) * kn
        const int m = static_cast<int>(f0 % half);
        put8<OutT>(p.out, row + m, lo, 8);
        put8<OutT>(p.out, row + m + half, hi, 8);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t f = f0 + e;
          if (f >= words) break;
          const size_t row = static_cast<size_t>(f / half) * p.kn;
          const int m = static_cast<int>(f % half);
          const float l[8] = {lo[e]}, h[8] = {hi[e]};
          put8<OutT>(p.out, row + m, l, 1);
          put8<OutT>(p.out, row + m + half, h, 1);
        }
      }
    }
  } else if constexpr (MODE == kNoPrng) {
    const int groups = (p.kn + 7) / 8;
    const uint32_t items = static_cast<uint32_t>(p.num_cs) * p.jn * groups;
    for (uint32_t it = first; it < items; it += stride) {
      const int g = static_cast<int>(it % groups);
      const uint32_t rest = it / groups;
      const uint32_t cs = rest / p.jn;
      const int k0 = 8 * g, n = p.kn - k0 < 8 ? p.kn - k0 : 8;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        lo[e] = scaled(static_cast<int32_t>(static_cast<uint32_t>(k0 + e) * (cs + 1u)), p.scale32);
      put8<OutT>(p.out, static_cast<size_t>(rest) * p.kn + k0, lo, n);
    }
  } else {  // kStoreOnly; kStore2d: block pid of (jma, kma) at column pid * kma
    // the flat output, 16-byte streaming stores (it is not read again), four
    // a thread 256 pieces apart (the wrapper's output is 16-byte aligned);
    // the last < 16 bytes one value at a time
    const uint32_t total = static_cast<uint32_t>(p.num_cs) * plane;
    const uint32_t pieces = total / (16 / sizeof(OutT));
    const uint32_t half = sizeof(OutT) == 4 ? 0x3F000000u : 0x3F003F00u;   // 0.5
    const uint4 v = make_uint4(half, half, half, half);
    uint4* o = static_cast<uint4*>(p.out);
    for (uint32_t span = blockIdx.x; span * 4 * kThreads < pieces; span += gridDim.x) {
      const uint32_t i0 = span * 4 * kThreads + threadIdx.x;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * kThreads < pieces) __stcs(o + i0 + u * kThreads, v);
    }
    if (first == 0) {
      for (uint32_t e = pieces * (16 / sizeof(OutT)); e < total; ++e) {
        const float one[8] = {0.5f};
        put8<OutT>(p.out, e, one, 1);
      }
    }
  }
}

template <int MODE>
cudaError_t launch(const Params& p, int out_bf16, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  unsigned int blocks = static_cast<unsigned int>(sms * 8);  // grid-stride
  if (MODE == kStoreOnly || MODE == kStore2d) {      // one span of 4 x 256 pieces a block
    const size_t bytes = static_cast<size_t>(p.num_cs) * p.jn * p.kn * (out_bf16 ? 2 : 4);
    blocks = static_cast<unsigned int>((bytes / 16 + 4 * kThreads - 1) / (4 * kThreads) + 1);
  }
  const dim3 grid(blocks);
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
