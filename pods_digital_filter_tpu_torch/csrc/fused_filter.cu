// K1: fused Philox noise + separable Klein spatial filter, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of pods_digital_filter_tpu/ops/pallas_filter.py:
//   _fused_spatial -> _kernel_body (full-slab, on-core PRNG) and its
//   interpret-mode twin _kernel_body_noise_in;
//   _fused_spatial_tiled -> _kernel_body_tiled (128-row j-stripes for planes
//   past the 12 MiB VMEM guard) and _kernel_body_tiled_noise_in;
//   raw_noise_slabs -> _noise_kernel_body and
//   raw_noise_blocks_tiled -> _noise_kernel_body_tiled (the raw stream).
// It computes what they compute, not how: each block owns one kTileJ x kTileK
// output tile of one (component, slab) and
//   1. draws the tile's noise plus its 2*nfy x 2*nfz halo into shared memory
//      from an element-keyed Philox4x32-10 stream (counter (k>>2, j, slab, comp),
//      key (seed lo, seed hi), word k&3), so neighbouring tiles rebuild the same
//      halo values and the raw noise never reaches device memory;
//   2. runs the z-pass t[j,k] = sum_d bz[d] x[j,k+d], then the y-pass
//      out[j,k] = sum_d by[d] t[j+d,k], as f32 FMAs with the taps in shared
//      memory: (2nf+1)(jn*kma + jma*kma) MACs per slab, where the TPU's dense
//      Toeplitz GEMMs spend jn*kn*kma + jma*jn*kma.
// Because j and k are both tiled for every plane, the TPU's full-slab/tiled
// split, its VMEM guard and its silent XLA fallback have no counterpart: an nf
// whose tile does not fit the shared memory is refused by the wrapper, with
// the byte count.
//
// What bounds it: at 512x512, nf=8, one 1,040-slab three-component window
// writes 3 * 1040 * 512 * 512 * 4 B = 3.27 GB of f32 output, about 1.0 ms at
// the H100's 3.35 TB/s; its banded FMAs are 3120 * 17 * (528*512 + 512*512)
// = 28 G, about 0.85 ms at 67 TFLOP/s f32.  So the floor is writing the f32
// output, not the FMAs.  The tiling keeps everything else off device memory:
// the noise is made and consumed in shared memory and the intermediate t
// never leaves it, so the only device-memory traffic is one coalesced write
// of each output element.  The price is the halo: a 32 x 64 tile at nf=8
// draws 48 x 80 noise values for 2048 outputs (1.9x).  This first version is
// well above that floor (about 10 ms on an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md): each output reads 2nf+1 shared-memory values per pass, one load
// per FMA, and those loads bound it; the Philox draw alone takes about
// 1.5 ms there.
//
// Compile-time modes (template parameter):
//   kPhiloxFiltered  -- Philox -> filtered slab (rows 1 and 2 of the kernel table)
//   kNoiseInFiltered -- given noise -> filtered slab (the interpret-mode bodies)
//   kPhiloxRaw       -- Philox -> raw noise field (rows 3 and 4)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_build.py); bound with ctypes (plain C entry points).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileJ = 32;    // output rows (j) per block
constexpr int kTileK = 64;    // output columns (k) per block; a multiple of 4
constexpr int kThreads = 256;
constexpr int kMaxGridZ = 65535;

enum Mode : int { kPhiloxFiltered = 0, kNoiseInFiltered = 1, kPhiloxRaw = 2 };

struct Params {
  const float* noise;  // (C*S, jn, kn), kNoiseInFiltered only
  float* out;          // (C*S, jma, kma) filtered, or (C*S, jn, kn) raw
  const float* by;     // (2*nfy + 1,)
  const float* bz;     // (2*nfz + 1,)
  int nfy, nfz;
  int jma, kma, jn, kn;
  int num_cs;          // components * slabs
  int num_slabs;
  uint32_t t0;         // global index of slab 0
  uint32_t key0, key1;
  float scale;         // float32(2*sqrt(3)*2^-32)
};

struct Words {
  uint32_t w[4];
};

__device__ __forceinline__ Words philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return Words{{c0, c1, c2, c3}};
}

// int32 bitcast, exact-rounding conversion, one f32 multiply (never contracted)
__device__ __forceinline__ float word_to_uniform(uint32_t w, float scale) {
  return __fmul_rn(__int2float_rn(static_cast<int32_t>(w)), scale);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) fused_filter_kernel(const Params p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;

  if constexpr (MODE == kPhiloxRaw) {
    // one kTileJ x kTileK tile of the noise field itself; no halo
    constexpr int groups = kTileK / 4;
    const int j0 = blockIdx.y * kTileJ;
    const int k0 = blockIdx.x * kTileK;
    for (int cs = blockIdx.z; cs < p.num_cs; cs += gridDim.z) {
      const uint32_t comp = static_cast<uint32_t>(cs / p.num_slabs);
      const uint32_t slab = p.t0 + static_cast<uint32_t>(cs % p.num_slabs);
      float* dst = p.out + static_cast<size_t>(cs) * p.jn * p.kn;
      for (int i = tid; i < kTileJ * groups; i += kThreads) {
        const int j = j0 + i / groups;
        const int kb = k0 + 4 * (i % groups);
        if (j >= p.jn || kb >= p.kn) continue;
        const Words w = philox4x32_10(static_cast<uint32_t>(kb >> 2),
                                      static_cast<uint32_t>(j), slab, comp,
                                      p.key0, p.key1);
        float* row = dst + static_cast<size_t>(j) * p.kn + kb;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (kb + q < p.kn) row[q] = word_to_uniform(w.w[q], p.scale);
      }
    }
  } else {
    const int hj = kTileJ + 2 * p.nfy;  // noise rows one tile reads
    const int wk = kTileK + 2 * p.nfz;  // noise columns one tile reads
    const int ty = 2 * p.nfy + 1;
    const int tz = 2 * p.nfz + 1;
    float* x = smem;                  // (hj, wk) noise tile + halo
    float* t = x + hj * wk;           // (hj, kTileK) after the z-pass
    float* sby = t + hj * kTileK;     // y taps
    float* sbz = sby + ty;            // z taps
    for (int i = tid; i < ty; i += kThreads) sby[i] = p.by[i];
    for (int i = tid; i < tz; i += kThreads) sbz[i] = p.bz[i];

    const int j0 = blockIdx.y * kTileJ;  // first output row == first noise row
    const int k0 = blockIdx.x * kTileK;
    for (int cs = blockIdx.z; cs < p.num_cs; cs += gridDim.z) {
      __syncthreads();  // taps are loaded; the last slab's x and t are consumed

      if constexpr (MODE == kPhiloxFiltered) {
        const uint32_t comp = static_cast<uint32_t>(cs / p.num_slabs);
        const uint32_t slab = p.t0 + static_cast<uint32_t>(cs % p.num_slabs);
        const int groups = (wk + 3) / 4;  // k0 is a multiple of 4
        for (int i = tid; i < hj * groups; i += kThreads) {
          const int r = i / groups;
          const int g = i - r * groups;
          const Words w = philox4x32_10(static_cast<uint32_t>((k0 >> 2) + g),
                                        static_cast<uint32_t>(j0 + r), slab,
                                        comp, p.key0, p.key1);
          float* row = x + r * wk + 4 * g;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (4 * g + q < wk) row[q] = word_to_uniform(w.w[q], p.scale);
        }
      } else {
        const float* src = p.noise + static_cast<size_t>(cs) * p.jn * p.kn;
        for (int i = tid; i < hj * wk; i += kThreads) {
          const int r = i / wk;
          const int c = i - r * wk;
          const int j = j0 + r;
          const int k = k0 + c;
          x[i] = (j < p.jn && k < p.kn) ? src[static_cast<size_t>(j) * p.kn + k]
                                        : 0.f;
        }
      }
      __syncthreads();

      // z-pass over every row the y-pass needs
      for (int i = tid; i < hj * kTileK; i += kThreads) {
        const int r = i / kTileK;
        const int c = i % kTileK;
        const float* xr = x + r * wk + c;
        float acc = 0.f;
        for (int d = 0; d < tz; ++d) acc = fmaf(sbz[d], xr[d], acc);
        t[i] = acc;
      }
      __syncthreads();

      // y-pass; consecutive threads write consecutive k (coalesced)
      float* dst = p.out + static_cast<size_t>(cs) * p.jma * p.kma;
      for (int i = tid; i < kTileJ * kTileK; i += kThreads) {
        const int r = i / kTileK;
        const int c = i % kTileK;
        const int j = j0 + r;
        const int k = k0 + c;
        if (j < p.jma && k < p.kma) {
          const float* tc = t + r * kTileK + c;
          float acc = 0.f;
          for (int d = 0; d < ty; ++d) acc = fmaf(sby[d], tc[d * kTileK], acc);
          dst[static_cast<size_t>(j) * p.kma + k] = acc;
        }
      }
    }
  }
}

int smem_bytes(int nfy, int nfz) {
  const int hj = kTileJ + 2 * nfy;
  const int wk = kTileK + 2 * nfz;
  return static_cast<int>(sizeof(float)) *
         (hj * wk + hj * kTileK + (2 * nfy + 1) + (2 * nfz + 1));
}

template <int MODE>
cudaError_t launch(const Params& p, dim3 grid, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_filter_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  fused_filter_kernel<MODE><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Dynamic shared memory one filtering block asks for, in bytes.
int fused_filter_smem_bytes(int nfy, int nfz) { return smem_bytes(nfy, nfz); }

// Largest dynamic shared memory a block may opt in to on `device`, or -1.
int fused_filter_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

const char* fused_filter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches one mode on `stream`, on the caller's current device; returns the
// cudaError_t of the launch.
int fused_filter_launch(int mode, const float* noise, float* out,
                        const float* by, const float* bz, int nfy, int nfz,
                        int jma, int kma, int num_components, int num_slabs,
                        unsigned int t0, unsigned int key0, unsigned int key1,
                        float scale, void* stream) {
  cudaError_t err;
  Params p;
  p.noise = noise;
  p.out = out;
  p.by = by;
  p.bz = bz;
  p.nfy = nfy;
  p.nfz = nfz;
  p.jma = jma;
  p.kma = kma;
  p.jn = jma + 2 * nfy;
  p.kn = kma + 2 * nfz;
  p.num_cs = num_components * num_slabs;
  p.num_slabs = num_slabs;
  p.t0 = t0;
  p.key0 = key0;
  p.key1 = key1;
  p.scale = scale;
  const unsigned int gz =
      static_cast<unsigned int>(p.num_cs < kMaxGridZ ? p.num_cs : kMaxGridZ);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPhiloxFiltered:
      err = launch<kPhiloxFiltered>(
          p, dim3(ceil_div(kma, kTileK), ceil_div(jma, kTileJ), gz),
          smem_bytes(nfy, nfz), s);
      break;
    case kNoiseInFiltered:
      err = launch<kNoiseInFiltered>(
          p, dim3(ceil_div(kma, kTileK), ceil_div(jma, kTileJ), gz),
          smem_bytes(nfy, nfz), s);
      break;
    case kPhiloxRaw:
      err = launch<kPhiloxRaw>(
          p, dim3(ceil_div(p.kn, kTileK), ceil_div(p.jn, kTileJ), gz), 0, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
