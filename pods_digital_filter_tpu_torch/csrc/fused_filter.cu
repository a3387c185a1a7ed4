// K1: fused Philox noise + separable Klein spatial filter, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of pods_digital_filter_tpu/ops/pallas_filter.py:
//   _fused_spatial -> _kernel_body (full-slab, on-core PRNG) and its
//   interpret-mode twin _kernel_body_noise_in;
//   _fused_spatial_tiled -> _kernel_body_tiled (128-row j-stripes for planes
//   past the 12 MiB VMEM guard) and _kernel_body_tiled_noise_in;
//   raw_noise_slabs -> _noise_kernel_body and
//   raw_noise_blocks_tiled -> _noise_kernel_body_tiled (the raw stream);
// and the fused bodies of the TPU experiments:
//   benchmarks/exp_two_kernel_pipeline.py _fused_body_noprng (iota source),
//   _fused_body_dummy_in (a cycling 8 x 128 input added after the filter),
//   benchmarks/exp_pipelined_kernel.py _kernel_pipelined (next slab's noise
//   drawn before this slab is filtered).
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
// The three phases live in filter_tile.cuh, shared with K4.  Because j and k
// are both tiled for every plane, the TPU's full-slab/tiled split, its VMEM
// guard and its silent XLA fallback have no counterpart: an nf whose tile
// does not fit the shared memory is refused by the wrapper, with the byte
// count.
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
// Modes (run-time `mode`, each a template instantiation):
//   kPhiloxFiltered  -- Philox -> filtered slab (rows 1 and 2 of the kernel
//                       table); with `dummy` set, dummy[cs] (8 x 128) is added
//                       to out[cs, :8, :128] after the filter (row 9)
//   kNoiseInFiltered -- given f32 noise -> filtered slab (interpret bodies)
//   kPhiloxRaw       -- Philox -> raw noise field, f32 or bf16 (rows 3, 4, 5)
//   kIotaFiltered    -- iota field k*(cs+1)*2sqrt3/65536 -> filtered (row 9)
//   kPipelined       -- Philox -> filtered with a persistent block per tile
//                       column that draws slab i+1's tile into a second buffer
//                       before it filters slab i (row 11); bit-identical to
//                       kPhiloxFiltered
// and bf16_taps (f32 or bf16 taps) for every filtering mode.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC, linked with the other csrc/*.cu into one shared
//        library (ops/_build.py); bound with ctypes (plain C entry points).

#include "filter_tile.cuh"

namespace {

using namespace podfs;

enum Mode : int {
  kPhiloxFiltered = 0,
  kNoiseInFiltered = 1,
  kPhiloxRaw = 2,
  kIotaFiltered = 3,
  kPipelined = 4,
};

struct Params {
  TileParams tile;
  void* out;            // (C*S, jma, kma) f32 filtered, or (C*S, jn, kn) raw
  const float* dummy;   // (C*S, 8, 128) or null
  const float* by;      // (2*nfy + 1,)
  const float* bz;      // (2*nfz + 1,)
  int num_cs;           // components * slabs
};

template <typename OutT>
__device__ __forceinline__ OutT from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// one kTileJ x kTileK tile of the noise field itself; no halo
template <typename OutT>
__global__ void __launch_bounds__(kThreads) raw_kernel(const __grid_constant__ Params p) {
  const TileParams& tp = p.tile;
  constexpr int groups = kTileK / 4;
  const int j0 = blockIdx.y * kTileJ;
  const int k0 = blockIdx.x * kTileK;
  for (int cs = blockIdx.z; cs < p.num_cs; cs += gridDim.z) {
    const uint32_t comp = static_cast<uint32_t>(cs / tp.num_slabs);
    const uint32_t slab = tp.t0 + static_cast<uint32_t>(cs % tp.num_slabs);
    OutT* dst = static_cast<OutT*>(p.out) + static_cast<size_t>(cs) * tp.jn * tp.kn;
    for (int i = threadIdx.x; i < kTileJ * groups; i += kThreads) {
      const int j = j0 + i / groups;
      const int kb = k0 + 4 * (i % groups);
      if (j >= tp.jn || kb >= tp.kn) continue;
      const Words w = philox4x32_10(static_cast<uint32_t>(kb >> 2),
                                    static_cast<uint32_t>(j), slab, comp,
                                    tp.key0, tp.key1);
      OutT* row = dst + static_cast<size_t>(j) * tp.kn + kb;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (kb + q < tp.kn)
          row[q] = from_float<OutT>(word_to_uniform(w.w[q], tp.scale));
    }
  }
}

__device__ __forceinline__ void load_taps(const Params& p, float* sby,
                                          float* sbz) {
  for (int i = threadIdx.x; i < 2 * p.tile.nfy + 1; i += kThreads) sby[i] = p.by[i];
  for (int i = threadIdx.x; i < 2 * p.tile.nfz + 1; i += kThreads) sbz[i] = p.bz[i];
}

// y-pass of one tile into the output (plus the dummy input, if any)
__device__ __forceinline__ void store_tile(const Params& p, int cs, int j0,
                                           int k0, const float* t,
                                           const float* sby) {
  const TileParams& tp = p.tile;
  float* dst = static_cast<float*>(p.out) + static_cast<size_t>(cs) * tp.jma * tp.kma;
  const float* dummy = p.dummy ? p.dummy + static_cast<size_t>(cs) * 8 * 128 : nullptr;
  for (int i = threadIdx.x; i < kTileJ * kTileK; i += kThreads) {
    const int r = i / kTileK;
    const int c = i % kTileK;
    const int j = j0 + r;
    const int k = k0 + c;
    if (j < tp.jma && k < tp.kma) {
      float v = y_at(t, sby, tp.nfy, r, c);
      if (dummy && j < 8 && k < 128) v += dummy[j * 128 + k];
      dst[static_cast<size_t>(j) * tp.kma + k] = v;
    }
  }
}

template <int SRC, bool BF16>
__global__ void __launch_bounds__(kThreads) filter_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  const TileParams& tp = p.tile;
  const int hj = kTileJ + 2 * tp.nfy;
  float* x = smem;                   // (hj, wk) noise tile + halo
  float* t = x + hj * (kTileK + 2 * tp.nfz);  // (hj, kTileK) after the z-pass
  float* sby = t + hj * kTileK;      // y taps
  float* sbz = sby + 2 * tp.nfy + 1; // z taps
  load_taps(p, sby, sbz);
  const int j0 = blockIdx.y * kTileJ;  // first output row == first noise row
  const int k0 = blockIdx.x * kTileK;
  for (int cs = blockIdx.z; cs < p.num_cs; cs += gridDim.z) {
    __syncthreads();  // taps are loaded; the last slab's x and t are consumed
    fill_tile<SRC, BF16>(tp, cs, j0, k0, x);
    __syncthreads();
    z_pass<BF16>(tp.nfy, tp.nfz, x, sbz, t);
    __syncthreads();
    store_tile(p, cs, j0, k0, t, sby);
  }
}

// Persistent over the slabs cs = blockIdx.z, blockIdx.z + gridDim.z, ...:
// slab i+1's noise goes into the other buffer while slab i is filtered; the
// draw has no dependence on the z-pass, so the warps of one barrier interval
// interleave Philox and FMA work.
template <bool BF16>
__global__ void __launch_bounds__(kThreads) pipelined_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  const TileParams& tp = p.tile;
  const int hj = kTileJ + 2 * tp.nfy;
  const int xs = hj * (kTileK + 2 * tp.nfz);
  float* xbuf[2] = {smem, smem + xs};
  float* t = smem + 2 * xs;
  float* sby = t + hj * kTileK;
  float* sbz = sby + 2 * tp.nfy + 1;
  load_taps(p, sby, sbz);
  const int j0 = blockIdx.y * kTileJ;
  const int k0 = blockIdx.x * kTileK;
  int cur = 0;
  if (static_cast<int>(blockIdx.z) < p.num_cs)
    fill_tile<kSrcPhilox, BF16>(tp, blockIdx.z, j0, k0, xbuf[0]);
  for (int cs = blockIdx.z; cs < p.num_cs; cs += gridDim.z) {
    __syncthreads();  // x[cur] is drawn; the last slab's t is consumed
    const int next = cs + static_cast<int>(gridDim.z);
    if (next < p.num_cs) fill_tile<kSrcPhilox, BF16>(tp, next, j0, k0, xbuf[cur ^ 1]);
    z_pass<BF16>(tp.nfy, tp.nfz, xbuf[cur], sbz, t);
    __syncthreads();
    store_tile(p, cs, j0, k0, t, sby);
    cur ^= 1;
  }
}

int filter_smem_bytes(int nfy, int nfz, int buffers) {
  const int extra_x = (buffers - 1) * (kTileJ + 2 * nfy) * (kTileK + 2 * nfz);
  return static_cast<int>(sizeof(float)) *
         (tile_smem_floats(nfy, nfz) + extra_x + (2 * nfy + 1) + (2 * nfz + 1));
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, dim3 grid, int smem,
                   cudaStream_t stream) {
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_filter(int mode, const Params& p, cudaStream_t s) {
  const int kx = (p.tile.kma + kTileK - 1) / kTileK;
  const int jy = (p.tile.jma + kTileJ - 1) / kTileJ;
  const unsigned int gz =
      static_cast<unsigned int>(p.num_cs < kMaxGrid ? p.num_cs : kMaxGrid);
  const int smem1 = filter_smem_bytes(p.tile.nfy, p.tile.nfz, 1);
  switch (mode) {
    case kPhiloxFiltered:
      return launch(filter_kernel<kSrcPhilox, BF16>, p, dim3(kx, jy, gz), smem1, s);
    case kNoiseInFiltered:
      return launch(filter_kernel<kSrcNoiseIn, BF16>, p, dim3(kx, jy, gz), smem1, s);
    case kIotaFiltered:
      return launch(filter_kernel<kSrcIota, BF16>, p, dim3(kx, jy, gz), smem1, s);
    case kPipelined: {
      // enough blocks per tile column to fill every SM once, no more
      const int smem2 = filter_smem_bytes(p.tile.nfy, p.tile.nfz, 2);
      auto kernel = pipelined_kernel<BF16>;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
      if (err != cudaSuccess) return err;
      int dev = 0, sms = 0, per_sm = 0;
      if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess)
        return err;
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kernel, kThreads, smem2)) != cudaSuccess)
        return err;
      const int tiles = kx * jy;
      int z = (sms * (per_sm > 0 ? per_sm : 1) + tiles - 1) / tiles;
      if (z > p.num_cs) z = p.num_cs;
      if (z > kMaxGrid) z = kMaxGrid;
      if (z < 1) z = 1;
      return launch(kernel, p, dim3(kx, jy, z), smem2, s);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one filtering block asks for, in bytes (the
// pipelined mode holds two noise buffers).
int fused_filter_smem_bytes(int nfy, int nfz, int pipelined) {
  return filter_smem_bytes(nfy, nfz, pipelined ? 2 : 1);
}

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
// cudaError_t of the launch.  `out_bf16` applies to kPhiloxRaw, `bf16_taps`
// to the filtering modes (whose taps hold bf16 values when it is set).
int fused_filter_launch(int mode, int bf16_taps, int out_bf16,
                        const float* noise, void* out, const float* dummy,
                        const float* by, const float* bz, int nfy, int nfz,
                        int jma, int kma, int num_components, int num_slabs,
                        unsigned int t0, unsigned int key0, unsigned int key1,
                        float scale, float iota_scale, void* stream) {
  Params p;
  p.tile.noise = noise;
  p.tile.nfy = nfy;
  p.tile.nfz = nfz;
  p.tile.jma = jma;
  p.tile.kma = kma;
  p.tile.jn = jma + 2 * nfy;
  p.tile.kn = kma + 2 * nfz;
  p.tile.num_slabs = num_slabs;
  p.tile.t0 = t0;
  p.tile.key0 = key0;
  p.tile.key1 = key1;
  p.tile.scale = scale;
  p.tile.iota_scale = iota_scale;
  p.out = out;
  p.dummy = dummy;
  p.by = by;
  p.bz = bz;
  p.num_cs = num_components * num_slabs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kPhiloxRaw) {
    const unsigned int gz =
        static_cast<unsigned int>(p.num_cs < kMaxGrid ? p.num_cs : kMaxGrid);
    const dim3 grid((p.tile.kn + kTileK - 1) / kTileK,
                    (p.tile.jn + kTileJ - 1) / kTileJ, gz);
    return static_cast<int>(out_bf16 ? launch(raw_kernel<__nv_bfloat16>, p, grid, 0, s)
                                     : launch(raw_kernel<float>, p, grid, 0, s));
  }
  return static_cast<int>(bf16_taps ? launch_filter<true>(mode, p, s)
                                    : launch_filter<false>(mode, p, s));
}

}  // extern "C"
