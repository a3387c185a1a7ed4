// K4: fused Philox noise + spatial filter + temporal FIR, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the experiment
// benchmarks/exp_two_kernel_pipeline.py: fused_temporal -> _fused_temporal_body
// (the fused body plus an in-kernel 2nfx+1-deep ring of filtered slabs, whose
// output is the temporally filtered window (C, nsteps, jma, kma) directly;
// row 10 of the kernel table in PERF.md).
//
// What it computes: y[c, n] = sum_i bx[i] z[c, n + i] for n < nsteps =
// num_slabs - 2nfx, where z is K1's spatially filtered slab -- made by K1's
// own passes (filter_tile.cuh), so K4 equals K1 followed by the plain FIR
// (filters.filter_temporal) up to the f32 summation order of the FIR.  Each
// block owns one ch x ks output tile (32 x 32 unless the ring does not fit)
// of one component and a chunk of `chunk` output steps; it walks the chunk's
// slabs in order: draw the tile's noise with its halo, z-pass, y-pass into
// the ring slot of the slab (the last 2nfx+1 filtered tiles, f32, in shared
// memory), then, once the ring is full, one output tile:
// y = sum_d bx[d] ring[(n + d) mod (2nfx+1)] as one fmaf chain in ascending
// d, 4 columns a thread read as float4.  Chunks recompute 2nfx warm-up slabs
// each; the wrapper sizes them from the block slots the card reports, so the
// last wave of blocks is not mostly empty.  No output step is written before
// its ring is full (the TPU body's zero-writes to output block 0 during its
// warm-up have no counterpart).
//
// Deviations from the TPU body, on purpose: the ring is f32 (the TPU's bf16
// ring saved VMEM and was not part of the meaning), and the noise scale is
// not folded into the y taps.
//
// What bounds it: the filter work of K1 on a tile (48 x 48 noise values and
// 48 z-filtered rows for 32 x 32 outputs at nf = 8: 2.25 draws and 1.5 z rows
// an output, where K1's walk has 1.16 and 1.03), plus 2nfx+1 FMAs and 2nfx+1
// 4-byte ring reads an output (one float4 read per 4 FMAs: 0.23 shared loads
// per FFMA in the static SASS; every ring value is read by one output only,
// so no register blocking removes them).  The only device-memory traffic is
// the write of y.  The ring is 17 x 4 KB at nfx = 8, so two 256-thread
// blocks share an SM, where the first version's 32 x 64 tiles and 139 KB
// ring held one 8-warp block: 41.3 ms per 1,024-step 512x512 window at nf =
// 8 then, 7.3-7.6 ms now, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md;
// experiments/tile_trial.py times the other tiles).  With nfx = nfy =
// nfz = 8 the three tap loops unroll and the taps live in registers; any
// other half-widths read their taps from shared memory.  An nfx whose ring
// does not fit even a 32 x 8 tile is refused by the wrapper with the byte
// count.
//
// Modes: Philox noise (the experiment), or given f32 noise (the CPU parity
// tests and the check on the card); f32 or bf16 taps as K1.

#include <type_traits>

#include "filter_tile.cuh"

namespace {

using namespace podfs;

constexpr int kTemporalThreads = 256;

struct Params {
  TileParams tile;
  float* out;         // (C, nsteps, jma, kma)
  const float* bx;    // (2*nfx + 1,)
  int nfx;
  int nsteps;
  int chunk;          // output steps per block
  int num_chunks;
};

// writes a y-pass item (1 column x 4 rows) into a ring slot
struct RingSink {
  float* slot;
  int ks;
  __device__ __forceinline__ void operator()(int row, int col, float (&acc)[4][1]) const {
#pragma unroll
    for (int o = 0; o < 4; ++o) slot[(row + o) * ks + col] = acc[o][0];
  }
};

// calls f(std::integral_constant<int, r0>) for a run-time r0 < D
template <int D, int R0 = 0, typename F>
__device__ __forceinline__ void with_offset(int r0, F&& f) {
  if constexpr (R0 < D) {
    if (r0 == R0)
      f(std::integral_constant<int, R0>{});
    else
      with_offset<D, R0 + 1>(r0, f);
  }
}

__device__ __forceinline__ void fma4(float b, const float4 v, float (&acc)[4]) {
  acc[0] = fmaf(b, v.x, acc[0]);
  acc[1] = fmaf(b, v.y, acc[1]);
  acc[2] = fmaf(b, v.z, acc[2]);
  acc[3] = fmaf(b, v.w, acc[3]);
}

template <int SRC, bool BF16, int NX, int NY, int NZ>
__global__ void __launch_bounds__(kTemporalThreads)
    fused_temporal_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const TileParams& tp = p.tile;
  const int halo = 2 * tp.nfy;
  const int xr = tp.ch + halo;
  const int depth = 2 * p.nfx + 1;
  const int tile = tp.ch * tp.ks;
  float* x = smem;
  float* t = x + xr * tp.xp;
  float* ring = t + tp.tr * tp.tp;     // (depth, ch, ks) filtered tiles
  float* staps = ring + depth * tile;
  Taps<NY> by;
  Taps<NZ> bz;
  Taps<NX> bx;
  by.load(tp.by, staps, tp.nfy);
  bz.load(tp.bz, staps + round4(halo + 1), tp.nfz);
  bx.load(p.bx, staps + round4(halo + 1) + round4(2 * tp.nfz + 1), p.nfx);
  zero_t_tail(tp, t, xr);

  const int j0 = blockIdx.y * tp.ch;
  const int k0 = blockIdx.x * tp.ks;
  const int comp = blockIdx.z / p.num_chunks;
  const int n0 = (blockIdx.z % p.num_chunks) * p.chunk;
  const int n1 = min(p.nsteps, n0 + p.chunk);
  const int width = fill_width<NZ>(tp);
  const int cols4_log2 = tp.ks_log2 - 2;
  const int items = tp.ch << cols4_log2;
  const bool whole = (tp.kma & 3) == 0;
  for (int s = n0; s < n1 + depth - 1; ++s) {
    const int cs = comp * tp.num_slabs + s;
    __syncthreads();  // the last slab's passes and FIR are done
    fill_rows<SRC, BF16>(tp, cs, j0, xr, k0, width, x);
    __syncthreads();
    z_pass<BF16, NZ>(tp, x, t, xr, bz);
    __syncthreads();
    y_pass<NY, 1, 4>(tp, t, by, RingSink{ring + (s % depth) * tile, tp.ks});
    if (s < n0 + depth - 1) continue;  // warm-up: the ring is not full yet
    __syncthreads();
    const int n = s - (depth - 1);
    const int r0 = n % depth;
    float* dst = p.out + (static_cast<size_t>(comp) * p.nsteps + n) * tp.jma * tp.kma;
    const float4* ring4 = reinterpret_cast<const float4*>(ring);
    const int tile4 = tile >> 2;
    auto store = [&](int i, const float (&acc)[4]) {
      const int j = j0 + (i >> cols4_log2);
      const int k = k0 + 4 * (i & ((1 << cols4_log2) - 1));
      if (j >= tp.jma || k >= tp.kma) return;
      float* d = dst + static_cast<size_t>(j) * tp.kma + k;
      if (whole) {
        *reinterpret_cast<float4*>(d) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < tp.kma) d[e] = acc[e];
      }
    };
    if constexpr (NX > 0) {
      constexpr int D = 2 * NX + 1;
      with_offset<D>(r0, [&](auto off) {
        constexpr int R0 = decltype(off)::value;
        for (int i = threadIdx.x; i < items; i += blockDim.x) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int d = 0; d < D; ++d) fma4(bx.b[d], ring4[((R0 + d) % D) * tile4 + i], acc);
          store(i, acc);
        }
      });
    } else {
      const float* sbx = reinterpret_cast<const float*>(bx.s);
      for (int i = threadIdx.x; i < items; i += blockDim.x) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int d = 0; d < depth - r0; ++d)
          fma4(sbx[d], ring4[(r0 + d) * tile4 + i], acc);
        for (int d = depth - r0; d < depth; ++d)
          fma4(sbx[d], ring4[(d - (depth - r0)) * tile4 + i], acc);
        store(i, acc);
      }
    }
  }
}

int smem_bytes(int nfx, int nfy, int nfz, int ks, int ch) {
  return static_cast<int>(sizeof(float)) *
         (walk_smem_floats(nfy, nfz, ks, ch, 1) + (2 * nfx + 1) * ch * ks +
          round4(2 * nfx + 1));
}

// the kernel that runs (nfx, nfy, nfz), `noise_in`, `bf16_taps`
const void* pick(int nfx, int nfy, int nfz, int noise_in, int bf16_taps) {
  const bool unrolled = nfx == 8 && nfy == 8 && nfz == 8;
  const void* k = nullptr;
#define PODFS_PICK(SRC, BF)                                                          \
  k = unrolled ? reinterpret_cast<const void*>(fused_temporal_kernel<SRC, BF, 8, 8, 8>) \
               : reinterpret_cast<const void*>(fused_temporal_kernel<SRC, BF, 0, 0, 0>)
  if (noise_in) {
    if (bf16_taps) PODFS_PICK(kSrcNoiseIn, true); else PODFS_PICK(kSrcNoiseIn, false);
  } else {
    if (bf16_taps) PODFS_PICK(kSrcPhilox, true); else PODFS_PICK(kSrcPhilox, false);
  }
#undef PODFS_PICK
  return k;
}

}  // namespace

extern "C" {

// Dynamic shared memory of a K4 block with a ch x ks tile, in bytes.
int fused_temporal_smem_bytes(int nfx, int nfy, int nfz, int ks, int ch) {
  return smem_bytes(nfx, nfy, nfz, ks, ch);
}

// K4 blocks the card holds at once (its SMs times the blocks an SM holds at
// this tile), or -(cudaError_t) on failure.
int fused_temporal_slots(int nfx, int nfy, int nfz, int ks, int ch, int noise_in,
                         int bf16_taps, int device) {
  const void* kernel = pick(nfx, nfy, nfz, noise_in, bf16_taps);
  const int smem = smem_bytes(nfx, nfy, nfz, ks, ch);
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kTemporalThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms * per_sm;
}

// Launches K4 on `stream` (noise != null: given-noise mode) with ch x ks
// tiles; returns the cudaError_t of the launch.
int fused_temporal_launch(int bf16_taps, const float* noise, float* out,
                          const float* bx, const float* by, const float* bz,
                          int nfx, int nfy, int nfz, int jma, int kma,
                          int num_components, int nsteps, int chunk, int ks,
                          int ch, unsigned int t0, unsigned int key0,
                          unsigned int key1, float scale, void* stream) {
  Params p{};
  p.tile.noise = noise;
  p.tile.by = by;
  p.tile.bz = bz;
  p.tile.nfy = nfy;
  p.tile.nfz = nfz;
  p.tile.jma = jma;
  p.tile.kma = kma;
  p.tile.jn = jma + 2 * nfy;
  p.tile.kn = kma + 2 * nfz;
  p.tile.num_slabs = nsteps + 2 * nfx;
  p.tile.t0 = t0;
  p.tile.keys = round_keys(key0, key1);
  p.tile.scale = scale;
  p.tile.iota_scale = 0.f;
  p.out = out;
  p.bx = bx;
  p.nfx = nfx;
  p.nsteps = nsteps;
  p.chunk = chunk;
  p.num_chunks = (nsteps + chunk - 1) / chunk;
  const long long gz = static_cast<long long>(num_components) * p.num_chunks;
  if (gz > kMaxGrid || chunk < 1 || (ks != 32 && ks != 64 && ks != 128) ||
      ch < 8 || ch % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  set_walk(p.tile, ks, ch);
  const dim3 grid((kma + ks - 1) / ks, (jma + ch - 1) / ch,
                  static_cast<unsigned int>(gz));
  const int smem = smem_bytes(nfx, nfy, nfz, ks, ch);
  const void* kernel = pick(nfx, nfy, nfz, noise != nullptr, bf16_taps);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  err = cudaLaunchKernel(kernel, grid, dim3(kTemporalThreads), args,
                         static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
