// K4: fused Philox noise + spatial filter + temporal FIR, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the experiment
// benchmarks/exp_two_kernel_pipeline.py: fused_temporal -> _fused_temporal_body
// (the fused body plus an in-kernel 2nfx+1-deep ring of filtered slabs, whose
// output is the temporally filtered window (C, nsteps, jma, kma) directly;
// row 10 of the kernel table in PERF.md).
//
// What it computes: y[c, n] = sum_i bx[i] z[c, n + i] for n < nsteps =
// num_slabs - 2nfx, where z is K1's spatially filtered slab -- the very tile
// code of K1 (filter_tile.cuh), so K4 equals K1 followed by the plain FIR
// (filters.filter_temporal) up to the f32 summation order of the FIR.  Each
// block owns one kTileJ x kTileK tile of one component and a chunk of
// `chunk` output steps; it walks the chunk's slabs in order, keeps the last
// 2nfx+1 filtered tiles in a ring in shared memory, and writes one output
// tile per slab once the ring is full.  Each thread reads back only the ring
// entries it wrote itself, so the ring needs no barrier of its own.  Chunks
// recompute 2nfx warm-up slabs each, so that short windows still give enough
// blocks; no output step is written before its ring is full (the TPU body's
// zero-writes to output block 0 during its warm-up have no counterpart).
//
// Deviations from the TPU body, on purpose: the ring is f32 (the TPU's bf16
// ring saved VMEM and was not part of the meaning), and the noise scale is
// not folded into the y taps.
//
// What bounds it: the same filter work as K1 plus 2nfx+1 FMAs per output and
// (1 + 2nfx/chunk) times K1's filter work for the warm-up; the only
// device-memory traffic is the write of y, nsteps/num_slabs of K1's.  The
// ring costs (2nfx+1) * 8 KB of shared memory (139 KB at nfx = 8), so one
// block fits on an SM: the shared-memory loads that bound K1's passes
// now run at one block per SM instead of several: 41.5 ms per 1,024-step
// 512x512 window at nf = 8, about K1 plus the FIR product (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md).  An nfx whose ring does not fit is refused by the
// wrapper with the byte count.
//
// Modes: Philox noise (the experiment), or given f32 noise (the CPU parity
// tests and the check on the card); f32 or bf16 taps as K1.

#include "filter_tile.cuh"

namespace {

using namespace podfs;

constexpr int kTile = kTileJ * kTileK;

struct Params {
  TileParams tile;
  float* out;         // (C, nsteps, jma, kma)
  const float* bx;    // (2*nfx + 1,)
  const float* by;
  const float* bz;
  int nfx;
  int nsteps;
  int chunk;          // output steps per block
  int num_chunks;
};

template <int SRC, bool BF16>
__global__ void __launch_bounds__(kThreads)
    fused_temporal_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  const TileParams& tp = p.tile;
  const int hj = kTileJ + 2 * tp.nfy;
  const int depth = 2 * p.nfx + 1;
  float* x = smem;
  float* t = x + hj * (kTileK + 2 * tp.nfz);
  float* ring = t + hj * kTileK;        // (depth, kTile) filtered tiles
  float* sby = ring + depth * kTile;
  float* sbz = sby + 2 * tp.nfy + 1;
  float* sbx = sbz + 2 * tp.nfz + 1;
  for (int i = threadIdx.x; i < 2 * tp.nfy + 1; i += kThreads) sby[i] = p.by[i];
  for (int i = threadIdx.x; i < 2 * tp.nfz + 1; i += kThreads) sbz[i] = p.bz[i];
  for (int i = threadIdx.x; i < depth; i += kThreads) sbx[i] = p.bx[i];

  const int j0 = blockIdx.y * kTileJ;
  const int k0 = blockIdx.x * kTileK;
  const int comp = blockIdx.z / p.num_chunks;
  const int n0 = (blockIdx.z % p.num_chunks) * p.chunk;
  const int n1 = min(p.nsteps, n0 + p.chunk);
  for (int s = n0; s < n1 + depth - 1; ++s) {
    const int cs = comp * tp.num_slabs + s;
    __syncthreads();  // taps are loaded; the last slab's x and t are consumed
    fill_tile<SRC, BF16>(tp, cs, j0, k0, x);
    __syncthreads();
    z_pass<BF16>(tp.nfy, tp.nfz, x, sbz, t);
    __syncthreads();
    float* slot = ring + (s % depth) * kTile;
    for (int i = threadIdx.x; i < kTile; i += kThreads)
      slot[i] = y_at(t, sby, tp.nfy, i / kTileK, i % kTileK);
    if (s < n0 + depth - 1) continue;  // warm-up: the ring is not full yet
    const int n = s - (depth - 1);
    float* dst = p.out + (static_cast<size_t>(comp) * p.nsteps + n) * tp.jma * tp.kma;
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int j = j0 + i / kTileK;
      const int k = k0 + i % kTileK;
      if (j >= tp.jma || k >= tp.kma) continue;
      float acc = 0.f;
      for (int d = 0; d < depth; ++d)
        acc = fmaf(sbx[d], ring[((n + d) % depth) * kTile + i], acc);
      dst[static_cast<size_t>(j) * tp.kma + k] = acc;
    }
  }
}

int smem_bytes(int nfx, int nfy, int nfz) {
  return static_cast<int>(sizeof(float)) *
         (tile_smem_floats(nfy, nfz) + (2 * nfx + 1) * kTile +
          (2 * nfx + 1) + (2 * nfy + 1) + (2 * nfz + 1));
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, dim3 grid, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_temporal_smem_bytes(int nfx, int nfy, int nfz) {
  return smem_bytes(nfx, nfy, nfz);
}

// Launches K4 on `stream` (noise != null: given-noise mode); returns the
// cudaError_t of the launch.
int fused_temporal_launch(int bf16_taps, const float* noise, float* out,
                          const float* bx, const float* by, const float* bz,
                          int nfx, int nfy, int nfz, int jma, int kma,
                          int num_components, int nsteps, int chunk,
                          unsigned int t0, unsigned int key0, unsigned int key1,
                          float scale, void* stream) {
  Params p;
  p.tile.noise = noise;
  p.tile.nfy = nfy;
  p.tile.nfz = nfz;
  p.tile.jma = jma;
  p.tile.kma = kma;
  p.tile.jn = jma + 2 * nfy;
  p.tile.kn = kma + 2 * nfz;
  p.tile.num_slabs = nsteps + 2 * nfx;
  p.tile.t0 = t0;
  p.tile.key0 = key0;
  p.tile.key1 = key1;
  p.tile.scale = scale;
  p.tile.iota_scale = 0.f;
  p.out = out;
  p.bx = bx;
  p.by = by;
  p.bz = bz;
  p.nfx = nfx;
  p.nsteps = nsteps;
  p.chunk = chunk;
  p.num_chunks = (nsteps + chunk - 1) / chunk;
  const long long gz = static_cast<long long>(num_components) * p.num_chunks;
  if (gz > kMaxGrid || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((kma + kTileK - 1) / kTileK, (jma + kTileJ - 1) / kTileJ,
                  static_cast<unsigned int>(gz));
  const int smem = smem_bytes(nfx, nfy, nfz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (noise != nullptr)
    err = bf16_taps ? launch(fused_temporal_kernel<kSrcNoiseIn, true>, p, grid, smem, s)
                    : launch(fused_temporal_kernel<kSrcNoiseIn, false>, p, grid, smem, s);
  else
    err = bf16_taps ? launch(fused_temporal_kernel<kSrcPhilox, true>, p, grid, smem, s)
                    : launch(fused_temporal_kernel<kSrcPhilox, false>, p, grid, smem, s);
  return static_cast<int>(err);
}

}  // extern "C"
