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
//   benchmarks/exp_pipelined_kernel.py _kernel_pipelined (the next slab's
//   noise drawn before this slab is filtered).
// It computes what they compute, not how.  Each block owns a strip of `ks`
// output columns of one (component, slab) and walks down j over a segment of
// rows, `ch` output rows a step:
//   1. it draws the step's noise rows with their 2nfz-column halo into shared
//      memory from an element-keyed Philox4x32-10 stream (counter (k>>2, j,
//      slab, comp), key (seed lo, seed hi), word k&3), so neighbouring strips
//      rebuild the same halo values and the raw noise never reaches device
//      memory;
//   2. runs the z-pass t[j,k] = sum_d bz[d] x[j,k+d] on those rows, keeping
//      the last 2nfy rows of t from the step before (so each noise row of a
//      segment is drawn and z-filtered once), then the y-pass
//      out[j,k] = sum_d by[d] t[j+d,k] for the step's ch rows, as f32 FMA
//      chains in registers (filter_tile.cuh) written with 16-byte stores.
// The strip width and step height are chosen from nf by the wrapper (the
// largest that fits the shared memory), so an nf only refuses when even a 32
// x 8 strip step does not fit, with the byte count; the TPU's full-slab /
// tiled split, its VMEM guard and its silent XLA fallback have no
// counterpart.
//
// What bounds it: at 512x512, nf=8, one 1,040-slab three-component window
// writes 3 * 1040 * 512 * 512 * 4 B = 3.27 GB of f32 output, 0.98 ms at the
// H100's 3.35 TB/s; its banded FMAs are 3120 * 17 * (528*512 + 512*512) =
// 28 G, 0.85 ms at 67 TFLOP/s.  The first version (32 x 64 tiles, taps and
// operands both from shared memory: two shared loads per FMA) took 10.3 ms
// on an NVIDIA H100 80GB HBM3 at 700 W, bound by those loads.  This one
// issues 0.046 shared loads per FFMA at nf = 8 (static SASS; taps in
// registers, 8 outputs a z item, 8 x 4 a y item) and draws 1.16 noise values
// per output (144 columns for a 128-column strip, 528 rows for 512) where
// the tiles drew 1.88.  What is left is instruction issue: about 20
// instructions per output in each pass and about 25 for the draw (Philox's
// 20 64-bit multiplies and 20 three-way xors per 4 values, its round keys
// read from the kernel parameters), some 64 per output, 1.6 ms at full
// issue over the card's 132 SMs x 128 lanes.  It takes 2.39-2.43 ms there
// (41 % of the output-write rate), 2.79 ms with bf16 taps (whose roundings
// run on the integer units), at four 4-warp blocks an SM; the raw bf16
// field of the experiments, 66.9 M values, 0.064 ms against a 0.040 ms
// store bound (PERF.md).
//
// Modes (run-time `mode`, each a template instantiation):
//   kPhiloxFiltered  -- Philox -> filtered slab (rows 1 and 2 of the kernel
//                       table); with `dummy` set, dummy[cs] (8 x 128) is added
//                       to out[cs, :8, :128] after the filter (row 9)
//   kNoiseInFiltered -- given f32 noise -> filtered slab (interpret bodies)
//   kPhiloxRaw       -- Philox -> raw noise field, f32 or bf16 (rows 3, 4, 5)
//   kIotaFiltered    -- iota field k*(cs+1)*2sqrt3/65536 -> filtered (row 9)
//   kPipelined       -- Philox -> filtered with persistent blocks that draw
//                       the next step's noise (the next slab's, at a slab's
//                       last step) into a second buffer while they z-filter
//                       this one (row 11); bit-identical to kPhiloxFiltered
// and bf16_taps (f32 or bf16 taps) for every filtering mode; the passes are
// unrolled for nfy = nfz = 8 (the main path, -f 2 -l 4) and 6 (the CLI's
// default -f 2 -l 3) and run any other half-widths from shared-memory taps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC, linked with the other csrc/*.cu into one shared
//        library (ops/_build.py); bound with ctypes (plain C entry points).

#include "filter_tile.cuh"

namespace {

using namespace podfs;

constexpr int kWalkThreads = 128;   // a filtering block: 4 warps

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
  int num_cs;           // components * slabs
  int seg_rows;         // output rows of a block's segment, a multiple of ch
};

// the raw field, 8 values of a row an item (two Philox calls), 16-byte
// stores (8-byte halves in bf16 where a row is off 16 bytes: put8); a
// thread's items are the grid stride apart, and their (group, row, slab,
// component) advance by the stride's own with carries, not by divisions
template <typename OutT>
__global__ void __launch_bounds__(kThreads) raw_kernel(const __grid_constant__ Params p) {
  const TileParams& tp = p.tile;
  const int groups = (tp.kn + 7) / 8, jn = tp.jn, ns = tp.num_slabs;
  const uint32_t items = static_cast<uint32_t>(p.num_cs) * jn * groups;
  const uint32_t stride = gridDim.x * kThreads;
  uint32_t it = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t srows = stride / groups, scs = srows / jn;
  const int dg = static_cast<int>(stride - srows * groups);
  const int dj = static_cast<int>(srows - scs * jn);
  const int dslab = static_cast<int>(scs % ns), dcomp = static_cast<int>(scs / ns);
  int g = static_cast<int>(it % groups);
  int j = static_cast<int>((it / groups) % jn);
  const int cs = static_cast<int>(it / groups / jn);
  int slab = cs % ns, comp = cs / ns;
  for (; it < items; it += stride) {
    float v[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Words w = philox4x32_10(static_cast<uint32_t>(2 * g + h),
                                    static_cast<uint32_t>(j),
                                    tp.t0 + static_cast<uint32_t>(slab),
                                    static_cast<uint32_t>(comp), tp.keys);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[4 * h + q] = word_to_uniform(w.w[q], tp.scale);
    }
    const int k0 = 8 * g;
    put8<OutT>(p.out,
               (static_cast<size_t>(comp * ns + slab) * jn + j) * tp.kn + k0, v,
               tp.kn - k0 < 8 ? tp.kn - k0 : 8);
    g += dg;
    int carry = g >= groups;
    g -= carry ? groups : 0;
    j += dj + carry;
    carry = j >= jn;
    j -= carry ? jn : 0;
    slab += dslab + carry;
    carry = slab >= ns;
    slab -= carry ? ns : 0;
    comp += dcomp + carry;
  }
}

// stores a y-pass item of the step at output row jo: 4 columns x 8 rows
struct OutSink {
  float* dst;           // this slab's (jma, kma) output
  const float* dummy;   // this slab's 8 x 128 dummy block, or null
  int jo, jend, k0, kma;
  __device__ __forceinline__ void operator()(int row, int col,
                                             float (&acc)[8][4]) const {
    const int k = k0 + col;
    if (k >= kma) return;
    const bool whole = (kma & 3) == 0 && k + 4 <= kma;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int j = jo + row + o;
      if (j >= jend) break;
      float* d = dst + static_cast<size_t>(j) * kma + k;
      if (dummy && j < 8) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < 128) acc[o][e] += dummy[j * 128 + k + e];
      }
      if (whole) {
        *reinterpret_cast<float4*>(d) =
            make_float4(acc[o][0], acc[o][1], acc[o][2], acc[o][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < kma) d[e] = acc[o][e];
      }
    }
  }
};

// The walk of one block: strip blockIdx.x, segment blockIdx.y, slabs cs =
// blockIdx.z, blockIdx.z + gridDim.z, ...; per step: [shift t, draw] |
// z-pass | y-pass, with a barrier between; PIPE draws the next step's noise
// into the other buffer during the z-pass instead.
template <int SRC, bool BF16, int NY, int NZ, bool PIPE>
__global__ void __launch_bounds__(kWalkThreads)
    walk_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const TileParams& tp = p.tile;
  const int halo = 2 * tp.nfy;
  const int xr = tp.ch + halo;                 // x rows of a segment's first step
  float* xbuf[2] = {smem, smem + xr * tp.xp};
  float* t = smem + (PIPE ? 2 : 1) * xr * tp.xp;
  float* staps = t + tp.tr * tp.tp;
  Taps<NY> by;
  Taps<NZ> bz;
  by.load(tp.by, staps, tp.nfy);
  bz.load(tp.bz, staps + round4(halo + 1), tp.nfz);
  zero_t_tail(tp, t, xr);

  const int k0 = blockIdx.x * tp.ks;
  const int seg0 = blockIdx.y * p.seg_rows;
  const int seg1 = min(tp.jma, seg0 + p.seg_rows);
  const int width = fill_width<NZ>(tp);
  float* dst = static_cast<float*>(p.out);
  const size_t plane = static_cast<size_t>(tp.jma) * tp.kma;
  // a step: its slab and first output row; the first step of a segment
  // draws and z-filters xr rows, the others ch new rows below the kept 2nfy
  auto draw = [&](int cs, int jo, float* x) {
    if (jo == seg0)
      fill_rows<SRC, BF16>(tp, cs, jo, xr, k0, width, x);
    else
      fill_rows<SRC, BF16>(tp, cs, jo + halo, tp.ch, k0, width, x);
  };
  int cs = blockIdx.z, jo = seg0, cur = 0;
  if (cs >= p.num_cs || seg0 >= tp.jma) return;
  if constexpr (PIPE) draw(cs, jo, xbuf[0]);
  for (;;) {
    const bool first = jo == seg0;
    int ncs = cs, njo = jo + tp.ch;
    if (njo >= seg1) {
      njo = seg0;
      ncs += gridDim.z;
    }
    __syncthreads();        // the last step's passes are done with x and t
    if (!first) shift_t(tp, t);
    if constexpr (!PIPE) draw(cs, jo, xbuf[0]);
    __syncthreads();
    if constexpr (PIPE) {
      if (ncs < p.num_cs) draw(ncs, njo, xbuf[cur ^ 1]);
    }
    z_pass<BF16, NZ>(tp, xbuf[cur], first ? t : t + halo * tp.tp,
                     first ? xr : tp.ch, bz);
    __syncthreads();
    y_pass<NY, 4, 8>(tp, t, by,
                     OutSink{dst + cs * plane,
                             p.dummy ? p.dummy + static_cast<size_t>(cs) * 8 * 128
                                     : nullptr,
                             jo, seg1, k0, tp.kma});
    if constexpr (PIPE) cur ^= 1;
    cs = ncs;
    jo = njo;
    if (cs >= p.num_cs) break;
  }
}

int walk_smem_bytes(int nfy, int nfz, int ks, int ch, int pipelined) {
  return static_cast<int>(sizeof(float)) *
         walk_smem_floats(nfy, nfz, ks, ch, pipelined ? 2 : 1);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, dim3 grid, int threads,
                   int smem, cudaStream_t stream) {
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t slots(const void* kernel, int smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           kWalkThreads, smem)) !=
      cudaSuccess)
    return err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

// Grid of a walk: a segment per strip while the (strip, slab) blocks fill
// the card's block slots twice; more segments (halving the rows, so each
// redraws 2nfy rows) when they do not.  The pipelined mode's blocks persist
// over the slabs: as many per (strip, segment) as fill the slots once.
// With `slots_out` set it only reports the slots.
template <int SRC, bool BF16, int NY, int NZ, bool PIPE>
cudaError_t launch_walk(Params p, cudaStream_t s, int* slots_out) {
  auto kernel = walk_kernel<SRC, BF16, NY, NZ, PIPE>;
  const TileParams& tp = p.tile;
  const int smem = walk_smem_bytes(tp.nfy, tp.nfz, tp.ks, tp.ch, PIPE);
  int n_slots = 0;
  cudaError_t err = slots(reinterpret_cast<const void*>(kernel), smem, &n_slots);
  if (err != cudaSuccess) return err;
  if (slots_out != nullptr) {
    *slots_out = n_slots;
    return cudaSuccess;
  }
  const int strips = (tp.kma + tp.ks - 1) / tp.ks;
  const int steps = (tp.jma + tp.ch - 1) / tp.ch;
  const long long per_seg = static_cast<long long>(strips) *
                            (p.num_cs < kMaxGrid ? p.num_cs : kMaxGrid);
  int segs = 1;
  while (segs < steps && per_seg * segs < 2LL * n_slots) segs *= 2;
  if (segs > steps) segs = steps;
  p.seg_rows = ((steps + segs - 1) / segs) * tp.ch;
  segs = (tp.jma + p.seg_rows - 1) / p.seg_rows;
  int gz = p.num_cs < kMaxGrid ? p.num_cs : kMaxGrid;
  if (PIPE) {
    const int per = strips * segs;
    gz = (n_slots + per - 1) / per;
    if (gz > p.num_cs) gz = p.num_cs;
    if (gz > kMaxGrid) gz = kMaxGrid;
    if (gz < 1) gz = 1;
  }
  return launch(kernel, p, dim3(strips, segs, gz), kWalkThreads, smem, s);
}

template <int SRC, bool BF16, bool PIPE>
cudaError_t launch_nf(const Params& p, cudaStream_t s, int* slots_out) {
  const int nfy = p.tile.nfy, nfz = p.tile.nfz;
  if (nfy == 8 && nfz == 8) return launch_walk<SRC, BF16, 8, 8, PIPE>(p, s, slots_out);
  if (nfy == 6 && nfz == 6) return launch_walk<SRC, BF16, 6, 6, PIPE>(p, s, slots_out);
  return launch_walk<SRC, BF16, 0, 0, PIPE>(p, s, slots_out);
}

template <bool BF16>
cudaError_t launch_filter(int mode, const Params& p, cudaStream_t s, int* slots_out) {
  switch (mode) {
    case kPhiloxFiltered:
      return launch_nf<kSrcPhilox, BF16, false>(p, s, slots_out);
    case kNoiseInFiltered:
      return launch_nf<kSrcNoiseIn, BF16, false>(p, s, slots_out);
    case kIotaFiltered:
      return launch_nf<kSrcIota, BF16, false>(p, s, slots_out);
    case kPipelined:
      return launch_nf<kSrcPhilox, BF16, true>(p, s, slots_out);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of a filtering block with a ks x ch strip step, in
// bytes (the pipelined mode holds two noise buffers); the wrapper picks the
// largest step that fits.
int fused_filter_smem_bytes(int nfy, int nfz, int ks, int ch, int pipelined) {
  return walk_smem_bytes(nfy, nfz, ks, ch, pipelined);
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
// to the filtering modes (whose taps hold bf16 values when it is set), `ks`
// (32, 64 or 128) and `ch` (a multiple of 8) to the filtering modes.  With
// `slots_out` set, a filtering mode is not launched: the blocks of its
// kernel the card holds at once go there.
int fused_filter_launch(int mode, int bf16_taps, int out_bf16,
                        const float* noise, void* out, const float* dummy,
                        const float* by, const float* bz, int nfy, int nfz,
                        int jma, int kma, int num_components, int num_slabs,
                        int ks, int ch, unsigned int t0, unsigned int key0,
                        unsigned int key1, float scale, float iota_scale,
                        void* stream, int* slots_out) {
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
  p.tile.num_slabs = num_slabs;
  p.tile.t0 = t0;
  p.tile.keys = round_keys(key0, key1);
  p.tile.scale = scale;
  p.tile.iota_scale = iota_scale;
  p.out = out;
  p.dummy = dummy;
  p.num_cs = num_components * num_slabs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kPhiloxRaw) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned int>(sms * 8));      // grid-stride
    return static_cast<int>(
        out_bf16 ? launch(raw_kernel<__nv_bfloat16>, p, grid, kThreads, 0, s)
                 : launch(raw_kernel<float>, p, grid, kThreads, 0, s));
  }
  if ((ks != 32 && ks != 64 && ks != 128) || ch < 8 || ch % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  set_walk(p.tile, ks, ch);
  return static_cast<int>(bf16_taps ? launch_filter<true>(mode, p, s, slots_out)
                                    : launch_filter<false>(mode, p, s, slots_out));
}

}  // extern "C"
