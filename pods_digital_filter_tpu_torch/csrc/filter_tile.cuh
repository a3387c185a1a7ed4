// Device code shared by K1 (fused_filter.cu), K4 (fused_temporal.cu) and K3
// (noise_probe.cu): the element-keyed Philox4x32-10 stream, 8-value stores,
// and the three phases of filtering -- fill the noise rows with their halo,
// the z-pass, the y-pass.  K1 and K4 run the very same functions, so a K4
// slab equals K1's bit for bit before K4's temporal FIR, and K1's
// slab-pipelined mode equals K1's default mode bit for bit.
//
// A block owns a strip of `ks` output columns (k).  Shared memory holds x
// (noise rows, each ks + 2nfz values wide and `xp` apart), t (the z-pass of
// those rows, ks values wide and `tp` apart) and, for any tap count, the
// taps.  Every output is one fmaf chain over its taps in ascending order,
// starting from 0, in both passes, so the result does not depend on how the
// work is cut.  With bf16 taps (BF16 = true) the passes compute what the
// Pallas body computes with bfloat16 tap matrices
// (pods_digital_filter_tpu/ops/pallas_filter.py:87-90): the noise value is
// rounded to bf16 (round to nearest even) before the z-pass, the taps hold
// bf16 values (the wrapper rounds them), every product is exact in f32 and
// summed in f32, and t is rounded to bf16 before the y-pass; the output stays
// f32.
//
// Register blocking: a z-pass item is 8 neighbouring t values of one row,
// made from 8 + 2nfz noise values loaded once as float4 (a lane map that puts
// four items of two rows in each 8-lane phase, with an odd float4 pitch, so
// the 16-byte loads meet no bank conflict); a y-pass item is CW columns x R
// rows of output, made from R + 2nfy t rows loaded once.  With the half-widths
// NY, NZ known at compile time the tap loops unroll and the taps live in
// registers, so the passes issue (8 + 2nfz)/4 and R + 2nfy shared loads for
// 8 (2nfz+1) and CW R (2nfy+1) FMAs: 6 loads for 136 FMAs and 24 for 544 at
// nf = 8 (the first version: two loads per FMA).  For any other half-width
// (NY or NZ = 0) the taps sit in shared memory, padded with zeros to a
// multiple of 4, and the loops run over them four at a time: one broadcast
// tap load and 1 (z) or 4 (y) operand loads per 32 or 4R*CW FMAs; the padded
// taps multiply finite values, so they add zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace podfs {

constexpr int kThreads = 256;   // K1's raw mode and K3
constexpr int kMaxGrid = 65535;

// Noise sources of a filtering block.
enum Source : int { kSrcPhilox = 0, kSrcNoiseIn = 1, kSrcIota = 2 };

struct Words {
  uint32_t w[4];
};

// Philox4x32-10's ten pairs of round keys (key + r * Weyl constants): built
// once on the host for K1 and K4, whose kernels read them from their
// parameters, so a draw spends no instructions on the key schedule
struct RoundKeys {
  uint32_t k[20];
};

__host__ __device__ inline RoundKeys round_keys(uint32_t k0, uint32_t k1) {
  RoundKeys rk;
  for (int r = 0; r < 10; ++r) {
    rk.k[2 * r] = k0 + static_cast<uint32_t>(r) * 0x9E3779B9u;
    rk.k[2 * r + 1] = k1 + static_cast<uint32_t>(r) * 0xBB67AE85u;
  }
  return rk;
}

struct TileParams {
  const float* noise;  // (C*S, jn, kn) float32, kSrcNoiseIn only
  const float* by;     // (2*nfy + 1,) y taps
  const float* bz;     // (2*nfz + 1,) z taps
  int nfy, nfz;
  int jma, kma, jn, kn;
  int num_slabs;       // slabs per component
  uint32_t t0;         // global index of slab 0
  RoundKeys keys;      // of (seed lo, seed hi)
  float scale;         // float32(2*sqrt(3)*2^-32): Philox word -> uniform
  float iota_scale;    // float32(2*sqrt(3)/65536): kSrcIota
  int ks, ks_log2;     // strip width (32, 64 or 128) and its log2
  int ch;              // output rows per step, a multiple of 8
  int xp, tp, tr;      // x pitch, t pitch (floats), t rows
};

__device__ __forceinline__ Words philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               const RoundKeys& rk) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    // one 32 x 32 -> 64-bit multiply a product (both halves at once)
    const uint64_t p0 = static_cast<uint64_t>(0xD2511F53u) * c0;
    const uint64_t p1 = static_cast<uint64_t>(0xCD9E8D57u) * c2;
    c0 = static_cast<uint32_t>(p1 >> 32) ^ c1 ^ rk.k[2 * r];
    c1 = static_cast<uint32_t>(p1);
    c2 = static_cast<uint32_t>(p0 >> 32) ^ c3 ^ rk.k[2 * r + 1];
    c3 = static_cast<uint32_t>(p0);
  }
  return Words{{c0, c1, c2, c3}};
}

__device__ __forceinline__ Words philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
  return philox4x32_10(c0, c1, c2, c3, round_keys(k0, k1));
}

// int32 bitcast, exact-rounding conversion, one f32 multiply (never contracted)
__device__ __forceinline__ float word_to_uniform(uint32_t w, float scale) {
  return __fmul_rn(__int2float_rn(static_cast<int32_t>(w)), scale);
}

// v rounded to the nearest bf16 value, ties to even (finite v), on the
// integer units: the same value as __float2bfloat16_rn, off the conversion
// pipe that the draw's int -> float conversions already load
__device__ __forceinline__ float round_bf16(float v) {
  uint32_t b = __float_as_uint(v);
  b += 0x7FFFu + ((b >> 16) & 1u);
  return __uint_as_float(b & 0xFFFF0000u);
}

template <bool BF16>
__device__ __forceinline__ float tap_round(float v) {
  if constexpr (BF16) return round_bf16(v);
  return v;
}

// values [0, n) of v at element i of out: 16-byte stores when the 8 values
// are whole and start on a 16-byte boundary, else one store each
template <typename OutT>
__device__ __forceinline__ void put8(void* out, size_t i, const float (&v)[8], int n);
template <>
__device__ __forceinline__ void put8<float>(void* out, size_t i, const float (&v)[8], int n) {
  float* o = static_cast<float*>(out) + i;
  if (n == 8 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n) o[e] = v[e];
  }
}
template <>
__device__ __forceinline__ void put8<__nv_bfloat16>(void* out, size_t i, const float (&v)[8], int n) {
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + i;
  if (n == 8 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    uint32_t u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      u[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n) o[e] = __float2bfloat16_rn(v[e]);
  }
}

// ---- geometry (host and device) ------------------------------------------

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// x row pitch: room for the zero-tap reads of the any-width z-pass (ks +
// 2nfz + 4 values), an odd number of float4 so that two neighbouring rows
// fall on different banks
__host__ __device__ inline int walk_xp(int ks, int nfz) {
  const int xp = round4(ks + 2 * nfz + 4);
  return ((xp >> 2) & 1) ? xp : xp + 4;
}

// t: ch + 2nfy rows the y-pass reads, plus 4 zero rows for its four-tap steps
__host__ __device__ inline int walk_tr(int ch, int nfy) { return ch + 2 * nfy + 4; }

// floats of shared memory: `nbuf` x buffers of ch + 2nfy rows, t, the taps
__host__ __device__ inline int walk_smem_floats(int nfy, int nfz, int ks, int ch,
                                                int nbuf) {
  return nbuf * (ch + 2 * nfy) * walk_xp(ks, nfz) + walk_tr(ch, nfy) * (ks + 4) +
         round4(2 * nfy + 1) + round4(2 * nfz + 1);
}

inline void set_walk(TileParams& p, int ks, int ch) {
  p.ks = ks;
  p.ks_log2 = ks == 128 ? 7 : ks == 64 ? 6 : 5;
  p.ch = ch;
  p.xp = walk_xp(ks, p.nfz);
  p.tp = ks + 4;
  p.tr = walk_tr(ch, p.nfy);
}

// ---- taps ------------------------------------------------------------------

// The taps of a pass: in registers when the half-width N is known at compile
// time, else in shared memory (padded with zeros to a multiple of 4).
template <int N>
struct Taps {
  float b[2 * N + 1];
  __device__ __forceinline__ void load(const float* g, float*, int) {
#pragma unroll
    for (int d = 0; d < 2 * N + 1; ++d) b[d] = __ldg(g + d);
  }
};
template <>
struct Taps<0> {
  const float4* s;    // round4(2nf+1) / 4 float4 in shared memory
  int n4;
  __device__ __forceinline__ void load(const float* g, float* smem, int nf) {
    const int taps = 2 * nf + 1;
    n4 = round4(taps) >> 2;
    for (int i = threadIdx.x; i < 4 * n4; i += blockDim.x)
      smem[i] = i < taps ? g[i] : 0.f;
    s = reinterpret_cast<const float4*>(smem);
  }
};

// ---- the phases ----------------------------------------------------------

// the 4 noise values at (row j, columns k .. k+3) of `cs`, rounded for BF16
template <int SRC, bool BF16>
__device__ __forceinline__ float4 noise4(const TileParams& p, int cs, int j, int k) {
  float v[4];
  if constexpr (SRC == kSrcPhilox) {
    const Words w = philox4x32_10(
        static_cast<uint32_t>(k >> 2), static_cast<uint32_t>(j),
        p.t0 + static_cast<uint32_t>(cs % p.num_slabs),
        static_cast<uint32_t>(cs / p.num_slabs), p.keys);
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = word_to_uniform(w.w[q], p.scale);
  } else if constexpr (SRC == kSrcIota) {
    // x[j, k] = float(int32(k * (cs + 1))) * 2*sqrt(3)/65536, cs the launch
    // index (exp_two_kernel_pipeline.py:212-213)
    const uint32_t mul = static_cast<uint32_t>(cs) + 1u;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = __fmul_rn(__int2float_rn(static_cast<int32_t>(
                           static_cast<uint32_t>(k + q) * mul)), p.iota_scale);
  } else {
    const float* src = p.noise + (static_cast<size_t>(cs) * p.jn + j) * p.kn;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = (j < p.jn && k + q < p.kn) ? src[k + q] : 0.f;
  }
  return make_float4(tap_round<BF16>(v[0]), tap_round<BF16>(v[1]),
                     tap_round<BF16>(v[2]), tap_round<BF16>(v[3]));
}

// x rows [0, rows) <- noise rows [r0, r0 + rows) of `cs`, columns
// [k0, k0 + width); k0 and width are multiples of 4
template <int SRC, bool BF16>
__device__ __forceinline__ void fill_rows(const TileParams& p, int cs, int r0,
                                          int rows, int k0, int width, float* x) {
  const int groups = width >> 2;
  const int n = rows * groups;
  const int step = blockDim.x;
  const int dr = step / groups, dg = step - dr * groups;
  int r = threadIdx.x / groups, g = threadIdx.x - r * groups;
  for (int i = threadIdx.x; i < n; i += step) {
    *reinterpret_cast<float4*>(x + r * p.xp + 4 * g) =
        noise4<SRC, BF16>(p, cs, r0 + r, k0 + 4 * g);
    g += dg;
    r += dr;
    if (g >= groups) {
      g -= groups;
      ++r;
    }
  }
}

// noise columns a fill must draw for the z-pass of half-width NZ (0: any)
template <int NZ>
__device__ __forceinline__ int fill_width(const TileParams& p) {
  if constexpr (NZ > 0) return round4(p.ks + 2 * NZ);
  return p.xp;     // the zero-tap reads run up to ks + 2nfz + 3
}

// t rows [0, rows) <- the z-pass of x rows [0, rows) (rows even):
// t[r][c] = sum_d bz[d] x[r][c + d], c < ks
template <bool BF16, int NZ>
__device__ __forceinline__ void z_pass(const TileParams& p, const float* x,
                                       float* t, int rows, const Taps<NZ>& bz) {
  const int gq_log2 = p.ks_log2 - 5;       // 8-column groups / 4
  const int n = rows << (p.ks_log2 - 3);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    // an 8-lane phase: groups 4gh .. 4gh+3 of rows 2rr and 2rr + 1
    const int rest = i >> 3;
    const int g = (i & 3) + 4 * (rest & ((1 << gq_log2) - 1));
    const int r = 2 * (rest >> gq_log2) + ((i >> 2) & 1);
    const float4* x4 = reinterpret_cast<const float4*>(x + r * p.xp + 8 * g);
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    if constexpr (NZ > 0) {
      constexpr int kLoads = (8 + 2 * NZ + 3) / 4;
      float w[4 * kLoads];
#pragma unroll
      for (int m = 0; m < kLoads; ++m) {
        const float4 v = x4[m];
        w[4 * m] = v.x;
        w[4 * m + 1] = v.y;
        w[4 * m + 2] = v.z;
        w[4 * m + 3] = v.w;
      }
#pragma unroll
      for (int d = 0; d < 2 * NZ + 1; ++d)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[c] = fmaf(bz.b[d], w[c + d], acc[c]);
    } else {
      float w[12];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float4 v = x4[m];
        w[4 * m] = v.x;
        w[4 * m + 1] = v.y;
        w[4 * m + 2] = v.z;
        w[4 * m + 3] = v.w;
      }
      for (int d4 = 0; d4 < bz.n4; ++d4) {
        const float4 v = x4[d4 + 2];
        w[8] = v.x;
        w[9] = v.y;
        w[10] = v.z;
        w[11] = v.w;
        const float4 b4 = bz.s[d4];
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int dd = 0; dd < 4; ++dd)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[c] = fmaf(b[dd], w[c + dd], acc[c]);
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] = w[e + 4];
      }
    }
    float4* t4 = reinterpret_cast<float4*>(t + r * p.tp + 8 * g);
    t4[0] = make_float4(tap_round<BF16>(acc[0]), tap_round<BF16>(acc[1]),
                        tap_round<BF16>(acc[2]), tap_round<BF16>(acc[3]));
    t4[1] = make_float4(tap_round<BF16>(acc[4]), tap_round<BF16>(acc[5]),
                        tap_round<BF16>(acc[6]), tap_round<BF16>(acc[7]));
  }
}

template <int CW>
__device__ __forceinline__ void load_cols(const float* src, float (&v)[CW]) {
  if constexpr (CW == 4) {
    const float4 u = *reinterpret_cast<const float4*>(src);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  } else {
#pragma unroll
    for (int e = 0; e < CW; ++e) v[e] = src[e];
  }
}

// The y-pass of one step: out[o][c] = sum_d by[d] t[o + d][c] for the ch
// output rows of the step, in items of CW columns x R rows; sink(row, col,
// acc) takes each item (row, col: its first output row and column in the
// step).  t rows [0, ch + 2nfy) hold the step's z-pass.
template <int NY, int CW, int R, typename Sink>
__device__ __forceinline__ void y_pass(const TileParams& p, const float* t,
                                       const Taps<NY>& by, Sink&& sink) {
  constexpr int cw_log2 = CW == 4 ? 2 : CW == 2 ? 1 : 0;
  const int cols_log2 = p.ks_log2 - cw_log2;
  const int n = (p.ch / R) << cols_log2;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int col = CW * (i & ((1 << cols_log2) - 1));
    const int row = R * (i >> cols_log2);
    const float* tc = t + row * p.tp + col;
    float acc[R][CW];
#pragma unroll
    for (int o = 0; o < R; ++o)
#pragma unroll
      for (int e = 0; e < CW; ++e) acc[o][e] = 0.f;
    if constexpr (NY > 0) {
#pragma unroll
      for (int rho = 0; rho < R + 2 * NY; ++rho) {
        float v[CW];
        load_cols<CW>(tc + rho * p.tp, v);
#pragma unroll
        for (int o = 0; o < R; ++o) {
          const int d = rho - o;
          if (d >= 0 && d <= 2 * NY)
#pragma unroll
            for (int e = 0; e < CW; ++e) acc[o][e] = fmaf(by.b[d], v[e], acc[o][e]);
        }
      }
    } else {
      float w[R + 4][CW];
#pragma unroll
      for (int o = 0; o < R; ++o) load_cols<CW>(tc + o * p.tp, w[o]);
      for (int d4 = 0; d4 < by.n4; ++d4) {
#pragma unroll
        for (int o = 0; o < 4; ++o) load_cols<CW>(tc + (4 * d4 + R + o) * p.tp, w[R + o]);
        const float4 b4 = by.s[d4];
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int dd = 0; dd < 4; ++dd)
#pragma unroll
          for (int o = 0; o < R; ++o)
#pragma unroll
            for (int e = 0; e < CW; ++e) acc[o][e] = fmaf(b[dd], w[o + dd][e], acc[o][e]);
#pragma unroll
        for (int o = 0; o < R; ++o)
#pragma unroll
          for (int e = 0; e < CW; ++e) w[o][e] = w[o + 4][e];
      }
    }
    sink(row, col, acc);
  }
}

// t rows [0, 2nfy) <- t rows [ch, ch + 2nfy): the last step's rows the next
// step's y-pass reads again; in passes of ch rows, each after a barrier
// (passes overlap when ch < 2nfy)
__device__ __forceinline__ void shift_t(const TileParams& p, float* t) {
  const int halo = 2 * p.nfy;
  const int w4_log2 = p.ks_log2 - 2;
  float4* t4 = reinterpret_cast<float4*>(t);
  const int tp4 = p.tp >> 2;
  for (int r0 = 0; r0 < halo; r0 += p.ch) {
    if (r0 > 0) __syncthreads();
    const int rows = min(p.ch, halo - r0);
    for (int i = threadIdx.x; i < rows << w4_log2; i += blockDim.x) {
      const int r = r0 + (i >> w4_log2), c = i & ((1 << w4_log2) - 1);
      t4[r * tp4 + c] = t4[(r + p.ch) * tp4 + c];
    }
  }
}

// rows [from, tr) of t to 0: the rows past the step's that the any-width
// y-pass multiplies by zero taps
__device__ __forceinline__ void zero_t_tail(const TileParams& p, float* t, int from) {
  for (int i = threadIdx.x; i < (p.tr - from) * p.tp; i += blockDim.x)
    t[from * p.tp + i] = 0.f;
}

}  // namespace podfs
