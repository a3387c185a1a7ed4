// Device code shared by K1 (fused_filter.cu) and K4 (fused_temporal.cu):
// the element-keyed Philox4x32-10 stream and the three phases of one
// filtering tile -- fill the noise tile with its halo, the z-pass, the y-pass.
// K1 and K4 run the very same functions, so a K4 slab equals K1's bit for bit
// before K4's temporal FIR, and K1's slab-pipelined mode equals K1's default
// mode bit for bit.
//
// A tile is kTileJ x kTileK outputs of one (component, slab) `cs`.  Shared
// memory holds x (hj x wk noise values, hj = kTileJ + 2nfy, wk = kTileK +
// 2nfz), t (hj x kTileK after the z-pass) and the taps.  With bf16 taps
// (BF16 = true) the tile computes what the Pallas body computes with
// bfloat16 tap matrices (pods_digital_filter_tpu/ops/pallas_filter.py:87-90):
// the noise value is rounded to bf16 (round to nearest even) before the
// z-pass, the taps hold bf16 values (the wrapper rounds them), every product
// is exact in f32 and summed in f32, and t is rounded to bf16 before the
// y-pass; the output stays f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace podfs {

constexpr int kTileJ = 32;    // output rows (j) per block
constexpr int kTileK = 64;    // output columns (k) per block; a multiple of 4
constexpr int kThreads = 256;
constexpr int kMaxGrid = 65535;

// Noise sources of a filtering tile.
enum Source : int { kSrcPhilox = 0, kSrcNoiseIn = 1, kSrcIota = 2 };

struct TileParams {
  const float* noise;  // (C*S, jn, kn) float32, kSrcNoiseIn only
  int nfy, nfz;
  int jma, kma, jn, kn;
  int num_slabs;       // slabs per component
  uint32_t t0;         // global index of slab 0
  uint32_t key0, key1;
  float scale;         // float32(2*sqrt(3)*2^-32): Philox word -> uniform
  float iota_scale;    // float32(2*sqrt(3)/65536): kSrcIota
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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__device__ __forceinline__ float tap_round(float v) {
  if constexpr (BF16) return round_bf16(v);
  return v;
}

__host__ __device__ inline int tile_smem_floats(int nfy, int nfz) {
  const int hj = kTileJ + 2 * nfy;
  const int wk = kTileK + 2 * nfz;
  return hj * wk + hj * kTileK;
}

// Fills x (hj x wk) with the noise of the tile at (j0, k0) of `cs`.
template <int SRC, bool BF16>
__device__ __forceinline__ void fill_tile(const TileParams& p, int cs, int j0,
                                          int k0, float* x) {
  const int hj = kTileJ + 2 * p.nfy;
  const int wk = kTileK + 2 * p.nfz;
  const int tid = threadIdx.x;
  if constexpr (SRC == kSrcPhilox) {
    const uint32_t comp = static_cast<uint32_t>(cs / p.num_slabs);
    const uint32_t slab = p.t0 + static_cast<uint32_t>(cs % p.num_slabs);
    const int groups = (wk + 3) / 4;  // k0 is a multiple of 4
    for (int i = tid; i < hj * groups; i += kThreads) {
      const int r = i / groups;
      const int g = i - r * groups;
      const Words w = philox4x32_10(static_cast<uint32_t>((k0 >> 2) + g),
                                    static_cast<uint32_t>(j0 + r), slab, comp,
                                    p.key0, p.key1);
      float* row = x + r * wk + 4 * g;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (4 * g + q < wk)
          row[q] = tap_round<BF16>(word_to_uniform(w.w[q], p.scale));
    }
  } else if constexpr (SRC == kSrcIota) {
    // x[j, k] = float(int32(k * (cs + 1))) * 2*sqrt(3)/65536 over the halo'd
    // field, cs the launch index (exp_two_kernel_pipeline.py:212-213)
    const uint32_t mul = static_cast<uint32_t>(cs) + 1u;
    for (int i = tid; i < hj * wk; i += kThreads) {
      const int c = i % wk;
      const int32_t v =
          static_cast<int32_t>(static_cast<uint32_t>(k0 + c) * mul);
      x[i] = tap_round<BF16>(__fmul_rn(__int2float_rn(v), p.iota_scale));
    }
  } else {
    const float* src = p.noise + static_cast<size_t>(cs) * p.jn * p.kn;
    for (int i = tid; i < hj * wk; i += kThreads) {
      const int r = i / wk;
      const int c = i - r * wk;
      const int j = j0 + r;
      const int k = k0 + c;
      x[i] = (j < p.jn && k < p.kn)
                 ? tap_round<BF16>(src[static_cast<size_t>(j) * p.kn + k])
                 : 0.f;
    }
  }
}

// t[r, c] = sum_d bz[d] x[r, c + d] for every row the y-pass needs
template <bool BF16>
__device__ __forceinline__ void z_pass(int nfy, int nfz, const float* x,
                                       const float* sbz, float* t) {
  const int hj = kTileJ + 2 * nfy;
  const int wk = kTileK + 2 * nfz;
  const int tz = 2 * nfz + 1;
  for (int i = threadIdx.x; i < hj * kTileK; i += kThreads) {
    const int r = i / kTileK;
    const int c = i % kTileK;
    const float* xr = x + r * wk + c;
    float acc = 0.f;
    for (int d = 0; d < tz; ++d) acc = fmaf(sbz[d], xr[d], acc);
    t[i] = tap_round<BF16>(acc);
  }
}

// out[r, c] = sum_d by[d] t[r + d, c]
__device__ __forceinline__ float y_at(const float* t, const float* sby,
                                      int nfy, int r, int c) {
  const float* tc = t + r * kTileK + c;
  float acc = 0.f;
  for (int d = 0; d < 2 * nfy + 1; ++d) acc = fmaf(sby[d], tc[d * kTileK], acc);
  return acc;
}

}  // namespace podfs
