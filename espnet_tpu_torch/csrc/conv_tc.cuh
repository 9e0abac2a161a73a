// The tensor-core pieces that the bf16 conv kernels share (conv_glu.cu: the
// split route's head and tail; conv_module.cu: the whole module): weight
// slabs of SLAB_K x SLAB_N bf16 that stream through one RING-stage cp.async
// ring in a fixed job order, and the mma.sync products of a block's rows
// (bf16 tiles in shared memory, rows padded by 16 bytes) on one slab, for
// 8 warps in 2 rows x 4 columns. `head_slab` pairs the a and gate halves of
// the pre-GLU product: a slab holds HEAD_C columns of each, and a warp
// accumulates the a and gate columns it will combine on its fragments.
#pragma once

#include "ffn_kernels.cuh"

namespace espnet_port {
namespace {

constexpr int SLAB_K = 32;          // reduction rows of a weight slab
constexpr int SLAB_N = 128;         // output columns of a weight slab
constexpr int LDKN = SLAB_N + 8;    // bf16 stride: [k][n] slabs, the dh tile
constexpr int LDNK = SLAB_K + 8;    // bf16 stride: [n][k] slabs
constexpr int SLAB_ELEMS =
    SLAB_K * LDKN > SLAB_N * LDNK ? SLAB_K * LDKN : SLAB_N * LDNK;
constexpr int RING = 3;    // stages of the weight ring
constexpr int HEAD_C = 64;  // columns of the a (and of the g) half a chunk

// Weight slabs through the ring, 16 bytes a cp.async, two a thread.
// W1 (DP x 2DP): rows k0.., columns c0..c0+63 of the a half (slab columns
// 0..63) and of the g half (64..127), as [k][n].
template <int DP>
__device__ __forceinline__ void load_w1_head(bf16* slab,
                                             const bf16* __restrict__ w1,
                                             int k0, int c0) {
  for (int e = threadIdx.x; e < SLAB_K * 16; e += THREADS) {
    const int r = e >> 4, c = e & 15;
    const int col = (c < 8 ? c0 : DP + c0 - HEAD_C) + c * 8;
    cp_async16(slab + r * LDKN + c * 8,
               w1 + static_cast<size_t>(k0 + r) * (2 * DP) + col, 16);
  }
}

// W (row stride ld): rows k0..k0+31, columns n0..n0+127, as [k][n].
__device__ __forceinline__ void load_kn(bf16* slab, const bf16* __restrict__ w,
                                        int ld, int k0, int n0) {
  for (int e = threadIdx.x; e < SLAB_K * 16; e += THREADS) {
    const int r = e >> 4, c = e & 15;
    cp_async16(slab + r * LDKN + c * 8,
               w + static_cast<size_t>(k0 + r) * ld + n0 + c * 8, 16);
  }
}

// W (row stride ld): rows n0..n0+127, columns k0..k0+31, as [n][k].
__device__ __forceinline__ void load_nk(bf16* slab, const bf16* __restrict__ w,
                                        int ld, int n0, int k0) {
  for (int e = threadIdx.x; e < SLAB_N * 4; e += THREADS) {
    const int r = e >> 2, c = e & 3;
    cp_async16(slab + r * LDNK + c * 8,
               w + static_cast<size_t>(n0 + r) * ld + k0 + c * 8, 16);
  }
}

// One slab of the head h = LN1(x) W1 over the m-tiles wm, wm + 2, ... below
// n_mt of xn_s (bf16, stride LDA): acc[i][0..1] the a columns wn*16.. of the
// chunk, acc[i][2..3] the g columns.
template <int MT, int LDA>
__device__ __forceinline__ void head_slab(float (&acc)[MT][4][4],
                                          const bf16* xn_s, const bf16* slab,
                                          int k0, int n_mt, int wm, int wn) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < SLAB_K / 16; ++kk) {
    unsigned ba[4], bg[4];
    const bf16* pb = slab + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                LDKN + wn * 16 + (lane >> 4) * 8;
    ldmatrix_x4_trans(ba, pb);
    ldmatrix_x4_trans(bg, pb + HEAD_C);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mt = wm + 2 * i;
      if (mt >= n_mt) continue;  // uniform across the warp
      unsigned a[4];
      ldmatrix_x4(a, xn_s + (mt * 16 + (lane & 15)) * LDA + k0 + kk * 16 +
                         (lane >> 4) * 8);
      mma_bf16(acc[i][0], a, ba[0], ba[1]);
      mma_bf16(acc[i][1], a, ba[2], ba[3]);
      mma_bf16(acc[i][2], a, bg[0], bg[1]);
      mma_bf16(acc[i][3], a, bg[2], bg[3]);
    }
  }
}

// One slab of z += A W over the warp's m-tiles wm*MT.. of a_s (bf16, stride
// LDA) and its 32 columns wn*32.. of the chunk; the slab is [k][n] (KN) or
// [n][k].
template <int MT, int LDA, bool KN>
__device__ __forceinline__ void tail_slab(float (&z)[MT][4][4],
                                          const bf16* a_s, const bf16* slab,
                                          int k0, int wm, int wn) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < SLAB_K / 16; ++kk) {
    unsigned bw[2][4];
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      if constexpr (KN)
        ldmatrix_x4_trans(bw[np], slab + (kk * 16 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8) * LDKN +
                                      wn * 32 + np * 16 + (lane >> 4) * 8);
      else
        ldmatrix_x4(bw[np], slab + (wn * 32 + np * 16 + (lane & 7) +
                                    (lane >> 4) * 8) * LDNK + kk * 16 +
                                ((lane >> 3) & 1) * 8);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      unsigned a[4];
      ldmatrix_x4(a, a_s + ((wm * MT + i) * 16 + (lane & 15)) * LDA + k0 +
                         kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        mma_bf16(z[i][2 * np], a, bw[np][0], bw[np][1]);
        mma_bf16(z[i][2 * np + 1], a, bw[np][2], bw[np][3]);
      }
    }
  }
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][4][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
}

// LayerNorm (eps 1e-6, the arithmetic of `ln_row`) of one row held by one
// warp, value d = lane + 32 e in v[e], zeros past n: v becomes the
// normalised row (with SWISH its swish), zeros past n.
template <int ZJ, bool SWISH>
__device__ __forceinline__ void ln_vals(float (&v)[ZJ], int n,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias,
                                        float& mean_out, float& inv_out) {
  const int lane = threadIdx.x & 31;
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < ZJ; ++e) sum += v[e];
  const float mean = warp_sum(sum) / n;
  float sq = 0.f;
#pragma unroll
  for (int e = 0; e < ZJ; ++e) {
    v[e] = lane + 32 * e < n ? v[e] - mean : 0.f;
    sq += v[e] * v[e];
  }
  const float inv = rsqrtf(warp_sum(sq) / n + LN_EPS);
#pragma unroll
  for (int e = 0; e < ZJ; ++e) {
    const int d = lane + 32 * e;
    float o = 0.f;
    if (d < n) {
      o = v[e] * inv * scale[d] + bias[d];
      if (SWISH) o = o * sigmoidf(o);
    }
    v[e] = o;
  }
  mean_out = mean;
  inv_out = inv;
}

}  // namespace
}  // namespace espnet_port
