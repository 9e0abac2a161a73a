// Position-wise FFN kernels, forward and backward, shared by two entry
// families through the template flag LN:
//
//   LN = true  (prenorm_ffn.cu): y = x + s * drop1(drop0(act(LN(x) W1 + b1))
//              W2 + b2), LN eps 1e-6 -- the Pallas `_pffn_fwd_kernel` and
//              `_pffn_bwd_kernel` behind `fused_prenorm_ffn`;
//   LN = false (ffn.cu):         y = drop0(act(x W1 + b1)) W2 + b2 -- the
//              Pallas `_ffn_fwd_kernel` and `_ffn_bwd_kernel` behind
//              `fused_ffn` (no LayerNorm, no residual, one mask);
//
// both in espnet_tpu/ops/pallas_ffn.py, act swish|relu.
//
// Dropout is the Pallas kernels' counter hash (`_keep_mask`), bit for bit:
// element (row g, column c) of a tensor of width C belongs to the logical
// 256-row tile pid = g / 256, its counter is (g % 256) * C + c, the stream
// id is fmix32(seed) ^ (pid * 0x9E3779B9) (stream 0: seed0, width F, after
// the activation; stream 1, LN only: seed1, width D, after W2), and the
// element is kept when the top byte of fmix32(counter + stream *
// 0x9E3779B9) is >= q; kept values are scaled by 256 / (256 - q). The mask
// does not depend on the CUDA block size, and the backward regenerates it
// instead of storing it.
//
// The operands round as in the Pallas kernels: LN(x), act(.), dz and dh are
// rounded to x's dtype before each product, products accumulate in float32,
// and every output is rounded once at the end.
//
// What bounds it on an H100: the forward does 4·M·D·F flops and the
// backward 10·M·D·F (the TPU kernels' count: the recomputed first product,
// da, dx, dW1 and dW2) against (2·M·D + 2·D·F) elements, some 600 flops
// per byte at M=30k, D=256, F=2048: bound by arithmetic. This first version
// does the products on the CUDA cores in float32 (no tensor cores yet), far
// below the bf16 bound, and the backward recomputes two of its products
// once more (14·M·D·F in all).
//
// What the design does about it:
// * The (M, F) hidden activation never reaches device memory, forward or
//   backward. The forward block owns BM rows, normalises them (LN) or
//   copies them into shared memory once and walks F in chunks whose
//   activations go through shared memory straight into the float32 output
//   accumulator in registers.
// * The backward needs dx, which sums over F for each row, and dW1, dW2,
//   which sum over all rows for each column of F; no block sees both. So it
//   runs two kernels. `bwd_dx` owns BM rows and walks F (as the forward),
//   recomputing h and da chunk by chunk to accumulate dx (LN: dxn) in
//   registers; with LN it writes dx, the rounded LN(x) and dz (M x D each,
//   not M x F), without LN only dx (the second kernel reads x and dy), and
//   per-block partial sums of dLN scale, dLN bias and db2 (without LN, of
//   db2 alone). `bwd_w` owns a BF2-wide column
//   chunk of F and a group of rows; it keeps its W1 and W2 chunks in shared
//   memory, recomputes h, a and dh for its rows from the stored LN(x) and
//   dz (or x and dy), and accumulates the chunk's dW1, dW2 and db1 in
//   registers. The few groups' partial sums are added afterwards
//   (deterministic, no atomics).
// * Rows past M are read as zeros (finite) and never stored or summed.
// * D is a template argument, a multiple of 128 up to 512 (the entry points
//   instantiate 128, 256, 384 and 512): at D = 640 the forward's and the
//   dx kernel's shared memory would pass the 227 KB a block may have.
#pragma once

#include "common.cuh"

namespace espnet_port {
namespace {

constexpr int BM = 32;        // rows per block (forward, bwd_dx)
constexpr int BF = 128;       // hidden units per chunk (forward)
constexpr int BFB = 64;       // hidden units per chunk (bwd_dx)
constexpr int KS = 32;        // depth of one weight slab
constexpr int THREADS = 256;  // 8 warps
constexpr int BF2 = 32;       // hidden units per bwd_w block
constexpr float LN_EPS = 1e-6f;
constexpr int DROP_TILE = 256;  // the logical row tile of the hash

enum Act : int { kSwish = 0, kRelu = 1 };

__device__ __forceinline__ unsigned fmix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Stream id of the logical tile holding row g.
__device__ __forceinline__ unsigned drop_stream(int seed, int g) {
  return fmix32(static_cast<unsigned>(seed)) ^
         (static_cast<unsigned>(g / DROP_TILE) * 0x9E3779B9u);
}

// Keep bit of (row g, column c) of a width-C tensor, given g's stream id.
__device__ __forceinline__ bool drop_keep(unsigned stream, int g, int C,
                                          int c, int q) {
  const unsigned counter = static_cast<unsigned>(g % DROP_TILE) *
                               static_cast<unsigned>(C) +
                           static_cast<unsigned>(c);
  return (fmix32(counter + stream * 0x9E3779B9u) >> 24) >=
         static_cast<unsigned>(q);
}

__device__ __forceinline__ float act_fwd(float h, int act) {
  return act == kRelu ? fmaxf(h, 0.f) : h / (1.f + expf(-h));
}

__device__ __forceinline__ float act_grad(float h, int act) {
  if (act == kRelu) return h > 0.f ? 1.f : 0.f;
  const float s = 1.f / (1.f + expf(-h));
  return s * (1.f + h * (1.f - s));
}

// LayerNorm of BM rows of x into xn_s (rounded to T); warp w does rows
// 4w..4w+3. Optionally keeps each row's mean and 1/std.
template <typename T, int D>
__device__ __forceinline__ void layer_norm_rows(
    const T* __restrict__ x, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, float* xn_s, float* mean_s,
    float* inv_s, int row0, int M) {
  constexpr int LDX = D + 1;
  constexpr int ZJ = D / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int r = warp * (BM / 8) + rr;
    const int gi = row0 + r;
    float vals[ZJ];
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      vals[e] = gi < M ? to_f32(x[static_cast<size_t>(gi) * D + lane + 32 * e])
                       : 0.f;
      sum += vals[e];
    }
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      vals[e] -= mean;
      sq += vals[e] * vals[e];
    }
    const float inv = rsqrtf(warp_sum(sq) / D + LN_EPS);
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      xn_s[r * LDX + d] =
          round_to<T>(vals[e] * inv * ln_scale[d] + ln_bias[d]);
    }
    if (mean_s != nullptr && lane == 0) {
      mean_s[r] = mean;
      inv_s[r] = inv;
    }
  }
}

// BM rows of x into xn_s as float32 (no LayerNorm), zeros past M.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ x,
                                          float* xn_s, int row0, int M) {
  for (int e = threadIdx.x; e < BM * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int gi = row0 + r;
    xn_s[r * (D + 1) + d] =
        gi < M ? to_f32(x[static_cast<size_t>(gi) * D + d]) : 0.f;
  }
}

template <int D>
constexpr size_t ffn_smem_bytes() {
  // normalised rows, a W1 slab, the hidden chunk, a W2 slab
  return sizeof(float) *
         (BM * (D + 1) + KS * BF + BM * (BF + 1) + KS * D);
}

template <typename T, int D, bool LN>
__global__ void __launch_bounds__(THREADS)
    ffn_fwd_kernel(const T* __restrict__ x,
                           const float* __restrict__ ln_scale,
                           const float* __restrict__ ln_bias,
                           const T* __restrict__ w1,
                           const float* __restrict__ b1,
                           const T* __restrict__ w2,
                           const float* __restrict__ b2, T* __restrict__ y,
                           int M, int F, float res_scale, int act, int q,
                           float dscale, int seed0, int seed1) {
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  constexpr int LDX = D + 1;
  constexpr int LDH = BF + 1;
  constexpr int ZJ = D / 32;

  extern __shared__ float smem[];
  float* xn_s = smem;
  float* w1_s = xn_s + BM * LDX;
  float* h_s = w1_s + KS * BF;
  float* w2_s = h_s + BM * LDH;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // 0..7
  const int row0 = blockIdx.x * BM;

  if (LN)
    layer_norm_rows<T, D>(x, ln_scale, ln_bias, xn_s, nullptr, nullptr, row0,
                          M);
  else
    load_rows<T, D>(x, xn_s, row0, M);

  // thread tile: rows warp+8ii; hidden columns lane+32jj / output lane+32jj
  unsigned st0[4], st1[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    st0[ii] = drop_stream(seed0, row0 + warp + 8 * ii);
    st1[ii] = drop_stream(seed1, row0 + warp + 8 * ii);
  }
  float z[4][ZJ];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < ZJ; ++jj) z[ii][jj] = 0.f;

  for (int c0 = 0; c0 < F; c0 += BF) {
    float hacc[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) hacc[ii][jj] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KS) {
      __syncthreads();  // earlier readers of w1_s (and xn_s writes) done
      for (int e = tid; e < KS * BF; e += THREADS) {
        const int kk = e / BF, f = e % BF;
        w1_s[e] = to_f32(w1[static_cast<size_t>(k0 + kk) * F + c0 + f]);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KS; ++kk) {
        float a[4], wv[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          a[ii] = xn_s[(warp + 8 * ii) * LDX + k0 + kk];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) wv[jj] = w1_s[kk * BF + lane + 32 * jj];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) hacc[ii][jj] += a[ii] * wv[jj];
      }
    }
    // The previous chunk's readers of h_s passed the barrier at the top of
    // the k0 loop above, so h_s may be written now.
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int f = lane + 32 * jj;
        float hv = act_fwd(hacc[ii][jj] + b1[c0 + f], act);
        if (q > 0)
          hv = drop_keep(st0[ii], row0 + warp + 8 * ii, F, c0 + f, q)
                   ? hv * dscale
                   : 0.f;
        h_s[(warp + 8 * ii) * LDH + f] = round_to<T>(hv);
      }

    for (int k0 = 0; k0 < BF; k0 += KS) {
      __syncthreads();  // h_s complete; earlier readers of w2_s done
      for (int e = tid; e < KS * D; e += THREADS) {
        const int kk = e / D, n = e % D;
        w2_s[e] = to_f32(w2[static_cast<size_t>(c0 + k0 + kk) * D + n]);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KS; ++kk) {
        float a[4], wv[ZJ];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          a[ii] = h_s[(warp + 8 * ii) * LDH + k0 + kk];
#pragma unroll
        for (int jj = 0; jj < ZJ; ++jj) wv[jj] = w2_s[kk * D + lane + 32 * jj];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < ZJ; ++jj) z[ii][jj] += a[ii] * wv[jj];
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int gi = row0 + warp + 8 * ii;
    if (gi >= M) continue;
#pragma unroll
    for (int jj = 0; jj < ZJ; ++jj) {
      const int n = lane + 32 * jj;
      const size_t g = static_cast<size_t>(gi) * D + n;
      float zz = z[ii][jj] + b2[n];
      if (!LN) {
        y[g] = from_f32<T>(zz);
        continue;
      }
      if (q > 0) zz = drop_keep(st1[ii], gi, D, n, q) ? zz * dscale : 0.f;
      y[g] = from_f32<T>(to_f32(x[g]) + res_scale * zz);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, kernel 1: dx, the rounded LN(x) and dz, and per-block partial
// sums of dLN scale, dLN bias and db2 (3 x D floats per block; without LN,
// db2's D floats alone).
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int dx_slab_floats() {
  return (2 * KS * (BFB + 1)) > (KS * (D + 1)) ? 2 * KS * (BFB + 1)
                                               : KS * (D + 1);
}

template <int D>
constexpr size_t dx_smem_bytes() {
  // LN(x) rows, dz rows, the weight slabs, the dh chunk, row mean and 1/std
  return sizeof(float) *
         (2 * BM * (D + 1) + dx_slab_floats<D>() + BM * (BFB + 1) + 2 * BM);
}

template <typename T, int D, bool LN>
__global__ void __launch_bounds__(THREADS)
    ffn_bwd_dx_kernel(const T* __restrict__ x,
                              const float* __restrict__ ln_scale,
                              const float* __restrict__ ln_bias,
                              const T* __restrict__ w1,
                              const float* __restrict__ b1,
                              const T* __restrict__ w2,
                              const T* __restrict__ gy, T* __restrict__ dx,
                              T* __restrict__ xn_out, T* __restrict__ dz_out,
                              float* __restrict__ partial, int M, int F,
                              float res_scale, int act, int q, float dscale,
                              int seed0, int seed1) {
  constexpr int LDX = D + 1;
  constexpr int LDB = BFB + 1;
  constexpr int LDW = D + 1;
  constexpr int ZJ = D / 32;
  constexpr int HJ = BFB / 32;

  extern __shared__ float smem[];
  float* xn_s = smem;
  float* dz_s = xn_s + BM * LDX;
  float* slab = dz_s + BM * LDX;  // w1 | w2^T slabs, later the w1^T slab
  float* w1a_s = slab;
  float* w2a_s = slab + KS * LDB;
  float* w1t_s = slab;
  float* dh_s = slab + dx_slab_floats<D>();
  float* mean_s = dh_s + BM * LDB;
  float* inv_s = mean_s + BM;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * BM;

  if (LN)
    layer_norm_rows<T, D>(x, ln_scale, ln_bias, xn_s, mean_s, inv_s, row0,
                          M);
  else
    load_rows<T, D>(x, xn_s, row0, M);
  // dz = drop1(s * g) (LN) or g, rounded; partial db2 over this warp's rows
  float db2p[ZJ];
#pragma unroll
  for (int e = 0; e < ZJ; ++e) db2p[e] = 0.f;
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int r = warp * (BM / 8) + rr;
    const int gi = row0 + r;
    const unsigned st = drop_stream(seed1, gi);
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      float v = 0.f;
      if (gi < M) {
        v = to_f32(gy[static_cast<size_t>(gi) * D + d]);
        if (LN) {
          v *= res_scale;
          if (q > 0) v = drop_keep(st, gi, D, d, q) ? v * dscale : 0.f;
        }
        db2p[e] += v;
      }
      const float vb = round_to<T>(v);
      dz_s[r * LDX + d] = vb;
      if (LN && gi < M) {
        const size_t g = static_cast<size_t>(gi) * D + d;
        dz_out[g] = from_f32<T>(vb);
        xn_out[g] = from_f32<T>(xn_s[r * LDX + d]);
      }
    }
  }

  unsigned st0[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) st0[ii] = drop_stream(seed0, row0 + warp + 8 * ii);
  float z[4][ZJ];  // dxn: rows warp+8ii, columns lane+32jj
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < ZJ; ++jj) z[ii][jj] = 0.f;

  for (int c0 = 0; c0 < F; c0 += BFB) {
    float hacc[4][HJ], dacc[4][HJ];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < HJ; ++jj) hacc[ii][jj] = dacc[ii][jj] = 0.f;
    for (int k0 = 0; k0 < D; k0 += KS) {
      __syncthreads();  // earlier readers of the slabs done
      for (int e = tid; e < KS * BFB; e += THREADS) {
        const int kk = e / BFB, f = e % BFB;  // W1[k0+kk][c0+f]
        w1a_s[kk * LDB + f] =
            to_f32(w1[static_cast<size_t>(k0 + kk) * F + c0 + f]);
      }
      for (int e = tid; e < KS * BFB; e += THREADS) {
        const int f = e / KS, kk = e % KS;  // W2[c0+f][k0+kk]
        w2a_s[kk * LDB + f] =
            to_f32(w2[static_cast<size_t>(c0 + f) * D + k0 + kk]);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KS; ++kk) {
        float a[4], b[4], wv[HJ], uv[HJ];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          a[ii] = xn_s[(warp + 8 * ii) * LDX + k0 + kk];
          b[ii] = dz_s[(warp + 8 * ii) * LDX + k0 + kk];
        }
#pragma unroll
        for (int jj = 0; jj < HJ; ++jj) {
          wv[jj] = w1a_s[kk * LDB + lane + 32 * jj];
          uv[jj] = w2a_s[kk * LDB + lane + 32 * jj];
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < HJ; ++jj) {
            hacc[ii][jj] += a[ii] * wv[jj];
            dacc[ii][jj] += b[ii] * uv[jj];
          }
      }
    }
    // dh = drop0(da) * act'(h), rounded
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < HJ; ++jj) {
        const int f = lane + 32 * jj;
        const float h = hacc[ii][jj] + b1[c0 + f];
        float da = dacc[ii][jj];
        if (q > 0)
          da = drop_keep(st0[ii], row0 + warp + 8 * ii, F, c0 + f, q)
                   ? da * dscale
                   : 0.f;
        dh_s[(warp + 8 * ii) * LDB + f] = round_to<T>(da * act_grad(h, act));
      }
    // dxn += dh W1[:, chunk]^T
    for (int k0 = 0; k0 < BFB; k0 += KS) {
      __syncthreads();  // dh_s complete; the slab's earlier readers done
      for (int e = tid; e < KS * D; e += THREADS) {
        const int n = e / KS, kk = e % KS;  // W1[n][c0+k0+kk]
        w1t_s[kk * LDW + n] =
            to_f32(w1[static_cast<size_t>(n) * F + c0 + k0 + kk]);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KS; ++kk) {
        float a[4], wv[ZJ];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          a[ii] = dh_s[(warp + 8 * ii) * LDB + k0 + kk];
#pragma unroll
        for (int jj = 0; jj < ZJ; ++jj) wv[jj] = w1t_s[kk * LDW + lane + 32 * jj];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < ZJ; ++jj) z[ii][jj] += a[ii] * wv[jj];
      }
    }
  }

  // LayerNorm backward per row (warp `warp` holds rows warp+8ii whole);
  // without LN, dx is the accumulated product itself
  float dls[ZJ], dlb[ZJ];
#pragma unroll
  for (int jj = 0; jj < ZJ; ++jj) dls[jj] = dlb[jj] = 0.f;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = warp + 8 * ii;
    const int gi = row0 + r;
    if (gi >= M) continue;  // uniform across the warp
    if (!LN) {
#pragma unroll
      for (int jj = 0; jj < ZJ; ++jj)
        dx[static_cast<size_t>(gi) * D + lane + 32 * jj] =
            from_f32<T>(z[ii][jj]);
      continue;
    }
    const float mean = mean_s[r], inv = inv_s[r];
    float xh[ZJ], dxh[ZJ];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int jj = 0; jj < ZJ; ++jj) {
      const int d = lane + 32 * jj;
      xh[jj] = (to_f32(x[static_cast<size_t>(gi) * D + d]) - mean) * inv;
      dxh[jj] = z[ii][jj] * ln_scale[d];
      s1 += dxh[jj];
      s2 += dxh[jj] * xh[jj];
      dls[jj] += z[ii][jj] * xh[jj];
      dlb[jj] += z[ii][jj];
    }
    const float m1 = warp_sum(s1) / D;
    const float m2 = warp_sum(s2) / D;
#pragma unroll
    for (int jj = 0; jj < ZJ; ++jj) {
      const int d = lane + 32 * jj;
      const size_t g = static_cast<size_t>(gi) * D + d;
      const float dxl = (dxh[jj] - m1 - xh[jj] * m2) * inv;
      dx[g] = from_f32<T>(to_f32(gy[g]) + dxl);
    }
  }
  // per-block partial sums over the 8 warps: reuse xn_s as (8, NP, D)
  constexpr int NP = LN ? 3 : 1;  // dLN scale, dLN bias, db2 | db2
  __syncthreads();
  float* red = xn_s;
#pragma unroll
  for (int jj = 0; jj < ZJ; ++jj) {
    const int d = lane + 32 * jj;
    if (LN) {
      red[(warp * NP + 0) * D + d] = dls[jj];
      red[(warp * NP + 1) * D + d] = dlb[jj];
    }
    red[(warp * NP + NP - 1) * D + d] = db2p[jj];
  }
  __syncthreads();
  for (int e = tid; e < NP * D; e += THREADS) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w * NP * D + e];
    partial[static_cast<size_t>(blockIdx.x) * NP * D + e] = s;
  }
}

// ---------------------------------------------------------------------------
// Backward, kernel 2: per (BF2-wide chunk of F, group of rows) the partial
// dW1[:, chunk], dW2[chunk, :] and db1[chunk].
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int w_rows() {
  return D <= 256 ? 32 : 16;  // rows per tile, so shared memory fits
}

template <int D>
constexpr size_t w_smem_bytes() {
  // LN(x) and dz tiles, the W1 and W2 chunks, a, dh rounded and unrounded
  return sizeof(float) * (2 * w_rows<D>() * (D + 1) + 2 * D * (BF2 + 1) +
                          3 * w_rows<D>() * (BF2 + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    ffn_bwd_w_kernel(const T* __restrict__ xn_b,
                             const T* __restrict__ dz_b,
                             const T* __restrict__ w1,
                             const float* __restrict__ b1,
                             const T* __restrict__ w2,
                             float* __restrict__ dw1p,
                             float* __restrict__ dw2p,
                             float* __restrict__ db1p, int M, int F,
                             int rows_per_group, int act, int q, float dscale,
                             int seed0) {
  constexpr int BMW = w_rows<D>();
  constexpr int LDX = D + 1;
  constexpr int LDC = BF2 + 1;
  constexpr int TPR = THREADS / BMW;  // threads per tile row
  constexpr int NJ = BF2 / TPR;       // chunk columns per thread
  // model columns per thread: tid + THREADS * kk, those past D idle
  constexpr int KK = (D + THREADS - 1) / THREADS;

  extern __shared__ float smem[];
  float* xn_s = smem;
  float* dz_s = xn_s + BMW * LDX;
  float* w1c = dz_s + BMW * LDX;  // [k][f] = W1[k][c0+f]
  float* w2c = w1c + D * LDC;     // [n][f] = W2[c0+f][n]
  float* a_s = w2c + D * LDC;
  float* dh_s = a_s + BMW * LDC;
  float* dhf_s = dh_s + BMW * LDC;

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * BF2;
  const int rbeg = blockIdx.y * rows_per_group;
  const int rend = min(M, rbeg + rows_per_group);

  for (int e = tid; e < D * BF2; e += THREADS) {
    const int k = e / BF2, f = e % BF2;
    w1c[k * LDC + f] = to_f32(w1[static_cast<size_t>(k) * F + c0 + f]);
  }
  for (int e = tid; e < D * BF2; e += THREADS) {
    const int f = e / D, n = e % D;
    w2c[n * LDC + f] = to_f32(w2[static_cast<size_t>(c0 + f) * D + n]);
  }

  float acc1[KK][BF2], acc2[KK][BF2];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int f = 0; f < BF2; ++f) acc1[kk][f] = acc2[kk][f] = 0.f;
  float db1acc = 0.f;

  const int tr = tid / TPR;  // tile row of this thread's h / da outputs
  const int fq = tid % TPR;
  for (int rt = rbeg; rt < rend; rt += BMW) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BMW * D; e += THREADS) {
      const int r = e / D, k = e % D;
      const int gi = rt + r;
      const bool ok = gi < rend;
      const size_t g = static_cast<size_t>(gi) * D + k;
      xn_s[r * LDX + k] = ok ? to_f32(xn_b[g]) : 0.f;
      dz_s[r * LDX + k] = ok ? to_f32(dz_b[g]) : 0.f;
    }
    __syncthreads();
    float hh[NJ], dd[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) hh[j] = dd[j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      const float xv = xn_s[tr * LDX + k];
      const float zv = dz_s[tr * LDX + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        hh[j] += xv * w1c[k * LDC + fq + TPR * j];
        dd[j] += zv * w2c[k * LDC + fq + TPR * j];
      }
    }
    const int gi = rt + tr;
    const unsigned st = drop_stream(seed0, gi);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int f = fq + TPR * j;
      const float h = hh[j] + b1[c0 + f];
      float a = act_fwd(h, act);
      float da = dd[j];
      if (q > 0) {
        const bool keep = drop_keep(st, gi, F, c0 + f, q);
        a = keep ? a * dscale : 0.f;
        da = keep ? da * dscale : 0.f;
      }
      float dh = da * act_grad(h, act);
      if (gi >= rend) a = dh = 0.f;
      a_s[tr * LDC + f] = round_to<T>(a);
      dhf_s[tr * LDC + f] = dh;
      dh_s[tr * LDC + f] = round_to<T>(dh);
    }
    __syncthreads();
    if (tid < BF2)
      for (int r = 0; r < BMW; ++r) db1acc += dhf_s[r * LDC + tid];
    for (int r = 0; r < BMW; ++r) {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const int k = tid + THREADS * kk;
        const float xv = k < D ? xn_s[r * LDX + k] : 0.f;
        const float zv = k < D ? dz_s[r * LDX + k] : 0.f;
#pragma unroll
        for (int f = 0; f < BF2; ++f) {
          acc1[kk][f] += xv * dh_s[r * LDC + f];
          acc2[kk][f] += a_s[r * LDC + f] * zv;
        }
      }
    }
  }

  const size_t part = blockIdx.y;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const int k = tid + THREADS * kk;
    if (k >= D) continue;
#pragma unroll
    for (int f = 0; f < BF2; ++f) {
      dw1p[(part * D + k) * F + c0 + f] = acc1[kk][f];
      dw2p[(part * F + c0 + f) * D + k] = acc2[kk][f];
    }
  }
  if (tid < BF2) db1p[part * F + c0 + tid] = db1acc;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

struct Drop {
  int q;
  float scale;
  int seed0, seed1;
};

template <typename T, int D, bool LN>
int launch_fwd(const void* x, const float* ln_scale, const float* ln_bias,
               const void* w1, const float* b1, const void* w2,
               const float* b2, void* y, int M, int F, float res_scale,
               int act, Drop dr, cudaStream_t stream) {
  auto kernel = ffn_fwd_kernel<T, D, LN>;
  const size_t smem = ffn_smem_bytes<D>();
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<(M + BM - 1) / BM, THREADS, smem, stream>>>(
      static_cast<const T*>(x), ln_scale, ln_bias, static_cast<const T*>(w1),
      b1, static_cast<const T*>(w2), b2, static_cast<T*>(y), M, F, res_scale,
      act, dr.q, dr.scale, dr.seed0, dr.seed1);
  return static_cast<int>(cudaGetLastError());
}

// With LN, xn_buf and dz_buf receive the rounded LN(x) and dz for the
// weight-gradient kernel; without LN they are null and it reads x and gy.
template <typename T, int D, bool LN>
int launch_bwd(const void* x, const float* ln_scale, const float* ln_bias,
               const void* w1, const float* b1, const void* w2,
               const void* gy, void* dx, void* xn_buf, void* dz_buf,
               float* partial, float* dw1p, float* dw2p, float* db1p, int M,
               int F, int groups, float res_scale, int act, Drop dr,
               cudaStream_t stream) {
  auto k1 = ffn_bwd_dx_kernel<T, D, LN>;
  const size_t smem1 = dx_smem_bytes<D>();
  if (int err = set_smem(k1, smem1)) return err;
  k1<<<(M + BM - 1) / BM, THREADS, smem1, stream>>>(
      static_cast<const T*>(x), ln_scale, ln_bias, static_cast<const T*>(w1),
      b1, static_cast<const T*>(w2), static_cast<const T*>(gy),
      static_cast<T*>(dx), static_cast<T*>(xn_buf), static_cast<T*>(dz_buf),
      partial, M, F, res_scale, act, dr.q, dr.scale, dr.seed0, dr.seed1);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  auto k2 = ffn_bwd_w_kernel<T, D>;
  const size_t smem2 = w_smem_bytes<D>();
  if (int err = set_smem(k2, smem2)) return err;
  const int rows_per_group = (M + groups - 1) / groups;
  k2<<<dim3(F / BF2, groups), THREADS, smem2, stream>>>(
      static_cast<const T*>(LN ? xn_buf : x),
      static_cast<const T*>(LN ? dz_buf : gy), static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), dw1p, dw2p, db1p, M, F, rows_per_group, act,
      dr.q, dr.scale, dr.seed0);
  return static_cast<int>(cudaGetLastError());
}

bool options_ok(int M, int F, int act, int q) {
  return M >= 1 && F >= BF && F % BF == 0 && (act == kSwish || act == kRelu) &&
         q >= 0 && q <= 255;
}

}  // namespace
}  // namespace espnet_port
