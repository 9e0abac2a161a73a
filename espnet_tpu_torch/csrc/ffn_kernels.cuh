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
// Its device pieces -- `ln_row` / `layer_norm_rows`, `tile_product`, the
// hash (`tile_stream`, `keep_counter`), `ln_bwd_row`, `store_block_sums`
// -- and the weight-gradient kernels, `atb_kernel` on the CUDA cores for
// float32 and `atb_tc_kernel` on the tensor cores for bf16, also build the
// conformer conv kernels (conv_glu.cu, conv_module.cu).
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
// per byte at M=30k, D=256, F=2048: bound by arithmetic, so the products
// belong on the tensor cores.
//
// The float32 forward and backward run on the CUDA cores (`tile_product`):
// float32 is the port's parity mode, and tensor-core float32 would be TF32,
// about three decimal digits. The forward block owns BM rows, normalises
// them (LN) or copies them into shared memory once and walks F in chunks
// whose activations go through shared memory straight into the float32
// output accumulator in registers: the (M, F) hidden activation never
// reaches device memory.
//
// The bf16 forward, `ffn_fwd_tc_kernel`, has the same shape on tensor
// cores (mma.sync m16n8k16, ldmatrix, a two-stage cp.async ring; mma.sync
// rather than wgmma because the activation, the hash and the rounding of a
// sit between the two products at fragment granularity). A block owns 64
// rows (32 at D > 256, as the backward's row kernel), keeps LN(x) (or x)
// rounded to bf16 in shared memory with 16-byte row padding, and walks F in
// 64-wide chunks (32 at D > 256) whose W1 and W2 slabs arrive through the
// ring while the previous chunk computes: h = LN(x)·W1 + b1 on mma, the
// activation and the stream-0 hash on the C fragments, a rounded into a
// shared-memory tile, z += a·W2 on mma into float32 registers, the 8 warps
// splitting z's D columns (WN ways) so that its accumulators fit at
// D = 512. The epilogue adds b2, with LN the stream-1 hash and x + s·z,
// and rounds once.
//
// The backward needs dx, which sums over F for each row, and dW1, dW2,
// which sum over all rows for each column of F; no block sees both, so it
// is two kernels.
//
// * bf16, on tensor cores (mma.sync m16n8k16 with ldmatrix fragments and a
//   cp.async ring; see tensor_core.cuh). `ffn_bwd_rows_tc_kernel` owns 64
//   rows (32 at D > 256, for shared memory), keeps the rounded LN(x) (or x)
//   and dz = s·drop1(gy) (or gy) tiles in shared memory, and walks F in
//   32-wide chunks whose W1 and W2 slabs arrive through a two-stage
//   cp.async ring, loading the next chunk while it computes on this one.
//   Per chunk it runs three products on mma: h = LN(x)·W1 + b1
//   (recomputed), da = dz·W2ᵀ, and, once dh = drop0(da)·act'(h) is rounded
//   into shared memory, dxn += dh·W1ᵀ in float32 registers. It writes
//   a = drop0(act(h)) and dh once each as (M, F) bf16 tensors (coalesced,
//   from shared memory) and db1's per-block partial sums of the unrounded
//   dh. After the walk, dxn goes through shared memory to the warp-per-row
//   LayerNorm backward (`ln_bwd_row`), which writes dx and the per-block
//   partials of dLN scale, dLN bias and db2. Then `atb_tc_kernel`, one
//   tensor-core A^T B kernel, runs twice: dW1 = LN(x)ᵀ·dh (D x F) and
//   dW2 = aᵀ·dz (F x D), each split over row groups into float32 partials
//   that are added afterwards (deterministic, no atomics). The products
//   come to the bound's 10·M·D·F; the price is 2·M·F bf16 written and read
//   once (246 MB at the conformer's training shapes, transient).
//   mma.sync rather than wgmma with TMA: the epilogues (hash, activation
//   gradient, LayerNorm backward) sit between the products at fragment
//   granularity, which the warp-level instructions keep simple; wgmma is
//   later work.
// * float32, on the CUDA cores. `bwd_dx` owns BM rows and walks F (as the
//   forward), recomputing h and da chunk by chunk to accumulate dx (LN:
//   dxn) in registers; with LN it writes dx, the rounded LN(x) and dz
//   (M x D each), without LN only dx, and per-block partial sums of dLN
//   scale, dLN bias and db2 (without LN, of db2 alone). `bwd_w` owns a
//   BF2-wide column chunk of F and a group of rows, keeps its W1 and W2
//   chunks in shared memory, recomputes h, a and dh for its rows from the
//   stored LN(x) and dz (or x and dy), and accumulates the chunk's dW1,
//   dW2 and db1 in registers (14·M·D·F flops in all).
// * Rows past M are read as zeros (finite) and never stored or summed.
// * D is a template argument, a multiple of 128 up to 512 (the entry points
//   instantiate 128, 256, 384 and 512): at D = 640 the forward's and the
//   dx kernels' shared memory would pass the 227 KB a block may have.
#pragma once

#include "common.cuh"
#include "tensor_core.cuh"

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

// Stream id of hash tile `tile` (the Pallas kernel's program id).
__device__ __forceinline__ unsigned tile_stream(int seed, int tile) {
  return fmix32(static_cast<unsigned>(seed)) ^
         (static_cast<unsigned>(tile) * 0x9E3779B9u);
}

// Keep bit of the element with counter `counter` (row within the tile times
// the width, plus the column) in the tile of stream id `stream`.
__device__ __forceinline__ bool keep_counter(unsigned stream, unsigned counter,
                                             int q) {
  return (fmix32(counter + stream * 0x9E3779B9u) >> 24) >=
         static_cast<unsigned>(q);
}

// Stream id of the logical 256-row tile holding row g.
__device__ __forceinline__ unsigned drop_stream(int seed, int g) {
  return tile_stream(seed, g / DROP_TILE);
}

// Keep bit of (row g, column c) of a width-C tensor, given g's stream id.
__device__ __forceinline__ bool drop_keep(unsigned stream, int g, int C,
                                          int c, int q) {
  return keep_counter(stream,
                      static_cast<unsigned>(g % DROP_TILE) *
                              static_cast<unsigned>(C) +
                          static_cast<unsigned>(c),
                      q);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float act_fwd(float h, int act) {
  return act == kRelu ? fmaxf(h, 0.f) : h / (1.f + expf(-h));
}

__device__ __forceinline__ float act_grad(float h, int act) {
  if (act == kRelu) return h > 0.f ? 1.f : 0.f;
  const float s = 1.f / (1.f + expf(-h));
  return s * (1.f + h * (1.f - s));
}

// act(h) and act'(h) together, the swish's sigmoid computed once.
__device__ __forceinline__ void act_and_grad(float h, int act, float& a,
                                             float& grad) {
  if (act == kRelu) {
    a = fmaxf(h, 0.f);
    grad = h > 0.f ? 1.f : 0.f;
    return;
  }
  const float s = 1.f / (1.f + expf(-h));
  a = h * s;
  grad = s * (1.f + h * (1.f - s));
}

// LayerNorm (eps 1e-6) of one row of n <= DP values held by one warp (value
// d = lane + 32 e of src; a row that is not `valid` reads as zeros):
// dst[d] = round_to<T>(epi(xhat * scale + bias)) for d < n and 0 for
// n <= d < DP, with epi the swish where SWISH, else the identity. dst may be
// src. Returns the row's mean and 1/std.
template <typename S, typename T, int DP, bool SWISH>
__device__ __forceinline__ void ln_row(const S* src, int n, bool valid,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias,
                                       float* dst, float& mean_out,
                                       float& inv_out) {
  constexpr int ZJ = DP / 32;
  const int lane = threadIdx.x & 31;
  float vals[ZJ];
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < ZJ; ++e) {
    const int d = lane + 32 * e;
    vals[e] = valid && d < n ? to_f32(src[d]) : 0.f;
    sum += vals[e];
  }
  const float mean = warp_sum(sum) / n;
  float sq = 0.f;
#pragma unroll
  for (int e = 0; e < ZJ; ++e) {
    vals[e] = lane + 32 * e < n ? vals[e] - mean : 0.f;
    sq += vals[e] * vals[e];
  }
  const float inv = rsqrtf(warp_sum(sq) / n + LN_EPS);
#pragma unroll
  for (int e = 0; e < ZJ; ++e) {
    const int d = lane + 32 * e;
    float v = 0.f;
    if (d < n) {
      v = vals[e] * inv * scale[d] + bias[d];
      if (SWISH) v = v * sigmoidf(v);
    }
    dst[d] = round_to<T>(v);
  }
  mean_out = mean;
  inv_out = inv;
}

// LayerNorm of BM rows of x (M x D) into xn_s (rounded to T, epi as in
// ln_row); warp w does rows 4w..4w+3. Optionally keeps each row's mean and
// 1/std.
template <typename T, int D, bool SWISH = false>
__device__ __forceinline__ void layer_norm_rows(
    const T* __restrict__ x, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, float* xn_s, float* mean_s,
    float* inv_s, int row0, int M) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int r = warp * (BM / 8) + rr;
    const int gi = row0 + r;
    float mean, inv;
    ln_row<T, T, D, SWISH>(x + static_cast<size_t>(gi < M ? gi : 0) * D, D,
                           gi < M, ln_scale, ln_bias, xn_s + r * (D + 1),
                           mean, inv);
    if (mean_s != nullptr && lane == 0) {
      mean_s[r] = mean;
      inv_s[r] = inv;
    }
  }
}

// The block's product of its 32 rows of A (shared memory, row r at
// a_s + r * lda; warp w holds rows w, w+8, w+16, w+24) with NJ * 32 columns
// of W (K x ncols, W(k, c) = w[k * ld + c]; TRANS: w[c * ld + k]):
// acc[ii][jj] += sum_{k < K} A(w + 8 ii, k) W(k, lane + 32 jj). Slabs of KS
// rows of W pass through w_s (KS x (NJ * 32 + TRANS) floats). With GUARD,
// rows k >= K and columns c >= ncols of W read as 0, and A's columns from
// K up to the next multiple of KS must hold finite values (the callers
// keep zeros there); without it (the FFN forward), K must be a multiple of
// KS and ncols at least NJ * 32. Every thread of the block calls it; it
// begins with a barrier, so the caller's writes to a_s before the call are
// seen.
template <typename T, int NJ, bool TRANS, bool GUARD = true>
__device__ __forceinline__ void tile_product(const float* a_s, int lda,
                                             const T* __restrict__ w, int ld,
                                             int K, int ncols, float* w_s,
                                             float (&acc)[4][NJ]) {
  constexpr int NC = NJ * 32;
  constexpr int LDW = NC + (TRANS ? 1 : 0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int k0 = 0; k0 < K; k0 += KS) {
    __syncthreads();  // earlier readers of w_s done, a_s written
    for (int e = tid; e < KS * NC; e += THREADS) {
      // neighbouring threads on neighbouring addresses of w
      const int kk = TRANS ? e % KS : e / NC;
      const int c = TRANS ? e / KS : e % NC;
      const int k = k0 + kk;
      float v = 0.f;
      if (!GUARD || (k < K && c < ncols))
        v = to_f32(TRANS ? w[static_cast<size_t>(c) * ld + k]
                         : w[static_cast<size_t>(k) * ld + c]);
      w_s[kk * LDW + c] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      float a[4], wv[NJ];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        a[ii] = a_s[(warp + 8 * ii) * lda + k0 + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) wv[jj] = w_s[kk * LDW + lane + 32 * jj];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[ii][jj] += a[ii] * wv[jj];
    }
  }
}

// LayerNorm backward of one row held by one warp (value lane + 32 e < n):
// dxv = d LN / d x for the gradient dyv of LN's output, given the row's
// xhat and 1/std; adds dyv * xhat and dyv to the LN scale and bias sums.
template <int ZJ>
__device__ __forceinline__ void ln_bwd_row(const float (&dyv)[ZJ],
                                           const float (&xh)[ZJ],
                                           const float* __restrict__ scale,
                                           float inv, int n,
                                           float (&dxv)[ZJ], float (&dls)[ZJ],
                                           float (&dlb)[ZJ]) {
  const int lane = threadIdx.x & 31;
  float dxh[ZJ];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int jj = 0; jj < ZJ; ++jj) {
    const int d = lane + 32 * jj;
    dxh[jj] = 0.f;
    if (d >= n) continue;
    dxh[jj] = dyv[jj] * scale[d];
    s1 += dxh[jj];
    s2 += dxh[jj] * xh[jj];
    dls[jj] += dyv[jj] * xh[jj];
    dlb[jj] += dyv[jj];
  }
  const float m1 = warp_sum(s1) / n;
  const float m2 = warp_sum(s2) / n;
#pragma unroll
  for (int jj = 0; jj < ZJ; ++jj)
    dxv[jj] = (dxh[jj] - m1 - xh[jj] * m2) * inv;
}

// The block's sums over its 8 warps of NP per-thread column vectors (vals[p]
// [jj] for column lane + 32 jj) into out[p * n + d], d < n. red: 8 * NP *
// ZJ * 32 floats of shared memory that no thread reads any more.
template <int NP, int ZJ>
__device__ __forceinline__ void store_block_sums(const float (&vals)[NP][ZJ],
                                                 float* red, float* out,
                                                 int n) {
  constexpr int W = ZJ * 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __syncthreads();
#pragma unroll
  for (int jj = 0; jj < ZJ; ++jj)
#pragma unroll
    for (int p = 0; p < NP; ++p)
      red[(warp * NP + p) * W + lane + 32 * jj] = vals[p][jj];
  __syncthreads();
  for (int e = tid; e < NP * W; e += THREADS) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w * NP * W + e];
    const int p = e / W, d = e % W;
    if (d < n) out[p * n + d] = s;
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
    tile_product<T, 4, false, false>(xn_s, LDX, w1 + c0, F, D, BF, w1_s,
                                     hacc);
    // The previous chunk's readers of h_s passed the first barrier of the
    // product above, so h_s may be written now.
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
    tile_product<T, ZJ, false, false>(h_s, LDH,
                                      w2 + static_cast<size_t>(c0) * D, D,
                                      BF, D, w2_s, z);
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
  // per-thread column sums: dLN scale, dLN bias, db2 | db2
  constexpr int NP = LN ? 3 : 1;
  float part[NP][ZJ];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < ZJ; ++e) part[p][e] = 0.f;
  // dz = drop1(s * g) (LN) or g, rounded; partial db2 over this warp's rows
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
        part[NP - 1][e] += v;
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
    float xh[ZJ], dxl[ZJ];
#pragma unroll
    for (int jj = 0; jj < ZJ; ++jj)
      xh[jj] = (to_f32(x[static_cast<size_t>(gi) * D + lane + 32 * jj]) -
                mean) * inv;
    ln_bwd_row<ZJ>(z[ii], xh, ln_scale, inv, D, dxl, part[0], part[LN]);
#pragma unroll
    for (int jj = 0; jj < ZJ; ++jj) {
      const size_t g = static_cast<size_t>(gi) * D + lane + 32 * jj;
      dx[g] = from_f32<T>(to_f32(gy[g]) + dxl[jj]);
    }
  }
  // per-block partial sums over the 8 warps: reuse xn_s as (8, NP, D)
  store_block_sums<NP, ZJ>(part, xn_s,
                           partial + static_cast<size_t>(blockIdx.x) * NP * D,
                           D);
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

// ---------------------------------------------------------------------------
// Weight gradient of a product with its rows' inputs and output gradients
// stored: out[group][k][n] = sum over the group's rows m of A[m][k] B[m][n]
// (A: M x K, B: M x N, row-major, type T; out float32). A block owns a
// WT x WT tile of the result and one group of rows, stages WR rows of each
// operand at a time in shared memory and keeps its 4 x 4 outputs per thread
// in registers; the groups' partial sums are added afterwards (no atomics).
// ---------------------------------------------------------------------------

constexpr int WT = 64;  // result tile (ops/ffn_common.py WGRAD_TILE)
constexpr int WR = 32;  // rows staged per step

template <typename T>
__global__ void __launch_bounds__(THREADS)
    atb_kernel(const T* __restrict__ a, const T* __restrict__ b,
               float* __restrict__ out, int M, int K, int N,
               int rows_per_group) {
  __shared__ float a_s[WR][WT + 1];
  __shared__ float b_s[WR][WT + 1];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * WT, k0 = blockIdx.y * WT;
  const int rbeg = blockIdx.z * rows_per_group;
  const int rend = min(M, rbeg + rows_per_group);
  const int tk = tid / 16, tn = tid % 16;  // outputs k0+tk+16i, n0+tn+16j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int r0 = rbeg; r0 < rend; r0 += WR) {
    __syncthreads();  // the previous step's readers are done
    for (int e = tid; e < WR * WT; e += THREADS) {
      const int r = e / WT, c = e % WT;
      const int m = r0 + r;
      const bool row_ok = m < rend;
      a_s[r][c] = row_ok && k0 + c < K
                      ? to_f32(a[static_cast<size_t>(m) * K + k0 + c])
                      : 0.f;
      b_s[r][c] = row_ok && n0 + c < N
                      ? to_f32(b[static_cast<size_t>(m) * N + n0 + c])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < WR; ++r) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[r][tk + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[r][tn + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
  }
  float* o = out + static_cast<size_t>(blockIdx.z) * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tk + 16 * i, n = n0 + tn + 16 * j;
      if (k < K && n < N) o[static_cast<size_t>(k) * N + n] = acc[i][j];
    }
}

// out: (groups, K, N) float32 partial sums of A^T B.
template <typename T>
int launch_atb(const T* a, const T* b, float* out, int M, int K, int N,
               int groups, cudaStream_t stream) {
  const int rows_per_group = (M + groups - 1) / groups;
  atb_kernel<T><<<dim3((N + WT - 1) / WT, (K + WT - 1) / WT, groups),
                  THREADS, 0, stream>>>(a, b, out, M, K, N, rows_per_group);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 backward on tensor cores, kernel 2: out[group][k][n] = sum over the
// group's rows m of A[m][k] B[m][n] (A: M x K, B: M x N, row-major bf16;
// out float32; K and N multiples of TC_TILE; A, B 16-byte aligned). A block
// of 8 warps (2 x 4, each 64 x 32 of the result) owns a TC_TILE x TC_TILE
// tile and one group of rows, which pass through a TC_STAGES-deep cp.async
// ring TC_ROWS at a time; both operands hold the reduction index along
// their rows, so both are read with ldmatrix.trans. Rows past the group
// read as zeros; an empty group writes zeros.
// ---------------------------------------------------------------------------

constexpr int TC_TILE = 128;  // result tile (ops/ffn_common.py TC_WGRAD_TILE)
constexpr int TC_ROWS = 32;   // rows per stage (ffn_common.py TC_WGRAD_ROWS)
constexpr int TC_STAGES = 3;
constexpr int TC_LDT = TC_TILE + 8;  // bf16 row stride in shared memory
constexpr size_t atb_tc_smem_bytes() {
  return sizeof(bf16) * TC_STAGES * 2 * TC_ROWS * TC_LDT;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    atb_tc_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  float* __restrict__ out, int M, int K, int N,
                  int rows_per_group) {
  static_assert(sizeof(T) == 2, "the tensor-core A^T B takes bf16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);  // [stage][row][TC_LDT]
  bf16* sb = sa + TC_STAGES * TC_ROWS * TC_LDT;
  const bf16* ag = reinterpret_cast<const bf16*>(a);
  const bf16* bg = reinterpret_cast<const bf16*>(b);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wk = warp >> 2;  // 64 result rows (k) each
  const int wn = warp & 3;   // 32 result columns (n) each
  const int n0 = blockIdx.x * TC_TILE, k0 = blockIdx.y * TC_TILE;
  const int rbeg = blockIdx.z * rows_per_group;
  const int rend = min(M, rbeg + rows_per_group);
  const int steps = rend > rbeg ? (rend - rbeg + TC_ROWS - 1) / TC_ROWS : 0;

  auto load = [&](int step, int st) {
    constexpr int CPR = TC_TILE / 8;  // 16-byte chunks per row
    const int r0 = rbeg + step * TC_ROWS;
    for (int e = tid; e < TC_ROWS * CPR; e += THREADS) {
      const int r = e / CPR, c = e % CPR;
      const int m = r0 + r;
      const bool ok = m < rend;
      const size_t mo = static_cast<size_t>(ok ? m : 0);
      cp_async16(sa + (st * TC_ROWS + r) * TC_LDT + c * 8,
                 ag + mo * K + k0 + c * 8, ok ? 16 : 0);
      cp_async16(sb + (st * TC_ROWS + r) * TC_LDT + c * 8,
                 bg + mo * N + n0 + c * 8, ok ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // step s landed; step s-1's readers are done
    const int next = s + TC_STAGES - 1;
    if (next < steps) load(next, next % TC_STAGES);
    cp_async_commit();
    const int st = s % TC_STAGES;
    const bf16* A = sa + st * TC_ROWS * TC_LDT;
    const bf16* B = sb + st * TC_ROWS * TC_LDT;
#pragma unroll
    for (int kk = 0; kk < TC_ROWS / 16; ++kk) {
      unsigned af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4_trans(af[mt], A + (kk * 16 + (lane & 7) +
                                       (lane >> 4) * 8) * TC_LDT +
                                      wk * 64 + mt * 16 +
                                      ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned bf[4];
        ldmatrix_x4_trans(bf, B + (kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * TC_LDT +
                                  wn * 32 + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* o = out + static_cast<size_t>(blockIdx.z) * K * N;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int kr = k0 + wk * 64 + mt * 16 + g;
      const int nc = n0 + wn * 32 + nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(o + static_cast<size_t>(kr) * N + nc) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(o + static_cast<size_t>(kr + 8) * N + nc) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// ---------------------------------------------------------------------------
// bf16 backward on tensor cores, kernel 1: a row block's dx, a and dh, and
// its partial sums (see the note at the top).
// ---------------------------------------------------------------------------

constexpr int TC_BF = 32;  // hidden units per chunk

template <int D>
struct TcRows {
  static constexpr int BMR = D <= 256 ? 64 : 32;  // rows per block
  static constexpr int LDX = D + 8;      // bf16 stride: x / dz rows, W2 slab
  static constexpr int LDF = TC_BF + 8;  // bf16 stride: W1 slab, a / dh tiles
  static constexpr int LDZ = D + 8;      // float stride of the dxn staging
  static constexpr int WM = BMR / 16;    // warps along rows
  static constexpr int WN = 8 / WM;      // warps along columns
  static constexpr int XN = BMR * LDX;   // elements of the x or dz tile
  static constexpr int SLAB = D * LDF + TC_BF * LDX;  // one ring stage
  static constexpr int TILE = BMR * LDF;              // the a or dh tile
  static constexpr size_t bytes = sizeof(bf16) * (2 * XN + 2 * SLAB + 2 * TILE)
                                  + sizeof(float) * (WM * TC_BF + 2 * BMR);
  static_assert(sizeof(float) * BMR * LDZ <= sizeof(bf16) * 2 * SLAB,
                "dxn is staged in the ring");
  static_assert(sizeof(float) * 8 * 3 * D <= sizeof(bf16) * 2 * XN,
                "the block sums reuse the x and dz tiles");
  static_assert(bytes <= 232448, "a block may have 227 KB");
};

template <int D, bool LN>
__global__ void __launch_bounds__(THREADS)
    ffn_bwd_rows_tc_kernel(const bf16* __restrict__ x,
                           const float* __restrict__ ln_scale,
                           const float* __restrict__ ln_bias,
                           const bf16* __restrict__ w1,
                           const float* __restrict__ b1,
                           const bf16* __restrict__ w2,
                           const bf16* __restrict__ gy, bf16* __restrict__ dx,
                           bf16* __restrict__ xn_out, bf16* __restrict__ dz_out,
                           bf16* __restrict__ a_out, bf16* __restrict__ dh_out,
                           float* __restrict__ partial,
                           float* __restrict__ db1p, int M, int F,
                           float res_scale, int act, int q, float dscale,
                           int seed0, int seed1) {
  using L = TcRows<D>;
  constexpr int BMR = L::BMR, LDX = L::LDX, LDF = L::LDF, LDZ = L::LDZ;
  constexpr int WM = L::WM, WN = L::WN;
  constexpr int NT = TC_BF / (8 * WN);  // n-tiles of h and da per warp
  constexpr int NX = D / (8 * WN);      // n-tiles of dxn per warp
  constexpr int ZJ = D / 32;
  constexpr int NP = LN ? 3 : 1;
  static_assert(NT == 1 || NT == 2, "h tile per warp");
  static_assert(NX % 2 == 0, "dxn n-tiles go in pairs");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xn_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* dz_s = xn_s + L::XN;
  bf16* ring = dz_s + L::XN;  // [stage]: W1 slab [D][LDF], W2 slab [BF][LDX]
  bf16* a_s = ring + 2 * L::SLAB;
  bf16* dh_s = a_s + L::TILE;
  float* red_s = reinterpret_cast<float*>(dh_s + L::TILE);  // [WM][TC_BF]
  float* mean_s = red_s + WM * TC_BF;
  float* inv_s = mean_s + BMR;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * BMR;

  auto load_slab = [&](int c0, int st) {
    bf16* w1s = ring + st * L::SLAB;  // W1[d][c0 + f]
    bf16* w2s = w1s + D * LDF;        // W2[c0 + f][d]
    constexpr int C1 = TC_BF / 8, C2 = D / 8;
    for (int e = tid; e < D * C1; e += THREADS) {
      const int d = e / C1, c = e % C1;
      cp_async16(w1s + d * LDF + c * 8,
                 w1 + static_cast<size_t>(d) * F + c0 + c * 8, 16);
    }
    for (int e = tid; e < TC_BF * C2; e += THREADS) {
      const int f = e / C2, c = e % C2;
      cp_async16(w2s + f * LDX + c * 8,
                 w2 + static_cast<size_t>(c0 + f) * D + c * 8, 16);
    }
  };
  load_slab(0, 0);
  cp_async_commit();

  // LN(x) (or x) and dz = s·drop1(gy) (or gy), rounded, zeros past M; warp
  // w does rows w·BMR/8 ...
  for (int rr = 0; rr < BMR / 8; ++rr) {
    const int r = warp * (BMR / 8) + rr;
    const int gi = row0 + r;
    const bool ok = gi < M;
    const size_t base = static_cast<size_t>(ok ? gi : 0) * D;
    float xv[ZJ];
#pragma unroll
    for (int e = 0; e < ZJ; ++e)
      xv[e] = ok ? to_f32(x[base + lane + 32 * e]) : 0.f;
    if (LN) {
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < ZJ; ++e) sum += xv[e];
      const float mean = warp_sum(sum) / D;
      float sq = 0.f;
#pragma unroll
      for (int e = 0; e < ZJ; ++e) {
        xv[e] -= mean;
        sq += xv[e] * xv[e];
      }
      const float inv = rsqrtf(warp_sum(sq) / D + LN_EPS);
#pragma unroll
      for (int e = 0; e < ZJ; ++e) {
        const int d = lane + 32 * e;
        xv[e] = xv[e] * inv * ln_scale[d] + ln_bias[d];
      }
      if (lane == 0) {
        mean_s[r] = mean;
        inv_s[r] = inv;
      }
    }
    const unsigned st1 = drop_stream(seed1, gi);
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      const bf16 xb = from_f32<bf16>(ok ? xv[e] : 0.f);
      float v = ok ? to_f32(gy[base + d]) : 0.f;
      if (LN) {
        v *= res_scale;
        if (q > 0) v = drop_keep(st1, gi, D, d, q) ? v * dscale : 0.f;
      }
      const bf16 vb = from_f32<bf16>(v);
      xn_s[r * LDX + d] = xb;
      dz_s[r * LDX + d] = vb;
      if (LN && ok) {
        xn_out[base + d] = xb;
        dz_out[base + d] = vb;
      }
    }
  }

  // this lane's fragment rows and their dropout streams
  const int ra = wm * 16 + g;
  const unsigned st0[2] = {drop_stream(seed0, row0 + ra),
                           drop_stream(seed0, row0 + ra + 8)};
  const int nb = wn * NT * 8;  // this warp's first column of a chunk
  const int xc = wn * NX * 8;  // this warp's first column of dxn
  float zacc[NX][4];           // dxn, float32
#pragma unroll
  for (int n = 0; n < NX; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) zacc[n][e] = 0.f;

  const int chunks = F / TC_BF;
  for (int ch = 0; ch < chunks; ++ch) {
    const int c0 = ch * TC_BF;
    const int st = ch & 1;
    cp_async_wait<0>();
    __syncthreads();  // slab ch landed; chunk ch-1's readers are done
    if (ch + 1 < chunks) {
      load_slab(c0 + TC_BF, st ^ 1);
      cp_async_commit();
    }
    const bf16* w1s = ring + st * L::SLAB;
    const bf16* w2s = w1s + D * LDF;

    // h = LN(x) W1[:, chunk] (W1 slab rows are k: ldmatrix.trans) and
    // da = dz W2[chunk, :]ᵀ (W2 slab rows are n: ldmatrix)
    float hacc[NT][4], dacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[n][e] = dacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int aoff = (wm * 16 + (lane & 15)) * LDX + kk * 16 +
                       (lane >> 4) * 8;
      unsigned ax[4], az[4];
      ldmatrix_x4(ax, xn_s + aoff);
      ldmatrix_x4(az, dz_s + aoff);
      const bf16* p1 = w1s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LDF + nb;
      if constexpr (NT == 2) {
        unsigned bw1[4], bw2[4];
        ldmatrix_x4_trans(bw1, p1 + (lane >> 4) * 8);
        ldmatrix_x4(bw2, w2s + (nb + (lane & 7) + (lane >> 4) * 8) * LDX +
                             kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(hacc[0], ax, bw1[0], bw1[1]);
        mma_bf16(hacc[1], ax, bw1[2], bw1[3]);
        mma_bf16(dacc[0], az, bw2[0], bw2[1]);
        mma_bf16(dacc[1], az, bw2[2], bw2[3]);
      } else {
        unsigned bw1[2], bw2[2];
        ldmatrix_x2_trans(bw1, p1);
        ldmatrix_x2(bw2, w2s + (nb + (lane & 7)) * LDX + kk * 16 +
                             ((lane >> 3) & 1) * 8);
        mma_bf16(hacc[0], ax, bw1[0], bw1[1]);
        mma_bf16(dacc[0], az, bw2[0], bw2[1]);
      }
    }

    // a = drop0(act(h)), dh = drop0(da)·act'(h): rounded into the tiles;
    // db1 sums the unrounded dh
    float db1v[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      db1v[n][0] = db1v[n][1] = 0.f;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = ra + 8 * hr;
        const int gi = row0 + r;
        const int c = nb + n * 8 + 2 * t4;
        float av[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = c0 + c + e;
          const float h = hacc[n][2 * hr + e] + b1[f];
          float a, grad;
          act_and_grad(h, act, a, grad);
          float da = dacc[n][2 * hr + e];
          if (q > 0) {
            const bool keep = drop_keep(st0[hr], gi, F, f, q);
            a = keep ? a * dscale : 0.f;
            da = keep ? da * dscale : 0.f;
          }
          av[e] = a;
          dv[e] = da * grad;
          db1v[n][e] += dv[e];
        }
        *reinterpret_cast<__nv_bfloat162*>(a_s + r * LDF + c) =
            __floats2bfloat162_rn(av[0], av[1]);
        *reinterpret_cast<__nv_bfloat162*>(dh_s + r * LDF + c) =
            __floats2bfloat162_rn(dv[0], dv[1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = db1v[n][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red_s[wm * TC_BF + nb + n * 8 + 2 * t4 + e] = v;
      }
    }
    __syncthreads();  // the a and dh tiles and the db1 sums are complete

    // dxn += dh W1[:, chunk]ᵀ (W1 slab rows are n: ldmatrix)
#pragma unroll
    for (int kk = 0; kk < TC_BF / 16; ++kk) {
      unsigned ad[4];
      ldmatrix_x4(ad, dh_s + (wm * 16 + (lane & 15)) * LDF + kk * 16 +
                          (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NX / 2; ++np) {
        unsigned bw[4];
        ldmatrix_x4(bw, w1s + (xc + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                  LDF + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(zacc[2 * np], ad, bw[0], bw[1]);
        mma_bf16(zacc[2 * np + 1], ad, bw[2], bw[3]);
      }
    }
    // a and dh to device memory, 16 bytes a thread, rows past M dropped
    constexpr int CR = TC_BF / 8;
    for (int e = tid; e < BMR * CR; e += THREADS) {
      const int r = e / CR, c = e % CR;
      const int gi = row0 + r;
      if (gi >= M) continue;
      const size_t go = static_cast<size_t>(gi) * F + c0 + c * 8;
      *reinterpret_cast<uint4*>(a_out + go) =
          *reinterpret_cast<const uint4*>(a_s + r * LDF + c * 8);
      *reinterpret_cast<uint4*>(dh_out + go) =
          *reinterpret_cast<const uint4*>(dh_s + r * LDF + c * 8);
    }
    if (tid < TC_BF) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WM; ++w) sum += red_s[w * TC_BF + tid];
      db1p[static_cast<size_t>(blockIdx.x) * F + c0 + tid] = sum;
    }
  }
  __syncthreads();  // every reader of the ring is done

  // dxn through shared memory (the ring) to one warp per row
  float* z_s = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int n = 0; n < NX; ++n) {
    const int c = xc + n * 8 + 2 * t4;
    *reinterpret_cast<float2*>(z_s + ra * LDZ + c) =
        make_float2(zacc[n][0], zacc[n][1]);
    *reinterpret_cast<float2*>(z_s + (ra + 8) * LDZ + c) =
        make_float2(zacc[n][2], zacc[n][3]);
  }
  __syncthreads();

  // LayerNorm backward per row (or dx = dxn) and the column sums: dLN
  // scale, dLN bias and db2 (LN), db2 (no LN); db2 sums the unrounded dz
  float part[NP][ZJ];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < ZJ; ++e) part[p][e] = 0.f;
  for (int rr = 0; rr < BMR / 8; ++rr) {
    const int r = warp * (BMR / 8) + rr;
    const int gi = row0 + r;
    if (gi >= M) continue;  // uniform across the warp
    const size_t base = static_cast<size_t>(gi) * D;
    const unsigned st1 = drop_stream(seed1, gi);
    float zv[ZJ], gv[ZJ];
#pragma unroll
    for (int jj = 0; jj < ZJ; ++jj) {
      const int d = lane + 32 * jj;
      zv[jj] = z_s[r * LDZ + d];
      gv[jj] = to_f32(gy[base + d]);
      float v = gv[jj];
      if (LN) {
        v *= res_scale;
        if (q > 0) v = drop_keep(st1, gi, D, d, q) ? v * dscale : 0.f;
      }
      part[NP - 1][jj] += v;
    }
    if constexpr (!LN) {
#pragma unroll
      for (int jj = 0; jj < ZJ; ++jj)
        dx[base + lane + 32 * jj] = from_f32<bf16>(zv[jj]);
    } else {
      const float mean = mean_s[r], inv = inv_s[r];
      float xh[ZJ], dxl[ZJ];
#pragma unroll
      for (int jj = 0; jj < ZJ; ++jj)
        xh[jj] = (to_f32(x[base + lane + 32 * jj]) - mean) * inv;
      ln_bwd_row<ZJ>(zv, xh, ln_scale, inv, D, dxl, part[0], part[LN]);
#pragma unroll
      for (int jj = 0; jj < ZJ; ++jj)
        dx[base + lane + 32 * jj] = from_f32<bf16>(gv[jj] + dxl[jj]);
    }
  }
  // per-block sums over the 8 warps: reuse the x and dz tiles as (8, NP, D)
  store_block_sums<NP, ZJ>(part, reinterpret_cast<float*>(smem_raw),
                           partial + static_cast<size_t>(blockIdx.x) * NP * D,
                           D);
}

// ---------------------------------------------------------------------------
// bf16 forward on tensor cores: a row block's y (see the note at the top).
// ---------------------------------------------------------------------------

template <int D>
struct TcFwd {
  static constexpr int BMR = TcRows<D>::BMR;      // rows per block
  static constexpr int BFC = D <= 256 ? 64 : 32;  // hidden units per chunk
  static constexpr int LDX = D + 8;    // bf16 stride: LN(x) rows, W2 slab
  static constexpr int LDF = BFC + 8;  // bf16 stride: W1 slab, a tile
  static constexpr int WM = BMR / 16;  // warps along rows
  static constexpr int WN = 8 / WM;    // warps along columns
  static constexpr int SLAB = D * LDF + BFC * LDX;  // one ring stage
  static constexpr size_t bytes =
      sizeof(bf16) * (BMR * LDX + 2 * SLAB + BMR * LDF);
  static_assert(bytes <= 232448, "a block may have 227 KB");
};

template <int D, bool LN>
__global__ void __launch_bounds__(THREADS)
    ffn_fwd_tc_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ ln_scale,
                      const float* __restrict__ ln_bias,
                      const bf16* __restrict__ w1,
                      const float* __restrict__ b1,
                      const bf16* __restrict__ w2,
                      const float* __restrict__ b2, bf16* __restrict__ y,
                      int M, int F, float res_scale, int act, int q,
                      float dscale, int seed0, int seed1) {
  using L = TcFwd<D>;
  constexpr int BMR = L::BMR, BFC = L::BFC, LDX = L::LDX, LDF = L::LDF;
  constexpr int WN = L::WN;
  constexpr int NT = BFC / (8 * WN);  // n-tiles of h per warp
  constexpr int NZ = D / (8 * WN);    // n-tiles of z per warp
  constexpr int ZJ = D / 32;
  static_assert(NT == 1 || NT % 2 == 0, "h n-tiles go alone or in pairs");
  static_assert(NZ % 2 == 0, "z n-tiles go in pairs");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xn_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = xn_s + BMR * LDX;  // [stage]: W1 slab [D][LDF], W2 [BFC][LDX]
  bf16* a_s = ring + 2 * L::SLAB;  // [BMR][LDF]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * BMR;

  auto load_slab = [&](int c0, int st) {
    bf16* w1s = ring + st * L::SLAB;  // W1[d][c0 + f]
    bf16* w2s = w1s + D * LDF;        // W2[c0 + f][d]
    constexpr int C1 = BFC / 8, C2 = D / 8;
    for (int e = tid; e < D * C1; e += THREADS) {
      const int d = e / C1, c = e % C1;
      cp_async16(w1s + d * LDF + c * 8,
                 w1 + static_cast<size_t>(d) * F + c0 + c * 8, 16);
    }
    for (int e = tid; e < BFC * C2; e += THREADS) {
      const int f = e / C2, c = e % C2;
      cp_async16(w2s + f * LDX + c * 8,
                 w2 + static_cast<size_t>(c0 + f) * D + c * 8, 16);
    }
  };
  load_slab(0, 0);
  cp_async_commit();

  // LN(x) (or x), rounded, zeros past M; warp w does rows w·BMR/8 ...
  for (int rr = 0; rr < BMR / 8; ++rr) {
    const int r = warp * (BMR / 8) + rr;
    const int gi = row0 + r;
    const bool ok = gi < M;
    const size_t base = static_cast<size_t>(ok ? gi : 0) * D;
    float xv[ZJ];
#pragma unroll
    for (int e = 0; e < ZJ; ++e)
      xv[e] = ok ? to_f32(x[base + lane + 32 * e]) : 0.f;
    if (LN) {
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < ZJ; ++e) sum += xv[e];
      const float mean = warp_sum(sum) / D;
      float sq = 0.f;
#pragma unroll
      for (int e = 0; e < ZJ; ++e) {
        xv[e] -= mean;
        sq += xv[e] * xv[e];
      }
      const float inv = rsqrtf(warp_sum(sq) / D + LN_EPS);
#pragma unroll
      for (int e = 0; e < ZJ; ++e) {
        const int d = lane + 32 * e;
        xv[e] = xv[e] * inv * ln_scale[d] + ln_bias[d];
      }
    }
#pragma unroll
    for (int e = 0; e < ZJ; ++e)
      xn_s[r * LDX + lane + 32 * e] = from_f32<bf16>(ok ? xv[e] : 0.f);
  }

  // this lane's fragment rows and their dropout streams
  const int ra = wm * 16 + g;
  const unsigned st0[2] = {drop_stream(seed0, row0 + ra),
                           drop_stream(seed0, row0 + ra + 8)};
  const int nb = wn * NT * 8;  // this warp's first column of a chunk
  const int zc = wn * NZ * 8;  // this warp's first column of z
  float z[NZ][4];
#pragma unroll
  for (int n = 0; n < NZ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[n][e] = 0.f;

  const int chunks = F / BFC;
  for (int ch = 0; ch < chunks; ++ch) {
    const int c0 = ch * BFC;
    const int st = ch & 1;
    cp_async_wait<0>();
    __syncthreads();  // slab ch landed; chunk ch-1's readers are done
    if (ch + 1 < chunks) {
      load_slab(c0 + BFC, st ^ 1);
      cp_async_commit();
    }
    const bf16* w1s = ring + st * L::SLAB;
    const bf16* w2s = w1s + D * LDF;

    // h = LN(x) W1[:, chunk] (W1 slab rows are k: ldmatrix.trans)
    float hacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned ax[4];
      ldmatrix_x4(ax, xn_s + (wm * 16 + (lane & 15)) * LDX + kk * 16 +
                          (lane >> 4) * 8);
      const bf16* p1 = w1s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LDF + nb;
      if constexpr (NT == 1) {
        unsigned bw[2];
        ldmatrix_x2_trans(bw, p1);
        mma_bf16(hacc[0], ax, bw[0], bw[1]);
      } else {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned bw[4];
          ldmatrix_x4_trans(bw, p1 + np * 16 + (lane >> 4) * 8);
          mma_bf16(hacc[2 * np], ax, bw[0], bw[1]);
          mma_bf16(hacc[2 * np + 1], ax, bw[2], bw[3]);
        }
      }
    }
    // a = drop0(act(h + b1)), rounded into the a tile
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = ra + 8 * hr;
        const int c = nb + n * 8 + 2 * t4;
        float av[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = c0 + c + e;
          float a = act_fwd(hacc[n][2 * hr + e] + b1[f], act);
          if (q > 0)
            a = drop_keep(st0[hr], row0 + r, F, f, q) ? a * dscale : 0.f;
          av[e] = a;
        }
        *reinterpret_cast<__nv_bfloat162*>(a_s + r * LDF + c) =
            __floats2bfloat162_rn(av[0], av[1]);
      }
    __syncthreads();  // the a tile is complete

    // z += a W2[chunk, :] (W2 slab rows are k: ldmatrix.trans)
#pragma unroll
    for (int kk = 0; kk < BFC / 16; ++kk) {
      unsigned aa[4];
      ldmatrix_x4(aa, a_s + (wm * 16 + (lane & 15)) * LDF + kk * 16 +
                          (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NZ / 2; ++np) {
        unsigned bw[4];
        ldmatrix_x4_trans(bw, w2s + (kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * LDX +
                                  zc + np * 16 + (lane >> 4) * 8);
        mma_bf16(z[2 * np], aa, bw[0], bw[1]);
        mma_bf16(z[2 * np + 1], aa, bw[2], bw[3]);
      }
    }
  }

  // y = z + b2, or with LN x + s·drop1(z + b2); rounded once
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int gi = row0 + ra + 8 * hr;
    if (gi >= M) continue;
    const unsigned st1 = drop_stream(seed1, gi);
    const size_t base = static_cast<size_t>(gi) * D;
#pragma unroll
    for (int n = 0; n < NZ; ++n) {
      const int c = zc + n * 8 + 2 * t4;
      float out[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float zz = z[n][2 * hr + e] + b2[c + e];
        if (LN) {
          if (q > 0) zz = drop_keep(st1, gi, D, c + e, q) ? zz * dscale : 0.f;
          zz = to_f32(x[base + c + e]) + res_scale * zz;
        }
        out[e] = zz;
      }
      *reinterpret_cast<__nv_bfloat162*>(y + base + c) =
          __floats2bfloat162_rn(out[0], out[1]);
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// out (groups, K, N) float32: the sums of A^T B over groups of
// rows_per_group rows, on tensor cores (`atb_tc_kernel`; A, B bf16, 16-byte
// aligned; K, N multiples of TC_TILE).
inline int launch_atb_tc(const bf16* a, const bf16* b, float* out, int M,
                         int K, int N, int groups, int rows_per_group,
                         cudaStream_t stream) {
  auto kernel = atb_tc_kernel<bf16>;
  constexpr size_t smem = atb_tc_smem_bytes();
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<dim3(N / TC_TILE, K / TC_TILE, groups), THREADS, smem, stream>>>(
      a, b, out, M, K, N, rows_per_group);
  return static_cast<int>(cudaGetLastError());
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

// The bf16 forward on tensor cores; x, w1 and w2 16-byte aligned.
template <int D, bool LN>
int launch_fwd_tc(const void* x, const float* ln_scale, const float* ln_bias,
                  const void* w1, const float* b1, const void* w2,
                  const float* b2, void* y, int M, int F, float res_scale,
                  int act, Drop dr, cudaStream_t stream) {
  auto kernel = ffn_fwd_tc_kernel<D, LN>;
  const size_t smem = TcFwd<D>::bytes;
  if (int err = set_smem(kernel, smem)) return err;
  constexpr int BMR = TcFwd<D>::BMR;
  kernel<<<(M + BMR - 1) / BMR, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), ln_scale, ln_bias,
      static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2,
      static_cast<bf16*>(y), M, F, res_scale, act, dr.q, dr.scale, dr.seed0,
      dr.seed1);
  return static_cast<int>(cudaGetLastError());
}

// With LN, xn_buf and dz_buf receive the rounded LN(x) and dz for the
// weight-gradient kernel; without LN they are null and it reads x and gy.
template <typename T, int D, bool LN>
int launch_bwd(const void* x, const float* ln_scale, const float* ln_bias,
               const void* w1, const float* b1, const void* w2,
               const void* gy, void* dx, void* xn_buf, void* dz_buf,
               float* partial, float* dw1p, float* dw2p, float* db1p, int M,
               int F, int groups, int rows_per_group, float res_scale,
               int act, Drop dr, cudaStream_t stream) {
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
  k2<<<dim3(F / BF2, groups), THREADS, smem2, stream>>>(
      static_cast<const T*>(LN ? xn_buf : x),
      static_cast<const T*>(LN ? dz_buf : gy), static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), dw1p, dw2p, db1p, M, F, rows_per_group, act,
      dr.q, dr.scale, dr.seed0);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 backward on tensor cores. With LN, xn_buf and dz_buf receive the
// rounded LN(x) and dz; without LN they are null and the A^T B kernel reads
// x and gy. a_buf and dh_buf receive a and dh (M x F); partial (row blocks,
// NP, D) and db1p (row blocks, F) the row blocks' sums; dw1p (groups, D, F)
// and dw2p (groups, F, D) the row groups' sums of rows_per_group rows each.
template <int D, bool LN>
int launch_bwd_tc(const void* x, const float* ln_scale, const float* ln_bias,
                  const void* w1, const float* b1, const void* w2,
                  const void* gy, void* dx, void* xn_buf, void* dz_buf,
                  void* a_buf, void* dh_buf, float* partial, float* dw1p,
                  float* dw2p, float* db1p, int M, int F, int groups,
                  int rows_per_group, float res_scale, int act, Drop dr,
                  cudaStream_t stream) {
  static_assert(BF % TC_TILE == 0 && D % TC_TILE == 0,
                "options_ok's multiple of F covers the A^T B tiles");
  auto k1 = ffn_bwd_rows_tc_kernel<D, LN>;
  const size_t smem1 = TcRows<D>::bytes;
  if (int err = set_smem(k1, smem1)) return err;
  constexpr int BMR = TcRows<D>::BMR;
  k1<<<(M + BMR - 1) / BMR, THREADS, smem1, stream>>>(
      static_cast<const bf16*>(x), ln_scale, ln_bias,
      static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2),
      static_cast<const bf16*>(gy), static_cast<bf16*>(dx),
      static_cast<bf16*>(xn_buf), static_cast<bf16*>(dz_buf),
      static_cast<bf16*>(a_buf), static_cast<bf16*>(dh_buf), partial, db1p, M,
      F, res_scale, act, dr.q, dr.scale, dr.seed0, dr.seed1);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  const bf16* xa = static_cast<const bf16*>(LN ? xn_buf : x);
  const bf16* dzb = static_cast<const bf16*>(LN ? dz_buf : gy);
  // dW1 = LN(x)^T dh: (D, F); dW2 = a^T dz: (F, D)
  if (int err = launch_atb_tc(xa, static_cast<const bf16*>(dh_buf), dw1p, M,
                              D, F, groups, rows_per_group, stream))
    return err;
  return launch_atb_tc(static_cast<const bf16*>(a_buf), dzb, dw2p, M, F, D,
                       groups, rows_per_group, stream);
}

bool options_ok(int M, int F, int act, int q) {
  return M >= 1 && F >= BF && F % BF == 0 && (act == kSwish || act == kRelu) &&
         q >= 0 && q <= 255;
}

}  // namespace
}  // namespace espnet_port
