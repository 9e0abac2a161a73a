// The whole conformer conv sub-block, forward and backward:
//
//   y = x + drop(PW2(swish(LN2(DW(mask * GLU(PW1(LN1(x))))))))
//
// with PW1 (D, 2D), a SAME depthwise conv over time of odd kernel size k
// (taps (k, D) in x's dtype, bias (D,)) and PW2 (D, D). It replaces the
// Pallas `_conv_fwd_kernel` and `_conv_bwd_kernel` behind `fused_conv_module`
// (espnet_tpu/ops/pallas_conv_module.py). As there: LN eps 1e-6, LN1(x) and
// swish(LN2(c)) rounded to x's dtype before their products, the GLU output u
// and the depthwise conv in float32, frames past an utterance's length
// computed (u is zeroed there by the mask), and dropout from the hash whose
// tile is one utterance (stream id from the seed and the utterance index b,
// counter t * D + c), regenerated in the backward.
//
// What bounds it on an H100: at the bench's B = 64, T = 469, D = 256, k =
// 31 in bf16 the forward does 12.3 GFLOP (PW1 7.9, PW2 3.9, the depthwise
// conv 0.48) against 30.7 MB (x read, y written, the weights): bound by
// the operations at the bf16 tensor-core rate (12.4 µs). This first
// version's products are float32 FMAs on the CUDA cores (67 TFLOP/s).
//
// What the design does about it, and why it is not the TPU's grid:
// * The TPU keeps one utterance's (T, D) in VMEM, one program per
//   utterance. On the card that is (472, 256) float32 = 483 KB per
//   activation, twice the 227 KB of shared memory a block may have, and 64
//   blocks (one an utterance) would fill under half of the 132 SMs. So a
//   block owns TT = 32 frames of one utterance (grid ceil(T/32) x B: 15 x 64
//   = 960 blocks at the bench shape, some 7 waves at one block an SM), and
//   the only coupling across time, the depthwise conv, is met with a halo:
//   the forward recomputes the head (LN1, PW1, GLU, mask) for its frames
//   and p = (k-1)/2 on each side (62 rows at k = 31, 1.9x the head's
//   products), keeps u in shared memory, and runs the conv, LN2, swish,
//   PW2, dropout and residual on its own 32 frames. Only x and y touch
//   device memory.
// * The backward would need u over the tile +- 2p and dc over the tile +- p
//   in one block (the head recomputed for 94 rows, the tail's backward for
//   62). Instead it runs as two kernels over the same 960 tiles with the
//   tile's own frames exchanged through device memory: kernel A recomputes
//   the head with the p-row halo, the conv, LN2 and swish, takes dz =
//   drop(dy) through PW2's and swish's and LN2's backward and writes u and
//   dc (float32), the rounded swish output and dz (for dW2), and per-block
//   partial sums of dLN2, ddb and db2; kernel B reads dc and u around its
//   frames for du (the conv's input gradient) and the per-block tap
//   gradients, recomputes the head for its own frames only, takes du
//   through the mask, the GLU, PW1 and LN1's backward, adds the residual's
//   dy, and writes dx, the rounded LN1(x) and dh (for dW1) and partial sums
//   of dLN1 and db1. Then dW1 and dW2 are A^T B over groups of frames
//   (`atb_kernel`). Every cross-block sum is a per-block partial added
//   afterwards, no atomics: at the bench shape 960 blocks x (8 + k) x D
//   floats = 38 MB of partials for the vectors and taps, and 16 groups x 3
//   D^2 floats = 12.6 MB for the weights.
// * D runs to DP, a multiple of 128 (instantiated 128, 256, 384, 512), with
//   the columns past D zero: the route has no shape gate in the JAX package,
//   so d 144 runs here too. k runs to 31 (the halo's 64 rows); past that
//   the wrapper raises. Shared memory at DP = 512: 213 KB (forward, kernel
//   A), 164 KB (kernel B).
#include "ffn_kernels.cuh"

namespace espnet_port {
namespace {

constexpr int TT = 32;    // frames a block owns
constexpr int PMAX = 15;  // the halo of the longest kernel, k = 31
constexpr int HR = 64;    // halo rows held: TT + 2 PMAX, in 32-row sub-tiles
static_assert(TT == BM && TT + 2 * PMAX <= HR && HR % BM == 0,
              "the head runs in BM-row sub-tiles");
static_assert(2 * BF == THREADS, "the db1 sums take one thread a column");

// u = mask * GLU(LN1(x) W1 + b1) of frames t_first .. t_first + nrows - 1 of
// utterance b into u_s (HR x DP float32, row r = frame t_first + r); zero
// for frames outside [0, T) (the conv's padding), rows past nrows and
// columns past D.
template <typename E, int DP>
__device__ __forceinline__ void head_rows(
    const E* __restrict__ x, const float* __restrict__ mask,
    const float* __restrict__ ln1s, const float* __restrict__ ln1b,
    const E* __restrict__ w1, const float* __restrict__ b1, int b, int T,
    int D, int t_first, int nrows, float* xn_s, float* w_s, float* u_s) {
  constexpr int LDX = DP + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = 0; r0 < nrows; r0 += BM) {
    __syncthreads();  // the previous sub-tile's readers of xn_s are done
    for (int rr = 0; rr < BM / 8; ++rr) {
      const int r = warp * (BM / 8) + rr;
      const int t = t_first + r0 + r;
      const bool ok = r0 + r < nrows && t >= 0 && t < T;
      float mean, inv;
      ln_row<E, E, DP, false>(
          x + (static_cast<size_t>(b) * T + (ok ? t : 0)) * D, D, ok, ln1s,
          ln1b, xn_s + r * LDX, mean, inv);
    }
    for (int c0 = 0; c0 < D; c0 += BF) {
      const int nc = min(BF, D - c0);
      float ha[4][4] = {}, hg[4][4] = {};
      tile_product<E, 4, false>(xn_s, LDX, w1 + c0, 2 * D, D, nc, w_s, ha);
      tile_product<E, 4, false>(xn_s, LDX, w1 + D + c0, 2 * D, D, nc, w_s,
                                hg);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int r = r0 + warp + 8 * ii;
        const int t = t_first + r;
        const bool ok = r < nrows && t >= 0 && t < T;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int f = c0 + lane + 32 * jj;
          float u = 0.f;
          if (ok && f < D)
            u = (ha[ii][jj] + b1[f]) * sigmoidf(hg[ii][jj] + b1[D + f]) *
                mask[static_cast<size_t>(b) * T + t];
          u_s[r * DP + f] = u;
        }
      }
    }
  }
}

// c = DW(u) + db for the block's TT frames into c_s (TT x (DP+1)), from u_s
// (the frames from t0 - p on); zero past column D. Taps in ascending order
// from a float32 zero, the bias last, as the Pallas `_depthwise`.
template <typename E, int DP>
__device__ __forceinline__ void depthwise_rows(const float* u_s,
                                               const E* __restrict__ dw,
                                               const float* __restrict__ db,
                                               int D, int K, float* c_s) {
  for (int e = threadIdx.x; e < TT * DP; e += THREADS) {
    const int r = e / DP, ch = e % DP;
    float v = 0.f;
    if (ch < D) {
      float acc = 0.f;
      for (int j = 0; j < K; ++j)
        acc += u_s[(r + j) * DP + ch] * to_f32(dw[j * D + ch]);
      v = acc + db[ch];
    }
    c_s[r * (DP + 1) + ch] = v;
  }
}

// LN2 of the block's frames from c_s into dst (swish, rounded to the
// element type E), with each frame's mean and 1/std.
template <typename E, int DP>
__device__ __forceinline__ void ln2_swish_rows(
    const float* c_s, const float* __restrict__ ln2s,
    const float* __restrict__ ln2b, int D, float* dst, float* mean_s,
    float* inv_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = 0; rr < TT / 8; ++rr) {
    const int r = warp * (TT / 8) + rr;
    float mean, inv;
    ln_row<float, E, DP, true>(c_s + r * (DP + 1), D, true, ln2s, ln2b,
                               dst + r * (DP + 1), mean, inv);
    if (mean_s != nullptr && lane == 0) {
      mean_s[r] = mean;
      inv_s[r] = inv;
    }
  }
}

template <int DP>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (HR * DP + TT * (DP + 1) + KS * BF);
}

template <typename E, int DP>
__global__ void __launch_bounds__(THREADS)
    conv_fwd_kernel(const E* __restrict__ x, const float* __restrict__ mask,
                    const float* __restrict__ ln1s,
                    const float* __restrict__ ln1b, const E* __restrict__ w1,
                    const float* __restrict__ b1, const E* __restrict__ dw,
                    const float* __restrict__ db,
                    const float* __restrict__ ln2s,
                    const float* __restrict__ ln2b, const E* __restrict__ w2,
                    const float* __restrict__ b2, E* __restrict__ y, int T,
                    int D, int K, int q, float dscale, int seed) {
  constexpr int LDX = DP + 1;
  extern __shared__ float smem[];
  float* u_s = smem;
  float* c_s = u_s + HR * DP;  // LN1 rows during the head, then c, then s
  float* w_s = c_s + TT * LDX;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, t0 = blockIdx.x * TT, p = (K - 1) / 2;

  head_rows<E, DP>(x, mask, ln1s, ln1b, w1, b1, b, T, D, t0 - p, TT + 2 * p,
                   c_s, w_s, u_s);
  __syncthreads();
  depthwise_rows<E, DP>(u_s, dw, db, D, K, c_s);
  __syncthreads();
  ln2_swish_rows<E, DP>(c_s, ln2s, ln2b, D, c_s, nullptr, nullptr);
  const unsigned st = tile_stream(seed, b);
  for (int n0 = 0; n0 < D; n0 += BF) {
    float z[4][4] = {};
    tile_product<E, 4, false>(c_s, LDX, w2 + n0, D, D, min(BF, D - n0), w_s,
                              z);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int t = t0 + warp + 8 * ii;
      if (t >= T) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = n0 + lane + 32 * jj;
        if (n >= D) continue;
        float zz = z[ii][jj] + b2[n];
        if (q > 0)
          zz = keep_counter(st, static_cast<unsigned>(t) * D + n, q)
                   ? zz * dscale
                   : 0.f;
        const size_t e = (static_cast<size_t>(b) * T + t) * D + n;
        y[e] = from_f32<E>(to_f32(x[e]) + zz);
      }
    }
  }
}

template <int DP>
constexpr size_t bwd_a_smem_bytes() {
  // u with its halo, later dz and dcn; LN1 rows, later c; the transposed
  // 128-column weight slab; LN2's mean and 1/std
  return sizeof(float) *
         ((HR * DP > 2 * TT * (DP + 1) ? HR * DP : 2 * TT * (DP + 1)) +
          TT * (DP + 1) + KS * (BF + 1) + 2 * TT);
}

// Backward, kernel A: from the head (with its halo) to dc. Writes u and dc
// (float32) and the rounded swish output and dz of the block's frames, and
// part[tile] = (dLN2 scale, dLN2 bias, ddb, db2) as 4 x D floats.
template <typename E, int DP>
__global__ void __launch_bounds__(THREADS)
    conv_bwd_a_kernel(const E* __restrict__ x, const float* __restrict__ mask,
                      const float* __restrict__ ln1s,
                      const float* __restrict__ ln1b,
                      const E* __restrict__ w1, const float* __restrict__ b1,
                      const E* __restrict__ dw, const float* __restrict__ db,
                      const float* __restrict__ ln2s,
                      const float* __restrict__ ln2b,
                      const E* __restrict__ w2, const E* __restrict__ gy,
                      float* __restrict__ u_buf, float* __restrict__ dc_buf,
                      E* __restrict__ s_buf, E* __restrict__ dz_buf,
                      float* __restrict__ part, int T, int D, int K, int q,
                      float dscale, int seed) {
  constexpr int LDX = DP + 1;
  constexpr int ZJ = DP / 32;
  extern __shared__ float smem[];
  float* region = smem;  // u_s (HR x DP), then dz_s and dcn_s
  float* c_s = region + (HR * DP > 2 * TT * LDX ? HR * DP : 2 * TT * LDX);
  float* w_s = c_s + TT * LDX;
  float* mean_s = w_s + KS * (BF + 1);
  float* inv_s = mean_s + TT;
  float* u_s = region;
  float* dz_s = region;
  float* dcn_s = region + TT * LDX;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, t0 = blockIdx.x * TT, p = (K - 1) / 2;
  const size_t row0 = static_cast<size_t>(b) * T + t0;  // the tile's frame 0

  head_rows<E, DP>(x, mask, ln1s, ln1b, w1, b1, b, T, D, t0 - p, TT + 2 * p,
                   c_s, w_s, u_s);
  __syncthreads();
  for (int e = tid; e < TT * DP; e += THREADS) {
    const int r = e / DP, ch = e % DP;
    if (t0 + r < T && ch < D)
      u_buf[(row0 + r) * D + ch] = u_s[(r + p) * DP + ch];
  }
  depthwise_rows<E, DP>(u_s, dw, db, D, K, c_s);
  __syncthreads();  // u_s is read for the last time above
  ln2_swish_rows<E, DP>(c_s, ln2s, ln2b, D, dcn_s, mean_s, inv_s);

  float sums[4][ZJ] = {};  // dLN2 scale, dLN2 bias, ddb, db2
  const unsigned st = tile_stream(seed, b);
  for (int rr = 0; rr < TT / 8; ++rr) {
    const int r = warp * (TT / 8) + rr;  // the rows this warp normalised
    const bool ok = t0 + r < T;
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      const bool in = ok && d < D;
      const size_t o = (row0 + r) * D + d;
      if (in) s_buf[o] = from_f32<E>(dcn_s[r * LDX + d]);
      float v = 0.f;
      if (in) {
        v = to_f32(gy[o]);
        if (q > 0)
          v = keep_counter(st, static_cast<unsigned>(t0 + r) * D + d, q)
                  ? v * dscale
                  : 0.f;
        sums[3][e] += v;
      }
      const float vb = round_to<E>(v);
      dz_s[r * LDX + d] = vb;
      if (in) dz_buf[o] = from_f32<E>(vb);
    }
  }
  // ds = dz W2^T by 128-column chunks, then dcn = ds * swish'(LN2(c))
  for (int n0 = 0; n0 < D; n0 += BF) {
    float ds[4][4] = {};
    tile_product<E, 4, true>(dz_s, LDX, w2 + static_cast<size_t>(n0) * D, D,
                             D, min(BF, D - n0), w_s, ds);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = warp + 8 * ii;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = n0 + lane + 32 * jj;
        float v = 0.f;
        if (n < D) {
          const float cn =
              (c_s[r * LDX + n] - mean_s[r]) * inv_s[r] * ln2s[n] + ln2b[n];
          const float sg = sigmoidf(cn);
          v = ds[ii][jj] * (sg * (1.f + cn * (1.f - sg)));
        }
        dcn_s[r * LDX + n] = v;
      }
    }
  }
  __syncthreads();
  // LN2 backward per frame (frames past T: dz = 0, so dc = 0)
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = warp + 8 * ii;
    const float mean = mean_s[r], inv = inv_s[r];
    float xh[ZJ], dcn[ZJ], dc[ZJ];
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      xh[e] = d < D ? (c_s[r * LDX + d] - mean) * inv : 0.f;
      dcn[e] = dcn_s[r * LDX + d];
    }
    ln_bwd_row<ZJ>(dcn, xh, ln2s, inv, D, dc, sums[0], sums[1]);
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      if (d >= D) continue;
      sums[2][e] += dc[e];
      if (t0 + r < T) dc_buf[(row0 + r) * D + d] = dc[e];
    }
  }
  store_block_sums<4, ZJ>(
      sums, region,
      part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 4 * D, D);
}

template <int DP>
constexpr size_t bwd_b_smem_bytes() {
  // LN1 rows, the dh chunk, the weight slab (the transposed one is the
  // widest), LN1's mean and 1/std
  return sizeof(float) *
         (TT * (DP + 1) + TT * (2 * BF + 1) + KS * (DP + 1) + 2 * TT);
}

// Backward, kernel B: from dc to dx. Writes dx, the rounded LN1(x) and dh
// of the block's frames, the tap gradients ddwp[tile] (K x D) and part[tile]
// = (dLN1 scale, dLN1 bias, db1 (2D)) as 4 x D floats.
template <typename E, int DP>
__global__ void __launch_bounds__(THREADS)
    conv_bwd_b_kernel(const E* __restrict__ x, const float* __restrict__ mask,
                      const float* __restrict__ ln1s,
                      const float* __restrict__ ln1b,
                      const E* __restrict__ w1, const float* __restrict__ b1,
                      const E* __restrict__ dw, const E* __restrict__ gy,
                      const float* __restrict__ u_buf,
                      const float* __restrict__ dc_buf, E* __restrict__ dx,
                      E* __restrict__ xn_buf, E* __restrict__ dh_buf,
                      float* __restrict__ part, float* __restrict__ ddwp,
                      int T, int D, int K) {
  constexpr int LDX = DP + 1;
  constexpr int LDH = 2 * BF + 1;
  constexpr int ZJ = DP / 32;
  extern __shared__ float smem[];
  float* xn_s = smem;
  float* dh_s = xn_s + TT * LDX;
  float* w_s = dh_s + TT * LDH;
  float* mean_s = w_s + KS * (DP + 1);
  float* inv_s = mean_s + TT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, t0 = blockIdx.x * TT, p = (K - 1) / 2;
  const size_t utt = static_cast<size_t>(b) * T;  // the utterance's frame 0
  const size_t tile = static_cast<size_t>(b) * gridDim.x + blockIdx.x;
  float* pt = part + tile * 4 * D;

  // tap gradients: ddw[j][ch] = sum over the tile's frames t of
  // u[t - p + j][ch] dc[t][ch] (u is 0 outside [0, T))
  for (int e = tid; e < K * D; e += THREADS) {
    const int j = e / D, ch = e % D;
    float acc = 0.f;
    for (int r = 0; r < TT && t0 + r < T; ++r) {
      const int ts = t0 + r - p + j;
      if (ts >= 0 && ts < T)
        acc += u_buf[(utt + ts) * D + ch] * dc_buf[(utt + t0 + r) * D + ch];
    }
    ddwp[(tile * K + j) * D + ch] = acc;
  }
  // LN1 of the tile's frames
  for (int rr = 0; rr < TT / 8; ++rr) {
    const int r = warp * (TT / 8) + rr;
    const bool ok = t0 + r < T;
    float mean, inv;
    ln_row<E, E, DP, false>(x + (utt + (ok ? t0 + r : 0)) * D, D, ok, ln1s,
                            ln1b, xn_s + r * LDX, mean, inv);
    if (lane == 0) {
      mean_s[r] = mean;
      inv_s[r] = inv;
    }
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      if (ok && d < D)
        xn_buf[(utt + t0 + r) * D + d] = from_f32<E>(xn_s[r * LDX + d]);
    }
  }

  float z[4][ZJ] = {};  // d LN1(x)
  for (int c0 = 0; c0 < D; c0 += BF) {
    const int nc = min(BF, D - c0);
    float ha[4][4] = {}, hg[4][4] = {};
    tile_product<E, 4, false>(xn_s, LDX, w1 + c0, 2 * D, D, nc, w_s, ha);
    tile_product<E, 4, false>(xn_s, LDX, w1 + D + c0, 2 * D, D, nc, w_s, hg);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = warp + 8 * ii;
      const int t = t0 + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cc = lane + 32 * jj, f = c0 + cc;
        float da = 0.f, dgg = 0.f;
        if (t < T && f < D) {
          // du = the conv's input gradient (the flipped taps), masked
          float du = 0.f;
          for (int j = 0; j < K; ++j) {
            const int ts = t + p - j;
            if (ts >= 0 && ts < T)
              du += dc_buf[(utt + ts) * D + f] * to_f32(dw[j * D + f]);
          }
          du *= mask[utt + t];
          const float a = ha[ii][jj] + b1[f];
          const float sg = sigmoidf(hg[ii][jj] + b1[D + f]);
          da = du * sg;
          dgg = du * a * sg * (1.f - sg);
        }
        dh_s[r * LDH + cc] = da;
        dh_s[r * LDH + BF + cc] = dgg;
      }
    }
    __syncthreads();
    {  // db1 over the tile's frames, from the unrounded dh
      const int cc = tid % BF;
      float s = 0.f;
      for (int r = 0; r < TT; ++r) s += dh_s[r * LDH + tid];
      if (cc < nc) pt[2 * D + (tid < BF ? c0 + cc : D + c0 + cc)] = s;
    }
    __syncthreads();
    for (int e = tid; e < TT * 2 * BF; e += THREADS) {
      const int r = e / (2 * BF), c = e % (2 * BF);
      const float v = round_to<E>(dh_s[r * LDH + c]);
      dh_s[r * LDH + c] = v;
      const int cc = c % BF;
      if (t0 + r < T && cc < nc)
        dh_buf[(utt + t0 + r) * 2 * D + (c < BF ? c0 + cc : D + c0 + cc)] =
            from_f32<E>(v);
    }
    tile_product<E, ZJ, true>(dh_s, LDH, w1 + c0, 2 * D, nc, D, w_s, z);
    tile_product<E, ZJ, true>(dh_s + BF, LDH, w1 + D + c0, 2 * D, nc, D, w_s,
                              z);
  }

  float sums[2][ZJ] = {};  // dLN1 scale, dLN1 bias
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = warp + 8 * ii;
    const int t = t0 + r;
    if (t >= T) continue;  // uniform across the warp
    const float mean = mean_s[r], inv = inv_s[r];
    float xh[ZJ], dxl[ZJ];
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      xh[e] = d < D ? (to_f32(x[(utt + t) * D + d]) - mean) * inv : 0.f;
    }
    ln_bwd_row<ZJ>(z[ii], xh, ln1s, inv, D, dxl, sums[0], sums[1]);
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      if (d >= D) continue;
      const size_t o = (utt + t) * D + d;
      dx[o] = from_f32<E>(to_f32(gy[o]) + dxl[e]);
    }
  }
  store_block_sums<2, ZJ>(sums, xn_s, pt, D);
}

struct Params {
  const float *ln1s, *ln1b;
  const void* w1;
  const float* b1;
  const void* dw;
  const float* db;
  const float *ln2s, *ln2b;
  const void* w2;
};

template <typename E, int DP>
int module_fwd(const void* x, const float* mask, Params pr, const float* b2,
               void* y, int B, int T, int D, int K, int q, float dscale,
               int seed, cudaStream_t s) {
  auto k = conv_fwd_kernel<E, DP>;
  const size_t smem = fwd_smem_bytes<DP>();
  if (int err = set_smem(k, smem)) return err;
  k<<<dim3((T + TT - 1) / TT, B), THREADS, smem, s>>>(
      static_cast<const E*>(x), mask, pr.ln1s, pr.ln1b,
      static_cast<const E*>(pr.w1), pr.b1, static_cast<const E*>(pr.dw),
      pr.db, pr.ln2s, pr.ln2b, static_cast<const E*>(pr.w2), b2,
      static_cast<E*>(y), T, D, K, q, dscale, seed);
  return static_cast<int>(cudaGetLastError());
}

struct Buffers {
  float *u, *dc;
  void *s, *dz, *xn, *dh;
  float *part_a, *part_b, *ddwp, *dw1p, *dw2p;
};

template <typename E, int DP>
int module_bwd(const void* x, const float* mask, Params pr, const void* gy,
               void* dx, Buffers bf, int B, int T, int D, int K, int g1,
               int g2, int q, float dscale, int seed, cudaStream_t s) {
  const dim3 grid((T + TT - 1) / TT, B);
  auto ka = conv_bwd_a_kernel<E, DP>;
  const size_t smem_a = bwd_a_smem_bytes<DP>();
  if (int err = set_smem(ka, smem_a)) return err;
  ka<<<grid, THREADS, smem_a, s>>>(
      static_cast<const E*>(x), mask, pr.ln1s, pr.ln1b,
      static_cast<const E*>(pr.w1), pr.b1, static_cast<const E*>(pr.dw),
      pr.db, pr.ln2s, pr.ln2b, static_cast<const E*>(pr.w2),
      static_cast<const E*>(gy), bf.u, bf.dc, static_cast<E*>(bf.s),
      static_cast<E*>(bf.dz), bf.part_a, T, D, K, q, dscale, seed);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  auto kb = conv_bwd_b_kernel<E, DP>;
  const size_t smem_b = bwd_b_smem_bytes<DP>();
  if (int err = set_smem(kb, smem_b)) return err;
  kb<<<grid, THREADS, smem_b, s>>>(
      static_cast<const E*>(x), mask, pr.ln1s, pr.ln1b,
      static_cast<const E*>(pr.w1), pr.b1, static_cast<const E*>(pr.dw),
      static_cast<const E*>(gy), bf.u, bf.dc, static_cast<E*>(dx),
      static_cast<E*>(bf.xn), static_cast<E*>(bf.dh), bf.part_b, bf.ddwp, T,
      D, K);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  const int M = B * T;
  if (int err = launch_atb<E>(static_cast<const E*>(bf.xn),
                              static_cast<const E*>(bf.dh), bf.dw1p, M, D,
                              2 * D, g1, s))
    return err;
  return launch_atb<E>(static_cast<const E*>(bf.s),
                       static_cast<const E*>(bf.dz), bf.dw2p, M, D, D, g2, s);
}

bool shape_ok(int B, int T, int D, int K) {
  return B >= 1 && T >= 1 && D >= 1 && D <= 512 && K >= 1 && K % 2 == 1 &&
         K <= 2 * PMAX + 1;
}

}  // namespace
}  // namespace espnet_port

// Dispatch on dtype and DP = D rounded up to a multiple of 128.
#define ESPNET_CONV_MODULE_DISPATCH(FN, ...)                                 \
  do {                                                                       \
    const int dp = (D + 127) / 128 * 128;                                    \
    if (dtype == kFloat32 && dp == 128) return FN<float, 128>(__VA_ARGS__);  \
    if (dtype == kFloat32 && dp == 256) return FN<float, 256>(__VA_ARGS__);  \
    if (dtype == kFloat32 && dp == 384) return FN<float, 384>(__VA_ARGS__);  \
    if (dtype == kFloat32 && dp == 512) return FN<float, 512>(__VA_ARGS__);  \
    if (dtype == kBFloat16 && dp == 128)                                     \
      return FN<__nv_bfloat16, 128>(__VA_ARGS__);                            \
    if (dtype == kBFloat16 && dp == 256)                                     \
      return FN<__nv_bfloat16, 256>(__VA_ARGS__);                            \
    if (dtype == kBFloat16 && dp == 384)                                     \
      return FN<__nv_bfloat16, 384>(__VA_ARGS__);                            \
    if (dtype == kBFloat16 && dp == 512)                                     \
      return FN<__nv_bfloat16, 512>(__VA_ARGS__);                            \
    return kUnsupported;                                                     \
  } while (0)

// x, y: (B, T, D); w1 (D, 2D), dw (K, D), w2 (D, D), all of one dtype,
// contiguous; mask (B, T) float32 (1 = valid); ln1s, ln1b, db, ln2s, ln2b,
// b2 (D,) and b1 (2D,) float32. D <= 512, K odd <= 31. q: dropout level in
// 1/256 (0 = none), dscale its keep scale 256 / (256 - q), seed the hash's
// int32 seed (tile = utterance).
extern "C" int espnet_conv_module_fwd(
    const void* x, const float* mask, const float* ln1s, const float* ln1b,
    const void* w1, const float* b1, const void* dw, const float* db,
    const float* ln2s, const float* ln2b, const void* w2, const float* b2,
    void* y, int B, int T, int D, int K, int q, float dscale, int seed,
    int dtype, void* stream) {
  using namespace espnet_port;
  if (!shape_ok(B, T, D, K) || q < 0 || q > 255) return kUnsupported;
  const Params pr{ln1s, ln1b, w1, b1, dw, db, ln2s, ln2b, w2};
  ESPNET_CONV_MODULE_DISPATCH(module_fwd, x, mask, pr, b2, y, B, T, D, K, q,
                              dscale, seed,
                              static_cast<cudaStream_t>(stream));
}

// Backward of espnet_conv_module_fwd (same inputs and options) for gy (B, T,
// D, x's dtype): dx (B, T, D); scratch u_buf, dc_buf (B*T, D) float32 and
// s_buf, dz_buf, xn_buf (B*T, D), dh_buf (B*T, 2D) in x's dtype; per tile of
// 32 frames (B * ceil(T/32) tiles) part_a (4, D) = (dLN2 scale, dLN2 bias,
// ddb, db2), part_b (4, D) = (dLN1 scale, dLN1 bias, db1 (2D)) and ddwp (K,
// D); dw1p (g1, D, 2D) and dw2p (g2, D, D) per group of frames; all
// float32 partial sums.
extern "C" int espnet_conv_module_bwd(
    const void* x, const float* mask, const float* ln1s, const float* ln1b,
    const void* w1, const float* b1, const void* dw, const float* db,
    const float* ln2s, const float* ln2b, const void* w2, const void* gy,
    void* dx, float* u_buf, float* dc_buf, void* s_buf, void* dz_buf,
    void* xn_buf, void* dh_buf, float* part_a, float* part_b, float* ddwp,
    float* dw1p, float* dw2p, int B, int T, int D, int K, int g1, int g2,
    int q, float dscale, int seed, int dtype, void* stream) {
  using namespace espnet_port;
  if (!shape_ok(B, T, D, K) || g1 < 1 || g2 < 1 || q < 0 || q > 255)
    return kUnsupported;
  const Params pr{ln1s, ln1b, w1, b1, dw, db, ln2s, ln2b, w2};
  const Buffers bf{u_buf, dc_buf, s_buf, dz_buf, xn_buf, dh_buf,
                   part_a, part_b, ddwp, dw1p, dw2p};
  ESPNET_CONV_MODULE_DISPATCH(module_bwd, x, mask, pr, gy, dx, bf, B, T, D,
                              K, g1, g2, q, dscale, seed,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int espnet_conv_module_tile_rows() { return espnet_port::TT; }
