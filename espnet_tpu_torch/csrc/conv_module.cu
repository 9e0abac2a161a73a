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
// the operations at the bf16 tensor-core rate (12.4 µs). The backward's
// gradients are 33 µs of tensor-core work by the same count.
//
// Why the TPU's grid does not carry over: the TPU keeps one utterance's
// (T, D) in VMEM, one program per utterance. On the card that is (472, 256)
// float32 = 483 KB per activation, twice the 227 KB of shared memory a block
// may have, and 64 blocks (one an utterance) would fill under half of the
// 132 SMs. So a block owns TT frames of one utterance, and the only coupling
// across time, the depthwise conv, is met with a halo: the head (LN1, PW1,
// GLU, mask) is recomputed for the tile's frames and p = (k-1)/2 on each
// side. Only x and y touch device memory in the forward. Every cross-block
// sum is a per-block partial added afterwards, in a fixed order, no atomics.
//
// Two designs, picked by dtype at the entry points:
//
// * float32, the parity mode (the 1e-4 checks): the first design, float32
//   FMAs on the CUDA cores (`tile_product`; tensor-core float32 would be
//   TF32). A block owns 32 frames and recomputes the head for 64 rows (2.0x
//   PW1's products at k = 31); the backward is kernel A (head with halo,
//   conv, LN2, swish, PW2's and swish's and LN2's backward; writes u and dc
//   as float32, the rounded swish output and dz, partials of dLN2, ddb, db2)
//   and kernel B (reads dc and u around its frames from device memory for du
//   and the tap gradients, recomputes the head for its own frames, the mask,
//   GLU, PW1 and LN1 backward; writes dx, the rounded LN1(x) and dh,
//   partials of dLN1 and db1), then dW1 and dW2 on `atb_kernel`.
//
// * bf16, on tensor cores (mma.sync m16n8k16 with bf16 operands and float32
//   sums, ldmatrix fragments from shared memory rows padded by 16 bytes, and
//   one three-stage cp.async ring of 10 KB weight slabs that every product
//   of a kernel walks in a fixed job order, so the next slabs load while
//   the current one computes, also across the phases between the products).
//   mma.sync rather than wgmma because the GLU, the mask, the hash and the
//   rounding points sit on the fragments between the products. The weights
//   come padded to DP = D rounded up to 128 (w1 (DP, 2DP) with the g half at
//   column DP, w2 (DP, DP), zeros past D; the wrapper pads them when D <
//   DP), and so do the scratch buffers, so every slab and every weight
//   gradient is whole 128-wide tiles. A block owns TT = 64 frames at DP <=
//   256 and 32 above (`TcConv`), 8 warps in 2 rows x 4 columns.
//   - `conv_fwd_tc_kernel`: LN1 of the HR = TT + 32 halo rows, rounded into
//     a bf16 tile; PW1 over round16(TT + 2p) rows on mma in 64-column chunks
//     of the a and g halves (96 rows for 64 frames at k = 31: 1.5x PW1's
//     products, against 2.0x at 32 frames), GLU and mask on the fragments
//     into a float32 u tile; the float32 depthwise conv on the CUDA cores,
//     one thread a column, eight output rows a pass with the taps in
//     registers, in place (c of frame t0 + r overwrites u row r), taps in
//     ascending order from a float32 zero, the bias last; LN2 and swish by
//     warp rows, rounded into a bf16 tile; PW2 on mma in 128-column chunks,
//     then b2, the hash on the fragments' logical (t, c) and the residual.
//   - `conv_bwd_a_tc_kernel`: the same head, conv, LN2 and swish; writes u
//     of its frames (float32, before the conv overwrites it) and s (bf16);
//     dz = drop(gy) rounded into a bf16 tile and dz_buf; ds = dz W2^T on mma
//     (W2 slabs [n][k], ldmatrix without .trans), swish' on the fragments
//     into a float32 dcn tile; LN2's backward by warp rows gives dc
//     (float32, to dc_buf) and the partials of dLN2 scale and bias, ddb and
//     db2 (from the unrounded dz).
//   - `conv_bwd_b_tc_kernel`: stages dc of frames [t0 - p, t0 + TT + p) and
//     u of its own frames in shared memory (cp.async, zeros outside [0, T))
//     and runs one CUDA-core pass, one thread a column: du (the flipped
//     taps) and the tap gradients ddw[j] = sum over its frames s of u[s]
//     dc[s + p - j] (each (s, t) pair belongs to the tile that owns s, so the
//     tiles' partials sum to the whole), one dc read feeding both. No device
//     memory is read k times. Then LN1 of its frames (bf16 tile, xn_buf),
//     and per 64-column chunk: PW1 on mma, the mask and the GLU backward on
//     the fragments (db1 from the unrounded dh), dh rounded into a bf16
//     tile (to dh_buf), dxn += dh W1^T on mma into float32 registers for
//     all DP columns; then LN1's backward by warp rows and dx = gy + dx_ln.
//   - dW1 = xn^T dh and dW2 = s^T dz on `atb_tc_kernel` (ffn_kernels.cuh),
//     over the row groups of ops/ffn_common.py `wgrad_split`, summed after.
//   Shared memory per block (bytes; DP 256 / 512): forward 200,192 /
//   230,656, kernel A 200,192 / 230,656, kernel B 201,216 / 231,680 (one
//   block of 8 warps an SM; 180, 181 and 151 registers at DP = 256, no
//   spills). The grid at the bench shape: 8 x 64 = 512 blocks, 3.9 waves on
//   132 SMs.
//   Measured at the bench shape on an NVIDIA H100 80GB HBM3 at 700 W
//   (chip_smoke.py, profile_train.py): forward 0.37 ms (the CUDA-core
//   design took 1.82 ms in bf16), backward with the wrapper's sums 1.04 ms
//   (5.62) -- kernel A 0.43, kernel B 0.36, the two A^T B 0.06 -- about 30x
//   their bounds; the forward at serve's B = 4, T = 374 takes 0.094 ms.
//   With one block of 8 warps an SM the products wait on the ring's
//   barriers and loads: wgmma, a deeper ring and less shared memory a block
//   are the next steps.
//
// D runs to DP, a multiple of 128 (instantiated 128, 256, 384, 512), with
// the columns past D zero: the route has no shape gate in the JAX package,
// so d 144 and 64 run here too. k runs to 31 (the halo's 32 rows); past that
// the wrapper raises.
#include "conv_tc.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on tensor cores (see the note at the top).
// ---------------------------------------------------------------------------

constexpr int KMAX = 2 * PMAX + 1;  // the longest depthwise kernel
constexpr int CONV_G = 8;  // output rows of one depthwise pass

template <int DP>
struct TcConv {
  static constexpr int TT = DP <= 256 ? 64 : 32;  // frames a block owns
  static constexpr int HR = TT + 2 * PMAX + 2;    // halo rows, 16 | HR
  static constexpr int LDU = DP + 8;  // float stride: u, c, dcn, dc, du, dxn
  static constexpr int LDX = DP + 8;  // bf16 stride: LN1(x), s, dz
  static constexpr int MTH = HR / 32;  // halo m-tiles per row warp
  static constexpr int MTO = TT / 32;  // own-row m-tiles per row warp
  static constexpr int NOC = DP / SLAB_N;  // 128-wide output chunks
  static constexpr int KS = DP / SLAB_K;   // slabs along a reduction over DP
  static constexpr int U_BYTES = HR * LDU * 4;
  static constexpr int X_BYTES =
      HR * LDX * 2 > TT * LDU * 4 ? HR * LDX * 2 : TT * LDU * 4;
  static constexpr int RING_BYTES = RING * SLAB_ELEMS * 2;
  // u / c / dz | LN1(x), later s or dcn | ring | LN2 mean, 1/std
  static constexpr size_t fwd_bytes =
      U_BYTES + X_BYTES + RING_BYTES + 2 * TT * 4;
  // dc halo, later LN1(x), dh and block sums | u, du, dxn | ring | db1 sums,
  // LN1 mean, 1/std
  static constexpr size_t b_bytes =
      U_BYTES + TT * LDU * 4 + RING_BYTES + (2 * SLAB_N + 2 * TT) * 4;
  static_assert(HR % 32 == 0 && TT % 32 == 0, "2 row warps of m-tiles");
  static_assert(fwd_bytes <= 232448 && b_bytes <= 232448,
                "a block may have 227 KB");
  static_assert(TT * LDX * 2 <= (HR - TT) * LDU * 4,
                "kernel A's dz tile sits after c");
  static_assert(8 * 4 * DP <= HR * LDU, "the block sums reuse u");
  static_assert(TT * LDX + TT * LDKN <= HR * LDU * 2,
                "LN1(x) and dh fit where dc was");
};

// LN1 of frames t_first + r, r < nrows, of utterance b, rounded into xn_s
// (stride DP + 8); zeros for r >= rows and frames outside [0, T). With
// mean_s, each row's mean and 1/std; with xn_buf, the rows of frames in
// [0, T) also to xn_buf row b*T + t (DP wide). Warp w takes rows w, w+8, ...
template <int DP>
__device__ void ln1_rows(const bf16* __restrict__ x,
                         const float* __restrict__ ln1s,
                         const float* __restrict__ ln1b, int b, int T, int D,
                         int t_first, int rows, int nrows, bf16* xn_s,
                         float* mean_s, float* inv_s, bf16* xn_buf) {
  constexpr int ZJ = DP / 32, LDX = DP + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrows; r += 8) {
    const int t = t_first + r;
    const bool ok = r < rows && t >= 0 && t < T;
    const bf16* xr = x + (static_cast<size_t>(b) * T + (ok ? t : 0)) * D;
    float v[ZJ];
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      v[e] = ok && d < D ? to_f32(xr[d]) : 0.f;
    }
    float mean, inv;
    ln_vals<ZJ, false>(v, D, ln1s, ln1b, mean, inv);
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      const bf16 xb = __float2bfloat16(ok ? v[e] : 0.f);
      xn_s[r * LDX + d] = xb;
      if (xn_buf != nullptr && ok)
        xn_buf[(static_cast<size_t>(b) * T + t) * DP + d] = xb;
    }
    if (mean_s != nullptr && lane == 0) {
      mean_s[r] = mean;
      inv_s[r] = inv;
    }
  }
}

// u = mask * GLU(h + b1) on the head's fragments (chunk columns c0..) into
// u_s row r = frame t_first + r; zero for r >= rows, frames outside [0, T)
// and columns past D. Clears acc.
template <int DP, int MT>
__device__ __forceinline__ void glu_to_u(float (&acc)[MT][4][4], float* u_s,
                                         const float* __restrict__ mask,
                                         const float* __restrict__ b1, int b,
                                         int T, int D, int t_first, int rows,
                                         int n_mt, int c0, int wm, int wn) {
  constexpr int LDU = TcConv<DP>::LDU;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mt = wm + 2 * i;
    if (mt >= n_mt) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      const int t = t_first + r;
      const bool ok = r < rows && t >= 0 && t < T;
      const float mk = ok ? mask[static_cast<size_t>(b) * T + t] : 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = c0 + wn * 16 + nt * 8 + 2 * t4;
        float uv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = col + e;
          uv[e] = 0.f;
          if (ok && f < D)
            uv[e] = (acc[i][nt][2 * h + e] + b1[f]) *
                    sigmoidf(acc[i][nt + 2][2 * h + e] + b1[D + f]) * mk;
        }
        *reinterpret_cast<float2*>(u_s + r * LDU + col) =
            make_float2(uv[0], uv[1]);
      }
    }
  }
  zero(acc);
}

// c = DW(u) + db of the block's TT frames, in place: row r of u_s (frame
// t0 - p + r) becomes c of frame t0 + r, r < TT. One thread a column, CONV_G
// output rows a pass, the taps in registers; each output sums its taps in
// ascending order from a float32 zero, the bias last (`_depthwise`). With
// u_out, first copies u of the block's frames (rows p.., `own` of them) to
// u_out (DP wide). Columns past D keep u = 0.
template <int DP>
__device__ void depthwise_in_place(float* u_s, const bf16* __restrict__ dw,
                                   const float* __restrict__ db, int D, int K,
                                   float* u_out, int own) {
  constexpr int TT = TcConv<DP>::TT, LDU = TcConv<DP>::LDU, G = CONV_G;
  const int p = (K - 1) / 2;
  for (int ch = threadIdx.x; ch < DP; ch += THREADS) {
    if (u_out != nullptr)
      for (int r = 0; r < own; ++r)
        u_out[static_cast<size_t>(r) * DP + ch] = u_s[(r + p) * LDU + ch];
    if (ch >= D) continue;
    float w[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) w[j] = j < K ? to_f32(dw[j * D + ch]) : 0.f;
    const float bias = db[ch];
    for (int o0 = 0; o0 < TT; o0 += G) {
      float acc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = 0.f;
      // input row o0 + n feeds output o0 + g through tap n - g (w is 0 past
      // K, and rows past the taps' reach read as 0)
#pragma unroll
      for (int n = 0; n < KMAX + G - 1; ++n) {
        const float v = n < K + G - 1 ? u_s[(o0 + n) * LDU + ch] : 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (n - g >= 0 && n - g < KMAX) acc[g] += v * w[n - g];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) u_s[(o0 + g) * LDU + ch] = acc[g] + bias;
    }
  }
}

// LN2 and swish of the block's TT rows of c (u_s) by warp rows: rounded into
// s_s (stride LDX) or, for the rows r < own, to s_buf (DP wide); with
// mean_s, each row's mean and 1/std.
template <int DP>
__device__ void ln2_rows(const float* c_s, const float* __restrict__ ln2s,
                         const float* __restrict__ ln2b, int D, bf16* s_s,
                         float* mean_s, float* inv_s, bf16* s_buf, int own) {
  constexpr int ZJ = DP / 32, TT = TcConv<DP>::TT, LDU = TcConv<DP>::LDU;
  constexpr int LDX = TcConv<DP>::LDX;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TT; r += 8) {
    float v[ZJ];
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      v[e] = d < D ? c_s[r * LDU + d] : 0.f;
    }
    float mean, inv;
    ln_vals<ZJ, true>(v, D, ln2s, ln2b, mean, inv);
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      const bf16 sb = __float2bfloat16(v[e]);
      if (s_s != nullptr) s_s[r * LDX + d] = sb;
      if (s_buf != nullptr && r < own)
        s_buf[static_cast<size_t>(r) * DP + d] = sb;
    }
    if (mean_s != nullptr && lane == 0) {
      mean_s[r] = mean;
      inv_s[r] = inv;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    conv_fwd_tc_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ mask,
                       const float* __restrict__ ln1s,
                       const float* __restrict__ ln1b,
                       const bf16* __restrict__ w1,
                       const float* __restrict__ b1,
                       const bf16* __restrict__ dw,
                       const float* __restrict__ db,
                       const float* __restrict__ ln2s,
                       const float* __restrict__ ln2b,
                       const bf16* __restrict__ w2,
                       const float* __restrict__ b2, bf16* __restrict__ y,
                       int T, int D, int K, int q, float dscale, int seed) {
  using L = TcConv<DP>;
  constexpr int TT = L::TT, LDX = L::LDX, MTH = L::MTH, MTO = L::MTO;
  constexpr int KS = L::KS, NH = (DP / HEAD_C) * KS, NJ = NH + L::NOC * KS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* u_s = reinterpret_cast<float*>(smem_raw);  // u over the halo, then c
  bf16* xn_s = reinterpret_cast<bf16*>(smem_raw + L::U_BYTES);  // then s
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + L::U_BYTES + L::X_BYTES);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y, t0 = blockIdx.x * TT, p = (K - 1) / 2;
  const int rows = TT + 2 * p, n_mt = (rows + 15) / 16;

  // jobs: the head's slabs chunk by chunk, then PW2's
  auto fetch = [&](int j) {
    if (j < NJ) {
      bf16* slab = ring + (j % RING) * SLAB_ELEMS;
      if (j < NH)
        load_w1_head<DP>(slab, w1, (j % KS) * SLAB_K, (j / KS) * HEAD_C);
      else
        load_kn(slab, w2, DP, ((j - NH) % KS) * SLAB_K,
                ((j - NH) / KS) * SLAB_N);
    }
    cp_async_commit();
  };
  fetch(0);
  fetch(1);
  ln1_rows<DP>(x, ln1s, ln1b, b, T, D, t0 - p, rows, n_mt * 16, xn_s,
               nullptr, nullptr, nullptr);

  float acc[MTH][4][4], z[MTO][4][4];
  zero(acc);
  zero(z);
  const unsigned st = tile_stream(seed, b);
  for (int j = 0; j < NJ; ++j) {
    cp_async_wait<RING - 2>();
    __syncthreads();  // slab j landed; job j-1's readers are done
    fetch(j + RING - 1);
    const bf16* slab = ring + (j % RING) * SLAB_ELEMS;
    const int ks = (j < NH ? j : j - NH) % KS;
    if (j < NH) {
      head_slab<MTH, LDX>(acc, xn_s, slab, ks * SLAB_K, n_mt, wm, wn);
      if (ks == KS - 1)
        glu_to_u<DP, MTH>(acc, u_s, mask, b1, b, T, D, t0 - p, rows, n_mt,
                          (j / KS) * HEAD_C, wm, wn);
      continue;
    }
    const int n0 = ((j - NH) / KS) * SLAB_N;
    if (j == NH) {  // u is complete: conv, LN2, swish
      depthwise_in_place<DP>(u_s, dw, db, D, K, nullptr, 0);
      __syncthreads();
      ln2_rows<DP>(u_s, ln2s, ln2b, D, xn_s, nullptr, nullptr, nullptr, 0);
      __syncthreads();
    }
    tail_slab<MTO, LDX, true>(z, xn_s, slab, ks * SLAB_K, wm, wn);
    if (ks != KS - 1) continue;
    // y = x + drop(z + b2), rounded once
#pragma unroll
    for (int i = 0; i < MTO; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + (wm * MTO + i) * 16 + g + 8 * h;
        if (t >= T) continue;
        const size_t base = (static_cast<size_t>(b) * T + t) * D;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + wn * 32 + nt * 8 + 2 * t4 + e;
            if (n >= D) continue;
            float zz = z[i][nt][2 * h + e] + b2[n];
            if (q > 0)
              zz = keep_counter(st, static_cast<unsigned>(t) * D + n, q)
                       ? zz * dscale
                       : 0.f;
            y[base + n] = __float2bfloat16(to_f32(x[base + n]) + zz);
          }
      }
    zero(z);
  }
  cp_async_wait<0>();
}

// Backward, kernel A: from the head (with its halo) to dc. Writes u, dc
// (float32), s and dz (bf16) of the block's frames, DP wide with zeros past
// D, and part[tile] = (dLN2 scale, dLN2 bias, ddb, db2) as 4 x D floats.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    conv_bwd_a_tc_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ mask,
                         const float* __restrict__ ln1s,
                         const float* __restrict__ ln1b,
                         const bf16* __restrict__ w1,
                         const float* __restrict__ b1,
                         const bf16* __restrict__ dw,
                         const float* __restrict__ db,
                         const float* __restrict__ ln2s,
                         const float* __restrict__ ln2b,
                         const bf16* __restrict__ w2,
                         const bf16* __restrict__ gy,
                         float* __restrict__ u_buf,
                         float* __restrict__ dc_buf, bf16* __restrict__ s_buf,
                         bf16* __restrict__ dz_buf, float* __restrict__ part,
                         int T, int D, int K, int q, float dscale, int seed) {
  using L = TcConv<DP>;
  constexpr int TT = L::TT, LDU = L::LDU, LDX = L::LDX, MTH = L::MTH;
  constexpr int MTO = L::MTO, ZJ = DP / 32;
  constexpr int KS = L::KS, NH = (DP / HEAD_C) * KS, NJ = NH + L::NOC * KS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* u_s = reinterpret_cast<float*>(smem_raw);  // u over the halo, then c
  bf16* dz_s = reinterpret_cast<bf16*>(u_s + TT * LDU);  // after c
  bf16* xn_s = reinterpret_cast<bf16*>(smem_raw + L::U_BYTES);
  float* dcn_s = reinterpret_cast<float*>(xn_s);  // after the head
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + L::U_BYTES + L::X_BYTES);
  float* mean_s = reinterpret_cast<float*>(ring + RING * SLAB_ELEMS);
  float* inv_s = mean_s + TT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y, t0 = blockIdx.x * TT, p = (K - 1) / 2;
  const int rows = TT + 2 * p, n_mt = (rows + 15) / 16;
  const int own = min(TT, T - t0);
  const size_t row0 = static_cast<size_t>(b) * T + t0;  // the tile's frame 0

  // jobs: the head's slabs, then ds = dz W2^T by 128 output columns
  auto fetch = [&](int j) {
    if (j < NJ) {
      bf16* slab = ring + (j % RING) * SLAB_ELEMS;
      if (j < NH)
        load_w1_head<DP>(slab, w1, (j % KS) * SLAB_K, (j / KS) * HEAD_C);
      else
        load_nk(slab, w2, DP, ((j - NH) / KS) * SLAB_N,
                ((j - NH) % KS) * SLAB_K);
    }
    cp_async_commit();
  };
  fetch(0);
  fetch(1);
  ln1_rows<DP>(x, ln1s, ln1b, b, T, D, t0 - p, rows, n_mt * 16, xn_s,
               nullptr, nullptr, nullptr);

  float acc[MTH][4][4], ds[MTO][4][4];
  zero(acc);
  zero(ds);
  float sums[4][ZJ];  // dLN2 scale, dLN2 bias, ddb, db2
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int e = 0; e < ZJ; ++e) sums[s][e] = 0.f;
  for (int j = 0; j < NJ; ++j) {
    cp_async_wait<RING - 2>();
    __syncthreads();
    fetch(j + RING - 1);
    const bf16* slab = ring + (j % RING) * SLAB_ELEMS;
    const int ks = (j < NH ? j : j - NH) % KS;
    if (j < NH) {
      head_slab<MTH, LDX>(acc, xn_s, slab, ks * SLAB_K, n_mt, wm, wn);
      if (ks == KS - 1)
        glu_to_u<DP, MTH>(acc, u_s, mask, b1, b, T, D, t0 - p, rows, n_mt,
                          (j / KS) * HEAD_C, wm, wn);
      continue;
    }
    const int n0 = ((j - NH) / KS) * SLAB_N;
    if (j == NH) {
      // u of the tile's frames out, then the conv, LN2 and swish (s out)
      depthwise_in_place<DP>(u_s, dw, db, D, K, u_buf + row0 * DP, own);
      __syncthreads();
      ln2_rows<DP>(u_s, ln2s, ln2b, D, nullptr, mean_s, inv_s,
                   s_buf + row0 * DP, own);
      // dz = drop(gy), rounded; db2 sums the unrounded values
      const unsigned st = tile_stream(seed, b);
      for (int r = warp; r < TT; r += 8) {
        const bool ok = r < own;
#pragma unroll
        for (int e = 0; e < ZJ; ++e) {
          const int d = lane + 32 * e;
          float v = 0.f;
          if (ok && d < D) {
            v = to_f32(gy[(row0 + r) * D + d]);
            if (q > 0)
              v = keep_counter(st, static_cast<unsigned>(t0 + r) * D + d, q)
                      ? v * dscale
                      : 0.f;
            sums[3][e] += v;
          }
          const bf16 vb = __float2bfloat16(v);
          dz_s[r * LDX + d] = vb;
          if (ok) dz_buf[(row0 + r) * DP + d] = vb;
        }
      }
      __syncthreads();
    }
    tail_slab<MTO, LDX, false>(ds, dz_s, slab, ks * SLAB_K, wm, wn);
    if (ks != KS - 1) continue;
    // dcn = ds * swish'(LN2(c)) into the float32 tile
#pragma unroll
    for (int i = 0; i < MTO; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * MTO + i) * 16 + g + 8 * h;
        const float mean = mean_s[r], inv = inv_s[r];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = n0 + wn * 32 + nt * 8 + 2 * t4;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = c + e;
            v[e] = 0.f;
            if (n < D) {
              const float cn =
                  (u_s[r * LDU + n] - mean) * inv * ln2s[n] + ln2b[n];
              const float sg = sigmoidf(cn);
              v[e] = ds[i][nt][2 * h + e] * (sg * (1.f + cn * (1.f - sg)));
            }
          }
          *reinterpret_cast<float2*>(dcn_s + r * LDU + c) =
              make_float2(v[0], v[1]);
        }
      }
    zero(ds);
  }
  cp_async_wait<0>();
  __syncthreads();
  // LN2 backward per frame (frames past T: dz = 0, so dc = 0)
  for (int r = warp; r < TT; r += 8) {
    const float mean = mean_s[r], inv = inv_s[r];
    float xh[ZJ], dcn[ZJ], dc[ZJ];
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      xh[e] = d < D ? (u_s[r * LDU + d] - mean) * inv : 0.f;
      dcn[e] = dcn_s[r * LDU + d];
    }
    ln_bwd_row<ZJ>(dcn, xh, ln2s, inv, D, dc, sums[0], sums[1]);
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      if (d < D) sums[2][e] += dc[e];
      if (r < own) dc_buf[(row0 + r) * DP + d] = d < D ? dc[e] : 0.f;
    }
  }
  store_block_sums<4, ZJ>(
      sums, u_s,
      part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 4 * D, D);
}

// du and the tap gradients of the block's frames, one thread a column: dc_s
// holds dc of frames t0 - p + i (zeros outside [0, T)), ud_s u of frames
// t0 + r (zeros past T) and receives du. du[r] = sum_j dc[r + 2p - j] w[j]
// (halo rows), and ddw[j] = sum_r u[r] dc[r + 2p - j], which pairs frame
// s = t0 + r with s + p - j: each pair belongs to the tile that owns s.
template <int DP>
__device__ void conv_bwd_pass(const float* dc_s, float* ud_s,
                              const bf16* __restrict__ dw, int D, int K,
                              float* __restrict__ ddw_out) {
  constexpr int TT = TcConv<DP>::TT, LDU = TcConv<DP>::LDU, G = CONV_G;
  for (int ch = threadIdx.x; ch < D; ch += THREADS) {
    float w[KMAX], dwa[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      w[j] = j < K ? to_f32(dw[j * D + ch]) : 0.f;
      dwa[j] = 0.f;
    }
    for (int r0 = 0; r0 < TT; r0 += G) {
      float uv[G], du[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        uv[g] = ud_s[(r0 + g) * LDU + ch];
        du[g] = 0.f;
      }
      // halo row r0 + G-1 + 2p - n feeds output r0 + g through tap
      // n - (G-1-g): the taps of each output in ascending order
#pragma unroll
      for (int n = 0; n < KMAX + G - 1; ++n) {
        const float v =
            n < K + G - 1 ? dc_s[(r0 + G - 1 + K - 1 - n) * LDU + ch] : 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int j = n - (G - 1 - g);
          if (j >= 0 && j < KMAX) {
            du[g] += v * w[j];
            dwa[j] += uv[g] * v;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) ud_s[(r0 + g) * LDU + ch] = du[g];
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < K) ddw_out[j * D + ch] = dwa[j];
  }
}

// Backward, kernel B: from dc to dx. Writes dx, the rounded LN1(x) (DP
// wide) and dh (2DP wide: the a half, then the g half at column DP) of the
// block's frames, the tap gradients ddwp[tile] (K x D) and part[tile] =
// (dLN1 scale, dLN1 bias, db1 (2D)) as 4 x D floats.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    conv_bwd_b_tc_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ mask,
                         const float* __restrict__ ln1s,
                         const float* __restrict__ ln1b,
                         const bf16* __restrict__ w1,
                         const float* __restrict__ b1,
                         const bf16* __restrict__ dw,
                         const bf16* __restrict__ gy,
                         const float* __restrict__ u_buf,
                         const float* __restrict__ dc_buf,
                         bf16* __restrict__ dx, bf16* __restrict__ xn_buf,
                         bf16* __restrict__ dh_buf, float* __restrict__ part,
                         float* __restrict__ ddwp, int T, int D, int K) {
  using L = TcConv<DP>;
  constexpr int TT = L::TT, LDU = L::LDU, LDX = L::LDX, MTO = L::MTO;
  constexpr int NOC = L::NOC, ZJ = DP / 32, KS = L::KS;
  constexpr int JC = KS + 4 * NOC;  // jobs a chunk: the head's, then dxn's
  constexpr int NJ = (DP / HEAD_C) * JC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dc_s = reinterpret_cast<float*>(smem_raw);  // the dc halo, then:
  bf16* xn_s = reinterpret_cast<bf16*>(smem_raw);    // LN1(x) (TT x LDX)
  bf16* dh_s = xn_s + TT * LDX;                      // dh (TT x LDKN)
  float* ud_s = reinterpret_cast<float*>(smem_raw + L::U_BYTES);  // u, du
  bf16* ring =
      reinterpret_cast<bf16*>(smem_raw + L::U_BYTES + TT * LDU * 4);
  float* red_s = reinterpret_cast<float*>(ring + RING * SLAB_ELEMS);
  float* mean_s = red_s + 2 * SLAB_N;
  float* inv_s = mean_s + TT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y, t0 = blockIdx.x * TT, p = (K - 1) / 2;
  const size_t row0 = static_cast<size_t>(b) * T + t0;
  const size_t tile = static_cast<size_t>(b) * gridDim.x + blockIdx.x;
  float* pt = part + tile * 4 * D;

  // dc of frames t0 - p .. t0 + TT + p - 1 and u of the tile's frames
  constexpr int C4 = DP / 4;  // 16-byte chunks of a float row
  for (int e = tid; e < (TT + 2 * p) * C4; e += THREADS) {
    const int i = e / C4, c = e % C4;
    const int t = t0 - p + i;
    const bool ok = t >= 0 && t < T;
    cp_async16(dc_s + i * LDU + c * 4,
               dc_buf + (static_cast<size_t>(b) * T + (ok ? t : 0)) * DP +
                   c * 4,
               ok ? 16 : 0);
  }
  for (int e = tid; e < TT * C4; e += THREADS) {
    const int r = e / C4, c = e % C4;
    const bool ok = t0 + r < T;
    cp_async16(ud_s + r * LDU + c * 4,
               u_buf + (ok ? row0 + r : row0) * DP + c * 4, ok ? 16 : 0);
  }
  cp_async_commit();

  auto fetch = [&](int j) {
    if (j < NJ) {
      bf16* slab = ring + (j % RING) * SLAB_ELEMS;
      const int c0 = (j / JC) * HEAD_C, jc = j % JC;
      if (jc < KS) {
        load_w1_head<DP>(slab, w1, jc * SLAB_K, c0);
      } else {  // dxn: W1 rows oc*128.. (dxn columns), dh columns kq*32..
        const int kq = (jc - KS) / NOC, oc = (jc - KS) % NOC;
        const int f0 = (kq < 2 ? c0 : DP + c0 - HEAD_C) + kq * SLAB_K;
        load_nk(slab, w1, 2 * DP, oc * SLAB_N, f0);
      }
    }
    cp_async_commit();
  };
  fetch(0);
  fetch(1);
  cp_async_wait<2>();  // the staged dc and u
  __syncthreads();
  conv_bwd_pass<DP>(dc_s, ud_s, dw, D, K, ddwp + tile * K * D);
  __syncthreads();  // dc is read for the last time above
  ln1_rows<DP>(x, ln1s, ln1b, b, T, D, t0, TT, TT, xn_s, mean_s, inv_s,
               xn_buf);

  float acc[MTO][4][4], dxn[NOC][MTO][4][4];
  zero(acc);
#pragma unroll
  for (int o = 0; o < NOC; ++o) zero(dxn[o]);
  for (int j = 0; j < NJ; ++j) {
    cp_async_wait<RING - 2>();
    __syncthreads();
    fetch(j + RING - 1);
    const bf16* slab = ring + (j % RING) * SLAB_ELEMS;
    const int c0 = (j / JC) * HEAD_C, jc = j % JC;
    if (jc < KS) {
      head_slab<MTO, LDX>(acc, xn_s, slab, jc * SLAB_K, TT / 16, wm, wn);
      if (jc < KS - 1) continue;
      // the mask and the GLU backward on the fragments: dh rounded into the
      // tile, db1 summed from the unrounded dh
      float db1v[4][2] = {};
#pragma unroll
      for (int i = 0; i < MTO; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (wm + 2 * i) * 16 + g + 8 * h;
          const int t = t0 + r;
          const float mk =
              t < T ? mask[static_cast<size_t>(b) * T + t] : 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int col = wn * 16 + nt * 8 + 2 * t4;
            float da[2], dg[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int f = c0 + col + e;
              da[e] = dg[e] = 0.f;
              if (t < T && f < D) {
                const float du = ud_s[r * LDU + f] * mk;
                const float a = acc[i][nt][2 * h + e] + b1[f];
                const float sg =
                    sigmoidf(acc[i][nt + 2][2 * h + e] + b1[D + f]);
                da[e] = du * sg;
                dg[e] = du * a * sg * (1.f - sg);
              }
              db1v[nt][e] += da[e];
              db1v[nt + 2][e] += dg[e];
            }
            *reinterpret_cast<__nv_bfloat162*>(dh_s + r * LDKN + col) =
                __floats2bfloat162_rn(da[0], da[1]);
            *reinterpret_cast<__nv_bfloat162*>(dh_s + r * LDKN + HEAD_C +
                                               col) =
                __floats2bfloat162_rn(dg[0], dg[1]);
          }
        }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = db1v[n][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0)
            red_s[wm * SLAB_N + (n >> 1) * HEAD_C + wn * 16 + (n & 1) * 8 +
                  2 * t4 + e] = v;
        }
      zero(acc);
      continue;
    }
    const int kq = (jc - KS) / NOC, oc = (jc - KS) % NOC;
    if (jc == KS) {
      // the dh tile and the db1 sums are complete: dh out (16 bytes a
      // thread), db1's block partial
      for (int e = tid; e < TT * 16; e += THREADS) {
        const int r = e >> 4, c = e & 15;
        if (t0 + r >= T) continue;
        const int col = (c < 8 ? c0 : DP + c0 - HEAD_C) + c * 8;
        *reinterpret_cast<uint4*>(dh_buf + (row0 + r) * 2 * DP + col) =
            *reinterpret_cast<const uint4*>(dh_s + r * LDKN + c * 8);
      }
      if (tid < SLAB_N) {
        const int f = c0 + (tid & (HEAD_C - 1));
        if (f < D)
          pt[2 * D + (tid < HEAD_C ? f : D + f)] =
              red_s[tid] + red_s[SLAB_N + tid];
      }
    }
    // dxn[:, oc*128..] += dh[:, kq*32..] W1[oc*128.., f0..]^T
#pragma unroll
    for (int o = 0; o < NOC; ++o)
      if (o == oc)
        tail_slab<MTO, LDKN, false>(dxn[o], dh_s, slab, kq * SLAB_K, wm,
                                    wn);
  }
  cp_async_wait<0>();
  __syncthreads();  // every reader of du is done

  // dxn through shared memory to one warp per row
  float* z_s = ud_s;
#pragma unroll
  for (int o = 0; o < NOC; ++o)
#pragma unroll
    for (int i = 0; i < MTO; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * MTO + i) * 16 + g + 8 * h;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<float2*>(
              z_s + r * LDU + o * SLAB_N + wn * 32 + nt * 8 + 2 * t4) =
              make_float2(dxn[o][i][nt][2 * h], dxn[o][i][nt][2 * h + 1]);
      }
  __syncthreads();
  float sums[2][ZJ];  // dLN1 scale, dLN1 bias
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < ZJ; ++e) sums[s][e] = 0.f;
  for (int r = warp; r < TT; r += 8) {
    if (t0 + r >= T) continue;  // uniform across the warp
    const size_t base = (row0 + r) * D;
    const float mean = mean_s[r], inv = inv_s[r];
    float zv[ZJ], xh[ZJ], dxl[ZJ];
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      zv[e] = z_s[r * LDU + d];
      xh[e] = d < D ? (to_f32(x[base + d]) - mean) * inv : 0.f;
    }
    ln_bwd_row<ZJ>(zv, xh, ln1s, inv, D, dxl, sums[0], sums[1]);
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      if (d < D)
        dx[base + d] = __float2bfloat16(to_f32(gy[base + d]) + dxl[e]);
    }
  }
  store_block_sums<2, ZJ>(sums, dc_s, pt, D);
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

template <int DP>
int module_fwd_tc(const void* x, const float* mask, Params pr,
                  const float* b2, void* y, int B, int T, int D, int K, int q,
                  float dscale, int seed, cudaStream_t s) {
  auto k = conv_fwd_tc_kernel<DP>;
  constexpr size_t smem = TcConv<DP>::fwd_bytes;
  if (int err = set_smem(k, smem)) return err;
  constexpr int TTC = TcConv<DP>::TT;
  k<<<dim3((T + TTC - 1) / TTC, B), THREADS, smem, s>>>(
      static_cast<const bf16*>(x), mask, pr.ln1s, pr.ln1b,
      static_cast<const bf16*>(pr.w1), pr.b1,
      static_cast<const bf16*>(pr.dw), pr.db, pr.ln2s, pr.ln2b,
      static_cast<const bf16*>(pr.w2), b2, static_cast<bf16*>(y), T, D, K, q,
      dscale, seed);
  return static_cast<int>(cudaGetLastError());
}

struct Buffers {
  float *u, *dc;
  void *s, *dz, *xn, *dh;
  float *part_a, *part_b, *ddwp, *dw1p, *dw2p;
};

// Row groups of the weight gradients: g1 (r1 rows each) for dW1, g2 (r2)
// for dW2.
struct Groups {
  int g1, r1, g2, r2;
};

template <typename E, int DP>
int module_bwd(const void* x, const float* mask, Params pr, const void* gy,
               void* dx, Buffers bf, int B, int T, int D, int K, Groups gr,
               int q, float dscale, int seed, cudaStream_t s) {
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
                              2 * D, gr.g1, s))
    return err;
  return launch_atb<E>(static_cast<const E*>(bf.s),
                       static_cast<const E*>(bf.dz), bf.dw2p, M, D, D, gr.g2,
                       s);
}

template <int DP>
int module_bwd_tc(const void* x, const float* mask, Params pr, const void* gy,
                  void* dx, Buffers bf, int B, int T, int D, int K, Groups gr,
                  int q, float dscale, int seed, cudaStream_t s) {
  constexpr int TTC = TcConv<DP>::TT;
  const dim3 grid((T + TTC - 1) / TTC, B);
  const bf16* w1 = static_cast<const bf16*>(pr.w1);
  const bf16* dw = static_cast<const bf16*>(pr.dw);
  auto ka = conv_bwd_a_tc_kernel<DP>;
  constexpr size_t smem_a = TcConv<DP>::fwd_bytes;
  if (int err = set_smem(ka, smem_a)) return err;
  ka<<<grid, THREADS, smem_a, s>>>(
      static_cast<const bf16*>(x), mask, pr.ln1s, pr.ln1b, w1, pr.b1, dw,
      pr.db, pr.ln2s, pr.ln2b, static_cast<const bf16*>(pr.w2),
      static_cast<const bf16*>(gy), bf.u, bf.dc, static_cast<bf16*>(bf.s),
      static_cast<bf16*>(bf.dz), bf.part_a, T, D, K, q, dscale, seed);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  auto kb = conv_bwd_b_tc_kernel<DP>;
  constexpr size_t smem_b = TcConv<DP>::b_bytes;
  if (int err = set_smem(kb, smem_b)) return err;
  kb<<<grid, THREADS, smem_b, s>>>(
      static_cast<const bf16*>(x), mask, pr.ln1s, pr.ln1b, w1, pr.b1, dw,
      static_cast<const bf16*>(gy), bf.u, bf.dc, static_cast<bf16*>(dx),
      static_cast<bf16*>(bf.xn), static_cast<bf16*>(bf.dh), bf.part_b,
      bf.ddwp, T, D, K);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  // dW1 = LN1(x)^T dh: (DP, 2DP); dW2 = s^T dz: (DP, DP)
  const int M = B * T;
  if (int err = launch_atb_tc(static_cast<const bf16*>(bf.xn),
                              static_cast<const bf16*>(bf.dh), bf.dw1p, M,
                              DP, 2 * DP, gr.g1, gr.r1, s))
    return err;
  return launch_atb_tc(static_cast<const bf16*>(bf.s),
                       static_cast<const bf16*>(bf.dz), bf.dw2p, M, DP, DP,
                       gr.g2, gr.r2, s);
}

bool shape_ok(int B, int T, int D, int K) {
  return B >= 1 && T >= 1 && D >= 1 && D <= 512 && K >= 1 && K % 2 == 1 &&
         K <= KMAX;
}

}  // namespace
}  // namespace espnet_port

// Dispatch on dtype and DP = D rounded up to a multiple of 128: float32 to
// the CUDA-core kernels FN<float, DP>, bf16 to the tensor-core FN_TC<DP>.
#define ESPNET_CONV_MODULE_DISPATCH(FN, FN_TC, ...)                          \
  do {                                                                       \
    const int dp = (D + 127) / 128 * 128;                                    \
    if (dtype == kFloat32 && dp == 128) return FN<float, 128>(__VA_ARGS__);  \
    if (dtype == kFloat32 && dp == 256) return FN<float, 256>(__VA_ARGS__);  \
    if (dtype == kFloat32 && dp == 384) return FN<float, 384>(__VA_ARGS__);  \
    if (dtype == kFloat32 && dp == 512) return FN<float, 512>(__VA_ARGS__);  \
    if (dtype == kBFloat16 && dp == 128) return FN_TC<128>(__VA_ARGS__);     \
    if (dtype == kBFloat16 && dp == 256) return FN_TC<256>(__VA_ARGS__);     \
    if (dtype == kBFloat16 && dp == 384) return FN_TC<384>(__VA_ARGS__);     \
    if (dtype == kBFloat16 && dp == 512) return FN_TC<512>(__VA_ARGS__);     \
    return kUnsupported;                                                     \
  } while (0)

// x, y: (B, T, D); mask (B, T) float32 (1 = valid); ln1s, ln1b, db, ln2s,
// ln2b, b2 (D,) and b1 (2D,) float32; dw (K, D) in x's dtype. float32: w1
// (D, 2D) and w2 (D, D). bf16: w1 (DP, 2DP) with the g half from column DP
// and w2 (DP, DP), zeros past D (DP = D rounded up to 128), 16-byte
// aligned. Every tensor contiguous; D <= 512, K odd <= 31. q: dropout level
// in 1/256 (0 = none), dscale its keep scale 256 / (256 - q), seed the
// hash's int32 seed (tile = utterance).
extern "C" int espnet_conv_module_fwd(
    const void* x, const float* mask, const float* ln1s, const float* ln1b,
    const void* w1, const float* b1, const void* dw, const float* db,
    const float* ln2s, const float* ln2b, const void* w2, const float* b2,
    void* y, int B, int T, int D, int K, int q, float dscale, int seed,
    int dtype, void* stream) {
  using namespace espnet_port;
  if (!shape_ok(B, T, D, K) || q < 0 || q > 255) return kUnsupported;
  const Params pr{ln1s, ln1b, w1, b1, dw, db, ln2s, ln2b, w2};
  ESPNET_CONV_MODULE_DISPATCH(module_fwd, module_fwd_tc, x, mask, pr, b2, y,
                              B, T, D, K, q, dscale, seed,
                              static_cast<cudaStream_t>(stream));
}

// Backward of espnet_conv_module_fwd (same inputs and options, the weights
// as there) for gy (B, T, D, x's dtype): dx (B, T, D). Scratch, W columns
// wide (float32: W = D; bf16: W = DP): u_buf, dc_buf (B*T, W) float32 and
// s_buf, dz_buf, xn_buf (B*T, W), dh_buf (B*T, 2W) in x's dtype; per tile
// of the kernels' frames (espnet_conv_module_tile_rows; B * ceil(T / rows)
// tiles) part_a (4, D) = (dLN2 scale, dLN2 bias, ddb, db2), part_b (4, D) =
// (dLN1 scale, dLN1 bias, db1 (2D)) and ddwp (K, D); dw1p (g1, W, 2W) and
// dw2p (g2, W, W) per group of r1 (r2) frames (float32: r = ceil(B*T/g));
// all float32 partial sums.
extern "C" int espnet_conv_module_bwd(
    const void* x, const float* mask, const float* ln1s, const float* ln1b,
    const void* w1, const float* b1, const void* dw, const float* db,
    const float* ln2s, const float* ln2b, const void* w2, const void* gy,
    void* dx, float* u_buf, float* dc_buf, void* s_buf, void* dz_buf,
    void* xn_buf, void* dh_buf, float* part_a, float* part_b, float* ddwp,
    float* dw1p, float* dw2p, int B, int T, int D, int K, int g1, int r1,
    int g2, int r2, int q, float dscale, int seed, int dtype, void* stream) {
  using namespace espnet_port;
  if (!shape_ok(B, T, D, K) || g1 < 1 || g2 < 1 || r1 < 1 || r2 < 1 ||
      q < 0 || q > 255)
    return kUnsupported;
  const Params pr{ln1s, ln1b, w1, b1, dw, db, ln2s, ln2b, w2};
  const Buffers bf{u_buf, dc_buf, s_buf, dz_buf, xn_buf, dh_buf,
                   part_a, part_b, ddwp, dw1p, dw2p};
  const Groups gr{g1, r1, g2, r2};
  ESPNET_CONV_MODULE_DISPATCH(module_bwd, module_bwd_tc, x, mask, pr, gy, dx,
                              bf, B, T, D, K, gr, q, dscale, seed,
                              static_cast<cudaStream_t>(stream));
}

// Frames a block owns (the tile of the partial sums) at model width D in
// dtype: 32 in float32, TcConv<DP>::TT in bf16; -1 for what the kernels do
// not take.
extern "C" int espnet_conv_module_tile_rows(int D, int dtype) {
  using namespace espnet_port;
  if (D < 1 || D > 512) return kUnsupported;
  if (dtype == kFloat32) return TT;
  if (dtype != kBFloat16) return kUnsupported;
  switch ((D + 127) / 128) {
    case 1: return TcConv<128>::TT;
    case 2: return TcConv<256>::TT;
    case 3: return TcConv<384>::TT;
    default: return TcConv<512>::TT;
  }
}
