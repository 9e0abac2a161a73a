// The conformer conv module's head and tail, forward and backward:
//
//   head: g = GLU(LN(x) W1 + b1)                  W1 (D, 2D)
//   tail: y = x_res + drop(swish(LN(g)) W2 + b2)  W2 (D, D), one seed
//
// They replace the Pallas `_glu_fwd_kernel` / `_glu_bwd_kernel` behind
// `fused_prenorm_glu` and `_tail_fwd_kernel` / `_tail_bwd_kernel` behind
// `fused_postnorm_proj` (espnet_tpu/ops/pallas_conv_glu.py). LayerNorm eps
// 1e-6; LN(x), swish(LN(g)), dh and dz are rounded to the input's dtype
// before each product and the sums are float32, as there. The tail's
// dropout is the FFN kernels' hash over 256-row logical tiles of the
// flattened rows (one seed, width D), bit for bit whatever the CUDA block;
// its backward regenerates the mask.
//
// What bounds them on an H100: at the bench's M = 30016 rows and D = 256
// in bf16 the head does 4·M·D² = 7.9 GFLOP against 2·M·D + 2·D² elements
// (30.7 MB) and the tail 2·M·D² = 3.9 GFLOP against 46 MB: some 250 and 85
// flops per byte, below the card's 295, so both forwards are bound by
// bytes (9.2 µs and 13.8 µs) at the bf16 tensor-core rate; the head's
// backward (12·M·D², 24 µs) by its operations, the tail's by its bytes.
//
// The Pallas backward sums the parameter gradients across its sequential
// grid. Blocks here run in no order, so each backward is two kernels, as
// the FFN's: a row kernel that owns a block of rows, recomputes the
// forward, writes dx (dg), the rounded operands of the weight gradient
// (LN(x) and dh; swish(LN(g)) and dz) and per-block partial sums of the
// LayerNorm and bias gradients; then the weight gradient as A^T B over
// groups of rows, whose few partial sums are added afterwards (no atomics).
// Rows past M are read as zeros and never stored or summed.
//
// Two designs, picked by dtype at the entry points:
//
// * float32, the parity mode (the 1e-4 checks): float32 FMAs on the CUDA
//   cores (tensor-core float32 would be TF32), built from the pieces of
//   ffn_kernels.cuh: `layer_norm_rows` (the swish as the tail's epilogue),
//   `tile_product` (32 rows by up to 512 columns, weights staged through
//   shared memory in 32-deep slabs), the hash, `ln_bwd_row` and
//   `store_block_sums`; the weight gradients on `atb_kernel`. The dx
//   kernels' shared memory at D = 512 is 197 KB.
//
// * bf16, on tensor cores (mma.sync m16n8k16 with bf16 operands and
//   float32 sums, ldmatrix fragments from shared-memory rows padded by 16
//   bytes, and one three-stage cp.async ring of 10 KB weight slabs that a
//   kernel's products walk in a fixed job order; the pieces of
//   conv_tc.cuh, which the whole-module kernels use too). A block of 8
//   warps (2 rows x 4 columns) owns 64 rows at D <= 256 and 32 above
//   (`TcGlu`, ops/ffn_common.py TC_ROWS_PER_BLOCK), so the float32
//   accumulators of a row kernel's D-wide product fit in registers at
//   D = 512. Its input rows arrive by cp.async in one round trip and are
//   normalised in place. mma.sync rather than wgmma because the GLU, its
//   gradient, the hash and the rounding points sit on the fragments
//   between products.
//   - `glu_fwd_tc_kernel`: LN(x) rounded in a bf16 tile; per 64 output
//     columns c0, the slabs of W1[:, c0..] and W1[:, D + c0..] arrive
//     side by side (`load_w1_head`), so a warp holds the a and the gate
//     accumulators of the same columns and the GLU runs on its fragments;
//     g is rounded once into a small tile that the next job stores, 16
//     bytes a thread. x is read once and g written once; W1 comes from L2.
//   - `glu_bwd_rows_tc_kernel`: the same LN(x) (to xn_buf too) and, per
//     64 columns, h on mma, dh = (dg·s, dg·a·s(1−s)) in float32 on the
//     fragments (dg loaded while the chunk's product runs), db1's
//     per-block partials of the unrounded dh, dh rounded into a tile (to
//     dh_buf, coalesced), and dxn += dh·W1ᵀ on mma into float32 registers
//     for all D columns (W1 rows as [n][k] slabs); then dxn through shared
//     memory to one warp per row for the LayerNorm backward (dx and the
//     partials of dLN scale and bias). Capped at 128 registers, two blocks
//     an SM. dW1 = xnᵀ·dh on `atb_tc_kernel` over the row groups of
//     `wgrad_split`.
//   - `tail_fwd_tc_kernel`: swish(LN(g)) rounded in a bf16 tile; z = a·W2
//     on mma per 128 output columns; b2, the hash (by the row's logical
//     256-row tile) and x_res (loaded while the chunk's product runs) on
//     the fragments, rounded once.
//   - `tail_bwd_rows_tc_kernel`: g and dy staged; swish(LN(g)) to a_buf
//     (its mean and 1/std kept); dz = drop(dy), its db2 partials
//     unrounded, rounded into the tile where g was and to dz_buf; da =
//     dz·W2ᵀ on mma into float32 registers for all D columns; then one
//     warp per row: dgn = da·swish'(LN(g)) and the LayerNorm backward (dg
//     and the partials). dW2 = aᵀ·dz on `atb_tc_kernel`.
//   Shared memory per block (bytes, D 256 / 512): head forward 73,728 /
//   68,608, head backward 83,456 / 73,984, tail forward 64,512 / 64,000,
//   tail backward 98,816 / 97,536: three blocks an SM for the forwards,
//   two for the backwards. At the bench shape the grid is 469 blocks.
#include "conv_tc.cuh"

namespace espnet_port {
namespace {

static_assert(2 * BF == THREADS, "the db1 sums take one thread a column");

// ---------------------------------------------------------------------------
// float32 on the CUDA cores: the head
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t glu_fwd_smem_bytes() {
  return sizeof(float) * (BM * (D + 1) + KS * BF);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    glu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ lns,
                   const float* __restrict__ lnb, const T* __restrict__ w1,
                   const float* __restrict__ b1, T* __restrict__ g, int M) {
  extern __shared__ float smem[];
  float* xn_s = smem;
  float* w_s = xn_s + BM * (D + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * BM;
  layer_norm_rows<T, D>(x, lns, lnb, xn_s, nullptr, nullptr, row0, M);
  for (int c0 = 0; c0 < D; c0 += BF) {
    float ha[4][4] = {}, hg[4][4] = {};
    tile_product<T, 4, false>(xn_s, D + 1, w1 + c0, 2 * D, D, BF, w_s, ha);
    tile_product<T, 4, false>(xn_s, D + 1, w1 + D + c0, 2 * D, D, BF, w_s,
                              hg);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int gi = row0 + warp + 8 * ii;
      if (gi >= M) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int f = c0 + lane + 32 * jj;
        const float a = ha[ii][jj] + b1[f];
        g[static_cast<size_t>(gi) * D + f] =
            from_f32<T>(a * sigmoidf(hg[ii][jj] + b1[D + f]));
      }
    }
  }
}

template <int D>
constexpr size_t glu_bwd_smem_bytes() {
  // LN(x) rows, the dh chunk (a and gate halves), the weight slab (the
  // transposed one is the widest), row mean and 1/std
  return sizeof(float) *
         (BM * (D + 1) + BM * (2 * BF + 1) + KS * (D + 1) + 2 * BM);
}

// dx of the head, the rounded LN(x) and dh (M x 2D) for the weight gradient,
// and per block the partial sums partial[block] = (dLN scale, dLN bias, db1
// (2D)) as 4 x D floats.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    glu_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ lns,
                      const float* __restrict__ lnb, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ dg,
                      T* __restrict__ dx, T* __restrict__ xn_out,
                      T* __restrict__ dh_out, float* __restrict__ partial,
                      int M) {
  constexpr int LDX = D + 1;
  constexpr int LDH = 2 * BF + 1;
  constexpr int ZJ = D / 32;
  extern __shared__ float smem[];
  float* xn_s = smem;
  float* dh_s = xn_s + BM * LDX;
  float* w_s = dh_s + BM * LDH;
  float* mean_s = w_s + KS * (D + 1);
  float* inv_s = mean_s + BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * BM;
  float* part = partial + static_cast<size_t>(blockIdx.x) * 4 * D;

  layer_norm_rows<T, D>(x, lns, lnb, xn_s, mean_s, inv_s, row0, M);
  __syncthreads();
  for (int e = tid; e < BM * D; e += THREADS) {
    const int r = e / D, d = e % D;
    if (row0 + r < M)
      xn_out[static_cast<size_t>(row0 + r) * D + d] =
          from_f32<T>(xn_s[r * LDX + d]);
  }

  float z[4][ZJ] = {};  // d LN(x): rows warp+8ii, columns lane+32jj
  for (int c0 = 0; c0 < D; c0 += BF) {
    float ha[4][4] = {}, hg[4][4] = {};
    tile_product<T, 4, false>(xn_s, LDX, w1 + c0, 2 * D, D, BF, w_s, ha);
    tile_product<T, 4, false>(xn_s, LDX, w1 + D + c0, 2 * D, D, BF, w_s, hg);
    // dh = (dg * s, dg * a * s * (1 - s)), float32 (rows past M: dg = 0)
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = warp + 8 * ii;
      const int gi = row0 + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cc = lane + 32 * jj, f = c0 + cc;
        const float dgv =
            gi < M ? to_f32(dg[static_cast<size_t>(gi) * D + f]) : 0.f;
        const float a = ha[ii][jj] + b1[f];
        const float s = sigmoidf(hg[ii][jj] + b1[D + f]);
        dh_s[r * LDH + cc] = dgv * s;
        dh_s[r * LDH + BF + cc] = dgv * a * s * (1.f - s);
      }
    }
    __syncthreads();
    {  // db1 over the block's rows, from the unrounded dh; 2 * BF threads
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s += dh_s[r * LDH + tid];
      part[2 * D + (tid < BF ? c0 + tid : D + c0 + tid - BF)] = s;
    }
    __syncthreads();
    for (int e = tid; e < BM * 2 * BF; e += THREADS) {
      const int r = e / (2 * BF), cc = e % (2 * BF);
      const float v = round_to<T>(dh_s[r * LDH + cc]);
      dh_s[r * LDH + cc] = v;
      if (row0 + r < M)
        dh_out[static_cast<size_t>(row0 + r) * 2 * D +
               (cc < BF ? c0 + cc : D + c0 + cc - BF)] = from_f32<T>(v);
    }
    // d LN(x) += dh W1[:, chunk]^T for both halves
    tile_product<T, ZJ, true>(dh_s, LDH, w1 + c0, 2 * D, BF, D, w_s, z);
    tile_product<T, ZJ, true>(dh_s + BF, LDH, w1 + D + c0, 2 * D, BF, D, w_s,
                              z);
  }

  float sums[2][ZJ] = {};  // dLN scale, dLN bias
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = warp + 8 * ii;
    const int gi = row0 + r;
    if (gi >= M) continue;  // uniform across the warp
    const float mean = mean_s[r], inv = inv_s[r];
    float xh[ZJ], dxl[ZJ];
#pragma unroll
    for (int jj = 0; jj < ZJ; ++jj)
      xh[jj] = (to_f32(x[static_cast<size_t>(gi) * D + lane + 32 * jj]) -
                mean) * inv;
    ln_bwd_row<ZJ>(z[ii], xh, lns, inv, D, dxl, sums[0], sums[1]);
#pragma unroll
    for (int jj = 0; jj < ZJ; ++jj)
      dx[static_cast<size_t>(gi) * D + lane + 32 * jj] = from_f32<T>(dxl[jj]);
  }
  store_block_sums<2, ZJ>(sums, xn_s, part, D);
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores: the tail
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t tail_fwd_smem_bytes() {
  return sizeof(float) * (BM * (D + 1) + KS * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    tail_fwd_kernel(const T* __restrict__ g, const T* __restrict__ xr,
                    const float* __restrict__ lns,
                    const float* __restrict__ lnb, const T* __restrict__ w2,
                    const float* __restrict__ b2, T* __restrict__ y, int M,
                    int q, float dscale, int seed) {
  constexpr int ZJ = D / 32;
  extern __shared__ float smem[];
  float* a_s = smem;  // swish(LN(g)), rounded
  float* w_s = a_s + BM * (D + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * BM;
  layer_norm_rows<T, D, true>(g, lns, lnb, a_s, nullptr, nullptr, row0, M);
  float z[4][ZJ] = {};
  tile_product<T, ZJ, false>(a_s, D + 1, w2, D, D, D, w_s, z);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int gi = row0 + warp + 8 * ii;
    if (gi >= M) continue;
    const unsigned st = drop_stream(seed, gi);
#pragma unroll
    for (int jj = 0; jj < ZJ; ++jj) {
      const int n = lane + 32 * jj;
      const size_t e = static_cast<size_t>(gi) * D + n;
      float zz = z[ii][jj] + b2[n];
      if (q > 0) zz = drop_keep(st, gi, D, n, q) ? zz * dscale : 0.f;
      y[e] = from_f32<T>(to_f32(xr[e]) + zz);
    }
  }
}

template <int D>
constexpr size_t tail_bwd_smem_bytes() {
  // swish(LN(g)) rows, dz rows, the transposed weight slab, mean and 1/std
  return sizeof(float) * (2 * BM * (D + 1) + KS * (D + 1) + 2 * BM);
}

// dg of the tail, the rounded swish(LN(g)) and dz for the weight gradient,
// and per block partial[block] = (dLN scale, dLN bias, db2) as 3 x D floats.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    tail_bwd_dx_kernel(const T* __restrict__ g, const float* __restrict__ lns,
                       const float* __restrict__ lnb, const T* __restrict__ w2,
                       const T* __restrict__ dy, T* __restrict__ dg,
                       T* __restrict__ a_out, T* __restrict__ dz_out,
                       float* __restrict__ partial, int M, int q,
                       float dscale, int seed) {
  constexpr int LDX = D + 1;
  constexpr int ZJ = D / 32;
  extern __shared__ float smem[];
  float* a_s = smem;
  float* dz_s = a_s + BM * LDX;
  float* w_s = dz_s + BM * LDX;
  float* mean_s = w_s + KS * (D + 1);
  float* inv_s = mean_s + BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * BM;

  layer_norm_rows<T, D, true>(g, lns, lnb, a_s, mean_s, inv_s, row0, M);
  float sums[3][ZJ] = {};  // dLN scale, dLN bias, db2
  // dz = drop(dy), float32 into db2, rounded for the product; each warp's
  // own LN rows, so no barrier is needed before a_s is read here
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int r = warp * (BM / 8) + rr;
    const int gi = row0 + r;
    const unsigned st = drop_stream(seed, gi);
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      float v = 0.f;
      if (gi < M) {
        v = to_f32(dy[static_cast<size_t>(gi) * D + d]);
        if (q > 0) v = drop_keep(st, gi, D, d, q) ? v * dscale : 0.f;
        sums[2][e] += v;
      }
      const float vb = round_to<T>(v);
      dz_s[r * LDX + d] = vb;
      if (gi < M) {
        const size_t o = static_cast<size_t>(gi) * D + d;
        dz_out[o] = from_f32<T>(vb);
        a_out[o] = from_f32<T>(a_s[r * LDX + d]);
      }
    }
  }
  float da[4][ZJ] = {};  // dz W2^T
  tile_product<T, ZJ, true>(dz_s, LDX, w2, D, D, D, w_s, da);

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = warp + 8 * ii;
    const int gi = row0 + r;
    if (gi >= M) continue;  // uniform across the warp
    const float mean = mean_s[r], inv = inv_s[r];
    float xh[ZJ], dgn[ZJ], dgl[ZJ];
#pragma unroll
    for (int jj = 0; jj < ZJ; ++jj) {
      const int d = lane + 32 * jj;
      xh[jj] = (to_f32(g[static_cast<size_t>(gi) * D + d]) - mean) * inv;
      const float gn = xh[jj] * lns[d] + lnb[d];
      const float s = sigmoidf(gn);
      dgn[jj] = da[ii][jj] * (s * (1.f + gn * (1.f - s)));
    }
    ln_bwd_row<ZJ>(dgn, xh, lns, inv, D, dgl, sums[0], sums[1]);
#pragma unroll
    for (int jj = 0; jj < ZJ; ++jj)
      dg[static_cast<size_t>(gi) * D + lane + 32 * jj] = from_f32<T>(dgl[jj]);
  }
  store_block_sums<3, ZJ>(sums, a_s,
                          partial + static_cast<size_t>(blockIdx.x) * 3 * D,
                          D);
}

template <typename T, int D>
int glu_fwd(const void* x, const float* lns, const float* lnb, const void* w1,
            const float* b1, void* g, int M, cudaStream_t s) {
  auto k = glu_fwd_kernel<T, D>;
  const size_t smem = glu_fwd_smem_bytes<D>();
  if (int err = set_smem(k, smem)) return err;
  k<<<(M + BM - 1) / BM, THREADS, smem, s>>>(
      static_cast<const T*>(x), lns, lnb, static_cast<const T*>(w1), b1,
      static_cast<T*>(g), M);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int glu_bwd(const void* x, const float* lns, const float* lnb, const void* w1,
            const float* b1, const void* dg, void* dx, void* xn_buf,
            void* dh_buf, float* partial, float* dw1p, int M, int groups,
            int /* rows_per_group: launch_atb's ceil(M / groups) */,
            cudaStream_t s) {
  auto k = glu_bwd_dx_kernel<T, D>;
  const size_t smem = glu_bwd_smem_bytes<D>();
  if (int err = set_smem(k, smem)) return err;
  k<<<(M + BM - 1) / BM, THREADS, smem, s>>>(
      static_cast<const T*>(x), lns, lnb, static_cast<const T*>(w1), b1,
      static_cast<const T*>(dg), static_cast<T*>(dx), static_cast<T*>(xn_buf),
      static_cast<T*>(dh_buf), partial, M);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  return launch_atb<T>(static_cast<const T*>(xn_buf),
                       static_cast<const T*>(dh_buf), dw1p, M, D, 2 * D,
                       groups, s);
}

template <typename T, int D>
int tail_fwd(const void* g, const void* xr, const float* lns,
             const float* lnb, const void* w2, const float* b2, void* y,
             int M, int q, float dscale, int seed, cudaStream_t s) {
  auto k = tail_fwd_kernel<T, D>;
  const size_t smem = tail_fwd_smem_bytes<D>();
  if (int err = set_smem(k, smem)) return err;
  k<<<(M + BM - 1) / BM, THREADS, smem, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(xr), lns, lnb,
      static_cast<const T*>(w2), b2, static_cast<T*>(y), M, q, dscale, seed);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int tail_bwd(const void* g, const float* lns, const float* lnb,
             const void* w2, const void* dy, void* dg, void* a_buf,
             void* dz_buf, float* partial, float* dw2p, int M, int groups,
             int /* rows_per_group: launch_atb's ceil(M / groups) */, int q,
             float dscale, int seed, cudaStream_t s) {
  auto k = tail_bwd_dx_kernel<T, D>;
  const size_t smem = tail_bwd_smem_bytes<D>();
  if (int err = set_smem(k, smem)) return err;
  k<<<(M + BM - 1) / BM, THREADS, smem, s>>>(
      static_cast<const T*>(g), lns, lnb, static_cast<const T*>(w2),
      static_cast<const T*>(dy), static_cast<T*>(dg), static_cast<T*>(a_buf),
      static_cast<T*>(dz_buf), partial, M, q, dscale, seed);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  return launch_atb<T>(static_cast<const T*>(a_buf),
                       static_cast<const T*>(dz_buf), dw2p, M, D, D, groups,
                       s);
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int D>
struct TcGlu {
  static constexpr int BMR = D <= 256 ? 64 : 32;  // rows a block owns
  static constexpr int MT = BMR / 32;     // m-tiles per row warp
  static constexpr int LDX = D + 8;       // bf16 stride: LN(x), swish, dz
  static constexpr int LDZ = D + 8;       // float stride: dxn, da
  static constexpr int LDG = HEAD_C + 8;  // bf16 stride: the head's g chunk
  static constexpr int KS = D / SLAB_K;   // slabs along a reduction over D
  static constexpr int NOC = D / SLAB_N;  // 128-wide output chunks
  static constexpr int X_BYTES = BMR * LDX * 2;
  static constexpr int RING_BYTES = RING * SLAB_ELEMS * 2;
  static constexpr int Z_BYTES = BMR * LDZ * 4;
  // LN(x) | ring | g chunk
  static constexpr size_t head_fwd_bytes =
      X_BYTES + RING_BYTES + BMR * LDG * 2;
  // swish(LN(g)) | ring
  static constexpr size_t tail_fwd_bytes = X_BYTES + RING_BYTES;
  // LN(x) | dh chunk | ring, later dxn and the block sums | db1 sums of the
  // two row warps, mean, 1/std
  static constexpr int HB_U =
      cmax(X_BYTES + BMR * LDKN * 2 + RING_BYTES, Z_BYTES);
  static constexpr size_t head_bwd_bytes = HB_U + (2 * SLAB_N + 2 * BMR) * 4;
  // g, then dz | dy | ring, later da and the block sums | mean, 1/std
  static constexpr int TB_U = cmax(2 * X_BYTES + RING_BYTES, Z_BYTES);
  static constexpr size_t tail_bwd_bytes = TB_U + 2 * BMR * 4;
  static_assert(D % SLAB_N == 0 && BMR % 32 == 0, "whole slabs, m-tiles");
  static_assert(8 * 2 * D * 4 <= HB_U && 8 * 3 * D * 4 <= TB_U,
                "the block sums reuse the tiles");
  static_assert(head_fwd_bytes <= 232448 && head_bwd_bytes <= 232448 &&
                    tail_bwd_bytes <= 232448,
                "a block may have 227 KB");
};

// Rows row0 .. row0 + BMR - 1 of x (M x D, 16-byte aligned) into t_s
// (stride D + 8) by cp.async, zeros past M, as one committed group: one
// round trip to device memory for the block's rows.
template <int D, int BMR>
__device__ __forceinline__ void stage_rows(bf16* t_s,
                                           const bf16* __restrict__ x,
                                           int row0, int M) {
  constexpr int C = D / 8;  // 16-byte chunks of a row
  for (int e = threadIdx.x; e < BMR * C; e += THREADS) {
    const int r = e / C, c = e % C;
    const bool ok = row0 + r < M;
    cp_async16(t_s + r * (D + 8) + c * 8,
               x + static_cast<size_t>(ok ? row0 + r : 0) * D + c * 8,
               ok ? 16 : 0);
  }
  cp_async_commit();
}

// LayerNorm (eps 1e-6) of the block's staged rows in t_s (stride D + 8),
// with the swish where SWISH, rounded to bf16 in place; rows past M stay
// zeros, and the rows below M also go to out (M x D) when given. With
// mean_s, each row's mean and 1/std. Warp w takes rows w, w + 8, ...
template <int D, int BMR, bool SWISH>
__device__ void ln_block_rows(bf16* t_s, const float* __restrict__ lns,
                              const float* __restrict__ lnb, int row0, int M,
                              float* mean_s, float* inv_s,
                              bf16* __restrict__ out) {
  constexpr int ZJ = D / 32, LDX = D + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < BMR; r += 8) {
    const int gi = row0 + r;
    const bool ok = gi < M;
    float v[ZJ];
#pragma unroll
    for (int e = 0; e < ZJ; ++e) v[e] = to_f32(t_s[r * LDX + lane + 32 * e]);
    float mean, inv;
    ln_vals<ZJ, SWISH>(v, D, lns, lnb, mean, inv);
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      const bf16 vb = __float2bfloat16(ok ? v[e] : 0.f);
      t_s[r * LDX + d] = vb;
      if (out != nullptr && ok) out[static_cast<size_t>(gi) * D + d] = vb;
    }
    if (mean_s != nullptr && lane == 0) {
      mean_s[r] = mean;
      inv_s[r] = inv;
    }
  }
}

// g = GLU(LN(x) W1 + b1) of the block's rows (the a half is W1's columns
// 0..D-1, the gate half D..2D-1).
template <int D>
__global__ void __launch_bounds__(THREADS)
    glu_fwd_tc_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ lns,
                      const float* __restrict__ lnb,
                      const bf16* __restrict__ w1,
                      const float* __restrict__ b1, bf16* __restrict__ g,
                      int M) {
  using L = TcGlu<D>;
  constexpr int BMR = L::BMR, MT = L::MT, LDX = L::LDX, LDG = L::LDG;
  constexpr int KS = L::KS, NJ = (D / HEAD_C) * KS;
  constexpr int CG = HEAD_C / 8;  // 16-byte chunks of a g chunk's row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xn_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + L::X_BYTES);
  bf16* g_s = ring + RING * SLAB_ELEMS;  // [BMR][LDG]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, gq = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * BMR;

  // jobs: per 64 output columns, the KS slabs of both halves
  auto fetch = [&](int j) {
    if (j < NJ)
      load_w1_head<D>(ring + (j % RING) * SLAB_ELEMS, w1, (j % KS) * SLAB_K,
                      (j / KS) * HEAD_C);
    cp_async_commit();
  };
  // the g chunk at columns c0 to device memory, rows past M dropped
  auto store_g = [&](int c0) {
    for (int e = tid; e < BMR * CG; e += THREADS) {
      const int r = e / CG, c = e % CG;
      if (row0 + r < M)
        *reinterpret_cast<uint4*>(g + static_cast<size_t>(row0 + r) * D +
                                  c0 + c * 8) =
            *reinterpret_cast<const uint4*>(g_s + r * LDG + c * 8);
    }
  };
  stage_rows<D, BMR>(xn_s, x, row0, M);
  fetch(0);
  fetch(1);
  cp_async_wait<2>();
  __syncthreads();  // x staged
  ln_block_rows<D, BMR, false>(xn_s, lns, lnb, row0, M, nullptr, nullptr,
                               nullptr);

  float acc[MT][4][4];
  zero(acc);
  for (int j = 0; j < NJ; ++j) {
    cp_async_wait<RING - 2>();
    __syncthreads();  // slab j landed; job j-1's readers are done
    fetch(j + RING - 1);
    const int ks = j % KS, c0 = (j / KS) * HEAD_C;
    if (ks == 0 && j > 0) store_g(c0 - HEAD_C);  // the last chunk's tile
    head_slab<MT, LDX>(acc, xn_s, ring + (j % RING) * SLAB_ELEMS,
                       ks * SLAB_K, BMR / 16, wm, wn);
    if (ks != KS - 1) continue;
    // g = (a + b1) sigmoid(gate + b1), rounded into the g tile
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm + 2 * i) * 16 + gq + 8 * h;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = wn * 16 + nt * 8 + 2 * t4;
          float gv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int f = c0 + col + e;
            gv[e] = (acc[i][nt][2 * h + e] + b1[f]) *
                    sigmoidf(acc[i][nt + 2][2 * h + e] + b1[D + f]);
          }
          *reinterpret_cast<__nv_bfloat162*>(g_s + r * LDG + col) =
              __floats2bfloat162_rn(gv[0], gv[1]);
        }
      }
    zero(acc);
  }
  cp_async_wait<0>();
  __syncthreads();
  store_g(D - HEAD_C);
}

// Backward of the head, the row kernel: dx, the rounded LN(x) (xn_buf, M x
// D) and dh (dh_buf, M x 2D, the a half then the gate half) for the weight
// gradient, and partial[block] = (dLN scale, dLN bias, db1 (2D)) as 4 x D
// floats.
template <int D>
__global__ void __launch_bounds__(THREADS, 2)  // two blocks an SM
    glu_bwd_rows_tc_kernel(const bf16* __restrict__ x,
                           const float* __restrict__ lns,
                           const float* __restrict__ lnb,
                           const bf16* __restrict__ w1,
                           const float* __restrict__ b1,
                           const bf16* __restrict__ dg, bf16* __restrict__ dx,
                           bf16* __restrict__ xn_buf,
                           bf16* __restrict__ dh_buf,
                           float* __restrict__ partial, int M) {
  using L = TcGlu<D>;
  constexpr int BMR = L::BMR, MT = L::MT, LDX = L::LDX, LDZ = L::LDZ;
  constexpr int KS = L::KS, NOC = L::NOC, ZJ = D / 32;
  constexpr int JC = KS + 4 * NOC;  // jobs a chunk: the head's, then dxn's
  constexpr int NJ = (D / HEAD_C) * JC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xn_s = reinterpret_cast<bf16*>(smem_raw);  // then dxn, block sums
  bf16* dh_s = xn_s + BMR * LDX;                   // [BMR][LDKN]
  bf16* ring = dh_s + BMR * LDKN;
  float* z_s = reinterpret_cast<float*>(smem_raw);
  float* red_s = reinterpret_cast<float*>(smem_raw + L::HB_U);  // [2][128]
  float* mean_s = red_s + 2 * SLAB_N;
  float* inv_s = mean_s + BMR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, gq = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * BMR;
  float* pt = partial + static_cast<size_t>(blockIdx.x) * 4 * D;

  auto fetch = [&](int j) {
    if (j < NJ) {
      bf16* slab = ring + (j % RING) * SLAB_ELEMS;
      const int c0 = (j / JC) * HEAD_C, jc = j % JC;
      if (jc < KS) {
        load_w1_head<D>(slab, w1, jc * SLAB_K, c0);
      } else {  // dxn: W1 rows oc*128.. (dxn columns), dh columns kq*32..
        const int kq = (jc - KS) / NOC, oc = (jc - KS) % NOC;
        const int f0 = (kq < 2 ? c0 : D + c0 - HEAD_C) + kq * SLAB_K;
        load_nk(slab, w1, 2 * D, oc * SLAB_N, f0);
      }
    }
    cp_async_commit();
  };
  stage_rows<D, BMR>(xn_s, x, row0, M);
  fetch(0);
  fetch(1);
  cp_async_wait<2>();
  __syncthreads();  // x staged
  ln_block_rows<D, BMR, false>(xn_s, lns, lnb, row0, M, mean_s, inv_s,
                               xn_buf);

  float acc[MT][4][4], dxn[NOC][MT][4][4];
  zero(acc);
#pragma unroll
  for (int o = 0; o < NOC; ++o) zero(dxn[o]);
  __nv_bfloat162 dgp[MT][2][2];  // this chunk's dg at the fragments
  for (int j = 0; j < NJ; ++j) {
    cp_async_wait<RING - 2>();
    __syncthreads();  // slab j landed; job j-1's readers are done
    fetch(j + RING - 1);
    const bf16* slab = ring + (j % RING) * SLAB_ELEMS;
    const int c0 = (j / JC) * HEAD_C, jc = j % JC;
    if (jc == 0) {  // dg of the chunk, loaded while its product runs
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gi = row0 + (wm + 2 * i) * 16 + gq + 8 * h;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            dgp[i][h][nt] =
                gi < M ? *reinterpret_cast<const __nv_bfloat162*>(
                             dg + static_cast<size_t>(gi) * D + c0 + wn * 16 +
                             nt * 8 + 2 * t4)
                       : __floats2bfloat162_rn(0.f, 0.f);
        }
    }
    if (jc < KS) {
      head_slab<MT, LDX>(acc, xn_s, slab, jc * SLAB_K, BMR / 16, wm, wn);
      if (jc < KS - 1) continue;
      // dh = (dg s, dg a s (1 - s)) on the fragments, float32: rounded into
      // the dh tile, summed unrounded into db1 (rows past M: dg = 0)
      float db1v[4][2] = {};
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (wm + 2 * i) * 16 + gq + 8 * h;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int col = wn * 16 + nt * 8 + 2 * t4;
            const float dgv[2] = {__low2float(dgp[i][h][nt]),
                                  __high2float(dgp[i][h][nt])};
            float da[2], dgt[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int f = c0 + col + e;
              const float a = acc[i][nt][2 * h + e] + b1[f];
              const float s = sigmoidf(acc[i][nt + 2][2 * h + e] + b1[D + f]);
              da[e] = dgv[e] * s;
              dgt[e] = dgv[e] * a * s * (1.f - s);
              db1v[nt][e] += da[e];
              db1v[nt + 2][e] += dgt[e];
            }
            *reinterpret_cast<__nv_bfloat162*>(dh_s + r * LDKN + col) =
                __floats2bfloat162_rn(da[0], da[1]);
            *reinterpret_cast<__nv_bfloat162*>(dh_s + r * LDKN + HEAD_C +
                                               col) =
                __floats2bfloat162_rn(dgt[0], dgt[1]);
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
          if (gq == 0)
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
      for (int e = tid; e < BMR * 16; e += THREADS) {
        const int r = e >> 4, c = e & 15;
        if (row0 + r >= M) continue;
        const int col = (c < 8 ? c0 : D + c0 - HEAD_C) + c * 8;
        *reinterpret_cast<uint4*>(
            dh_buf + static_cast<size_t>(row0 + r) * 2 * D + col) =
            *reinterpret_cast<const uint4*>(dh_s + r * LDKN + c * 8);
      }
      if (tid < SLAB_N) {
        const int f = c0 + (tid & (HEAD_C - 1));
        pt[2 * D + (tid < HEAD_C ? f : D + f)] =
            red_s[tid] + red_s[SLAB_N + tid];
      }
    }
    // dxn[:, oc*128..] += dh[:, kq*32..] W1[oc*128.., f0..]^T
#pragma unroll
    for (int o = 0; o < NOC; ++o)
      if (o == oc)
        tail_slab<MT, LDKN, false>(dxn[o], dh_s, slab, kq * SLAB_K, wm, wn);
  }
  cp_async_wait<0>();
  __syncthreads();  // every reader of the tiles and the ring is done

  // dxn through shared memory to one warp per row
#pragma unroll
  for (int o = 0; o < NOC; ++o)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * MT + i) * 16 + gq + 8 * h;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<float2*>(
              z_s + r * LDZ + o * SLAB_N + wn * 32 + nt * 8 + 2 * t4) =
              make_float2(dxn[o][i][nt][2 * h], dxn[o][i][nt][2 * h + 1]);
      }
  __syncthreads();
  float sums[2][ZJ];  // dLN scale, dLN bias
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < ZJ; ++e) sums[s][e] = 0.f;
  for (int r = warp; r < BMR; r += 8) {
    const int gi = row0 + r;
    if (gi >= M) continue;  // uniform across the warp
    const size_t base = static_cast<size_t>(gi) * D;
    const float mean = mean_s[r], inv = inv_s[r];
    float zv[ZJ], xh[ZJ], dxl[ZJ];
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      zv[e] = z_s[r * LDZ + d];
      xh[e] = (to_f32(x[base + d]) - mean) * inv;
    }
    ln_bwd_row<ZJ>(zv, xh, lns, inv, D, dxl, sums[0], sums[1]);
#pragma unroll
    for (int e = 0; e < ZJ; ++e)
      dx[base + lane + 32 * e] = __float2bfloat16(dxl[e]);
  }
  store_block_sums<2, ZJ>(sums, z_s, pt, D);
}

// y = x_res + drop(swish(LN(g)) W2 + b2) of the block's rows.
template <int D>
__global__ void __launch_bounds__(THREADS)
    tail_fwd_tc_kernel(const bf16* __restrict__ g, const bf16* __restrict__ xr,
                       const float* __restrict__ lns,
                       const float* __restrict__ lnb,
                       const bf16* __restrict__ w2,
                       const float* __restrict__ b2, bf16* __restrict__ y,
                       int M, int q, float dscale, int seed) {
  using L = TcGlu<D>;
  constexpr int BMR = L::BMR, MT = L::MT, LDX = L::LDX, KS = L::KS;
  constexpr int NJ = L::NOC * KS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + L::X_BYTES);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, gq = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * BMR;

  // jobs: per 128 output columns, the KS slabs of W2 as [k][n]
  auto fetch = [&](int j) {
    if (j < NJ)
      load_kn(ring + (j % RING) * SLAB_ELEMS, w2, D, (j % KS) * SLAB_K,
              (j / KS) * SLAB_N);
    cp_async_commit();
  };
  stage_rows<D, BMR>(a_s, g, row0, M);
  fetch(0);
  fetch(1);
  cp_async_wait<2>();
  __syncthreads();  // g staged
  ln_block_rows<D, BMR, true>(a_s, lns, lnb, row0, M, nullptr, nullptr,
                              nullptr);

  float z[MT][4][4];
  zero(z);
  __nv_bfloat162 xrp[MT][2][4];  // this chunk's x_res at the fragments
  for (int j = 0; j < NJ; ++j) {
    cp_async_wait<RING - 2>();
    __syncthreads();  // slab j landed; job j-1's readers are done
    fetch(j + RING - 1);
    const int ks = j % KS, n0 = (j / KS) * SLAB_N;
    if (ks == 0) {  // x_res of the chunk, loaded while its product runs
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gi = row0 + (wm * MT + i) * 16 + gq + 8 * h;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            xrp[i][h][nt] =
                gi < M ? *reinterpret_cast<const __nv_bfloat162*>(
                             xr + static_cast<size_t>(gi) * D + n0 +
                             wn * 32 + nt * 8 + 2 * t4)
                       : __floats2bfloat162_rn(0.f, 0.f);
        }
    }
    tail_slab<MT, LDX, true>(z, a_s, ring + (j % RING) * SLAB_ELEMS,
                             ks * SLAB_K, wm, wn);
    if (ks != KS - 1) continue;
    // y = x_res + drop(z + b2), the hash by the row's logical tile; rounded
    // once
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gi = row0 + (wm * MT + i) * 16 + gq + 8 * h;
        if (gi >= M) continue;
        const unsigned st = drop_stream(seed, gi);
        const size_t base = static_cast<size_t>(gi) * D;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n0 + wn * 32 + nt * 8 + 2 * t4;
          const float xv[2] = {__low2float(xrp[i][h][nt]),
                               __high2float(xrp[i][h][nt])};
          float out[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float zz = z[i][nt][2 * h + e] + b2[n + e];
            if (q > 0)
              zz = drop_keep(st, gi, D, n + e, q) ? zz * dscale : 0.f;
            out[e] = xv[e] + zz;
          }
          *reinterpret_cast<__nv_bfloat162*>(y + base + n) =
              __floats2bfloat162_rn(out[0], out[1]);
        }
      }
    zero(z);
  }
  cp_async_wait<0>();
}

// Backward of the tail, the row kernel: dg, the rounded swish(LN(g)) (a_buf)
// and dz (dz_buf), M x D each, for the weight gradient, and partial[block]
// = (dLN scale, dLN bias, db2) as 3 x D floats.
template <int D>
__global__ void __launch_bounds__(THREADS)
    tail_bwd_rows_tc_kernel(const bf16* __restrict__ g,
                            const float* __restrict__ lns,
                            const float* __restrict__ lnb,
                            const bf16* __restrict__ w2,
                            const bf16* __restrict__ dy,
                            bf16* __restrict__ dg, bf16* __restrict__ a_buf,
                            bf16* __restrict__ dz_buf,
                            float* __restrict__ partial, int M, int q,
                            float dscale, int seed) {
  using L = TcGlu<D>;
  constexpr int BMR = L::BMR, MT = L::MT, LDX = L::LDX, LDZ = L::LDZ;
  constexpr int KS = L::KS, NOC = L::NOC, NJ = NOC * KS, ZJ = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* dz_s = reinterpret_cast<bf16*>(smem_raw);  // g, dz; then da, sums
  bf16* dy_s = dz_s + BMR * LDX;
  bf16* ring = dy_s + BMR * LDX;
  float* z_s = reinterpret_cast<float*>(smem_raw);
  float* mean_s = reinterpret_cast<float*>(smem_raw + L::TB_U);
  float* inv_s = mean_s + BMR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, gq = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * BMR;

  // jobs: per 128 columns of da, the KS slabs of W2's rows as [n][k]
  auto fetch = [&](int j) {
    if (j < NJ)
      load_nk(ring + (j % RING) * SLAB_ELEMS, w2, D, (j / KS) * SLAB_N,
              (j % KS) * SLAB_K);
    cp_async_commit();
  };
  stage_rows<D, BMR>(dz_s, g, row0, M);
  stage_rows<D, BMR>(dy_s, dy, row0, M);
  fetch(0);
  fetch(1);
  cp_async_wait<2>();
  __syncthreads();  // g and dy staged
  // swish(LN(g)) in place, to a_buf; the dz tile then overwrites it row by
  // row (each warp its own rows)
  ln_block_rows<D, BMR, true>(dz_s, lns, lnb, row0, M, mean_s, inv_s, a_buf);
  float sums[3][ZJ];  // dLN scale, dLN bias, db2
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int e = 0; e < ZJ; ++e) sums[s][e] = 0.f;
  // dz = drop(dy), the hash by the row's logical tile: float32 into db2,
  // rounded into the dz tile and dz_buf; zeros past M
  for (int r = warp; r < BMR; r += 8) {
    const int gi = row0 + r;
    const bool ok = gi < M;
    const unsigned st = drop_stream(seed, gi);
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      float v = 0.f;
      if (ok) {
        v = to_f32(dy_s[r * LDX + d]);
        if (q > 0) v = drop_keep(st, gi, D, d, q) ? v * dscale : 0.f;
        sums[2][e] += v;
      }
      const bf16 vb = __float2bfloat16(v);
      dz_s[r * LDX + d] = vb;
      if (ok) dz_buf[static_cast<size_t>(gi) * D + d] = vb;
    }
  }

  float da[NOC][MT][4][4];  // dz W2^T
#pragma unroll
  for (int o = 0; o < NOC; ++o) zero(da[o]);
  for (int j = 0; j < NJ; ++j) {
    cp_async_wait<RING - 2>();
    __syncthreads();  // slab j landed (and the dz tile); job j-1's readers
                      // are done
    fetch(j + RING - 1);
    const int oc = j / KS, ks = j % KS;
#pragma unroll
    for (int o = 0; o < NOC; ++o)
      if (o == oc)
        tail_slab<MT, LDX, false>(da[o], dz_s, ring + (j % RING) * SLAB_ELEMS,
                                  ks * SLAB_K, wm, wn);
  }
  cp_async_wait<0>();
  __syncthreads();  // every reader of the dz tile and the ring is done

  // da through shared memory to one warp per row
#pragma unroll
  for (int o = 0; o < NOC; ++o)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * MT + i) * 16 + gq + 8 * h;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<float2*>(
              z_s + r * LDZ + o * SLAB_N + wn * 32 + nt * 8 + 2 * t4) =
              make_float2(da[o][i][nt][2 * h], da[o][i][nt][2 * h + 1]);
      }
  __syncthreads();
  // dgn = da swish'(LN(g)), then the LayerNorm backward
  for (int r = warp; r < BMR; r += 8) {
    const int gi = row0 + r;
    if (gi >= M) continue;  // uniform across the warp
    const size_t base = static_cast<size_t>(gi) * D;
    const float mean = mean_s[r], inv = inv_s[r];
    float xh[ZJ], dgn[ZJ], dgl[ZJ];
#pragma unroll
    for (int e = 0; e < ZJ; ++e) {
      const int d = lane + 32 * e;
      xh[e] = (to_f32(g[base + d]) - mean) * inv;
      const float gn = xh[e] * lns[d] + lnb[d];
      const float s = sigmoidf(gn);
      dgn[e] = z_s[r * LDZ + d] * (s * (1.f + gn * (1.f - s)));
    }
    ln_bwd_row<ZJ>(dgn, xh, lns, inv, D, dgl, sums[0], sums[1]);
#pragma unroll
    for (int e = 0; e < ZJ; ++e)
      dg[base + lane + 32 * e] = __float2bfloat16(dgl[e]);
  }
  store_block_sums<3, ZJ>(sums, z_s,
                          partial + static_cast<size_t>(blockIdx.x) * 3 * D,
                          D);
}

template <int D>
int glu_fwd_tc(const void* x, const float* lns, const float* lnb,
               const void* w1, const float* b1, void* g, int M,
               cudaStream_t s) {
  using L = TcGlu<D>;
  auto k = glu_fwd_tc_kernel<D>;
  if (int err = set_smem(k, L::head_fwd_bytes)) return err;
  k<<<(M + L::BMR - 1) / L::BMR, THREADS, L::head_fwd_bytes, s>>>(
      static_cast<const bf16*>(x), lns, lnb, static_cast<const bf16*>(w1),
      b1, static_cast<bf16*>(g), M);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int glu_bwd_tc(const void* x, const float* lns, const float* lnb,
               const void* w1, const float* b1, const void* dg, void* dx,
               void* xn_buf, void* dh_buf, float* partial, float* dw1p, int M,
               int groups, int rows_per_group, cudaStream_t s) {
  using L = TcGlu<D>;
  auto k = glu_bwd_rows_tc_kernel<D>;
  if (int err = set_smem(k, L::head_bwd_bytes)) return err;
  k<<<(M + L::BMR - 1) / L::BMR, THREADS, L::head_bwd_bytes, s>>>(
      static_cast<const bf16*>(x), lns, lnb, static_cast<const bf16*>(w1),
      b1, static_cast<const bf16*>(dg), static_cast<bf16*>(dx),
      static_cast<bf16*>(xn_buf), static_cast<bf16*>(dh_buf), partial, M);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  // dW1 = LN(x)^T dh: (D, 2D)
  return launch_atb_tc(static_cast<const bf16*>(xn_buf),
                       static_cast<const bf16*>(dh_buf), dw1p, M, D, 2 * D,
                       groups, rows_per_group, s);
}

template <int D>
int tail_fwd_tc(const void* g, const void* xr, const float* lns,
                const float* lnb, const void* w2, const float* b2, void* y,
                int M, int q, float dscale, int seed, cudaStream_t s) {
  using L = TcGlu<D>;
  auto k = tail_fwd_tc_kernel<D>;
  if (int err = set_smem(k, L::tail_fwd_bytes)) return err;
  k<<<(M + L::BMR - 1) / L::BMR, THREADS, L::tail_fwd_bytes, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(xr), lns, lnb,
      static_cast<const bf16*>(w2), b2, static_cast<bf16*>(y), M, q, dscale,
      seed);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int tail_bwd_tc(const void* g, const float* lns, const float* lnb,
                const void* w2, const void* dy, void* dg, void* a_buf,
                void* dz_buf, float* partial, float* dw2p, int M, int groups,
                int rows_per_group, int q, float dscale, int seed,
                cudaStream_t s) {
  using L = TcGlu<D>;
  auto k = tail_bwd_rows_tc_kernel<D>;
  if (int err = set_smem(k, L::tail_bwd_bytes)) return err;
  k<<<(M + L::BMR - 1) / L::BMR, THREADS, L::tail_bwd_bytes, s>>>(
      static_cast<const bf16*>(g), lns, lnb, static_cast<const bf16*>(w2),
      static_cast<const bf16*>(dy), static_cast<bf16*>(dg),
      static_cast<bf16*>(a_buf), static_cast<bf16*>(dz_buf), partial, M, q,
      dscale, seed);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  // dW2 = swish(LN(g))^T dz: (D, D)
  return launch_atb_tc(static_cast<const bf16*>(a_buf),
                       static_cast<const bf16*>(dz_buf), dw2p, M, D, D,
                       groups, rows_per_group, s);
}

}  // namespace
}  // namespace espnet_port

// Dispatch on dtype and D in {128, 256, 384, 512}: float32 to the CUDA-core
// kernels FN<float, D>, bf16 to the tensor-core FN_TC<D>.
#define ESPNET_CONV_GLU_DISPATCH(FN, FN_TC, ...)                             \
  do {                                                                       \
    if (dtype == kFloat32 && D == 128) return FN<float, 128>(__VA_ARGS__);   \
    if (dtype == kFloat32 && D == 256) return FN<float, 256>(__VA_ARGS__);   \
    if (dtype == kFloat32 && D == 384) return FN<float, 384>(__VA_ARGS__);   \
    if (dtype == kFloat32 && D == 512) return FN<float, 512>(__VA_ARGS__);   \
    if (dtype == kBFloat16 && D == 128) return FN_TC<128>(__VA_ARGS__);      \
    if (dtype == kBFloat16 && D == 256) return FN_TC<256>(__VA_ARGS__);      \
    if (dtype == kBFloat16 && D == 384) return FN_TC<384>(__VA_ARGS__);      \
    if (dtype == kBFloat16 && D == 512) return FN_TC<512>(__VA_ARGS__);      \
    return kUnsupported;                                                     \
  } while (0)

// x, g: (M, D); w1: (D, 2D), of one dtype, contiguous (bf16: 16-byte
// aligned); lns, lnb: (D,), b1: (2D,) float32.
extern "C" int espnet_conv_glu_fwd(const void* x, const float* lns,
                                   const float* lnb, const void* w1,
                                   const float* b1, void* g, int M, int D,
                                   int dtype, void* stream) {
  using namespace espnet_port;
  if (M < 1) return kUnsupported;
  ESPNET_CONV_GLU_DISPATCH(glu_fwd, glu_fwd_tc, x, lns, lnb, w1, b1, g, M,
                           static_cast<cudaStream_t>(stream));
}

// Backward of espnet_conv_glu_fwd for dg (M, D, x's dtype): dx (M, D),
// scratch xn_buf (M, D) and dh_buf (M, 2D) in x's dtype, partial (row
// blocks of espnet_conv_glu_rows_per_block rows, 4, D) float32 = per-block
// (dLN scale, dLN bias, db1 (2D)), dw1p (groups, D, 2D) float32 = the sums
// of dW1 over groups of rows_per_group rows (float32: ceil(M / groups)).
extern "C" int espnet_conv_glu_bwd(const void* x, const float* lns,
                                   const float* lnb, const void* w1,
                                   const float* b1, const void* dg, void* dx,
                                   void* xn_buf, void* dh_buf, float* partial,
                                   float* dw1p, int M, int D, int groups,
                                   int rows_per_group, int dtype,
                                   void* stream) {
  using namespace espnet_port;
  if (M < 1 || groups < 1 || rows_per_group < 1) return kUnsupported;
  ESPNET_CONV_GLU_DISPATCH(glu_bwd, glu_bwd_tc, x, lns, lnb, w1, b1, dg, dx,
                           xn_buf, dh_buf, partial, dw1p, M, groups,
                           rows_per_group, static_cast<cudaStream_t>(stream));
}

// g, x_res, y: (M, D); w2: (D, D), of one dtype, contiguous (bf16: 16-byte
// aligned); lns, lnb, b2: (D,) float32. q: dropout level in 1/256 (0 =
// none), dscale its keep scale 256 / (256 - q), seed the hash's int32 seed.
extern "C" int espnet_conv_tail_fwd(const void* g, const void* xr,
                                    const float* lns, const float* lnb,
                                    const void* w2, const float* b2, void* y,
                                    int M, int D, int q, float dscale,
                                    int seed, int dtype, void* stream) {
  using namespace espnet_port;
  if (M < 1 || q < 0 || q > 255) return kUnsupported;
  ESPNET_CONV_GLU_DISPATCH(tail_fwd, tail_fwd_tc, g, xr, lns, lnb, w2, b2, y,
                           M, q, dscale, seed,
                           static_cast<cudaStream_t>(stream));
}

// Backward of espnet_conv_tail_fwd for dy (M, D, g's dtype): dg (M, D),
// scratch a_buf and dz_buf (M, D, g's dtype), partial (row blocks, 3, D)
// float32 = per-block (dLN scale, dLN bias, db2), dw2p (groups, D, D)
// float32 = the sums of dW2 over groups of rows_per_group rows (float32:
// ceil(M / groups)). x_res's gradient is dy itself.
extern "C" int espnet_conv_tail_bwd(const void* g, const float* lns,
                                    const float* lnb, const void* w2,
                                    const void* dy, void* dg, void* a_buf,
                                    void* dz_buf, float* partial, float* dw2p,
                                    int M, int D, int groups,
                                    int rows_per_group, int q, float dscale,
                                    int seed, int dtype, void* stream) {
  using namespace espnet_port;
  if (M < 1 || groups < 1 || rows_per_group < 1 || q < 0 || q > 255)
    return kUnsupported;
  ESPNET_CONV_GLU_DISPATCH(tail_bwd, tail_bwd_tc, g, lns, lnb, w2, dy, dg,
                           a_buf, dz_buf, partial, dw2p, M, groups,
                           rows_per_group, q, dscale, seed,
                           static_cast<cudaStream_t>(stream));
}

// Rows a backward row kernel's block owns (the rows of one block's
// partials) at model width D in dtype: 32 in float32, TcGlu<D>::BMR in
// bf16; -1 for what the kernels do not take.
extern "C" int espnet_conv_glu_rows_per_block(int D, int dtype) {
  using namespace espnet_port;
  if (dtype == kFloat32) return BM;
  if (dtype != kBFloat16) return kUnsupported;
  switch (D) {
    case 128: return TcGlu<128>::BMR;
    case 256: return TcGlu<256>::BMR;
    case 384: return TcGlu<384>::BMR;
    case 512: return TcGlu<512>::BMR;
    default: return kUnsupported;
  }
}
