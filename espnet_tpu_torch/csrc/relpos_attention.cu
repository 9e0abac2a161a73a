// Rel-pos (Transformer-XL) flash attention, forward and backward.
//
// Replaces the Pallas kernels behind `relpos_flash_attention`
// (espnet_tpu/ops/pallas_relpos_attention.py): the forward `_fwd_kernel` /
// `_fwd_kernel_fold`, and the backward of its general path, `_dqdp_kernel`
// (dq and the dp slabs) and `_dkv_kernel` (dk, dv), which also stand in for
// the single-block `_fused1_bwd_kernel_fold`.
//
//   out[b,h,i] = softmax_j( ((q+u)·k_j + (q+v)·p[T-1-(i-j)]) / sqrt(D)
//                           + max(kbias[b,j], NEG) ) · v
//
// What bounds it on an H100: the forward needs 6·B·H·T²·D flops (ac, bd
// and P·V) and the backward 16·B·H·T²·D (ac, bd and dO·V recomputed, then
// dq's two parts, dk, dv and dp) against 4·B·H·T·D elements moved (7 in the
// backward), so at T≈470, D=64 both are bound by arithmetic, not by device
// memory.
//
// Rounding points are the Pallas kernels': in bf16, q+u and q+v are rounded
// to bf16 (u and v first, as `u.astype(q.dtype)` does), in the forward the
// unnormalised probabilities before P·V (their row sum l is taken before
// the rounding), and in the backward the probabilities P and dS before
// their products; products sum in float32.
//
// The float32 forward and backward run on the CUDA cores in float32
// (float32 is the port's parity mode; tensor-core float32 would be TF32).
// The float32 backward recomputes ac, bd and dO·V in both passes
// (22·B·H·T²·D). The bf16 forward and backward run on tensor cores (below).
//
// What the CUDA-core design does about it:
// * The (B, H, T, 2T-1) position-score tensor is never built. A block owns
//   one (b, h) and BQ query rows; for each BK-wide key tile it stages the
//   BQ+BK-1 contiguous rows of p that the tile can touch (row T-1-(i-j)) in
//   shared memory and reads bd[r][c] from window row BQ-1-r+c — the
//   block-local skew of the Pallas kernel as an index, with no roll.
// * An online softmax in float32 keeps the score tile in registers; the
//   normalised tile goes through shared memory once for the P·V product.
// * Each thread holds a 4x4 sub-tile of rows ty+16i and columns tx+16j; the
//   bd term of that sub-tile needs only 7 distinct window rows, and rows of
//   stride D+1 keep the column reads free of bank conflicts.
// * Masking uses the reference's finite value: the key bias is clamped at
//   NEG = finfo(f32).min/2 and the running max starts at NEG, so a query
//   whose keys are all masked averages v uniformly (as the plain softmax
//   over finite scores does) and never yields NaN. Keys past T are skipped.
// * The TPU's sequential grid carried the dp slab of a (head, q block)
//   across the batch; here blocks run in parallel, so the backward splits
//   as the Pallas general path does: pass 1 per (q block, b·h) computes
//   dqu, dqv and its q block's dp contributions, pass 2 per (k block, b·h)
//   dk and dv. Pass 1 adds each key tile's dp window (BQ+BK-1 rows) into
//   registers; the window's first BK rows are complete after the tile and
//   go to the block's own slab, the other BQ-1 carry into the next tile, so
//   every slab row is written once. A fold kernel sums the slabs over the
//   batch and overlap-adds them into dp (deterministic, no atomics).
//
// The bf16 forward and backward run on tensor cores (`mma.sync` m16n8k16
// with `ldmatrix` fragments and a `cp.async` ring, tensor_core.cuh;
// mma.sync rather than wgmma because the skewed bd read, the softmax and
// the dS window sit between the products at fragment granularity):
// * Forward, block per (q block, b·h), 4 warps of 16 query rows. It rounds
//   Qu = q+u and Qv = q+v into shared memory once (their A fragments stay
//   in registers up to D = 64) and, per 64-key tile (K, V, the tile's key
//   bias and the 128-row p window through a two-stage ring), runs ac =
//   Qu·Kᵀ and the warp's 80-row bd band of Qv·Pwᵀ on mma; the band goes
//   through a float32 tile so that row r reads window row 63-r+c, as in
//   backward pass 1. The online softmax runs in float32 on the C fragments
//   (row max by quad shuffles); l sums the unrounded exp, and P is rounded
//   to bf16 once, its C fragments reused as the A fragments of P·V (V by
//   ldmatrix.trans), as the Pallas kernel rounds pmat before that product.
//   The epilogue writes out = acc / max(l, 1e-30) in bf16 and (m, l) per
//   row for the backward. Products: 6.5·B·H·Tp²·D (the band is 80/64 of
//   the square). Shared memory 115,200 bytes at D = 64: two blocks an SM.
// * Pass 1, block per (q block, head, group of batch elements), 4 warps of
//   16 query rows. It rounds Qu = q+u and Qv = q+v into shared memory and,
//   per 64-key tile (K, V and the 128-row p window through a two-stage
//   ring; one stage at D = 128, for shared memory), runs ac = Qu·Kᵀ, the
//   warp's 80-row band of Qv·Pwᵀ (only the window rows its 16 queries
//   reach), dPv = dO·Vᵀ on mma; the band goes through a float32 tile so
//   that row r reads window row 63-r+c. P = exp(s - m)/l and dS = P∘(dPv -
//   δ)·scale stay in registers, are rounded once and written as bf16 (B,
//   H, Tp, Tp) planes (Tp = 64·⌈T/64⌉, zeros past T) for pass 2. dqu +=
//   dS·K takes dS's C fragments as A fragments. dS is also written skewed
//   into a 64x128 window tile (zeros elsewhere, written once), so dqv +=
//   dSw·Pw and dPw = dSwᵀ·Qv are plain products; dPw's first 64 rows are
//   complete after the tile and are added to the block's slab, the other
//   64 carry to the next tile in a two-half float32 ring. The block walks
//   its batch elements and sums their dp rows into one slab, so the slabs
//   are (groups, H, ⌈T/64⌉, rows, D) float32 instead of one per element.
// * Pass 2, block per (key tile, b·h): dv += Pᵀ·dO and dk += dSᵀ·Qu over
//   the query tiles, both on mma from the stored planes (no recomputed
//   scores). Products: 14·B·H·Tp²·D in pass 1 (the bd band is 80/64 of the
//   square, dPw skips the window tile's all-zero blocks), 4 in pass 2. The
//   price is the two planes (2·2·B·H·Tp² bytes, 268 MB at the training
//   shape, transient).
#include "common.cuh"
#include "tensor_core.cuh"

namespace espnet_port {
namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16: tx = column lane, ty = row lane
constexpr int PW = BQ + BK - 1;
constexpr float NEG = -FLT_MAX / 2;

template <int D>
constexpr size_t relpos_smem_bytes() {
  // qu, qv (BQ rows), k, v (BK rows), the p window (PW rows, reused for the
  // probability tile), the tile's key bias.
  return sizeof(float) * ((2 * BQ + 2 * BK + PW) * (D + 1) + BK);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    relpos_attention_fwd_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ p,
                                const float* __restrict__ pos_u,
                                const float* __restrict__ pos_v,
                                const float* __restrict__ kbias,
                                float* __restrict__ out,
                                float2* __restrict__ stats, int H, int Tn,
                                float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  static_assert(BQ * (BK + 1) <= PW * (D + 1), "probability tile must fit");
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;

  extern __shared__ float smem[];
  float* qu_s = smem;
  float* qv_s = qu_s + BQ * LD;
  float* k_s = qv_s + BQ * LD;
  float* v_s = k_s + BK * LD;
  float* pw_s = v_s + BK * LD;  // later: probability tile, row stride BK+1
  float* kb_s = pw_s + PW * LD;

  const int bh = blockIdx.y;
  const int h = bh % H;
  const int b = bh / H;
  const int i0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const size_t seq = static_cast<size_t>(bh) * Tn * D;
  const float* qg = q + seq;
  const float* kg = k + seq;
  const float* vg = v + seq;
  const float* pg = p + static_cast<size_t>(h) * (2 * Tn - 1) * D;
  const float* kbg = kbias + static_cast<size_t>(b) * Tn;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int i = i0 + r;
    const float x = i < Tn ? qg[static_cast<size_t>(i) * D + d] : 0.f;
    qu_s[r * LD + d] = x + pos_u[h * D + d];
    qv_s[r * LD + d] = x + pos_v[h * D + d];
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = NEG;
    l[ii] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[ii][jj] = 0.f;
  }

  const int n_tiles = (Tn + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int j0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D;
      const int j = j0 + c;
      const bool ok = j < Tn;
      const size_t g = static_cast<size_t>(j) * D + d;
      k_s[c * LD + d] = ok ? kg[g] : 0.f;
      v_s[c * LD + d] = ok ? vg[g] : 0.f;
    }
    // window row w holds p row (T-1) - (i0+BQ-1) + j0 + w
    const int prow0 = Tn - 1 - (i0 + BQ - 1) + j0;
    for (int e = tid; e < PW * D; e += THREADS) {
      const int w = e / D, d = e % D;
      const int pr = prow0 + w;
      pw_s[w * LD + d] = (pr >= 0 && pr < 2 * Tn - 1)
                             ? pg[static_cast<size_t>(pr) * D + d]
                             : 0.f;
    }
    for (int c = tid; c < BK; c += THREADS) {
      const int j = j0 + c;
      kb_s[c] = j < Tn ? fmaxf(kbg[j], NEG) : 0.f;
    }
    __syncthreads();

    // s[ii][jj]: query row ty+16ii, key column tx+16jj of the tile.
    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
    // bd[r][c] lives in window row BQ-1-r+c = wbase + 16*(jj-ii)
    const int wbase = BQ - 1 - ty + tx;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a_u[4], a_v[4], a_k[4], a_p[7];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        a_u[ii] = qu_s[(ty + 16 * ii) * LD + d];
        a_v[ii] = qv_s[(ty + 16 * ii) * LD + d];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) a_k[jj] = k_s[(tx + 16 * jj) * LD + d];
#pragma unroll
      for (int mm = 0; mm < 7; ++mm)
        a_p[mm] = pw_s[(wbase + 16 * (mm - 3)) * LD + d];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          s[ii][jj] += a_u[ii] * a_k[jj] + a_v[ii] * a_p[jj - ii + 3];
    }
    __syncthreads();  // all reads of the p window are done: reuse it

    float* prob_s = pw_s;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      float mc = NEG;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        s[ii][jj] = s[ii][jj] * scale + kb_s[c];
        if (j0 + c < Tn) mc = fmaxf(mc, s[ii][jj]);
      }
      mc = half_warp_max(mc);
      const float m_new = fmaxf(m[ii], mc);
      const float alpha = expf(m[ii] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const float e = j0 + c < Tn ? expf(s[ii][jj] - m_new) : 0.f;
        prob_s[(ty + 16 * ii) * (BK + 1) + c] = e;
        rs += e;
      }
      rs = half_warp_sum(rs);
      l[ii] = l[ii] * alpha + rs;
      m[ii] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[ii][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a_p[4], a_v[DJ];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        a_p[ii] = prob_s[(ty + 16 * ii) * (BK + 1) + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) a_v[jj] = v_s[c * LD + tx + 16 * jj];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[ii][jj] += a_p[ii] * a_v[jj];
    }
  }

  float* og = out + seq;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = i0 + ty + 16 * ii;
    if (i >= Tn) continue;
    const float inv = 1.f / fmaxf(l[ii], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      og[static_cast<size_t>(i) * D + tx + 16 * jj] =
          acc[ii][jj] * inv;
    if (stats != nullptr && tx == 0)
      stats[static_cast<size_t>(bh) * Tn + i] = make_float2(m[ii], l[ii]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* p,
           const float* pos_u, const float* pos_v, const float* kbias,
           void* out, float2* stats, int B, int H, int Tn, float scale,
           cudaStream_t stream) {
  auto kernel = relpos_attention_fwd_kernel<D>;
  const size_t smem = relpos_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tn + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(p), pos_u, pos_v,
      kbias, static_cast<float*>(out), stats, H, Tn, scale);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// Backward. Given dO, the forward's row statistics (running max m and sum l
// of exp(score - m)) and delta = rowsum(dO * O):
//   w = exp(score - m) / l,  ds = w * (dO·v - delta) / sqrt(D)
//   dqu = ds k,  dqv = ds p[T-1-(i-j)],  dk = ds^T qu,  dv = w^T dO,
//   dp[T-1-(i-j)] += ds_ij qv_i  (summed over the batch)
// Pass 1 (block per (q block, b·h)) gives dqu, dqv and the dp slab of its
// q block; pass 2 (block per (k block, b·h)) gives dk and dv. The weights
// use (m, l) rather than m + log l, so a query whose keys are all masked
// (m = NEG) keeps its uniform weights 1/l and gets the gradient of the
// uniform average, as the plain softmax does.
// ---------------------------------------------------------------------------

// The backward keeps q once in shared memory and adds the head's position
// biases u and v (read through the cache) where it uses q+u and q+v: two
// copies of the query rows would not fit beside the rest at D = 128 (the
// dkv kernel needs 231,932 of the 232,448 bytes a block may have there).
template <int D>
constexpr size_t dq_smem_bytes() {
  // q, dO (BQ rows), k, v (BK rows), the p window, ds, key bias, the rows'
  // m, l and delta
  return sizeof(float) * ((2 * BQ + 2 * BK + PW) * (D + 1) +
                          BQ * (BK + 1) + BK + 3 * BQ);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // q, dO (BQ rows), k, v (BK rows), the p window, w, ds, key bias, the
  // rows' m, l and delta
  return sizeof(float) * ((2 * BQ + 2 * BK + PW) * (D + 1) +
                          2 * BQ * (BK + 1) + BK + 3 * BQ);
}

// Loads the BQ query rows at i0 as q, dO and their m, l, delta.
template <typename T, int D>
__device__ __forceinline__ void load_query_rows(
    const T* qg, const T* dog, const float2* stg, const float* dlg, int i0,
    int Tn, float* q_s, float* do_s, float* m_s, float* l_s, float* dl_s) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int i = i0 + r;
    const bool ok = i < Tn;
    const size_t g = static_cast<size_t>(i) * D + d;
    q_s[r * LD + d] = ok ? to_f32(qg[g]) : 0.f;
    do_s[r * LD + d] = ok ? to_f32(dog[g]) : 0.f;
  }
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const int i = i0 + r;
    const float2 st = i < Tn ? stg[i] : make_float2(0.f, 1.f);
    m_s[r] = st.x;
    l_s[r] = st.y;
    dl_s[r] = i < Tn ? dlg[i] : 0.f;
  }
}

// Loads the BK key rows at j0 (k, v, clamped key bias) and the p window of
// the (i0, j0) tile.
template <typename T, int D>
__device__ __forceinline__ void load_key_rows(const T* kg, const T* vg,
                                              const float* kbg, int j0,
                                              int Tn, float* k_s, float* v_s,
                                              float* kb_s) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < BK * D; e += THREADS) {
    const int c = e / D, d = e % D;
    const int j = j0 + c;
    const bool ok = j < Tn;
    const size_t g = static_cast<size_t>(j) * D + d;
    k_s[c * LD + d] = ok ? to_f32(kg[g]) : 0.f;
    v_s[c * LD + d] = ok ? to_f32(vg[g]) : 0.f;
  }
  for (int c = threadIdx.x; c < BK; c += THREADS) {
    const int j = j0 + c;
    kb_s[c] = j < Tn ? fmaxf(kbg[j], NEG) : 0.f;
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_p_window(const T* pg, int i0, int j0,
                                              int Tn, float* pw_s) {
  constexpr int LD = D + 1;
  const int prow0 = Tn - 1 - (i0 + BQ - 1) + j0;
  for (int e = threadIdx.x; e < PW * D; e += THREADS) {
    const int w = e / D, d = e % D;
    const int pr = prow0 + w;
    pw_s[w * LD + d] = (pr >= 0 && pr < 2 * Tn - 1)
                           ? to_f32(pg[static_cast<size_t>(pr) * D + d])
                           : 0.f;
  }
}

// ds (and w) of the (i0, j0) tile into shared memory: thread (ty, tx) does
// rows ty+16ii and columns tx+16jj. pu, pv: the head's position biases.
template <int D>
__device__ __forceinline__ void tile_ds(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* pw_s, const float* kb_s, const float* m_s, const float* l_s,
    const float* dl_s, const float* __restrict__ pu,
    const float* __restrict__ pv, int i0, int j0, int Tn, float scale,
    float* w_s, float* ds_s) {
  constexpr int LD = D + 1;
  constexpr int LS = BK + 1;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float s[4][4], dw[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) s[ii][jj] = dw[ii][jj] = 0.f;
  const int wbase = BQ - 1 - ty + tx;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float a_u[4], a_v[4], a_o[4], a_k[4], a_w[4], a_p[7];
    const float ud = pu[d], vd = pv[d];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const float x = q_s[(ty + 16 * ii) * LD + d];
      a_u[ii] = x + ud;
      a_v[ii] = x + vd;
      a_o[ii] = do_s[(ty + 16 * ii) * LD + d];
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      a_k[jj] = k_s[(tx + 16 * jj) * LD + d];
      a_w[jj] = v_s[(tx + 16 * jj) * LD + d];
    }
#pragma unroll
    for (int mm = 0; mm < 7; ++mm)
      a_p[mm] = pw_s[(wbase + 16 * (mm - 3)) * LD + d];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[ii][jj] += a_u[ii] * a_k[jj] + a_v[ii] * a_p[jj - ii + 3];
        dw[ii][jj] += a_o[ii] * a_w[jj];
      }
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = ty + 16 * ii;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = tx + 16 * jj;
      float w = 0.f;
      if (i0 + r < Tn && j0 + c < Tn)
        w = expf(s[ii][jj] * scale + kb_s[c] - m_s[r]) / l_s[r];
      if (w_s != nullptr) w_s[r * LS + c] = w;
      ds_s[r * LS + c] = w * (dw[ii][jj] - dl_s[r]) * scale;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    relpos_attention_bwd_dq_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ p,
        const float* __restrict__ pos_u, const float* __restrict__ pos_v,
        const float* __restrict__ kbias, const T* __restrict__ dout,
        const float2* __restrict__ stats, const float* __restrict__ delta,
        float* __restrict__ dqu, float* __restrict__ dqv,
        float* __restrict__ slabs, int H, int Tn, float scale) {
  static_assert(BQ == 64 && BK == 64, "the dp carry assumes 64 x 64 tiles");
  constexpr int LD = D + 1;
  constexpr int LS = BK + 1;
  constexpr int DJ = D / 16;
  constexpr int DG = THREADS / D;  // row groups of the dp window
  constexpr int NR = BQ / DG;      // window rows per thread and half

  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * LD;
  float* k_s = do_s + BQ * LD;
  float* v_s = k_s + BK * LD;
  float* pw_s = v_s + BK * LD;
  float* ds_s = pw_s + PW * LD;
  float* kb_s = ds_s + BQ * LS;
  float* m_s = kb_s + BK;
  float* l_s = m_s + BQ;
  float* dl_s = l_s + BQ;

  const int bh = blockIdx.y;
  const int h = bh % H;
  const int b = bh / H;
  const int i0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_tiles = (Tn + BK - 1) / BK;
  const size_t seq = static_cast<size_t>(bh) * Tn * D;
  const T* pg = p + static_cast<size_t>(h) * (2 * Tn - 1) * D;
  const float* pu = pos_u + h * D;
  const float* pv = pos_v + h * D;
  // this block's dp slab: n_tiles*BK + BQ-1 rows, row 0 = p row
  // T-1-(i0+BQ-1)
  const int slab_rows = n_tiles * BK + BQ - 1;
  float* slab = slabs + (static_cast<size_t>(bh) * gridDim.x + blockIdx.x) *
                            slab_rows * D;

  load_query_rows<T, D>(q + seq, dout + seq,
                        stats + static_cast<size_t>(bh) * Tn,
                        delta + static_cast<size_t>(bh) * Tn, i0, Tn, q_s,
                        do_s, m_s, l_s, dl_s);

  float aqu[4][DJ], aqv[4][DJ];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) aqu[ii][jj] = aqv[ii][jj] = 0.f;
  const int dcol = tid % D;
  const int grp = tid / D;
  const float pv_d = pv[dcol];
  float low[NR], high[NR];
#pragma unroll
  for (int kr = 0; kr < NR; ++kr) low[kr] = high[kr] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int j0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_key_rows<T, D>(k + seq, v + seq, kbias + static_cast<size_t>(b) * Tn,
                        j0, Tn, k_s, v_s, kb_s);
    load_p_window<T, D>(pg, i0, j0, Tn, pw_s);
    __syncthreads();
    tile_ds<D>(q_s, do_s, k_s, v_s, pw_s, kb_s, m_s, l_s, dl_s, pu, pv, i0,
               j0, Tn, scale, nullptr, ds_s);
    __syncthreads();
    // dqu += ds k, dqv += ds p_window (row BQ-1-r+c)
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float a_s[4], a_k[DJ];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) a_s[ii] = ds_s[(ty + 16 * ii) * LS + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) a_k[jj] = k_s[c * LD + tx + 16 * jj];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float* prow = pw_s + (BQ - 1 - (ty + 16 * ii) + c) * LD;
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          aqu[ii][jj] += a_s[ii] * a_k[jj];
          aqv[ii][jj] += a_s[ii] * prow[tx + 16 * jj];
        }
      }
    }
    // dp window: low rows rho (0..BQ-1) and high rows BQ+rho of this tile,
    // window row w = BQ-1-r+c
    for (int r = 0; r < BQ; ++r) {
      const float qvv = q_s[r * LD + dcol] + pv_d;
      const float* dsr = ds_s + r * LS;
#pragma unroll
      for (int kr = 0; kr < NR; ++kr) {
        const int rho = grp + DG * kr;
        const int cl = rho - (BQ - 1) + r;
        const int ch = rho + 1 + r;
        if (cl >= 0) low[kr] += dsr[cl] * qvv;
        if (ch < BK) high[kr] += dsr[ch] * qvv;
      }
    }
    // the low rows are complete: no later tile reaches them
#pragma unroll
    for (int kr = 0; kr < NR; ++kr) {
      const int rho = grp + DG * kr;
      slab[static_cast<size_t>(kt * BK + rho) * D + dcol] = low[kr];
      low[kr] = high[kr];
      high[kr] = 0.f;
    }
  }
#pragma unroll
  for (int kr = 0; kr < NR; ++kr) {
    const int rho = grp + DG * kr;
    if (rho < BQ - 1)
      slab[static_cast<size_t>(n_tiles * BK + rho) * D + dcol] = low[kr];
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = i0 + ty + 16 * ii;
    if (i >= Tn) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const size_t g = seq + static_cast<size_t>(i) * D + tx + 16 * jj;
      dqu[g] = aqu[ii][jj];
      dqv[g] = aqv[ii][jj];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    relpos_attention_bwd_dkv_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ p,
        const float* __restrict__ pos_u, const float* __restrict__ pos_v,
        const float* __restrict__ kbias, const T* __restrict__ dout,
        const float2* __restrict__ stats, const float* __restrict__ delta,
        float* __restrict__ dk, float* __restrict__ dv, int H, int Tn,
        float scale) {
  constexpr int LD = D + 1;
  constexpr int LS = BK + 1;
  constexpr int DJ = D / 16;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * LD;
  float* k_s = do_s + BQ * LD;
  float* v_s = k_s + BK * LD;
  float* pw_s = v_s + BK * LD;
  float* w_s = pw_s + PW * LD;
  float* ds_s = w_s + BQ * LS;
  float* kb_s = ds_s + BQ * LS;
  float* m_s = kb_s + BK;
  float* l_s = m_s + BQ;
  float* dl_s = l_s + BQ;

  const int bh = blockIdx.y;
  const int h = bh % H;
  const int b = bh / H;
  const int j0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t seq = static_cast<size_t>(bh) * Tn * D;
  const T* pg = p + static_cast<size_t>(h) * (2 * Tn - 1) * D;
  const float* pu = pos_u + h * D;
  const float* pv = pos_v + h * D;

  load_key_rows<T, D>(k + seq, v + seq, kbias + static_cast<size_t>(b) * Tn,
                      j0, Tn, k_s, v_s, kb_s);
  float u_c[DJ];  // u at this thread's columns tx+16jj
#pragma unroll
  for (int jj = 0; jj < DJ; ++jj) u_c[jj] = pu[tx + 16 * jj];
  float ak[4][DJ], av[4][DJ];  // key rows ty+16ii, columns tx+16jj
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) ak[ii][jj] = av[ii][jj] = 0.f;

  const int n_tiles = (Tn + BQ - 1) / BQ;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int i0 = qt * BQ;
    __syncthreads();  // the previous tile's readers are done
    load_query_rows<T, D>(q + seq, dout + seq,
                          stats + static_cast<size_t>(bh) * Tn,
                          delta + static_cast<size_t>(bh) * Tn, i0, Tn, q_s,
                          do_s, m_s, l_s, dl_s);
    load_p_window<T, D>(pg, i0, j0, Tn, pw_s);
    __syncthreads();
    tile_ds<D>(q_s, do_s, k_s, v_s, pw_s, kb_s, m_s, l_s, dl_s, pu, pv, i0,
               j0, Tn, scale, w_s, ds_s);
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float a_w[4], a_s[4], a_o[DJ], a_q[DJ];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        a_w[ii] = w_s[r * LS + ty + 16 * ii];
        a_s[ii] = ds_s[r * LS + ty + 16 * ii];
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        a_o[jj] = do_s[r * LD + tx + 16 * jj];
        a_q[jj] = q_s[r * LD + tx + 16 * jj] + u_c[jj];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          av[ii][jj] += a_w[ii] * a_o[jj];
          ak[ii][jj] += a_s[ii] * a_q[jj];
        }
    }
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int j = j0 + ty + 16 * ii;
    if (j >= Tn) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const size_t g = seq + static_cast<size_t>(j) * D + tx + 16 * jj;
      dk[g] = ak[ii][jj];
      dv[g] = av[ii][jj];
    }
  }
}

// ---------------------------------------------------------------------------
// The dp fold, both dtypes: dp[h, pr] = sum over the slab groups and query
// blocks n of slab[g, h, n, pr - (T-1-(64n+63))] (rows inside the slab), in
// a fixed order.
// ---------------------------------------------------------------------------

constexpr int FOLD_THREADS = 256;

__global__ void __launch_bounds__(FOLD_THREADS)
    relpos_dp_fold_kernel(const float* __restrict__ slabs,
                          float* __restrict__ dp, int groups, int H, int Tn,
                          int D) {
  const int nq = (Tn + BQ - 1) / BQ;
  const int rows = nq * BK + BQ - 1;
  const int h = blockIdx.y;
  const int e = blockIdx.x * FOLD_THREADS + threadIdx.x;
  const int pr = e / D, d = e % D;
  if (pr >= 2 * Tn - 1) return;
  float acc = 0.f;
  for (int gi = 0; gi < groups; ++gi)
    for (int n = 0; n < nq; ++n) {
      const int row = pr - (Tn - 1 - (n * BQ + BQ - 1));
      if (row >= 0 && row < rows)
        acc += slabs[((static_cast<size_t>(gi) * H + h) * nq + n) * rows * D +
                     static_cast<size_t>(row) * D + d];
    }
  dp[(static_cast<size_t>(h) * (2 * Tn - 1) + pr) * D + d] = acc;
}

int launch_fold(const float* slabs, float* dp, int groups, int H, int Tn,
                int D, cudaStream_t stream) {
  const int n = (2 * Tn - 1) * D;
  relpos_dp_fold_kernel<<<dim3((n + FOLD_THREADS - 1) / FOLD_THREADS, H),
                          FOLD_THREADS, 0, stream>>>(slabs, dp, groups, H, Tn,
                                                     D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* p,
               const float* pos_u, const float* pos_v, const float* kbias,
               const void* dout, const float2* stats, const float* delta,
               float* dqu, float* dqv, float* slabs, float* dk, float* dv,
               float* dp, int B, int H, int Tn, float scale,
               cudaStream_t stream) {
  auto k1 = relpos_attention_bwd_dq_kernel<T, D>;
  const size_t smem1 = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  k1<<<dim3((Tn + BQ - 1) / BQ, B * H), THREADS, smem1, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(p), pos_u, pos_v, kbias,
      static_cast<const T*>(dout), stats, delta, dqu, dqv, slabs, H, Tn,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto k2 = relpos_attention_bwd_dkv_kernel<T, D>;
  const size_t smem2 = dkv_smem_bytes<D>();
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  k2<<<dim3((Tn + BK - 1) / BK, B * H), THREADS, smem2, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(p), pos_u, pos_v, kbias,
      static_cast<const T*>(dout), stats, delta, dk, dv, H, Tn, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_fold(slabs, dp, B, H, Tn, D, stream);  // one slab per element
}

// ---------------------------------------------------------------------------
// bf16 backward on tensor cores (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps x 16 rows
constexpr int PWR = 2 * BK;      // window rows of a tile (row 127 stays 0)
constexpr int BAND = 80;         // window rows one warp's 16 queries reach
constexpr int LDB = BAND + 8;    // float stride of a warp's bd band
constexpr int LDW = PWR + 8;     // bf16 stride of the dS window tile
constexpr int LDT = BK + 8;      // bf16 stride of the P and dS tiles (pass 2)
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct TcDq {
  static constexpr int LD = D + 8;   // bf16 stride: Qu, Qv, dO, k, v, p rows
  static constexpr int LDA = D + 4;  // float stride of the dp accumulator
  static constexpr int STAGES = D <= 64 ? 2 : 1;
  static constexpr int RING = (2 * BK + PWR) * LD;  // one stage: k, v, p
  static constexpr size_t bytes =
      sizeof(bf16) * (3 * BQ * LD + STAGES * RING + BQ * LDW) +
      sizeof(float) * (STAGES * BK + 4 * 16 * LDB + 2 * BQ * LDA + 3 * BQ);
  static_assert(bytes <= 232448, "a block may have 227 KB");
};

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
    relpos_bwd_dq_tc_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ p,
        const float* __restrict__ pos_u, const float* __restrict__ pos_v,
        const float* __restrict__ kbias, const bf16* __restrict__ dout,
        const float2* __restrict__ stats, const float* __restrict__ delta,
        float* __restrict__ dqu, float* __restrict__ dqv,
        float* __restrict__ slabs, bf16* __restrict__ pbuf,
        bf16* __restrict__ dsbuf, int B, int H, int Tn, int per_group,
        float scale) {
  static_assert(BQ == 64 && BK == 64, "the window tile assumes 64 x 64 tiles");
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  using L = TcDq<D>;
  constexpr int LD = L::LD, LDA = L::LDA, STAGES = L::STAGES;
  constexpr int CPR = D / 8;    // 16-byte chunks per row
  constexpr int KD = D / 16;    // k-steps over D
  constexpr int ND = D / 8;     // n-tiles over D
  constexpr int NS = BK / 8;    // n-tiles of a score tile
  constexpr int NB = BAND / 8;  // n-tiles of a warp's bd band

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qu_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* qv_s = qu_s + BQ * LD;
  bf16* do_s = qv_s + BQ * LD;
  bf16* ring = do_s + BQ * LD;  // [stage]: k [BK][LD], v [BK][LD], p [PWR][LD]
  bf16* dsw_s = ring + STAGES * L::RING;                     // [BQ][LDW]
  float* kb_s = reinterpret_cast<float*>(dsw_s + BQ * LDW);  // [stage][BK]
  float* bd_s = kb_s + STAGES * BK;                          // [4][16][LDB]
  float* acc_s = bd_s + 4 * 16 * LDB;                        // [2][BQ][LDA]
  float* m_s = acc_s + 2 * BQ * LDA;
  float* il_s = m_s + BQ;  // 1 / l
  float* dl_s = il_s + BQ;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_tiles = gridDim.x;  // key tiles = query blocks
  const int Tp = n_tiles * BK;
  const int h = blockIdx.y % H;
  const int grp = blockIdx.y / H;
  const int b0 = grp * per_group;
  const int steps = (min(B, b0 + per_group) - b0) * n_tiles;
  const int i0 = blockIdx.x * BQ;
  const int slab_rows = n_tiles * BK + BQ - 1;
  float* slab = slabs + (static_cast<size_t>(grp * H + h) * n_tiles +
                         blockIdx.x) * slab_rows * D;
  const bf16* pg = p + static_cast<size_t>(h) * (2 * Tn - 1) * D;
  const int wb0 = 48 - 16 * warp;  // the warp's first window row (its band)
  const int ra = warp * 16 + g;    // fragment rows ra and ra + 8

  // the window tile's cells outside the skew pattern stay 0; the ring of
  // dp accumulator halves starts at 0
  for (int e = tid; e < BQ * LDW / 8; e += TC_THREADS)
    reinterpret_cast<uint4*>(dsw_s)[e] = make_uint4(0u, 0u, 0u, 0u);
  for (int e = tid; e < 2 * BQ * LDA; e += TC_THREADS) acc_s[e] = 0.f;

  auto load_step = [&](int s, int st) {
    const int b = b0 + s / n_tiles;
    const int j0 = (s % n_tiles) * BK;
    const size_t seq = static_cast<size_t>(b * H + h) * Tn * D;
    bf16* ks = ring + st * L::RING;
    bf16* vs = ks + BK * LD;
    bf16* ps = vs + BK * LD;
    for (int e = tid; e < BK * CPR; e += TC_THREADS) {
      const int r = e / CPR, c = e % CPR;
      const int j = j0 + r;
      const bool ok = j < Tn;
      const size_t gi = seq + static_cast<size_t>(ok ? j : 0) * D + c * 8;
      cp_async16(ks + r * LD + c * 8, k + gi, ok ? 16 : 0);
      cp_async16(vs + r * LD + c * 8, v + gi, ok ? 16 : 0);
    }
    // window row w holds p row T-1-(i0+BQ-1)+j0+w, zeros outside [0, 2T-1)
    const int prow0 = Tn - 1 - (i0 + BQ - 1) + j0;
    for (int e = tid; e < PWR * CPR; e += TC_THREADS) {
      const int w = e / CPR, c = e % CPR;
      const int pr = prow0 + w;
      const bool ok = pr >= 0 && pr < 2 * Tn - 1;
      cp_async16(ps + w * LD + c * 8,
                 pg + static_cast<size_t>(ok ? pr : 0) * D + c * 8,
                 ok ? 16 : 0);
    }
    if (tid < BK) {
      const int j = j0 + tid;
      const bool ok = j < Tn;
      cp_async4(kb_s + st * BK + tid,
                kbias + static_cast<size_t>(b) * Tn + (ok ? j : 0),
                ok ? 4 : 0);
    }
  };
  // Qu = bf16(q + bf16(u)), Qv likewise, dO, and the rows' m, 1/l, delta
  // for batch element b; rows past T are zeros (their P is 0)
  auto load_rows = [&](int b) {
    const size_t seq = static_cast<size_t>(b * H + h) * Tn * D;
    for (int e = tid; e < BQ * CPR; e += TC_THREADS) {
      const int r = e / CPR, c = e % CPR;
      const int i = i0 + r;
      uint4 qx = make_uint4(0u, 0u, 0u, 0u), ox = qx;
      if (i < Tn) {
        const size_t gi = seq + static_cast<size_t>(i) * D + c * 8;
        qx = *reinterpret_cast<const uint4*>(q + gi);
        ox = *reinterpret_cast<const uint4*>(dout + gi);
      }
      const bf16* qe = reinterpret_cast<const bf16*>(&qx);
      uint4 ux, vx;
      bf16* ue = reinterpret_cast<bf16*>(&ux);
      bf16* ve = reinterpret_cast<bf16*>(&vx);
#pragma unroll
      for (int e8 = 0; e8 < 8; ++e8) {
        const int d = h * D + c * 8 + e8;
        const float x = __bfloat162float(qe[e8]);
        ue[e8] = __float2bfloat16(x + round_to<bf16>(pos_u[d]));
        ve[e8] = __float2bfloat16(x + round_to<bf16>(pos_v[d]));
      }
      *reinterpret_cast<uint4*>(qu_s + r * LD + c * 8) = ux;
      *reinterpret_cast<uint4*>(qv_s + r * LD + c * 8) = vx;
      *reinterpret_cast<uint4*>(do_s + r * LD + c * 8) = ox;
    }
    for (int r = tid; r < BQ; r += TC_THREADS) {
      const int i = i0 + r;
      const size_t gi = static_cast<size_t>(b * H + h) * Tn + i;
      const float2 st = i < Tn ? stats[gi] : make_float2(0.f, 1.f);
      m_s[r] = st.x;
      il_s[r] = 1.f / st.y;
      dl_s[r] = i < Tn ? delta[gi] : 0.f;
    }
  };
  // float32 dp accumulator half `phys` to slab rows row0 .. row0+nrows-1
  // (the group's first element writes, the others add) and back to 0; the
  // thread of a slab cell does not depend on the tile or the element
  auto flush = [&](int phys, int row0, int nrows, bool first) {
    float* half = acc_s + phys * BQ * LDA;
    for (int e = tid; e < BQ * (D / 4); e += TC_THREADS) {
      const int r = e / (D / 4), c = (e % (D / 4)) * 4;
      float4* src = reinterpret_cast<float4*>(half + r * LDA + c);
      if (r < nrows) {
        float4 x = *src;
        float4* dst =
            reinterpret_cast<float4*>(slab + static_cast<size_t>(row0 + r) * D + c);
        if (!first) {
          const float4 o = *dst;
          x.x += o.x;
          x.y += o.y;
          x.z += o.z;
          x.w += o.w;
        }
        *dst = x;
      }
      *src = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  load_rows(b0);
  load_step(0, 0);
  cp_async_commit();

  float aqu[ND][4], aqv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) aqu[n][e] = aqv[n][e] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int kt = s % n_tiles;
    const int b = b0 + s / n_tiles;
    const int st = STAGES == 2 ? (s & 1) : 0;
    const int j0 = kt * BK;
    cp_async_wait<0>();
    __syncthreads();  // step s landed; step s-1's readers are done
    if (STAGES == 2 && s + 1 < steps) {
      load_step(s + 1, st ^ 1);
      cp_async_commit();
    }
    if (kt == 0 && s > 0) {
      load_rows(b);
      __syncthreads();
    }
    const bf16* ks = ring + st * L::RING;
    const bf16* vs = ks + BK * LD;
    const bf16* ps = vs + BK * LD;
    const float* kb = kb_s + st * BK;
    const int aoff = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;

    // ac = Qu Kᵀ: K's rows are the n index, its columns the k index
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, qu_s + aoff + kk * 16);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned bk[4];
        ldmatrix_x4(bk, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], a, bk[0], bk[1]);
        mma_bf16(sc[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    // bd: the warp's band of Qv Pwᵀ (window rows wb0 .. wb0+79) through
    // its float32 tile; row r (rr = r - 16 warp) reads band column
    // 63-r+c - wb0 = 15-rr+c
    {
      float bd[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) bd[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned a[4];
        ldmatrix_x4(a, qv_s + aoff + kk * 16);
#pragma unroll
        for (int np = 0; np < NB / 2; ++np) {
          unsigned bp[4];
          ldmatrix_x4(bp, ps + (wb0 + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                   LD + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(bd[2 * np], a, bp[0], bp[1]);
          mma_bf16(bd[2 * np + 1], a, bp[2], bp[3]);
        }
      }
      float* bw = bd_s + warp * 16 * LDB;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        *reinterpret_cast<float2*>(bw + g * LDB + n * 8 + 2 * t4) =
            make_float2(bd[n][0], bd[n][1]);
        *reinterpret_cast<float2*>(bw + (g + 8) * LDB + n * 8 + 2 * t4) =
            make_float2(bd[n][2], bd[n][3]);
      }
      __syncwarp();
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = g + 8 * (e >> 1);
          sc[n][e] += bw[rr * LDB + 15 - rr + n * 8 + 2 * t4 + (e & 1)];
        }
    }
    // dPv = dO Vᵀ
    float dpv[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpv[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, do_s + aoff + kk * 16);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned bv[4];
        ldmatrix_x4(bv, vs + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(dpv[2 * np], a, bv[0], bv[1]);
        mma_bf16(dpv[2 * np + 1], a, bv[2], bv[3]);
      }
    }

    // P = exp(s - m) / l and dS = P (dPv - delta) scale, zero for rows and
    // keys past T; both rounded once, packed (rows ra, ra + 8)
    unsigned pp[NS][2], dsp[NS][2];
    {
      const float mr[2] = {m_s[ra], m_s[ra + 8]};
      const float il[2] = {il_s[ra], il_s[ra + 8]};
      const float dl[2] = {dl_s[ra], dl_s[ra + 8]};
      const bool rok[2] = {i0 + ra < Tn, i0 + ra + 8 < Tn};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t4 + (e & 1);
          const int hr = e >> 1;
          float pv = 0.f;
          if (rok[hr] && j0 + c < Tn)
            pv = exp2f((sc[n][e] * scale + fmaxf(kb[c], NEG) - mr[hr]) *
                       LOG2E) * il[hr];
          sc[n][e] = pv;
          dpv[n][e] = pv * (dpv[n][e] - dl[hr]) * scale;
        }
        pp[n][0] = pack_bf16(sc[n][0], sc[n][1]);
        pp[n][1] = pack_bf16(sc[n][2], sc[n][3]);
        dsp[n][0] = pack_bf16(dpv[n][0], dpv[n][1]);
        dsp[n][1] = pack_bf16(dpv[n][2], dpv[n][3]);
      }
    }
    // P and dS to their planes (row i0+ra of (b, h), columns j0 ..)
    {
      const size_t row = (static_cast<size_t>(b * H + h) * Tp + i0 + ra) *
                             Tp + j0 + 2 * t4;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const size_t o = row + n * 8;
        *reinterpret_cast<unsigned*>(pbuf + o) = pp[n][0];
        *reinterpret_cast<unsigned*>(pbuf + o + 8 * static_cast<size_t>(Tp)) =
            pp[n][1];
        *reinterpret_cast<unsigned*>(dsbuf + o) = dsp[n][0];
        *reinterpret_cast<unsigned*>(dsbuf + o + 8 * static_cast<size_t>(Tp)) =
            dsp[n][1];
      }
    }
    // dqu += dS K: dS's C fragments of n-tiles 2kk, 2kk+1 are the A
    // fragment of k-step kk; K's rows are the k index (ldmatrix.trans)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned a[4] = {dsp[2 * kk][0], dsp[2 * kk][1],
                             dsp[2 * kk + 1][0], dsp[2 * kk + 1][1]};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        unsigned bk[4];
        ldmatrix_x4_trans(bk, ks + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(aqu[2 * dp], a, bk[0], bk[1]);
        mma_bf16(aqu[2 * dp + 1], a, bk[2], bk[3]);
      }
    }
    // dS skewed into the window tile: (r, c) at window column 63-r+c
    {
      bf16* w0 = dsw_s + ra * LDW + wb0 + 15 - g;
      bf16* w1 = dsw_s + (ra + 8) * LDW + wb0 + 7 - g;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int c = n * 8 + 2 * t4;
        const __nv_bfloat162 v0 =
            *reinterpret_cast<const __nv_bfloat162*>(&dsp[n][0]);
        const __nv_bfloat162 v1 =
            *reinterpret_cast<const __nv_bfloat162*>(&dsp[n][1]);
        w0[c] = v0.x;
        w0[c + 1] = v0.y;
        w1[c] = v1.x;
        w1[c + 1] = v1.y;
      }
    }
    __syncwarp();
    // dqv += dSw Pw over the warp's band: Pw's rows are the k index
#pragma unroll
    for (int kk = 0; kk < BAND / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, dsw_s + (warp * 16 + (lane & 15)) * LDW + wb0 + kk * 16 +
                         (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        unsigned bp[4];
        ldmatrix_x4_trans(bp, ps + (wb0 + kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(aqv[2 * dp], a, bp[0], bp[1]);
        mma_bf16(aqv[2 * dp + 1], a, bp[2], bp[3]);
      }
    }
    __syncthreads();  // the window tile is complete; the ring is read
    if (STAGES == 1 && s + 1 < steps) {
      load_step(s + 1, 0);
      cp_async_commit();
    }

    // dPw += dSwᵀ Qv: warp w takes window rows 32w .. 32w+31 (A = dSwᵀ:
    // ldmatrix.trans of the tile; Qv's rows are the k index), in chunks of
    // 32 columns of D, skipping the k-steps whose rows of dSw are zero in
    // those window rows (warp 0 needs query rows >= 32, warp 3 < 32)
    {
      const int kk_lo = warp == 0 ? 2 : 0;
      const int kk_hi = warp == 3 ? 2 : 4;
      float* half = acc_s + ((kt + (warp >> 1)) & 1) * BQ * LDA;
#pragma unroll
      for (int ch = 0; ch < D / 32; ++ch) {
        float pa[2][4][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) pa[mt][n][e] = 0.f;
        for (int kk = kk_lo; kk < kk_hi; ++kk) {
          unsigned a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldmatrix_x4_trans(a[mt], dsw_s + (kk * 16 + (lane & 7) +
                                              (lane >> 4) * 8) * LDW +
                                         warp * 32 + mt * 16 +
                                         ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            unsigned bq[4];
            ldmatrix_x4_trans(bq, qv_s + (kk * 16 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8) * LD +
                                      ch * 32 + np * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(pa[mt][2 * np], a[mt], bq[0], bq[1]);
              mma_bf16(pa[mt][2 * np + 1], a[mt], bq[2], bq[3]);
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int wr = (warp & 1) * 32 + mt * 16 + g;  // row of the half
            const int c = ch * 32 + n * 8 + 2 * t4;
            float2* p0 = reinterpret_cast<float2*>(half + wr * LDA + c);
            float2* p1 = reinterpret_cast<float2*>(half + (wr + 8) * LDA + c);
            float2 x0 = *p0, x1 = *p1;
            x0.x += pa[mt][n][0];
            x0.y += pa[mt][n][1];
            x1.x += pa[mt][n][2];
            x1.y += pa[mt][n][3];
            *p0 = x0;
            *p1 = x1;
          }
      }
    }
    __syncthreads();  // window rows 0..63 of the accumulator are complete

    // they reach no later tile: slab rows 64 kt .. 64 kt + 63
    const bool first = b == b0;
    flush(kt & 1, kt * BK, BK, first);
    if (kt == n_tiles - 1) {
      flush((kt + 1) & 1, (kt + 1) * BK, BQ - 1, first);
      const size_t seq = static_cast<size_t>(b * H + h) * Tn * D;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = i0 + ra + 8 * hr;
        if (i >= Tn) continue;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const size_t gi = seq + static_cast<size_t>(i) * D + n * 8 + 2 * t4;
          *reinterpret_cast<float2*>(dqu + gi) =
              make_float2(aqu[n][2 * hr], aqu[n][2 * hr + 1]);
          *reinterpret_cast<float2*>(dqv + gi) =
              make_float2(aqv[n][2 * hr], aqv[n][2 * hr + 1]);
        }
      }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) aqu[n][e] = aqv[n][e] = 0.f;
    }
  }
}

template <int D>
struct TcDkv {
  static constexpr int LD = D + 8;
  static constexpr int STAGE = 2 * BQ * LDT + 2 * BQ * LD;  // P, dS, dO, q
  static constexpr size_t bytes = sizeof(bf16) * 2 * STAGE;
};

// Pass 2: block per (key tile, b·h); warp w owns key rows 16w .. 16w+15.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
    relpos_bwd_dkv_tc_kernel(const bf16* __restrict__ q,
                             const float* __restrict__ pos_u,
                             const bf16* __restrict__ dout,
                             const bf16* __restrict__ pbuf,
                             const bf16* __restrict__ dsbuf,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int H, int Tn) {
  using L = TcDkv<D>;
  constexpr int LD = L::LD;
  constexpr int CPR = D / 8;
  constexpr int ND = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [stage]: P [BQ][LDT], dS [BQ][LDT], dO [BQ][LD], q [BQ][LD]
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_tiles = gridDim.x;
  const int Tp = n_tiles * BK;
  const int bh = blockIdx.y;
  const int h = bh % H;
  const int j0 = blockIdx.x * BK;
  const size_t seq = static_cast<size_t>(bh) * Tn * D;
  const size_t plane = static_cast<size_t>(bh) * Tp * Tp;

  auto load = [&](int qt, int st) {
    bf16* ps = sm + st * L::STAGE;
    bf16* dss = ps + BQ * LDT;
    bf16* dos = dss + BQ * LDT;
    bf16* qs = dos + BQ * LD;
    const int i0 = qt * BQ;
    for (int e = tid; e < BQ * (BK / 8); e += TC_THREADS) {
      const int r = e / (BK / 8), c = e % (BK / 8);
      const size_t gi = plane + static_cast<size_t>(i0 + r) * Tp + j0 + c * 8;
      cp_async16(ps + r * LDT + c * 8, pbuf + gi, 16);
      cp_async16(dss + r * LDT + c * 8, dsbuf + gi, 16);
    }
    for (int e = tid; e < BQ * CPR; e += TC_THREADS) {
      const int r = e / CPR, c = e % CPR;
      const int i = i0 + r;
      const bool ok = i < Tn;
      const size_t gi = seq + static_cast<size_t>(ok ? i : 0) * D + c * 8;
      cp_async16(dos + r * LD + c * 8, dout + gi, ok ? 16 : 0);
      cp_async16(qs + r * LD + c * 8, q + gi, ok ? 16 : 0);
    }
  };
  load(0, 0);
  cp_async_commit();

  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int qt = 0; qt < n_tiles; ++qt) {
    const int st = qt & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile qt landed; tile qt-1's readers are done
    if (qt + 1 < n_tiles) {
      load(qt + 1, st ^ 1);
      cp_async_commit();
    }
    const bf16* ps = sm + st * L::STAGE;
    const bf16* dss = ps + BQ * LDT;
    const bf16* dos = dss + BQ * LDT;
    bf16* qs = const_cast<bf16*>(dos) + BQ * LD;
    // Qu = bf16(q + bf16(u)) in place (rows past T hold bf16(u); their P
    // and dS are 0)
    for (int e = tid; e < BQ * CPR; e += TC_THREADS) {
      const int r = e / CPR, c = e % CPR;
      uint4* pq = reinterpret_cast<uint4*>(qs + r * LD + c * 8);
      uint4 x = *pq;
      bf16* xe = reinterpret_cast<bf16*>(&x);
#pragma unroll
      for (int e8 = 0; e8 < 8; ++e8)
        xe[e8] = __float2bfloat16(__bfloat162float(xe[e8]) +
                                  round_to<bf16>(pos_u[h * D + c * 8 + e8]));
      *pq = x;
    }
    __syncthreads();
    // dv += Pᵀ dO, dk += dSᵀ Qu: A = Pᵀ (ldmatrix.trans of the stored
    // rows i), B's rows are the k index i (ldmatrix.trans)
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const int aoff = (kk * 16 + (lane & 7) + (lane >> 4) * 8) * LDT +
                       warp * 16 + ((lane >> 3) & 1) * 8;
      unsigned ap[4], ad[4];
      ldmatrix_x4_trans(ap, ps + aoff);
      ldmatrix_x4_trans(ad, dss + aoff);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        const int boff = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                         dp * 16 + (lane >> 4) * 8;
        unsigned bo[4], bq[4];
        ldmatrix_x4_trans(bo, dos + boff);
        ldmatrix_x4_trans(bq, qs + boff);
        mma_bf16(adv[2 * dp], ap, bo[0], bo[1]);
        mma_bf16(adv[2 * dp + 1], ap, bo[2], bo[3]);
        mma_bf16(adk[2 * dp], ad, bq[0], bq[1]);
        mma_bf16(adk[2 * dp + 1], ad, bq[2], bq[3]);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = j0 + warp * 16 + g + 8 * hr;
    if (j >= Tn) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const size_t gi = seq + static_cast<size_t>(j) * D + n * 8 + 2 * t4;
      *reinterpret_cast<float2*>(dk + gi) =
          make_float2(adk[n][2 * hr], adk[n][2 * hr + 1]);
      *reinterpret_cast<float2*>(dv + gi) =
          make_float2(adv[n][2 * hr], adv[n][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on tensor cores (see the note at the top)
// ---------------------------------------------------------------------------

template <int D>
struct TcFwd {
  static constexpr int LD = D + 8;  // bf16 stride: Qu, Qv, k, v, p rows
  static constexpr int RING = (2 * BK + PWR) * LD;  // one stage: k, v, p
  static constexpr size_t bytes = sizeof(bf16) * (2 * BQ * LD + 2 * RING) +
                                  sizeof(float) * (2 * BK + 4 * 16 * LDB);
  static_assert(bytes <= 232448, "a block may have 227 KB");
};

// Block per (query block, b·h); warp w owns query rows 16w .. 16w+15.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
    relpos_attention_fwd_tc_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ p,
        const float* __restrict__ pos_u, const float* __restrict__ pos_v,
        const float* __restrict__ kbias, bf16* __restrict__ out,
        float2* __restrict__ stats, int H, int Tn, float scale) {
  static_assert(BQ == 64 && BK == 64, "the bd band assumes 64 x 64 tiles");
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  using L = TcFwd<D>;
  constexpr int LD = L::LD;
  constexpr int CPR = D / 8;    // 16-byte chunks per row
  constexpr int KD = D / 16;    // k-steps over D
  constexpr int ND = D / 8;     // n-tiles of the output
  constexpr int NS = BK / 8;    // n-tiles of a score tile
  constexpr int NB = BAND / 8;  // n-tiles of a warp's bd band
  // Qu and Qv fragments stay in registers across the key loop up to D = 64
  // (2 KD x 4 registers); at D = 128 they are loaded again for each tile
  constexpr bool QREG = D <= 64;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qu_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* qv_s = qu_s + BQ * LD;
  bf16* ring = qv_s + BQ * LD;  // [stage]: k [BK][LD], v [BK][LD], p [PWR][LD]
  float* kb_s = reinterpret_cast<float*>(ring + 2 * L::RING);  // [stage][BK]
  float* bd_s = kb_s + 2 * BK;                                 // [4][16][LDB]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int h = bh % H;
  const int b = bh / H;
  const int i0 = blockIdx.x * BQ;
  const size_t seq = static_cast<size_t>(bh) * Tn * D;
  const bf16* pg = p + static_cast<size_t>(h) * (2 * Tn - 1) * D;
  const float* kbg = kbias + static_cast<size_t>(b) * Tn;
  const int wb0 = 48 - 16 * warp;  // the warp's first window row (its band)

  auto load_tile = [&](int kt, int st) {
    const int j0 = kt * BK;
    bf16* ks = ring + st * L::RING;
    bf16* vs = ks + BK * LD;
    bf16* ps = vs + BK * LD;
    for (int e = tid; e < BK * CPR; e += TC_THREADS) {
      const int r = e / CPR, c = e % CPR;
      const int j = j0 + r;
      const bool ok = j < Tn;
      const size_t gi = seq + static_cast<size_t>(ok ? j : 0) * D + c * 8;
      cp_async16(ks + r * LD + c * 8, k + gi, ok ? 16 : 0);
      cp_async16(vs + r * LD + c * 8, v + gi, ok ? 16 : 0);
    }
    // window row w holds p row T-1-(i0+BQ-1)+j0+w, zeros outside [0, 2T-1)
    const int prow0 = Tn - 1 - (i0 + BQ - 1) + j0;
    for (int e = tid; e < PWR * CPR; e += TC_THREADS) {
      const int w = e / CPR, c = e % CPR;
      const int pr = prow0 + w;
      const bool ok = pr >= 0 && pr < 2 * Tn - 1;
      cp_async16(ps + w * LD + c * 8,
                 pg + static_cast<size_t>(ok ? pr : 0) * D + c * 8,
                 ok ? 16 : 0);
    }
    if (tid < BK) {
      const int j = j0 + tid;
      const bool ok = j < Tn;
      cp_async4(kb_s + st * BK + tid, kbg + (ok ? j : 0), ok ? 4 : 0);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  // Qu = bf16(q + bf16(u)) and Qv likewise, as the Pallas kernel's
  // q + u.astype(q.dtype); rows past T are zeros (never stored)
  for (int e = tid; e < BQ * CPR; e += TC_THREADS) {
    const int r = e / CPR, c = e % CPR;
    const int i = i0 + r;
    uint4 qx = make_uint4(0u, 0u, 0u, 0u);
    if (i < Tn)
      qx = *reinterpret_cast<const uint4*>(q + seq +
                                           static_cast<size_t>(i) * D + c * 8);
    const bf16* qe = reinterpret_cast<const bf16*>(&qx);
    uint4 ux, vx;
    bf16* ue = reinterpret_cast<bf16*>(&ux);
    bf16* ve = reinterpret_cast<bf16*>(&vx);
#pragma unroll
    for (int e8 = 0; e8 < 8; ++e8) {
      const int d = h * D + c * 8 + e8;
      const float x = __bfloat162float(qe[e8]);
      ue[e8] = __float2bfloat16(x + round_to<bf16>(pos_u[d]));
      ve[e8] = __float2bfloat16(x + round_to<bf16>(pos_v[d]));
    }
    *reinterpret_cast<uint4*>(qu_s + r * LD + c * 8) = ux;
    *reinterpret_cast<uint4*>(qv_s + r * LD + c * 8) = vx;
  }

  const int aoff = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  float* bw = bd_s + warp * 16 * LDB;
  unsigned quf[QREG ? KD : 1][4], qvf[QREG ? KD : 1][4];
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG, NEG};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};  // this lane's part of the running row sums

  const int n_tiles = (Tn + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    const int j0 = kt * BK;
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed (and Qu, Qv); tile kt-1 is read
    if (kt + 1 < n_tiles) {
      load_tile(kt + 1, st ^ 1);
      cp_async_commit();
    }
    if constexpr (QREG) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          ldmatrix_x4(quf[kk], qu_s + aoff + kk * 16);
          ldmatrix_x4(qvf[kk], qv_s + aoff + kk * 16);
        }
      }
    }
    const bf16* ks = ring + st * L::RING;
    const bf16* vs = ks + BK * LD;
    const bf16* ps = vs + BK * LD;
    const float* kb = kb_s + st * BK;

    // ac = Qu Kᵀ: K's rows are the n index, its columns the k index
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = quf[kk][e];
      } else {
        ldmatrix_x4(a, qu_s + aoff + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned bk[4];
        ldmatrix_x4(bk, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], a, bk[0], bk[1]);
        mma_bf16(sc[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    // bd: the warp's band of Qv Pwᵀ (window rows wb0 .. wb0+79) through
    // its float32 tile; row r (rr = r - 16 warp) reads band column
    // 63-r+c - wb0 = 15-rr+c
    {
      float bd[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) bd[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned a[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qvf[kk][e];
        } else {
          ldmatrix_x4(a, qv_s + aoff + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < NB / 2; ++np) {
          unsigned bp[4];
          ldmatrix_x4(bp, ps + (wb0 + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                   LD + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(bd[2 * np], a, bp[0], bp[1]);
          mma_bf16(bd[2 * np + 1], a, bp[2], bp[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        *reinterpret_cast<float2*>(bw + g * LDB + n * 8 + 2 * t4) =
            make_float2(bd[n][0], bd[n][1]);
        *reinterpret_cast<float2*>(bw + (g + 8) * LDB + n * 8 + 2 * t4) =
            make_float2(bd[n][2], bd[n][3]);
      }
      __syncwarp();
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = g + 8 * (e >> 1);
          sc[n][e] += bw[rr * LDB + 15 - rr + n * 8 + 2 * t4 + (e & 1)];
        }
    }

    // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3) over the
    // keys below T, in float32
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t4 + (e & 1);
        sc[n][e] = sc[n][e] * scale + fmaxf(kb[c], NEG);
        if (j0 + c < Tn) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f((m[r] - m_new) * LOG2E);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // l sums the unrounded exp; P·V takes them rounded to bf16, as the
    // Pallas kernel's pmat.astype(v.dtype)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t4 + (e & 1);
        const float pe =
            j0 + c < Tn ? exp2f((sc[n][e] - m[e >> 1]) * LOG2E) : 0.f;
        sc[n][e] = pe;
        l[e >> 1] += pe;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // O += P V: P's C fragments of n-tiles 2kk, 2kk+1 are the A fragment of
    // k-step kk; V's rows are the k index (ldmatrix.trans)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }

  bf16* og = out + seq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int i = i0 + warp * 16 + g + 8 * r;
    if (i >= Tn) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(og + static_cast<size_t>(i) * D +
                                         n * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (stats != nullptr && t4 == 0)
      stats[static_cast<size_t>(bh) * Tn + i] = make_float2(m[r], l[r]);
  }
}

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, const void* p,
                  const float* pos_u, const float* pos_v, const float* kbias,
                  void* out, float2* stats, int B, int H, int Tn, float scale,
                  cudaStream_t stream) {
  auto kernel = relpos_attention_fwd_tc_kernel<D>;
  const size_t smem = TcFwd<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // all of the SM's 228 KB as shared memory: two blocks an SM at D = 64
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((Tn + BQ - 1) / BQ, B * H), TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(p), pos_u, pos_v,
      kbias, static_cast<bf16*>(out), stats, H, Tn, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* p,
                  const float* pos_u, const float* pos_v, const float* kbias,
                  const void* dout, const float2* stats, const float* delta,
                  float* dqu, float* dqv, float* slabs, float* dk, float* dv,
                  void* pbuf, void* dsbuf, float* dp, int B, int H, int Tn,
                  int per_group, float scale, cudaStream_t stream) {
  const int nq = (Tn + BQ - 1) / BQ;
  const int groups = (B + per_group - 1) / per_group;
  auto k1 = relpos_bwd_dq_tc_kernel<D>;
  const size_t smem1 = TcDq<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  k1<<<dim3(nq, H * groups), TC_THREADS, smem1, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(p), pos_u, pos_v,
      kbias, static_cast<const bf16*>(dout), stats, delta, dqu, dqv, slabs,
      static_cast<bf16*>(pbuf), static_cast<bf16*>(dsbuf), B, H, Tn,
      per_group, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto k2 = relpos_bwd_dkv_tc_kernel<D>;
  const size_t smem2 = TcDkv<D>::bytes;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  k2<<<dim3(nq, B * H), TC_THREADS, smem2, stream>>>(
      static_cast<const bf16*>(q), pos_u, static_cast<const bf16*>(dout),
      static_cast<const bf16*>(pbuf), static_cast<const bf16*>(dsbuf), dk, dv,
      H, Tn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_fold(slabs, dp, groups, H, Tn, D, stream);
}

}  // namespace
}  // namespace espnet_port

// q, k, v, out: (B, H, T, D); p: (H, 2T-1, D), all of one dtype, contiguous.
// pos_u, pos_v: (H, D) float32; kbias: (B, T) float32. stats: (B, H, T)
// float2 (row max, row sum) for the backward, or null. D in {32, 64, 128};
// scale multiplies the scores (1/sqrt of the head dim before any zero
// padding to D). float32 runs on the CUDA cores; bf16 runs on tensor cores
// and needs q, k, v and p 16-byte aligned.
extern "C" int espnet_relpos_attention_fwd(const void* q, const void* k,
                                           const void* v, const void* p,
                                           const float* pos_u,
                                           const float* pos_v,
                                           const float* kbias, void* out,
                                           void* stats, int B, int H, int T,
                                           int D, float scale, int dtype,
                                           void* stream) {
  using namespace espnet_port;
  if (B < 1 || H < 1 || T < 1) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* st = static_cast<float2*>(stats);
#define ESPNET_RELPOS_FWD(DD)                                              \
  return launch<DD>(q, k, v, p, pos_u, pos_v, kbias, out, st, B, H, T, scale, \
                    s)
  if (dtype == kFloat32 && D == 32) ESPNET_RELPOS_FWD(32);
  if (dtype == kFloat32 && D == 64) ESPNET_RELPOS_FWD(64);
  if (dtype == kFloat32 && D == 128) ESPNET_RELPOS_FWD(128);
#undef ESPNET_RELPOS_FWD
#define ESPNET_RELPOS_FWD_TC(DD)                                         \
  return launch_fwd_tc<DD>(q, k, v, p, pos_u, pos_v, kbias, out, st, B, H, \
                           T, scale, s)
  if (dtype == kBFloat16 && D == 32) ESPNET_RELPOS_FWD_TC(32);
  if (dtype == kBFloat16 && D == 64) ESPNET_RELPOS_FWD_TC(64);
  if (dtype == kBFloat16 && D == 128) ESPNET_RELPOS_FWD_TC(128);
#undef ESPNET_RELPOS_FWD_TC
  return kUnsupported;
}

// Rows of one dp slab of espnet_relpos_attention_bwd for sequence length T.
extern "C" int espnet_relpos_attention_slab_rows(int T) {
  using namespace espnet_port;
  return ((T + BK - 1) / BK) * BK + BQ - 1;
}

// Backward of espnet_relpos_attention_fwd (same D and scale). dout: (B, H,
// T, D) in q's dtype; stats from the forward; delta: (B, H, T) float32 =
// rowsum(dout * out). Writes dqu, dqv, dk, dv: (B, H, T, D) float32 and dp:
// (H, 2T-1, D) float32. slabs is float32 scratch of (ceil(B / per_group),
// H, ceil(T/64), slab_rows(T), D): each slab sums the dp contributions of
// one query block over per_group batch elements, and slab row 0 of query
// block n is p row T-1-(64n+63). float32 runs on the CUDA cores and takes
// per_group 1 and null pbuf and dsbuf; bf16 runs on tensor cores, needs
// every bf16 input 16-byte aligned, and takes pbuf and dsbuf, bf16 scratch
// of (B, H, Tp, Tp) with Tp = 64 ceil(T/64) (the probabilities and dS).
extern "C" int espnet_relpos_attention_bwd(
    const void* q, const void* k, const void* v, const void* p,
    const float* pos_u, const float* pos_v, const float* kbias,
    const void* dout, const void* stats, const float* delta, float* dqu,
    float* dqv, float* slabs, float* dk, float* dv, void* pbuf, void* dsbuf,
    float* dp, int B, int H, int T, int D, int per_group, float scale,
    int dtype, void* stream) {
  using namespace espnet_port;
  if (B < 1 || H < 1 || T < 1 || per_group < 1) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* st = static_cast<const float2*>(stats);
  if (dtype == kFloat32 && per_group == 1) {
#define ESPNET_RELPOS_BWD(DD)                                               \
  return launch_bwd<float, DD>(q, k, v, p, pos_u, pos_v, kbias, dout, st,   \
                               delta, dqu, dqv, slabs, dk, dv, dp, B, H, T, \
                               scale, s)
    if (D == 32) ESPNET_RELPOS_BWD(32);
    if (D == 64) ESPNET_RELPOS_BWD(64);
    if (D == 128) ESPNET_RELPOS_BWD(128);
#undef ESPNET_RELPOS_BWD
  }
  if (dtype == kBFloat16 && pbuf != nullptr && dsbuf != nullptr) {
#define ESPNET_RELPOS_BWD_TC(DD)                                           \
  return launch_bwd_tc<DD>(q, k, v, p, pos_u, pos_v, kbias, dout, st,      \
                           delta, dqu, dqv, slabs, dk, dv, pbuf, dsbuf, dp, \
                           B, H, T, per_group, scale, s)
    if (D == 32) ESPNET_RELPOS_BWD_TC(32);
    if (D == 64) ESPNET_RELPOS_BWD_TC(64);
    if (D == 128) ESPNET_RELPOS_BWD_TC(128);
#undef ESPNET_RELPOS_BWD_TC
  }
  return kUnsupported;
}

extern "C" const char* espnet_cuda_error_string(int code) {
  if (code == espnet_port::kUnsupported) return "unsupported argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
