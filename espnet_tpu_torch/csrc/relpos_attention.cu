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
// memory. This first version does the products on the CUDA cores in float32
// (no tensor cores yet), and its backward recomputes ac, bd and dO·V in both
// passes (22·B·H·T²·D), so it runs well below the bf16 tensor-core bound
// that chip_smoke.py reports beside it.
//
// What the design does about it:
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
//   every slab row is written once. The slabs are summed over the batch and
//   overlap-added outside (deterministic, no atomics), as the JAX package
//   does.
#include "common.cuh"

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    relpos_attention_fwd_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ p,
                                const float* __restrict__ pos_u,
                                const float* __restrict__ pos_v,
                                const float* __restrict__ kbias,
                                T* __restrict__ out,
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
  const T* qg = q + seq;
  const T* kg = k + seq;
  const T* vg = v + seq;
  const T* pg = p + static_cast<size_t>(h) * (2 * Tn - 1) * D;
  const float* kbg = kbias + static_cast<size_t>(b) * Tn;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int i = i0 + r;
    const float x = i < Tn ? to_f32(qg[static_cast<size_t>(i) * D + d]) : 0.f;
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
      k_s[c * LD + d] = ok ? to_f32(kg[g]) : 0.f;
      v_s[c * LD + d] = ok ? to_f32(vg[g]) : 0.f;
    }
    // window row w holds p row (T-1) - (i0+BQ-1) + j0 + w
    const int prow0 = Tn - 1 - (i0 + BQ - 1) + j0;
    for (int e = tid; e < PW * D; e += THREADS) {
      const int w = e / D, d = e % D;
      const int pr = prow0 + w;
      pw_s[w * LD + d] = (pr >= 0 && pr < 2 * Tn - 1)
                             ? to_f32(pg[static_cast<size_t>(pr) * D + d])
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

  T* og = out + seq;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = i0 + ty + 16 * ii;
    if (i >= Tn) continue;
    const float inv = 1.f / fmaxf(l[ii], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      og[static_cast<size_t>(i) * D + tx + 16 * jj] =
          from_f32<T>(acc[ii][jj] * inv);
    if (stats != nullptr && tx == 0)
      stats[static_cast<size_t>(bh) * Tn + i] = make_float2(m[ii], l[ii]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* p,
           const float* pos_u, const float* pos_v, const float* kbias,
           void* out, float2* stats, int B, int H, int Tn,
           cudaStream_t stream) {
  auto kernel = relpos_attention_fwd_kernel<T, D>;
  const size_t smem = relpos_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tn + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(p), pos_u, pos_v, kbias,
      static_cast<T*>(out), stats, H, Tn, rsqrtf(static_cast<float>(D)));
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

template <int D>
constexpr size_t dq_smem_bytes() {
  // qu, qv, dO (BQ rows), k, v (BK rows), the p window, ds, key bias,
  // the rows' m, l and delta
  return sizeof(float) * ((3 * BQ + 2 * BK + PW) * (D + 1) +
                          BQ * (BK + 1) + BK + 3 * BQ);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // qu, qv, dO (BQ rows), k, v (BK rows), the p window, w, ds, key bias,
  // the rows' m, l and delta
  return sizeof(float) * ((3 * BQ + 2 * BK + PW) * (D + 1) +
                          2 * BQ * (BK + 1) + BK + 3 * BQ);
}

// Loads the BQ query rows at i0 as qu, qv, dO and their m, l, delta.
template <typename T, int D>
__device__ __forceinline__ void load_query_rows(
    const T* qg, const T* dog, const float* pos_u, const float* pos_v,
    const float2* stg, const float* dlg, int h, int i0, int Tn, float* qu_s,
    float* qv_s, float* do_s, float* m_s, float* l_s, float* dl_s) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int i = i0 + r;
    const bool ok = i < Tn;
    const size_t g = static_cast<size_t>(i) * D + d;
    const float x = ok ? to_f32(qg[g]) : 0.f;
    qu_s[r * LD + d] = x + pos_u[h * D + d];
    qv_s[r * LD + d] = x + pos_v[h * D + d];
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
// rows ty+16ii and columns tx+16jj.
template <int D>
__device__ __forceinline__ void tile_ds(const float* qu_s, const float* qv_s,
                                        const float* do_s, const float* k_s,
                                        const float* v_s, const float* pw_s,
                                        const float* kb_s, const float* m_s,
                                        const float* l_s, const float* dl_s,
                                        int i0, int j0, int Tn, float scale,
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
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      a_u[ii] = qu_s[(ty + 16 * ii) * LD + d];
      a_v[ii] = qv_s[(ty + 16 * ii) * LD + d];
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
  float* qu_s = smem;
  float* qv_s = qu_s + BQ * LD;
  float* do_s = qv_s + BQ * LD;
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
  // this block's dp slab: n_tiles*BK + BQ-1 rows, row 0 = p row
  // T-1-(i0+BQ-1)
  const int slab_rows = n_tiles * BK + BQ - 1;
  float* slab = slabs + (static_cast<size_t>(bh) * gridDim.x + blockIdx.x) *
                            slab_rows * D;

  load_query_rows<T, D>(q + seq, dout + seq, pos_u, pos_v,
                        stats + static_cast<size_t>(bh) * Tn,
                        delta + static_cast<size_t>(bh) * Tn, h, i0, Tn, qu_s,
                        qv_s, do_s, m_s, l_s, dl_s);

  float aqu[4][DJ], aqv[4][DJ];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) aqu[ii][jj] = aqv[ii][jj] = 0.f;
  const int dcol = tid % D;
  const int grp = tid / D;
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
    tile_ds<D>(qu_s, qv_s, do_s, k_s, v_s, pw_s, kb_s, m_s, l_s, dl_s, i0, j0,
               Tn, scale, nullptr, ds_s);
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
      const float qvv = qv_s[r * LD + dcol];
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
  float* qu_s = smem;
  float* qv_s = qu_s + BQ * LD;
  float* do_s = qv_s + BQ * LD;
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

  load_key_rows<T, D>(k + seq, v + seq, kbias + static_cast<size_t>(b) * Tn,
                      j0, Tn, k_s, v_s, kb_s);
  float ak[4][DJ], av[4][DJ];  // key rows ty+16ii, columns tx+16jj
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) ak[ii][jj] = av[ii][jj] = 0.f;

  const int n_tiles = (Tn + BQ - 1) / BQ;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int i0 = qt * BQ;
    __syncthreads();  // the previous tile's readers are done
    load_query_rows<T, D>(q + seq, dout + seq, pos_u, pos_v,
                          stats + static_cast<size_t>(bh) * Tn,
                          delta + static_cast<size_t>(bh) * Tn, h, i0, Tn,
                          qu_s, qv_s, do_s, m_s, l_s, dl_s);
    load_p_window<T, D>(pg, i0, j0, Tn, pw_s);
    __syncthreads();
    tile_ds<D>(qu_s, qv_s, do_s, k_s, v_s, pw_s, kb_s, m_s, l_s, dl_s, i0, j0,
               Tn, scale, w_s, ds_s);
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
        a_q[jj] = qu_s[r * LD + tx + 16 * jj];
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

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* p,
               const float* pos_u, const float* pos_v, const float* kbias,
               const void* dout, const float2* stats, const float* delta,
               float* dqu, float* dqv, float* slabs, float* dk, float* dv,
               int B, int H, int Tn, cudaStream_t stream) {
  const float scale = rsqrtf(static_cast<float>(D));
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
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace espnet_port

// q, k, v, out: (B, H, T, D); p: (H, 2T-1, D), all of one dtype, contiguous.
// pos_u, pos_v: (H, D) float32; kbias: (B, T) float32. stats: (B, H, T)
// float2 (row max, row sum) for the backward, or null.
extern "C" int espnet_relpos_attention_fwd(const void* q, const void* k,
                                           const void* v, const void* p,
                                           const float* pos_u,
                                           const float* pos_v,
                                           const float* kbias, void* out,
                                           void* stats, int B, int H, int T,
                                           int D, int dtype, void* stream) {
  using namespace espnet_port;
  if (B < 1 || H < 1 || T < 1) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* st = static_cast<float2*>(stats);
#define ESPNET_RELPOS_FWD(TT, DD)                                        \
  return launch<TT, DD>(q, k, v, p, pos_u, pos_v, kbias, out, st, B, H, T, \
                        s)
  if (dtype == kFloat32 && D == 32) ESPNET_RELPOS_FWD(float, 32);
  if (dtype == kFloat32 && D == 64) ESPNET_RELPOS_FWD(float, 64);
  if (dtype == kFloat32 && D == 128) ESPNET_RELPOS_FWD(float, 128);
  if (dtype == kBFloat16 && D == 32) ESPNET_RELPOS_FWD(__nv_bfloat16, 32);
  if (dtype == kBFloat16 && D == 64) ESPNET_RELPOS_FWD(__nv_bfloat16, 64);
  if (dtype == kBFloat16 && D == 128) ESPNET_RELPOS_FWD(__nv_bfloat16, 128);
#undef ESPNET_RELPOS_FWD
  return kUnsupported;
}

// Rows of one dp slab of espnet_relpos_attention_bwd for sequence length T.
extern "C" int espnet_relpos_attention_slab_rows(int T) {
  using namespace espnet_port;
  return ((T + BK - 1) / BK) * BK + BQ - 1;
}

// Backward of espnet_relpos_attention_fwd. dout: (B, H, T, D) in q's dtype;
// stats from the forward; delta: (B, H, T) float32 = rowsum(dout * out).
// Writes dqu, dqv, dk, dv: (B, H, T, D) float32 and slabs: (B, H,
// ceil(T/64), slab_rows(T), D) float32, the dp contributions of each query
// block, where slab row 0 of query block n is p row T-1-(64n+63).
extern "C" int espnet_relpos_attention_bwd(
    const void* q, const void* k, const void* v, const void* p,
    const float* pos_u, const float* pos_v, const float* kbias,
    const void* dout, const void* stats, const float* delta, float* dqu,
    float* dqv, float* slabs, float* dk, float* dv, int B, int H, int T,
    int D, int dtype, void* stream) {
  using namespace espnet_port;
  if (B < 1 || H < 1 || T < 1) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* st = static_cast<const float2*>(stats);
#define ESPNET_RELPOS_BWD(TT, DD)                                           \
  return launch_bwd<TT, DD>(q, k, v, p, pos_u, pos_v, kbias, dout, st,      \
                            delta, dqu, dqv, slabs, dk, dv, B, H, T, s)
  if (dtype == kFloat32 && D == 32) ESPNET_RELPOS_BWD(float, 32);
  if (dtype == kFloat32 && D == 64) ESPNET_RELPOS_BWD(float, 64);
  if (dtype == kBFloat16 && D == 32) ESPNET_RELPOS_BWD(__nv_bfloat16, 32);
  if (dtype == kBFloat16 && D == 64) ESPNET_RELPOS_BWD(__nv_bfloat16, 64);
#undef ESPNET_RELPOS_BWD
  return kUnsupported;
}

extern "C" const char* espnet_cuda_error_string(int code) {
  if (code == espnet_port::kUnsupported) return "unsupported argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
