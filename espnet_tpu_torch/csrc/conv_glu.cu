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
// dropout is the FFN kernels' hash over 256-row tiles of the flattened rows
// (one seed, width D), bit for bit; its backward regenerates the mask.
//
// Both are the pre-norm FFN's anatomy with one product instead of two: a
// row-local LayerNorm, one product, a pointwise epilogue. They are built
// from the pieces of ffn_kernels.cuh: `layer_norm_rows` (with the swish as
// the tail's epilogue), `tile_product` (32 rows by up to 512 columns,
// weights staged through shared memory in 32-deep slabs; float32 FMAs on
// the CUDA cores, no tensor cores yet), the hash, `ln_bwd_row` and
// `store_block_sums`.
//
// What bounds them on an H100: at the bench's M = 30016 rows and D = 256
// in bf16 the head does 4·M·D² = 7.9 GFLOP against 2·M·D + 2·D² elements
// (30.7 MB) and the tail 2·M·D² = 3.9 GFLOP against 46 MB: some 250 and 85
// flops per byte, below the card's 295, so both are bound by bytes
// (9.2 µs and 13.8 µs) -- at the bf16 tensor-core rate. This first version
// runs its products on the CUDA cores in float32 (67 TFLOP/s), where the
// operations bind instead (0.12 and 0.06 ms at best).
//
// What the design does about it:
// * One read of x (head) or of g and x_res (tail) and one write of the
//   output: the 2D-wide pre-GLU activation and the normalised rows never
//   reach device memory.
// * The Pallas backward sums the parameter gradients across its sequential
//   grid. Blocks here run in no order, so each backward is two kernels, as
//   the FFN's: a dx kernel that owns 32 rows, recomputes the forward,
//   writes dx, the rounded product operands (LN(x) and dh; swish(LN(g)) and
//   dz) and per-block partial sums of the LayerNorm and bias gradients;
//   then the weight gradient as A^T B over groups of rows (`atb_kernel`),
//   whose few partial sums are added afterwards (no atomics).
// * D is a template argument, a multiple of 128 up to 512 (the JAX gate
//   passes multiples of 128); the shared memory of the dx kernels at
//   D = 512 is 197 KB of the 227 KB a block may have.
#include "ffn_kernels.cuh"

namespace espnet_port {
namespace {

static_assert(2 * BF == THREADS, "the db1 sums take one thread a column");

// ---------------------------------------------------------------------------
// head
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
// tail
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
             int q, float dscale, int seed, cudaStream_t s) {
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

}  // namespace
}  // namespace espnet_port

// Dispatch on dtype and D in {128, 256, 384, 512}.
#define ESPNET_CONV_GLU_DISPATCH(FN, ...)                                    \
  do {                                                                       \
    if (dtype == kFloat32 && D == 128) return FN<float, 128>(__VA_ARGS__);   \
    if (dtype == kFloat32 && D == 256) return FN<float, 256>(__VA_ARGS__);   \
    if (dtype == kFloat32 && D == 384) return FN<float, 384>(__VA_ARGS__);   \
    if (dtype == kFloat32 && D == 512) return FN<float, 512>(__VA_ARGS__);   \
    if (dtype == kBFloat16 && D == 128)                                      \
      return FN<__nv_bfloat16, 128>(__VA_ARGS__);                            \
    if (dtype == kBFloat16 && D == 256)                                      \
      return FN<__nv_bfloat16, 256>(__VA_ARGS__);                            \
    if (dtype == kBFloat16 && D == 384)                                      \
      return FN<__nv_bfloat16, 384>(__VA_ARGS__);                            \
    if (dtype == kBFloat16 && D == 512)                                      \
      return FN<__nv_bfloat16, 512>(__VA_ARGS__);                            \
    return kUnsupported;                                                     \
  } while (0)

// x, g: (M, D); w1: (D, 2D), of one dtype, contiguous; lns, lnb: (D,),
// b1: (2D,) float32.
extern "C" int espnet_conv_glu_fwd(const void* x, const float* lns,
                                   const float* lnb, const void* w1,
                                   const float* b1, void* g, int M, int D,
                                   int dtype, void* stream) {
  using namespace espnet_port;
  if (M < 1) return kUnsupported;
  ESPNET_CONV_GLU_DISPATCH(glu_fwd, x, lns, lnb, w1, b1, g, M,
                           static_cast<cudaStream_t>(stream));
}

// Backward of espnet_conv_glu_fwd for dg (M, D, x's dtype): dx (M, D),
// scratch xn_buf (M, D) and dh_buf (M, 2D) in x's dtype, partial
// (ceil(M/32), 4, D) float32 = per-block (dLN scale, dLN bias, db1 (2D)),
// dw1p (groups, D, 2D) float32 = per-group sums of dW1.
extern "C" int espnet_conv_glu_bwd(const void* x, const float* lns,
                                   const float* lnb, const void* w1,
                                   const float* b1, const void* dg, void* dx,
                                   void* xn_buf, void* dh_buf, float* partial,
                                   float* dw1p, int M, int D, int groups,
                                   int dtype, void* stream) {
  using namespace espnet_port;
  if (M < 1 || groups < 1) return kUnsupported;
  ESPNET_CONV_GLU_DISPATCH(glu_bwd, x, lns, lnb, w1, b1, dg, dx, xn_buf,
                           dh_buf, partial, dw1p, M, groups,
                           static_cast<cudaStream_t>(stream));
}

// g, x_res, y: (M, D); w2: (D, D), of one dtype, contiguous; lns, lnb, b2:
// (D,) float32. q: dropout level in 1/256 (0 = none), dscale its keep scale
// 256 / (256 - q), seed the hash's int32 seed.
extern "C" int espnet_conv_tail_fwd(const void* g, const void* xr,
                                    const float* lns, const float* lnb,
                                    const void* w2, const float* b2, void* y,
                                    int M, int D, int q, float dscale,
                                    int seed, int dtype, void* stream) {
  using namespace espnet_port;
  if (M < 1 || q < 0 || q > 255) return kUnsupported;
  ESPNET_CONV_GLU_DISPATCH(tail_fwd, g, xr, lns, lnb, w2, b2, y, M, q, dscale,
                           seed, static_cast<cudaStream_t>(stream));
}

// Backward of espnet_conv_tail_fwd for dy (M, D, g's dtype): dg (M, D),
// scratch a_buf and dz_buf (M, D, g's dtype), partial (ceil(M/32), 3, D)
// float32 = per-block (dLN scale, dLN bias, db2), dw2p (groups, D, D)
// float32 = per-group sums of dW2. x_res's gradient is dy itself.
extern "C" int espnet_conv_tail_bwd(const void* g, const float* lns,
                                    const float* lnb, const void* w2,
                                    const void* dy, void* dg, void* a_buf,
                                    void* dz_buf, float* partial, float* dw2p,
                                    int M, int D, int groups, int q,
                                    float dscale, int seed, int dtype,
                                    void* stream) {
  using namespace espnet_port;
  if (M < 1 || groups < 1 || q < 0 || q > 255) return kUnsupported;
  ESPNET_CONV_GLU_DISPATCH(tail_bwd, g, lns, lnb, w2, dy, dg, a_buf, dz_buf,
                           partial, dw2p, M, groups, q, dscale, seed,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int espnet_conv_glu_rows_per_block() { return espnet_port::BM; }
