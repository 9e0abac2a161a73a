// Pre-norm position-wise FFN with residual, forward.
//
// Replaces the Pallas kernel `_pffn_fwd_kernel` behind `fused_prenorm_ffn`
// (espnet_tpu/ops/pallas_ffn.py), without dropout:
//
//   y = x + s * (act(LN(x) W1 + b1) W2 + b2),   LN eps 1e-6, act swish|relu
//
// The operands round as in the Pallas kernel: LN(x) and act(.) are rounded
// to x's dtype before each product, products accumulate in float32, and the
// residual sum is rounded once at the end.
//
// What bounds it on an H100: 4·M·D·F flops against (2·M·D + 2·D·F)
// elements moved — at M=1500, D=256, F=2048 some 600 flops per byte, so it
// is bound by arithmetic. This first version does the products on the CUDA
// cores in float32 (no tensor cores yet), far below the bf16 bound.
//
// What the design does about it:
// * The (M, F) hidden activation never reaches device memory. A block owns
//   BM rows: it normalises them into shared memory once, then walks F in
//   chunks of BF: h = act(LN(x) W1[:, chunk] + b1) goes to shared memory and
//   is at once multiplied into the float32 output accumulator in registers
//   (BM x D per block, 32 values a thread at D=256).
// * W1 and W2 stream through shared memory in KS-row slabs that every
//   thread of the block reuses; the weights are read from L2 once per block.
// * Rows past M are normalised from zeros (finite) and never stored.
#include "common.cuh"

namespace espnet_port {
namespace {

constexpr int BM = 32;        // rows per block
constexpr int BF = 128;       // hidden units per chunk
constexpr int KS = 32;        // depth of one weight slab
constexpr int THREADS = 256;  // 8 warps
constexpr float LN_EPS = 1e-6f;

enum Act : int { kSwish = 0, kRelu = 1 };

template <int D>
constexpr size_t ffn_smem_bytes() {
  // normalised rows, a W1 slab, the hidden chunk, a W2 slab
  return sizeof(float) *
         (BM * (D + 1) + KS * BF + BM * (BF + 1) + KS * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    prenorm_ffn_fwd_kernel(const T* __restrict__ x,
                           const float* __restrict__ ln_scale,
                           const float* __restrict__ ln_bias,
                           const T* __restrict__ w1,
                           const float* __restrict__ b1,
                           const T* __restrict__ w2,
                           const float* __restrict__ b2, T* __restrict__ y,
                           int M, int F, float res_scale, int act) {
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

  // LayerNorm in float32: warp w normalises rows 4w .. 4w+3.
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
  }

  // thread tile: rows warp+8ii; hidden columns lane+32jj / output lane+32jj
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
        float hv = hacc[ii][jj] + b1[c0 + f];
        hv = act == kRelu ? fmaxf(hv, 0.f) : hv / (1.f + expf(-hv));
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
      y[g] = from_f32<T>(to_f32(x[g]) + res_scale * (z[ii][jj] + b2[n]));
    }
  }
}

template <typename T, int D>
int launch(const void* x, const float* ln_scale, const float* ln_bias,
           const void* w1, const float* b1, const void* w2, const float* b2,
           void* y, int M, int F, float res_scale, int act,
           cudaStream_t stream) {
  auto kernel = prenorm_ffn_fwd_kernel<T, D>;
  const size_t smem = ffn_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(M + BM - 1) / BM, THREADS, smem, stream>>>(
      static_cast<const T*>(x), ln_scale, ln_bias, static_cast<const T*>(w1),
      b1, static_cast<const T*>(w2), b2, static_cast<T*>(y), M, F, res_scale,
      act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* x, const float* ln_scale, const float* ln_bias,
               const void* w1, const float* b1, const void* w2,
               const float* b2, void* y, int M, int D, int F, float res_scale,
               int act, cudaStream_t stream) {
  switch (D) {
    case 256:
      return launch<T, 256>(x, ln_scale, ln_bias, w1, b1, w2, b2, y, M, F,
                            res_scale, act, stream);
    case 512:
      return launch<T, 512>(x, ln_scale, ln_bias, w1, b1, w2, b2, y, M, F,
                            res_scale, act, stream);
    default:
      return kUnsupported;
  }
}

}  // namespace
}  // namespace espnet_port

// x, y: (M, D); w1: (D, F); w2: (F, D), all of one dtype, contiguous.
// ln_scale, ln_bias, b2: (D,) float32; b1: (F,) float32. F % 128 == 0.
// act: 0 = swish, 1 = relu.
extern "C" int espnet_prenorm_ffn_fwd(const void* x, const float* ln_scale,
                                      const float* ln_bias, const void* w1,
                                      const float* b1, const void* w2,
                                      const float* b2, void* y, int M, int D,
                                      int F, float res_scale, int act,
                                      int dtype, void* stream) {
  using namespace espnet_port;
  if (M < 1 || F < BF || F % BF != 0) return kUnsupported;
  if (act != kSwish && act != kRelu) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_d<float>(x, ln_scale, ln_bias, w1, b1, w2, b2, y, M, D, F,
                             res_scale, act, s);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(x, ln_scale, ln_bias, w1, b1, w2, b2, y,
                                     M, D, F, res_scale, act, s);
  return kUnsupported;
}
