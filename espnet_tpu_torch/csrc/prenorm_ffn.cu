// Pre-norm position-wise FFN with residual and hash dropout: the C entry
// points of the LN = true kernels in ffn_kernels.cuh, which replace the
// Pallas `_pffn_fwd_kernel` and `_pffn_bwd_kernel` behind
// `fused_prenorm_ffn` (espnet_tpu/ops/pallas_ffn.py):
//
//   y = x + s * drop1(drop0(act(LN(x) W1 + b1)) W2 + b2)
//
// The design and what bounds it are described in ffn_kernels.cuh.
#include "ffn_kernels.cuh"


// x, y: (M, D); w1: (D, F); w2: (F, D), all of one dtype, contiguous.
// D in {128, 256, 384, 512}.
// ln_scale, ln_bias, b2: (D,) float32; b1: (F,) float32. F % 128 == 0.
// act: 0 = swish, 1 = relu. q: dropout level in 1/256 (0 = none), dscale
// its keep scale 256 / (256 - q); seed0 / seed1 the two streams' seeds.
extern "C" int espnet_prenorm_ffn_fwd(const void* x, const float* ln_scale,
                                      const float* ln_bias, const void* w1,
                                      const float* b1, const void* w2,
                                      const float* b2, void* y, int M, int D,
                                      int F, float res_scale, int act, int q,
                                      float dscale, int seed0, int seed1,
                                      int dtype, void* stream) {
  using namespace espnet_port;
  if (!options_ok(M, F, act, q)) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop dr{q, dscale, seed0, seed1};
#define ESPNET_PFFN_FWD(T, DD)                                             \
  return launch_fwd<T, DD, true>(x, ln_scale, ln_bias, w1, b1, w2, b2, y, M, \
                                 F, res_scale, act, dr, s)
  if (dtype == kFloat32 && D == 128) ESPNET_PFFN_FWD(float, 128);
  if (dtype == kFloat32 && D == 256) ESPNET_PFFN_FWD(float, 256);
  if (dtype == kFloat32 && D == 384) ESPNET_PFFN_FWD(float, 384);
  if (dtype == kFloat32 && D == 512) ESPNET_PFFN_FWD(float, 512);
  if (dtype == kBFloat16 && D == 128) ESPNET_PFFN_FWD(__nv_bfloat16, 128);
  if (dtype == kBFloat16 && D == 256) ESPNET_PFFN_FWD(__nv_bfloat16, 256);
  if (dtype == kBFloat16 && D == 384) ESPNET_PFFN_FWD(__nv_bfloat16, 384);
  if (dtype == kBFloat16 && D == 512) ESPNET_PFFN_FWD(__nv_bfloat16, 512);
#undef ESPNET_PFFN_FWD
  return kUnsupported;
}

// Backward of espnet_prenorm_ffn_fwd (same x, weights and options) for the
// output gradient gy (M, D, x's dtype). Writes dx (M, D), scratch xn_buf and
// dz_buf (M, D, x's dtype), partial (ceil(M/32), 3, D) float32 = per-block
// sums of dLN scale, dLN bias and db2, and dw1p (groups, D, F), dw2p
// (groups, F, D), db1p (groups, F) float32 = per-group sums.
extern "C" int espnet_prenorm_ffn_bwd(
    const void* x, const float* ln_scale, const float* ln_bias,
    const void* w1, const float* b1, const void* w2, const void* gy,
    void* dx, void* xn_buf, void* dz_buf, float* partial, float* dw1p,
    float* dw2p, float* db1p, int M, int D, int F, int groups,
    float res_scale, int act, int q, float dscale, int seed0, int seed1,
    int dtype, void* stream) {
  using namespace espnet_port;
  if (!options_ok(M, F, act, q) || groups < 1) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop dr{q, dscale, seed0, seed1};
#define ESPNET_PFFN_BWD(T, DD)                                            \
  return launch_bwd<T, DD, true>(x, ln_scale, ln_bias, w1, b1, w2, gy, dx, \
                                 xn_buf, dz_buf, partial, dw1p, dw2p, db1p, \
                                 M, F, groups, res_scale, act, dr, s)
  if (dtype == kFloat32 && D == 128) ESPNET_PFFN_BWD(float, 128);
  if (dtype == kFloat32 && D == 256) ESPNET_PFFN_BWD(float, 256);
  if (dtype == kFloat32 && D == 384) ESPNET_PFFN_BWD(float, 384);
  if (dtype == kFloat32 && D == 512) ESPNET_PFFN_BWD(float, 512);
  if (dtype == kBFloat16 && D == 128) ESPNET_PFFN_BWD(__nv_bfloat16, 128);
  if (dtype == kBFloat16 && D == 256) ESPNET_PFFN_BWD(__nv_bfloat16, 256);
  if (dtype == kBFloat16 && D == 384) ESPNET_PFFN_BWD(__nv_bfloat16, 384);
  if (dtype == kBFloat16 && D == 512) ESPNET_PFFN_BWD(__nv_bfloat16, 512);
#undef ESPNET_PFFN_BWD
  return kUnsupported;
}

extern "C" int espnet_prenorm_ffn_bwd_rows_per_block() {
  return espnet_port::BM;
}
