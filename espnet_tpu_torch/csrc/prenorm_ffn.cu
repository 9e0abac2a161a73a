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
// bf16 runs on tensor cores and needs x, w1 and w2 16-byte aligned; float32
// runs on the CUDA cores.
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
#undef ESPNET_PFFN_FWD
#define ESPNET_PFFN_FWD_TC(DD)                                             \
  return launch_fwd_tc<DD, true>(x, ln_scale, ln_bias, w1, b1, w2, b2, y, M, \
                                 F, res_scale, act, dr, s)
  if (dtype == kBFloat16 && D == 128) ESPNET_PFFN_FWD_TC(128);
  if (dtype == kBFloat16 && D == 256) ESPNET_PFFN_FWD_TC(256);
  if (dtype == kBFloat16 && D == 384) ESPNET_PFFN_FWD_TC(384);
  if (dtype == kBFloat16 && D == 512) ESPNET_PFFN_FWD_TC(512);
#undef ESPNET_PFFN_FWD_TC
  return kUnsupported;
}

// Backward of espnet_prenorm_ffn_fwd (same x, weights and options) for the
// output gradient gy (M, D, x's dtype). Writes dx (M, D), scratch xn_buf and
// dz_buf (M, D, x's dtype), and float32 partial sums: partial (row blocks,
// 3, D) of dLN scale, dLN bias and db2, dw1p (groups, D, F) and dw2p
// (groups, F, D) over row groups of rows_per_group rows, and db1p over row
// groups (float32: (groups, F)) or row blocks (bf16: (row blocks, F)).
// bf16 runs on tensor cores and also writes a_buf and dh_buf (M, F), 16-byte
// aligned like every bf16 input (row blocks of espnet_ffn_bwd_rows_per_block
// rows); float32 runs on the CUDA cores (row blocks of 32 rows) and takes
// null for a_buf and dh_buf.
extern "C" int espnet_prenorm_ffn_bwd(
    const void* x, const float* ln_scale, const float* ln_bias,
    const void* w1, const float* b1, const void* w2, const void* gy,
    void* dx, void* xn_buf, void* dz_buf, void* a_buf, void* dh_buf,
    float* partial, float* dw1p, float* dw2p, float* db1p, int M, int D,
    int F, int groups, int rows_per_group, float res_scale, int act, int q,
    float dscale, int seed0, int seed1, int dtype, void* stream) {
  using namespace espnet_port;
  if (!options_ok(M, F, act, q) || groups < 1 || rows_per_group < 1 ||
      static_cast<long long>(groups) * rows_per_group < M)
    return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop dr{q, dscale, seed0, seed1};
#define ESPNET_PFFN_BWD(DD)                                                 \
  return launch_bwd<float, DD, true>(x, ln_scale, ln_bias, w1, b1, w2, gy,  \
                                     dx, xn_buf, dz_buf, partial, dw1p,     \
                                     dw2p, db1p, M, F, groups,              \
                                     rows_per_group, res_scale, act, dr, s)
  if (dtype == kFloat32 && D == 128) ESPNET_PFFN_BWD(128);
  if (dtype == kFloat32 && D == 256) ESPNET_PFFN_BWD(256);
  if (dtype == kFloat32 && D == 384) ESPNET_PFFN_BWD(384);
  if (dtype == kFloat32 && D == 512) ESPNET_PFFN_BWD(512);
#undef ESPNET_PFFN_BWD
#define ESPNET_PFFN_BWD_TC(DD)                                                \
  return launch_bwd_tc<DD, true>(x, ln_scale, ln_bias, w1, b1, w2, gy, dx,    \
                                 xn_buf, dz_buf, a_buf, dh_buf, partial, dw1p, \
                                 dw2p, db1p, M, F, groups, rows_per_group,    \
                                 res_scale, act, dr, s)
  if (dtype == kBFloat16 && D == 128) ESPNET_PFFN_BWD_TC(128);
  if (dtype == kBFloat16 && D == 256) ESPNET_PFFN_BWD_TC(256);
  if (dtype == kBFloat16 && D == 384) ESPNET_PFFN_BWD_TC(384);
  if (dtype == kBFloat16 && D == 512) ESPNET_PFFN_BWD_TC(512);
#undef ESPNET_PFFN_BWD_TC
  return kUnsupported;
}

// Rows per block of the backward's row kernel (the float32 `bwd_dx` or the
// bf16 tensor-core kernel at model width D); -1 for what it does not take.
extern "C" int espnet_ffn_bwd_rows_per_block(int D, int dtype) {
  using namespace espnet_port;
  if (dtype == kFloat32) return BM;
  if (dtype != kBFloat16) return kUnsupported;
  switch (D) {
    case 128: return TcRows<128>::BMR;
    case 256: return TcRows<256>::BMR;
    case 384: return TcRows<384>::BMR;
    case 512: return TcRows<512>::BMR;
    default: return kUnsupported;
  }
}
