// Position-wise FFN with hash dropout, no LayerNorm and no residual: the C
// entry points of the LN = false kernels in ffn_kernels.cuh, which replace
// the Pallas `_ffn_fwd_kernel` and `_ffn_bwd_kernel` behind `fused_ffn`
// (espnet_tpu/ops/pallas_ffn.py):
//
//   y = drop(act(x W1 + b1)) W2 + b2
//
// with the one mask of `fused_ffn` (seed, width F, 256-row tiles): the
// first mask of the pre-norm variant, bit for bit. The design and what
// bounds it are described in ffn_kernels.cuh.
#include "ffn_kernels.cuh"

// x, y: (M, D); w1: (D, F); w2: (F, D), all of one dtype, contiguous.
// D in {128, 256, 384, 512}.
// b1: (F,), b2: (D,) float32. F % 128 == 0. act: 0 = swish, 1 = relu. q:
// dropout level in 1/256 (0 = none), dscale its keep scale 256 / (256 - q).
// bf16 runs on tensor cores and needs x, w1 and w2 16-byte aligned; float32
// runs on the CUDA cores.
extern "C" int espnet_ffn_fwd(const void* x, const void* w1, const float* b1,
                              const void* w2, const float* b2, void* y, int M,
                              int D, int F, int act, int q, float dscale,
                              int seed, int dtype, void* stream) {
  using namespace espnet_port;
  if (!options_ok(M, F, act, q)) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop dr{q, dscale, seed, 0};
#define ESPNET_FFN_FWD(T, DD)                                             \
  return launch_fwd<T, DD, false>(x, nullptr, nullptr, w1, b1, w2, b2, y, \
                                  M, F, 1.f, act, dr, s)
  if (dtype == kFloat32 && D == 128) ESPNET_FFN_FWD(float, 128);
  if (dtype == kFloat32 && D == 256) ESPNET_FFN_FWD(float, 256);
  if (dtype == kFloat32 && D == 384) ESPNET_FFN_FWD(float, 384);
  if (dtype == kFloat32 && D == 512) ESPNET_FFN_FWD(float, 512);
#undef ESPNET_FFN_FWD
#define ESPNET_FFN_FWD_TC(DD)                                              \
  return launch_fwd_tc<DD, false>(x, nullptr, nullptr, w1, b1, w2, b2, y, \
                                  M, F, 1.f, act, dr, s)
  if (dtype == kBFloat16 && D == 128) ESPNET_FFN_FWD_TC(128);
  if (dtype == kBFloat16 && D == 256) ESPNET_FFN_FWD_TC(256);
  if (dtype == kBFloat16 && D == 384) ESPNET_FFN_FWD_TC(384);
  if (dtype == kBFloat16 && D == 512) ESPNET_FFN_FWD_TC(512);
#undef ESPNET_FFN_FWD_TC
  return kUnsupported;
}

// Backward of espnet_ffn_fwd (same x, weights and options) for the output
// gradient gy (M, D, x's dtype). Writes dx (M, D) and float32 partial sums:
// partial (row blocks, D) of db2, dw1p (groups, D, F) and dw2p (groups, F,
// D) over row groups of rows_per_group rows, and db1p over row groups
// (float32: (groups, F)) or row blocks (bf16: (row blocks, F)). bf16 runs on
// tensor cores and also writes a_buf and dh_buf (M, F), 16-byte aligned
// like every bf16 input; float32 runs on the CUDA cores and takes null for
// them. Row blocks as in espnet_ffn_bwd_rows_per_block (prenorm_ffn.cu).
extern "C" int espnet_ffn_bwd(const void* x, const void* w1, const float* b1,
                              const void* w2, const void* gy, void* dx,
                              void* a_buf, void* dh_buf, float* partial,
                              float* dw1p, float* dw2p, float* db1p, int M,
                              int D, int F, int groups, int rows_per_group,
                              int act, int q, float dscale, int seed,
                              int dtype, void* stream) {
  using namespace espnet_port;
  if (!options_ok(M, F, act, q) || groups < 1 || rows_per_group < 1 ||
      static_cast<long long>(groups) * rows_per_group < M)
    return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop dr{q, dscale, seed, 0};
#define ESPNET_FFN_BWD(DD)                                                   \
  return launch_bwd<float, DD, false>(x, nullptr, nullptr, w1, b1, w2, gy,   \
                                      dx, nullptr, nullptr, partial, dw1p,   \
                                      dw2p, db1p, M, F, groups,              \
                                      rows_per_group, 1.f, act, dr, s)
  if (dtype == kFloat32 && D == 128) ESPNET_FFN_BWD(128);
  if (dtype == kFloat32 && D == 256) ESPNET_FFN_BWD(256);
  if (dtype == kFloat32 && D == 384) ESPNET_FFN_BWD(384);
  if (dtype == kFloat32 && D == 512) ESPNET_FFN_BWD(512);
#undef ESPNET_FFN_BWD
#define ESPNET_FFN_BWD_TC(DD)                                               \
  return launch_bwd_tc<DD, false>(x, nullptr, nullptr, w1, b1, w2, gy, dx,  \
                                  nullptr, nullptr, a_buf, dh_buf, partial, \
                                  dw1p, dw2p, db1p, M, F, groups,           \
                                  rows_per_group, 1.f, act, dr, s)
  if (dtype == kBFloat16 && D == 128) ESPNET_FFN_BWD_TC(128);
  if (dtype == kBFloat16 && D == 256) ESPNET_FFN_BWD_TC(256);
  if (dtype == kBFloat16 && D == 384) ESPNET_FFN_BWD_TC(384);
  if (dtype == kBFloat16 && D == 512) ESPNET_FFN_BWD_TC(512);
#undef ESPNET_FFN_BWD_TC
  return kUnsupported;
}
