// Flash attention with a key-padding bias, forward.
//
// Replaces the Pallas kernel `_flash_kernel` behind `flash_attention`
// (espnet_tpu/ops/pallas_attention.py):
//
//   out[b,h,i] = softmax_j( q_i·k_j / sqrt(D) + max(kbias[b,j], NEG) ) · v
//
// The JAX package has no backward kernel (its custom VJP recomputes through
// the plain attention), and neither has the port.
//
// What bounds it on an H100: 4·B·H·T²·D flops (QKᵀ and P·V) against
// 4·B·H·T·D elements moved, T / (element size) flops per byte: ~234 at
// T=469 in bf16, just below the card's ridge of ~295, so the bytes bound
// binds by a little at the training shapes. This first version does the
// products on the CUDA cores in float32 (no tensor cores yet), far above
// both bounds, which chip_smoke.py reports beside it.
//
// What the design does about it:
// * The (B, H, T, T) score tensor is never built. A block owns one (b, h)
//   and BQ query rows and walks the keys in BK-wide tiles; an online
//   softmax in float32 keeps each score tile in registers, and the
//   unnormalised probability tile goes through shared memory once for the
//   P·V product. The key bias is a (B, T) vector, one BK slice per tile.
// * Each thread holds a 4x4 sub-tile of rows ty+16i and columns tx+16j;
//   rows of stride D+1 keep the column reads free of bank conflicts.
// * Masking follows the plain reference (`_reference_attention`), not the
//   Pallas kernel: the key bias is clamped at NEG = finfo(f32).min/2 and
//   the running max starts at NEG, so a query whose keys are all masked
//   averages v uniformly over the T keys (the Pallas kernel averages over
//   its padded key length instead). Keys past T are skipped.
#include "common.cuh"

namespace espnet_port {
namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16: tx = column lane, ty = row lane
constexpr float NEG = -FLT_MAX / 2;

template <int D>
constexpr size_t flash_smem_bytes() {
  // q (BQ rows), k, v (BK rows), the probability tile, the tile's key bias
  return sizeof(float) * ((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1) + BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_attention_fwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const float* __restrict__ kbias,
                               T* __restrict__ out, int H, int Tn,
                               float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int DJ = D / 16;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * LD;
  float* v_s = k_s + BK * LD;
  float* prob_s = v_s + BK * LD;
  float* kb_s = prob_s + BQ * LP;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int i0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const size_t seq = static_cast<size_t>(bh) * Tn * D;
  const T* qg = q + seq;
  const T* kg = k + seq;
  const T* vg = v + seq;
  const float* kbg = kbias + static_cast<size_t>(b) * Tn;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int i = i0 + r;
    q_s[r * LD + d] = i < Tn ? to_f32(qg[static_cast<size_t>(i) * D + d]) : 0.f;
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
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a_q[4], a_k[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) a_q[ii] = q_s[(ty + 16 * ii) * LD + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) a_k[jj] = k_s[(tx + 16 * jj) * LD + d];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[ii][jj] += a_q[ii] * a_k[jj];
    }

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
        prob_s[(ty + 16 * ii) * LP + c] = e;
        rs += e;
      }
      rs = half_warp_sum(rs);
      l[ii] = l[ii] * alpha + rs;
      m[ii] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[ii][jj] *= alpha;
    }
    __syncthreads();  // the probability tile is complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a_p[4], a_v[DJ];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) a_p[ii] = prob_s[(ty + 16 * ii) * LP + c];
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
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* kbias,
           void* out, int B, int H, int Tn, float scale,
           cudaStream_t stream) {
  auto kernel = flash_attention_fwd_kernel<T, D>;
  const size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tn + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kbias, static_cast<T*>(out), H, Tn, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace espnet_port

// q, k, v, out: (B, H, T, D) of one dtype, contiguous; kbias: (B, T)
// float32 additive key bias. D in {32, 64, 128}; scale multiplies the
// scores (1/sqrt of the head dim before any zero padding to D).
extern "C" int espnet_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, const float* kbias,
                                          void* out, int B, int H, int T,
                                          int D, float scale, int dtype,
                                          void* stream) {
  using namespace espnet_port;
  if (B < 1 || H < 1 || T < 1) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ESPNET_FLASH_FWD(TT, DD) \
  return launch<TT, DD>(q, k, v, kbias, out, B, H, T, scale, s)
  if (dtype == kFloat32 && D == 32) ESPNET_FLASH_FWD(float, 32);
  if (dtype == kFloat32 && D == 64) ESPNET_FLASH_FWD(float, 64);
  if (dtype == kFloat32 && D == 128) ESPNET_FLASH_FWD(float, 128);
  if (dtype == kBFloat16 && D == 32) ESPNET_FLASH_FWD(__nv_bfloat16, 32);
  if (dtype == kBFloat16 && D == 64) ESPNET_FLASH_FWD(__nv_bfloat16, 64);
  if (dtype == kBFloat16 && D == 128) ESPNET_FLASH_FWD(__nv_bfloat16, 128);
#undef ESPNET_FLASH_FWD
  return kUnsupported;
}
