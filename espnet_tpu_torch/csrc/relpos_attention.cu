// Rel-pos (Transformer-XL) flash attention, forward.
//
// Replaces the Pallas kernels `_fwd_kernel` / `_fwd_kernel_fold` behind
// `relpos_flash_attention` (espnet_tpu/ops/pallas_relpos_attention.py).
//
//   out[b,h,i] = softmax_j( ((q+u)·k_j + (q+v)·p[T-1-(i-j)]) / sqrt(D)
//                           + max(kbias[b,j], NEG) ) · v
//
// What bounds it on an H100: the work is 6·B·H·T²·D flops (ac, bd and P·V)
// against 4·B·H·T·D elements moved, so at T≈470, D=64 it is bound by
// arithmetic, not by device memory. This first version does the products on
// the CUDA cores in float32 (no tensor cores yet), so it runs well below the
// bf16 tensor-core bound that chip_smoke.py reports beside it.
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
                                T* __restrict__ out, int H, int Tn,
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
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* p,
           const float* pos_u, const float* pos_v, const float* kbias,
           void* out, int B, int H, int Tn, cudaStream_t stream) {
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
      static_cast<T*>(out), H, Tn, rsqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* p,
               const float* pos_u, const float* pos_v, const float* kbias,
               void* out, int B, int H, int Tn, int D, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, p, pos_u, pos_v, kbias, out, B, H, Tn,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, p, pos_u, pos_v, kbias, out, B, H, Tn,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, p, pos_u, pos_v, kbias, out, B, H, Tn,
                            stream);
    default:
      return kUnsupported;
  }
}

}  // namespace
}  // namespace espnet_port

// q, k, v, out: (B, H, T, D); p: (H, 2T-1, D), all of one dtype, contiguous.
// pos_u, pos_v: (H, D) float32; kbias: (B, T) float32.
extern "C" int espnet_relpos_attention_fwd(const void* q, const void* k,
                                           const void* v, const void* p,
                                           const float* pos_u,
                                           const float* pos_v,
                                           const float* kbias, void* out,
                                           int B, int H, int T, int D,
                                           int dtype, void* stream) {
  using namespace espnet_port;
  if (B < 1 || H < 1 || T < 1) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_d<float>(q, k, v, p, pos_u, pos_v, kbias, out, B, H, T, D,
                             s);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, p, pos_u, pos_v, kbias, out, B,
                                     H, T, D, s);
  return kUnsupported;
}

extern "C" const char* espnet_cuda_error_string(int code) {
  if (code == espnet_port::kUnsupported) return "unsupported argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
