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
// binds by a little at the training shapes (chip_smoke.py reports it). In
// bf16 that leaves the tensor cores busy for a few microseconds per block;
// what costs time is feeding them: shared-memory traffic for the operand
// fragments, the online softmax's exponentials, and load latency.
//
// Two instantiations, picked by dtype in the C entry point (neither falls
// back to the other):
//
// * bf16, on tensor cores (FlashAttention-2's shape). A block of four warps
//   owns one (b, h) and 64 query rows, 16 per warp. The warp's Q rows stay
//   in registers as mma A fragments for the whole key walk. K and V tiles
//   of 64 keys (and their 64 key biases) arrive through a two-stage
//   cp.async ring in bf16, rows padded by 16 bytes so that ldmatrix reads
//   them without bank conflicts; the next tile loads while the block
//   computes on this one (one barrier per tile). S = Q·Kᵀ runs on
//   mma.sync m16n8k16 (bf16 in, float32 accumulators), then the scale and
//   max(kbias, NEG). The online softmax runs on the float32 accumulators in
//   registers: each row lives in one quad of lanes, so the row max takes
//   two shuffles, and each lane keeps its partial row sum until the end. P
//   is rounded to bf16 and repacked from the S accumulators straight into
//   A fragments for P·V (the C layout of two n-tiles is the A layout of one
//   k-step), with V read by ldmatrix.trans: no shared-memory round trip.
//   mma.sync rather than wgmma with TMA: a 16-row warp tile needs no
//   warpgroup, and the ring, fragments and masks stay in plain CUDA that a
//   first tensor-core version can get right; wgmma is later work.
// * float32, on the CUDA cores (the port's parity mode: tensor-core float32
//   is TF32, about three decimal digits). A block owns 64 query rows and
//   walks 64-key tiles in float32 shared memory; each thread holds a 4x4
//   sub-tile and the probability tile goes through shared memory.
//
// Both follow the plain reference (`_reference_attention`), not the Pallas
// kernel, on masking: the key bias is clamped at NEG = finfo(f32).min/2 and
// the running max starts at NEG, so a query whose keys are all masked
// averages v uniformly over the T keys (the Pallas kernel averages over its
// padded key length instead); no key tile is skipped, since that rule
// needs every key. Keys past T contribute nothing. Rounding points are the
// Pallas kernel's: bf16 operands, float32 sums, the output rounded once.
#include "common.cuh"
#include "tensor_core.cuh"

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


// ---------------------------------------------------------------------------
// bf16 on tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps x 16 query rows = BQ
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t flash_tc_smem_bytes() {
  // the Q tile, two stages of K and V tiles (bf16, rows of D + 8), and two
  // stages of the tile's key biases
  return sizeof(bf16) * (BQ + 4 * BK) * (D + 8) + sizeof(float) * 2 * BK;
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
    flash_attention_tc_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const float* __restrict__ kbias,
                              bf16* __restrict__ out, int H, int Tn,
                              float scale) {
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  constexpr int LD = D + 8;    // bf16 row stride: 16 bytes of padding
  constexpr int CPR = D / 8;   // 16-byte chunks per row
  constexpr int KD = D / 16;   // k-steps of Q·Kᵀ
  constexpr int ND = D / 8;    // n-tiles of the output
  constexpr int NS = BK / 8;   // n-tiles of a score tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + BQ * LD;      // [stage][BK][LD]
  bf16* v_s = k_s + 2 * BK * LD;  // [stage][BK][LD]
  float* kb_s = reinterpret_cast<float*>(v_s + 2 * BK * LD);  // [stage][BK]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t4 = lane & 3;  // fragment column pair
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int i0 = blockIdx.x * BQ;

  const size_t seq = static_cast<size_t>(bh) * Tn * D;
  const bf16* qg = q + seq;
  const bf16* kg = k + seq;
  const bf16* vg = v + seq;
  const float* kbg = kbias + static_cast<size_t>(b) * Tn;

  // rows past T are zero-filled (finite; never stored)
  for (int e = tid; e < BQ * CPR; e += TC_THREADS) {
    const int r = e / CPR, c = e % CPR;
    const int i = i0 + r;
    const bool ok = i < Tn;
    cp_async16(q_s + r * LD + c * 8,
               qg + static_cast<size_t>(ok ? i : 0) * D + c * 8, ok ? 16 : 0);
  }
  auto load_kv = [&](int kt, int st) {
    const int j0 = kt * BK;
    bf16* ks = k_s + st * BK * LD;
    bf16* vs = v_s + st * BK * LD;
    for (int e = tid; e < BK * CPR; e += TC_THREADS) {
      const int r = e / CPR, c = e % CPR;
      const int j = j0 + r;
      const bool ok = j < Tn;
      const size_t gi = static_cast<size_t>(ok ? j : 0) * D + c * 8;
      cp_async16(ks + r * LD + c * 8, kg + gi, ok ? 16 : 0);
      cp_async16(vs + r * LD + c * 8, vg + gi, ok ? 16 : 0);
    }
    if (tid < BK) {
      const int j = j0 + tid;
      const bool ok = j < Tn;
      cp_async4(kb_s + st * BK + tid, kbg + (ok ? j : 0), ok ? 4 : 0);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  unsigned qf[KD][4];
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
    __syncthreads();  // tile kt landed for all; tile kt-1's readers are done
    if (kt + 1 < n_tiles) {
      load_kv(kt + 1, st ^ 1);
      cp_async_commit();
    }
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                (lane >> 4) * 8);
    }
    const bf16* ks = k_s + st * BK * LD;
    const bf16* vs = v_s + st * BK * LD;
    const float* kb = kb_s + st * BK;

    // S = Q Kᵀ: K's rows are the n index, its columns the k index
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned bk[4];
        ldmatrix_x4(bk, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }

    // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t4 + e;
        const float bias = fmaxf(kb[c], NEG);
        s[n][e] = s[n][e] * scale + bias;
        s[n][e + 2] = s[n][e + 2] * scale + bias;
        if (j0 + c < Tn) {
          mx[0] = fmaxf(mx[0], s[n][e]);
          mx[1] = fmaxf(mx[1], s[n][e + 2]);
        }
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
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t4 + (e & 1);
        const float p =
            j0 + c < Tn ? exp2f((s[n][e] - m[e >> 1]) * LOG2E) : 0.f;
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P's accumulators of n-tiles 2kk, 2kk+1 are the A fragment of
    // k-step kk; V's rows are the k index (ldmatrix.trans)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
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
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v,
              const float* kbias, void* out, int B, int H, int Tn,
              float scale, cudaStream_t stream) {
  auto kernel = flash_attention_tc_kernel<D>;
  const size_t smem = flash_tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tn + BQ - 1) / BQ, B * H);
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kbias, static_cast<bf16*>(out), H, Tn,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace espnet_port

// q, k, v, out: (B, H, T, D) of one dtype, contiguous; kbias: (B, T)
// float32 additive key bias. D in {32, 64, 128}; scale multiplies the
// scores (1/sqrt of the head dim before any zero padding to D). bf16 runs
// on tensor cores and needs q, k, v 16-byte aligned; float32 runs on the
// CUDA cores.
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
#undef ESPNET_FLASH_FWD
#define ESPNET_FLASH_TC(DD) \
  return launch_tc<DD>(q, k, v, kbias, out, B, H, T, scale, s)
  if (dtype == kBFloat16 && D == 32) ESPNET_FLASH_TC(32);
  if (dtype == kBFloat16 && D == 64) ESPNET_FLASH_TC(64);
  if (dtype == kBFloat16 && D == 128) ESPNET_FLASH_TC(128);
#undef ESPNET_FLASH_TC
  return kUnsupported;
}
