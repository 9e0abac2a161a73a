// CTC lattice recursions: the forward alpha pass and the backward beta pass
// fused with the occupancy combine gamma = alpha + beta - emit.
//
// Replaces the Pallas kernels `_alpha_kernel` (`ctc_alphas_pallas`) and
// `_beta_gamma_kernel` (`ctc_gamma_pallas`) in espnet_tpu/ops/pallas_ctc.py.
// Semantics as there: log space with the finite NEG_INF = -1e30 and the
// m_safe log-add-exp; frames at or past an utterance's length freeze alpha
// (and the final alpha is the frozen state); beta is NEG_INF past the length
// and starts from the terminal set {2U, 2U-1 if U > 0} at frame length-1.
//
// What bounds it on an H100: the T recursion is serial, and each step is a
// few dozen flops on an S-wide state, so neither the bytes (T*B*S floats in,
// T*B*S out) nor the flops bound it: the latency of T dependent steps does.
//
// What the design does about it: one block per utterance, threads over S
// (S = 81 at the bench), the state double-buffered in shared memory with one
// barrier per frame; the emission of frame t+1 is loaded into registers
// before the barrier of frame t, so the global load overlaps the step.
// Blocks of different utterances run in parallel. The (T, B, S) emission
// gather, the log-sum-exp over the vocabulary and the spread of the
// occupancies back onto the vocabulary stay in PyTorch.
#include "common.cuh"

namespace espnet_port {
namespace {

constexpr float CTC_NEG_INF = -1.0e30f;
constexpr int CTC_THREADS = 128;
constexpr int CTC_MAX_PER_THREAD = 32;  // S <= 4096

__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, CTC_NEG_INF);
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return m <= CTC_NEG_INF ? CTC_NEG_INF : out;
}

// emit, alphas: (T, B, S) float32; skip: (B, S) uint8 (transition s-2 -> s);
// lens: (B,) int64; last: (B, S).
template <int PER>
__global__ void __launch_bounds__(CTC_THREADS)
    ctc_alpha_kernel(const float* __restrict__ emit,
                     const unsigned char* __restrict__ skip,
                     const long long* __restrict__ lens,
                     float* __restrict__ alphas, float* __restrict__ last,
                     int T, int B, int S) {
  extern __shared__ float st[];  // 2 x S
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long len = lens[b];
  const size_t row = static_cast<size_t>(B) * S;
  const float* eb = emit + static_cast<size_t>(b) * S;
  float* ab = alphas + static_cast<size_t>(b) * S;

  bool sk[PER];
  float e_next[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int s = tid + k * CTC_THREADS;
    sk[k] = s < S && skip[static_cast<size_t>(b) * S + s] != 0;
    e_next[k] = s < S ? eb[s] : CTC_NEG_INF;
    if (s < S) st[s] = CTC_NEG_INF;
  }
  __syncthreads();
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    float e[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      e[k] = e_next[k];
      const int s = tid + k * CTC_THREADS;
      if (t + 1 < T && s < S) e_next[k] = eb[(t + 1) * row + s];
    }
    const float* a = st + cur * S;
    float* an = st + (cur ^ 1) * S;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int s = tid + k * CTC_THREADS;
      if (s >= S) continue;
      const float a0 = a[s];
      float nv;
      if (t == 0) {
        nv = s < 2 ? e[k] : CTC_NEG_INF;
      } else {
        const float a1 = s >= 1 ? a[s - 1] : CTC_NEG_INF;
        const float a2 = (sk[k] && s >= 2) ? a[s - 2] : CTC_NEG_INF;
        nv = logaddexp3(a0, a1, a2) + e[k];
      }
      nv = t < len ? nv : a0;
      an[s] = nv;
      ab[t * row + s] = nv;
    }
    cur ^= 1;
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int s = tid + k * CTC_THREADS;
    if (s < S) last[static_cast<size_t>(b) * S + s] = st[cur * S + s];
  }
}

// gamma[t] = alpha[t] + beta[t] - emit[t], beta running backwards from the
// terminal set at frame len-1 and NEG_INF at frames >= len.
template <int PER>
__global__ void __launch_bounds__(CTC_THREADS)
    ctc_gamma_kernel(const float* __restrict__ emit,
                     const unsigned char* __restrict__ skip,
                     const long long* __restrict__ lens,
                     const long long* __restrict__ label_lens,
                     const float* __restrict__ alphas,
                     float* __restrict__ gamma, int T, int B, int S) {
  extern __shared__ float st[];  // 2 x S
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long len = lens[b];
  const long long send = 2 * label_lens[b];
  const bool has_label = label_lens[b] > 0;
  const size_t row = static_cast<size_t>(B) * S;
  const size_t off = static_cast<size_t>(b) * S;

  bool skf[PER];  // transition s -> s+2
  float term[PER], e_next[PER], a_next[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int s = tid + k * CTC_THREADS;
    skf[k] = s + 2 < S && skip[off + s + 2] != 0;
    const bool is_term =
        s == send || (has_label && s == (send - 1 > 0 ? send - 1 : 0));
    term[k] = is_term ? 0.f : CTC_NEG_INF;
    e_next[k] = s < S ? emit[(T - 1) * row + off + s] : 0.f;
    a_next[k] = s < S ? alphas[(T - 1) * row + off + s] : 0.f;
    if (s < S) st[s] = CTC_NEG_INF;
  }
  __syncthreads();
  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    float e[PER], al[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      e[k] = e_next[k];
      al[k] = a_next[k];
      const int s = tid + k * CTC_THREADS;
      if (t > 0 && s < S) {
        e_next[k] = emit[(t - 1) * row + off + s];
        a_next[k] = alphas[(t - 1) * row + off + s];
      }
    }
    const float* bt = st + cur * S;
    float* bn = st + (cur ^ 1) * S;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int s = tid + k * CTC_THREADS;
      if (s >= S) continue;
      const float b0 = bt[s];
      const float b1 = s + 1 < S ? bt[s + 1] : CTC_NEG_INF;
      const float b2 = skf[k] ? bt[s + 2] : CTC_NEG_INF;
      float nv = logaddexp3(b0, b1, b2) + e[k];
      if (t == len - 1) nv = term[k] + e[k];
      if (t >= len) nv = CTC_NEG_INF;
      bn[s] = nv;
      gamma[t * row + off + s] = al[k] + nv - e[k];
    }
    cur ^= 1;
    __syncthreads();
  }
}

template <int PER>
int launch_alpha(const float* emit, const unsigned char* skip,
                 const long long* lens, float* alphas, float* last, int T,
                 int B, int S, cudaStream_t stream) {
  ctc_alpha_kernel<PER><<<B, CTC_THREADS, 2 * S * sizeof(float), stream>>>(
      emit, skip, lens, alphas, last, T, B, S);
  return static_cast<int>(cudaGetLastError());
}

template <int PER>
int launch_gamma(const float* emit, const unsigned char* skip,
                 const long long* lens, const long long* label_lens,
                 const float* alphas, float* gamma, int T, int B, int S,
                 cudaStream_t stream) {
  ctc_gamma_kernel<PER><<<B, CTC_THREADS, 2 * S * sizeof(float), stream>>>(
      emit, skip, lens, label_lens, alphas, gamma, T, B, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace espnet_port

extern "C" int espnet_ctc_max_states() {
  return espnet_port::CTC_THREADS * espnet_port::CTC_MAX_PER_THREAD;
}

// emit, alphas: (T, B, S) float32; skip: (B, S) uint8; lens: (B,) int64;
// last: (B, S) float32. 1 <= S <= espnet_ctc_max_states().
extern "C" int espnet_ctc_alphas(const float* emit, const unsigned char* skip,
                                 const long long* lens, float* alphas,
                                 float* last, int T, int B, int S,
                                 void* stream) {
  using namespace espnet_port;
  if (T < 1 || B < 1 || S < 1) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (S + CTC_THREADS - 1) / CTC_THREADS;
  if (per <= 1) return launch_alpha<1>(emit, skip, lens, alphas, last, T, B, S, s);
  if (per <= 2) return launch_alpha<2>(emit, skip, lens, alphas, last, T, B, S, s);
  if (per <= 4) return launch_alpha<4>(emit, skip, lens, alphas, last, T, B, S, s);
  if (per <= 8) return launch_alpha<8>(emit, skip, lens, alphas, last, T, B, S, s);
  if (per <= CTC_MAX_PER_THREAD)
    return launch_alpha<CTC_MAX_PER_THREAD>(emit, skip, lens, alphas, last, T,
                                            B, S, s);
  return kUnsupported;
}

// gamma: (T, B, S) float32; label_lens: (B,) int64; other arguments as in
// espnet_ctc_alphas.
extern "C" int espnet_ctc_gamma(const float* emit, const unsigned char* skip,
                                const long long* lens,
                                const long long* label_lens,
                                const float* alphas, float* gamma, int T,
                                int B, int S, void* stream) {
  using namespace espnet_port;
  if (T < 1 || B < 1 || S < 1) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (S + CTC_THREADS - 1) / CTC_THREADS;
  if (per <= 1)
    return launch_gamma<1>(emit, skip, lens, label_lens, alphas, gamma, T, B, S, s);
  if (per <= 2)
    return launch_gamma<2>(emit, skip, lens, label_lens, alphas, gamma, T, B, S, s);
  if (per <= 4)
    return launch_gamma<4>(emit, skip, lens, label_lens, alphas, gamma, T, B, S, s);
  if (per <= 8)
    return launch_gamma<8>(emit, skip, lens, label_lens, alphas, gamma, T, B, S, s);
  if (per <= CTC_MAX_PER_THREAD)
    return launch_gamma<CTC_MAX_PER_THREAD>(emit, skip, lens, label_lens,
                                            alphas, gamma, T, B, S, s);
  return kUnsupported;
}
