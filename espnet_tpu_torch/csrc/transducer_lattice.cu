// RNN-Transducer lattice recursions: the forward alpha pass with log Z, and
// the backward beta pass fused with the occupancies that the loss's
// gradient scatters onto the vocabulary.
//
// Replaces no Pallas kernel: the JAX package runs this lattice as a
// `lax.scan` over frames with a nested `lax.scan` over labels
// (espnet_tpu/ops/transducer.py `_alpha_scan`, `_beta_scan` and the
// occupancy arithmetic of `_bwd`), which on the card would be T * U
// dependent steps of several launches each. It is the port's counterpart of
// warp-transducer, the function the reference delegates to. Semantics as
// there: log space with the finite NEG_INF = -1e30 and the m_safe
// log-add-exp (a maximum at or below NEG_INF gives NEG_INF exactly); alpha
// rows at or past an utterance's input length repeat the row before; log Z
// = alpha[ilen-1, llen] + blank[ilen-1, llen]; beta has its terminal blank
// at (ilen-1, llen) and is NEG_INF past ilen; the occupancies clip their
// exponent to [NEG_INF, 0] and are 0 past ilen. `lab` comes masked to
// NEG_INF at u >= llen (the loss masks it, as `_loss_impl` does).
//
// What bounds it on an H100: node (t, u) needs (t-1, u) and (t, u-1), so
// the nodes of one anti-diagonal t + u = n are independent and the
// lattice is ilen + U dependent waves. Each wave is one log-add-exp (two
// expf, one logf) and a barrier: a few hundred nanoseconds, against bytes
// (B*T*(2U+1) floats in, as many out: about 1.2 MB at B 8, T 468, U 40)
// that the card moves in under a microsecond. The latency of the wave
// chain bounds it; a batch's utterances run in parallel, one block each.
//
// Design (simple first): one block per utterance, one thread per label
// position u (so U + 1 <= 1024); on wave n thread u computes node
// (n - u, u), keeps its own column's last value in a register (the
// neighbour along t) and reads the neighbour along u from the previous
// wave's diagonal, double-buffered in shared memory with one __syncthreads
// a wave. A thread loads the next wave's emissions into registers before
// the current wave's arithmetic, so their latency overlaps the wave. The
// occupancy pass reads alpha from global memory and writes occ_blank and
// occ_label as beta is produced (beta itself is never stored). expf and
// logf are CUDA's accurate float32 functions, as PyTorch's on the card.
#include "common.cuh"

namespace espnet_port {
namespace {

constexpr float RNNT_NEG_INF = -1.0e30f;
constexpr int RNNT_MAX_LABELS = 1024;  // U + 1: one thread each

// The JAX package's `_logaddexp`.
__device__ __forceinline__ float rnnt_logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  const float ms = fmaxf(m, RNNT_NEG_INF);
  const float out = ms + logf(expf(a - ms) + expf(b - ms));
  return m <= RNNT_NEG_INF ? RNNT_NEG_INF : out;
}

// exp(clip(x, NEG_INF, 0))
__device__ __forceinline__ float rnnt_occ(float x) {
  return expf(fminf(fmaxf(x, RNNT_NEG_INF), 0.0f));
}

// blank, alphas: (B, T, U1); lab: (B, T, U1 - 1); log_z: (B,).
__global__ void rnnt_alpha_kernel(const float* __restrict__ blank,
                                  const float* __restrict__ lab,
                                  const long long* __restrict__ ilens,
                                  const long long* __restrict__ llens,
                                  float* __restrict__ alphas,
                                  float* __restrict__ log_z, int T, int U1) {
  extern __shared__ float diag[];  // [2][U1]: waves n - 1 and n
  const int b = blockIdx.x;
  const int u = threadIdx.x;
  const int U = U1 - 1;
  const int ilen = static_cast<int>(ilens[b]);
  const int llen = static_cast<int>(llens[b]);
  const float* bl = blank + static_cast<size_t>(b) * T * U1;
  const float* lb = lab + static_cast<size_t>(b) * T * U;
  float* al = alphas + static_cast<size_t>(b) * T * U1;
  const bool col = u < U1;
  if (col) {
    diag[u] = RNNT_NEG_INF;
    diag[U1 + u] = RNNT_NEG_INF;
  }
  __syncthreads();
  float own = RNNT_NEG_INF;  // alpha[t - 1, u]
  // the emissions of this thread's node on the coming wave, t = n - u:
  // blank[t - 1, u] (the move along t) and lab[t, u - 1] (along u)
  auto load = [&](int t, float& eb, float& el) {
    eb = (t >= 1 && t - 1 < T) ? bl[(t - 1) * U1 + u] : RNNT_NEG_INF;
    el = (u >= 1 && t >= 0 && t < T) ? lb[t * U + u - 1] : RNNT_NEG_INF;
  };
  float eb = RNNT_NEG_INF, el = RNNT_NEG_INF;
  if (col) load(-u, eb, el);
  const int waves = ilen + U;
  for (int n = 0; n < waves; ++n) {
    const float* prev = diag + ((n + 1) & 1) * U1;
    float* cur = diag + (n & 1) * U1;
    const int t = n - u;
    float nb = RNNT_NEG_INF, nl = RNNT_NEG_INF;
    if (col) load(t + 1, nb, nl);  // the next wave's, ahead of the math
    if (col && t >= 0 && t < ilen) {
      const float a =
          t == 0 ? (u == 0 ? 0.0f : RNNT_NEG_INF) : own + eb;
      const float left = u >= 1 ? prev[u - 1] : RNNT_NEG_INF;
      const float v = rnnt_logaddexp(a, left + el);
      own = v;
      cur[u] = v;
      al[t * U1 + u] = v;
    }
    eb = nb;
    el = nl;
    __syncthreads();
  }
  if (!col) return;
  // rows at or past the input length repeat row ilen - 1
  for (int t = ilen; t < T; ++t) al[t * U1 + u] = own;
  if (u == llen) log_z[b] = own + bl[(ilen - 1) * U1 + llen];
}

// occ_blank: (B, T, U1); occ_label: (B, T, U1 - 1); other arguments as in
// rnnt_alpha_kernel.
__global__ void rnnt_occupancy_kernel(
    const float* __restrict__ blank, const float* __restrict__ lab,
    const long long* __restrict__ ilens, const long long* __restrict__ llens,
    const float* __restrict__ alphas, const float* __restrict__ log_z,
    float* __restrict__ occ_blank, float* __restrict__ occ_label, int T,
    int U1) {
  extern __shared__ float diag[];  // [2][U1]: waves n + 1 and n
  const int b = blockIdx.x;
  const int u = threadIdx.x;
  const int U = U1 - 1;
  const int ilen = static_cast<int>(ilens[b]);
  const int llen = static_cast<int>(llens[b]);
  const size_t off = static_cast<size_t>(b) * T * U1;
  const float* bl = blank + off;
  const float* al = alphas + off;
  const float* lb = lab + static_cast<size_t>(b) * T * U;
  float* ob = occ_blank + off;
  float* ol = occ_label + static_cast<size_t>(b) * T * U;
  const float lz = log_z[b];
  const bool col = u < U1;
  if (col) {
    diag[u] = RNNT_NEG_INF;
    diag[U1 + u] = RNNT_NEG_INF;
  }
  __syncthreads();
  float own = RNNT_NEG_INF;  // beta[t + 1, u]
  // this thread's node inputs on a wave, t = n - u: blank, lab, alpha
  auto load = [&](int t, float& eb, float& el, float& ea) {
    const bool in = t >= 0 && t < ilen;
    eb = in ? bl[t * U1 + u] : RNNT_NEG_INF;
    el = (in && u < U) ? lb[t * U + u] : RNNT_NEG_INF;
    ea = in ? al[t * U1 + u] : RNNT_NEG_INF;
  };
  float eb = RNNT_NEG_INF, el = RNNT_NEG_INF, ea = RNNT_NEG_INF;
  const int waves = ilen + U;
  if (col) load(waves - 1 - u, eb, el, ea);
  for (int n = waves - 1; n >= 0; --n) {
    const float* next = diag + ((n + 1) & 1) * U1;
    float* cur = diag + (n & 1) * U1;
    const int t = n - u;
    float nb = RNNT_NEG_INF, nl = RNNT_NEG_INF, na = RNNT_NEG_INF;
    if (col) load(t - 1, nb, nl, na);
    if (col && t >= 0 && t < ilen) {
      const bool last = t == ilen - 1;
      const float term = last ? (u == llen ? eb : RNNT_NEG_INF) : eb + own;
      const float right = u < U ? next[u + 1] : RNNT_NEG_INF;  // beta[t, u+1]
      const float beta = rnnt_logaddexp(term, el + right);
      const float blank_to = (last && u == llen) ? 0.0f : own;
      ob[t * U1 + u] = rnnt_occ(ea + eb + blank_to - lz);
      if (u < U) ol[t * U + u] = rnnt_occ(ea + el + right - lz);
      own = beta;
      cur[u] = beta;
    }
    eb = nb;
    el = nl;
    ea = na;
    __syncthreads();
  }
  if (!col) return;
  for (int t = ilen; t < T; ++t) {
    ob[t * U1 + u] = 0.0f;
    if (u < U) ol[t * U + u] = 0.0f;
  }
}

int rnnt_threads(int U1) { return (U1 + 31) / 32 * 32; }

}  // namespace
}  // namespace espnet_port

// Largest U + 1 the kernels take (one thread a label position).
extern "C" int espnet_transducer_max_labels() {
  return espnet_port::RNNT_MAX_LABELS;
}

// blank, alphas: (B, T, U1) float32; lab: (B, T, U1 - 1) float32; ilens,
// llens: (B,) int64 with 1 <= ilens <= T and 0 <= llens <= U1 - 1 (the
// wrapper's caller checks); log_z: (B,) float32.
extern "C" int espnet_transducer_alphas(const float* blank, const float* lab,
                                        const long long* ilens,
                                        const long long* llens, float* alphas,
                                        float* log_z, int T, int B, int U1,
                                        void* stream) {
  using namespace espnet_port;
  if (T < 1 || B < 1 || U1 < 1 || U1 > RNNT_MAX_LABELS) return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * U1 * sizeof(float);
  rnnt_alpha_kernel<<<B, rnnt_threads(U1), smem, st>>>(
      blank, lab, ilens, llens, alphas, log_z, T, U1);
  return static_cast<int>(cudaGetLastError());
}

// occ_blank: (B, T, U1) float32; occ_label: (B, T, U1 - 1) float32; alphas
// and log_z from espnet_transducer_alphas; other arguments as there.
extern "C" int espnet_transducer_occupancy(
    const float* blank, const float* lab, const long long* ilens,
    const long long* llens, const float* alphas, const float* log_z,
    float* occ_blank, float* occ_label, int T, int B, int U1, void* stream) {
  using namespace espnet_port;
  if (T < 1 || B < 1 || U1 < 1 || U1 > RNNT_MAX_LABELS) return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * U1 * sizeof(float);
  rnnt_occupancy_kernel<<<B, rnnt_threads(U1), smem, st>>>(
      blank, lab, ilens, llens, alphas, log_z, occ_blank, occ_label, T, U1);
  return static_cast<int>(cudaGetLastError());
}
