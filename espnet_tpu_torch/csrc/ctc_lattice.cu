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
// T*B*S out) nor the flops bound it: the latency of T dependent steps does,
// one step being a shuffle, the maxes, two exponentials, a logarithm and a
// few adds, plus, on one warp, the issue of the step's memory instructions.
//
// Two designs, chosen by S (`espnet_ctc_strip_max_states`):
//
// * S <= 256 (U <= 127, the bench's S = 81): one warp per utterance. Lane l
//   holds the contiguous strip of states l*PER .. l*PER+PER-1 in registers
//   (PER = ceil(S / 32), a template constant); states s-1 and s-2 across the
//   strip's lower edge come from lane l-1 by `shfl.sync.up` (beta: s+1,
//   s+2 from lane l+1 by `shfl.sync.down`), NEG_INF at the edge lane, so
//   no shared-memory round trip and no barrier sits on the chain. Each lane
//   stages its own strip of the emissions (gamma: and of the alphas) through
//   a ring of CTC_RING = 17 frames in shared memory with 4-byte `cp.async`
//   (a row of S = 81 floats is only 4-byte aligned): a step refills the slot
//   that the frame before it left with the frame 16 steps ahead, and reads
//   the next frame's slot a step ahead of its use. A lane reads only what it
//   copied, so its own `cp.async.wait_group` orders the ring and no warp or
//   lane waits on another. A step issues its shuffles first, then its
//   memory work (the previous frame's stores, the refill, the read), then
//   the math, so that the memory pipe drains while the math runs. The
//   serial loop stops at the length; the frames past it need no recursion
//   (alpha there is the frozen state, gamma alpha + NEG_INF - emit) and are
//   written without it. States past S hold NEG_INF emissions, as in the
//   Pallas kernel's 128-lane padding, and never reach a state below S above
//   NEG_INF.
// * S > 256, up to 4096: one block of 128 threads per utterance, threads
//   over S, the state double-buffered in shared memory with one barrier per
//   frame and the next frame's emission loaded into registers ahead.
//
// The log-add-exp of three takes two exponentials and one logarithm (the
// largest term is exp(0) = 1), in base 2 with the fast approximations
// `ex2.approx` and `lg2.approx` (the instructions behind __expf and
// __log2f: absolute error about 2^-22 on the logarithm of a sum in [1, 3]),
// where CUDA's accurate expf and logf take a range reduction and a
// polynomial on the chain; chip_smoke.py holds both designs to
// CTC_TOLERANCE of the plain version and the loss to CTC_LOSS_RTOL and
// CTC_GRAD_ATOL of torch.nn.functional.ctc_loss. The (T, B, S) emission
// gather, the log-sum-exp over the vocabulary and the spread of the
// occupancies back onto the vocabulary stay in PyTorch.
#include <type_traits>

#include "common.cuh"

namespace espnet_port {
namespace {

constexpr float CTC_NEG_INF = -1.0e30f;
constexpr int CTC_STRIP_MAX_PER = 8;  // states a lane holds: S <= 256
static_assert(CTC_STRIP_MAX_PER == 8,
              "espnet_ctc_alphas and espnet_ctc_gamma switch on PER 1 .. 8");
constexpr int CTC_RING = 17;          // frames of a lane's ring: 16 ahead
constexpr int CTC_THREADS = 128;      // block route
constexpr int CTC_MAX_PER_THREAD = 32;  // S <= 4096

// ex2.approx and lg2.approx: one MUFU instruction each (exp2f and log2f add
// denormal handling and, for the logarithm, a polynomial, which on a warp's
// serial chain cost more than the step's other work together).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log(e^a + e^b + e^c) + e with the m_safe guard: ms = max(a, b, c,
// NEG_INF). The largest term is exp(0) = 1, so two exponentials and one
// logarithm remain, in base 2. The NEG_INF case needs no select: when
// max(a, b, c) <= NEG_INF, ms = NEG_INF and the logarithm of a sum of 1 to 3
// is lost in its rounding. ms + e is formed while the exponentials run, so
// the chain from the neighbours to the result is two maxes, a subtraction,
// a product, ex2, an addition, lg2 and an fma.
__device__ __forceinline__ float logaddexp3_plus(float a, float b, float c,
                                                 float e) {
  constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
  const float hi = fmaxf(a, b), lo = fminf(a, b);
  const float ms = fmaxf(hi, fmaxf(c, CTC_NEG_INF));
  const float mid = fminf(hi, c);  // lo and mid: the terms other than the max
  const float x = ex2_approx((lo - ms) * kLog2e);
  const float y = ex2_approx((mid - ms) * kLog2e);
  return fmaf(lg2_approx((1.f + x) + y), kLn2, ms + e);
}

// The chain's warp shuffles, as volatile asm so that the compiler keeps
// them in program order with the step's memory work, which a step issues
// after them.
__device__ __forceinline__ float shfl_up(float v, int d) {
  float r;
  asm volatile("shfl.sync.up.b32 %0, %1, %2, 0, -1;\n"
               : "=f"(r)
               : "f"(v), "r"(d));
  return r;
}

__device__ __forceinline__ float shfl_down(float v, int d) {
  float r;
  asm volatile("shfl.sync.down.b32 %0, %1, %2, 31, -1;\n"
               : "=f"(r)
               : "f"(v), "r"(d));
  return r;
}

// A global store as volatile asm, so that it stays where the step puts it:
// right after the step's shuffles, with the step's math left to drain it.
__device__ __forceinline__ void stg(float* p, float v) {
  asm volatile("st.global.f32 [%0], %1;\n" ::"l"(p), "f"(v) : "memory");
}

__device__ __forceinline__ void ring_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This lane's copies of all but the CTC_RING - 2 newest frames have landed.
__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(CTC_RING - 2) : "memory");
}

// One lane's view of a ring of CTC_RING frame slots in shared memory, laid
// out [slot][k][lane] (a warp's reads of one k fall in 32 banks). Lane l
// copies and reads only its own strip, states s0 .. s0+PER-1 of a frame;
// a state past S is zero-filled without a read (its copy names a state
// inside the row and reads 0 bytes of it) and read back as 0 + NEG_INF.
template <int PER>
struct LaneRing {
  unsigned base;  // shared address of (slot 0, k 0) of this lane
  int off[PER];   // the state each copy names, within the row
  int bytes[PER];
  float mask[PER];  // 0 below S, NEG_INF past it

  __device__ __forceinline__ LaneRing(float* ring, int lane, int s0, int S) {
    base = static_cast<unsigned>(__cvta_generic_to_shared(ring + lane));
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      off[k] = min(s0 + k, S - 1);
      bytes[k] = s0 + k < S ? 4 : 0;
      mask[k] = s0 + k < S ? 0.f : CTC_NEG_INF;
    }
  }

  // frame: this utterance's row of the frame (its state 0)
  __device__ __forceinline__ void fill(unsigned slot,
                                       const float* frame) const {
#pragma unroll
    for (int k = 0; k < PER; ++k)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       slot + k * 128),
                   "l"(frame + off[k]), "r"(bytes[k])
                   : "memory");
  }

  __device__ __forceinline__ void load(unsigned slot, float (&v)[PER]) const {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      float x;
      asm volatile("ld.shared.f32 %0, [%1];\n"
                   : "=f"(x)
                   : "r"(slot + k * 128)
                   : "memory");
      v[k] = x + mask[k];
    }
  }

  // shared address of `slot` for this lane, and the slots after and before
  __device__ __forceinline__ unsigned at(int slot) const {
    return base + slot * PER * 128;
  }
  __device__ __forceinline__ unsigned next(unsigned a) const {
    return a == at(CTC_RING - 1) ? base : a + PER * 128;
  }
  __device__ __forceinline__ unsigned prev(unsigned a) const {
    return a == base ? at(CTC_RING - 1) : a - PER * 128;
  }
};

// Masks are added, not selected: `x + m` with m = 0 keeps x, with m =
// NEG_INF gives NEG_INF for any |x| below 1e22 (and at most NEG_INF for
// x <= NEG_INF, which log-add-exp treats as NEG_INF), and a float mask needs
// no predicate register across the loop.
__device__ __forceinline__ float keep_if(bool keep) {
  return keep ? 0.f : CTC_NEG_INF;
}

// emit, alphas: (T, B, S) float32; skip: (B, S) uint8 or bool (transition
// s-2 -> s); lens: (B,) int64; last: (B, S). One warp per utterance.
template <int PER>
__global__ void __launch_bounds__(32)
    ctc_alpha_strip_kernel(const float* __restrict__ emit,
                           const unsigned char* __restrict__ skip,
                           const long long* __restrict__ lens,
                           float* __restrict__ alphas,
                           float* __restrict__ last, int T, int B, int S) {
  __shared__ float ring_smem[CTC_RING * PER * 32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int n = static_cast<int>(min(max(lens[b], 0LL),
                                     static_cast<long long>(T)));
  const size_t row = static_cast<size_t>(B) * S;
  const int s0 = lane * PER;
  float* dst = alphas + static_cast<size_t>(b) * S + s0;
  const LaneRing<PER> ring(ring_smem, lane, s0, S);

  // s-1 and s-2 of the strip's first states come from below it: s-1 of
  // state 0 from lane l-1, s-2 of state 0 from lane l-1 (PER = 1: l-2) and
  // s-2 of state 1 from lane l-1; none below lane 0. `take2` folds that
  // into the skip mask.
  const float below1 = keep_if(lane >= 1);
  float take2[PER], a[PER], ea[PER], eb[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const bool sk =
        s0 + k < S && skip[static_cast<size_t>(b) * S + s0 + k] != 0;
    const bool below = k >= 2 || lane >= (k == 0 && PER == 1 ? 2 : 1);
    take2[k] = keep_if(sk && below);
    a[k] = CTC_NEG_INF;
  }
  if (n > 0) {
    // frames 0 .. CTC_RING-2 into slots 0 .. CTC_RING-2; each step then
    // refills the slot its predecessor's frame left with the frame
    // CTC_RING-1 ahead (frames past the length clamped to the last: their
    // slots are never read) and reads the next frame's slot
    const float* fetch = emit + static_cast<size_t>(b) * S;
    int left = n - 1;  // frames after `fetch`
    for (int f = 0; f < CTC_RING - 1; ++f) {
      ring.fill(ring.at(f), fetch);
      ring_commit();
      if (left > 0) fetch += row;
      --left;
    }
    ring_wait();
    ring.load(ring.at(0), ea);
    unsigned wr = ring.at(CTC_RING - 1), rd = ring.at(1);
    // A step issues its shuffles first, then the memory work of the step
    // (the previous frame's stores, the refill of the slot that frame left
    // with frame t+CTC_RING-1, the read of frame t+1 into the other register
    // set), then the math: the memory pipe drains while the math runs, and
    // the next step's shuffles find it empty. ea and eb alternate, so no
    // register copy waits on a ring read. `first` (std::true_type or
    // std::false_type) marks the loop's first step at compile time.
    auto step = [&](auto first, float(&e)[PER], float(&en)[PER]) {
      float up1 = 0.f, up2 = 0.f;
      if constexpr (!decltype(first)::value) {
        up1 = shfl_up(a[PER - 1], 1);
        up2 = PER >= 2 ? shfl_up(a[PER >= 2 ? PER - 2 : 0], 1)
                       : shfl_up(a[0], 2);
#pragma unroll
        for (int k = 0; k < PER; ++k)
          if (s0 + k < S) stg(dst + k, a[k]);
        dst += row;
      }
      ring.fill(wr, fetch);
      ring_commit();
      if (left > 0) fetch += row;
      --left;
      wr = ring.next(wr);
      ring_wait();
      ring.load(rd, en);
      rd = ring.next(rd);
      float nv[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        if constexpr (decltype(first)::value) {
          nv[k] = s0 + k < 2 ? e[k] : CTC_NEG_INF;
        } else {
          const float p1 = k >= 1 ? a[k >= 1 ? k - 1 : 0] : up1 + below1;
          const float p2 =
              k >= 2 ? a[k >= 2 ? k - 2 : 0] : (k == 1 ? up1 : up2);
          nv[k] = logaddexp3_plus(a[k], p1, p2 + take2[k], e[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) a[k] = nv[k];
    };
    step(std::true_type{}, ea, eb);
    int t = 1;
    for (; t + 1 < n; t += 2) {
      step(std::false_type{}, eb, ea);
      step(std::false_type{}, ea, eb);
    }
    if (t < n) step(std::false_type{}, eb, ea);
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (s0 + k < S) dst[k] = a[k];
    dst += row;
  }
  // frames at or past the length: the frozen state
  for (int t = n; t < T; ++t, dst += row) {
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (s0 + k < S) dst[k] = a[k];
  }
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (s0 + k < S) last[static_cast<size_t>(b) * S + s0 + k] = a[k];
}

// gamma[t] = alpha[t] + beta[t] - emit[t], beta running backwards from the
// terminal set at frame len-1 and NEG_INF at frames >= len. One warp per
// utterance; two rings hold the emission and alpha strips of a frame.
template <int PER>
__global__ void __launch_bounds__(32)
    ctc_gamma_strip_kernel(const float* __restrict__ emit,
                           const unsigned char* __restrict__ skip,
                           const long long* __restrict__ lens,
                           const long long* __restrict__ label_lens,
                           const float* __restrict__ alphas,
                           float* __restrict__ gamma, int T, int B, int S) {
  __shared__ float ring_e_smem[CTC_RING * PER * 32];
  __shared__ float ring_a_smem[CTC_RING * PER * 32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int n = static_cast<int>(min(max(lens[b], 0LL),
                                     static_cast<long long>(T)));
  const long long send = 2 * label_lens[b];
  const bool has_label = label_lens[b] > 0;
  const size_t row = static_cast<size_t>(B) * S;
  const int s0 = lane * PER;
  const size_t utt = static_cast<size_t>(b) * S;
  const LaneRing<PER> ring_e(ring_e_smem, lane, s0, S);
  const LaneRing<PER> ring_a(ring_a_smem, lane, s0, S);

  // s+1 and s+2 of the strip's last states come from above it (lane l+1,
  // PER = 1: s+2 from l+2); none above lane 31
  const float above1 = keep_if(lane <= 30);
  float take2[PER];  // transition s -> s+2, and s+2 exists
  float term[PER], beta[PER], ea[PER], aa[PER], eb[PER], ab[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int s = s0 + k;
    const bool skf = s + 2 < S && skip[utt + s + 2] != 0;
    const bool above =
        k + 2 < PER || lane <= (k + 2 == PER || PER >= 2 ? 30 : 29);
    take2[k] = keep_if(skf && above);
    const bool is_term =
        s == send || (has_label && s == (send - 1 > 0 ? send - 1 : 0));
    term[k] = keep_if(s < S && is_term);
    beta[k] = CTC_NEG_INF;
  }
  // frames at or past the length: beta = NEG_INF, no recursion
#pragma unroll 4
  for (int t = n; t < T; ++t) {
    const size_t at = t * row + utt + s0;
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (s0 + k < S)
        gamma[at + k] = alphas[at + k] + CTC_NEG_INF - emit[at + k];
  }
  if (n == 0) return;
  // frames n-1 down to n-CTC_RING+1 into their slots t mod CTC_RING, then
  // one more a step (frames below 0 clamped to 0: their slots are never
  // read)
  const size_t start = (n - 1) * row + utt;
  const float* fetch_e = emit + start;
  const float* fetch_a = alphas + start;
  int left = n - 1;  // frames before `fetch`
  unsigned wr = ring_e.at((n - 1) % CTC_RING);
  const unsigned gap = ring_a.base - ring_e.base;  // ring_a = ring_e + gap
  auto fill = [&]() {
    ring_e.fill(wr, fetch_e);
    ring_a.fill(wr + gap, fetch_a);
    ring_commit();
    if (left > 0) {
      fetch_e -= row;
      fetch_a -= row;
    }
    --left;
    wr = ring_e.prev(wr);
  };
  unsigned rd = wr;
  for (int j = 0; j < CTC_RING - 1; ++j) fill();
  ring_wait();
  ring_e.load(rd, ea);
  ring_a.load(rd + gap, aa);
  rd = ring_e.prev(rd);
  float* dst = gamma + start + s0;
  float out[PER];
  // steps as in the alpha kernel: shuffles, then the previous frame's
  // stores, the refill and the next frame's read, then the math
  auto step = [&](auto first, float(&e)[PER], float(&al)[PER],
                  float(&en)[PER], float(&aln)[PER]) {
    float dn1 = 0.f, dn2 = 0.f;
    if constexpr (!decltype(first)::value) {
      dn1 = shfl_down(beta[0], 1);
      dn2 = PER >= 2 ? shfl_down(beta[PER >= 2 ? 1 : 0], 1)
                     : shfl_down(beta[0], 2);
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (s0 + k < S) stg(dst + k, out[k]);
      dst -= row;
    }
    fill();
    ring_wait();
    ring_e.load(rd, en);
    ring_a.load(rd + gap, aln);
    rd = ring_e.prev(rd);
    float nv[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if constexpr (decltype(first)::value) {
        nv[k] = term[k] + e[k];
      } else {
        const float q1 =
            k + 1 < PER ? beta[k + 1 < PER ? k + 1 : 0] : dn1 + above1;
        const float q2 = k + 2 < PER ? beta[k + 2 < PER ? k + 2 : 0]
                                     : (k + 2 == PER ? dn1 : dn2);
        nv[k] = logaddexp3_plus(beta[k], q1, q2 + take2[k], e[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      beta[k] = nv[k];
      out[k] = al[k] + beta[k] - e[k];
    }
  };
  step(std::true_type{}, ea, aa, eb, ab);
  int t = n - 2;
  for (; t >= 1; t -= 2) {
    step(std::false_type{}, eb, ab, ea, aa);
    step(std::false_type{}, ea, aa, eb, ab);
  }
  if (t == 0) step(std::false_type{}, eb, ab, ea, aa);
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (s0 + k < S) dst[k] = out[k];
}

// The block route (S > 256): emit, alphas, skip, lens, last as above.
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
        nv = logaddexp3_plus(a0, a1, a2, e[k]);
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
      float nv = logaddexp3_plus(b0, b1, b2, e[k]);
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
int launch_alpha_strip(const float* emit, const unsigned char* skip,
                       const long long* lens, float* alphas, float* last,
                       int T, int B, int S, cudaStream_t stream) {
  ctc_alpha_strip_kernel<PER><<<B, 32, 0, stream>>>(emit, skip, lens, alphas,
                                                    last, T, B, S);
  return static_cast<int>(cudaGetLastError());
}

template <int PER>
int launch_alpha_block(const float* emit, const unsigned char* skip,
                       const long long* lens, float* alphas, float* last,
                       int T, int B, int S, cudaStream_t stream) {
  ctc_alpha_kernel<PER><<<B, CTC_THREADS, 2 * S * sizeof(float), stream>>>(
      emit, skip, lens, alphas, last, T, B, S);
  return static_cast<int>(cudaGetLastError());
}

template <int PER>
int launch_gamma_strip(const float* emit, const unsigned char* skip,
                       const long long* lens, const long long* label_lens,
                       const float* alphas, float* gamma, int T, int B, int S,
                       cudaStream_t stream) {
  ctc_gamma_strip_kernel<PER><<<B, 32, 0, stream>>>(
      emit, skip, lens, label_lens, alphas, gamma, T, B, S);
  return static_cast<int>(cudaGetLastError());
}

template <int PER>
int launch_gamma_block(const float* emit, const unsigned char* skip,
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

// Largest S that the warp-per-utterance route takes; above it, the block
// route runs.
extern "C" int espnet_ctc_strip_max_states() {
  return 32 * espnet_port::CTC_STRIP_MAX_PER;
}

// emit, alphas: (T, B, S) float32; skip: (B, S) uint8 or bool; lens: (B,)
// int64; last: (B, S) float32. 1 <= S <= espnet_ctc_max_states().
extern "C" int espnet_ctc_alphas(const float* emit, const unsigned char* skip,
                                 const long long* lens, float* alphas,
                                 float* last, int T, int B, int S,
                                 void* stream) {
  using namespace espnet_port;
  if (T < 1 || B < 1 || S < 1) return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ESPNET_CTC_ARGS emit, skip, lens, alphas, last, T, B, S, st
  switch ((S + 31) / 32) {  // the strip route: PER = ceil(S / 32)
    case 1: return launch_alpha_strip<1>(ESPNET_CTC_ARGS);
    case 2: return launch_alpha_strip<2>(ESPNET_CTC_ARGS);
    case 3: return launch_alpha_strip<3>(ESPNET_CTC_ARGS);
    case 4: return launch_alpha_strip<4>(ESPNET_CTC_ARGS);
    case 5: return launch_alpha_strip<5>(ESPNET_CTC_ARGS);
    case 6: return launch_alpha_strip<6>(ESPNET_CTC_ARGS);
    case 7: return launch_alpha_strip<7>(ESPNET_CTC_ARGS);
    case 8: return launch_alpha_strip<8>(ESPNET_CTC_ARGS);
    default: break;
  }
  const int per = (S + CTC_THREADS - 1) / CTC_THREADS;  // 3 .. 32
  if (per <= 4) return launch_alpha_block<4>(ESPNET_CTC_ARGS);
  if (per <= 8) return launch_alpha_block<8>(ESPNET_CTC_ARGS);
  if (per <= CTC_MAX_PER_THREAD)
    return launch_alpha_block<CTC_MAX_PER_THREAD>(ESPNET_CTC_ARGS);
#undef ESPNET_CTC_ARGS
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ESPNET_CTC_ARGS \
  emit, skip, lens, label_lens, alphas, gamma, T, B, S, st
  switch ((S + 31) / 32) {
    case 1: return launch_gamma_strip<1>(ESPNET_CTC_ARGS);
    case 2: return launch_gamma_strip<2>(ESPNET_CTC_ARGS);
    case 3: return launch_gamma_strip<3>(ESPNET_CTC_ARGS);
    case 4: return launch_gamma_strip<4>(ESPNET_CTC_ARGS);
    case 5: return launch_gamma_strip<5>(ESPNET_CTC_ARGS);
    case 6: return launch_gamma_strip<6>(ESPNET_CTC_ARGS);
    case 7: return launch_gamma_strip<7>(ESPNET_CTC_ARGS);
    case 8: return launch_gamma_strip<8>(ESPNET_CTC_ARGS);
    default: break;
  }
  const int per = (S + CTC_THREADS - 1) / CTC_THREADS;
  if (per <= 4) return launch_gamma_block<4>(ESPNET_CTC_ARGS);
  if (per <= 8) return launch_gamma_block<8>(ESPNET_CTC_ARGS);
  if (per <= CTC_MAX_PER_THREAD)
    return launch_gamma_block<CTC_MAX_PER_THREAD>(ESPNET_CTC_ARGS);
#undef ESPNET_CTC_ARGS
  return kUnsupported;
}
