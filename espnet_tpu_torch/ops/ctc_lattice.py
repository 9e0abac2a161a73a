"""CTC lattice recursions: CUDA kernels and their plain versions.

Port of `ctc_alphas_pallas` and `ctc_gamma_pallas`
(`espnet_tpu/ops/pallas_ctc.py`); the plain versions are the recursions of
`espnet_tpu/ops/ctc.py` (`_forward_alphas`, `_backward_betas`) written as a
loop over frames, with the Pallas kernels' conventions:

* log space with the finite NEG_INF = -1e30 and an m_safe log-add-exp;
* alpha starts at frame 0 from states 0 and 1; frames at or past an
  utterance's length freeze it, so the last alpha is the state at its final
  frame (an utterance of length 0 keeps NEG_INF everywhere);
* beta starts at frame length-1 from the terminal set {2U, 2U-1 if U > 0}
  and is NEG_INF past the length; gamma = alpha + beta - emit.

`ctc_alphas` and `ctc_gamma` are the entry points: a CPU tensor takes the
plain version, a CUDA tensor a kernel in `csrc/ctc_lattice.cu`; anything
else raises. Two kernel designs, chosen by S in the C library (`design`
asks it):

* S <= `strip_max_states()` (256, U <= 127): one warp per utterance, lane l
  holding the strip of PER = ceil(S / 32) states from l * PER in registers;
  neighbours across a strip's edge come by warp shuffle (NEG_INF at the
  edge lane); each lane stages its strip of the emissions (and, for gamma,
  of the alphas) through a ring of frame slots in shared memory, slot
  t mod R holding frame t (R = `CTC_RING` of the source): each step refills
  the slot that the frame before it left with the frame R - 1 ahead and
  reads the next frame's slot a step ahead of its use; the serial loop
  stops at the utterance's length and the frames past it are written
  without recursion. Its log-add-exp runs in base 2 on the card's fast
  `ex2.approx` / `lg2.approx`, with the maximum's term taken as 1 (within
  chip_smoke.py's CTC_TOLERANCE of the plain version);
* larger S, up to `max_states()` (4096): one block per utterance, the
  S-wide state in shared memory.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from espnet_tpu_torch.ops.cuda_build import check_launch, kernel_library

NEG_INF = -1.0e30


def _logaddexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = m.clamp(min=NEG_INF)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)
                             + torch.exp(c - m_safe))
    return torch.where(m <= NEG_INF, torch.full_like(out, NEG_INF), out)


def _shift_right(x, n):
    return F.pad(x, (n, 0), value=NEG_INF)[:, :x.shape[1]]


def _shift_left(x, n):
    return F.pad(x, (0, n), value=NEG_INF)[:, n:]


def terminal_states(label_lengths, s: int):
    """(B, S) 0 on the final blank 2U and the final label 2U-1 (U > 0),
    NEG_INF elsewhere."""
    send = 2 * label_lengths.long()
    idx = torch.arange(s, device=label_lengths.device)[None, :]
    last = ((idx == send[:, None])
            | ((idx == (send - 1).clamp(min=0)[:, None])
               & (label_lengths > 0)[:, None]))
    return torch.where(last, 0.0, NEG_INF).float()


def ctc_alphas_plain(emit, skip_mask, input_lengths):
    """emit (T, B, S) float32 log emissions; skip_mask (B, S) bool
    (transition s-2 -> s); input_lengths (B,) -> (alphas (T, B, S),
    alpha_last (B, S))."""
    t_max, _, s = emit.shape
    lane = torch.arange(s, device=emit.device)[None, :]
    live = input_lengths.long()[:, None]
    alpha = torch.full_like(emit[0], NEG_INF)
    out = []
    for t in range(t_max):
        e = emit[t]
        if t == 0:
            new = torch.where(lane < 2, e, torch.full_like(e, NEG_INF))
        else:
            a2 = torch.where(skip_mask, _shift_right(alpha, 2),
                             torch.full_like(alpha, NEG_INF))
            new = _logaddexp3(alpha, _shift_right(alpha, 1), a2) + e
        alpha = torch.where(t < live, new, alpha)
        out.append(alpha)
    return torch.stack(out), alpha


def ctc_gamma_plain(emit, skip_mask, input_lengths, label_lengths, alphas):
    """Backward recursion fused with gamma = alpha + beta - emit, (T, B, S)
    (log state posteriors before subtracting log Z)."""
    t_max, _, s = emit.shape
    skip_fwd = F.pad(skip_mask, (0, 2))[:, 2:]
    term = terminal_states(label_lengths, s)
    lens = input_lengths.long()[:, None]
    beta = torch.full_like(emit[0], NEG_INF)
    neg = torch.full_like(beta, NEG_INF)
    gamma = torch.empty_like(emit)
    for t in range(t_max - 1, -1, -1):
        e = emit[t]
        b2 = torch.where(skip_fwd, _shift_left(beta, 2), neg)
        new = _logaddexp3(beta, _shift_left(beta, 1), b2) + e
        new = torch.where(t == lens - 1, term + e, new)
        beta = torch.where(t >= lens, neg, new)
        gamma[t] = alphas[t] + beta - e
    return gamma


@functools.lru_cache(maxsize=None)
def max_states() -> int:
    """Largest S = 2U+1 the kernels take (the C library is asked once)."""
    return int(kernel_library().espnet_ctc_max_states())


@functools.lru_cache(maxsize=None)
def strip_max_states() -> int:
    """Largest S that the warp-per-utterance kernels take; the C library,
    which routes each launch by it, is asked once."""
    return int(kernel_library().espnet_ctc_strip_max_states())


def design(s: int) -> str:
    """The kernel design that the C library runs for S states."""
    if s <= strip_max_states():
        return "warp per utterance"
    return "block per utterance"


def _check_cuda_args(name, emit, skip_mask, *lengths):
    t, b, s = emit.shape
    if emit.dtype != torch.float32 or not emit.is_contiguous():
        raise TypeError(f"{name}: emit must be contiguous float32")
    if tuple(skip_mask.shape) != (b, s):
        raise ValueError(f"{name}: skip_mask has shape "
                         f"{tuple(skip_mask.shape)}, expected {(b, s)}")
    for x in lengths:
        if tuple(x.shape) != (b,):
            raise ValueError(f"{name}: lengths have shape {tuple(x.shape)}")
    for x in (skip_mask, *lengths):
        if x.device != emit.device:
            raise ValueError(f"{name}: argument on {x.device}, emit on "
                             f"{emit.device}")
    if s > max_states():
        raise ValueError(f"{name}: S = {s} states exceed the kernel's "
                         f"{max_states()} (U <= {(max_states() - 1) // 2})")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _as_mask(skip_mask):
    """The (B, S) skip mask as the kernels read it: one byte a state, bool
    or uint8 as given (`.to` and `.contiguous` return their input when it
    already has the dtype and layout, so the lengths need no such care)."""
    if skip_mask.dtype in (torch.bool, torch.uint8):
        return skip_mask.contiguous()
    return skip_mask.to(torch.uint8).contiguous()


def ctc_alphas(emit, skip_mask, input_lengths):
    """CTC alpha recursion: the CUDA kernel on the card, the plain version on
    the CPU. Returns (alphas (T, B, S), alpha_last (B, S)) float32.

    Replaces `ctc_alphas_pallas` (espnet_tpu/ops/pallas_ctc.py).
    `ctc_alphas.launches` counts kernel launches.
    """
    if emit.device.type == "cpu":
        return ctc_alphas_plain(emit, skip_mask, input_lengths)
    if emit.device.type != "cuda":
        raise ValueError(f"ctc_alphas: unsupported device {emit.device}")
    _check_cuda_args("ctc_alphas", emit, skip_mask, input_lengths)
    t, b, s = emit.shape
    skip = _as_mask(skip_mask)
    lens = input_lengths.to(torch.int64).contiguous()
    alphas = torch.empty_like(emit)
    last = torch.empty(b, s, dtype=torch.float32, device=emit.device)
    code = kernel_library().espnet_ctc_alphas(
        emit.data_ptr(), skip.data_ptr(), lens.data_ptr(), alphas.data_ptr(),
        last.data_ptr(), t, b, s, _stream(emit))
    check_launch("ctc_alphas", code)
    ctc_alphas.launches += 1
    return alphas, last


def ctc_gamma(emit, skip_mask, input_lengths, label_lengths, alphas):
    """Beta recursion fused with gamma = alpha + beta - emit: the CUDA kernel
    on the card, the plain version on the CPU. (T, B, S) float32.

    Replaces `ctc_gamma_pallas` (espnet_tpu/ops/pallas_ctc.py).
    `ctc_gamma.launches` counts kernel launches.
    """
    if emit.device.type == "cpu":
        return ctc_gamma_plain(emit, skip_mask, input_lengths, label_lengths,
                               alphas)
    if emit.device.type != "cuda":
        raise ValueError(f"ctc_gamma: unsupported device {emit.device}")
    _check_cuda_args("ctc_gamma", emit, skip_mask, input_lengths,
                     label_lengths)
    if alphas.shape != emit.shape or alphas.dtype != torch.float32:
        raise ValueError("ctc_gamma: alphas must be float32 of emit's shape")
    t, b, s = emit.shape
    skip = _as_mask(skip_mask)
    lens = input_lengths.to(torch.int64).contiguous()
    ulens = label_lengths.to(torch.int64).contiguous()
    alphas = alphas.contiguous()
    gamma = torch.empty_like(emit)
    code = kernel_library().espnet_ctc_gamma(
        emit.data_ptr(), skip.data_ptr(), lens.data_ptr(), ulens.data_ptr(),
        alphas.data_ptr(), gamma.data_ptr(), t, b, s, _stream(emit))
    check_launch("ctc_gamma", code)
    ctc_gamma.launches += 1
    return gamma


ctc_alphas.launches = 0
ctc_gamma.launches = 0
