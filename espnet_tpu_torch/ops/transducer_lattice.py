"""RNN-Transducer lattice recursions: CUDA kernels and their plain versions.

The (T, U+1) log-space lattice of `espnet_tpu/ops/transducer.py`
(`_alpha_scan`, `_beta_scan` and the occupancies of the analytic `_bwd`),
which the JAX package runs as a `lax.scan` over frames with a nested scan
over labels and which has no Pallas kernel: on the card a transcription of
that double scan is T * U dependent steps of several launches each. These
kernels are the port's counterpart of warp-transducer, the function the
reference delegates to. Conventions, all the JAX package's:

* log space with the finite NEG_INF = -1e30 and the m_safe log-add-exp of
  `_logaddexp` (a maximum at or below NEG_INF gives NEG_INF exactly);
* alpha[0, 0] = 0; alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
  alpha[t, u-1] + lab[t, u-1]); rows at or past an utterance's input length
  repeat the row before (frozen), and log Z = alpha[ilen-1, llen] +
  blank[ilen-1, llen];
* beta has its terminal blank at (ilen-1, llen) and is NEG_INF past ilen;
* occ_blank[t, u] = exp(clip(alpha + blank + beta[t+1, u] - log Z, NEG_INF,
  0)) (the terminal node takes 0 in place of beta), occ_label[t, u] =
  exp(clip(alpha + lab + beta[t, u+1] - log Z, ...)), both 0 at t >= ilen.

`lab` is the label emissions already masked to NEG_INF at u >= llen (the
loss does that, as `_loss_impl` does). The plain versions walk the lattice
by anti-diagonals (wave n holds the nodes t + u = n), one vectorised step a
wave; each node is computed with the same operations in the same order as
the JAX row scans, so the traversal order changes no number.

`transducer_alphas` and `transducer_occupancy` are the entry points: a CPU
tensor takes the plain version, a CUDA tensor a kernel in
`csrc/transducer_lattice.cu` (one block per utterance, one thread per label
position u, so U + 1 <= `max_labels()`: `kernel_takes` says so before any
launch, and a larger lattice raises on the card); anything else raises.
"""

from __future__ import annotations

import functools

import torch

from espnet_tpu_torch.ops.cuda_build import check_launch, kernel_library

NEG_INF = -1.0e30


def logaddexp(a, b):
    """The JAX package's `_logaddexp`: NEG_INF when both are at or below it."""
    m = torch.maximum(a, b)
    m_safe = m.clamp(min=NEG_INF)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))
    return torch.where(m <= NEG_INF, torch.full_like(out, NEG_INF), out)


def _wave_index(t_max: int, u1: int, device):
    """(t (N, U1), valid (N, U1)) of the node on wave n in column u, for the
    N = T + U waves: t = n - u, valid where 0 <= t < T."""
    n = torch.arange(t_max + u1 - 1, device=device)[:, None]
    u = torch.arange(u1, device=device)[None, :]
    t = n - u
    return t, (t >= 0) & (t < t_max)


def skew(x, fill: float):
    """(B, T, U1) -> (B, N, U1) with wave n, column u holding x[:, n-u, u]
    (`fill` off the lattice)."""
    b, t_max, u1 = x.shape
    t, valid = _wave_index(t_max, u1, x.device)
    u = torch.arange(u1, device=x.device)[None, :].expand_as(t)
    out = x[:, t.clamp(0, t_max - 1), u]
    return torch.where(valid[None], out, torch.full_like(out, fill))


def unskew(y, t_max: int):
    """The inverse of `skew`: (B, N, U1) -> (B, T, U1)."""
    u1 = y.shape[2]
    t = torch.arange(t_max, device=y.device)[:, None]
    u = torch.arange(u1, device=y.device)[None, :]
    return y[:, t + u, u.expand(t_max, u1)]


def _lab_shift(lab):
    """(B, T, U) -> (B, T, U1): column u holds lab[..., u-1], NEG_INF at 0
    (the JAX `lab_shift`)."""
    return torch.nn.functional.pad(lab, (1, 0), value=NEG_INF)


def _lab_pad(lab):
    """(B, T, U) -> (B, T, U1): NEG_INF in column U (the JAX `lab_pad`)."""
    return torch.nn.functional.pad(lab, (0, 1), value=NEG_INF)


def _shift_right(x):
    return torch.nn.functional.pad(x, (1, 0), value=NEG_INF)[:, :-1]


def _shift_left(x):
    return torch.nn.functional.pad(x, (0, 1), value=NEG_INF)[:, 1:]


def transducer_alphas_plain(blank, lab, input_lengths, label_lengths):
    """blank (B, T, U1), lab (B, T, U) float32 (lab masked past each label
    length), lengths (B,) -> (alphas (B, T, U1), log Z (B,))."""
    b, t_max, u1 = blank.shape
    t_idx, valid = _wave_index(t_max, u1, blank.device)
    blank_s = skew(blank, NEG_INF)            # blank[t, u] on wave t + u
    lsh_s = skew(_lab_shift(lab), NEG_INF)    # lab[t, u-1] on wave t + u
    ilen = input_lengths.long()[:, None]
    col = torch.arange(u1, device=blank.device)[None, :]
    prev = torch.full((b, u1), NEG_INF, dtype=blank.dtype,
                      device=blank.device)
    waves = []
    for n in range(t_max + u1 - 1):
        t = t_idx[n][None, :]
        if n == 0:
            own = torch.full_like(prev, NEG_INF)
        else:  # alpha[t-1, u] + blank[t-1, u]: (t-1, u) was on wave n-1
            own = prev + blank_s[:, n - 1]
        first = torch.where(col == 0, 0.0, NEG_INF).to(prev.dtype)
        a = torch.where(t == 0, first.expand_as(own), own)
        new = logaddexp(a, _shift_right(prev) + lsh_s[:, n])
        # rows at or past the input length repeat the row before
        new = torch.where((t >= ilen) & (t >= 1), prev, new)
        prev = torch.where(valid[n][None, :], new,
                           torch.full_like(new, NEG_INF))
        waves.append(prev)
    alphas = unskew(torch.stack(waves, 1), t_max)
    bi = torch.arange(b, device=blank.device)
    last = input_lengths.long() - 1
    llen = label_lengths.long()
    log_z = alphas[bi, last, llen] + blank[bi, last, llen]
    return alphas, log_z


def transducer_betas_plain(blank, lab, input_lengths, label_lengths):
    """beta (B, T, U1): log P(complete | at (t, u)), including (t, u)'s
    emission; the JAX `_beta_scan` (transposed to batch-major)."""
    b, t_max, u1 = blank.shape
    t_idx, valid = _wave_index(t_max, u1, blank.device)
    blank_s = skew(blank, NEG_INF)
    lab_s = skew(_lab_pad(lab), NEG_INF)
    ilen = input_lengths.long()[:, None]
    col = torch.arange(u1, device=blank.device)[None, :]
    at_end_u = col == label_lengths.long()[:, None]
    nxt = torch.full((b, u1), NEG_INF, dtype=blank.dtype, device=blank.device)
    waves = [None] * (t_max + u1 - 1)
    for n in range(t_max + u1 - 2, -1, -1):
        t = t_idx[n][None, :]
        bl = blank_s[:, n]
        is_last = t == ilen - 1
        # beta[t+1, u] was on wave n+1 in column u, beta[t, u+1] in u+1
        term = torch.where(is_last & at_end_u, bl, torch.where(
            is_last, torch.full_like(bl, NEG_INF), bl + nxt))
        new = logaddexp(term, lab_s[:, n] + _shift_left(nxt))
        new = torch.where(t >= ilen, torch.full_like(new, NEG_INF), new)
        nxt = torch.where(valid[n][None, :], new,
                          torch.full_like(new, NEG_INF))
        waves[n] = nxt
    return unskew(torch.stack(waves, 1), t_max)


def occupancies(blank, lab, input_lengths, label_lengths, alphas, betas,
                log_z):
    """(occ_blank (B, T, U1), occ_label (B, T, U)) from alpha and beta: the
    JAX `_bwd`'s posteriors, in its order of operations."""
    b, t_max, u1 = blank.shape
    dev = blank.device
    t_idx = torch.arange(t_max, device=dev)[None, :, None]
    valid_t = (t_idx < input_lengths.long()[:, None, None]).to(blank.dtype)
    beta_next = torch.cat([betas[:, 1:], torch.full_like(betas[:, :1],
                                                         NEG_INF)], 1)
    is_term = ((t_idx == (input_lengths.long() - 1)[:, None, None])
               & (torch.arange(u1, device=dev)[None, None, :]
                  == label_lengths.long()[:, None, None]))
    blank_to = torch.where(is_term, torch.zeros_like(beta_next), beta_next)
    lz = log_z[:, None, None]
    occ_blank = torch.exp((alphas + blank + blank_to - lz).clamp(
        NEG_INF, 0.0)) * valid_t
    occ_label = torch.exp((alphas[:, :, :-1] + lab + betas[:, :, 1:] - lz)
                          .clamp(NEG_INF, 0.0)) * valid_t
    return occ_blank, occ_label


def transducer_occupancy_plain(blank, lab, input_lengths, label_lengths,
                               alphas, log_z):
    """The beta recursion, then the occupancies of every node."""
    betas = transducer_betas_plain(blank, lab, input_lengths, label_lengths)
    return occupancies(blank, lab, input_lengths, label_lengths, alphas,
                       betas, log_z)


@functools.lru_cache(maxsize=None)
def max_labels() -> int:
    """Largest U + 1 the kernels take: one thread a label position in one
    block (the C library is asked once)."""
    return int(kernel_library().espnet_transducer_max_labels())


def kernel_takes(u1: int) -> bool:
    """Whether the kernels take a lattice U + 1 = `u1` wide. Asked before any
    launch: a wider lattice raises on the card, never runs plain."""
    return 1 <= u1 <= max_labels()


def _check_cuda_args(name, blank, lab, input_lengths, label_lengths,
                     *more):
    b, t, u1 = blank.shape
    for x in (blank, lab, *more):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise TypeError(f"{name}: lattice tensors must be contiguous "
                            "float32")
    if tuple(lab.shape) != (b, t, u1 - 1):
        raise ValueError(f"{name}: lab has shape {tuple(lab.shape)}, "
                         f"expected {(b, t, u1 - 1)}")
    for x in (input_lengths, label_lengths):
        if tuple(x.shape) != (b,):
            raise ValueError(f"{name}: lengths have shape {tuple(x.shape)}")
    for x in (lab, input_lengths, label_lengths, *more):
        if x.device != blank.device:
            raise ValueError(f"{name}: argument on {x.device}, blank on "
                             f"{blank.device}")
    if not kernel_takes(u1):
        raise ValueError(f"{name}: U + 1 = {u1} label positions exceed the "
                         f"kernel's {max_labels()} (one thread each)")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def transducer_alphas(blank, lab, input_lengths, label_lengths):
    """Alpha recursion and log Z: the CUDA kernel on the card, the plain
    version on the CPU. Returns (alphas (B, T, U1), log Z (B,)) float32.

    Replaces the `lax.scan` pair of `_alpha_scan`
    (espnet_tpu/ops/transducer.py); no Pallas kernel. Lengths must satisfy
    1 <= input_lengths <= T and 0 <= label_lengths <= U (the loss checks).
    `transducer_alphas.launches` counts kernel launches.
    """
    if blank.device.type == "cpu":
        return transducer_alphas_plain(blank, lab, input_lengths,
                                       label_lengths)
    if blank.device.type != "cuda":
        raise ValueError(f"transducer_alphas: unsupported device "
                         f"{blank.device}")
    _check_cuda_args("transducer_alphas", blank, lab, input_lengths,
                     label_lengths)
    b, t, u1 = blank.shape
    ilen = input_lengths.to(torch.int64).contiguous()
    llen = label_lengths.to(torch.int64).contiguous()
    alphas = torch.empty_like(blank)
    log_z = torch.empty(b, dtype=torch.float32, device=blank.device)
    code = kernel_library().espnet_transducer_alphas(
        blank.data_ptr(), lab.data_ptr(), ilen.data_ptr(), llen.data_ptr(),
        alphas.data_ptr(), log_z.data_ptr(), t, b, u1, _stream(blank))
    check_launch("transducer_alphas", code)
    transducer_alphas.launches += 1
    return alphas, log_z


def transducer_occupancy(blank, lab, input_lengths, label_lengths, alphas,
                         log_z):
    """Beta recursion fused with the occupancies: the CUDA kernel on the
    card, the plain version on the CPU. Returns (occ_blank (B, T, U1),
    occ_label (B, T, U)) float32.

    Replaces `_beta_scan` and the occupancy arithmetic of `_bwd`
    (espnet_tpu/ops/transducer.py); no Pallas kernel.
    `transducer_occupancy.launches` counts kernel launches.
    """
    if blank.device.type == "cpu":
        return transducer_occupancy_plain(blank, lab, input_lengths,
                                          label_lengths, alphas, log_z)
    if blank.device.type != "cuda":
        raise ValueError(f"transducer_occupancy: unsupported device "
                         f"{blank.device}")
    _check_cuda_args("transducer_occupancy", blank, lab, input_lengths,
                     label_lengths, alphas, log_z)
    if alphas.shape != blank.shape or tuple(log_z.shape) != blank.shape[:1]:
        raise ValueError("transducer_occupancy: alphas must have blank's "
                         "shape and log Z one value an utterance")
    b, t, u1 = blank.shape
    ilen = input_lengths.to(torch.int64).contiguous()
    llen = label_lengths.to(torch.int64).contiguous()
    occ_blank = torch.empty_like(blank)
    occ_label = torch.empty_like(lab)
    code = kernel_library().espnet_transducer_occupancy(
        blank.data_ptr(), lab.data_ptr(), ilen.data_ptr(), llen.data_ptr(),
        alphas.data_ptr(), log_z.data_ptr(), occ_blank.data_ptr(),
        occ_label.data_ptr(), t, b, u1, _stream(blank))
    check_launch("transducer_occupancy", code)
    transducer_occupancy.launches += 1
    return occ_blank, occ_label


transducer_alphas.launches = 0
transducer_occupancy.launches = 0
