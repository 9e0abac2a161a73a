"""CTC loss from logits with the analytic gradient (port of
espnet_tpu/ops/ctc.py `ctc_loss_from_logits` and `ctc_loss`).

The forward takes a log-sum-exp over the vocabulary, gathers the (T, B, S)
emissions of the blank-interleaved labels and runs the alpha recursion
(`ops.ctc_lattice.ctc_alphas`: the CUDA kernel on the card); the backward
runs the fused beta/gamma recursion (`ctc_gamma`) and returns

    d logits = softmax * occ_total - occ          (in the logits' dtype)

with occ the state posteriors spread back onto the vocabulary. The port
keeps the forward's alphas for the backward instead of recomputing them
(one alpha launch per step, not two). The spread is a float32 scatter-add
(the JAX package uses a one-hot matmul, in bf16 for bf16 logits).
zero_infinity: an utterance with no feasible alignment gives loss 0 and a
zero gradient. Blank is `blank_id` (0 for the ASR models).

`ctc_loss_from_log_probs` (port of the JAX function of that name) takes
float32 log-probabilities that the caller has already normalised (the
multi-encoder and multi-speaker models fuse or permute them first): the
same lattice pair, and a gradient with no softmax term,

    d log_probs = -occ          (masked past each utterance's length)
"""

from __future__ import annotations

import torch

from espnet_tpu_torch.ops.ctc_lattice import (NEG_INF, ctc_alphas,
                                              ctc_alphas_plain, ctc_gamma,
                                              ctc_gamma_plain)


def extended_labels(labels, blank_id: int = 0):
    """(B, U) -> (B, 2U+1) blank-interleaved: [b, l1, b, l2, ..., b]."""
    b, u = labels.shape
    ext = torch.full((b, 2 * u + 1), blank_id, dtype=labels.dtype,
                     device=labels.device)
    ext[:, 1::2] = labels
    return ext


def transition_mask(ext):
    """(B, S) bool: the skip transition s-2 -> s is allowed (s odd and the
    label differs from the one two states back)."""
    s = ext.shape[1]
    prev2 = torch.nn.functional.pad(ext, (2, 0), value=-1)[:, :s]
    odd = (torch.arange(s, device=ext.device) % 2) == 1
    return (ext != prev2) & odd[None, :]


def final_log_z(alpha_last, label_lengths):
    """log Z from the last alpha: final blank 2U or final label 2U-1."""
    send = 2 * label_lengths.long()
    a_end = alpha_last.gather(1, send[:, None])[:, 0]
    a_lab = alpha_last.gather(1, (send - 1).clamp(min=0)[:, None])[:, 0]
    a_lab = torch.where(label_lengths > 0, a_lab,
                        torch.full_like(a_lab, NEG_INF))
    return torch.logaddexp(a_end, a_lab)


def min_frames(labels, label_lengths):
    """Extra frames needed for repeated labels (each repeat needs a blank)."""
    same = labels[:, 1:] == labels[:, :-1]
    idx = torch.arange(labels.shape[1] - 1, device=labels.device)[None, :]
    valid = idx + 1 < label_lengths[:, None]
    return (same & valid).sum(dim=1)


def _emissions(logits, ext, lse):
    """(T, B, S) float32 emission log-probs without the full log-softmax."""
    b, t, _ = logits.shape
    idx = ext[:, None, :].expand(b, t, ext.shape[1])
    gathered = logits.gather(2, idx).float()
    return (gathered - lse[:, :, None]).transpose(0, 1).contiguous()


def _occupancy_btv(gamma, ext, v: int):
    """(T, B, S) state log-posteriors -> their occupancies spread onto the
    vocabulary, (B, T, V) float32 (a scatter-add over the S states)."""
    occ = torch.exp(gamma.clamp(max=0.0))
    occ = torch.where(torch.isfinite(gamma), occ, torch.zeros_like(occ))
    occ_bts = occ.transpose(0, 1)  # (B, T, S)
    b, t, s = occ_bts.shape
    occ_btv = torch.zeros(b, t, v, dtype=torch.float32, device=gamma.device)
    occ_btv.scatter_add_(2, ext[:, None, :].expand(b, t, s), occ_bts)
    return occ_bts, occ_btv


class _CTCFromLogits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, input_lengths, label_lengths, blank_id,
                use_kernels):
        labels = labels.long()
        input_lengths = input_lengths.long()
        label_lengths = label_lengths.long()
        ext = extended_labels(labels, blank_id)
        skip = transition_mask(ext)
        lse = torch.logsumexp(logits.float(), dim=-1)  # (B, T)
        emit = _emissions(logits, ext, lse)
        ctx.gamma_fn = ctc_gamma if use_kernels else ctc_gamma_plain
        alphas_fn = ctc_alphas if use_kernels else ctc_alphas_plain
        alphas, alpha_last = alphas_fn(emit, skip, input_lengths)
        log_z = final_log_z(alpha_last, label_lengths)
        feasible = input_lengths >= (label_lengths
                                     + min_frames(labels, label_lengths))
        loss = torch.where(feasible & (log_z > NEG_INF / 2), -log_z,
                           torch.zeros_like(log_z))
        ctx.save_for_backward(logits, ext, skip, input_lengths,
                              label_lengths, lse, log_z, feasible, emit,
                              alphas)
        return loss

    @staticmethod
    def backward(ctx, g):
        (logits, ext, skip, input_lengths, label_lengths, lse, log_z,
         feasible, emit, alphas) = ctx.saved_tensors
        gamma = ctx.gamma_fn(emit, skip, input_lengths, label_lengths, alphas)
        b, t, v = logits.shape
        occ_bts, occ_btv = _occupancy_btv(gamma - log_z[None, :, None], ext,
                                          v)
        occ_total = occ_bts.sum(dim=-1)  # (B, T)
        softmax = torch.exp(logits.float() - lse[:, :, None])
        t_mask = (torch.arange(t, device=logits.device)[None, :]
                  < input_lengths[:, None]).float()
        g = g.float()
        scale = torch.where(feasible[:, None], occ_total * t_mask,
                            torch.zeros_like(occ_total)) * g[:, None]
        g_occ = torch.where(feasible, g, torch.zeros_like(g))
        dlogits = softmax * scale[:, :, None] - occ_btv * (
            g_occ[:, None, None] * t_mask[:, :, None])
        return dlogits.to(logits.dtype), None, None, None, None, None


class _CTCFromLogProbs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, labels, input_lengths, label_lengths,
                blank_id, use_kernels):
        labels = labels.long()
        input_lengths = input_lengths.long()
        label_lengths = label_lengths.long()
        ext = extended_labels(labels, blank_id)
        skip = transition_mask(ext)
        b, t, _ = log_probs.shape
        emit = log_probs.float().gather(
            2, ext[:, None, :].expand(b, t, ext.shape[1])
        ).transpose(0, 1).contiguous()  # (T, B, S)
        ctx.gamma_fn = ctc_gamma if use_kernels else ctc_gamma_plain
        alphas_fn = ctc_alphas if use_kernels else ctc_alphas_plain
        alphas, alpha_last = alphas_fn(emit, skip, input_lengths)
        log_z = final_log_z(alpha_last, label_lengths)
        feasible = input_lengths >= (label_lengths
                                     + min_frames(labels, label_lengths))
        loss = torch.where(feasible & (log_z > NEG_INF / 2), -log_z,
                           torch.zeros_like(log_z))
        ctx.v = log_probs.shape[-1]
        ctx.dtype = log_probs.dtype
        ctx.save_for_backward(ext, skip, input_lengths, label_lengths, log_z,
                              feasible, emit, alphas)
        return loss

    @staticmethod
    def backward(ctx, g):
        (ext, skip, input_lengths, label_lengths, log_z, feasible, emit,
         alphas) = ctx.saved_tensors
        gamma = ctx.gamma_fn(emit, skip, input_lengths, label_lengths, alphas)
        _, occ_btv = _occupancy_btv(gamma - log_z[None, :, None], ext, ctx.v)
        t = occ_btv.shape[1]
        t_mask = (torch.arange(t, device=g.device)[None, :]
                  < input_lengths[:, None])
        g = torch.where(feasible, g.float(), torch.zeros_like(g).float())
        grad = -occ_btv * (t_mask.float() * g[:, None])[:, :, None]
        return grad.to(ctx.dtype), None, None, None, None, None


def ctc_loss_from_log_probs(log_probs, labels, input_lengths, label_lengths,
                            blank_id: int = 0, use_kernels: bool = True):
    """Per-utterance CTC negative log-likelihood (B,) from (B, T, V)
    log-softmax outputs, zero_infinity as `ctc_loss_from_logits`; its
    gradient is minus the occupancies, 0 past each input length.
    use_kernels=False takes the lattice's plain versions even on the
    card."""
    return _CTCFromLogProbs.apply(log_probs, labels, input_lengths,
                                  label_lengths, blank_id, use_kernels)


def ctc_loss_from_logits(logits, labels, input_lengths, label_lengths,
                         blank_id: int = 0, use_kernels: bool = True):
    """Per-utterance CTC negative log-likelihood (B,) from (B, T, V) logits
    of any float dtype; the log-softmax is taken in float32. use_kernels=
    False takes the lattice's plain versions even on the card."""
    return _CTCFromLogits.apply(logits, labels, input_lengths, label_lengths,
                                blank_id, use_kernels)


def ctc_loss(logits, labels, input_lengths, label_lengths, blank_id: int = 0,
             reduction: str = "mean_batch", use_kernels: bool = True):
    """CTC loss; "mean_batch" sums over the batch and divides by its size
    (the reference CTC module's normalisation)."""
    nll = ctc_loss_from_logits(logits, labels, input_lengths, label_lengths,
                               blank_id, use_kernels)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean_batch":
        return nll.sum() / nll.shape[0]
    if reduction == "mean":
        return nll.sum() / label_lengths.sum().clamp(min=1)
    raise ValueError(f"unknown reduction {reduction}")
