"""RNN-Transducer loss with the analytic gradient (port of
espnet_tpu/ops/transducer.py).

loss = -log P(labels | x), summed over the paths of the (T, U+1) lattice
(the reference delegates to warp-transducer). The forward gathers the blank
and label log-probs, masks the label emissions at u >= label_length to
NEG_INF and runs the alpha recursion (`ops.transducer_lattice.
transducer_alphas`: the CUDA kernel on the card); the backward runs the beta
recursion fused with the occupancies (`transducer_occupancy`) and returns
the JAX `_bwd` gradient on the log-probs,

    d log_probs = -(occ_blank at blank_id + occ_label at each label) * g,

zero elsewhere, without differentiating through the recursion. The port
keeps the forward's alphas for the backward instead of recomputing them.
`transducer_loss` takes the raw joint logits: float32 log-softmax, then this
loss and a reduction (PyTorch's autograd carries the gradient through the
log-softmax).

Lengths are checked on the host (one synchronisation a call): an input
length of 0 would make the JAX package index frame -1, which wraps around to
the last frame; the port raises a ValueError for it, and for lengths past
the padded shapes and label ids outside the vocabulary (the text pad is 0,
the blank id, as the collate pads it).
"""

from __future__ import annotations

import torch

from espnet_tpu_torch.ops.transducer_lattice import (
    NEG_INF, transducer_alphas, transducer_alphas_plain, transducer_occupancy,
    transducer_occupancy_plain)


def lattice_inputs(log_probs, labels, label_lengths, blank_id: int = 0):
    """(B, T, U1, V) log-probs and (B, U) labels -> blank (B, T, U1) and the
    label emissions lab (B, T, U), NEG_INF at u >= label_length (contiguous
    float32)."""
    b, t, u1, v = log_probs.shape
    u = labels.shape[1]
    blank = log_probs[..., blank_id].contiguous()
    idx = labels.long()[:, None, :, None].expand(b, t, u, 1)
    lab = log_probs[:, :, :u, :].gather(3, idx)[..., 0]
    u_mask = (torch.arange(u, device=labels.device)[None, :]
              < label_lengths.long()[:, None])[:, None, :]
    lab = torch.where(u_mask, lab, torch.full_like(lab, NEG_INF))
    return blank, lab.contiguous()


def check_lengths(log_probs, labels, input_lengths, label_lengths) -> None:
    """Raise a ValueError for lengths outside 1 <= input <= T, 0 <= label <=
    U, or a label outside [0, V) (one host synchronisation)."""
    b, t, u1, v = log_probs.shape
    if tuple(labels.shape) != (b, u1 - 1):
        raise ValueError(f"labels have shape {tuple(labels.shape)}, expected "
                         f"{(b, u1 - 1)} for log-probs {tuple(log_probs.shape)}")
    ilen, llen = input_lengths.long(), label_lengths.long()
    bad = torch.stack([((ilen < 1) | (ilen > t)).any(),
                       ((llen < 0) | (llen > u1 - 1)).any(),
                       ((labels < 0) | (labels >= v)).any()]).tolist()
    if bad[0]:
        raise ValueError(
            f"input lengths {ilen.tolist()} must lie in [1, {t}] (an input "
            "length of 0 has no transducer lattice)")
    if bad[1]:
        raise ValueError(f"label lengths {llen.tolist()} must lie in "
                         f"[0, {u1 - 1}]")
    if bad[2]:
        raise ValueError(f"label ids must lie in [0, {v}) (pad with the "
                         "blank id 0)")


class _TransducerLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, labels, input_lengths, label_lengths,
                blank_id, use_kernels):
        check_lengths(log_probs, labels, input_lengths, label_lengths)
        blank, lab = lattice_inputs(log_probs.float(), labels, label_lengths,
                                    blank_id)
        alphas_fn = transducer_alphas if use_kernels else \
            transducer_alphas_plain
        ctx.occupancy_fn = (transducer_occupancy if use_kernels
                            else transducer_occupancy_plain)
        alphas, log_z = alphas_fn(blank, lab, input_lengths, label_lengths)
        ctx.blank_id = blank_id
        ctx.shape, ctx.dtype = log_probs.shape, log_probs.dtype
        ctx.save_for_backward(labels, input_lengths, label_lengths, blank,
                              lab, alphas, log_z)
        return -log_z

    @staticmethod
    def backward(ctx, g):
        (labels, input_lengths, label_lengths, blank, lab, alphas,
         log_z) = ctx.saved_tensors
        occ_blank, occ_label = ctx.occupancy_fn(
            blank, lab, input_lengths, label_lengths, alphas, log_z)
        b, t, u1, v = ctx.shape
        g = g.float()[:, None, None]
        grad = torch.zeros(ctx.shape, dtype=torch.float32, device=blank.device)
        grad[..., ctx.blank_id] = -occ_blank * g
        idx = labels.long()[:, None, :, None].expand(b, t, u1 - 1, 1)
        grad[:, :, :u1 - 1].scatter_add_(3, idx, (-occ_label * g)[..., None])
        return grad.to(ctx.dtype), None, None, None, None, None


def transducer_loss_from_log_probs(log_probs, labels, input_lengths,
                                   label_lengths, blank_id: int = 0,
                                   use_kernels: bool = True):
    """Per-utterance negative log-likelihood (B,) from (B, T, U+1, V)
    log-softmax joint outputs. use_kernels=False takes the lattice's plain
    versions even on the card."""
    return _TransducerLoss.apply(log_probs, labels, input_lengths,
                                 label_lengths, blank_id, use_kernels)


def transducer_loss(logits, labels, input_lengths, label_lengths,
                    blank_id: int = 0, reduction: str = "mean",
                    use_kernels: bool = True):
    """RNN-T loss from raw joint logits (B, T, U+1, V) of any float dtype
    (log-softmax in float32); reduction "mean" over the batch, "sum" or
    "none"."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = transducer_loss_from_log_probs(log_probs, labels, input_lengths,
                                         label_lengths, blank_id, use_kernels)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return nll.mean()
    raise ValueError(f"unknown reduction {reduction}")
