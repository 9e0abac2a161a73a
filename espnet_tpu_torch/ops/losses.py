"""Label-smoothing loss and token accuracy (port of espnet_tpu/ops/losses.py).

KL(smoothed one-hot || softmax(logits)) masked to the valid positions,
including the entropy term of the target as the reference's KLDivLoss does,
divided by the batch size (normalize_length=False, the reference default)
or by the number of valid tokens.
"""

from __future__ import annotations

import math

import torch


def label_smoothing_loss(logits, targets, valid_mask, smoothing: float = 0.1,
                         normalize_length: bool = False):
    """logits (B, U, V); targets (B, U) int; valid_mask (B, U) bool."""
    v = logits.shape[-1]
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    confidence = 1.0 - smoothing
    low = smoothing / (v - 1)
    # sum_v p log p of the smoothed target, the same for every position
    plogp = ((confidence * math.log(confidence) if confidence > 0 else 0.0)
             + ((v - 1) * low * math.log(low) if low > 0 else 0.0))
    target_lp = log_probs.gather(-1, targets.long()[..., None])[..., 0]
    ce = -(confidence - low) * target_lp - low * log_probs.sum(dim=-1)
    kl = (plogp + ce) * valid_mask.float()
    denom = (valid_mask.sum().clamp(min=1) if normalize_length
             else max(logits.shape[0], 1))
    return kl.sum() / denom


def token_accuracy(logits, targets, valid_mask):
    """Fraction of valid positions where argmax == target."""
    correct = (logits.argmax(dim=-1) == targets) & valid_mask
    return correct.sum() / valid_mask.sum().clamp(min=1)
