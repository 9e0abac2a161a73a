"""Length and causal masks (port of espnet_tpu/ops/masks.py).

Boolean masks are True where valid. `attention_bias` turns one into an
additive bias with the finite value finfo(float32).min on masked entries, as
the reference does, so a fully masked softmax row stays finite.
"""

from __future__ import annotations

import torch


def make_valid_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """(B,) int lengths -> (B, maxlen) bool, True where index < length."""
    pos = torch.arange(maxlen, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def make_pad_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """True where padded (the reference's convention)."""
    return ~make_valid_mask(lengths, maxlen)


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """(size, size) lower-triangular causal mask, True = attendable."""
    return torch.ones(size, size, dtype=torch.bool, device=device).tril()


def attention_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Boolean attend-mask -> additive bias (finfo(dtype).min on masked)."""
    neg = torch.finfo(dtype).min
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    return torch.where(mask, zero, torch.full((), neg, dtype=dtype,
                                              device=mask.device))
