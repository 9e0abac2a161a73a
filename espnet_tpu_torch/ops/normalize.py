"""Utterance mean/variance normalisation (port of
espnet_tpu/ops/normalize.py `utterance_mvn`)."""

from __future__ import annotations

from typing import Optional

import torch

from espnet_tpu_torch.ops.masks import make_valid_mask


def utterance_mvn(x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                  norm_means: bool = True, norm_vars: bool = False,
                  eps: float = 1.0e-20) -> torch.Tensor:
    """(B, T, D) -> per-utterance normalised over valid frames, padding 0."""
    if lengths is None:
        n = torch.full((x.shape[0], 1, 1), x.shape[1], dtype=x.dtype,
                       device=x.device)
        mask = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)[:, :, None]
    else:
        mask = make_valid_mask(lengths, x.shape[1]).to(x.dtype)[:, :, None]
        n = lengths.to(x.dtype)[:, None, None]
    mean = (x * mask).sum(dim=1, keepdim=True) / n
    out = (x - mean) * mask if norm_means else x * mask
    if norm_vars:
        var = (((x - mean) * mask) ** 2).sum(dim=1, keepdim=True) / n
        out = out / torch.sqrt(var.clamp(min=eps))
    return out
