"""Feature normalisation: global MVN (from collected stats) and utterance
MVN (port of espnet_tpu/ops/normalize.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from espnet_tpu_torch.ops.masks import make_valid_mask


def global_mvn_params(stats: dict, norm_means: bool = True,
                      norm_vars: bool = True, eps: float = 1.0e-20
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """{count, sum, sum_square} -> (mean, inv_std) float32 arrays of shape
    (D,)."""
    count = np.asarray(stats["count"], np.float64)
    mean = np.asarray(stats["sum"], np.float64) / count
    var = np.asarray(stats["sum_square"], np.float64) / count - mean * mean
    std = np.sqrt(np.maximum(var, eps))
    if not norm_means:
        mean = np.zeros_like(mean)
    if not norm_vars:
        std = np.ones_like(std)
    return mean.astype(np.float32), (1.0 / std).astype(np.float32)


def global_mvn(x: torch.Tensor, lengths: Optional[torch.Tensor],
               mean: torch.Tensor, inv_std: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (x - mean) * inv_std, padding re-zeroed."""
    out = (x - mean) * inv_std
    if lengths is not None:
        mask = make_valid_mask(lengths, x.shape[1])[:, :, None]
        out = out * mask.to(out.dtype)
    return out


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
