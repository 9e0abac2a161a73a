"""Positional encodings (port of espnet_tpu/models/embedding.py)."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def sinusoidal_table(maxlen: int, d_model: int) -> np.ndarray:
    """(maxlen, d_model) sin/cos position table."""
    pos = np.arange(maxlen, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(np.log(10000.0) / d_model))
    pe = np.zeros((maxlen, d_model), np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


def add_positional_encoding(x: torch.Tensor, scale: bool = True) -> torch.Tensor:
    """x: (B, T, D) -> x*sqrt(D) + PE[:T] (absolute sinusoidal)."""
    t, d = x.shape[-2], x.shape[-1]
    pe = torch.from_numpy(sinusoidal_table(t, d)).to(x.device, x.dtype)
    if scale:
        x = x * float(np.sqrt(d))
    return x + pe


@functools.lru_cache(maxsize=None)
def rel_positional_table(maxlen: int, d_model: int) -> np.ndarray:
    """(2*maxlen-1, d_model) table for relative positions
    [maxlen-1 ... -(maxlen-1)]: positive first, so row index = (T-1) - rel."""
    pos = np.arange(maxlen, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(np.log(10000.0) / d_model))
    pe_pos = np.zeros((maxlen, d_model), np.float64)
    pe_pos[:, 0::2] = np.sin(pos * div)
    pe_pos[:, 1::2] = np.cos(pos * div)
    pe_neg = np.zeros((maxlen, d_model), np.float64)
    pe_neg[:, 0::2] = np.sin(-pos * div)
    pe_neg[:, 1::2] = np.cos(-pos * div)
    return np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0).astype(np.float32)


def rel_position_encoding(t: int, d_model: int, dtype=torch.float32,
                          device=None) -> torch.Tensor:
    """(1, 2T-1, D) relative position embedding for a length-T sequence."""
    table = rel_positional_table(t, d_model)
    return torch.from_numpy(table).to(device=device, dtype=dtype)[None]
