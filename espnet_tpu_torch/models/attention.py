"""Multi-head attention (port of espnet_tpu/models/attention.py).

Masks arrive as additive float32 biases; softmax runs in float32 whatever
the compute dtype. `RelPositionMultiHeadAttention` goes through
`ops.relpos_attention.relpos_attention` at every sequence length: on the
card that is the CUDA kernel (the JAX package's `t >= 256` gate is a TPU
padding tuning), on the CPU its plain version. `MultiHeadAttention` sends
full self-attention (no cache, Tq == Tk, a key-padding bias) through
`ops.flash_attention.flash_attention` at every length likewise (the JAX
package's `T >= 512` gate is a TPU tuning); other calls take the plain
`scaled_dot_attention`. Both ask the JAX modules' shape gate first
(`relpos_attention.kernel_takes`, a head dim that is a multiple of 8): a
head dim it refuses goes to the plain version, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from espnet_tpu_torch.models.layers import Dense
from espnet_tpu_torch.ops import flash_attention as _flash
from espnet_tpu_torch.ops import relpos_attention as _relpos


def scaled_dot_attention(q, k, v, bias: Optional[torch.Tensor]):
    """q, k, v: (B, H, T, Dk); bias broadcastable to (B, H, Tq, Tk)."""
    scores = (q @ k.transpose(-1, -2)).float() / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.float()
    weights = torch.softmax(scores, dim=-1)
    return weights.to(v.dtype) @ v


class MultiHeadAttention(nn.Module):
    """Standard MHA with an optional incremental KV cache. Returns (B, Tq, D)."""

    def __init__(self, num_heads: int, d_model: int, dtype=torch.float32):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must be a multiple of num_heads")
        self.num_heads = num_heads
        self.d_model = d_model
        self.q_proj = Dense(d_model, d_model, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.out_proj = Dense(d_model, d_model, dtype=dtype)
        # False: the plain version even on the card (chip_smoke.py compares)
        self.use_kernel = True

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        h = self.num_heads
        return x.reshape(b, t, h, self.d_model // h).transpose(1, 2)

    def forward(self, query, key, value, bias=None, cache=None,
                cache_index: Optional[int] = None):
        """With `cache` ({"k", "v"}: (B, H, Tmax, Dk)) and a one-step query,
        writes this step's k/v at `cache_index`, attends over positions
        <= cache_index, and returns (out, new_cache); else returns out."""
        q = self._split(self.q_proj(query))
        k = self._split(self.k_proj(key))
        v = self._split(self.v_proj(value))
        new_cache = None
        if cache is not None:
            i = cache_index
            ck, cv = cache["k"].clone(), cache["v"].clone()
            ck[:, :, i:i + 1] = k
            cv[:, :, i:i + 1] = v
            k, v = ck, cv
            new_cache = {"k": ck, "v": cv}
            tmax = k.shape[2]
            valid = torch.arange(tmax, device=q.device)[None, None, None, :] <= i
            step_bias = torch.where(
                valid, 0.0, torch.finfo(torch.float32).min).float()
            bias = step_bias if bias is None else bias + step_bias
        if (cache is None and q.shape[2] == k.shape[2]
                and _flash.key_padding_only(bias)
                and _relpos.kernel_takes(q.shape[3])):
            attn = (_flash.flash_attention if self.use_kernel
                    else _flash.flash_attention_plain)
            x = attn(q.contiguous(), k.contiguous(), v.contiguous(), bias)
        else:
            x = scaled_dot_attention(q, k, v, bias)
        b, h, t, dk = x.shape
        out = self.out_proj(x.transpose(1, 2).reshape(b, t, h * dk))
        if cache is not None:
            return out, new_cache
        return out


class RelPositionMultiHeadAttention(nn.Module):
    """MHA with Transformer-XL relative positions (the conformer's)."""

    def __init__(self, num_heads: int, d_model: int, dtype=torch.float32):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must be a multiple of num_heads")
        self.num_heads = num_heads
        self.d_model = d_model
        dk = d_model // num_heads
        self.q_proj = Dense(d_model, d_model, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.out_proj = Dense(d_model, d_model, dtype=dtype)
        self.pos_proj = Dense(d_model, d_model, bias=False, dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, dk))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, dk))
        # False: the plain version even on the card (chip_smoke.py compares)
        self.use_kernel = True

    def forward(self, x, pos_emb, bias=None):
        """x: (B, T, D); pos_emb: (1, 2T-1, D); bias: (B, 1, 1, T) or None."""
        b, t, d = x.shape
        h, dk = self.num_heads, d // self.num_heads

        def heads(y):
            return y.reshape(b, t, h, dk).transpose(1, 2).contiguous()

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        p = self.pos_proj(pos_emb).reshape(-1, h, dk).transpose(0, 1).contiguous()
        if self.use_kernel and _relpos.kernel_takes(dk):
            attn = _relpos.relpos_attention
        else:
            attn = _relpos.relpos_attention_plain
        out = attn(q, k, v, p, self.pos_bias_u, self.pos_bias_v, bias)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))
