"""Conformer encoder (port of espnet_tpu/models/conformer.py).

Macaron FFN pair scaled by 1/2, rel-pos self-attention, a depthwise conv
module with GLU, LayerNorm and swish, pre-norm everywhere and a LayerNorm at
the end of every block. Only the unrolled layer layout (`layer{i}`) is
ported; the JAX package's `scan_layers` stacked layout comes later.

Both macaron FFNs go through `ops.prenorm_ffn.prenorm_ffn` (the CUDA kernels
on the card, with their hash dropout: two int32 seeds per call drawn from the
caller's generator) and the attention through `ops.relpos_attention`: one
encode call launches 2 FFN kernels and 1 attention kernel per block, and a
backward as many backward kernel pairs. Shapes the JAX package's gates
send to its plain versions (a d_model or d_ff that is not a multiple of
128, a head dim that is not a multiple of 8) go to the plain versions here
too, decided from the shapes before any launch. The conv module is
plain PyTorch: its fused kernels are opt-in in the JAX package and not on
this path.

Dropout (rate `dropout_rate`) is where the JAX package has it: after the
scaled subsampling output, inside and after each macaron FFN (in the
kernel), after the attention and after the conv module. It is on while the
module is training and the caller passes a `torch.Generator`.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from espnet_tpu_torch.models.attention import RelPositionMultiHeadAttention
from espnet_tpu_torch.models.embedding import rel_position_encoding
from espnet_tpu_torch.models.layers import Dense, LayerNorm
from espnet_tpu_torch.models.subsampling import Conv2dSubsampling
from espnet_tpu_torch.models.transformer import (PositionwiseFeedForward,
                                                  prenorm_residual_ffn)
from espnet_tpu_torch.ops.dropout import FastDropout
from espnet_tpu_torch.ops.masks import attention_bias, make_valid_mask


class ConvolutionModule(nn.Module):
    """Pointwise (2D) -> GLU -> depthwise -> LayerNorm -> swish -> pointwise;
    the residual is added by the caller."""

    def __init__(self, d_model: int, kernel_size: int = 31,
                 dtype=torch.float32):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError("kernel_size must be odd ('SAME' padding)")
        self.dtype = dtype
        self.pointwise_conv1 = Dense(d_model, 2 * d_model, dtype=dtype)
        self.depthwise_conv = nn.Conv1d(d_model, d_model, kernel_size,
                                        padding=kernel_size // 2,
                                        groups=d_model)
        self.norm = LayerNorm(d_model, dtype)
        self.pointwise_conv2 = Dense(d_model, d_model, dtype=dtype)

    def forward(self, x, pad_mask):
        """x: (B, T, D); pad_mask: (B, T) True = valid."""
        a, g = self.pointwise_conv1(x).chunk(2, dim=-1)
        h = a * torch.sigmoid(g)
        # zero the padding so the depthwise conv cannot leak across it
        h = h * pad_mask[:, :, None].to(h.dtype)
        conv = self.depthwise_conv
        h = nn.functional.conv1d(
            h.transpose(1, 2), conv.weight.to(self.dtype),
            conv.bias.to(self.dtype), padding=conv.padding,
            groups=conv.groups).transpose(1, 2)
        h = self.norm(h)
        return self.pointwise_conv2(h * torch.sigmoid(h))


class ConformerBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 kernel_size: int = 31, dtype=torch.float32,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.dtype = dtype
        self.dropout = FastDropout(dropout_rate)
        self.norm_ff1 = LayerNorm(d_model, dtype)
        self.ff1 = PositionwiseFeedForward(d_model, d_ff, "swish", dtype)
        self.norm_attn = LayerNorm(d_model, dtype)
        self.self_attn = RelPositionMultiHeadAttention(num_heads, d_model,
                                                       dtype)
        self.norm_conv = LayerNorm(d_model, dtype)
        self.conv = ConvolutionModule(d_model, kernel_size, dtype)
        self.norm_ff2 = LayerNorm(d_model, dtype)
        self.ff2 = PositionwiseFeedForward(d_model, d_ff, "swish", dtype)
        self.norm_final = LayerNorm(d_model, dtype)

    def _macaron(self, x, norm: LayerNorm, ff: PositionwiseFeedForward,
                 generator):
        """x + 0.5 * drop(FFN_drop(LN(x)))."""
        rate = (self.dropout.rate
                if self.training and generator is not None else 0.0)
        return prenorm_residual_ffn(x, norm, ff, 0.5, rate, generator)

    def forward(self, x, pos_emb, bias, pad_mask, generator=None):
        drop = self.dropout
        x = self._macaron(x, self.norm_ff1, self.ff1, generator)
        x = x + drop(self.self_attn(self.norm_attn(x), pos_emb, bias),
                     generator)
        x = x + drop(self.conv(self.norm_conv(x), pad_mask), generator)
        x = self._macaron(x, self.norm_ff2, self.ff2, generator)
        return self.norm_final(x)


class ConformerEncoder(nn.Module):
    """Conv2d-subsampled conformer encoder. Returns (hidden (B, T', D),
    output lengths)."""

    def __init__(self, n_feats: int, d_model: int = 256, num_heads: int = 4,
                 d_ff: int = 2048, num_layers: int = 12,
                 kernel_size: int = 31, subsampling_factor: int = 4,
                 dtype=torch.float32, dropout_rate: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.num_layers = num_layers
        self.dtype = dtype
        self.embed = Conv2dSubsampling(d_model, n_feats, subsampling_factor,
                                       dtype=dtype)
        self.dropout = FastDropout(dropout_rate)
        for i in range(num_layers):
            self.add_module(f"layer{i}", ConformerBlock(
                d_model, num_heads, d_ff, kernel_size, dtype, dropout_rate))

    def layers(self) -> List[ConformerBlock]:
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def forward(self, feats, lengths, generator=None):
        x, olens = self.embed(feats, lengths)
        x = self.dropout(x * self.d_model ** 0.5, generator)
        t = x.shape[1]
        pos_emb = rel_position_encoding(t, self.d_model, self.dtype, x.device)
        pad_mask = make_valid_mask(olens, t)
        bias = attention_bias(pad_mask[:, None, None, :])
        for layer in self.layers():
            x = layer(x, pos_emb, bias, pad_mask, generator)
        return x, olens
