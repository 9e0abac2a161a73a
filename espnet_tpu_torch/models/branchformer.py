"""Branchformer and E-Branchformer encoders (port of
espnet_tpu/models/branchformer.py).

Each layer runs two branches on the same input: rel-pos self-attention and
a convolutional gating MLP (cgMLP: a projection up, tanh-approximated GELU
as flax's `nn.gelu`, a spatial gating unit whose gate half goes through a
LayerNorm and a depthwise conv, a projection down). The Branchformer merges
them by concatenation and a projection and ends the encoder in
`after_norm`; the E-Branchformer adds a depthwise conv over the
concatenation before the projection, wraps the branches in a macaron FFN
pair (swish, scale 1/2) and ends every layer in `norm_final`.

The attention goes through `ops.relpos_attention` and the E-Branchformer's
FFNs through `ops.ffn.fused_ffn` (`PositionwiseFeedForward(fused=True)`):
one encode call launches 1 attention and 2 FFN kernels per E-Branchformer
layer. Dropout is flax `nn.Dropout`'s rule (`ops.dropout.Dropout`), not
FastDropout's, except inside the fused FFN, which drops with the kernel's
hash. It is on while the module is training and the caller passes a
`torch.Generator`.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from espnet_tpu_torch.models.attention import RelPositionMultiHeadAttention
from espnet_tpu_torch.models.embedding import rel_position_encoding
from espnet_tpu_torch.models.layers import Dense, LayerNorm
from espnet_tpu_torch.models.subsampling import Conv2dSubsampling
from espnet_tpu_torch.models.transformer import PositionwiseFeedForward
from espnet_tpu_torch.ops.dropout import Dropout
from espnet_tpu_torch.ops.masks import attention_bias, make_valid_mask

VARIANTS = ("branchformer", "e_branchformer")


class DepthwiseConv1d(nn.Conv1d):
    """Depthwise conv over time with 'SAME' padding (odd kernel), on
    (B, T, C) in `dtype`."""

    def __init__(self, channels: int, kernel_size: int, dtype=torch.float32):
        if kernel_size % 2 == 0:
            raise ValueError("kernel_size must be odd ('SAME' padding)")
        super().__init__(channels, channels, kernel_size,
                         padding=kernel_size // 2, groups=channels)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return nn.functional.conv1d(
            x.transpose(1, 2), self.weight.to(dt), self.bias.to(dt),
            padding=self.padding, groups=self.groups).transpose(1, 2)


class ConvolutionalGatingMLP(nn.Module):
    """cgMLP: proj-up -> GELU -> spatial gating unit -> dropout ->
    proj-down."""

    def __init__(self, d_model: int, d_hidden: int, kernel_size: int = 31,
                 dtype=torch.float32, dropout_rate: float = 0.1):
        super().__init__()
        half = d_hidden // 2
        self.channel_proj1 = Dense(d_model, d_hidden, dtype=dtype)
        self.gate_norm = LayerNorm(half, dtype)
        self.gate_conv = DepthwiseConv1d(half, kernel_size, dtype)
        self.channel_proj2 = Dense(half, d_model, dtype=dtype)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, pad_mask, generator=None):
        h = nn.functional.gelu(self.channel_proj1(x), approximate="tanh")
        x_r, x_g = h.chunk(2, dim=-1)
        x_g = self.gate_norm(x_g) * pad_mask[:, :, None].to(x_r.dtype)
        h = self.dropout(x_r * self.gate_conv(x_g), generator)
        return self.channel_proj2(h)


class _Branches(nn.Module):
    """The attention and cgMLP branches of one layer, each dropped out."""

    def __init__(self, d_model, num_heads, cgmlp_hidden, cgmlp_kernel, dtype,
                 dropout_rate):
        super().__init__()
        self.norm_attn = LayerNorm(d_model, dtype)
        self.self_attn = RelPositionMultiHeadAttention(num_heads, d_model,
                                                       dtype)
        self.norm_mlp = LayerNorm(d_model, dtype)
        self.cgmlp = ConvolutionalGatingMLP(d_model, cgmlp_hidden,
                                            cgmlp_kernel, dtype, dropout_rate)
        self.dropout = Dropout(dropout_rate)

    def branches(self, x, pos_emb, bias, pad_mask, generator):
        drop = self.dropout
        h1 = drop(self.self_attn(self.norm_attn(x), pos_emb, bias), generator)
        h2 = drop(self.cgmlp(self.norm_mlp(x), pad_mask, generator),
                  generator)
        return torch.cat([h1, h2], dim=-1)


class BranchformerLayer(_Branches):
    """The two branches merged by concatenation and a projection."""

    def __init__(self, d_model: int, num_heads: int, cgmlp_hidden: int,
                 cgmlp_kernel: int = 31, dtype=torch.float32,
                 dropout_rate: float = 0.1):
        super().__init__(d_model, num_heads, cgmlp_hidden, cgmlp_kernel,
                         dtype, dropout_rate)
        self.merge_proj = Dense(2 * d_model, d_model, dtype=dtype)

    def forward(self, x, pos_emb, bias, pad_mask, generator=None):
        concat = self.branches(x, pos_emb, bias, pad_mask, generator)
        return x + self.dropout(self.merge_proj(concat), generator)


class EBranchformerLayer(_Branches):
    """Macaron FFN pair around the branches, merged through a depthwise
    conv over their concatenation."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 cgmlp_hidden: int, cgmlp_kernel: int = 31,
                 merge_kernel: int = 3, dtype=torch.float32,
                 dropout_rate: float = 0.1):
        super().__init__(d_model, num_heads, cgmlp_hidden, cgmlp_kernel,
                         dtype, dropout_rate)
        self.norm_ff1 = LayerNorm(d_model, dtype)
        self.ff1 = PositionwiseFeedForward(d_model, d_ff, "swish", dtype,
                                           dropout_rate, fused=True)
        self.merge_conv = DepthwiseConv1d(2 * d_model, merge_kernel, dtype)
        self.merge_proj = Dense(2 * d_model, d_model, dtype=dtype)
        self.norm_ff2 = LayerNorm(d_model, dtype)
        self.ff2 = PositionwiseFeedForward(d_model, d_ff, "swish", dtype,
                                           dropout_rate, fused=True)
        self.norm_final = LayerNorm(d_model, dtype)

    def forward(self, x, pos_emb, bias, pad_mask, generator=None):
        drop = self.dropout
        x = x + 0.5 * drop(self.ff1(self.norm_ff1(x), generator), generator)
        concat = self.branches(x, pos_emb, bias, pad_mask, generator)
        merged = self.merge_proj(concat + self.merge_conv(concat))
        x = x + drop(merged, generator)
        x = x + 0.5 * drop(self.ff2(self.norm_ff2(x), generator), generator)
        return self.norm_final(x)


class BranchformerEncoder(nn.Module):
    """Conv2d-subsampled (E-)Branchformer encoder. Returns (hidden
    (B, T', D), output lengths)."""

    def __init__(self, n_feats: int, d_model: int = 256, num_heads: int = 4,
                 d_ff: int = 2048, num_layers: int = 12,
                 cgmlp_hidden: int = 2048, cgmlp_kernel: int = 31,
                 subsampling_factor: int = 4, variant: str = "branchformer",
                 merge_kernel: int = 3, dtype=torch.float32,
                 dropout_rate: float = 0.1):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        self.d_model = d_model
        self.num_layers = num_layers
        self.dtype = dtype
        self.variant = variant
        self.embed = Conv2dSubsampling(d_model, n_feats, subsampling_factor,
                                       dtype=dtype)
        self.dropout = Dropout(dropout_rate)
        for i in range(num_layers):
            if variant == "e_branchformer":
                layer = EBranchformerLayer(
                    d_model, num_heads, d_ff, cgmlp_hidden, cgmlp_kernel,
                    merge_kernel, dtype, dropout_rate)
            else:
                layer = BranchformerLayer(d_model, num_heads, cgmlp_hidden,
                                          cgmlp_kernel, dtype, dropout_rate)
            self.add_module(f"layer{i}", layer)
        if variant == "branchformer":
            self.after_norm = LayerNorm(d_model, dtype)

    def layers(self) -> List[nn.Module]:
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
        if self.variant == "branchformer":
            x = self.after_norm(x)
        return x, olens
