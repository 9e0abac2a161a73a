"""Longformer encoder: conformer blocks with sliding-window local
self-attention (port of espnet_tpu/models/longformer.py).

`LocalSelfAttention` is blocked banded attention: the sequence is cut into
blocks of w (= the window) frames; block i's queries attend to the keys of
blocks i-1, i and i+1 under the exact band |p - q| <= w. The phantom blocks
beyond either end hold no valid key. Masked scores take float32's most
negative finite value, as in JAX (a fully masked row, a padded query,
then averages its stripe and is zeroed by the pad mask on the output).
The rounding points are the JAX module's: the scores and the softmax in
float32 (`preferred_element_type`), `attn @ v` promoted to float32, cast
back to the compute dtype by `out_proj`.

`LongformerLayer` is the JAX layer: macaron FFNs through the port's
`PositionwiseFeedForward(fused=True)` (the `fused_ffn` kernels on the card,
with their hash dropout) with `norm_ff1` and `norm_ff2` in front of them,
the local attention, the plain conv module with LayerNorm, flax-rule
dropout (`ops.dropout.Dropout`) on each residual branch and `norm_final`
closing the layer: one encode launches 2 `fused_ffn` per layer, a train
step as many backward calls. The encoder embeds with `Conv2dSubsampling`,
scales by sqrt(d) and adds the sinusoidal encoding through
`add_positional_encoding`, which scales by sqrt(d) once more (the JAX
encoder's formula), then drops out.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from espnet_tpu_torch.models.conformer import ConvolutionModule
from espnet_tpu_torch.models.embedding import add_positional_encoding
from espnet_tpu_torch.models.layers import Dense, LayerNorm
from espnet_tpu_torch.models.subsampling import Conv2dSubsampling
from espnet_tpu_torch.models.transformer import PositionwiseFeedForward
from espnet_tpu_torch.ops.dropout import Dropout
from espnet_tpu_torch.ops.masks import make_valid_mask

NEG = torch.finfo(torch.float32).min


def _neighbors(y: torch.Tensor) -> torch.Tensor:
    """(B, H, nc, w, ...) -> (B, H, nc, 3w, ...): blocks i-1, i, i+1 of
    each block, zero phantoms past either end."""
    pad = [0, 0] * (y.dim() - 3) + [1, 1]
    y = nn.functional.pad(y, pad)
    return torch.cat([y[:, :, :-2], y[:, :, 1:-1], y[:, :, 2:]], dim=3)


def band_mask(w: int, device=None) -> torch.Tensor:
    """(w, 3w) bool: query i of a block (global c*w + i) sees stripe key j
    (global c*w + j - w) iff |i - (j - w)| <= w."""
    qi = torch.arange(w, device=device)[:, None]
    kj = torch.arange(3 * w, device=device)[None, :] - w
    return (qi - kj).abs() <= w


class LocalSelfAttention(nn.Module):
    """Banded self-attention: token p attends to q iff |p - q| <= window;
    the projections are `MultiHeadAttention`'s (q/k/v/out_proj)."""

    def __init__(self, num_heads: int, d_model: int, window: int,
                 dtype=torch.float32):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must be a multiple of num_heads")
        self.num_heads = num_heads
        self.d_model = d_model
        self.window = window
        self.q_proj = Dense(d_model, d_model, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.out_proj = Dense(d_model, d_model, dtype=dtype)

    def forward(self, x, pad_mask):
        """x: (B, T, D); pad_mask: (B, T) True = valid."""
        b, t, _ = x.shape
        h, w = self.num_heads, self.window
        dk = self.d_model // h
        nc = -(-t // w)
        pad_t = nc * w - t

        def chunk(y):  # (B, T, D) -> (B, H, nc, w, dk)
            y = nn.functional.pad(y, (0, 0, 0, pad_t))
            return y.reshape(b, nc, w, h, dk).permute(0, 3, 1, 2, 4)

        qc = chunk(self.q_proj(x))
        kn = _neighbors(chunk(self.k_proj(x)))
        vn = _neighbors(chunk(self.v_proj(x)))
        valid = nn.functional.pad(pad_mask.to(torch.uint8), (0, pad_t))
        kvalid = _neighbors(valid.reshape(b, 1, nc, w))[:, 0] > 0  # (B, nc, 3w)
        scores = torch.matmul(qc.float(), kn.float().transpose(-1, -2)) \
            / (dk ** 0.5)
        mask = band_mask(w, x.device)[None, None, None] \
            & kvalid[:, None, :, None, :]
        scores = torch.where(mask, scores, NEG)
        attn = torch.softmax(scores, dim=-1)
        out = torch.matmul(attn, vn.float())  # promoted to float32
        out = out.permute(0, 2, 3, 1, 4).reshape(b, nc * w, h * dk)[:, :t]
        out = self.out_proj(out)
        return out * pad_mask[:, :, None].to(out.dtype)


class LongformerLayer(nn.Module):
    """Conformer-style block with local attention."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, window: int,
                 kernel_size: int = 31, dropout_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.dropout = Dropout(dropout_rate)
        self.norm_ff1 = LayerNorm(d_model, dtype)
        self.ff1 = PositionwiseFeedForward(d_model, d_ff, "swish", dtype,
                                           dropout_rate, fused=True)
        self.norm_attn = LayerNorm(d_model, dtype)
        self.self_attn = LocalSelfAttention(num_heads, d_model, window,
                                            dtype)
        self.norm_conv = LayerNorm(d_model, dtype)
        self.conv = ConvolutionModule(d_model, kernel_size, dtype)
        self.norm_ff2 = LayerNorm(d_model, dtype)
        self.ff2 = PositionwiseFeedForward(d_model, d_ff, "swish", dtype,
                                           dropout_rate, fused=True)
        self.norm_final = LayerNorm(d_model, dtype)

    def forward(self, x, pad_mask, generator=None):
        drop = self.dropout
        h = self.ff1(self.norm_ff1(x), generator)
        x = x + 0.5 * drop(h, generator)
        h = self.self_attn(self.norm_attn(x), pad_mask)
        x = x + drop(h, generator)
        h = self.conv(self.norm_conv(x), pad_mask)
        x = x + drop(h, generator)
        h = self.ff2(self.norm_ff2(x), generator)
        x = x + 0.5 * drop(h, generator)
        return self.norm_final(x)


class LongformerEncoder(nn.Module):
    """Conv2d-subsampled encoder of `LongformerLayer`s. Returns (hidden
    (B, T', D), output lengths)."""

    def __init__(self, n_feats: int, d_model: int = 256, num_heads: int = 4,
                 d_ff: int = 2048, num_layers: int = 12, window: int = 100,
                 kernel_size: int = 31, dropout_rate: float = 0.1,
                 subsampling_factor: int = 4, dtype=torch.float32):
        super().__init__()
        self.d_model = d_model
        self.num_layers = num_layers
        self.embed = Conv2dSubsampling(d_model, n_feats, subsampling_factor,
                                       dtype=dtype)
        self.dropout = Dropout(dropout_rate)
        for i in range(num_layers):
            self.add_module(f"layer{i}", LongformerLayer(
                d_model, num_heads, d_ff, window, kernel_size, dropout_rate,
                dtype))

    def layers(self) -> List[LongformerLayer]:
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def forward(self, feats, lengths, generator=None):
        x, olens = self.embed(feats, lengths)
        x = add_positional_encoding(x * float(self.d_model ** 0.5))
        x = self.dropout(x, generator)
        pad_mask = make_valid_mask(olens, x.shape[1])
        for layer in self.layers():
            x = layer(x, pad_mask, generator)
        return x, olens
