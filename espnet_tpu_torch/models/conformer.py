"""Conformer encoder (port of espnet_tpu/models/conformer.py).

Macaron FFN pair scaled by 1/2, rel-pos self-attention, a depthwise conv
module with GLU, LayerNorm and swish, pre-norm everywhere and a LayerNorm at
the end of every block. The module is always unrolled (`layer{i}`): the JAX
package's `scan_layers` changes only the checkpoint layout (one stacked
`block` of (L, ...) leaves), which `convert.py` unstacks and restacks, not
the math. `capture_layers` (InterCTC) also returns the outputs of the given
1-based layers, the raw block outputs as in JAX; `remat` recomputes each
block's activations in the backward pass (`models.remat`, which replays the
block's dropout seeds).

Both macaron FFNs go through `ops.prenorm_ffn.prenorm_ffn` (the CUDA kernels
on the card, with their hash dropout: two int32 seeds per call drawn from the
caller's generator) and the attention through `ops.relpos_attention`: one
encode call launches 2 FFN kernels and 1 attention kernel per block, and a
backward as many backward kernel pairs. Shapes the JAX package's gates
send to its plain versions (a d_model or d_ff that is not a multiple of
128, a head dim that is not a multiple of 8) go to the plain versions here
too, decided from the shapes before any launch.

The conv sub-block (pre-LN, conv module, dropout, residual) has the JAX
block's three routes (`conv_route`): plain PyTorch (the default, as in
JAX); `fused_conv_split`, the head and tail kernels of `ops.conv_glu` around
a depthwise conv left to PyTorch (one launch of each per block and encode;
auto on the card when ESPNET_TPU_CONV_SPLIT=1, as JAX's auto is on the TPU;
its gate is d_model a multiple of 128); and `fused_conv`, the whole
sub-block as one kernel of `ops.conv_module` (no gate; it wins when both are
set). The parameters are the plain route's in every route, so a JAX
checkpoint loads the same way.

Dropout (rate `dropout_rate`) is where the JAX package has it: after the
scaled subsampling output, inside and after each macaron FFN (in the
kernel), after the attention and after the conv module. It is on while the
module is training and the caller passes a `torch.Generator`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
from torch import nn

from espnet_tpu_torch.models.attention import RelPositionMultiHeadAttention
from espnet_tpu_torch.models.embedding import rel_position_encoding
from espnet_tpu_torch.models import remat as _remat
from espnet_tpu_torch.models.layers import Dense, LayerNorm
from espnet_tpu_torch.models.subsampling import Conv2dSubsampling
from espnet_tpu_torch.models.transformer import (PositionwiseFeedForward,
                                                  prenorm_residual_ffn)
from espnet_tpu_torch.ops import conv_glu as _glu
from espnet_tpu_torch.ops import conv_module as _cm
from espnet_tpu_torch.ops.dropout import FastDropout, draw_seeds
from espnet_tpu_torch.ops.ffn_common import kernel_takes
from espnet_tpu_torch.ops.masks import attention_bias, make_valid_mask


class ConvolutionModule(nn.Module):
    """Pointwise (2D) -> GLU -> depthwise -> LayerNorm -> swish -> pointwise;
    the residual is added by the caller. `use_kernel` is the one switch of
    the conv sub-block's kernel route, whichever the block selects: False
    sends the split and whole-module routes to their plain versions."""

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
        # False: the plain versions even on the card (chip_smoke.py compares)
        self.use_kernel = True

    def weights(self):
        """(W1 (D, 2D), W2 (D, D), taps (k, D)) in the compute dtype, laid
        out as the kernels take them (the JAX kernels' layouts)."""
        dt = self.dtype
        return (self.pointwise_conv1.weight.t().to(dt).contiguous(),
                self.pointwise_conv2.weight.t().to(dt).contiguous(),
                self.depthwise_conv.weight[:, 0, :].t().to(dt).contiguous())

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


def conv_route(fused_conv: Optional[bool], fused_conv_split: Optional[bool],
               x: torch.Tensor, d_model: int) -> str:
    """The JAX ConformerBlock's choice for its conv sub-block
    (espnet_tpu/models/conformer.py): "split" when `fused_conv_split` (None
    = auto: on the card with ESPNET_TPU_CONV_SPLIT=1) is set, `fused_conv`
    is not, and d_model passes the gate (`_ffn_tileable(x, d, d, 256)` less
    its row count); else "module" when `fused_conv` is set; else "plain"."""
    whole = bool(fused_conv)
    split = fused_conv_split
    if split is None:
        split = (x.device.type == "cuda"
                 and os.environ.get("ESPNET_TPU_CONV_SPLIT", "0") == "1")
    if split and not whole and kernel_takes(d_model, d_model):
        return "split"
    return "module" if whole else "plain"


def conv_split_residual(x, norm: LayerNorm, conv: ConvolutionModule,
                        pad_mask, rate: float, generator):
    """x + drop(conv(LN(x))) as the head kernel, the depthwise conv in the
    compute dtype (PyTorch's, as JAX leaves it to XLA) and the tail kernel
    with its hash dropout (one int32 seed when `rate` > 0)."""
    dt = conv.dtype
    seed = draw_seeds(generator, 1)[0] if rate > 0.0 else None
    head, tail = ((_glu.prenorm_glu, _glu.postnorm_proj) if conv.use_kernel
                  else (_glu.prenorm_glu_plain, _glu.postnorm_proj_plain))
    w1, w2, _ = conv.weights()
    xd = x.to(dt).contiguous()
    g = head(xd, norm.weight, norm.bias, w1, conv.pointwise_conv1.bias)
    g = g * pad_mask[:, :, None].to(dt)
    dwc = conv.depthwise_conv
    g = nn.functional.conv1d(g.transpose(1, 2), dwc.weight.to(dt),
                             padding=dwc.padding, groups=dwc.groups)
    g = g.transpose(1, 2) + dwc.bias.to(dt)
    return tail(g.contiguous(), xd, conv.norm.weight, conv.norm.bias, w2,
                conv.pointwise_conv2.bias, seed, rate)


def conv_module_residual(x, norm: LayerNorm, conv: ConvolutionModule,
                         pad_mask, rate: float, generator):
    """x + drop(conv(LN(x))) as one whole-module kernel (one int32 seed
    when `rate` > 0)."""
    seed = draw_seeds(generator, 1)[0] if rate > 0.0 else None
    fn = _cm.conv_module if conv.use_kernel else _cm.conv_module_plain
    w1, w2, taps = conv.weights()
    dwc = conv.depthwise_conv
    return fn(x.to(conv.dtype).contiguous(), pad_mask.contiguous(),
              norm.weight, norm.bias, w1, conv.pointwise_conv1.bias, taps,
              dwc.bias, conv.norm.weight, conv.norm.bias, w2,
              conv.pointwise_conv2.bias, seed, rate, dwc.kernel_size[0])


class ConformerBlock(nn.Module):
    """One conformer layer. `fused_conv` and `fused_conv_split` select the
    conv sub-block's route as the JAX block's fields of the same names do
    (`conv_route`)."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 kernel_size: int = 31, dtype=torch.float32,
                 dropout_rate: float = 0.1,
                 fused_conv: Optional[bool] = None,
                 fused_conv_split: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.fused_conv = fused_conv
        self.fused_conv_split = fused_conv_split
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

    def _conv_sub_block(self, x, pad_mask, generator):
        """x + drop(conv(LN(x))) through the selected route."""
        route = conv_route(self.fused_conv, self.fused_conv_split, x,
                           self.norm_conv.normalized_shape[0])
        if route == "plain":
            return x + self.dropout(self.conv(self.norm_conv(x), pad_mask),
                                    generator)
        rate = (self.dropout.rate
                if self.training and generator is not None else 0.0)
        fn = conv_split_residual if route == "split" else conv_module_residual
        return fn(x, self.norm_conv, self.conv, pad_mask, rate, generator)

    def forward(self, x, pos_emb, bias, pad_mask, generator=None):
        drop = self.dropout
        x = self._macaron(x, self.norm_ff1, self.ff1, generator)
        x = x + drop(self.self_attn(self.norm_attn(x), pos_emb, bias),
                     generator)
        x = self._conv_sub_block(x, pad_mask, generator)
        x = self._macaron(x, self.norm_ff2, self.ff2, generator)
        return self.norm_final(x)


class ConformerEncoder(nn.Module):
    """Conv2d-subsampled conformer encoder. Returns (hidden (B, T', D),
    output lengths), and with `capture_layers` (1-based layer indices) also
    the list [(index, that layer's output), ...]. `remat` checkpoints every
    block; `scan_layers` marks a model whose JAX checkpoints use the stacked
    layout, which InterCTC cannot use (ValueError, as in JAX). `fused_conv`
    and `fused_conv_split` go to every block (the encoder options of
    `models.asr.build_encoder`)."""

    def __init__(self, n_feats: int, d_model: int = 256, num_heads: int = 4,
                 d_ff: int = 2048, num_layers: int = 12,
                 kernel_size: int = 31, subsampling_factor: int = 4,
                 dtype=torch.float32, dropout_rate: float = 0.1,
                 fused_conv: Optional[bool] = None,
                 fused_conv_split: Optional[bool] = None,
                 capture_layers: Sequence[int] = (), remat: bool = False,
                 scan_layers: bool = False):
        super().__init__()
        if scan_layers and capture_layers:
            raise ValueError(
                "scan_layers is incompatible with capture_layers (InterCTC "
                "needs per-layer outputs); use the unrolled layout for "
                "InterCTC models")
        self.d_model = d_model
        self.num_layers = num_layers
        self.dtype = dtype
        self.capture_layers = tuple(capture_layers)
        self.remat = remat
        self.scan_layers = scan_layers
        self.embed = Conv2dSubsampling(d_model, n_feats, subsampling_factor,
                                       dtype=dtype)
        self.dropout = FastDropout(dropout_rate)
        for i in range(num_layers):
            self.add_module(f"layer{i}", ConformerBlock(
                d_model, num_heads, d_ff, kernel_size, dtype, dropout_rate,
                fused_conv, fused_conv_split))

    def layers(self) -> List[ConformerBlock]:
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def forward(self, feats, lengths, generator=None):
        x, olens = self.embed(feats, lengths)
        x = self.dropout(x * self.d_model ** 0.5, generator)
        t = x.shape[1]
        pos_emb = rel_position_encoding(t, self.d_model, self.dtype, x.device)
        pad_mask = make_valid_mask(olens, t)
        bias = attention_bias(pad_mask[:, None, None, :])
        intermediates = []
        for i, layer in enumerate(self.layers()):
            if self.remat:
                x = _remat.checkpoint_block(layer, generator, x, pos_emb,
                                            bias, pad_mask)
            else:
                x = layer(x, pos_emb, bias, pad_mask, generator)
            if i + 1 in self.capture_layers:
                intermediates.append((i + 1, x))
        if self.capture_layers:
            return x, olens, intermediates
        return x, olens
