"""Separators: encoded mixture -> per-speaker masked features (port of
espnet_tpu/models/enh/separators.py).

Each takes (feat (B, T, N), lengths, generator) and returns (masked
(B, n_spk, T, N), lengths, {"mask_spk<i>": ...}). `ConformerSeparator` and
`TransformerSeparator` run the port's kernels: the rel-pos attention, the
pre-norm FFN and (on the split or module route) the conv sub-block for the
conformer; flash attention and the pre-norm FFN for the transformer, whose
hash dropout matches JAX's bit for bit given the same seeds. DPTNet's
attention is the port's `MultiHeadAttention`, so flash over 100-frame
chunks and across them; its dropout is flax's `nn.Dropout` rule
(`ops/dropout.py` `Dropout`). The LSTM separators are host loops of cell
steps (`models/layers.py` `lstm_sequence`). Dropout and the other draws
are on while a module is training and given a generator.
"""

from __future__ import annotations

import torch
from torch import nn

from espnet_tpu_torch.models.attention import MultiHeadAttention
from espnet_tpu_torch.models.conformer import ConformerBlock
from espnet_tpu_torch.models.embedding import (add_positional_encoding,
                                               rel_position_encoding)
from espnet_tpu_torch.models.enh.layers import (DPRNNBlock, TemporalConvNet,
                                                add_cells, bilstm, cell,
                                                mask_nonlinear,
                                                merge_segments,
                                                segment_sequence)
from espnet_tpu_torch.models.layers import Dense, LayerNorm, lstm_sequence
from espnet_tpu_torch.models.transformer import TransformerEncoderLayer
from espnet_tpu_torch.ops.dropout import Dropout
from espnet_tpu_torch.ops.masks import attention_bias, make_valid_mask

F32 = torch.float32


def _masks_out(masks, feat, lengths, num_spk):
    others = {f"mask_spk{i + 1}": masks[:, i] for i in range(num_spk)}
    return masks * feat[:, None], lengths, others


class TCNSeparator(nn.Module):
    """Conv-TasNet separator."""

    def __init__(self, input_dim: int, num_spk: int = 2, layers: int = 8,
                 stacks: int = 3, bottleneck: int = 128, hidden: int = 512,
                 kernel: int = 3, norm_type: str = "gLN",
                 causal: bool = False, nonlinear: str = "relu",
                 dtype=F32):
        super().__init__()
        self.num_spk = num_spk
        self.tcn = TemporalConvNet(input_dim, num_spk, layers, stacks,
                                   bottleneck, hidden, kernel, norm_type,
                                   causal, nonlinear, dtype)

    def forward(self, feat, lengths, generator=None):
        return _masks_out(self.tcn(feat), feat, lengths, self.num_spk)


class DPRNNSeparator(nn.Module):
    """Dual-path RNN separator."""

    def __init__(self, input_dim: int, num_spk: int = 2,
                 num_blocks: int = 6, hidden: int = 128,
                 chunk_size: int = 100, nonlinear: str = "relu",
                 dtype=F32):
        super().__init__()
        self.num_spk, self.num_blocks = num_spk, num_blocks
        self.chunk_size, self.nonlinear = chunk_size, nonlinear
        for i in range(num_blocks):
            self.add_module(f"block{i}", DPRNNBlock(input_dim, hidden,
                                                    dtype=dtype))
        self.mask_out = Dense(input_dim, num_spk * input_dim, dtype=dtype)

    def forward(self, feat, lengths, generator=None):
        b, t, n = feat.shape
        seg, t_orig = segment_sequence(feat, self.chunk_size)
        for i in range(self.num_blocks):
            seg = getattr(self, f"block{i}")(seg)
        s = seg.shape[1]
        h = self.mask_out(seg).reshape(b, s, self.chunk_size, self.num_spk,
                                       n)
        h = h.permute(0, 3, 1, 2, 4).reshape(b * self.num_spk, s,
                                             self.chunk_size, n)
        masks = merge_segments(h, t_orig).reshape(b, self.num_spk, t, n)
        kind = self.nonlinear if self.nonlinear in ("relu", "sigmoid") \
            else "tanh"
        return _masks_out(mask_nonlinear(masks, kind), feat, lengths,
                          self.num_spk)


class TransformerSeparator(nn.Module):
    """Transformer-encoder separator: in_proj, sinusoidal positions, the
    port's `TransformerEncoderLayer`s (flash and the pre-norm FFN)."""

    def __init__(self, input_dim: int, num_spk: int = 2, d_model: int = 256,
                 num_heads: int = 4, d_ff: int = 1024, num_layers: int = 4,
                 dropout_rate: float = 0.1, nonlinear: str = "relu",
                 dtype=F32):
        super().__init__()
        self.num_spk, self.num_layers = num_spk, num_layers
        self.nonlinear = nonlinear
        self.in_proj = Dense(input_dim, d_model, dtype=dtype)
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                d_model, num_heads, d_ff, dtype, dropout_rate))
        self.mask_out = Dense(d_model, num_spk * input_dim, dtype=dtype)

    def forward(self, feat, lengths, generator=None):
        b, t, n = feat.shape
        x = add_positional_encoding(self.in_proj(feat))
        bias = attention_bias(make_valid_mask(lengths, t)[:, None, None, :])
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, bias, generator)
        masks = self.mask_out(x).reshape(b, t, self.num_spk, n)
        kind = self.nonlinear if self.nonlinear in ("relu", "sigmoid") \
            else "tanh"
        return _masks_out(mask_nonlinear(masks.permute(0, 2, 1, 3), kind),
                          feat, lengths, self.num_spk)


class ImprovedTransformerLayer(nn.Module):
    """DPTNet's layer: MHA, then a BiLSTM position-wise FF, each with
    dropout, residual and LayerNorm."""

    def __init__(self, d_model: int, num_heads: int, hidden: int,
                 dropout_rate: float = 0.0, dtype=F32):
        super().__init__()
        self.drop = Dropout(dropout_rate)
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype)
        self.norm_attn = LayerNorm(d_model, dtype)
        add_cells(self, [(d_model, hidden, F32)] * 2)
        self.ff_proj = Dense(2 * hidden, d_model, dtype=dtype)
        self.norm_ff = LayerNorm(d_model, dtype)

    def forward(self, x, generator=None):
        h = self.self_attn(x, x, x)
        x = self.norm_attn(x + self.drop(h, generator))
        h = self.ff_proj(torch.relu(bilstm(self, 0, x)))
        return self.norm_ff(x + self.drop(h, generator))


class DPTNetSeparator(nn.Module):
    """Dual-path transformer: half-overlapping chunks, intra- and
    inter-chunk improved transformer layers, a mask head per speaker."""

    def __init__(self, input_dim: int, num_spk: int = 2,
                 num_blocks: int = 4, d_model: int = 0, num_heads: int = 4,
                 hidden: int = 128, chunk_size: int = 100,
                 nonlinear: str = "relu", dropout_rate: float = 0.0,
                 dtype=F32):
        super().__init__()
        self.num_spk, self.num_blocks = num_spk, num_blocks
        self.chunk_size, self.nonlinear = chunk_size, nonlinear
        d = d_model or input_dim
        self.d = d
        if d != input_dim:
            self.in_proj = Dense(input_dim, d, dtype=dtype)
        for i in range(num_blocks):
            for side in ("intra", "inter"):
                self.add_module(f"{side}{i}", ImprovedTransformerLayer(
                    d, num_heads, hidden, dropout_rate, dtype))
        self.mask_out = Dense(d, num_spk * input_dim, dtype=dtype)

    def forward(self, feat, lengths, generator=None):
        b, t, n = feat.shape
        seg, t_orig = segment_sequence(feat, self.chunk_size)
        s, k, d = seg.shape[1], seg.shape[2], self.d
        if d != n:
            seg = self.in_proj(seg)
        for i in range(self.num_blocks):
            h = getattr(self, f"intra{i}")(seg.reshape(b * s, k, d),
                                           generator)
            seg = h.reshape(b, s, k, d)
            h = seg.transpose(1, 2).reshape(b * k, s, d)
            h = getattr(self, f"inter{i}")(h, generator)
            seg = h.reshape(b, k, s, d).transpose(1, 2)
        h = self.mask_out(seg * torch.sigmoid(seg))
        h = h.reshape(b, s, k, self.num_spk, n).permute(0, 3, 1, 2, 4)
        h = h.reshape(b * self.num_spk, s, k, n)
        masks = merge_segments(h, t_orig).reshape(b, self.num_spk, t, n)
        return _masks_out(mask_nonlinear(masks, self.nonlinear), feat,
                          lengths, self.num_spk)


class SegLSTM(nn.Module):
    """Per-segment (Bi)LSTM from given initial states, projection,
    LayerNorm and residual; returns (out, the forward run's final carry)."""

    def __init__(self, input_dim: int, hidden: int,
                 bidirectional: bool = True, dtype=F32):
        super().__init__()
        self.bidirectional = bidirectional
        add_cells(self, [(input_dim, hidden, F32)]
                  * (2 if bidirectional else 1))
        self.proj = Dense((2 if bidirectional else 1) * hidden, input_dim,
                          dtype=dtype)
        self.norm = LayerNorm(input_dim, dtype)

    def forward(self, x, carry):
        fwd, carry_out = lstm_sequence(cell(self, 0), x, carry=carry)
        if self.bidirectional:
            bwd, _ = lstm_sequence(cell(self, 1), x, reverse=True)
            h = torch.cat([fwd, bwd], dim=-1)
        else:
            h = fwd
        return x + self.norm(self.proj(h)), carry_out


class MemLSTM(nn.Module):
    """The memory LSTM over the segment axis: the per-segment final (c, h)
    become the next SegLSTM layer's initial states (mem_type "hc")."""

    def __init__(self, hidden: int, bidirectional: bool = True, dtype=F32):
        super().__init__()
        self.bidirectional = bidirectional
        per = 2 if bidirectional else 1
        add_cells(self, [(hidden, hidden, F32)] * (2 * per))
        for name in ("c", "h"):
            self.add_module(f"{name}_proj", Dense(per * hidden, hidden,
                                                  dtype=dtype))
            self.add_module(f"{name}_norm", LayerNorm(hidden, dtype))

    def _run(self, x, k, name):
        if self.bidirectional:
            y = bilstm(self, k, x)
        else:
            y, _ = lstm_sequence(cell(self, k), x)
        y = getattr(self, f"{name}_proj")(y)
        return getattr(self, f"{name}_norm")(x + y)

    def forward(self, c, h):
        per = 2 if self.bidirectional else 1
        return self._run(c, 0, "c"), self._run(h, per, "h")


class SkiMSeparator(nn.Module):
    """Skipping-memory LSTM separator: non-overlapping segments, SegLSTM in
    each, MemLSTM carrying states across segments between layers."""

    def __init__(self, input_dim: int, num_spk: int = 2,
                 num_blocks: int = 4, hidden: int = 128,
                 segment_size: int = 20, bidirectional: bool = True,
                 mem_type: str = "hc", nonlinear: str = "relu", dtype=F32):
        super().__init__()
        self.num_spk, self.num_blocks = num_spk, num_blocks
        self.hidden, self.segment_size = hidden, segment_size
        self.mem_type, self.nonlinear = mem_type, nonlinear
        self.dtype = dtype
        for i in range(num_blocks):
            self.add_module(f"seg{i}", SegLSTM(input_dim, hidden,
                                               bidirectional, dtype))
            if i < num_blocks - 1 and mem_type == "hc":
                self.add_module(f"mem{i}", MemLSTM(hidden, bidirectional,
                                                   dtype))
        self.mask_out = Dense(input_dim, num_spk * input_dim, dtype=dtype)

    def forward(self, feat, lengths, generator=None):
        b, t, n = feat.shape
        k, hd = self.segment_size, self.hidden
        s = -(-t // k)
        seg = nn.functional.pad(feat, (0, 0, 0, s * k - t)).reshape(b, s, k,
                                                                    n)
        c0 = torch.zeros(b * s, hd, dtype=self.dtype, device=feat.device)
        h0 = torch.zeros(b * s, hd, dtype=self.dtype, device=feat.device)
        for i in range(self.num_blocks):
            x, (c_out, h_out) = getattr(self, f"seg{i}")(
                seg.reshape(b * s, k, n), (c0, h0))
            seg = x.reshape(b, s, k, n)
            if i < self.num_blocks - 1:
                if self.mem_type == "hc":
                    c_seq, h_seq = getattr(self, f"mem{i}")(
                        c_out.reshape(b, s, hd), h_out.reshape(b, s, hd))
                    c0 = c_seq.reshape(b * s, hd)
                    h0 = h_seq.reshape(b * s, hd)
                else:
                    c0, h0 = c_out, h_out
        h = self.mask_out(seg.reshape(b, s * k, n)[:, :t])
        masks = h.reshape(b, t, self.num_spk, n).permute(0, 2, 1, 3)
        return _masks_out(mask_nonlinear(masks, self.nonlinear), feat,
                          lengths, self.num_spk)


class ConformerSeparator(nn.Module):
    """Conformer-encoder separator: in_proj, relative positions and the
    port's `ConformerBlock`s (no input scaling, as in JAX). Their conv
    sub-block takes the plain route, JAX's default; a block's `fused_conv`
    or `fused_conv_split` sends it to the kernels (`conv_route`)."""

    def __init__(self, input_dim: int, num_spk: int = 2, d_model: int = 256,
                 num_heads: int = 4, d_ff: int = 1024, num_layers: int = 4,
                 kernel_size: int = 15, dropout_rate: float = 0.1,
                 nonlinear: str = "relu", dtype=F32):
        super().__init__()
        self.num_spk, self.num_layers = num_spk, num_layers
        self.d_model, self.dtype = d_model, dtype
        self.nonlinear = nonlinear
        self.in_proj = Dense(input_dim, d_model, dtype=dtype)
        for i in range(num_layers):
            self.add_module(f"layer{i}", ConformerBlock(
                d_model, num_heads, d_ff, kernel_size, dtype, dropout_rate))
        self.mask_out = Dense(d_model, num_spk * input_dim, dtype=dtype)

    def forward(self, feat, lengths, generator=None):
        b, t, n = feat.shape
        x = self.in_proj(feat)
        pos_emb = rel_position_encoding(t, self.d_model, self.dtype,
                                        feat.device)
        pad_mask = make_valid_mask(lengths, t)
        bias = attention_bias(pad_mask[:, None, None, :])
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, pos_emb, bias, pad_mask,
                                           generator)
        masks = self.mask_out(x).reshape(b, t, self.num_spk, n)
        return _masks_out(mask_nonlinear(masks.permute(0, 2, 1, 3),
                                         self.nonlinear),
                          feat, lengths, self.num_spk)


def _stacked_blstm(module, x, layers, bidirectional=True):
    """`layers` (Bi)LSTM layers over x, cells 2i and 2i+1 of `module`
    (i only when unidirectional)."""
    for i in range(layers):
        if bidirectional:
            x = bilstm(module, 2 * i, x)
        else:
            x, _ = lstm_sequence(cell(module, i), x)
    return x


class RNNSeparator(nn.Module):
    """Stacked (Bi)LSTM mask estimator with per-speaker masks."""

    def __init__(self, input_dim: int, num_spk: int = 2, layers: int = 3,
                 hidden: int = 512, bidirectional: bool = True,
                 nonlinear: str = "sigmoid", dtype=F32):
        super().__init__()
        if nonlinear not in ("sigmoid", "relu", "tanh"):
            raise KeyError(nonlinear)
        self.num_spk, self.layers = num_spk, layers
        self.bidirectional, self.nonlinear = bidirectional, nonlinear
        self.input_dim = input_dim
        per = 2 if bidirectional else 1
        add_cells(self, [(input_dim if i == 0 else per * hidden, hidden,
                          dtype) for i in range(layers) for _ in range(per)])
        self.mask_proj = Dense(per * hidden, num_spk * input_dim,
                               dtype=dtype)

    def forward(self, feat, lengths, generator=None):
        x = _stacked_blstm(self, feat, self.layers, self.bidirectional)
        masks = mask_nonlinear(self.mask_proj(x), self.nonlinear)
        masks = masks.reshape(feat.shape[0], feat.shape[1], self.num_spk,
                              self.input_dim).permute(0, 2, 1, 3)
        return _masks_out(masks, feat, lengths, self.num_spk)


class DANSeparator(nn.Module):
    """Deep-attractor network: BLSTM -> TF embeddings; attractors are the
    mask-weighted embedding means, from `oracle_masks` (B, T, F, n_spk)
    when given, else from a first softmax over the learned codebook
    `attractor_init`; masks are the softmax of embedding-attractor
    similarities. `others["embedding"]` holds the (B, TF, D) embeddings."""

    def __init__(self, input_dim: int, num_spk: int = 2, layers: int = 2,
                 hidden: int = 256, emb_dim: int = 20, dtype=F32):
        super().__init__()
        self.num_spk, self.layers, self.emb_dim = num_spk, layers, emb_dim
        add_cells(self, [(input_dim if i == 0 else 2 * hidden, hidden,
                          dtype) for i in range(layers) for _ in range(2)])
        self.emb_proj = Dense(2 * hidden, input_dim * emb_dim, dtype=dtype)
        self.attractor_init = nn.Parameter(torch.randn(num_spk, emb_dim))

    @torch.no_grad()
    def init_random_(self, generator=None):
        self.attractor_init.copy_(torch.randn(
            self.attractor_init.shape, generator=generator))

    def forward(self, feat, lengths, generator=None, oracle_masks=None):
        b, t, f = feat.shape
        x = _stacked_blstm(self, feat, self.layers)
        emb = torch.tanh(self.emb_proj(x)).reshape(b, t * f, self.emb_dim)
        if oracle_masks is not None:
            w = oracle_masks.reshape(b, t * f, self.num_spk)
        else:
            sim0 = torch.einsum("bnd,sd->bns", emb,
                                self.attractor_init.to(emb.dtype))
            w = torch.softmax(sim0, dim=-1)
        denom = w.sum(1, keepdim=True).clamp(min=1e-6)
        attractors = torch.einsum("bns,bnd->bsd", w / denom, emb)
        sim = torch.einsum("bnd,bsd->bns", emb, attractors)
        masks = torch.softmax(sim, dim=-1).reshape(b, t, f, self.num_spk)
        masked, lengths, others = _masks_out(masks.permute(0, 3, 1, 2), feat,
                                             lengths, self.num_spk)
        others["embedding"] = emb
        return masked, lengths, others
