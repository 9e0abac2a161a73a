"""Contextual-block (streaming) conformer encoder (port of
espnet_tpu/models/streaming.py).

The subsampled frames are cut into blocks of `block_size` frames that start
every `hop_size` frames; each block carries two more slots, a context token
in front (slot 0) and the block's own context seed at the back (slot -1, the
mean of its raw frames). Slot 0 of block b at layer l is the slot -1 output
of layer l-1 at block b-1 (block 0 reuses its own chain). `forward` runs all
blocks of every layer as one batch of (B * nblk, block_size + 2, D) chunks;
`forward_blockwise` runs the same parameters block after block with the
per-layer context carried explicitly (`_one_block`, the streaming mode), and
gives the same output. Sequences of at most `block_size` frames take the
short path: one full block with a key-padding bias.

Each layer is the JAX `ContextualBlockLayer`: [LN, macaron FFN], LN,
self-attention, [LN, conv module], LN, FFN, [final LN], pre-norm with
residuals. Its routes on the card:
* both FFNs are `PositionwiseFeedForward(fused=True)` behind their own
  LayerNorm, so they take `ops.ffn.fused_ffn` (forward and backward), the
  kernel the JAX layer's FFN reaches on the TPU;
* the chunk attention's bias masks query 0 against every key, so it is not
  a key-padding bias and `MultiHeadAttention` takes its plain path there;
  the short path's bias is one, so its attention takes `flash_attention`;
* the conv module is the plain one, with an all-ones mask (padding
  included), as in JAX.
Dropout after each sub-layer is flax `nn.Dropout` (`ops.dropout.Dropout`),
inside the FFNs the kernels' hash dropout; both are on while the module is
training and the caller passes a `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from espnet_tpu_torch.models.attention import MultiHeadAttention
from espnet_tpu_torch.models.conformer import ConvolutionModule
from espnet_tpu_torch.models.embedding import sinusoidal_table
from espnet_tpu_torch.models.layers import LayerNorm
from espnet_tpu_torch.models.subsampling import Conv2dSubsampling
from espnet_tpu_torch.models.transformer import PositionwiseFeedForward
from espnet_tpu_torch.ops.dropout import Dropout
from espnet_tpu_torch.ops.masks import attention_bias, make_valid_mask


class ContextualBlockLayer(nn.Module):
    """One conformer-style layer over (N, block_size + 2, D) chunks."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 kernel_size: int = 31, dropout_rate: float = 0.1,
                 macaron_style: bool = True, use_cnn_module: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.macaron_style = macaron_style
        self.use_cnn_module = use_cnn_module
        self.dropout = Dropout(dropout_rate)

        def ffn():
            return PositionwiseFeedForward(d_model, d_ff, "swish", dtype,
                                           dropout_rate, fused=True)

        if macaron_style:
            self.norm_ff_macaron = LayerNorm(d_model, dtype)
            self.ff_macaron = ffn()
        self.norm1 = LayerNorm(d_model, dtype)
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype)
        if use_cnn_module:
            self.norm_conv = LayerNorm(d_model, dtype)
            self.conv = ConvolutionModule(d_model, kernel_size, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.ff = ffn()
        if use_cnn_module:
            self.norm_final = LayerNorm(d_model, dtype)

    def forward(self, x, bias, generator=None):
        drop = self.dropout
        ff_scale = 0.5 if self.macaron_style else 1.0
        if self.macaron_style:
            h = self.ff_macaron(self.norm_ff_macaron(x), generator)
            x = x + ff_scale * drop(h, generator)
        h = self.norm1(x)
        x = x + drop(self.self_attn(h, h, h, bias), generator)
        if self.use_cnn_module:
            h = self.norm_conv(x)
            ones = torch.ones(h.shape[:2], dtype=torch.bool, device=h.device)
            x = x + drop(self.conv(h, ones), generator)
        h = self.ff(self.norm2(x), generator)
        x = x + ff_scale * drop(h, generator)
        if self.use_cnn_module:
            x = self.norm_final(x)
        return x


def _block_geometry(t: int, block_size: int, hop_size: int, look_ahead: int):
    """(nblk, block of each output frame, its slot): block 0 emits frames
    [0, block_size - look_ahead), block b >= 1 from slot i - b * hop + 1."""
    past = block_size - hop_size - look_ahead
    nblk = max(1, math.ceil(float(t - past - look_ahead) / hop_size))
    first = block_size - look_ahead
    idx = np.arange(t)
    blk = np.where(idx < first, 0, 1 + (idx - first) // hop_size)
    blk = np.minimum(blk, nblk - 1)
    slot = np.clip(idx - blk * hop_size + 1, 0, block_size + 1)
    return nblk, blk.astype(np.int64), slot.astype(np.int64)


def chunk_bias(block_size: int, device=None) -> torch.Tensor:
    """(1, 1, bs+2, bs+2): queries 1..bs+1 attend keys 0..bs; query 0 is
    inert (overwritten at the next layer) and key bs+1 (the context seed)
    is attended by no query."""
    q = torch.arange(block_size + 2, device=device)[:, None]
    k = torch.arange(block_size + 2, device=device)[None, :]
    return attention_bias(((q >= 1) & (k <= block_size))[None, None])


class ContextualBlockConformerEncoder(nn.Module):
    """Streaming conformer encoder: `forward` (all blocks in parallel) and
    `forward_blockwise` (block after block) return (hidden (B, T', D),
    output lengths)."""

    def __init__(self, n_feats: int, d_model: int = 256, num_heads: int = 4,
                 d_ff: int = 2048, num_layers: int = 12,
                 kernel_size: int = 31, dropout_rate: float = 0.1,
                 subsampling_factor: int = 4, block_size: int = 40,
                 hop_size: int = 16, look_ahead: int = 16,
                 init_average: bool = True, ctx_pos_enc: bool = True,
                 macaron_style: bool = True, use_cnn_module: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.d_model = d_model
        self.num_layers = num_layers
        self.block_size = block_size
        self.hop_size = hop_size
        self.look_ahead = look_ahead
        self.init_average = init_average
        self.ctx_pos_enc = ctx_pos_enc
        self.dtype = dtype
        self.embed = Conv2dSubsampling(d_model, n_feats, subsampling_factor,
                                       dtype=dtype)
        for i in range(num_layers):
            self.add_module(f"layer{i}", ContextualBlockLayer(
                d_model, num_heads, d_ff, kernel_size, dropout_rate,
                macaron_style, use_cnn_module, dtype))
        self.after_norm = LayerNorm(d_model, dtype)

    def layers(self) -> List[ContextualBlockLayer]:
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    # --- shared helpers ---------------------------------------------------
    def pos_enc(self, x, start: int = 0):
        """x * sqrt(D) + PE[start:start+T] (the scale rounded to x's dtype
        first, as JAX multiplies)."""
        t, d = x.shape[-2], x.shape[-1]
        pe = torch.from_numpy(sinusoidal_table(start + t, d)[start:])
        scale = torch.tensor(d ** 0.5, dtype=x.dtype, device=x.device)
        return x * scale + pe.to(x.device, x.dtype)

    def addin(self, x_raw, counts):
        """Context seed per block: the mean (or max) of its raw frames.
        x_raw (B, nblk, bs, D) zero-padded windows; counts (nblk,)."""
        if self.init_average:
            return x_raw.sum(dim=2) / counts.clamp(min=1)[None, :, None].to(
                x_raw.dtype)
        return x_raw.max(dim=2).values

    def _windows(self, x, nblk: int):
        """x (B, T, D) -> ((B, nblk, bs, D) strided windows, frame counts)."""
        _, t, _ = x.shape
        bs, hop = self.block_size, self.hop_size
        need = (nblk - 1) * hop + bs
        xp = nn.functional.pad(x, (0, 0, 0, max(0, need - t)))
        starts = np.arange(nblk) * hop
        idx = torch.from_numpy(starts[:, None] + np.arange(bs)[None, :])
        counts = torch.from_numpy(np.minimum(np.maximum(t - starts, 0), bs))
        return xp[:, idx.to(x.device)], counts.to(x.device)

    def _short(self, x, olens, generator):
        """Sequences of at most one block: every layer over the whole
        sequence with a key-padding bias."""
        t = x.shape[1]
        bias = attention_bias(make_valid_mask(olens, t)[:, None, None, :])
        h = self.pos_enc(x)
        for layer in self.layers():
            h = layer(h, bias, generator)
        return self.after_norm(h), olens

    def _prepare(self, x):
        """(geometry, windows with positions, context seeds, bias)."""
        t = x.shape[1]
        nblk, blk_map, slot_map = _block_geometry(
            t, self.block_size, self.hop_size, self.look_ahead)
        win_raw, counts = self._windows(x, nblk)
        seeds = self.addin(win_raw, counts)  # (B, nblk, D)
        if self.ctx_pos_enc:
            seeds = self.pos_enc(seeds)
        win, _ = self._windows(self.pos_enc(x), nblk)
        return (nblk, blk_map, slot_map), win, seeds, chunk_bias(
            self.block_size, x.device)

    def _gather(self, h, blk_map, slot_map):
        """(B, nblk, bs+2, D) chunk outputs -> (B, T, D) output frames."""
        dev = h.device
        ys = h[:, torch.from_numpy(blk_map).to(dev),
               torch.from_numpy(slot_map).to(dev)]
        return self.after_norm(ys)

    # --- training path (all blocks in parallel) ---------------------------
    def forward(self, feats, lengths, generator=None):
        x, olens = self.embed(feats, lengths)
        b, t, d = x.shape
        bs = self.block_size
        if bs == 0 or t <= bs:
            return self._short(x, olens, generator)
        (nblk, blk_map, slot_map), win, seeds, bias = self._prepare(x)
        prev = torch.cat([seeds[:, :1], seeds[:, :-1]], dim=1)
        h = torch.cat([prev[:, :, None], win, seeds[:, :, None]], dim=2)
        for li, layer in enumerate(self.layers()):
            if li > 0:
                # slot 0 of block b <- slot -1 of block b-1 at the previous
                # layer; block 0 reuses its own
                chain = h[:, :, -1]
                ctx = torch.cat([chain[:, :1], chain[:, :-1]], dim=1)
                h = torch.cat([ctx[:, :, None], h[:, :, 1:]], dim=2)
            h = layer(h.reshape(b * nblk, bs + 2, d), bias,
                      generator).reshape(b, nblk, bs + 2, d)
        return self._gather(h, blk_map, slot_map), olens

    # --- blockwise-sequential path (streaming execution) -------------------
    def forward_blockwise(self, feats, lengths, generator=None):
        """The same computation block after block, the per-layer context
        carried explicitly (the streaming mode; equals `forward`)."""
        x, olens = self.embed(feats, lengths)
        t = x.shape[1]
        if self.block_size == 0 or t <= self.block_size:
            return self._short(x, olens, generator)
        (nblk, blk_map, slot_map), win, seeds, bias = self._prepare(x)
        ctx = None
        outs = []
        for bi in range(nblk):
            chunk, ctx = self.one_block(
                win[:, bi], seeds[:, bi], seeds[:, bi - 1] if bi else None,
                ctx, bias, generator)
            outs.append(chunk)
        return self._gather(torch.stack(outs, dim=1), blk_map,
                            slot_map), olens

    def one_block(self, frames, addin_cur, addin_prev,
                  ctx: Optional[List[torch.Tensor]], bias, generator=None
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """One (B, bs, D) block (positions added). ctx: None for the first
        block, else the num_layers context vectors (B, D) carried from the
        previous block. Returns (chunk output (B, bs+2, D), new ctx)."""
        first = ctx is None
        slot0 = addin_cur if first else addin_prev
        h = torch.cat([slot0[:, None], frames, addin_cur[:, None]], dim=1)
        new_ctx = []
        for li, layer in enumerate(self.layers()):
            if li > 0:
                chain = h[:, -1]  # slot -1 output of layer li-1
                use = chain if first else ctx[li]
                h = torch.cat([use[:, None], h[:, 1:]], dim=1)
                new_ctx.append(chain)
            else:
                new_ctx.append(addin_cur)
            h = layer(h, bias, generator)
        return h, new_ctx
