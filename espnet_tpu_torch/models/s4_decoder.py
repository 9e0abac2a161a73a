"""S4 (state-space) ASR decoder (port of espnet_tpu/models/s4_decoder.py).

A token embedding, then blocks of [LN -> S4D -> GLU gate -> projection ->
residual] + [LN -> cross-attention to the encoder -> residual] + [LN ->
FFN -> residual], a final LayerNorm and the output projection. The S4D
core (`ops/s4.py`) runs as a convolution under teacher forcing and as a
recurrence when decoding, so the decode state is one complex (B, H, N/2)
tensor per block whatever the length. The FFN is
`PositionwiseFeedForward(fused=True)` (the `fused_ffn` kernels on the
card); the cross-attention is the port's `MultiHeadAttention`, whose flash
route takes only Tq == Tk, as the JAX gate does, so the decoder's
cross-attention runs its plain version at the lengths it meets. Dropout
follows flax's rule (`ops.dropout.Dropout`). `init_cache` and
`score_step` serve the beam search, the cache a list of per-block states.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from espnet_tpu_torch.models.attention import MultiHeadAttention
from espnet_tpu_torch.models.layers import Dense, LayerNorm
from espnet_tpu_torch.models.transformer import PositionwiseFeedForward
from espnet_tpu_torch.ops.dropout import Dropout
from espnet_tpu_torch.ops.masks import attention_bias, make_valid_mask
from espnet_tpu_torch.ops.s4 import S4DLayer


class S4DecoderBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 state_dim: int = 64, dropout_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.norm_s4 = LayerNorm(d_model, dtype)
        self.s4 = S4DLayer(d_model, state_dim, dtype=dtype)
        self.gate = Dense(d_model, 2 * d_model, dtype=dtype)
        self.out = Dense(d_model, d_model, dtype=dtype)
        self.norm_cross = LayerNorm(d_model, dtype)
        self.cross = MultiHeadAttention(num_heads, d_model, dtype)
        self.norm_ff = LayerNorm(d_model, dtype)
        self.ff = PositionwiseFeedForward(d_model, d_ff, "relu", dtype,
                                          dropout_rate, fused=True)
        self.dropout = Dropout(dropout_rate)

    def _post_s4(self, h, generator):
        a, g = self.gate(h).chunk(2, dim=-1)
        return self.dropout(self.out(a * torch.sigmoid(g)), generator)

    def forward(self, x, memory, mem_bias, generator=None):
        x = x + self._post_s4(self.s4(self.norm_s4(x)), generator)
        h = self.cross(self.norm_cross(x), memory, memory, mem_bias)
        x = x + self.dropout(h, generator)
        h = self.ff(self.norm_ff(x), generator)
        return x + self.dropout(h, generator)

    def step(self, x_t, state, memory, mem_bias):
        """x_t (B, D); state: the S4 complex state."""
        h, new_state = self.s4.step(state, self.norm_s4(x_t))
        x_t = x_t + self._post_s4(h, None)
        h = self.norm_cross(x_t)
        x_t = x_t + self.cross(h[:, None], memory, memory, mem_bias)[:, 0]
        return x_t + self.ff(self.norm_ff(x_t)), new_state


class S4Decoder(nn.Module):
    """Drop-in alternative to TransformerDecoder (same scoring
    interface)."""

    def __init__(self, vocab_size: int, d_model: int = 256,
                 num_heads: int = 4, d_ff: int = 2048, num_layers: int = 6,
                 state_dim: int = 64, dropout_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        for i in range(num_layers):
            self.add_module(f"block{i}", S4DecoderBlock(
                d_model, num_heads, d_ff, state_dim, dropout_rate, dtype))
        self.final_norm = LayerNorm(d_model, dtype)
        self.out_proj = Dense(d_model, vocab_size, dtype=dtype)
        self.dropout = Dropout(dropout_rate)

    def blocks(self) -> List[S4DecoderBlock]:
        return [getattr(self, f"block{i}") for i in range(self.num_layers)]

    def _embed(self, tokens):
        return nn.functional.embedding(tokens.long(),
                                       self.embed.weight.to(self.dtype))

    def forward(self, tokens, token_lengths, memory, memory_lengths,
                generator=None):
        x = self.dropout(self._embed(tokens), generator)
        mem_bias = attention_bias(
            make_valid_mask(memory_lengths, memory.shape[1])[:, None, None, :])
        for block in self.blocks():
            x = block(x, memory, mem_bias, generator)
        return self.out_proj(self.final_norm(x))

    def init_cache(self, batch: int, max_len: int = 0, device=None) -> list:
        return [b.s4.init_state(batch, device) for b in self.blocks()]

    def score_step(self, tokens_step, pos, memory, memory_lengths, cache):
        mem_bias = attention_bias(
            make_valid_mask(memory_lengths, memory.shape[1])[:, None, None, :])
        x = self._embed(tokens_step)
        new_cache = []
        for block, st in zip(self.blocks(), cache):
            x, ns = block.step(x, st, memory, mem_bias)
            new_cache.append(ns)
        logits = self.out_proj(self.final_norm(x))
        return torch.log_softmax(logits.float(), dim=-1), new_cache
