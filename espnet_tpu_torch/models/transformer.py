"""Transformer encoder and decoder (port of espnet_tpu/models/transformer.py).

Pre-norm layers with a final LayerNorm. The encoder adds absolute
positions after the Conv2d subsampling; each layer's self-attention goes
through `MultiHeadAttention`'s kernel route and its FFN through the pre-norm
FFN (`ops.prenorm_ffn`, relu, residual scale 1, hash dropout with two
int32 seeds drawn from the caller's generator), as the JAX layer's fused
path does: one encode call launches 1 attention and 1 FFN kernel per layer.
The decoder ends in an output projection to the vocabulary; `score_step`
decodes one token for every hypothesis of a beam search against an explicit
per-layer KV cache. The decoder's FFN is plain PyTorch: in the JAX package
its row count (batch x beam, or batch x labels in training) stays below the
fused kernels' gate, so it never reaches `fused_ffn` or `fused_prenorm_ffn`
either.

`PositionwiseFeedForward(fused=True)` (the E-Branchformer's macaron FFNs)
goes through `ops.ffn.fused_ffn`, the CUDA kernels on the card, with its
hash dropout (one int32 seed per call); with `fused=False` it is plain
PyTorch with FastDropout, as the JAX layer's unfused path.

Dropout (FastDropout, rate `dropout_rate`) sits where the JAX package has
it: after the embedding, after each sub-layer and inside the FFN after its
activation. It is on while the module is training and the caller passes a
`torch.Generator`; without one the modules are deterministic.
"""

from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

from espnet_tpu_torch.models.attention import MultiHeadAttention
from espnet_tpu_torch.models.embedding import (add_positional_encoding,
                                               sinusoidal_table)
from espnet_tpu_torch.models.layers import Dense, LayerNorm
from espnet_tpu_torch.models.subsampling import Conv2dSubsampling
from espnet_tpu_torch.ops import ffn as _ffn
from espnet_tpu_torch.ops import prenorm_ffn as _pffn
from espnet_tpu_torch.ops.ffn_common import kernel_takes
from espnet_tpu_torch.ops.dropout import FastDropout, draw_seeds
from espnet_tpu_torch.ops.masks import (attention_bias, make_valid_mask,
                                        subsequent_mask)


class PositionwiseFeedForward(nn.Module):
    """w1 -> activation -> dropout -> w2 (parameter names as the JAX
    package's); `fused=True` takes the `fused_ffn` route. `use_kernel` is
    the one switch of this FFN's kernel route, whichever it is: `fused_ffn`
    here, or the pre-norm FFN where a layer calls `prenorm_residual_ffn`."""

    def __init__(self, d_model: int, d_ff: int, activation: str = "relu",
                 dtype=torch.float32, dropout_rate: float = 0.1,
                 fused: bool = False):
        super().__init__()
        if activation not in ("relu", "swish"):
            raise ValueError(f"unsupported activation {activation!r}")
        self.activation = activation
        self.dtype = dtype
        self.fused = fused
        self.w1 = Dense(d_model, d_ff, dtype=dtype)
        self.w2 = Dense(d_ff, d_model, dtype=dtype)
        self.dropout = FastDropout(dropout_rate)
        # False: the plain version even on the card (chip_smoke.py compares)
        self.use_kernel = True

    def forward(self, x, generator=None):
        if self.fused:
            return self._fused(x, generator)
        h = self.w1(x)
        h = torch.relu(h) if self.activation == "relu" else h * torch.sigmoid(h)
        return self.w2(self.dropout(h, generator))

    def _fused(self, x, generator):
        dt = self.dtype
        d_model, d_ff = self.w1.in_features, self.w1.out_features
        drop = (self.dropout.rate
                if self.training and generator is not None else 0.0)
        seed = draw_seeds(generator, 1)[0] if drop > 0.0 else None
        fn = (_ffn.fused_ffn
              if self.use_kernel and kernel_takes(d_model, d_ff)
              else _ffn.fused_ffn_plain)
        return fn(x.to(dt).contiguous(),
                  self.w1.weight.t().to(dt).contiguous(), self.w1.bias,
                  self.w2.weight.t().to(dt).contiguous(), self.w2.bias,
                  seed, drop, self.activation)


def prenorm_residual_ffn(x, norm: "LayerNorm", ff: PositionwiseFeedForward,
                         residual_scale: float, rate: float, generator):
    """x + s * drop(FFN_drop(LN(x))) through the pre-norm FFN kernels (the
    JAX package's `fused_prenorm_ffn` route), or their plain version where
    `ff.use_kernel` is False or the shape gate refuses the shapes. Dropout
    (two int32 seeds) is on when `rate` > 0 and a generator is given."""
    dt = ff.dtype
    seeds = draw_seeds(generator, 2) if rate > 0.0 else None
    take = ff.use_kernel and kernel_takes(ff.w1.in_features,
                                          ff.w1.out_features)
    fn = _pffn.prenorm_ffn if take else _pffn.prenorm_ffn_plain
    return fn(x.to(dt).contiguous(), norm.weight, norm.bias,
              ff.w1.weight.t().to(dt).contiguous(), ff.w1.bias,
              ff.w2.weight.t().to(dt).contiguous(), ff.w2.bias,
              activation=ff.activation, residual_scale=residual_scale,
              drop_rate=rate, seeds=seeds)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 dtype=torch.float32, dropout_rate: float = 0.1):
        super().__init__()
        self.norm1 = LayerNorm(d_model, dtype)
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.ff = PositionwiseFeedForward(d_model, d_ff, "relu", dtype,
                                          dropout_rate)
        self.dropout = FastDropout(dropout_rate)

    def forward(self, x, bias, generator=None):
        h = self.norm1(x)
        x = x + self.dropout(self.self_attn(h, h, h, bias), generator)
        rate = (self.dropout.rate
                if self.training and generator is not None else 0.0)
        return prenorm_residual_ffn(x, self.norm2, self.ff, 1.0, rate,
                                    generator)


class TransformerEncoder(nn.Module):
    """Conv2d-subsampled transformer encoder. Returns (hidden (B, T', D),
    output lengths)."""

    def __init__(self, n_feats: int, d_model: int = 256, num_heads: int = 4,
                 d_ff: int = 2048, num_layers: int = 12,
                 subsampling_factor: int = 4, dtype=torch.float32,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.num_layers = num_layers
        self.embed = Conv2dSubsampling(d_model, n_feats, subsampling_factor,
                                       dtype=dtype)
        self.dropout = FastDropout(dropout_rate)
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                d_model, num_heads, d_ff, dtype, dropout_rate))
        self.final_norm = LayerNorm(d_model, dtype)

    def layers(self) -> List[TransformerEncoderLayer]:
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def forward(self, feats, lengths, generator=None):
        x, olens = self.embed(feats, lengths)
        x = self.dropout(add_positional_encoding(x), generator)
        bias = attention_bias(
            make_valid_mask(olens, x.shape[1])[:, None, None, :])
        for layer in self.layers():
            x = layer(x, bias, generator)
        return self.final_norm(x), olens


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 dtype=torch.float32, dropout_rate: float = 0.1):
        super().__init__()
        self.norm1 = LayerNorm(d_model, dtype)
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.src_attn = MultiHeadAttention(num_heads, d_model, dtype)
        self.norm3 = LayerNorm(d_model, dtype)
        self.ff = PositionwiseFeedForward(d_model, d_ff, "relu", dtype,
                                          dropout_rate)
        self.dropout = FastDropout(dropout_rate)

    def forward(self, x, self_bias, memory, memory_bias, cache=None,
                cache_index=None, generator=None):
        drop = self.dropout
        h = self.norm1(x)
        new_cache = None
        if cache is not None:
            h, new_cache = self.self_attn(h, h, h, self_bias, cache, cache_index)
        else:
            h = self.self_attn(h, h, h, self_bias)
        x = x + drop(h, generator)
        h = self.norm2(x)
        x = x + drop(self.src_attn(h, memory, memory, memory_bias), generator)
        x = x + drop(self.ff(self.norm3(x), generator), generator)
        if cache is not None:
            return x, new_cache
        return x


class TransformerDecoder(nn.Module):
    """Autoregressive transformer decoder with output projection."""

    def __init__(self, vocab_size: int, d_model: int = 256,
                 num_heads: int = 4, d_ff: int = 2048, num_layers: int = 6,
                 dtype=torch.float32, dropout_rate: float = 0.1):
        super().__init__()
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerDecoderLayer(
                d_model, num_heads, d_ff, dtype, dropout_rate))
        self.final_norm = LayerNorm(d_model, dtype)
        self.out_proj = Dense(d_model, vocab_size, dtype=dtype)
        self.dropout = FastDropout(dropout_rate)

    def layers(self) -> List[TransformerDecoderLayer]:
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def _embed(self, tokens):
        return nn.functional.embedding(tokens, self.embed.weight.to(self.dtype))

    def forward(self, tokens, token_lengths, memory, memory_lengths,
                generator=None):
        """Teacher-forced decode. tokens: (B, U) int -> logits (B, U, V)."""
        u = tokens.shape[1]
        x = self.dropout(add_positional_encoding(self._embed(tokens)),
                         generator)
        tgt_valid = make_valid_mask(token_lengths, u)
        causal = subsequent_mask(u, tokens.device)
        self_bias = attention_bias(tgt_valid[:, None, None, :]
                                   & causal[None, None])
        mem_bias = attention_bias(
            make_valid_mask(memory_lengths, memory.shape[1])[:, None, None, :])
        for layer in self.layers():
            x = layer(x, self_bias, memory, mem_bias, generator=generator)
        return self.out_proj(self.final_norm(x))

    def init_cache(self, batch: int, max_len: int, device=None) -> list:
        """Empty per-layer KV caches, (batch, H, max_len, Dk) each."""
        dk = self.d_model // self.num_heads
        shape = (batch, self.num_heads, max_len, dk)
        return [{"k": torch.zeros(shape, dtype=self.dtype, device=device),
                 "v": torch.zeros(shape, dtype=self.dtype, device=device)}
                for _ in range(self.num_layers)]

    def score_step(self, tokens_step, pos: int, memory, memory_lengths, cache):
        """One incremental step: tokens_step (N,) at position `pos` ->
        (log-probs (N, V) float32, new cache)."""
        x = self._embed(tokens_step[:, None])
        t_all = cache[0]["k"].shape[2]
        pe = torch.from_numpy(sinusoidal_table(t_all, self.d_model)[pos])
        x = x * math.sqrt(self.d_model)
        x = x + pe.to(x.device, x.dtype)
        mem_bias = attention_bias(
            make_valid_mask(memory_lengths, memory.shape[1])[:, None, None, :])
        new_caches = []
        for layer, layer_cache in zip(self.layers(), cache):
            x, nc = layer(x, None, memory, mem_bias, layer_cache, pos)
            new_caches.append(nc)
        logits = self.out_proj(self.final_norm(x))[:, 0]
        return torch.log_softmax(logits.float(), dim=-1), new_caches

