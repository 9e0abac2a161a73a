"""Language models: the transformer LM and the sequential LSTM LM (port of
espnet_tpu/models/lm.py).

`TransformerLM` is pre-norm layers (`_LMLayer`: causal self-attention and
an FFN) under a final LayerNorm and an output projection. Its causal bias
sends the self-attention to the plain path (flash takes key-padding biases
only); its FFN takes the `fused_ffn` route, the JAX layer's
`PositionwiseFeedForward` under the auto rule that the port applies at every
row count. `RNNLM` is an embedding, `lstm{i}` cells (flax's
`OptimizedLSTMCell`, `models/layers.py` `LSTMCell`) and an output
projection. Both give `score_step` / `init_cache` for shallow fusion: the
transformer writes its k/v cache at `pos` through `MultiHeadAttention`'s
cache path, as the ASR decoder does; the LSTM carries (c, h) a layer.
`lm_loss` is the token-mean cross-entropy with the perplexity stats.

Dropout is flax `nn.Dropout`'s rule (`ops.dropout.Dropout`) after the
embedding and after each sub-layer, as in JAX; inside the FFN it is the
kernel's hash dropout. It is on while the module is training and the caller
passes a `torch.Generator`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from espnet_tpu_torch.models.attention import MultiHeadAttention
from espnet_tpu_torch.models.layers import (Dense, LayerNorm, LSTMCell,
                                            lstm_sequence)
from espnet_tpu_torch.models.transformer import (PositionwiseFeedForward,
                                                 TokenStack)
from espnet_tpu_torch.ops.dropout import Dropout


class _LMLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 dropout_rate: float, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(d_model, dtype)
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.ff = PositionwiseFeedForward(d_model, d_ff, "relu", dtype,
                                          dropout_rate, fused=True)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, bias, cache=None, cache_index=None, generator=None):
        h = self.norm1(x)
        new_cache = None
        if cache is not None:
            h, new_cache = self.self_attn(h, h, h, bias, cache, cache_index)
        else:
            h = self.self_attn(h, h, h, bias)
        x = x + self.dropout(h, generator)
        x = x + self.dropout(self.ff(self.norm2(x), generator), generator)
        if cache is not None:
            return x, new_cache
        return x


class TransformerLM(TokenStack):
    def __init__(self, vocab_size: int, d_model: int = 256,
                 num_heads: int = 4, d_ff: int = 1024, num_layers: int = 6,
                 dropout_rate: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        for i in range(num_layers):
            self.add_module(f"layer{i}", _LMLayer(d_model, num_heads, d_ff,
                                                  dropout_rate, dtype))
        self.final_norm = LayerNorm(d_model, dtype)
        self.out_proj = Dense(d_model, vocab_size, dtype=dtype)
        self.dropout = Dropout(dropout_rate)

    def forward(self, tokens, lengths, generator=None):
        """(B, U) -> logits (B, U, V), causal."""
        x = self._embed_sequence(tokens, generator)
        bias = self._causal_bias(lengths, tokens.shape[1])
        for layer in self.layers():
            x = layer(x, bias, generator=generator)
        return self.out_proj(self.final_norm(x))

    def score_step(self, tokens_step, pos: int, cache):
        """(N,) tokens at position `pos` -> (log-probs (N, V) float32, new
        cache)."""
        x = self._embed_step(tokens_step, pos, cache)
        new_cache = []
        for layer, lc in zip(self.layers(), cache):
            x, nc = layer(x, None, lc, pos)
            new_cache.append(nc)
        return self._step_log_probs(x), new_cache


class RNNLM(nn.Module):
    """LSTM LM (ESPnet's SequentialRNNLM)."""

    def __init__(self, vocab_size: int, d_model: int = 256,
                 num_layers: int = 2, dropout_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.d_model = d_model
        self.num_layers = num_layers
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        for i in range(num_layers):
            self.add_module(f"lstm{i}", LSTMCell(d_model, d_model, dtype))
        self.out_proj = Dense(d_model, vocab_size, dtype=dtype)
        self.dropout = Dropout(dropout_rate)

    def cells(self) -> List[LSTMCell]:
        return [getattr(self, f"lstm{i}") for i in range(self.num_layers)]

    def _embed(self, tokens):
        return nn.functional.embedding(tokens.long(),
                                       self.embed.weight.to(self.dtype))

    def init_cache(self, batch: int, max_len: int = 0, device=None):
        return [cell.zero_carry(batch, device) for cell in self.cells()]

    def forward(self, tokens, lengths, generator=None):
        h = self.dropout(self._embed(tokens), generator)
        for cell in self.cells():  # every step of the padded length, as JAX
            h, _ = lstm_sequence(cell, h)
        return self.out_proj(h)

    def score_step(self, tokens_step, pos: int, cache):
        h = self._embed(tokens_step)
        new_cache = []
        for cell, carry in zip(self.cells(), cache):
            carry = cell.step(carry, cell.input_proj(h))
            new_cache.append(carry)
            h = carry[1]
        logits = self.out_proj(h)
        return torch.log_softmax(logits.float(), dim=-1), new_cache


def lm_loss(logits, targets, valid_mask) -> Tuple[torch.Tensor,
                                                   Dict[str, torch.Tensor]]:
    """Token-mean cross-entropy and the perplexity stats (ESPnet's
    ESPnetLanguageModel.forward): (loss, {loss, ppl, nll_sum, ntokens})."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    nll = nll * valid_mask
    n = valid_mask.sum().clamp(min=1)
    loss = nll.sum() / n
    return loss, {"loss": loss, "ppl": torch.exp(loss),
                  "nll_sum": nll.sum(), "ntokens": n}
