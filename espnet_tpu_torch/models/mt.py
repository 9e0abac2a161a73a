"""Machine translation model: token encoder -> attention decoder (port of
espnet_tpu/models/mt.py).

Behavioral spec: reference `espnet2/mt/espnet_model.py` (ESPnetMTModel).
`MTEncoder` embeds the source tokens, adds the sinusoidal positions (scaled
by sqrt(d_model), `models/embedding.py`), drops out, runs the transformer
encoder layers of `models/transformer.py` under the key-padding bias (their
self-attention through the flash kernel, their FFN through the pre-norm FFN
kernels, relu, residual scale 1, on the card) and ends in `after_norm`.
`MTModel` decodes with the port's `TransformerDecoder` and trains with
the label-smoothed loss and the token accuracy; sos = eos = vocab_size - 1.
Parameter names are the JAX model's, so `convert.py` carries its trees
both ways. The JAX encoder layers send self-attention below 512 frames
and FFNs below 4096 rows to plain XLA; the port takes its kernels at every
shape (ROADMAP.md "Time budgets"), so the two round differently.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from espnet_tpu_torch.models.asr import add_sos_eos
from espnet_tpu_torch.models.embedding import add_positional_encoding
from espnet_tpu_torch.models.layers import KernelRouted, LayerNorm
from espnet_tpu_torch.models.transformer import (TransformerDecoder,
                                                 TransformerEncoderLayer)
from espnet_tpu_torch.ops.dropout import FastDropout
from espnet_tpu_torch.ops.losses import label_smoothing_loss, token_accuracy
from espnet_tpu_torch.ops.masks import attention_bias, make_valid_mask


@dataclasses.dataclass(frozen=True)
class MTConfig:
    """The JAX `MTConfig`: its fields and defaults, `dtype` a torch
    dtype (the compute dtype; parameters are float32)."""

    vocab_size: int = -1           # target vocab
    src_vocab_size: int = -1       # source vocab
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 2048
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    decoder_d_ff: int = 2048
    lsm_weight: float = 0.1
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.float32

    @property
    def sos_id(self) -> int:
        return self.vocab_size - 1

    @property
    def eos_id(self) -> int:
        return self.vocab_size - 1


class MTEncoder(nn.Module):
    """Token-embedding transformer encoder (`mt/espnet_model.py`'s
    frontend and encoder)."""

    def __init__(self, vocab_size: int, d_model: int, num_heads: int,
                 d_ff: int, num_layers: int, dropout_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        self.dropout = FastDropout(dropout_rate)
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                d_model, num_heads, d_ff, dtype, dropout_rate))
        self.after_norm = LayerNorm(d_model, dtype)

    def layers(self):
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def forward(self, tokens, lengths, generator=None):
        """(B, L) source ids, (B,) lengths -> ((B, L, D), lengths)."""
        x = nn.functional.embedding(tokens.long(),
                                    self.embed.weight.to(self.dtype))
        x = self.dropout(add_positional_encoding(x), generator)
        bias = attention_bias(
            make_valid_mask(lengths, tokens.shape[1])[:, None, None, :])
        for layer in self.layers():
            x = layer(x, bias, generator)
        return self.after_norm(x), lengths


class MTModel(KernelRouted):
    """Source tokens -> `MTEncoder` -> `TransformerDecoder` over the
    target vocabulary."""

    def __init__(self, config: MTConfig):
        super().__init__()
        c = config
        self.config = c
        self.encoder = MTEncoder(c.src_vocab_size, c.d_model, c.num_heads,
                                 c.d_ff, c.num_encoder_layers,
                                 c.dropout_rate, c.dtype)
        self.decoder = TransformerDecoder(
            c.vocab_size, c.d_model, c.num_heads, c.decoder_d_ff,
            c.num_decoder_layers, c.dtype, c.dropout_rate)

    def encode(self, src_text, src_text_lengths, generator=None):
        return self.encoder(src_text, src_text_lengths, generator)

    def decoder_score_step(self, tokens_step, pos, memory, memory_lengths,
                           cache):
        return self.decoder.score_step(tokens_step, pos, memory,
                                       memory_lengths, cache)

    def decoder_init_cache(self, batch, max_len, memory=None,
                           memory_lengths=None):
        device = (memory.device if memory is not None
                  else next(self.parameters()).device)
        return self.decoder.init_cache(batch, max_len, device=device)

    def forward(self, src_text, src_text_lengths, text, text_lengths,
                generator=None) -> Tuple[torch.Tensor,
                                         Dict[str, torch.Tensor]]:
        """(loss, {loss, acc}). In training mode with dropout `generator`
        is required and drives every dropout."""
        c = self.config
        if self.training and generator is None and c.dropout_rate > 0.0:
            raise ValueError("training with dropout needs a torch.Generator")
        enc, enc_lengths = self.encode(src_text, src_text_lengths, generator)
        ys_in, ys_out, olens = add_sos_eos(text.long(), text_lengths.long(),
                                           c.sos_id, c.eos_id)
        logits = self.decoder(ys_in, olens, enc, enc_lengths, generator)
        valid = make_valid_mask(olens, ys_in.shape[1])
        loss = label_smoothing_loss(logits, ys_out, valid, c.lsm_weight)
        acc = token_accuracy(logits, ys_out, valid)
        return loss, {"loss": loss, "acc": acc}
