"""Transformer-TTS (port of espnet_tpu/models/tts/transformer_tts.py).

Behavioral spec: reference `espnet/nets/pytorch_backend/e2e_tts_transformer.py`:
a transformer encoder over token ids (or a projection of input frames, the
Voice Transformer Network's "linear" input for VC), the mel prenet, a
causal transformer decoder with cross attention, the frame and stop-token
projections and the postnet residual; the loss is Tacotron2's L1 + MSE +
weighted stop BCE.

The encoder layers are the port's `TransformerEncoderLayer`s (flash and the
pre-norm FFN kernels); the decoder layers its `TransformerDecoderLayer`s,
whose causal self-attention and cross attention are plain, as in JAX, and
whose FFN is plain as in every decoder of the port. Training decodes
teacher-forced in one pass; `inference` runs a loop over the decoder steps
with per-layer k/v caches (the JAX `lax.while_loop`), stopping when every
utterance has stopped: the frames of a step after that are zero, as the
while-loop never computes them, so a step runs at most 16 steps past it
and its frames are masked (one host read of the stop flags every 16
steps). The prenet's dropout is drawn in training with a generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn

from espnet_tpu_torch.models.embedding import (add_positional_encoding,
                                               sinusoidal_table)
from espnet_tpu_torch.models.layers import Dense, KernelRouted, LayerNorm
from espnet_tpu_torch.models.transformer import (TransformerDecoderLayer,
                                                 TransformerEncoderLayer)
from espnet_tpu_torch.models.tts.fastspeech2 import Postnet
from espnet_tpu_torch.models.tts.tacotron2 import spectrogram_loss
from espnet_tpu_torch.ops.dropout import bernoulli
from espnet_tpu_torch.ops.masks import (attention_bias, make_valid_mask,
                                        subsequent_mask)


@dataclasses.dataclass(frozen=True)
class TransformerTTSConfig:
    vocab_size: int = -1
    input_type: str = "text"
    input_dim: int = 80
    n_mels: int = 80
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 1024
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    prenet_units: int = 256
    prenet_layers: int = 2
    prenet_dropout: float = 0.5
    postnet_layers: int = 5
    postnet_channels: int = 256
    reduction_factor: int = 1
    bce_pos_weight: float = 5.0
    dropout_rate: float = 0.1
    max_frames: int = 1000
    stop_threshold: float = 0.5
    dtype: Any = torch.float32


class MelPrenet(nn.Module):
    """relu Dense layers on the previous frames, then a projection to
    d_model; flax's dropout rule after each layer where a generator is
    given."""

    def __init__(self, n_mels: int, units: int, layers: int, out_dim: int,
                 dropout: float = 0.5, dtype=torch.float32):
        super().__init__()
        self.layers, self.rate = layers, dropout
        for i in range(layers):
            self.add_module(f"fc{i}", Dense(n_mels if i == 0 else units,
                                            units, dtype=dtype))
        self.proj = Dense(units if layers else n_mels, out_dim, dtype=dtype)

    def forward(self, x, generator=None):
        for i in range(self.layers):
            x = torch.relu(getattr(self, f"fc{i}")(x))
            if generator is not None and self.rate > 0.0:
                keep = ~bernoulli(x.shape, self.rate, generator, x.device)
                x = torch.where(keep, x / (1.0 - self.rate),
                                torch.zeros_like(x))
        return self.proj(x)


class TransformerTTS(KernelRouted):
    def __init__(self, config: TransformerTTSConfig):
        super().__init__()
        c = self.config = config
        dt = c.dtype
        if c.input_type == "feats":
            self.in_proj = Dense(c.input_dim, c.d_model, dtype=dt)
        else:
            self.embed = nn.Embedding(c.vocab_size, c.d_model)
        for i in range(c.num_encoder_layers):
            self.add_module(f"enc{i}", TransformerEncoderLayer(
                c.d_model, c.num_heads, c.d_ff, dt, c.dropout_rate))
        self.enc_norm = LayerNorm(c.d_model, dt)
        self.prenet = MelPrenet(c.n_mels, c.prenet_units, c.prenet_layers,
                                c.d_model, c.prenet_dropout, dt)
        for i in range(c.num_decoder_layers):
            self.add_module(f"dec{i}", TransformerDecoderLayer(
                c.d_model, c.num_heads, c.d_ff, dt, c.dropout_rate))
        self.dec_norm = LayerNorm(c.d_model, dt)
        self.feat_out = Dense(c.d_model, c.n_mels * c.reduction_factor,
                              dtype=dt)
        self.prob_out = Dense(c.d_model, c.reduction_factor, dtype=dt)
        self.postnet = Postnet(c.n_mels, c.postnet_channels,
                               c.postnet_layers, dt)

    def _dec_layers(self):
        return [getattr(self, f"dec{i}")
                for i in range(self.config.num_decoder_layers)]

    def encoder(self, text, text_lengths, generator=None):
        c = self.config
        x = (self.in_proj(text) if c.input_type == "feats"
             else self.embed(text).to(c.dtype))
        x = add_positional_encoding(x)
        bias = attention_bias(
            make_valid_mask(text_lengths, text.shape[1])[:, None, None, :])
        for i in range(c.num_encoder_layers):
            x = getattr(self, f"enc{i}")(x, bias, generator)
        return self.enc_norm(x)

    def forward(self, text, text_lengths, mel, mel_lengths, generator=None):
        c = self.config
        r = c.reduction_factor
        b, t, _ = mel.shape
        n_dec = t // r
        memory = self.encoder(text, text_lengths, generator)
        teacher = torch.cat([mel.new_zeros(b, 1, c.n_mels),
                             mel[:, r - 1::r][:, :-1]], dim=1)
        prenet_gen = generator if self.training else None
        x = add_positional_encoding(self.prenet(teacher, prenet_gen))
        self_bias = attention_bias(subsequent_mask(n_dec, mel.device)
                                   [None, None])
        mem_bias = attention_bias(make_valid_mask(
            text_lengths, memory.shape[1])[:, None, None, :])
        for layer in self._dec_layers():
            x = layer(x, self_bias, memory, mem_bias, generator=generator)
        x = self.dec_norm(x)
        mel_before = self.feat_out(x).reshape(b, n_dec * r, c.n_mels)[:, :t]
        mel_post = mel_before + self.postnet(mel_before, generator)
        stop_logits = self.prob_out(x).reshape(b, n_dec * r)[:, :t]
        loss, stats = spectrogram_loss(mel_before, mel_post, stop_logits, mel,
                                       mel_lengths, c.n_mels,
                                       c.bce_pos_weight)
        stats["loss"] = loss
        return loss, stats, mel_post

    @torch.no_grad()
    def inference(self, text, text_lengths, max_frames: Optional[int] = None):
        """Autoregressive synthesis with k/v caches: (mel (B, n_dec * r,
        n_mels) zero past each length, lengths)."""
        c = self.config
        r = c.reduction_factor
        n_dec = (max_frames or c.max_frames) // r
        b = text.shape[0]
        dev = text.device
        memory = self.encoder(text, text_lengths)
        mem_bias = attention_bias(make_valid_mask(
            text_lengths, memory.shape[1])[:, None, None, :])
        h, dk = c.num_heads, c.d_model // c.num_heads
        z = memory.new_zeros(b, h, n_dec, dk)
        caches = [{"k": z, "v": z} for _ in range(c.num_decoder_layers)]
        pe = torch.from_numpy(sinusoidal_table(max(n_dec, 1), c.d_model)
                              ).to(dev)
        frames = memory.new_zeros(b, n_dec, r, c.n_mels)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        lens = torch.zeros(b, dtype=torch.long, device=dev)
        prev = memory.new_zeros(b, c.n_mels)
        scale = math.sqrt(c.d_model)
        for step in range(n_dec):
            x = self.prenet(prev[:, None])
            x = x * torch.tensor(scale, dtype=x.dtype) + \
                pe[step:step + 1][None].to(x.dtype)
            new_caches = []
            for layer, cache in zip(self._dec_layers(), caches):
                x, nc = layer(x, None, memory, mem_bias, cache=cache,
                              cache_index=step)
                new_caches.append(nc)
            caches = new_caches
            x = self.dec_norm(x)
            feat = self.feat_out(x)[:, 0].reshape(b, r, c.n_mels)
            prob = torch.sigmoid(self.prob_out(x)[:, 0].float())
            stop = (prob > c.stop_threshold).any(-1)
            # a step after every utterance stopped is one the JAX loop
            # never runs: its frames stay zero
            live = (~done.all()).to(feat.dtype)
            frames[:, step] = feat * live
            lens = torch.where(done, lens, torch.full_like(lens,
                                                           (step + 1) * r))
            done = done | stop
            prev = feat[:, -1]
            if step % 16 == 15 and bool(done.all()):
                break
        mel_before = frames.reshape(b, n_dec * r, c.n_mels)
        mel_post = mel_before + self.postnet(mel_before, None)
        lens = torch.where(lens == 0, torch.full_like(lens, n_dec * r), lens)
        mask = make_valid_mask(lens, n_dec * r)[..., None]
        return mel_post * mask.to(mel_post.dtype), lens
