"""WaveNet vocoder: a mu-law autoregressive waveform model (port of
espnet_tpu/models/tts/wavenet.py).

Behavioral spec: reference `espnet/nets/pytorch_backend/wavenet.py`: a
256-way mu-law classifier over a causal dilated residual conv stack with
gated tanh/sigmoid units, local conditioning on the mel (nearest frame),
skip connections into a two-conv output head. Teacher-forced training is
one parallel causal-conv pass; `generate` samples one step at a time with
a buffer of (k-1)*d past inputs per layer (the reference's fast
generation). Sampling draws from a torch generator, or takes the uniform
draws that a Gumbel-max sample needs as `uniforms=` (JAX's
`jax.random.categorical` is argmax(logits + Gumbel(u))). Plain PyTorch:
the JAX package has no Pallas kernel here, and neither package has a task
or CLI for this model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from espnet_tpu_torch.models.layers import SameConv1d


def mulaw_encode(x: torch.Tensor, channels: int = 256) -> torch.Tensor:
    """[-1, 1] float -> int ids."""
    mu = channels - 1
    y = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / np.log1p(mu)
    return ((y + 1.0) / 2.0 * mu + 0.5).to(torch.int32)


def mulaw_decode(ids: torch.Tensor, channels: int = 256) -> torch.Tensor:
    """int ids -> [-1, 1] float."""
    mu = channels - 1
    y = 2.0 * ids.float() / mu - 1.0
    return torch.sign(y) * ((1.0 + mu) ** torch.abs(y) - 1.0) / mu


@dataclasses.dataclass(frozen=True)
class WaveNetConfig:
    quantize: int = 256
    residual_channels: int = 64
    skip_channels: int = 64
    aux_channels: int = 80
    kernel_size: int = 2
    dilation_depth: int = 8
    dilation_repeat: int = 2
    hop_length: int = 256
    dtype: object = torch.float32

    @property
    def dilations(self) -> Tuple[int, ...]:
        return tuple(2 ** d for _ in range(self.dilation_repeat)
                     for d in range(self.dilation_depth))

    @property
    def receptive_field(self) -> int:
        return sum((self.kernel_size - 1) * d for d in self.dilations) + 1


class WaveNet(nn.Module):
    def __init__(self, config: WaveNetConfig):
        super().__init__()
        c = self.config = config
        dt = c.dtype
        self.input_conv = SameConv1d(c.quantize, c.residual_channels, 1,
                                     dtype=dt)
        for i, d in enumerate(c.dilations):
            self.add_module(f"dil{i}", SameConv1d(
                c.residual_channels, 2 * c.residual_channels, c.kernel_size,
                dilation=d, padding="VALID", dtype=dt))
            self.add_module(f"aux{i}", SameConv1d(
                c.aux_channels, 2 * c.residual_channels, 1, dtype=dt))
            self.add_module(f"res{i}", SameConv1d(
                c.residual_channels, c.residual_channels, 1, dtype=dt))
            self.add_module(f"skip{i}", SameConv1d(
                c.residual_channels, c.skip_channels, 1, dtype=dt))
        self.out1 = SameConv1d(c.skip_channels, c.skip_channels, 1, dtype=dt)
        self.out2 = SameConv1d(c.skip_channels, c.quantize, 1, dtype=dt)

    def _upsample(self, mel, n_samples):
        """(B, T_mel, M) -> (B, n, M), the nearest earlier frame."""
        idx = torch.clamp(torch.arange(n_samples, device=mel.device)
                          // self.config.hop_length, max=mel.shape[1] - 1)
        return mel[:, idx]

    def _layers(self):
        return [(getattr(self, f"dil{i}"), getattr(self, f"aux{i}"),
                 getattr(self, f"res{i}"), getattr(self, f"skip{i}"), d)
                for i, d in enumerate(self.config.dilations)]

    def _head(self, skip_sum):
        return self.out2(torch.relu(self.out1(torch.relu(skip_sum))))

    def forward(self, wav_ids, mel):
        """Teacher-forced logits (B, N, Q) predicting wav_ids[t] from the
        ids before t; wav_ids (B, N), mel (B, T_mel, M)."""
        c = self.config
        b, n = wav_ids.shape
        x_prev = torch.cat([torch.full((b, 1), c.quantize // 2,
                                       dtype=wav_ids.dtype,
                                       device=wav_ids.device),
                            wav_ids[:, :-1]], dim=1)
        x = self.input_conv(F.one_hot(x_prev.long(), c.quantize).float())
        aux = self._upsample(mel, n)
        skip_sum = 0.0
        for conv, aconv, rconv, sconv, d in self._layers():
            pad = (c.kernel_size - 1) * d
            h = conv(F.pad(x, (0, 0, pad, 0))) + aconv(aux)
            a, g = h.chunk(2, dim=-1)
            z = torch.tanh(a) * torch.sigmoid(g)
            x = x + rconv(z)
            skip_sum = skip_sum + sconv(z)
        return self._head(skip_sum)

    def loss(self, wav, mel, lengths):
        """Masked cross entropy over the mu-law targets; wav in [-1, 1]."""
        c = self.config
        ids = mulaw_encode(torch.clamp(wav, -1.0, 1.0), c.quantize)
        logits = self(ids, mel)
        logp = torch.log_softmax(logits.float(), -1)
        nll = -logp.gather(-1, ids.long()[..., None])[..., 0]
        mask = (torch.arange(wav.shape[1], device=wav.device)[None, :]
                < lengths[:, None]).float()
        denom = mask.sum().clamp(min=1.0)
        loss = (nll * mask).sum() / denom
        acc = ((logits.argmax(-1) == ids.long()).float() * mask).sum() / denom
        return loss, {"loss": loss, "acc": acc}

    @torch.no_grad()
    def generate(self, mel, n_samples: int,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0,
                 uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sample n_samples (B, n) waveform values, one step at a time.
        Step t draws argmax(logits / temperature + Gumbel), the Gumbel
        noise -log(-log(u)) from `uniforms[t]` (B, Q) when given, else from
        `generator`."""
        c = self.config
        b = mel.shape[0]
        aux_all = self._upsample(mel, n_samples)
        k = c.kernel_size
        layers = self._layers()
        bufs = [mel.new_zeros(b, (k - 1) * d, c.residual_channels)
                for d in c.dilations]
        prev = torch.full((b,), c.quantize // 2, dtype=torch.long,
                          device=mel.device)
        tiny = torch.finfo(torch.float32).tiny
        out = []
        for t in range(n_samples):
            x = self.input_conv(F.one_hot(prev, c.quantize).float()[:, None])
            aux = aux_all[:, t:t + 1]
            skip_sum = 0.0
            for li, (conv, aconv, rconv, sconv, _) in enumerate(layers):
                buf = bufs[li]
                h = conv(torch.cat([buf, x], dim=1)) + aconv(aux)
                a, g = h.chunk(2, dim=-1)
                z = torch.tanh(a) * torch.sigmoid(g)
                if buf.shape[1] > 0:
                    bufs[li] = torch.cat([buf[:, 1:], x], dim=1)
                x = x + rconv(z)
                skip_sum = skip_sum + sconv(z)
            logits = self._head(skip_sum)[:, 0].float() / temperature
            if uniforms is not None:
                u = uniforms[t].to(logits.device).float()
            else:
                dev = generator.device if generator is not None \
                    else logits.device
                u = torch.rand(logits.shape, generator=generator,
                               device=dev).to(logits.device)
            gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
            prev = (logits + gumbel).argmax(-1)
            out.append(prev)
        return mulaw_decode(torch.stack(out, 1), c.quantize)
