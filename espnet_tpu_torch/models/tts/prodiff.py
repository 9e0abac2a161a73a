"""ProDiff (port of espnet_tpu/models/tts/prodiff.py).

Behavioral spec: reference `espnet2/tts/prodiff/`: a FastSpeech2-style
encoder and variance adaptor give the condition, `SpectrogramDenoiser` (a
WaveNet-like gated residual stack with a diffusion-step embedding)
predicts the clean mel x0, and a few-step (4) DDPM schedule runs at
inference. Training draws one timestep per utterance and the noise; the
loss is the masked L1 of x0 plus FastSpeech2's variance losses.

The encoder's layers are the port's `TransformerEncoderLayer`s (flash at
head dim 128 for 256 wide and 2 heads, and the pre-norm FFN kernels), with
the vanilla x * sqrt(d) + PE positions. The JAX model draws the timestep,
the noise and the sampling noise from its 'diffusion' rng; the port draws
them from the caller's generator, or takes them as given (`t=`, `noise=`
in training, `noise=` a list of the draws at inference: the initial x and
one per step but the last), which the tests use.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from espnet_tpu_torch.models.layers import Conv1d, Dense, KernelRouted
from espnet_tpu_torch.models.tts.fastspeech2 import (FFTBlockStack,
                                                     VarianceAdaptorMixin,
                                                     length_regulate,
                                                     masked_l1,
                                                     variance_losses)
from espnet_tpu_torch.ops.masks import make_valid_mask


def _mish(x):
    return x * torch.tanh(F.softplus(x))


class DiffusionStepEmbedding(nn.Module):
    """Sinusoidal step embedding + a mish MLP (dim -> 4 dim -> dim)."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.fc1 = Dense(dim, 4 * dim, dtype=dtype)
        self.fc2 = Dense(4 * dim, dim, dtype=dtype)

    def forward(self, t):
        half = self.dim // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(
            half, dtype=torch.float32, device=t.device) / half)
        arg = t.float()[:, None] * freqs[None, :]
        emb = torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)
        return self.fc2(_mish(self.fc1(emb)))


class DenoiserResBlock(nn.Module):
    """Gated dilated conv block with the condition and the step injected."""

    def __init__(self, channels: int, cond_dim: int, kernel: int = 3,
                 dilation: int = 1, dtype=torch.float32):
        super().__init__()
        self.step_proj = Dense(channels, channels, dtype=dtype)
        self.conv = Conv1d(channels, 2 * channels, kernel, dtype=dtype,
                           dilation=dilation)
        self.cond_proj = Conv1d(cond_dim, 2 * channels, 1, dtype=dtype)
        self.res = Conv1d(channels, channels, 1, dtype=dtype)
        self.skip = Conv1d(channels, channels, 1, dtype=dtype)

    def forward(self, x, cond, step_emb):
        h = x + self.step_proj(step_emb)[:, None, :]
        h = self.conv(h) + self.cond_proj(cond)
        a, b = h.chunk(2, dim=-1)
        h = torch.tanh(a) * torch.sigmoid(b)
        return (x + self.res(h)) * (0.5 ** 0.5), self.skip(h)


class SpectrogramDenoiser(nn.Module):
    """x_t (B, T, M), condition (B, T, D), step (B,) -> x0 (B, T, M)."""

    def __init__(self, n_mels: int, cond_dim: int, channels: int = 256,
                 layers: int = 20, cycle: int = 4, dtype=torch.float32):
        super().__init__()
        self.layers = layers
        self.step_emb = DiffusionStepEmbedding(channels, dtype)
        self.in_proj = Conv1d(n_mels, channels, 1, dtype=dtype)
        for i in range(layers):
            self.add_module(f"block{i}", DenoiserResBlock(
                channels, cond_dim, 3, 2 ** (i % cycle), dtype))
        self.post1 = Conv1d(channels, channels, 1, dtype=dtype)
        self.post2 = Conv1d(channels, n_mels, 1, dtype=dtype)

    def forward(self, x_t, cond, t):
        emb = self.step_emb(t)
        h = torch.relu(self.in_proj(x_t))
        skips = 0.0
        for i in range(self.layers):
            h, skip = getattr(self, f"block{i}")(h, cond, emb)
            skips = skips + skip
        h = skips * (1.0 / self.layers ** 0.5)
        return self.post2(torch.relu(self.post1(h)))


def diffusion_schedule(timesteps: int, beta_min: float = 1e-4,
                       beta_max: float = 0.06):
    """Linear beta schedule (DDPM), numpy float32 constants."""
    betas = np.linspace(beta_min, beta_max, timesteps, dtype=np.float64)
    ac = np.cumprod(1.0 - betas)
    ac_prev = np.concatenate([[1.0], ac[:-1]])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    return {"betas": betas.astype(np.float32),
            "alphas_cumprod": ac.astype(np.float32),
            "alphas_cumprod_prev": ac_prev.astype(np.float32),
            "posterior_variance": post_var.astype(np.float32)}


@dataclasses.dataclass(frozen=True)
class ProDiffConfig:
    vocab_size: int = -1
    n_mels: int = 80
    d_model: int = 256
    num_heads: int = 2
    d_ff: int = 1024
    encoder_layers: int = 4
    predictor_layers: int = 2
    predictor_channels: int = 256
    predictor_kernel: int = 3
    denoiser_channels: int = 256
    denoiser_layers: int = 20
    timesteps: int = 4
    dropout_rate: float = 0.1
    max_frames: int = 2048
    dtype: Any = torch.float32


def _normal(shape, generator, device):
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    return torch.randn(tuple(shape), generator=gen,
                       device=gen.device).to(device)


class ProDiff(KernelRouted, VarianceAdaptorMixin):
    def __init__(self, config: ProDiffConfig):
        super().__init__()
        c = self.config = config
        self.embed = nn.Embedding(c.vocab_size, c.d_model)
        self.encoder = FFTBlockStack(c.d_model, c.num_heads, c.d_ff,
                                     c.encoder_layers, c.dropout_rate,
                                     c.dtype)
        self._build_variance(c)
        self.denoiser = SpectrogramDenoiser(c.n_mels, c.d_model,
                                            c.denoiser_channels,
                                            c.denoiser_layers, dtype=c.dtype)
        self.sched = diffusion_schedule(c.timesteps)

    def _condition(self, text, text_lengths, generator):
        hs = self.encoder(self.embed(text).to(self.config.dtype),
                          text_lengths, generator)
        return (hs,) + self._variance(hs, text_lengths, generator)

    def forward(self, text, text_lengths, mel, mel_lengths, durations,
                pitch, energy, generator=None, t=None, noise=None):
        """(loss, stats, x0_hat); the timestep t (B,) and the noise (B, T,
        M) come from `generator` unless given."""
        c = self.config
        hs, d_pred, p_pred, e_pred, tmask = self._condition(
            text, text_lengths, generator)
        hs = self._add_variance(hs, pitch, energy)
        t_max = mel.shape[1]
        cond, _ = length_regulate(hs, durations, t_max)
        b = mel.shape[0]
        if t is None:
            gen = generator if generator is not None \
                else torch.Generator().manual_seed(0)
            t = torch.randint(0, c.timesteps, (b,), generator=gen,
                              device=gen.device)
        t = t.to(mel.device)
        if noise is None:
            noise = _normal(mel.shape, generator, mel.device)
        ac = torch.from_numpy(self.sched["alphas_cumprod"]).to(
            mel.device)[t.long()]
        x_t = (torch.sqrt(ac)[:, None, None] * mel
               + torch.sqrt(1.0 - ac)[:, None, None] * noise.to(mel.dtype))
        x0_hat = self.denoiser(x_t, cond, t)
        fmask = make_valid_mask(mel_lengths, t_max)[..., None].float()
        l1 = masked_l1(x0_hat, mel, fmask, c.n_mels)
        dur_loss, pitch_loss, energy_loss = variance_losses(
            d_pred, p_pred, e_pred, durations, pitch, energy, tmask)
        loss = l1 + dur_loss + pitch_loss + energy_loss
        stats = {"loss": loss, "l1_loss": l1, "duration_loss": dur_loss,
                 "pitch_loss": pitch_loss, "energy_loss": energy_loss}
        return loss, stats, x0_hat

    @torch.no_grad()
    def inference(self, text, text_lengths, max_frames: Optional[int] = None,
                  generator=None, noise: Optional[List] = None):
        """DDPM sampling with the x0 parameterisation over `timesteps`
        steps: (mel (B, max_frames, n_mels) zero past each length,
        lengths)."""
        c = self.config
        max_frames = max_frames or c.max_frames
        hs, d_pred, p_pred, e_pred, tmask = self._condition(
            text, text_lengths, None)
        dur = torch.round(torch.exp(d_pred.float()) - 1.0).clamp(min=0)
        dur = (dur * tmask).long()
        hs = self._add_variance(hs, p_pred, e_pred)
        cond, out_lens = length_regulate(hs, dur, max_frames)
        s = self.sched
        b = text.shape[0]
        shape = (b, max_frames, c.n_mels)
        draws = list(noise) if noise is not None else [
            _normal(shape, generator, text.device)
            for _ in range(c.timesteps)]
        x = draws[0].to(text.device).float()
        for k, step in enumerate(range(c.timesteps - 1, -1, -1)):
            tt = torch.full((b,), step, dtype=torch.long, device=text.device)
            x0_hat = self.denoiser(x, cond, tt).float()
            ac = float(s["alphas_cumprod"][step])
            ac_prev = float(s["alphas_cumprod_prev"][step])
            beta = float(s["betas"][step])
            coef0 = beta * np.sqrt(ac_prev) / (1.0 - ac)
            coeft = (1.0 - ac_prev) * np.sqrt(1.0 - beta) / (1.0 - ac)
            mean = float(coef0) * x0_hat + float(coeft) * x
            if step > 0:
                z = draws[k + 1].to(text.device).float()
                x = mean + float(np.sqrt(s["posterior_variance"][step])) * z
            else:
                x = mean
        fmask = make_valid_mask(out_lens, max_frames)[..., None]
        return x * fmask.to(x.dtype), out_lens
