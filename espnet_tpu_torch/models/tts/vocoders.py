"""GAN vocoders: MelGAN and multi-band MelGAN, Parallel WaveGAN,
StyleMelGAN, the multi-resolution STFT loss (port of
espnet_tpu/models/tts/vocoders.py).

Behavioral spec: reference `espnet2/gan_tts/melgan/melgan.py`,
`espnet2/gan_tts/parallel_wavegan/parallel_wavegan.py` and
`espnet2/gan_tts/style_melgan/style_melgan.py`, as the JAX package
formulates them. Channel-last (B, T, C) throughout; leaky-ReLU slope 0.2.
Every generator maps a mel (B, T_mel, n_mels) to (B, T_mel *
upsample_factor, 1). The noise-driven ones (Parallel WaveGAN,
StyleMelGAN) take their latent as `noise=` (the JAX modules draw it from
the "noise" rng collection) or draw it from `generator`. Multi-band
MelGAN is MelGAN with out_channels 4 and PQMF synthesis; the StyleMelGAN
discriminator runs PQMF analysis over evenly spaced windows. Plain
PyTorch: the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from espnet_tpu_torch.models.layers import (ConvTranspose1d, SameConv1d,
                                            avg_pool_same)
from espnet_tpu_torch.ops.pqmf import pqmf_analysis, pqmf_synthesis
from espnet_tpu_torch.ops.stft import stft

LRELU = 0.2


def _noise(shape, like, noise, generator):
    """The injected latent, or N(0, 1) drawn from `generator`."""
    if noise is None:
        dev = generator.device if generator is not None else like.device
        noise = torch.randn(shape, generator=generator, device=dev)
    return noise.to(like.device, like.dtype)


# ---------------------------------------------------------------- MelGAN --

class MelGANResidualStack(nn.Module):
    """leaky_relu -> dilated conv(k) -> leaky_relu -> 1x1, plus a 1x1 skip."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv1 = SameConv1d(channels, channels, kernel_size,
                                dilation=dilation, dtype=dtype)
        self.conv2 = SameConv1d(channels, channels, 1, dtype=dtype)
        self.skip = SameConv1d(channels, channels, 1, dtype=dtype)

    def forward(self, x):
        h = self.conv1(F.leaky_relu(x, LRELU))
        h = self.conv2(F.leaky_relu(h, LRELU))
        return h + self.skip(x)


class MelGANGenerator(nn.Module):
    def __init__(self, in_channels: int = 80, out_channels: int = 1,
                 channels: int = 512, kernel_size: int = 7,
                 upsample_scales: Sequence[int] = (8, 8, 2, 2),
                 stacks: int = 3, dtype=torch.float32):
        super().__init__()
        self.out_channels = out_channels
        self.upsample_scales = tuple(upsample_scales)
        self.stacks = stacks
        self.input_conv = SameConv1d(in_channels, channels, kernel_size,
                                     dtype=dtype)
        ch = channels
        for i, scale in enumerate(self.upsample_scales):
            self.add_module(f"upsample{i}", ConvTranspose1d(
                ch, ch // 2, 2 * scale, scale, dtype=dtype))
            ch //= 2
            for j in range(stacks):
                self.add_module(f"stack{i}_{j}", MelGANResidualStack(
                    ch, 3, 3 ** j, dtype))
        self.output_conv = SameConv1d(ch, out_channels, kernel_size,
                                      dtype=dtype)

    @property
    def upsample_factor(self) -> int:
        return int(np.prod(self.upsample_scales)) * (
            self.out_channels if self.out_channels > 1 else 1)

    def forward(self, mel, noise=None, generator=None):
        x = self.input_conv(mel)
        for i in range(len(self.upsample_scales)):
            x = getattr(self, f"upsample{i}")(F.leaky_relu(x, LRELU))
            for j in range(self.stacks):
                x = getattr(self, f"stack{i}_{j}")(x)
        x = torch.tanh(self.output_conv(F.leaky_relu(x, LRELU)))
        if self.out_channels > 1:
            x = pqmf_synthesis(x, self.out_channels)[:, :, None]
        return x


class MelGANDiscriminator(nn.Module):
    """One scale of `melgan.py:MelGANDiscriminator`."""

    def __init__(self, channels: int = 16, max_channels: int = 1024,
                 downsample_scales: Sequence[int] = (4, 4, 4, 4),
                 in_channels: int = 1):
        super().__init__()
        self.downsample_scales = tuple(downsample_scales)
        self.conv0 = SameConv1d(in_channels, channels, 15)
        ch, groups = channels, 4
        for i, s in enumerate(self.downsample_scales):
            out_ch = min(ch * s, max_channels)
            self.add_module(f"down{i}", SameConv1d(
                ch, out_ch, s * 10 + 1, stride=s, groups=groups))
            ch = out_ch
            groups = min(groups * 4, 256)
        self.post1 = SameConv1d(ch, min(ch * 2, max_channels), 5)
        self.post2 = SameConv1d(min(ch * 2, max_channels), 1, 3)

    def forward(self, wav):
        feats = []
        x = F.leaky_relu(self.conv0(wav), LRELU)
        feats.append(x)
        for i in range(len(self.downsample_scales)):
            x = F.leaky_relu(getattr(self, f"down{i}")(x), LRELU)
            feats.append(x)
        x = F.leaky_relu(self.post1(x), LRELU)
        feats.append(x)
        x = self.post2(x)
        feats.append(x)
        return x.reshape(x.shape[0], -1), feats


class MelGANMultiScaleDiscriminator(nn.Module):
    def __init__(self, scales: int = 3, channels: int = 16):
        super().__init__()
        self.scales = scales
        for i in range(scales):
            self.add_module(f"disc{i}", MelGANDiscriminator(channels))

    def forward(self, wav):
        outs = []
        x = wav
        for i in range(self.scales):
            if i > 0:
                x = avg_pool_same(x, 4, 2)
            outs.append(getattr(self, f"disc{i}")(x))
        return outs


# ------------------------------------------------------- ParallelWaveGAN --

class _UpsampleNet(nn.Module):
    """Mel (B, T_mel, M) -> (B, T_mel * prod(scales), M): a transposed conv
    and a leaky ReLU per scale."""

    def __init__(self, scales: Sequence[int], channels: int,
                 dtype=torch.float32):
        super().__init__()
        self.scales = tuple(scales)
        for i, s in enumerate(self.scales):
            self.add_module(f"up{i}", ConvTranspose1d(channels, channels,
                                                      2 * s, s, dtype=dtype))

    def forward(self, c):
        for i in range(len(self.scales)):
            c = F.leaky_relu(getattr(self, f"up{i}")(c), LRELU)
        return c


class ParallelWaveGANGenerator(nn.Module):
    """Noise-driven non-causal WaveNet on the upsampled mel."""

    def __init__(self, in_channels: int = 80, layers: int = 30,
                 stacks: int = 3, residual_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64,
                 kernel_size: int = 3,
                 upsample_scales: Sequence[int] = (8, 8, 2, 2),
                 dtype=torch.float32):
        super().__init__()
        self.layers, self.stacks = layers, stacks
        self.upsample_scales = tuple(upsample_scales)
        self.half = gate_channels // 2
        self.upsample_net = _UpsampleNet(upsample_scales, in_channels, dtype)
        self.first_conv = SameConv1d(1, residual_channels, 1, dtype=dtype)
        per_stack = layers // stacks
        for i in range(layers):
            self.add_module(f"conv{i}", SameConv1d(
                residual_channels, gate_channels, kernel_size,
                dilation=2 ** (i % per_stack), dtype=dtype))
            self.add_module(f"cond{i}", SameConv1d(
                in_channels, gate_channels, 1, bias=False, dtype=dtype))
            self.add_module(f"res{i}", SameConv1d(
                self.half, residual_channels, 1, dtype=dtype))
            self.add_module(f"skip{i}", SameConv1d(
                self.half, skip_channels, 1, dtype=dtype))
        self.post1 = SameConv1d(skip_channels, skip_channels, 1, dtype=dtype)
        self.post2 = SameConv1d(skip_channels, 1, 1, dtype=dtype)

    @property
    def upsample_factor(self) -> int:
        return int(np.prod(self.upsample_scales))

    def forward(self, mel, noise=None, generator=None):
        """`noise` (B, T_mel * upsample_factor, 1), else N(0, 1) from
        `generator`."""
        b, t_mel, _ = mel.shape
        z = _noise((b, t_mel * self.upsample_factor, 1), mel, noise,
                   generator)
        c = self.upsample_net(mel)
        x = self.first_conv(z)
        skips = 0.0
        for i in range(self.layers):
            h = getattr(self, f"conv{i}")(x) + getattr(self, f"cond{i}")(c)
            gated = torch.tanh(h[..., :self.half]) * torch.sigmoid(
                h[..., self.half:])
            x = (x + getattr(self, f"res{i}")(gated)) * (0.5 ** 0.5)
            skips = skips + getattr(self, f"skip{i}")(gated)
        x = torch.relu(skips * (1.0 / self.layers ** 0.5))
        x = torch.relu(self.post1(x))
        return torch.tanh(self.post2(x))


class ParallelWaveGANDiscriminator(nn.Module):
    """Dilated conv stack -> a score per sample."""

    def __init__(self, layers: int = 10, channels: int = 64,
                 kernel_size: int = 3):
        super().__init__()
        self.layers = layers
        ch_in = 1
        for i in range(layers - 1):
            self.add_module(f"conv{i}", SameConv1d(
                ch_in, channels, kernel_size, dilation=max(1, i)))
            ch_in = channels
        self.out = SameConv1d(ch_in, 1, kernel_size)

    def forward(self, wav):
        feats = []
        x = wav
        for i in range(self.layers - 1):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), LRELU)
            feats.append(x)
        x = self.out(x)
        feats.append(x)
        return [(x.reshape(x.shape[0], -1), feats)]


# ----------------------------------------------------------- StyleMelGAN --

class TADELayer(nn.Module):
    """Instance-normalise x over time, then modulate it with (gamma, beta)
    convs of the condition resized (nearest) to x's length."""

    def __init__(self, channels: int, aux_channels: int = 80,
                 kernel_size: int = 9, dtype=torch.float32):
        super().__init__()
        self.cond_conv = SameConv1d(aux_channels, channels, kernel_size,
                                    dtype=dtype)
        self.gamma = SameConv1d(channels, channels, kernel_size, dtype=dtype)
        self.beta = SameConv1d(channels, channels, kernel_size, dtype=dtype)

    def forward(self, x, c):
        mean = x.mean(1, keepdim=True)
        var = ((x - mean) ** 2).mean(1, keepdim=True)
        xn = (x - mean) * torch.rsqrt(var + 1e-5)
        t = x.shape[1]
        idx = torch.arange(t, device=x.device) * c.shape[1] // t
        cr = self.cond_conv(c[:, idx])
        return xn * self.gamma(cr) + self.beta(cr), cr


class TADEResBlock(nn.Module):
    def __init__(self, channels: int, aux_channels: int = 80,
                 kernel_size: int = 9, dilation: int = 2, upsample: int = 2,
                 dtype=torch.float32):
        super().__init__()
        self.upsample = upsample
        self.tade1 = TADELayer(channels, aux_channels, kernel_size, dtype)
        self.gated1a = SameConv1d(channels, channels, kernel_size,
                                  dtype=dtype)
        self.gated1b = SameConv1d(channels, channels, kernel_size,
                                  dtype=dtype)
        self.tade2 = TADELayer(channels, aux_channels, kernel_size, dtype)
        self.gated2a = SameConv1d(channels, channels, kernel_size,
                                  dilation=dilation, dtype=dtype)
        self.gated2b = SameConv1d(channels, channels, kernel_size,
                                  dilation=dilation, dtype=dtype)

    def forward(self, x, c):
        h, _ = self.tade1(x, c)
        h = torch.tanh(self.gated1a(h)) * torch.sigmoid(self.gated1b(h))
        if self.upsample > 1:
            h = h.repeat_interleave(self.upsample, dim=1)
            x = x.repeat_interleave(self.upsample, dim=1)
        h2, _ = self.tade2(h, c)
        h2 = torch.tanh(self.gated2a(h2)) * torch.sigmoid(self.gated2b(h2))
        return x + h2


class StyleMelGANGenerator(nn.Module):
    """A (B, T_mel, noise_dim) latent, upsampled by TADE residual blocks
    modulated with the mel up to the audio rate."""

    def __init__(self, aux_channels: int = 80, channels: int = 64,
                 noise_dim: int = 128, kernel_size: int = 9,
                 block_upsamples: Sequence[int] = (2,) * 8,
                 dtype=torch.float32):
        super().__init__()
        self.noise_dim = noise_dim
        self.block_upsamples = tuple(block_upsamples)
        self.in_conv = SameConv1d(noise_dim, channels, kernel_size,
                                  dtype=dtype)
        for i, up in enumerate(self.block_upsamples):
            self.add_module(f"block{i}", TADEResBlock(
                channels, aux_channels, kernel_size, 2, up, dtype))
        self.out_conv = SameConv1d(channels, 1, kernel_size, dtype=dtype)

    @property
    def upsample_factor(self) -> int:
        return int(np.prod(self.block_upsamples))

    def forward(self, mel, noise=None, generator=None):
        """`noise` (B, T_mel, noise_dim), else N(0, 1) from `generator`."""
        b, t_mel, _ = mel.shape
        z = _noise((b, t_mel, self.noise_dim), mel, noise, generator)
        x = self.in_conv(z)
        for i in range(len(self.block_upsamples)):
            x = getattr(self, f"block{i}")(x, mel)
        x = self.out_conv(F.leaky_relu(x, LRELU))
        return torch.tanh(x)


class StyleMelGANDiscriminator(nn.Module):
    """PQMF multi-band analysis over `repeats` evenly spaced windows per
    window size, one base discriminator per size shared across repeats."""

    def __init__(self, repeats: int = 2,
                 window_sizes: Sequence[int] = (512, 1024, 2048, 4096),
                 pqmf_bands: Sequence[int] = (1, 2, 4, 8)):
        super().__init__()
        self.repeats = repeats
        self.window_sizes = tuple(window_sizes)
        self.pqmf_bands = tuple(pqmf_bands)
        for wi, bands in enumerate(self.pqmf_bands):
            self.add_module(f"disc{wi}", MelGANDiscriminator(
                16, downsample_scales=(4, 4, 4), in_channels=bands))

    def forward(self, wav):
        t = wav.shape[1]
        outs = []
        for r in range(self.repeats):
            for wi, (win, bands) in enumerate(zip(self.window_sizes,
                                                  self.pqmf_bands)):
                win = min(win, t)
                start = (r * max(t - win, 0)) // max(self.repeats - 1, 1)
                x = wav[:, start:start + win]
                if bands > 1:
                    x = pqmf_analysis(x[..., 0], bands, taps=62)
                outs.append(getattr(self, f"disc{wi}")(x))
        return outs


# ------------------------------------------------ multi-resolution STFT --

def stft_loss(x, y, n_fft: int, hop: int, win: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spectral convergence, log-magnitude L1) at one resolution."""
    def mag(w):
        r, i = stft(w, n_fft, hop, win)
        return torch.sqrt((r * r + i * i).clamp(min=1e-7))

    mx, my = mag(x), mag(y)
    sc = torch.linalg.norm(my - mx) / torch.linalg.norm(my).clamp(min=1e-7)
    lm = torch.mean(torch.abs(torch.log(my) - torch.log(mx)))
    return sc, lm


def multi_resolution_stft_loss(
        x, y, resolutions: Sequence[Tuple[int, int, int]] = (
            (1024, 120, 600), (2048, 240, 1200), (512, 50, 240))
) -> torch.Tensor:
    """Mean over resolutions of sc + log-magnitude L1; x generated, y the
    ground truth, both (B, N)."""
    total = 0.0
    for n_fft, hop, win in resolutions:
        sc, lm = stft_loss(x, y, n_fft, hop, win)
        total = total + sc + lm
    return total / len(resolutions)
