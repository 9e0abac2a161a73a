"""HiFiGAN vocoder: generator, multi-scale and multi-period
discriminators, GAN losses (port of espnet_tpu/models/tts/hifigan.py).

Behavioral spec: reference `espnet2/gan_tts/hifigan/hifigan.py`
(`HiFiGANGenerator:21`, `HiFiGANPeriodDiscriminator:220`,
`HiFiGANScaleDiscriminator:410`, the multi variants `:357,576,658`) and
`hifigan/loss.py` (least-squares adversarial losses, feature matching, the
log-mel L1).

Every module works on channel-last (B, T, C) tensors, as the JAX modules
do, through the flax-equivalent convs of `models/layers.py`: "SAME" as
XLA pads it (strided and grouped too), flax's transposed conv (kernel not
flipped), `avg_pool` with count_include_pad. The period discriminator
reflect-pads to a multiple of the period and folds (B, T) into (B, T/p, p)
with sample index i*p + j; its 2-D convs run NCHW and its feature maps
come back as NHWC views (the JAX layout). Leaky-ReLU slope 0.1, the output
conv's 0.01. Weight norm is dropped, as in the JAX package. These are
plain PyTorch convs: the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from espnet_tpu_torch.models.layers import (ConvTranspose1d, Dense,
                                            SameConv1d, avg_pool_same,
                                            same_padding)
from espnet_tpu_torch.ops.stft import log_mel_spectrogram

LRELU = 0.1


class ResidualBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5),
                 use_additional_convs: bool = True, dtype=torch.float32):
        super().__init__()
        self.dilations = tuple(dilations)
        self.use_additional_convs = use_additional_convs
        for i, d in enumerate(self.dilations):
            self.add_module(f"conv{i}_1", SameConv1d(
                channels, channels, kernel_size, dilation=d, dtype=dtype))
            if use_additional_convs:
                self.add_module(f"conv{i}_2", SameConv1d(
                    channels, channels, kernel_size, dtype=dtype))

    def forward(self, x):
        for i in range(len(self.dilations)):
            h = getattr(self, f"conv{i}_1")(F.leaky_relu(x, LRELU))
            if self.use_additional_convs:
                h = getattr(self, f"conv{i}_2")(F.leaky_relu(h, LRELU))
            x = x + h
        return x


class HiFiGANGenerator(nn.Module):
    """(B, T_mel, in_channels) [+ g (B, global_channels)] -> (B, T_mel *
    prod(upsample_scales), 1) in [-1, 1]."""

    def __init__(self, in_channels: int = 80, channels: int = 512,
                 kernel_size: int = 7,
                 upsample_scales: Sequence[int] = (8, 8, 2, 2),
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilations: Sequence[Sequence[int]] = (
                     (1, 3, 5),) * 3,
                 global_channels: int = 0, dtype=torch.float32):
        super().__init__()
        self.upsample_scales = tuple(upsample_scales)
        self.n_blocks = len(resblock_kernel_sizes)
        self.input_conv = SameConv1d(in_channels, channels, kernel_size,
                                     dtype=dtype)
        if global_channels > 0:
            self.global_conv = Dense(global_channels, channels, bias=False,
                                     dtype=dtype)
        ch_in = channels
        for i, scale in enumerate(self.upsample_scales):
            ch = channels // (2 ** (i + 1))
            self.add_module(f"upsample{i}", ConvTranspose1d(
                ch_in, ch, 2 * scale, scale, dtype=dtype))
            for j, (k, ds) in enumerate(zip(resblock_kernel_sizes,
                                            resblock_dilations)):
                self.add_module(f"block{i}_{j}", ResidualBlock(
                    ch, k, tuple(ds), dtype=dtype))
            ch_in = ch
        self.output_conv = SameConv1d(ch_in, 1, kernel_size, dtype=dtype)

    @property
    def upsample_factor(self) -> int:
        return int(np.prod(self.upsample_scales))

    def forward(self, mel, g=None, noise=None, generator=None):
        """`noise` and `generator` are ignored: the vocoder step passes them
        to every generator, and only the noise-driven ones draw."""
        x = self.input_conv(mel)
        if g is not None:
            x = x + self.global_conv(g)[:, None]
        for i in range(len(self.upsample_scales)):
            x = getattr(self, f"upsample{i}")(F.leaky_relu(x, LRELU))
            acc = 0.0
            for j in range(self.n_blocks):
                acc = acc + getattr(self, f"block{i}_{j}")(x)
            x = acc / self.n_blocks
        x = self.output_conv(F.leaky_relu(x, 0.01))
        return torch.tanh(x)


class _PeriodConv(nn.Conv2d):
    """flax `nn.Conv(c, (k, 1), strides=(s, 1), padding="SAME")` over NCHW
    (the H axis "SAME"-padded as XLA pads it)."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1):
        super().__init__(c_in, c_out, (kernel, 1), stride=(stride, 1))

    def forward(self, x):
        top, bottom = same_padding(x.shape[2], self.kernel_size[0],
                                   self.stride[0])
        return F.conv2d(F.pad(x, (0, 0, top, bottom)), self.weight,
                        self.bias, self.stride)


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, channels: int = 32,
                 downsample_scales: Sequence[int] = (3, 3, 3, 3, 1),
                 max_channels: int = 1024):
        super().__init__()
        self.period = period
        self.n_convs = len(downsample_scales)
        ch_in, ch = 1, channels
        for i, s in enumerate(downsample_scales):
            self.add_module(f"conv{i}", _PeriodConv(ch_in, ch, kernel_size,
                                                    s))
            ch_in, ch = ch, min(ch * 4, max_channels)
        self.out_conv = _PeriodConv(ch_in, 1, 3)

    def forward(self, wav):
        """(B, T, 1) -> (score (B, T'), feature maps (B, H, p, C))."""
        b, t, _ = wav.shape
        p = self.period
        pad = (p - t % p) % p
        x = wav[..., 0]
        if pad:
            x = F.pad(x[:, None], (0, pad), mode="reflect")[:, 0]
        x = x.reshape(b, 1, -1, p)
        feats = []
        for i in range(self.n_convs):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), LRELU)
            feats.append(x.permute(0, 2, 3, 1))
        x = self.out_conv(x)
        feats.append(x.permute(0, 2, 3, 1))
        return x.reshape(b, -1), feats


class ScaleDiscriminator(nn.Module):
    def __init__(self, kernel_sizes: Sequence[int] = (15, 41, 5, 3),
                 channels: int = 128, max_channels: int = 1024,
                 max_groups: int = 16,
                 downsample_scales: Sequence[int] = (2, 2, 4, 4, 1)):
        super().__init__()
        self.n_down = len(downsample_scales)
        self.conv0 = SameConv1d(1, channels, kernel_sizes[0])
        ch, groups = channels, 4
        for i, s in enumerate(downsample_scales):
            out_ch = min(ch * 2, max_channels)
            self.add_module(f"down{i}", SameConv1d(
                ch, out_ch, kernel_sizes[1], stride=s, groups=groups))
            ch = out_ch
            groups = min(groups * 4, max_groups)
        self.conv_post1 = SameConv1d(ch, ch, kernel_sizes[2])
        self.conv_post2 = SameConv1d(ch, 1, kernel_sizes[3])

    def forward(self, wav):
        feats = []
        x = F.leaky_relu(self.conv0(wav), LRELU)
        feats.append(x)
        for i in range(self.n_down):
            x = F.leaky_relu(getattr(self, f"down{i}")(x), LRELU)
            feats.append(x)
        x = F.leaky_relu(self.conv_post1(x), LRELU)
        feats.append(x)
        x = self.conv_post2(x)
        feats.append(x)
        return x.reshape(x.shape[0], -1), feats


class HiFiGANMultiDiscriminator(nn.Module):
    """Multi-scale (3 scales, each avg-pooled from the last) plus
    multi-period (`hifigan.py:658`)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 scales: int = 3):
        super().__init__()
        self.periods, self.scales = tuple(periods), scales
        for i in range(scales):
            self.add_module(f"msd{i}", ScaleDiscriminator())
        for p in self.periods:
            self.add_module(f"mpd{p}", PeriodDiscriminator(p))

    def forward(self, wav):
        """(B, T, 1) -> [(score, feature maps)] per discriminator."""
        outs = []
        x = wav
        for i in range(self.scales):
            if i > 0:
                x = avg_pool_same(x, 4, 2)
            outs.append(getattr(self, f"msd{i}")(x))
        for p in self.periods:
            outs.append(getattr(self, f"mpd{p}")(wav))
        return outs


# --- losses (`hifigan/loss.py`) ---------------------------------------------

def generator_adversarial_loss(disc_outs) -> torch.Tensor:
    """Least squares: the mean over discriminators of mean((1 - D(fake))^2)."""
    losses = [torch.mean((1.0 - s) ** 2) for s, _ in disc_outs]
    return sum(losses) / len(losses)


def discriminator_adversarial_loss(real_outs, fake_outs):
    """(mean over discriminators of mean((1 - D(real))^2), of
    mean(D(fake)^2))."""
    real = [torch.mean((1.0 - s) ** 2) for s, _ in real_outs]
    fake = [torch.mean(s ** 2) for s, _ in fake_outs]
    return sum(real) / len(real), sum(fake) / len(fake)


def feature_match_loss(real_outs, fake_outs) -> torch.Tensor:
    """Mean over every feature map of mean |fake - real| (real detached)."""
    total, count = 0.0, 0
    for (_, rf), (_, ff) in zip(real_outs, fake_outs):
        for r, f in zip(rf, ff):
            total = total + torch.mean(torch.abs(f - r.detach()))
            count += 1
    return total / max(count, 1)


def mel_spectrogram_loss(real_wav, fake_wav, fs: int = 16000,
                         n_fft: int = 1024, hop_length: int = 256,
                         n_mels: int = 80) -> torch.Tensor:
    """L1 between the log-mels of (B, T) real and fake waves
    (`loss.py:217` MelSpectrogramLoss), the frontend's log-mel (fmin 0, no
    fmax) over every frame."""
    lens = torch.full((real_wav.shape[0],), real_wav.shape[1],
                      dtype=torch.long, device=real_wav.device)
    mr, _ = log_mel_spectrogram(real_wav, lens, fs, n_fft, hop_length, None,
                                n_mels)
    mf, _ = log_mel_spectrogram(fake_wav, lens, fs, n_fft, hop_length, None,
                                n_mels)
    return torch.mean(torch.abs(mr - mf))
