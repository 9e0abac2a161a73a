"""Lightweight Sinc convolutions: a learnable band-pass frontend on raw
waveform windows (port of espnet_tpu/models/sinc.py).

`SincConv` keeps one (low_hz, band_hz) pair per filter, mel-initialised,
and builds its kernel on every call in float32: the difference of two
low-pass sincs at the band's edges, Hamming-windowed and normalised by the
band's width, then rounded to the compute dtype as JAX rounds it. It is
applied as a VALID convolution of each window (the JAX package's einsum
over stride-1 frames; the same sums) in float32, cast to the compute dtype.
`LightweightSincConvs` frames the waveform (`win_length` samples every
`hop_length`, centred), runs the sinc block (|.|, max-pool 2, LayerNorm,
leaky ReLU) and two depthwise-separable blocks (depthwise conv of width 25,
pointwise conv, max-pool 2, LayerNorm, leaky ReLU), averages each window to
one `out_dim` vector, drops out by flax's rule and zeroes the frames past
each utterance's `lengths // hop_length + 1`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from espnet_tpu_torch.models.layers import Conv1d, LayerNorm
from espnet_tpu_torch.ops.dropout import Dropout
from espnet_tpu_torch.ops.stft import frame_signal

DW_KERNEL = 25


def _mel_edges(fs: int, channels: int) -> np.ndarray:
    mel = np.linspace(2595.0 * np.log10(1.0 + 30.0 / 700.0),
                      2595.0 * np.log10(1.0 + (fs / 2 - 100.0) / 700.0),
                      channels + 1)
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


class SincConv(nn.Module):
    """Band-pass sinc filterbank conv: (N', win) -> (N', win - k + 1, C)."""

    def __init__(self, out_channels: int = 128, kernel_size: int = 101,
                 fs: int = 16000, min_low_hz: float = 50.0,
                 min_band_hz: float = 50.0, dtype=torch.float32):
        super().__init__()
        self.kernel_size = kernel_size
        self.fs = fs
        self.min_low_hz = min_low_hz
        self.min_band_hz = min_band_hz
        self.dtype = dtype
        hz = _mel_edges(fs, out_channels)
        self.low_hz = nn.Parameter(torch.from_numpy(
            np.asarray(hz[:-1], np.float32)))
        self.band_hz = nn.Parameter(torch.from_numpy(
            np.asarray(np.diff(hz), np.float32)))

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """The mel initialisation (deterministic, as in JAX)."""
        hz = _mel_edges(self.fs, self.low_hz.numel())
        self.low_hz.copy_(torch.from_numpy(np.asarray(hz[:-1], np.float32)))
        self.band_hz.copy_(torch.from_numpy(np.asarray(np.diff(hz),
                                                       np.float32)))

    def filters(self) -> torch.Tensor:
        """(k, C) kernel in the compute dtype."""
        k, fs = self.kernel_size, self.fs
        dev = self.low_hz.device
        low = self.min_low_hz + self.low_hz.abs()
        high = (low + self.min_band_hz + self.band_hz.abs()).clamp(0.0, fs / 2)
        n = (k - 1) // 2
        t = torch.arange(-n, n + 1, dtype=torch.float32, device=dev) / fs
        window = 0.54 - 0.46 * torch.cos(
            2.0 * math.pi * torch.arange(k, dtype=torch.float32, device=dev)
            / (k - 1))

        def bandpass(cut):  # (C,) -> (k, C): low-pass sinc at the cutoff
            arg = 2.0 * math.pi * cut[None, :] * t[:, None]
            # the 0/0 point out of both branches: no NaN gradient
            near0 = arg.abs() < 1e-8
            safe = torch.where(near0, torch.ones_like(arg), arg)
            sinc = torch.where(near0, torch.ones_like(arg),
                               torch.sin(safe) / safe)
            return 2.0 * cut[None, :] * sinc

        kern = (bandpass(high) - bandpass(low)) * window[:, None]
        kern = kern / (2.0 * (high - low))[None, :]
        return kern.to(self.dtype)

    def forward(self, x):
        kern = self.filters().float()  # (k, C)
        y = nn.functional.conv1d(x.float()[:, None, :], kern.t()[:, None, :])
        return y.transpose(1, 2).to(self.dtype)


def _pool2(h):
    """max-pool of width 2, stride 2, along L of (N, L, C)."""
    return nn.functional.max_pool1d(h.transpose(1, 2), 2, 2).transpose(1, 2)


class LightweightSincConvs(nn.Module):
    """Sliding-window raw-audio frontend: (B, N) waveform, (B,) lengths ->
    ((B, T, out_dim) features, frame lengths)."""

    def __init__(self, fs: int = 16000, win_length: int = 400,
                 hop_length: int = 160, sinc_channels: int = 128,
                 sinc_kernel: int = 101, out_dim: int = 256,
                 dropout_rate: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.win_length = win_length
        self.hop_length = hop_length
        self.out_dim = out_dim
        self.dtype = dtype
        self.sinc = SincConv(sinc_channels, sinc_kernel, fs, dtype=dtype)
        self.norm0 = LayerNorm(sinc_channels, dtype)
        c = sinc_channels
        for i in range(2):
            self.add_module(f"dw{i}", Conv1d(c, c, DW_KERNEL, groups=c,
                                              dtype=dtype))
            self.add_module(f"pw{i}", Conv1d(c, out_dim, 1, dtype=dtype))
            self.add_module(f"norm{i + 1}", LayerNorm(out_dim, dtype))
            c = out_dim
        self.dropout = Dropout(dropout_rate)

    def forward(self, speech, lengths, generator=None):
        b = speech.shape[0]
        frames = frame_signal(speech, self.win_length, self.hop_length,
                              center=True)  # (B, T, win)
        t = frames.shape[1]
        flens = torch.clamp(torch.div(lengths, self.hop_length,
                                      rounding_mode="floor") + 1, max=t)
        h = self.sinc(frames.reshape(b * t, self.win_length))
        h = _pool2(h.abs())
        h = nn.functional.leaky_relu(self.norm0(h), 0.01)
        for i in range(2):
            h = getattr(self, f"pw{i}")(getattr(self, f"dw{i}")(h))
            h = getattr(self, f"norm{i + 1}")(_pool2(h))
            h = nn.functional.leaky_relu(h, 0.01)
        h = self.dropout(h.mean(dim=1), generator)
        feats = h.reshape(b, t, self.out_dim)
        mask = (torch.arange(t, device=feats.device)[None, :]
                < flens[:, None]).to(feats.dtype)
        return feats * mask[:, :, None], flens
