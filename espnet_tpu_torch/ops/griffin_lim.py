"""Griffin-Lim phase reconstruction (port of espnet_tpu/ops/griffin_lim.py).

log-mel -> the mel filterbank's pseudo-inverse -> linear magnitude ->
`n_iter` rounds of istft/stft keeping the magnitude and taking the phase.
The JAX package draws the initial phase from `jax.random.uniform(
PRNGKey(0))`; the port draws it from a torch generator (seeded 0 unless the
caller passes one), or takes it as given (`angle=`), which the tests use to
hold the two packages to the same waves.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from espnet_tpu_torch.ops.stft import istft, mel_filterbank, stft


def logmel_to_linear(log_mel: torch.Tensor, fs: int = 16000,
                     n_fft: int = 512, n_mels: int = 80, fmin: float = 0.0,
                     fmax: Optional[float] = None) -> torch.Tensor:
    """Pseudo-inverse mel -> linear magnitude (B, T, n_fft//2+1) of a
    natural-log mel spectrogram (B, T, n_mels)."""
    inv = np.linalg.pinv(mel_filterbank(fs, n_fft, n_mels, fmin, fmax))
    inv = torch.from_numpy(inv.astype(np.float32)).to(log_mel.device)
    return torch.sqrt((torch.exp(log_mel.float()) @ inv).clamp(min=1e-10))


def initial_angle(shape, device, generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Uniform phases in [-pi, pi) from `generator` (a CPU generator
    seeded 0 when None), drawn on the CPU and moved to `device`."""
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    u = torch.rand(tuple(shape), generator=gen, device=gen.device)
    return (u * 2 * math.pi - math.pi).to(device)


def griffin_lim(magnitude: torch.Tensor, n_fft: int = 512,
                hop_length: int = 128, win_length: Optional[int] = None,
                n_iter: int = 32, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                angle: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Iterative phase reconstruction of a (B, T, F) magnitude -> (B, N)
    waveform, N = `length` or hop * (T - 1)."""
    magnitude = magnitude.float()
    t = magnitude.shape[1]
    out_len = length or hop_length * (t - 1)
    if angle is None:
        angle = initial_angle(magnitude.shape, magnitude.device, generator)
    angle = angle.to(magnitude.device, torch.float32)
    real = magnitude * torch.cos(angle)
    imag = magnitude * torch.sin(angle)
    for _ in range(n_iter):
        wav = istft(real, imag, n_fft, hop_length, win_length,
                    length=out_len)
        r2, i2 = stft(wav, n_fft, hop_length, win_length)
        r2, i2 = r2[:, :t], i2[:, :t]
        mag2 = torch.sqrt((r2 * r2 + i2 * i2).clamp(min=1e-12))
        real, imag = magnitude * r2 / mag2, magnitude * i2 / mag2
    return istft(real, imag, n_fft, hop_length, win_length, length=out_len)


def logmel_to_wav(log_mel: torch.Tensor, fs: int = 16000, n_fft: int = 512,
                  hop_length: int = 128, win_length: Optional[int] = None,
                  n_mels: int = 80, n_iter: int = 32,
                  generator: Optional[torch.Generator] = None,
                  angle: Optional[torch.Tensor] = None) -> torch.Tensor:
    mag = logmel_to_linear(log_mel, fs, n_fft, n_mels)
    return griffin_lim(mag, n_fft, hop_length, win_length, n_iter,
                       generator=generator, angle=angle)
