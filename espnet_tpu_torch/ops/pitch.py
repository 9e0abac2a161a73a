"""Frame energy and autocorrelation F0 (port of espnet_tpu/ops/pitch.py).

`frame_energy` is the L2 norm of each STFT frame; `autocorr_f0` picks the
normalised-autocorrelation peak (Wiener-Khinchin: one rFFT and one irFFT
of length 2 n_fft) in the lag band [fs/f0max, fs/f0min], on the frame grid
of the log-mel frontend. The argmax takes the first of equal maxima, as
`jnp.argmax` does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from espnet_tpu_torch.ops.stft import frame_signal, stft


def frame_energy(wav: torch.Tensor, n_fft: int = 1024,
                 hop_length: int = 256) -> torch.Tensor:
    """(B, N) -> (B, T) energy = ||STFT frame||_2."""
    real, imag = stft(wav, n_fft, hop_length)
    return torch.sqrt((real * real + imag * imag).sum(-1).clamp(min=1e-10))


def autocorr_f0(wav: torch.Tensor, fs: int = 16000, n_fft: int = 1024,
                hop_length: int = 256, f0min: float = 80.0,
                f0max: float = 400.0, voicing_threshold: float = 0.35
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) -> (log_f0 (B, T), voiced (B, T)); unvoiced frames get 0."""
    frames = frame_signal(wav.float(), n_fft, hop_length, center=True)
    frames = frames - frames.mean(-1, keepdim=True)
    spec = torch.fft.rfft(frames, n=2 * n_fft, dim=-1)
    ac = torch.fft.irfft(spec * torch.conj(spec), dim=-1)[..., :n_fft]
    acn = ac / ac[..., :1].clamp(min=1e-8)
    lag_min = max(int(fs / f0max), 2)
    lag_max = min(int(fs / f0min) + 1, n_fft - 1)
    band = acn[..., lag_min:lag_max]
    peak = torch.argmax(band, dim=-1)
    peak_val = torch.gather(band, -1, peak[..., None])[..., 0]
    f0 = fs / (peak + lag_min).float()
    energy = torch.sqrt((frames ** 2).mean(-1))
    voiced = (peak_val > voicing_threshold) & (
        energy > 1e-4 * energy.amax(-1, keepdim=True))
    log_f0 = torch.where(voiced, torch.log(f0), torch.zeros_like(f0))
    return log_f0, voiced.float()
