"""STFT and log-mel filterbank (port of espnet_tpu/ops/stft.py).

Same numerics as the JAX package: periodic Hann window, centre reflect
padding, the real DFT as two float32 matrix products with precomputed
cos/sin bases, librosa's slaney mel filterbank, clamp at 1e-10 and natural
log. The bases are built with numpy in float64 and cached per size.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from espnet_tpu_torch.ops.masks import make_valid_mask


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (torch.hann_window(periodic=True))."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def _padded_window(win_length: int, n_fft: int, window: str = "hann") -> np.ndarray:
    if window == "hann":
        w = hann_window(win_length)
    elif window is None or window == "rect":
        w = np.ones(win_length, np.float32)
    else:
        raise ValueError(f"unknown window: {window}")
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, np.float32)
    out[left:left + win_length] = w
    return out


@functools.lru_cache(maxsize=None)
def _dft_bases(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT cos/sin bases, (n_fft, n_fft//2+1) each, of angle
    -2*pi*k*n/N."""
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """(B, N) -> (B, F, n_fft) frames; reflect-pads n_fft//2 when center
    (numpy's reflect, repeated where the pad reaches past the signal, as
    jnp.pad does for a signal shorter than the pad)."""
    if center:
        pad = n_fft // 2
        n = x.shape[-1]
        if pad < n:
            x = torch.nn.functional.pad(x[:, None, :], (pad, pad),
                                        mode="reflect")[:, 0]
        else:
            idx = torch.arange(-pad, n + pad, device=x.device)
            period = max(2 * (n - 1), 1)
            idx = idx % period
            idx = torch.where(idx >= n, period - idx, idx)
            x = x[:, idx]
    return x.unfold(-1, n_fft, hop_length)


def stft_frames_lengths(ilens: torch.Tensor, n_fft: int, hop_length: int,
                        center: bool = True) -> torch.Tensor:
    """Per-utterance frame counts (torch.stft's output length)."""
    if center:
        return ilens // hop_length + 1
    return (ilens - n_fft) // hop_length + 1


def stft(x: torch.Tensor, n_fft: int = 512, hop_length: int = 128,
         win_length: Optional[int] = None, window: str = "hann",
         center: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """STFT of a (B, N) float signal -> (real, imag), each
    (B, F, n_fft//2+1), computed in float32."""
    win_length = win_length or n_fft
    frames = frame_signal(x.float(), n_fft, hop_length, center)
    w = torch.from_numpy(_padded_window(win_length, n_fft, window)).to(x.device)
    frames = frames * w
    cos_b, sin_b = (torch.from_numpy(a).to(x.device) for a in _dft_bases(n_fft))
    return frames @ cos_b, frames @ sin_b


def power_spectrum(real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
    return real * real + imag * imag


def _hz_to_mel(freq, htk: bool) -> np.ndarray:
    freq = np.asarray(freq, np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # Slaney: linear below 1 kHz, logarithmic above.
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_branch = min_log_mel + np.log(freq / min_log_hz) / logstep
    return np.where(freq >= min_log_hz, log_branch, mels)


def _mel_to_hz(mels, htk: bool) -> np.ndarray:
    mels = np.asarray(mels, np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=None)
def mel_filterbank(fs: int = 16000, n_fft: int = 512, n_mels: int = 80,
                   fmin: float = 0.0, fmax: Optional[float] = None,
                   htk: bool = False, norm: Optional[str] = "slaney") -> np.ndarray:
    """Mel filterbank matrix (n_fft//2+1, n_mels), librosa's numerics."""
    fmax = fs / 2 if fmax is None else fmax
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, fs / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk),
                          n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    return weights.T.astype(np.float32)


def log_mel(power: torch.Tensor, fs: int = 16000, n_fft: int = 512,
            n_mels: int = 80, fmin: float = 0.0, fmax: Optional[float] = None,
            htk: bool = False, floor: float = 1e-10) -> torch.Tensor:
    """(B, F, n_freqs) power -> (B, F, n_mels) natural-log mel energies."""
    mat = torch.from_numpy(
        mel_filterbank(fs, n_fft, n_mels, fmin, fmax, htk)).to(power.device)
    return torch.log((power @ mat).clamp(min=floor))


def log_mel_spectrogram(x: torch.Tensor, ilens: torch.Tensor, fs: int = 16000,
                        n_fft: int = 512, hop_length: int = 128,
                        win_length: Optional[int] = None, n_mels: int = 80,
                        fmin: float = 0.0, fmax: Optional[float] = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw wave (B, N) -> (log-mel (B, F, n_mels), frame lengths); padded
    frames are zeroed."""
    real, imag = stft(x, n_fft, hop_length, win_length)
    feats = log_mel(power_spectrum(real, imag), fs, n_fft, n_mels, fmin, fmax)
    olens = stft_frames_lengths(ilens, n_fft, hop_length)
    mask = make_valid_mask(olens, feats.shape[1])
    return feats * mask[:, :, None].to(feats.dtype), olens


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int = 512,
          hop_length: int = 128, win_length: Optional[int] = None,
          window: str = "hann", center: bool = True,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT of (real, imag), each (B, F, n_fft//2+1) -> (B, N):
    the inverse real DFT as two float32 products with the bases of `stft`,
    the window, overlap-add, then division by the overlap-added squared
    window (floored at 1e-11), as the JAX `istft` does."""
    win_length = win_length or n_fft
    b, f, k = real.shape
    dev = real.device
    cos_b, sin_b = (torch.from_numpy(a).to(dev) for a in _dft_bases(n_fft))
    scale = np.full((k,), 2.0, np.float32)
    scale[0] = 1.0
    if n_fft % 2 == 0:
        scale[-1] = 1.0
    scale = torch.from_numpy(scale).to(dev)
    # x[n] = (1/N) sum_k scale_k (Re cos(2 pi k n/N) - Im sin(2 pi k n/N));
    # the bases hold cos(-t) and sin(-t), hence '+' on the imaginary term
    frames = ((real.float() * scale) @ cos_b.t()
              + (imag.float() * scale) @ sin_b.t()) / n_fft
    w = torch.from_numpy(_padded_window(win_length, n_fft, window)).to(dev)
    frames = frames * w
    out_len = n_fft + hop_length * (f - 1)
    idx = (torch.arange(f, device=dev)[:, None] * hop_length
           + torch.arange(n_fft, device=dev)[None, :]).reshape(-1)
    sig = torch.zeros(b, out_len, device=dev).index_add_(
        1, idx, frames.reshape(b, -1))
    wsq = torch.zeros(out_len, device=dev).index_add_(
        0, idx, (w * w).repeat(f))
    sig = sig / wsq.clamp(min=1e-11)
    if center:
        pad = n_fft // 2
        sig = sig[:, pad:out_len - pad]
    if length is not None:
        sig = sig[:, :length]
    return sig
