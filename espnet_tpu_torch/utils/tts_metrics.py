"""Objective TTS evaluation: mel-cepstral distortion with DTW (port of
espnet_tpu/utils/tts_metrics.py).

Mel cepstra are the orthonormal DCT-II of the log-mel spectrogram
(`ops/stft.log_mel_spectrogram` at its defaults, on the CPU); frames are
aligned with dynamic time warping, and MCD is (10 sqrt(2) / ln 10) times
the mean Euclidean distance along the path, c0 (energy) excluded. Host
numpy apart from the log-mel.
"""

from __future__ import annotations

import numpy as np
import torch

from espnet_tpu_torch.ops.stft import log_mel_spectrogram


def mel_cepstra(wav: np.ndarray, fs: int = 16000, n_mels: int = 80,
                n_mcep: int = 13) -> np.ndarray:
    """(N,) waveform -> (T, n_mcep + 1) mel cepstra, column 0 = c0; an
    empty wave (a synthesis of no frames) has none, and its MCD is inf
    (where the JAX package's log-mel fails on it)."""
    if len(wav) == 0:
        return np.zeros((0, n_mcep + 1))
    mel, lens = log_mel_spectrogram(
        torch.from_numpy(np.asarray(wav, np.float32)[None]),
        torch.tensor([len(wav)]), fs=fs, n_mels=n_mels)
    mel = mel[0, :int(lens[0])].numpy().astype(np.float64)
    m = mel.shape[1]
    k = np.arange(m)
    basis = np.cos(np.pi * (k[:, None] + 0.5) * k[None, :n_mcep + 1] / m)
    basis *= np.sqrt(2.0 / m)
    basis[:, 0] *= np.sqrt(0.5)
    return mel @ basis


def dtw_path_cost(a: np.ndarray, b: np.ndarray) -> float:
    """Mean Euclidean frame distance along the DTW path of (Ta, D) and
    (Tb, D)."""
    ta, tb = a.shape[0], b.shape[0]
    d = np.sqrt(np.maximum((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
                           - 2.0 * (a @ b.T), 0.0))
    acc = np.full((ta + 1, tb + 1), np.inf)
    cnt = np.zeros((ta + 1, tb + 1), np.int64)
    acc[0, 0] = 0.0
    for i in range(1, ta + 1):
        for j in range(1, tb + 1):
            prev = min((acc[i - 1, j], (i - 1, j)),
                       (acc[i, j - 1], (i, j - 1)),
                       (acc[i - 1, j - 1], (i - 1, j - 1)))
            acc[i, j] = d[i - 1, j - 1] + prev[0]
            cnt[i, j] = cnt[prev[1]] + 1
    return float(acc[ta, tb] / max(int(cnt[ta, tb]), 1))


def mel_cepstral_distortion(ref_wav: np.ndarray, syn_wav: np.ndarray,
                            fs: int = 16000, n_mcep: int = 13) -> float:
    """MCD in dB between a reference and a synthesised waveform."""
    cr = mel_cepstra(ref_wav, fs=fs, n_mcep=n_mcep)[:, 1:]
    cs = mel_cepstra(syn_wav, fs=fs, n_mcep=n_mcep)[:, 1:]
    return 10.0 * np.sqrt(2.0) / np.log(10.0) * dtw_path_cost(cr, cs)
