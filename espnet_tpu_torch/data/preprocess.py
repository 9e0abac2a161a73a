# Copy of espnet_tpu/data/preprocess.py (the port imports nothing of
# espnet_tpu); its imports point at the port's modules.
"""On-access speech preprocessing: RIR convolution, noise mixing at a
sampled SNR, and volume normalization.

Behavioral spec: reference `espnet2/train/preprocessor.py` CommonPreprocessor
speech path (`_speech_process:283`): with probability `rir_apply_prob` /
`noise_apply_prob` (train only) convolve a randomly chosen RIR
(`_convolve_rir:221` — full convolution truncated to the input length,
power restored on the non-silent region) and add a randomly chosen noise at
a uniform SNR from `noise_db_range` (`_add_noise:240` — short noises are
wrap-padded at a random offset, long ones randomly cropped), clip-protect by
peak, then optionally rescale the peak to `speech_volume_normalize`
(`:316-319`).  `detect_non_silence` (`preprocessor.py:74`) is the same
power-based VAD: frame power above `threshold` x mean power.

This is the per-utterance, on-the-fly counterpart of the corpus-level
`ops/perturb.py` stage; it runs host-side in the data loader (numpy), like
the reference's — augmentation is IO-bound, the TPU step never sees it.
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

from espnet_tpu_torch.data.fileio import read_2column_text, read_wav


def detect_non_silence(x: np.ndarray, threshold: float = 0.01,
                       frame_length: int = 1024,
                       frame_shift: int = 512) -> np.ndarray:
    """Power-based VAD mask, same shape as x (preprocessor.py:74)."""
    if x.shape[-1] < frame_length:
        return np.full(x.shape, True)
    n_frames = (x.shape[-1] - frame_length) // frame_shift + 1
    idx = (np.arange(n_frames) * frame_shift)[:, None] + np.arange(
        frame_length)[None, :]
    framed = x[..., idx]                         # (..., T, F)
    power = (framed ** 2).mean(axis=-1)          # (..., T)
    mean_power = power.mean(axis=-1, keepdims=True)
    if np.all(mean_power == 0):
        return np.full(x.shape, True)
    detect = power / mean_power > threshold      # (..., T)
    detects = np.repeat(detect, frame_shift, axis=-1)
    pad = x.shape[-1] - detects.shape[-1]
    return np.pad(detects, [(0, 0)] * (x.ndim - 1) + [(0, pad)],
                  mode="edge")


class SpeechPreprocessor:
    """RIR + noise + volume normalize on raw waveforms (numpy, host-side).

    ``__call__(speech (N,) or (N, C)) -> same layout``.
    """

    def __init__(
        self,
        rir_scp: Optional[str] = None,
        rir_apply_prob: float = 1.0,
        noise_scp: Optional[str] = None,
        noise_apply_prob: float = 1.0,
        noise_db_range: str = "13_15",
        speech_volume_normalize: Optional[float] = None,
        train: bool = True,
        seed: int = 0,
    ):
        self.train = train
        self.rir_apply_prob = rir_apply_prob
        self.noise_apply_prob = noise_apply_prob
        self.speech_volume_normalize = speech_volume_normalize
        # No shared mutable RNG: __call__ runs inside EpochIterator's
        # ThreadPoolExecutor collate workers, and np.random.RandomState is
        # not thread-safe — concurrent draws would race and make the
        # augmentation nondeterministic. Each call derives a fresh
        # generator from (seed, uid) instead.
        self.seed = seed
        self.rirs = (sorted(read_2column_text(rir_scp).values())
                     if rir_scp else None)
        self.noises = (sorted(read_2column_text(noise_scp).values())
                       if noise_scp else None)
        sps = noise_db_range.split("_")
        if len(sps) == 1:
            self.noise_db_low = self.noise_db_high = float(sps[0])
        elif len(sps) == 2:
            self.noise_db_low, self.noise_db_high = map(float, sps)
        else:
            raise ValueError(
                f"noise_db_range format error: {noise_db_range!r} "
                "(e.g. '-3_4' -> [-3dB, 4dB])"
            )

    def _convolve_rir(self, speech, power, rng):
        """speech (C, N); full conv with a random RIR, truncated, power
        restored (preprocessor.py:221)."""
        rir, _ = read_wav(self.rirs[int(rng.integers(len(self.rirs)))])
        rir = rir.astype(np.float64)
        rir = rir[:, None] if rir.ndim == 1 else rir
        rir = rir.T                                  # (C_rir, L)
        n = speech.shape[1]
        out = np.stack([
            np.convolve(speech[c], rir[min(c, rir.shape[0] - 1)],
                        mode="full")[:n]
            for c in range(speech.shape[0])
        ])
        power2 = (out[detect_non_silence(out)] ** 2).mean()
        return np.sqrt(power / max(power2, 1e-10)) * out

    def _add_noise(self, speech, power, rng):
        """speech (C, N); mix a random noise at a uniform SNR
        (preprocessor.py:240)."""
        nsamples = speech.shape[1]
        noise, _ = read_wav(self.noises[int(rng.integers(len(self.noises)))])
        noise = noise.astype(np.float64)
        noise = noise[:, None] if noise.ndim == 1 else noise  # (L, C)
        noise_db = rng.uniform(self.noise_db_low, self.noise_db_high)
        ln = noise.shape[0]
        if ln == nsamples:
            pass
        elif ln < nsamples:
            offset = int(rng.integers(0, nsamples - ln + 1))
            noise = np.pad(noise, [(offset, nsamples - ln - offset), (0, 0)],
                           mode="wrap")
        else:
            offset = int(rng.integers(0, ln - nsamples + 1))
            noise = noise[offset:offset + nsamples]
        noise = noise.T                               # (C, N)
        if noise.shape[0] < speech.shape[0]:
            noise = np.broadcast_to(noise[:1], speech.shape)
        noise_power = (noise ** 2).mean()
        scale = (10 ** (-noise_db / 20) * np.sqrt(power)
                 / np.sqrt(max(noise_power, 1e-10)))
        return speech + scale * noise[: speech.shape[0]]

    def __call__(self, speech: np.ndarray, uid: str = "") -> np.ndarray:
        # per-utterance generator seeded from (seed, uid): thread-safe under
        # concurrent collate workers AND reproducible per utterance across
        # runs/epoch orders (reference keeps one RandomState but loads
        # single-threaded; we parallelize, so determinism must not depend
        # on call order).
        rng = np.random.default_rng(
            (self.seed, zlib.crc32(uid.encode("utf-8"))))
        mono = speech.ndim == 1
        out = speech.astype(np.float64)
        out = out[None, :] if mono else out.T         # (C, N)
        if self.train and (self.rirs or self.noises):
            power = (out[detect_non_silence(out)] ** 2).mean()
            if self.rirs and self.rir_apply_prob >= rng.random():
                out = self._convolve_rir(out, power, rng)
            if self.noises and self.noise_apply_prob >= rng.random():
                out = self._add_noise(out, power, rng)
            ma = np.max(np.abs(out))
            if ma > 1.0:
                out = out / ma
        if self.speech_volume_normalize is not None:
            ma = np.max(np.abs(out))
            if ma > 0:
                out = out * self.speech_volume_normalize / ma
        out = out[0] if mono else out.T
        return out.astype(np.float32)
