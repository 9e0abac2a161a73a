# Copy of espnet_tpu/ops/perturb.py (the port imports nothing of
# espnet_tpu); its imports point at the port's modules.
"""Waveform perturbations: speed, volume, noise (host-side numpy).

Behavioral spec: reference `espnet/transform/perturb.py`
(SpeedPerturbation `:9` via resampy — here polyphase-free linear
interpolation; VolumePerturbation; NoiseInjection with target SNR) and the
recipe-side speed-perturb stage (`egs2/TEMPLATE/asr1/asr.sh` stage 2:
0.9/1.0/1.1 copies of the corpus).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np


def speed_perturb(wav: np.ndarray, factor: float) -> np.ndarray:
    """Resample by `factor` (>1 = faster/shorter) with linear interpolation
    (`perturb.py:9` SpeedPerturbation semantics)."""
    if factor == 1.0:
        return wav
    n_out = int(round(len(wav) / factor))
    pos = np.arange(n_out, dtype=np.float64) * factor
    i0 = np.minimum(pos.astype(np.int64), len(wav) - 1)
    i1 = np.minimum(i0 + 1, len(wav) - 1)
    frac = (pos - i0).astype(wav.dtype)
    return (wav[i0] * (1.0 - frac) + wav[i1] * frac).astype(wav.dtype)


def volume_perturb(wav: np.ndarray, db: float) -> np.ndarray:
    """Scale by db decibels (`perturb.py` VolumePerturbation)."""
    return (wav * (10.0 ** (db / 20.0))).astype(wav.dtype)


def noise_injection(
    wav: np.ndarray, snr_db: float,
    noise: Optional[np.ndarray] = None,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Add noise at the given SNR (`perturb.py` NoiseInjection). White
    noise when no noise signal is given."""
    rng = rng or np.random.RandomState(0)
    if noise is None:
        noise = rng.randn(len(wav)).astype(wav.dtype)
    else:
        if len(noise) < len(wav):
            reps = int(np.ceil(len(wav) / len(noise)))
            noise = np.tile(noise, reps)
        start = rng.randint(0, len(noise) - len(wav) + 1)
        noise = noise[start:start + len(wav)]
    p_sig = np.mean(wav ** 2) + 1e-12
    p_noise = np.mean(noise ** 2) + 1e-12
    scale = np.sqrt(p_sig / (p_noise * 10.0 ** (snr_db / 10.0)))
    return (wav + scale * noise).astype(wav.dtype)


def rir_convolve(wav: np.ndarray, rir: np.ndarray) -> np.ndarray:
    """Convolve with a room impulse response (`perturb.py` RIRConvolve)."""
    out = np.convolve(wav, rir)[: len(wav)]
    peak_in = np.max(np.abs(wav)) + 1e-12
    peak_out = np.max(np.abs(out)) + 1e-12
    return (out * (peak_in / peak_out)).astype(wav.dtype)


def speed_perturb_corpus(
    data_dir, out_dir, factors: Sequence[float] = (0.9, 1.0, 1.1),
    fs: int = 16000,
) -> Path:
    """Recipe stage-2 equivalent: write a combined data dir with
    sp<factor>- prefixed copies (`asr.sh:500`)."""
    from espnet_tpu_torch.data.fileio import (
        DatadirWriter, read_2column_text, read_wav, write_wav,
    )

    src = Path(data_dir)
    out = Path(out_dir)
    (out / "wav").mkdir(parents=True, exist_ok=True)
    wavs = read_2column_text(src / "wav.scp")
    texts = read_2column_text(src / "text") if (src / "text").exists() else {}
    with DatadirWriter(out) as w:
        for factor in factors:
            prefix = "" if factor == 1.0 else f"sp{factor:.1f}-"
            for key, path in wavs.items():
                uid = prefix + key
                if factor == 1.0:
                    w["wav.scp"][uid] = path
                else:
                    wav, sr = read_wav(path)
                    pw = speed_perturb(wav, factor)
                    p = out / "wav" / f"{uid}.wav"
                    write_wav(p, pw, sr)
                    w["wav.scp"][uid] = str(p)
                if key in texts:
                    w["text"][uid] = texts[key]
    return out
