"""Collect-stats pass: feature shape files + global MVN statistics (port of
espnet_tpu/train/collect_stats.py).

One pass over the training batches computes the log-mel features with the
port's `ops/stft.py` on the run's device (for `input_type` "feats" the
features are the inputs) and sums, over valid frames, their count, sum and
sum of squares (float32 per batch, float64 across batches), as the JAX pass
does. Like the JAX pass, the features use the n_fft-long window
(`win_length` None) whatever the model's `win_length`, and every
`input_type` but "raw" counts as precomputed features: for
"sliding_window" and "fused", whose data are waveforms, the JAX pass fails
on the (B, N) batch, and this one raises a ValueError. With `whisper_mels`
(a Whisper encoder on raw input) the features are the encoder's own,
`models.ssl.whisper_log_mel` with that many mels, where the JAX pass takes
the ASR's log-mel at its n_fft and hop (ROADMAP.md queue 3). Writes
`feats_stats.npz` {count, sum, sum_square} and the `speech_shape` /
`text_shape` files; `mvn_variables` turns the stats into the model's
`GlobalMVN` buffers.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from espnet_tpu_torch.data.dataset import collate
from espnet_tpu_torch.data.fileio import write_shape_file
from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.ops.masks import make_valid_mask
from espnet_tpu_torch.ops.normalize import global_mvn_params
from espnet_tpu_torch.ops.stft import log_mel_spectrogram


@torch.no_grad()
def _moments(speech, lengths, fs, n_fft, hop_length, n_mels, input_type,
             whisper_mels=0):
    if input_type == "raw" and whisper_mels:
        from espnet_tpu_torch.models.ssl import whisper_log_mel

        feats, flens = whisper_log_mel(speech, lengths, fs, whisper_mels)
    elif input_type == "raw":
        feats, flens = log_mel_spectrogram(speech, lengths, fs, n_fft,
                                           hop_length, None, n_mels)
    else:
        feats, flens = speech, lengths
        if feats.ndim != 3:
            raise ValueError(
                f"collect-stats takes input_type {input_type!r} as "
                f"precomputed features, but the batch is {tuple(feats.shape)}"
                " waveforms (the JAX pass fails on it too): global MVN needs "
                "input_type raw or feats")
    mask = make_valid_mask(flens, feats.shape[1])[:, :, None]
    feats = feats * mask.to(feats.dtype)
    return torch.cat([flens.sum().float()[None], feats.sum(dim=(0, 1)),
                      (feats * feats).sum(dim=(0, 1))])


def collect_stats(dataset, batches, output_dir, fs: int = 16000,
                  n_fft: int = 512, hop_length: int = 128, n_mels: int = 80,
                  input_type: str = "raw", device="cuda",
                  whisper_mels: int = 0) -> Dict[str, np.ndarray]:
    """Returns {count, sum, sum_square} over valid feature frames and writes
    speech_shape / text_shape / feats_stats.npz under output_dir. Runs on
    `device` (the card unless "cpu" is asked for)."""
    dev = resolve_device(device)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    count = 0.0
    s = sq = None
    speech_shapes: Dict[str, Tuple[int, ...]] = {}
    text_shapes: Dict[str, Tuple[int, ...]] = {}
    for batch_spec in batches:
        batch = collate(dataset, batch_spec)
        m = _moments(torch.from_numpy(batch["speech"]).to(dev),
                     torch.from_numpy(batch["speech_lengths"]).to(dev),
                     fs, n_fft, hop_length, n_mels, input_type,
                     whisper_mels)
        m = m.cpu().numpy()
        dim = (len(m) - 1) // 2
        count += float(m[0])
        if s is None:
            s, sq = np.zeros(dim, np.float64), np.zeros(dim, np.float64)
        s += np.asarray(m[1:1 + dim], np.float64)
        sq += np.asarray(m[1 + dim:], np.float64)
        for i, k in enumerate(batch["keys"]):
            speech_shapes[k] = (int(batch["speech_lengths"][i]),)
            if "text_lengths" in batch:
                text_shapes[k] = (int(batch["text_lengths"][i]),)
    if s is None:
        dim = whisper_mels or n_mels
        s, sq = np.zeros(dim, np.float64), np.zeros(dim, np.float64)
    stats = {"count": np.asarray(count), "sum": s, "sum_square": sq}
    np.savez(out / "feats_stats.npz", **stats)
    write_shape_file(out / "speech_shape", speech_shapes)
    if text_shapes:
        write_shape_file(out / "text_shape", text_shapes)
    return stats


def load_stats(path) -> Dict[str, np.ndarray]:
    z = np.load(path)
    return {k: z[k] for k in ("count", "sum", "sum_square")}


def mvn_variables(stats: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """The JAX `mvn` collection of the stats, {"mvn": {"mean", "inv_std"}}
    as numpy: the port's `GlobalMVN` buffers `mvn.mean`, `mvn.inv_std`."""
    mean, inv_std = global_mvn_params(stats)
    return {"mvn": {"mean": mean, "inv_std": inv_std}}
