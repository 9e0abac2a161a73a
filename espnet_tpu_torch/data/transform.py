# Copy of espnet_tpu/data/transform.py (the port imports nothing of
# espnet_tpu); its imports point at the port's modules
# (its YAML read: the port's codec).
"""v1 YAML-configured transform pipeline.

Behavioral spec: reference `espnet/transform/transformation.py:15-36`
(Transformation: a YAML `{"process": [{"type": ..., **opts}, ...]}` spec
instantiates a chain of callables by alias) and the transform zoo it
aliases (`espnet/transform/perturb.py`, `spec_augment.py`, `cmvn.py`,
`add_deltas.py`, `spectrogram.py`, `channel_selector.py`).

Role split in this framework: the *training hot path* runs its transforms
on-device inside the model (`ops/stft.py`, `ops/specaug.py`,
`ops/normalize.py` — fused into the compiled step, SURVEY §2.3 layers);
this module is the host-side (numpy) pipeline for corpus preparation,
decode-time feature dumps and parity with v1 recipe configs. Each
transform takes (x, train=...) and most are array->array.
"""

from __future__ import annotations

import io
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from espnet_tpu_torch.ops.perturb import (
    noise_injection, rir_convolve, speed_perturb, volume_perturb,
)


class Identity:
    """`transform_interface.py` Identity."""

    def __call__(self, x, train=True, uttid=None):
        return x


class TimeMask:
    """`spec_augment.py` TimeMask: zero out `n_mask` random time spans."""

    def __init__(self, n_mask=2, width=40, seed=0):
        self.n_mask, self.width = n_mask, width
        self.state = np.random.RandomState(seed)

    def __call__(self, x, train=True, uttid=None):
        if not train:
            return x
        x = x.copy()
        t = x.shape[0]
        for _ in range(self.n_mask):
            w = self.state.randint(0, self.width + 1)
            t0 = self.state.randint(0, max(t - w, 1))
            x[t0:t0 + w] = 0.0
        return x


class FreqMask:
    """`spec_augment.py` FreqMask: zero out `n_mask` random freq bands."""

    def __init__(self, n_mask=2, width=20, seed=0):
        self.n_mask, self.width = n_mask, width
        self.state = np.random.RandomState(seed)

    def __call__(self, x, train=True, uttid=None):
        if not train:
            return x
        x = x.copy()
        f = x.shape[-1]
        for _ in range(self.n_mask):
            w = self.state.randint(0, self.width + 1)
            f0 = self.state.randint(0, max(f - w, 1))
            x[..., f0:f0 + w] = 0.0
        return x


class TimeWarp:
    """`spec_augment.py` TimeWarp: warp a random center frame by +-window
    frames with piecewise-linear interpolation (same math as the on-device
    `ops/specaug.py` time_warp)."""

    def __init__(self, max_time_warp=80, seed=0):
        self.window = max_time_warp
        self.state = np.random.RandomState(seed)

    def __call__(self, x, train=True, uttid=None):
        if not train or x.shape[0] - self.window <= self.window:
            return x
        t = x.shape[0]
        center = self.state.randint(self.window, t - self.window)
        warped = center + self.state.randint(-self.window, self.window + 1)
        src = np.concatenate([
            np.linspace(0, center, warped, endpoint=False),
            np.linspace(center, t - 1, t - warped),
        ])
        lo = np.clip(np.floor(src).astype(int), 0, t - 1)
        hi = np.clip(lo + 1, 0, t - 1)
        frac = (src - lo)[:, None]
        return (1 - frac) * x[lo] + frac * x[hi]


class SpecAugment:
    """`spec_augment.py` SpecAugment = TimeWarp + FreqMask + TimeMask."""

    def __init__(self, max_time_warp=80, n_freq_mask=2, max_freq_width=27,
                 n_time_mask=2, max_time_width=100, seed=0):
        self.fns = [
            TimeWarp(max_time_warp, seed),
            FreqMask(n_freq_mask, max_freq_width, seed + 1),
            TimeMask(n_time_mask, max_time_width, seed + 2),
        ]

    def __call__(self, x, train=True, uttid=None):
        for f in self.fns:
            x = f(x, train=train)
        return x


class SpeedPerturbation:
    """`perturb.py` SpeedPerturbation: resample by a random ratio."""

    def __init__(self, lower=0.9, upper=1.1, utt2ratio=None, keep_length=True,
                 seed=0):
        self.lower, self.upper, self.keep_length = lower, upper, keep_length
        self.state = np.random.RandomState(seed)
        self.utt2ratio = None
        if utt2ratio is not None:
            self.utt2ratio = {
                k: float(v) for k, v in
                (ln.split() for ln in open(utt2ratio) if ln.strip())
            }

    def __call__(self, x, train=True, uttid=None):
        if not train:
            return x
        if self.utt2ratio is not None and uttid in self.utt2ratio:
            ratio = self.utt2ratio[uttid]
        else:
            ratio = self.state.uniform(self.lower, self.upper)
        y = speed_perturb(x, ratio)
        if self.keep_length:
            n = len(x)
            y = y[:n] if len(y) >= n else np.pad(y, (0, n - len(y)))
        return y


class VolumePerturbation:
    """`perturb.py` VolumePerturbation: random gain in dB."""

    def __init__(self, lower=-1.6, upper=1.6, dbunit=True, seed=0):
        self.lower, self.upper, self.dbunit = lower, upper, dbunit
        self.state = np.random.RandomState(seed)

    def __call__(self, x, train=True, uttid=None):
        if not train:
            return x
        r = self.state.uniform(self.lower, self.upper)
        return volume_perturb(x, r) if self.dbunit else x * r


class NoiseInjection:
    """`perturb.py` NoiseInjection: white noise at a random SNR (dB)."""

    def __init__(self, lower=-20, upper=-5, seed=0):
        self.lower, self.upper = lower, upper
        self.state = np.random.RandomState(seed)

    def __call__(self, x, train=True, uttid=None):
        if not train:
            return x
        snr = -self.state.uniform(self.lower, self.upper)
        return noise_injection(x, snr_db=snr,
                               rng=np.random.RandomState(self.state.randint(1 << 31)))


class RIRConvolve:
    """`perturb.py` RIRConvolve: convolve with a random RIR from an scp."""

    def __init__(self, rir_scp, seed=0):
        from espnet_tpu_torch.data.fileio import read_2column_text, read_wav

        self.paths = sorted(read_2column_text(rir_scp).values())
        self._read = read_wav
        self.state = np.random.RandomState(seed)

    def __call__(self, x, train=True, uttid=None):
        if not train:
            return x
        rir, _ = self._read(self.state.choice(self.paths))
        if rir.ndim > 1:
            rir = rir[:, 0]
        return rir_convolve(x, rir)


class BandpassPerturbation:
    """`perturb.py:101` BandpassPerturbation: random dropout along the
    frequency axis of a time-freq input (CHiME-5 Hitachi/JHU trick)."""

    def __init__(self, lower=0.0, upper=0.75, seed=0, axes=(-1,)):
        self.lower, self.upper, self.axes = lower, upper, axes
        self.state = np.random.RandomState(seed)

    def __call__(self, x, train=True, uttid=None):
        if not train:
            return x
        if x.ndim == 1:
            raise RuntimeError(
                "BandpassPerturbation needs time-freq input (T, [C,] F)"
            )
        ratio = self.state.uniform(self.lower, self.upper)
        axes = [a % x.ndim for a in self.axes]
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
        return x * (self.state.randn(*shape) > ratio)


class ChannelSelector:
    """`channel_selector.py`: pick a channel (int | 'random')."""

    def __init__(self, train_channel="random", eval_channel=0, axis=1,
                 seed=0):
        self.train_channel, self.eval_channel = train_channel, eval_channel
        self.axis = axis
        self.state = np.random.RandomState(seed)

    def __call__(self, x, train=True, uttid=None):
        if x.ndim <= self.axis:
            return x
        ch = self.train_channel if train else self.eval_channel
        if ch == "random":
            ch = self.state.randint(0, x.shape[self.axis])
        return np.take(x, int(ch), axis=self.axis)


class AddDeltas:
    """`add_deltas.py`: append delta (and delta-delta) features."""

    def __init__(self, window=2, order=2):
        self.window, self.order = window, order

    @staticmethod
    def _delta(x, window):
        num = sum(i * (np.roll(x, -i, 0) - np.roll(x, i, 0))
                  for i in range(1, window + 1))
        den = 2 * sum(i * i for i in range(1, window + 1))
        out = num / den
        # edge replication like librosa/kaldi boundary handling
        out[:window] = out[window]
        out[-window:] = out[-window - 1]
        return out

    def __call__(self, x, train=True, uttid=None):
        feats = [x]
        for _ in range(self.order):
            feats.append(self._delta(feats[-1], self.window))
        return np.concatenate(feats, axis=-1)


class CMVN:
    """`cmvn.py` CMVN: apply precomputed stats (kaldi-style or npz with
    mean/inv_std arrays)."""

    def __init__(self, stats, norm_means=True, norm_vars=False):
        if isinstance(stats, str):
            z = np.load(stats)
            self.mean, self.inv_std = z["mean"], z["inv_std"]
        else:
            self.mean, self.inv_std = stats
        self.norm_means, self.norm_vars = norm_means, norm_vars

    def __call__(self, x, train=True, uttid=None):
        if self.norm_means:
            x = x - self.mean
        if self.norm_vars:
            x = x * self.inv_std
        return x


class UtteranceCMVN:
    """`cmvn.py` UtteranceCMVN: per-utterance mean/var normalisation."""

    def __init__(self, norm_means=True, norm_vars=False):
        self.norm_means, self.norm_vars = norm_means, norm_vars

    def __call__(self, x, train=True, uttid=None):
        if self.norm_means:
            x = x - x.mean(axis=0, keepdims=True)
        if self.norm_vars:
            x = x / np.maximum(x.std(axis=0, keepdims=True), 1e-10)
        return x


class Stft:
    """`spectrogram.py` Stft (numpy rFFT; same framing/window conventions
    as the on-device `ops/stft.py`, parity-tested)."""

    def __init__(self, n_fft=512, n_shift=128, win_length=None,
                 window="hann"):
        self.n_fft, self.n_shift = n_fft, n_shift
        self.win_length = win_length or n_fft
        self.window = window

    def __call__(self, x, train=True, uttid=None):
        from espnet_tpu_torch.ops.stft import _padded_window

        pad = self.n_fft // 2
        xp = np.pad(x, (pad, pad), mode="reflect")
        n_frames = 1 + (len(xp) - self.n_fft) // self.n_shift
        idx = (np.arange(n_frames) * self.n_shift)[:, None] + np.arange(
            self.n_fft)[None, :]
        frames = xp[idx] * _padded_window(self.win_length, self.n_fft,
                                          self.window)
        return np.fft.rfft(frames, axis=-1)


class Spectrogram:
    def __init__(self, **kw):
        self.stft = Stft(**kw)

    def __call__(self, x, train=True, uttid=None):
        return np.abs(self.stft(x)) ** 2


class LogMelSpectrogram:
    """`spectrogram.py` LogMelSpectrogram — fbank via the shared
    `ops/stft.py` mel filterbank."""

    def __init__(self, fs=16000, n_mels=80, n_fft=512, n_shift=128,
                 win_length=None, window="hann", fmin=None, fmax=None,
                 eps=1e-10):
        from espnet_tpu_torch.ops.stft import mel_filterbank

        self.spec = Spectrogram(n_fft=n_fft, n_shift=n_shift,
                                win_length=win_length, window=window)
        # (n_freqs, n_mels)
        self.mel = np.asarray(mel_filterbank(
            fs, n_fft, n_mels, fmin=fmin or 0.0, fmax=fmax))
        self.eps = eps

    def __call__(self, x, train=True, uttid=None):
        return np.log(np.maximum(self.spec(x) @ self.mel, self.eps))


_ALIAS = {
    "identity": Identity,
    "time_warp": TimeWarp,
    "time_mask": TimeMask,
    "freq_mask": FreqMask,
    "spec_augment": SpecAugment,
    "speed_perturbation": SpeedPerturbation,
    "volume_perturbation": VolumePerturbation,
    "noise_injection": NoiseInjection,
    "bandpass_perturbation": BandpassPerturbation,
    "rir_convolve": RIRConvolve,
    "delta": AddDeltas,
    "cmvn": CMVN,
    "utterance_cmvn": UtteranceCMVN,
    "fbank": LogMelSpectrogram,
    "spectrogram": Spectrogram,
    "stft": Stft,
    "channel_selector": ChannelSelector,
}


class Transformation:
    """Chain of transforms from a YAML/dict spec
    (`transformation.py:39`).

    >>> t = Transformation({"process": [
    ...     {"type": "fbank", "n_mels": 80},
    ...     {"type": "utterance_cmvn"},
    ... ]})
    >>> feats = t(wav, train=True)
    """

    def __init__(self, conf: Any = None):
        if isinstance(conf, str):
            from espnet_tpu_torch.utils.config import load_yaml

            conf = load_yaml(conf)
        conf = conf or {"process": []}
        if "mode" in conf and conf["mode"] != "sequential":
            raise NotImplementedError(f"mode: {conf['mode']}")
        self.fns: List[Any] = []
        self.specs = conf.get("process", [])
        for spec in self.specs:
            opts = dict(spec)
            kind = opts.pop("type")
            if kind not in _ALIAS:
                raise ValueError(
                    f"unknown transform {kind!r} (choices: {sorted(_ALIAS)})"
                )
            self.fns.append(_ALIAS[kind](**opts))

    def __call__(self, x, train: bool = True, uttid: Optional[str] = None):
        for fn in self.fns:
            x = fn(x, train=train, uttid=uttid)
        return x

    def __repr__(self):
        body = ", ".join(s["type"] for s in self.specs)
        return f"Transformation({body})"
