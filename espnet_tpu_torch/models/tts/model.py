"""TTS task model (port of espnet_tpu/models/tts/model.py).

Behavioral spec: reference `espnet2/tts/espnet_model.py:28`: the log-mel
features of the raw speech (`ops/stft.log_mel_spectrogram`, the TTS
frontend: 16 kHz, n_fft 1024, hop 256, 80 mels, fmin 80, fmax 7600 by
default), global MVN, then the TTS module of `tts_type` (tacotron2 |
fastspeech2 | transformer | prodiff). Tacotron2 and Transformer-TTS cut
the mel to a multiple of their reduction factor (`_fit_reduction`).
FastSpeech2 and ProDiff need durations; their pitch and energy targets
are zeros where none are given, as in JAX. `inference` returns the mel in
the normalised domain, in eval mode whatever the model's mode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from espnet_tpu_torch.models.asr import GlobalMVN
from espnet_tpu_torch.models.layers import KernelRouted
from espnet_tpu_torch.models.tts.fastspeech2 import (FastSpeech2,
                                                     FastSpeech2Config)
from espnet_tpu_torch.models.tts.prodiff import ProDiff, ProDiffConfig
from espnet_tpu_torch.models.tts.tacotron2 import Tacotron2, Tacotron2Config
from espnet_tpu_torch.models.tts.transformer_tts import (
    TransformerTTS, TransformerTTSConfig)
from espnet_tpu_torch.ops.stft import log_mel_spectrogram

@dataclasses.dataclass(frozen=True)
class TTSTaskConfig:
    tts_type: str = "tacotron2"
    vocab_size: int = -1
    fs: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: Optional[int] = None
    n_mels: int = 80
    fmin: float = 80.0
    fmax: Optional[float] = 7600.0
    normalize: str = "global_mvn"  # global_mvn | none
    tacotron2: Optional[Tacotron2Config] = None
    fastspeech2: Optional[FastSpeech2Config] = None
    transformer: Optional[TransformerTTSConfig] = None
    prodiff: Optional[ProDiffConfig] = None


def build_tts(c: TTSTaskConfig):
    if c.tts_type == "tacotron2":
        return Tacotron2(c.tacotron2)
    if c.tts_type == "fastspeech2":
        return FastSpeech2(c.fastspeech2)
    if c.tts_type == "transformer":
        return TransformerTTS(c.transformer)
    if c.tts_type == "prodiff":
        return ProDiff(c.prodiff)
    raise ValueError(f"unknown tts_type {c.tts_type}")


class TTSModel(KernelRouted):
    def __init__(self, config: TTSTaskConfig):
        super().__init__()
        self.config = config
        self.tts = build_tts(config)
        if config.normalize == "global_mvn":
            self.mvn = GlobalMVN(config.n_mels)

    def extract_feats(self, speech, speech_lengths):
        c = self.config
        mel, mel_lengths = log_mel_spectrogram(
            speech, speech_lengths, c.fs, c.n_fft, c.hop_length,
            c.win_length, c.n_mels, c.fmin, c.fmax)
        if c.normalize == "global_mvn":
            mel = self.mvn(mel, mel_lengths)
        return mel, mel_lengths

    def _fit_reduction(self, mel, mel_lengths):
        c = self.config
        if c.tts_type in ("tacotron2", "transformer"):
            sub = c.tacotron2 if c.tts_type == "tacotron2" else c.transformer
            r = sub.reduction_factor
            if r > 1:
                t = (mel.shape[1] // r) * r
                mel = mel[:, :t]
                mel_lengths = torch.clamp((mel_lengths // r) * r, max=t)
        return mel, mel_lengths

    def forward(self, text, text_lengths, speech, speech_lengths,
                durations=None, pitch=None, energy=None, sids=None,
                lids=None, spembs=None, generator=None):
        c = self.config
        mel, mel_lengths = self.extract_feats(speech, speech_lengths)
        mel, mel_lengths = self._fit_reduction(mel, mel_lengths)
        spk = dict(sids=sids, lids=lids, spembs=spembs)
        if c.tts_type == "tacotron2":
            loss, stats, _ = self.tts(text, text_lengths, mel, mel_lengths,
                                      generator=generator, **spk)
        elif c.tts_type == "transformer":
            loss, stats, _ = self.tts(text, text_lengths, mel, mel_lengths,
                                      generator=generator)
        else:
            if durations is None:
                raise ValueError(f"{c.tts_type} training requires durations")
            z = torch.zeros(text.shape, dtype=torch.float32,
                            device=text.device)
            extra = spk if c.tts_type == "fastspeech2" else {}
            loss, stats, _ = self.tts(
                text, text_lengths, mel, mel_lengths, durations,
                pitch if pitch is not None else z,
                energy if energy is not None else z, generator=generator,
                **extra)
        return loss, stats

    @torch.no_grad()
    def inference(self, text, text_lengths, max_frames: Optional[int] = None,
                  sids=None, lids=None, spembs=None, generator=None):
        """(mel, lengths) in the normalised domain; callers denormalise with
        the MVN statistics before vocoding. `generator`: Tacotron2's prenet
        dropout and ProDiff's noise."""
        was = self.training
        self.eval()
        try:
            t = self.config.tts_type
            if t == "tacotron2":
                mel, lens, _ = self.tts.inference(
                    text, text_lengths, max_frames, sids=sids, lids=lids,
                    spembs=spembs, generator=generator)
                return mel, lens
            if t == "transformer":
                return self.tts.inference(text, text_lengths, max_frames)
            if t == "prodiff":
                return self.tts.inference(text, text_lengths, max_frames,
                                          generator=generator)
            return self.tts.inference(text, text_lengths, sids=sids,
                                      lids=lids, spembs=spembs)
        finally:
            self.train(was)
