"""Voice conversion model (port of espnet_tpu/models/tts/vc.py).

Behavioral spec: reference `espnet/nets/pytorch_backend/e2e_vc_tacotron2.py`
and `e2e_vc_transformer.py`: a Tacotron2 (or the Voice Transformer
Network, `vc_type="transformer"`) whose encoder takes the source
speaker's log-mel frames; loss and synthesis are the TTS model's. No
global MVN, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from espnet_tpu_torch.models.layers import KernelRouted
from espnet_tpu_torch.models.tts.tacotron2 import Tacotron2, Tacotron2Config
from espnet_tpu_torch.models.tts.transformer_tts import (
    TransformerTTS, TransformerTTSConfig)
from espnet_tpu_torch.ops.stft import log_mel_spectrogram

VC_BATCH_KEYS = ("src_speech", "src_speech_lengths", "speech",
                 "speech_lengths")


@dataclasses.dataclass(frozen=True)
class VCTaskConfig:
    fs: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: Optional[int] = None
    n_mels: int = 80
    fmin: float = 80.0
    fmax: Optional[float] = 7600.0
    vc_type: str = "tacotron2"  # tacotron2 | transformer (VTN)
    tacotron2: Optional[Tacotron2Config] = None
    transformer: Optional[TransformerTTSConfig] = None


class VCModel(KernelRouted):
    def __init__(self, config: VCTaskConfig):
        super().__init__()
        self.config = config
        if config.vc_type == "transformer":
            tcfg = config.transformer or TransformerTTSConfig()
            if tcfg.input_type != "feats":
                tcfg = dataclasses.replace(tcfg, input_type="feats",
                                           input_dim=config.n_mels,
                                           n_mels=config.n_mels)
            self.tts = TransformerTTS(tcfg)
        else:
            self.tts = Tacotron2(config.tacotron2)

    def extract_feats(self, speech, speech_lengths):
        c = self.config
        return log_mel_spectrogram(speech, speech_lengths, c.fs, c.n_fft,
                                   c.hop_length, c.win_length, c.n_mels,
                                   c.fmin, c.fmax)

    def forward(self, src_speech, src_speech_lengths, speech, speech_lengths,
                generator=None):
        src_mel, src_lens = self.extract_feats(src_speech, src_speech_lengths)
        tgt_mel, tgt_lens = self.extract_feats(speech, speech_lengths)
        r = self.tts.config.reduction_factor
        if r > 1:
            t = (tgt_mel.shape[1] // r) * r
            tgt_mel = tgt_mel[:, :t]
            tgt_lens = torch.clamp((tgt_lens // r) * r, max=t)
        loss, stats, _ = self.tts(src_mel, src_lens, tgt_mel, tgt_lens,
                                  generator=generator)
        return loss, stats

    @torch.no_grad()
    def inference(self, src_speech, src_speech_lengths,
                  max_frames: Optional[int] = None):
        was = self.training
        self.eval()
        try:
            src_mel, src_lens = self.extract_feats(src_speech,
                                                   src_speech_lengths)
            out = self.tts.inference(src_mel, src_lens, max_frames)
            return out[0], out[1]
        finally:
            self.train(was)
