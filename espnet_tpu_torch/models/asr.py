"""Joint CTC/attention ASR model, inference half (port of
espnet_tpu/models/asr.py).

The slice ported here: raw 16 kHz waveform -> log-mel -> utterance MVN ->
Conv2d subsampling -> conformer encoder -> CTC log-probs and a transformer
decoder scored step by step. sos = eos = vocab_size - 1 and blank = 0, as in
the JAX package. Parameters are float32; `ASRConfig.dtype` is the compute
dtype (bfloat16 for the bench model). SpecAug, dropout, the losses and the
other encoder, decoder and frontend families are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from espnet_tpu_torch.models.conformer import ConformerEncoder
from espnet_tpu_torch.models.layers import Dense
from espnet_tpu_torch.models.transformer import TransformerDecoder
from espnet_tpu_torch.ops.normalize import utterance_mvn
from espnet_tpu_torch.ops.stft import log_mel_spectrogram


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    """The fields of the JAX `ASRConfig` that this slice serves: a raw
    waveform frontend with utterance MVN, a conformer encoder and a
    transformer decoder (the JAX choice fields' values for the bench
    model)."""

    vocab_size: int
    fs: int = 16000
    n_fft: int = 512
    hop_length: int = 128
    win_length: Optional[int] = None
    n_mels: int = 80
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 2048
    num_encoder_layers: int = 12
    subsampling_factor: int = 4
    conformer_kernel_size: int = 31
    num_decoder_layers: int = 6
    decoder_d_ff: int = 2048
    ctc_weight: float = 0.3
    dtype: torch.dtype = torch.float32

    @property
    def sos_id(self) -> int:
        return self.vocab_size - 1

    @property
    def eos_id(self) -> int:
        return self.vocab_size - 1

    @property
    def blank_id(self) -> int:
        return 0


class ASRModel(nn.Module):
    """Frontend + conformer encoder + CTC head + transformer decoder."""

    def __init__(self, config: ASRConfig):
        super().__init__()
        if not 0.0 < config.ctc_weight < 1.0:
            raise NotImplementedError(
                "this slice serves joint CTC/attention models "
                "(0 < ctc_weight < 1)")
        c = config
        self.config = c
        self.encoder = ConformerEncoder(
            c.n_mels, c.d_model, c.num_heads, c.d_ff, c.num_encoder_layers,
            c.conformer_kernel_size, c.subsampling_factor, c.dtype)
        self.decoder = TransformerDecoder(
            c.vocab_size, c.d_model, c.num_heads, c.decoder_d_ff,
            c.num_decoder_layers, c.dtype)
        self.ctc_head = Dense(c.d_model, c.vocab_size, dtype=c.dtype)

    def set_use_kernels(self, enabled: bool) -> None:
        """Route the encoder through the CUDA kernels (default) or, when
        False, through their plain versions even on the card."""
        for layer in self.encoder.layers():
            layer.use_kernel = enabled
            layer.self_attn.use_kernel = enabled

    def frontend(self, speech, speech_lengths):
        c = self.config
        feats, feat_lengths = log_mel_spectrogram(
            speech, speech_lengths, c.fs, c.n_fft, c.hop_length,
            c.win_length, c.n_mels)
        return utterance_mvn(feats, feat_lengths), feat_lengths

    def encode(self, speech, speech_lengths):
        """(B, N) waveform, (B,) lengths -> (encoder out (B, T', D),
        output lengths)."""
        feats, feat_lengths = self.frontend(speech, speech_lengths)
        return self.encoder(feats, feat_lengths)

    def ctc_log_probs(self, encoder_out):
        return torch.log_softmax(self.ctc_head(encoder_out).float(), dim=-1)

    def decoder_score_step(self, tokens_step, pos, memory, memory_lengths,
                           cache):
        return self.decoder.score_step(tokens_step, pos, memory,
                                       memory_lengths, cache)

    def decoder_init_cache(self, batch, max_len, device=None):
        return self.decoder.init_cache(batch, max_len, device)


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from `generator`, in place: Xavier-uniform
    weights, N(0, 1) embeddings, zero biases and position biases, unit
    LayerNorm scales (the JAX package's initialisers, drawn from torch)."""
    for name, prm in model.named_parameters():
        owner = name.split(".")[-2]
        if name.endswith((".bias", "pos_bias_u", "pos_bias_v")):
            prm.zero_()
        elif "norm" in owner:
            prm.fill_(1.0)
        elif owner == "embed":
            prm.copy_(torch.randn(prm.shape, generator=generator))
        else:
            receptive = prm[0, 0].numel() if prm.ndim > 2 else 1
            fan_in, fan_out = prm.shape[1] * receptive, prm.shape[0] * receptive
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            prm.copy_((torch.rand(prm.shape, generator=generator) * 2 - 1)
                      * bound)
    return model
