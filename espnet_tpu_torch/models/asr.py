"""Joint CTC/attention ASR model (port of espnet_tpu/models/asr.py).

The slice ported here: raw 16 kHz waveform -> log-mel -> SpecAug (training)
-> global MVN (stats in the `mvn` buffers, loaded from the JAX `mvn`
collection), utterance MVN or none -> Conv2d subsampling -> a conformer,
transformer, Branchformer or E-Branchformer encoder -> a CTC head and a
transformer decoder. `forward` is the training loss (CTC weight
`ctc_weight`, label-smoothed attention loss), `encode`, `ctc_log_probs` and
the decoder's step scoring serve inference. sos = eos = vocab_size - 1 and
blank = 0, as in the JAX package. Parameters are float32; `ASRConfig.dtype`
is the compute dtype (bfloat16 for the bench model).

Dropout and SpecAug are on while the model is training and the caller
passes a `torch.Generator`, from which all their randomness is drawn (the
FFN kernels' seeds included). InterCTC and the other encoder, decoder and
frontend families are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from espnet_tpu_torch.models.branchformer import VARIANTS, BranchformerEncoder
from espnet_tpu_torch.models.conformer import ConformerEncoder
from espnet_tpu_torch.models.layers import Dense
from espnet_tpu_torch.models.transformer import (TransformerDecoder,
                                                 TransformerEncoder)
from espnet_tpu_torch.ops.ctc import ctc_loss, min_frames
from espnet_tpu_torch.ops.losses import label_smoothing_loss, token_accuracy
from espnet_tpu_torch.ops.masks import make_valid_mask
from espnet_tpu_torch.ops.normalize import global_mvn, utterance_mvn
from espnet_tpu_torch.ops.specaug import specaug
from espnet_tpu_torch.ops.stft import log_mel_spectrogram


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    """The fields of the JAX `ASRConfig` that this slice serves, with the
    JAX defaults: a raw waveform frontend with SpecAug and a normalisation
    (`normalize`: "global_mvn" | "utterance_mvn" | "none"), an encoder
    (`encoder_type`: "conformer" | "transformer" | "branchformer" |
    "e_branchformer") and a transformer decoder."""

    vocab_size: int
    fs: int = 16000
    n_fft: int = 512
    hop_length: int = 128
    win_length: Optional[int] = None
    n_mels: int = 80
    use_specaug: bool = True
    num_freq_masks: int = 2
    freq_mask_width: Tuple[int, int] = (0, 20)
    num_time_masks: int = 2
    time_mask_width: Tuple[int, int] = (0, 40)
    normalize: str = "global_mvn"
    encoder_type: str = "conformer"
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 2048
    num_encoder_layers: int = 12
    subsampling_factor: int = 4
    conformer_kernel_size: int = 31
    num_decoder_layers: int = 6
    decoder_d_ff: int = 2048
    ctc_weight: float = 0.3
    lsm_weight: float = 0.1
    dropout_rate: float = 0.1
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


NORMALIZE = ("global_mvn", "utterance_mvn", "none")
MERGE_KERNEL = 3  # the JAX BranchformerEncoder's default; no config field


class GlobalMVN(nn.Module):
    """Global mean/variance normalisation with its stats in non-trainable
    buffers `mean` and `inv_std` (the JAX variables
    {"mvn": {"mvn": {"mean", "inv_std"}}}, filled by the collect-stats
    pass); identity stats until loaded."""

    def __init__(self, dim: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("inv_std", torch.ones(dim))

    def forward(self, x, lengths):
        return global_mvn(x, lengths, self.mean, self.inv_std)


def build_encoder(c: ASRConfig) -> nn.Module:
    """The encoder of `c.encoder_type`, built as the JAX `ASRModel` builds
    it (the branchformers' cgMLP width is d_ff, their conv kernel the
    conformer's)."""
    if c.encoder_type == "conformer":
        return ConformerEncoder(
            c.n_mels, c.d_model, c.num_heads, c.d_ff, c.num_encoder_layers,
            c.conformer_kernel_size, c.subsampling_factor, c.dtype,
            c.dropout_rate)
    if c.encoder_type == "transformer":
        return TransformerEncoder(
            c.n_mels, c.d_model, c.num_heads, c.d_ff, c.num_encoder_layers,
            c.subsampling_factor, c.dtype, c.dropout_rate)
    if c.encoder_type in VARIANTS:
        return BranchformerEncoder(
            c.n_mels, c.d_model, c.num_heads, c.d_ff, c.num_encoder_layers,
            cgmlp_hidden=c.d_ff, cgmlp_kernel=c.conformer_kernel_size,
            subsampling_factor=c.subsampling_factor, variant=c.encoder_type,
            merge_kernel=MERGE_KERNEL, dtype=c.dtype,
            dropout_rate=c.dropout_rate)
    raise NotImplementedError(
        f"encoder_type {c.encoder_type!r} is not ported (conformer, "
        f"transformer, {', '.join(VARIANTS)})")


class ASRModel(nn.Module):
    """Frontend + encoder + CTC head + transformer decoder."""

    def __init__(self, config: ASRConfig):
        super().__init__()
        if not 0.0 < config.ctc_weight < 1.0:
            raise NotImplementedError(
                "this slice serves joint CTC/attention models "
                "(0 < ctc_weight < 1)")
        c = config
        if c.normalize not in NORMALIZE:
            raise ValueError(f"normalize {c.normalize!r} not in {NORMALIZE}")
        self.config = c
        if c.normalize == "global_mvn":
            self.mvn = GlobalMVN(c.n_mels)
        self.encoder = build_encoder(c)
        self.decoder = TransformerDecoder(
            c.vocab_size, c.d_model, c.num_heads, c.decoder_d_ff,
            c.num_decoder_layers, c.dtype, c.dropout_rate)
        self.ctc_head = Dense(c.d_model, c.vocab_size, dtype=c.dtype)
        # False: the plain versions even on the card (chip_smoke.py compares)
        self.use_kernels = True

    def set_use_kernels(self, enabled: bool) -> None:
        """Route the encoder and the CTC loss through the CUDA kernels
        (default) or, when False, through their plain versions even on the
        card: every submodule with a `use_kernel` switch follows."""
        self.use_kernels = enabled
        for module in self.modules():
            if hasattr(module, "use_kernel"):
                module.use_kernel = enabled

    def frontend(self, speech, speech_lengths, generator=None):
        c = self.config
        feats, feat_lengths = log_mel_spectrogram(
            speech, speech_lengths, c.fs, c.n_fft, c.hop_length,
            c.win_length, c.n_mels)
        if c.use_specaug and self.training and generator is not None:
            feats = specaug(generator, feats, feat_lengths,
                            num_freq_masks=c.num_freq_masks,
                            freq_mask_width=c.freq_mask_width,
                            num_time_masks=c.num_time_masks,
                            time_mask_width=c.time_mask_width)
        if c.normalize == "global_mvn":
            feats = self.mvn(feats, feat_lengths)
        elif c.normalize == "utterance_mvn":
            feats = utterance_mvn(feats, feat_lengths)
        return feats, feat_lengths

    def encode(self, speech, speech_lengths, generator=None):
        """(B, N) waveform, (B,) lengths -> (encoder out (B, T', D),
        output lengths)."""
        feats, feat_lengths = self.frontend(speech, speech_lengths, generator)
        return self.encoder(feats, feat_lengths, generator)

    def forward(self, speech, speech_lengths, text, text_lengths,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training loss: (loss, stats with loss_ctc, ctc_infeasible,
        loss_att, acc and loss). text: (B, U) int labels padded past
        text_lengths. In training mode `generator` drives dropout and
        SpecAug and is required when either is configured."""
        c = self.config
        if (self.training and generator is None
                and (c.dropout_rate > 0.0 or c.use_specaug)):
            raise ValueError("training with dropout or SpecAug needs a "
                             "torch.Generator")
        enc, enc_lengths = self.encode(speech, speech_lengths, generator)
        text = text.long()
        text_lengths = text_lengths.long()
        stats = {}
        loss_ctc = ctc_loss(self.ctc_head(enc), text, enc_lengths,
                            text_lengths, c.blank_id,
                            use_kernels=self.use_kernels)
        stats["loss_ctc"] = loss_ctc
        # utterances too short for any CTC alignment (zero_infinity zeroes
        # them; a high share means the data or subsampling is wrong)
        need = text_lengths + min_frames(text, text_lengths)
        stats["ctc_infeasible"] = (enc_lengths < need).float().mean()
        ys_in, ys_out, ys_lengths = add_sos_eos(text, text_lengths, c.sos_id,
                                                c.eos_id)
        logits = self.decoder(ys_in, ys_lengths, enc, enc_lengths, generator)
        valid = make_valid_mask(ys_lengths, ys_in.shape[1])
        loss_att = label_smoothing_loss(logits, ys_out, valid, c.lsm_weight)
        stats["loss_att"] = loss_att
        stats["acc"] = token_accuracy(logits, ys_out, valid)
        loss = c.ctc_weight * loss_ctc + (1.0 - c.ctc_weight) * loss_att
        stats["loss"] = loss
        return loss, stats

    def ctc_log_probs(self, encoder_out):
        return torch.log_softmax(self.ctc_head(encoder_out).float(), dim=-1)

    def decoder_score_step(self, tokens_step, pos, memory, memory_lengths,
                           cache):
        return self.decoder.score_step(tokens_step, pos, memory,
                                       memory_lengths, cache)

    def decoder_init_cache(self, batch, max_len, device=None):
        return self.decoder.init_cache(batch, max_len, device)


def add_sos_eos(text, text_lengths, sos: int, eos: int):
    """(B, U) -> decoder input [sos, y] (B, U+1), target [y, eos] with 0
    past the end (B, U+1), and the output lengths text_lengths + 1."""
    b, u = text.shape
    ys_in = torch.cat([torch.full((b, 1), sos, dtype=text.dtype,
                                  device=text.device), text], dim=1)
    ys_out = torch.cat([text, torch.zeros((b, 1), dtype=text.dtype,
                                          device=text.device)], dim=1)
    pos = torch.arange(u + 1, device=text.device)[None, :]
    ys_out = torch.where(pos == text_lengths[:, None], eos, ys_out)
    ys_out = torch.where(pos > text_lengths[:, None], 0, ys_out)
    return ys_in, ys_out, text_lengths + 1


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
