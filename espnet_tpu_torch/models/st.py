"""Speech translation model: speech encoder -> translation decoder, with
auxiliary ASR losses on the source transcripts (port of
espnet_tpu/models/st.py).

Behavioral spec: reference `espnet2/st/espnet_model.py` (ESPnetSTModel).
`STConfig` is `ASRConfig` plus the source vocabulary, `asr_weight`,
`mtlalpha` and `num_asr_decoder_layers`. `STModel` has the frontend of the
JAX model (log-mel of raw input, SpecAug with its default masks while
training, global MVN from the `mvn` buffers (the JAX `mvn` collection) or
utterance MVN), a conformer or transformer encoder, the translation
decoder, a CTC head over the source vocabulary when `asr_weight` > 0 and
`mtlalpha` > 0, and a source-side `asr_decoder` when `mtlalpha` < 1. The
loss is the JAX code's:

    (1 - asr_weight) * st + asr_weight * (mtlalpha * ctc
                                          + (1 - mtlalpha) * asr_att)

(the JAX docstring's `mt_weight` term is not computed there, nor here).
sos = eos = vocab_size - 1 on both vocabularies; blank = 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from espnet_tpu_torch.models.asr import (ASRBase, ASRConfig, GlobalMVN,
                                         add_sos_eos)
from espnet_tpu_torch.models.conformer import ConformerEncoder
from espnet_tpu_torch.models.layers import Dense
from espnet_tpu_torch.models.transformer import (TransformerDecoder,
                                                 TransformerEncoder)
from espnet_tpu_torch.ops.ctc import ctc_loss
from espnet_tpu_torch.ops.losses import label_smoothing_loss, token_accuracy
from espnet_tpu_torch.ops.masks import make_valid_mask


@dataclasses.dataclass(frozen=True)
class STConfig(ASRConfig):
    """vocab_size = target (translation) vocab; src_vocab_size = source."""

    src_vocab_size: int = 0
    asr_weight: float = 0.3      # aux ASR multi-task weight
    mtlalpha: float = 1.0        # within-ASR CTC/attention split
    num_asr_decoder_layers: int = 2

    @property
    def src_sos_id(self) -> int:
        return self.src_vocab_size - 1


class STModel(ASRBase):
    def __init__(self, config: STConfig):
        super().__init__()
        c = config
        self.config = c
        if c.normalize == "global_mvn":
            self.mvn = GlobalMVN(c.n_mels)
        enc = dict(d_model=c.d_model, num_heads=c.num_heads, d_ff=c.d_ff,
                   num_layers=c.num_encoder_layers,
                   subsampling_factor=c.subsampling_factor, dtype=c.dtype,
                   dropout_rate=c.dropout_rate)
        if c.encoder_type == "conformer":
            self.encoder = ConformerEncoder(
                c.n_mels, kernel_size=c.conformer_kernel_size, **enc)
        else:
            self.encoder = TransformerEncoder(c.n_mels, **enc)
        self.decoder = TransformerDecoder(
            c.vocab_size, c.d_model, c.num_heads, c.decoder_d_ff,
            c.num_decoder_layers, c.dtype, c.dropout_rate)
        self.ctc_head = (Dense(c.d_model, c.src_vocab_size, dtype=c.dtype)
                         if c.asr_weight > 0 and c.mtlalpha > 0 else None)
        self.asr_decoder = (
            TransformerDecoder(c.src_vocab_size, c.d_model, c.num_heads,
                               c.decoder_d_ff, c.num_asr_decoder_layers,
                               c.dtype, c.dropout_rate)
            if c.asr_weight > 0 and c.mtlalpha < 1.0 else None)

    def frontend(self, speech, speech_lengths, generator=None):
        c = self.config
        feats, flens = self.task_frontend(
            speech, speech_lengths, generator, win_length=c.win_length,
            features=c.input_type != "raw")
        if c.normalize == "global_mvn":
            feats = self.mvn(feats, flens)
        return feats, flens

    def encode(self, speech, speech_lengths, generator=None):
        feats, flens = self.frontend(speech, speech_lengths, generator)
        return self.encoder(feats, flens, generator)

    def decoder_score_step(self, tokens_step, pos, memory, memory_lengths,
                           cache):
        return self.decoder.score_step(tokens_step, pos, memory,
                                       memory_lengths, cache)

    def decoder_init_cache(self, batch, max_len, memory=None,
                           memory_lengths=None):
        device = (memory.device if memory is not None
                  else next(self.parameters()).device)
        return self.decoder.init_cache(batch, max_len, device=device)

    def _att_loss(self, decoder, enc, enc_lengths, text, text_lengths, sos,
                  eos, generator):
        ys_in, ys_out, olens = add_sos_eos(text.long(), text_lengths.long(),
                                           sos, eos)
        logits = decoder(ys_in, olens, enc, enc_lengths, generator)
        valid = make_valid_mask(olens, ys_in.shape[1])
        loss = label_smoothing_loss(logits, ys_out, valid,
                                    self.config.lsm_weight)
        return loss, token_accuracy(logits, ys_out, valid)

    def forward(self, speech, speech_lengths, text, text_lengths,
                src_text=None, src_text_lengths=None, generator=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, stats): loss_st, acc, and with source transcripts and
        `asr_weight` > 0 loss_asr_ctc (`mtlalpha` > 0), loss_asr_att and
        asr_acc (`mtlalpha` < 1); then loss."""
        c = self.config
        self.require_generator(generator)
        enc, enc_lengths = self.encode(speech, speech_lengths, generator)
        loss_st, acc = self._att_loss(self.decoder, enc, enc_lengths, text,
                                      text_lengths, c.sos_id, c.eos_id,
                                      generator)
        stats = {"loss_st": loss_st, "acc": acc}
        loss = (1.0 - c.asr_weight) * loss_st
        if c.asr_weight > 0 and src_text is not None:
            loss_asr = 0.0
            if c.mtlalpha > 0:
                loss_ctc = ctc_loss(self.ctc_head(enc), src_text.long(),
                                    enc_lengths, src_text_lengths.long(),
                                    c.blank_id, use_kernels=self.use_kernels)
                stats["loss_asr_ctc"] = loss_ctc
                loss_asr = loss_asr + c.mtlalpha * loss_ctc
            if c.mtlalpha < 1.0:
                loss_att, asr_acc = self._att_loss(
                    self.asr_decoder, enc, enc_lengths, src_text,
                    src_text_lengths, c.src_sos_id, c.src_sos_id, generator)
                stats["loss_asr_att"] = loss_att
                stats["asr_acc"] = asr_acc
                loss_asr = loss_asr + (1.0 - c.mtlalpha) * loss_att
            loss = loss + c.asr_weight * loss_asr
        stats["loss"] = loss
        return loss, stats
