"""HuBERT masked-prediction pretraining (port of espnet_tpu/models/hubert.py).

ESPnet's HubertPretrainModel (`espnet2/hubert/espnet_model.py`): frame
features (log-mel of the raw waveform and utterance MVN, or precomputed
features) -> `in_proj` -> span masking with the learned `mask_emb` ->
sinusoidal positions -> `TransformerEncoderLayer`s (`models/
transformer.py`: flash attention and the pre-norm FFN kernels on the card)
-> `after_norm` (eps 1e-6) -> `final_proj` to the k-means classes; the
loss is `pred_masked_weight` x the cross-entropy over masked frames plus
`pred_nomask_weight` x that over unmasked ones, with the stats loss,
loss_masked, loss_unmasked, acc_masked and mask_ratio.

The span mask draws Bernoulli span starts with probability `mask_prob` on
valid frames and dilates each over the next `mask_length` frames (frame t
is masked iff a start lies in (t - mask_length, t], the JAX
`reduce_window` max). The starts come from the caller's generator while
the model is training, else from one seeded 0 (the JAX model's fixed
PRNGKey(0) then; the draws themselves differ from JAX's, so tests inject
`starts`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from espnet_tpu_torch.models.embedding import add_positional_encoding
from espnet_tpu_torch.models.layers import Dense, KernelRouted, LayerNorm
from espnet_tpu_torch.models.transformer import TransformerEncoderLayer
from espnet_tpu_torch.ops.masks import attention_bias, make_valid_mask
from espnet_tpu_torch.ops.normalize import utterance_mvn
from espnet_tpu_torch.ops.stft import log_mel_spectrogram


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    num_classes: int = 100       # k-means clusters
    input_type: str = "raw"      # raw | feats (n_mels wide)
    fs: int = 16000
    n_fft: int = 512
    hop_length: int = 128
    n_mels: int = 80
    normalize: str = "utterance_mvn"
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 1024
    num_encoder_layers: int = 6
    dropout_rate: float = 0.1
    mask_prob: float = 0.08      # probability that a frame starts a span
    mask_length: int = 10
    pred_masked_weight: float = 1.0
    pred_nomask_weight: float = 0.0
    dtype: torch.dtype = torch.float32


def dilate_spans(starts: torch.Tensor, window: int) -> torch.Tensor:
    """(B, T) bool span starts -> (B, T) bool: t is True iff a start lies
    in (t - window, t]."""
    x = starts.float()[:, None, :]
    x = nn.functional.pad(x, (window - 1, 0))
    return nn.functional.max_pool1d(x, window, stride=1)[:, 0] > 0


class HubertModel(KernelRouted):
    """`in_proj`, `mask_emb`, `layer{i}`, `after_norm` and `final_proj`, as
    the JAX model names them."""

    def __init__(self, config: HubertConfig):
        super().__init__()
        c = config
        self.config = c
        self.in_proj = Dense(c.n_mels, c.d_model, dtype=c.dtype)
        self.mask_emb = nn.Parameter(torch.zeros(c.d_model))
        for i in range(c.num_encoder_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                c.d_model, c.num_heads, c.d_ff, c.dtype, c.dropout_rate))
        self.after_norm = LayerNorm(c.d_model, c.dtype)
        self.final_proj = Dense(c.d_model, c.num_classes, dtype=c.dtype)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """`mask_emb` uniform in [0, 1) (flax `uniform(1.0)`)."""
        self.mask_emb.copy_(torch.rand(self.mask_emb.shape,
                                       generator=generator))

    def layers(self) -> list:
        return [getattr(self, f"layer{i}")
                for i in range(self.config.num_encoder_layers)]

    def frontend(self, speech, speech_lengths):
        c = self.config
        if c.input_type == "raw":
            feats, flens = log_mel_spectrogram(
                speech, speech_lengths, c.fs, c.n_fft, c.hop_length, None,
                c.n_mels)
        else:
            feats, flens = speech, speech_lengths
        if c.normalize == "utterance_mvn":
            feats = utterance_mvn(feats, flens)
        return feats, flens

    def span_mask(self, valid: torch.Tensor, generator=None,
                  starts: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T) valid frames -> the (B, T) mask; `starts` (B, T) bool
        injects the span starts in place of the draw."""
        c = self.config
        if starts is None:
            gen = (generator if self.training and generator is not None
                   else torch.Generator().manual_seed(0))
            starts = (torch.rand(valid.shape, generator=gen)
                      < c.mask_prob).to(valid.device)
        starts = starts.to(valid.device) & valid
        return dilate_spans(starts, c.mask_length) & valid

    def encode_features(self, feats, flens, mask=None, generator=None):
        """Features (B, T, n_mels) -> (after_norm output (B, T, D))."""
        x = self.in_proj(feats)
        if mask is not None:
            x = torch.where(mask[:, :, None], self.mask_emb.to(x.dtype), x)
        x = add_positional_encoding(x)
        bias = attention_bias(make_valid_mask(flens, x.shape[1])[
            :, None, None, :])
        for layer in self.layers():
            x = layer(x, bias, generator)
        return self.after_norm(x)

    def encode(self, speech, speech_lengths, mask=None, generator=None):
        """(B, N) waveforms -> (encoder output (B, T, D), frame lengths)."""
        feats, flens = self.frontend(speech, speech_lengths)
        return self.encode_features(feats, flens, mask, generator), flens

    def forward(self, speech, speech_lengths, labels,
                generator: Optional[torch.Generator] = None,
                starts: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """labels: (B, T_frames) k-means ids on the frontend's frame grid.
        Returns (loss, stats). In training mode with dropout the caller's
        `generator` is required; it also draws the span starts."""
        c = self.config
        if self.training and generator is None and c.dropout_rate > 0.0:
            raise ValueError("training with dropout needs a torch.Generator")
        feats, flens = self.frontend(speech, speech_lengths)
        valid = make_valid_mask(flens, feats.shape[1])
        mask = self.span_mask(valid, generator, starts)
        enc = self.encode_features(feats, flens, mask, generator)
        logits = self.final_proj(enc).float()
        t = min(logits.shape[1], labels.shape[1])
        logits, labels_t = logits[:, :t], labels[:, :t].long()
        mask_t, valid_t = mask[:, :t], valid[:, :t]
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, labels_t[..., None])[..., 0]

        def masked_mean(region):
            w = region.float()
            return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)

        loss_m = masked_mean(mask_t & valid_t)
        loss_u = masked_mean(~mask_t & valid_t)
        loss = c.pred_masked_weight * loss_m + c.pred_nomask_weight * loss_u
        pred = logits.argmax(-1)
        hit = (pred == labels_t) & mask_t & valid_t
        acc_m = hit.sum() / torch.clamp((mask_t & valid_t).sum(), min=1)
        stats = {"loss": loss, "loss_masked": loss_m,
                 "loss_unmasked": loss_u, "acc_masked": acc_m.float(),
                 "mask_ratio": mask_t.float().mean()}
        return loss, stats
