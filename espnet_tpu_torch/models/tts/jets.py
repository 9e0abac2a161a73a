"""JETS: FastSpeech2 and a HiFiGAN head trained jointly as a GAN, with a
learned alignment (port of espnet_tpu/models/tts/jets.py).

Behavioral spec: reference `espnet2/gan_tts/jets/` (the generator, the
`AlignmentModule` and `ForwardSumLoss`, Gaussian upsampling), as the JAX
package formulates it. The encoder and decoder are the port's FastSpeech2
`FFTBlockStack`s (vanilla x*sqrt(d) + PE positions): every self-attention
goes to the flash kernel (head dim 128 at adim 256 and 2 heads) and every
FFN to the pre-norm FFN kernels (D 256, F 1024). The alignment search is
VITS's `maximum_path`. The forward-sum loss is CTC over the alignment
lattice: a weak blank column of -4.0 is prepended, log-softmaxed over
U+1, and the labels are the token positions 1..U, so S = 2U+1; it runs on
the port's CTC lattice pair through `ctc_loss_from_log_probs` (the warp
per utterance design up to S = 256, the block per utterance one above).

Randomness: the segment starts (`starts=`, else drawn from `generator`)
and dropout (on while training and a generator is given).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from espnet_tpu_torch.models.layers import KernelRouted, SameConv1d
from espnet_tpu_torch.models.tts.fastspeech2 import (FFTBlockStack,
                                                     VariancePredictor)
from espnet_tpu_torch.models.tts.hifigan import HiFiGANGenerator
from espnet_tpu_torch.models.tts.vits import (_slice_segments,
                                              _uniform_starts, maximum_path)
from espnet_tpu_torch.ops.ctc import ctc_loss_from_log_probs
from espnet_tpu_torch.ops.masks import make_valid_mask

_NEG = -1e9


class AlignmentModule(nn.Module):
    """log_softmax over the text of -||q_t - k_u||^2, with conv-projected
    text keys and mel queries (B, T, U)."""

    def __init__(self, d_text: int, n_mels: int, adim: int,
                 dtype=torch.float32):
        super().__init__()
        self.t_conv1 = SameConv1d(d_text, adim, 3, dtype=dtype)
        self.t_conv2 = SameConv1d(adim, adim, 1, dtype=dtype)
        self.f_conv1 = SameConv1d(n_mels, adim, 3, dtype=dtype)
        self.f_conv2 = SameConv1d(adim, adim, 3, dtype=dtype)
        self.f_conv3 = SameConv1d(adim, adim, 1, dtype=dtype)

    def forward(self, text_h, feats, text_mask):
        k = self.t_conv2(torch.relu(self.t_conv1(text_h)))
        q = torch.relu(self.f_conv1(feats))
        q = self.f_conv3(torch.relu(self.f_conv2(q)))
        score = (-torch.sum(q ** 2, -1)[:, :, None]
                 + 2.0 * torch.einsum("btd,bud->btu", q, k)
                 - torch.sum(k ** 2, -1)[:, None, :])
        score = torch.where(text_mask[:, None, :], score,
                            torch.full((), _NEG, device=score.device,
                                       dtype=score.dtype))
        return torch.log_softmax(score, dim=-1)


def forward_sum_loss(log_p_attn, text_lengths, feat_lengths,
                     use_kernels: bool = True):
    """The alignment forward-sum loss: the mean over utterances of the CTC
    negative log-likelihood of labels 1..U under the blank-prepended
    lattice, each divided by its U."""
    b, t, u = log_p_attn.shape
    pad = torch.full((b, t, 1), -4.0, dtype=log_p_attn.dtype,
                     device=log_p_attn.device)
    log_probs = torch.log_softmax(torch.cat([pad, log_p_attn], -1), dim=-1)
    labels = torch.arange(1, u + 1, device=log_p_attn.device)[None].expand(
        b, u)
    nll = ctc_loss_from_log_probs(log_probs, labels, feat_lengths,
                                  text_lengths, blank_id=0,
                                  use_kernels=use_kernels)
    return torch.mean(nll / text_lengths.clamp(min=1).to(nll.dtype))


def gaussian_upsample(hs, durations, feat_lengths, max_frames: int,
                      text_mask, sigma: float = 1.0):
    """(B, U, D) -> (B, T, D): frame t takes softmax_u(-(t - c_u)^2 /
    sigma) of the tokens, c_u = cumsum(d) - d/2, zero past each length."""
    centre = torch.cumsum(durations, dim=1) - 0.5 * durations
    t_grid = torch.arange(max_frames, dtype=torch.float32,
                          device=hs.device)[None, :, None]
    energy = -((t_grid - centre[:, None, :]) ** 2) / sigma
    energy = torch.where(text_mask[:, None, :], energy,
                         torch.full((), _NEG, device=hs.device))
    out = torch.einsum("btu,bud->btd", torch.softmax(energy, dim=-1), hs)
    fmask = make_valid_mask(feat_lengths, max_frames)[..., None]
    return out * fmask.to(out.dtype)


def average_by_path(x_frame, path, durations):
    """Frame values (B, T) -> token means (B, U) along a 0/1 path."""
    return torch.einsum("bt,btu->bu", x_frame, path) / durations.clamp(
        min=1.0)


@dataclasses.dataclass(frozen=True)
class JETSConfig:
    vocab_size: int = -1
    n_mels: int = 80
    adim: int = 256
    num_heads: int = 2
    d_ff: int = 1024
    encoder_layers: int = 4
    decoder_layers: int = 4
    predictor_layers: int = 2
    predictor_channels: int = 256
    predictor_kernel: int = 3
    decoder_channels: int = 512
    upsample_scales: Tuple[int, ...] = (8, 8, 2, 2)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    segment_frames: int = 32
    max_frames: int = 1000
    dropout_rate: float = 0.1
    dtype: Any = torch.float32


class JETSGenerator(KernelRouted):
    def __init__(self, config: JETSConfig):
        super().__init__()
        c = self.config = config
        self.embed = nn.Embedding(c.vocab_size, c.adim)
        self.encoder = FFTBlockStack(c.adim, c.num_heads, c.d_ff,
                                     c.encoder_layers, c.dropout_rate,
                                     c.dtype)
        self.decoder = FFTBlockStack(c.adim, c.num_heads, c.d_ff,
                                     c.decoder_layers, c.dropout_rate,
                                     c.dtype)
        self.alignment = AlignmentModule(c.adim, c.n_mels, c.adim, c.dtype)
        pk = dict(channels=c.predictor_channels, layers=c.predictor_layers,
                  kernel=c.predictor_kernel, dropout_rate=0.5, dtype=c.dtype)
        self.duration = VariancePredictor(c.adim, **pk)
        self.pitch = VariancePredictor(c.adim, **pk)
        self.energy = VariancePredictor(c.adim, **pk)
        self.pitch_embed = SameConv1d(1, c.adim, 9, dtype=c.dtype)
        self.energy_embed = SameConv1d(1, c.adim, 9, dtype=c.dtype)
        self.wav_decoder = HiFiGANGenerator(
            in_channels=c.adim, channels=c.decoder_channels,
            upsample_scales=c.upsample_scales,
            resblock_kernel_sizes=c.resblock_kernel_sizes, dtype=c.dtype)

    @property
    def upsample_factor(self) -> int:
        return int(np.prod(self.config.upsample_scales))

    def _embed(self, tokens):
        return self.embed(tokens.long()).to(self.config.dtype)

    def forward(self, tokens, text_lengths, feats, feat_lengths, pitch,
                energy, generator: Optional[torch.Generator] = None,
                starts=None):
        """The training forward: the dict the GAN step reads."""
        c = self.config
        drop = generator if self.training else None
        tmask = make_valid_mask(text_lengths, tokens.shape[1])
        hs = self.encoder(self._embed(tokens), text_lengths, drop)
        log_p_attn = self.alignment(hs, feats, tmask)
        path = maximum_path(log_p_attn.detach(), feat_lengths, text_lengths)
        ds = path.sum(1)
        p_tgt = average_by_path(pitch, path, ds)
        e_tgt = average_by_path(energy, path, ds)
        d_pred = self.duration(hs, tmask, drop)
        p_pred = self.pitch(hs, tmask, drop)
        e_pred = self.energy(hs, tmask, drop)
        hs = hs + self.pitch_embed(p_tgt[..., None])
        hs = hs + self.energy_embed(e_tgt[..., None])
        up = gaussian_upsample(hs, ds, feat_lengths, feats.shape[1], tmask)
        hd = self.decoder(up, feat_lengths, drop)
        seg = c.segment_frames
        starts = _uniform_starts(feat_lengths, seg, generator, starts)
        wav_seg = self.wav_decoder(_slice_segments(hd, starts, seg))
        return {
            "wav_seg": wav_seg[..., 0], "seg_starts": starts,
            "log_p_attn": log_p_attn, "durations": ds,
            "d_pred": d_pred, "p_pred": p_pred, "e_pred": e_pred,
            "p_tgt": p_tgt, "e_tgt": e_tgt,
            "text_mask": tmask.float(),
        }

    @torch.no_grad()
    def inference(self, tokens, text_lengths):
        """Text -> (wav (B, max_frames * upsample), lengths in samples)."""
        c = self.config
        tmask = make_valid_mask(text_lengths, tokens.shape[1])
        hs = self.encoder(self._embed(tokens), text_lengths)
        d_pred = self.duration(hs, tmask)
        p_pred = self.pitch(hs, tmask)
        e_pred = self.energy(hs, tmask)
        dur = torch.clamp(torch.round(torch.exp(d_pred) - 1.0), min=0)
        dur = dur * tmask
        hs = hs + self.pitch_embed(p_pred[..., None])
        hs = hs + self.energy_embed(e_pred[..., None])
        feat_lengths = dur.sum(1).clamp(max=c.max_frames).long()
        up = gaussian_upsample(hs, dur, feat_lengths, c.max_frames, tmask)
        hd = self.decoder(up, feat_lengths)
        wav = self.wav_decoder(hd)[..., 0]
        return wav, feat_lengths * self.upsample_factor
