"""FastSpeech2 (port of espnet_tpu/models/tts/fastspeech2.py).

Behavioral spec: reference `espnet2/tts/fastspeech2/fastspeech2.py:33`.
A transformer encoder over token ids, the variance adaptor (duration,
pitch and energy predictors, the length regulator), a transformer decoder
over the expanded frames, the mel projection and the postnet residual.
Loss: the masked mean L1 of the mel before and after the postnet, plus the
MSE of log duration, pitch and energy over the tokens.

Both stacks (`FFTBlockStack`) are the port's `TransformerEncoderLayer`s,
so every self-attention goes to the flash kernel (at d_model 384 and 2
heads its head dim is 192) and every FFN to the pre-norm FFN kernels; the
decoder runs over the mel frames (T = max_frames, 2048, at inference).
The length regulator is the JAX package's static-shape gather: output
frame t takes token sum(cumsum(dur) <= t), zeroed past the total.
The stacks' positions are the scaled encoding x + alpha * PE with a
trainable `pos_alpha` and no sqrt(d) scaling (`use_scaled_pos_enc`).
`Postnet` (BatchNorm with flax's running statistics) is shared with
Tacotron2 and Transformer-TTS. Dropout is on while the model is training
and the caller passes a generator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
from torch import nn

from espnet_tpu_torch.models.embedding import (add_positional_encoding,
                                               sinusoidal_table)
from espnet_tpu_torch.models.layers import (BatchNorm, Conv1d, Dense,
                                            KernelRouted, LayerNorm)
from espnet_tpu_torch.models.transformer import TransformerEncoderLayer
from espnet_tpu_torch.ops.dropout import Dropout
from espnet_tpu_torch.ops.masks import attention_bias, make_valid_mask


@dataclasses.dataclass(frozen=True)
class FastSpeech2Config:
    vocab_size: int = -1
    n_mels: int = 80
    d_model: int = 384
    num_heads: int = 2
    d_ff: int = 1536
    encoder_layers: int = 4
    decoder_layers: int = 4
    predictor_layers: int = 2
    predictor_channels: int = 256
    predictor_kernel: int = 3
    postnet_layers: int = 5
    postnet_channels: int = 512
    use_scaled_pos_enc: bool = True
    spks: int = 0
    langs: int = 0
    spk_embed_dim: int = 0
    spk_embed_integration_type: str = "add"
    dropout_rate: float = 0.1
    max_frames: int = 2048
    dtype: Any = torch.float32


class VariancePredictor(nn.Module):
    """Conv -> relu -> LayerNorm -> dropout, `layers` times, then a scalar
    per token, zeroed on padding (`fastspeech2/variance_predictor.py`)."""

    def __init__(self, d_in: int, channels: int, layers: int, kernel: int,
                 dropout_rate: float, dtype=torch.float32):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"conv{i}", Conv1d(d_in if i == 0 else channels,
                                               channels, kernel, dtype=dtype))
            self.add_module(f"norm{i}", LayerNorm(channels, dtype))
        self.out = Dense(channels, 1, dtype=dtype)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, mask, generator=None):
        h = x
        for i in range(self.layers):
            h = torch.relu(getattr(self, f"conv{i}")(h))
            h = self.dropout(getattr(self, f"norm{i}")(h), generator)
        out = self.out(h)[..., 0]
        return out * mask.to(out.dtype)


def length_regulate(hs: torch.Tensor, durations: torch.Tensor,
                    max_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand token states (B, U, D) by integer durations (B, U): returns
    (B, max_frames, D), zero past each total, and the totals capped at
    max_frames."""
    cum = torch.cumsum(durations.long(), dim=1)
    total = cum[:, -1]
    t = torch.arange(max_frames, device=hs.device)
    idx = (cum[:, None, :] <= t[None, :, None]).sum(-1)
    idx = idx.clamp(max=hs.shape[1] - 1)
    out = torch.gather(hs, 1, idx[..., None].expand(-1, -1, hs.shape[2]))
    valid = (t[None, :] < total[:, None])[..., None]
    return out * valid.to(out.dtype), total.clamp(max=max_frames)


class Postnet(nn.Module):
    """`layers` x (conv k5 without bias -> BatchNorm -> tanh but on the last
    -> dropout 0.5) (`tacotron2/decoder.py` Postnet:150)."""

    def __init__(self, n_mels: int, channels: int, layers: int,
                 dtype=torch.float32, use_batch_norm: bool = True):
        super().__init__()
        self.layers = layers
        self.use_batch_norm = use_batch_norm
        for i in range(layers):
            last = i == layers - 1
            self.add_module(f"conv{i}", Conv1d(
                n_mels if i == 0 else channels,
                n_mels if last else channels, 5, bias=False, dtype=dtype))
            if use_batch_norm:
                self.add_module(f"norm{i}", BatchNorm(
                    n_mels if last else channels))
        self.dropout = Dropout(0.5)

    def forward(self, x, generator=None):
        h = x
        for i in range(self.layers):
            h = getattr(self, f"conv{i}")(h)
            if self.use_batch_norm:
                h = getattr(self, f"norm{i}")(h)
            if i < self.layers - 1:
                h = torch.tanh(h)
            h = self.dropout(h, generator)
        return h


class FFTBlockStack(nn.Module):
    """Positions, dropout, `layers` transformer encoder layers, the final
    LayerNorm; zero on padding. `scaled_pos`: x + pos_alpha * PE (no sqrt(d)
    scaling), else the vanilla x * sqrt(d) + PE."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, layers: int,
                 dropout_rate: float, dtype=torch.float32,
                 scaled_pos: bool = False):
        super().__init__()
        self.layers = layers
        self.scaled_pos = scaled_pos
        if scaled_pos:
            self.pos_alpha = nn.Parameter(torch.ones(1))
        self.dropout = Dropout(dropout_rate)
        for i in range(layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                d_model, num_heads, d_ff, dtype, dropout_rate))
        self.final_norm = LayerNorm(d_model, dtype)

    def init_random_(self, generator):
        if self.scaled_pos:
            with torch.no_grad():
                self.pos_alpha.fill_(1.0)

    def forward(self, x, lengths, generator=None):
        mask = make_valid_mask(lengths, x.shape[1])
        bias = attention_bias(mask[:, None, None, :])
        if self.scaled_pos:
            pe = torch.from_numpy(sinusoidal_table(x.shape[1], x.shape[2]))
            x = x + self.pos_alpha.to(x.dtype) * pe.to(x.device, x.dtype)
        else:
            x = add_positional_encoding(x)
        x = self.dropout(x, generator)
        for i in range(self.layers):
            x = getattr(self, f"layer{i}")(x, bias, generator)
        x = self.final_norm(x)
        return x * mask[..., None].to(x.dtype)


def masked_l1(pred, target, fmask, n_mels):
    """sum |pred - target| over valid frames / (frames * n_mels)."""
    n_el = fmask.sum().clamp(min=1.0) * n_mels
    return (torch.abs(pred.float() - target.float()) * fmask).sum() / n_el


def variance_losses(d_pred, p_pred, e_pred, durations, pitch, energy, tmask):
    """MSE of log(duration + 1), pitch and energy over the valid tokens."""
    tm = tmask.float()
    n_tok = tm.sum().clamp(min=1.0)
    log_dur = torch.log(durations.float() + 1.0)

    def mse(a, b):
        return (((a.float() - b.float()) ** 2) * tm).sum() / n_tok

    return mse(d_pred, log_dur), mse(p_pred, pitch), mse(e_pred, energy)


class VarianceAdaptorMixin:
    """The three predictors and the pitch/energy embeddings, shared by
    FastSpeech2 and ProDiff (the JAX models' attribute names)."""

    def _build_variance(self, c):
        pk = dict(channels=c.predictor_channels, layers=c.predictor_layers,
                  kernel=c.predictor_kernel, dropout_rate=0.5, dtype=c.dtype)
        self.duration = VariancePredictor(c.d_model, **pk)
        self.pitch = VariancePredictor(c.d_model, **pk)
        self.energy = VariancePredictor(c.d_model, **pk)
        self.pitch_embed = Conv1d(1, c.d_model, 9, dtype=c.dtype)
        self.energy_embed = Conv1d(1, c.d_model, 9, dtype=c.dtype)

    def _variance(self, hs, text_lengths, generator):
        tmask = make_valid_mask(text_lengths, hs.shape[1])
        return (self.duration(hs, tmask, generator),
                self.pitch(hs, tmask, generator),
                self.energy(hs, tmask, generator), tmask)

    def _add_variance(self, hs, pitch, energy):
        hs = hs + self.pitch_embed(pitch[..., None])
        return hs + self.energy_embed(energy[..., None])


class FastSpeech2(KernelRouted, VarianceAdaptorMixin):
    def __init__(self, config: FastSpeech2Config):
        super().__init__()
        c = self.config = config
        self.embed = nn.Embedding(c.vocab_size, c.d_model)
        stack = dict(d_model=c.d_model, num_heads=c.num_heads, d_ff=c.d_ff,
                     dropout_rate=c.dropout_rate, dtype=c.dtype,
                     scaled_pos=c.use_scaled_pos_enc)
        self.encoder = FFTBlockStack(layers=c.encoder_layers, **stack)
        self.decoder = FFTBlockStack(layers=c.decoder_layers, **stack)
        self._build_variance(c)
        self.spk_cond = self.spk_cond_proj = None
        if c.spks > 1 or c.langs > 1 or c.spk_embed_dim > 0:
            from espnet_tpu_torch.models.tts.spk_embed import \
                SpeakerConditioner

            self.spk_cond = SpeakerConditioner(
                spks=c.spks, langs=c.langs, spk_embed_dim=c.spk_embed_dim,
                integration_type=c.spk_embed_integration_type,
                units=c.d_model, dtype=c.dtype)
            if c.spk_embed_dim > 0 and \
                    c.spk_embed_integration_type == "concat":
                self.spk_cond_proj = Dense(c.d_model + c.spk_embed_dim,
                                           c.d_model, dtype=c.dtype)
        self.mel_out = Dense(c.d_model, c.n_mels, dtype=c.dtype)
        self.postnet = Postnet(c.n_mels, c.postnet_channels,
                               c.postnet_layers, c.dtype)

    def _encode(self, text, text_lengths, generator, sids=None, lids=None,
                spembs=None):
        x = self.embed(text).to(self.config.dtype)
        hs = self.encoder(x, text_lengths, generator)
        if self.spk_cond is not None:
            hs = self.spk_cond(hs, sids, lids, spembs)
            if self.spk_cond_proj is not None:
                hs = self.spk_cond_proj(hs)
        return hs

    def forward(self, text, text_lengths, mel, mel_lengths, durations,
                pitch, energy, sids=None, lids=None, spembs=None,
                generator=None):
        """Teacher-forced training forward: (loss, stats, mel_post)."""
        c = self.config
        hs = self._encode(text, text_lengths, generator, sids, lids, spembs)
        d_pred, p_pred, e_pred, tmask = self._variance(hs, text_lengths,
                                                       generator)
        hs = self._add_variance(hs, pitch, energy)
        t_max = mel.shape[1]
        hs_exp, _ = length_regulate(hs, durations, t_max)
        hd = self.decoder(hs_exp, mel_lengths, generator)
        mel_before = self.mel_out(hd)
        mel_post = mel_before + self.postnet(mel_before, generator)
        fmask = make_valid_mask(mel_lengths, t_max)[..., None].float()
        l1 = (masked_l1(mel_before, mel, fmask, c.n_mels)
              + masked_l1(mel_post, mel, fmask, c.n_mels))
        dur_loss, pitch_loss, energy_loss = variance_losses(
            d_pred, p_pred, e_pred, durations, pitch, energy, tmask)
        loss = l1 + dur_loss + pitch_loss + energy_loss
        stats = {"loss": loss, "l1_loss": l1, "duration_loss": dur_loss,
                 "pitch_loss": pitch_loss, "energy_loss": energy_loss}
        return loss, stats, mel_post

    def predict_durations(self, d_pred, tmask, speed: float = 1.0):
        """round((exp(log-dur) - 1) / speed) clipped at 0, on the tokens;
        torch.round rounds half to even, as jnp.round."""
        dur = torch.round((torch.exp(d_pred.float()) - 1.0) / speed)
        return dur.clamp(min=0).long() * tmask.long()

    @torch.no_grad()
    def inference(self, text, text_lengths, speed: float = 1.0, sids=None,
                  lids=None, spembs=None):
        """Synthesis with the predicted variances: (mel (B, max_frames,
        n_mels), lengths), zero past each length."""
        c = self.config
        hs = self._encode(text, text_lengths, None, sids, lids, spembs)
        d_pred, p_pred, e_pred, tmask = self._variance(hs, text_lengths,
                                                       None)
        dur = self.predict_durations(d_pred, tmask, speed)
        hs = self._add_variance(hs, p_pred, e_pred)
        hs_exp, out_lens = length_regulate(hs, dur, c.max_frames)
        hd = self.decoder(hs_exp, out_lens, None)
        mel_before = self.mel_out(hd)
        mel_post = mel_before + self.postnet(mel_before, None)
        mask = make_valid_mask(out_lens, c.max_frames)[..., None]
        return mel_post * mask.to(mel_post.dtype), out_lens
