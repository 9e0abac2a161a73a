"""Tacotron2 (port of espnet_tpu/models/tts/tacotron2.py).

Behavioral spec: reference `espnet2/tts/tacotron2/tacotron2.py:26`,
`espnet/nets/pytorch_backend/tacotron2/{encoder.py:20,decoder.py:269}` and
`e2e_tts_tacotron2.py` (`Tacotron2Loss:163`, `GuidedAttentionLoss:22`).
Encoder: embedding (or a projection of input frames, for VC), convolutions
with BatchNorm (flax's running statistics) and relu, then a BLSTM whose
backward direction is reversed within each utterance's length (flax
`nn.RNN(..., reverse=True, keep_order=True)` with seq_lengths). Decoder, one
step a frame group: location-sensitive attention (AttLoc, scaling 2.0, the
cumulative weights as its conv input after step 0), the prenet whose
dropout is always on, the LSTM stack with zoneout, the frame and stop-token
projections; the postnet residual. Loss: L1 + MSE of the mels before and
after the postnet, the positively weighted stop BCE, the guided-attention
loss.

The JAX package wraps one step in `nn.scan`; here the step is a Python loop
over the frames (teacher frames in training, the previous output at
inference). Inference stops early once every utterance has stopped, after
running the steps the postnet still reads (its receptive field), so its
frames, lengths and shapes are the full-length scan's; the attention
weights of the steps not run are zeros. No module of this model reaches a
kernel in the JAX package, and none does here.

Randomness: the prenet dropout is drawn whenever a generator is given (in
training and at inference, as in JAX); zoneout is drawn while the model is
training and given a generator, else the expectation rate * prev + (1 -
rate) * new is used, as the JAX step does without a 'zoneout' rng.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn
from torch.nn import functional as F

from espnet_tpu_torch.models.layers import (BatchNorm, Conv1d, Dense,
                                            KernelRouted, LayerNorm, LSTMCell,
                                            lstm_sequence)
from espnet_tpu_torch.models.tts.fastspeech2 import Postnet
from espnet_tpu_torch.ops.dropout import Dropout, bernoulli
from espnet_tpu_torch.ops.masks import make_valid_mask

NEG_INF = -1.0e30


@dataclasses.dataclass(frozen=True)
class Tacotron2Config:
    vocab_size: int = -1
    n_mels: int = 80
    input_type: str = "text"
    input_dim: int = 80
    embed_dim: int = 512
    encoder_conv_layers: int = 3
    encoder_conv_channels: int = 512
    encoder_conv_kernel: int = 5
    encoder_lstm_units: int = 512
    prenet_layers: int = 2
    prenet_units: int = 256
    decoder_lstm_units: int = 1024
    decoder_lstm_layers: int = 2
    att_dim: int = 128
    att_conv_channels: int = 32
    att_conv_kernel: int = 15
    postnet_layers: int = 5
    postnet_channels: int = 512
    reduction_factor: int = 1
    dropout_rate: float = 0.5
    zoneout_rate: float = 0.1
    cumulate_att_w: bool = True
    use_batch_norm: bool = True
    use_gst: bool = False
    gst_tokens: int = 10
    gst_heads: int = 4
    spks: int = 0
    langs: int = 0
    spk_embed_dim: int = 0
    spk_embed_integration_type: str = "concat"
    use_guided_attn: bool = True
    guided_attn_sigma: float = 0.4
    guided_attn_lambda: float = 1.0
    bce_pos_weight: float = 5.0
    max_frames: int = 2048
    stop_threshold: float = 0.5
    dtype: Any = torch.float32


def flip_within_lengths(x: torch.Tensor, lengths: torch.Tensor):
    """x (B, T, ...) with each row's first `length` steps reversed (flax
    `flip_sequences`: step t takes step (length - 1 - t) mod T)."""
    t = x.shape[1]
    idx = (lengths.long()[:, None] - 1
           - torch.arange(t, device=x.device)[None, :]) % t
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.ndim - 2))
                        .expand_as(x))


class Tacotron2Encoder(nn.Module):
    def __init__(self, c: Tacotron2Config):
        super().__init__()
        self.c = c
        if c.input_type == "feats":
            self.in_proj = Dense(c.input_dim, c.embed_dim, dtype=c.dtype)
        else:
            self.embed = nn.Embedding(c.vocab_size, c.embed_dim)
        for i in range(c.encoder_conv_layers):
            self.add_module(f"conv{i}", Conv1d(
                c.embed_dim if i == 0 else c.encoder_conv_channels,
                c.encoder_conv_channels, c.encoder_conv_kernel,
                bias=not c.use_batch_norm, dtype=c.dtype))
            self.add_module(f"norm{i}", BatchNorm(c.encoder_conv_channels)
                            if c.use_batch_norm else
                            LayerNorm(c.encoder_conv_channels, c.dtype))
        self.dropout = Dropout(c.dropout_rate)
        d_in = (c.encoder_conv_channels if c.encoder_conv_layers
                else c.embed_dim)
        h = c.encoder_lstm_units // 2
        self.OptimizedLSTMCell_0 = LSTMCell(d_in, h, c.dtype)  # forward
        self.OptimizedLSTMCell_1 = LSTMCell(d_in, h, c.dtype)  # backward

    def forward(self, text, text_lengths, generator=None):
        c = self.c
        if c.input_type == "feats":
            x = self.in_proj(text)
        else:
            x = self.embed(text).to(c.dtype)
        mask = make_valid_mask(text_lengths, text.shape[1])
        for i in range(c.encoder_conv_layers):
            x = getattr(self, f"conv{i}")(x * mask[..., None].to(x.dtype))
            x = torch.relu(getattr(self, f"norm{i}")(x)).to(c.dtype)
            x = self.dropout(x, generator)
        xf, _ = lstm_sequence(self.OptimizedLSTMCell_0, x)
        xb, _ = lstm_sequence(self.OptimizedLSTMCell_1,
                              flip_within_lengths(x, text_lengths))
        out = torch.cat([xf, flip_within_lengths(xb, text_lengths)], -1)
        return (out * mask[..., None]).to(c.dtype)


class Tacotron2Decoder(nn.Module):
    """The JAX `_DecoderStep`'s layers (its param names), and `step`."""

    def __init__(self, c: Tacotron2Config, mem_dim: int):
        super().__init__()
        self.c = c
        dt = c.dtype
        self.att_conv = Conv1d(1, c.att_conv_channels, c.att_conv_kernel,
                               dtype=dt)
        self.att_q = Dense(c.decoder_lstm_units, c.att_dim, bias=False,
                           dtype=dt)
        self.att_f = Dense(c.att_conv_channels, c.att_dim, bias=False,
                           dtype=dt)
        self.att_v = Dense(c.att_dim, 1, bias=False, dtype=dt)
        d = c.n_mels
        for i in range(c.prenet_layers):
            self.add_module(f"prenet{i}", Dense(d, c.prenet_units, dtype=dt))
            d = c.prenet_units
        d = mem_dim + d
        for i in range(c.decoder_lstm_layers):
            self.add_module(f"lstm{i}", LSTMCell(d, c.decoder_lstm_units, dt))
            d = c.decoder_lstm_units
        self.feat_out = Dense(d + mem_dim, c.n_mels * c.reduction_factor,
                              dtype=dt)
        self.prob_out = Dense(d + mem_dim, c.reduction_factor, dtype=dt)

    def _zoneout(self, prev, new, generator):
        rate = self.c.zoneout_rate
        if rate == 0.0:
            return new
        if self.training and generator is not None:
            keep = bernoulli(new.shape, rate, generator, new.device)
            return torch.where(keep, prev, new)
        return rate * prev + (1.0 - rate) * new

    def step(self, state, prev_frame, memory, processed, mem_mask,
             generator=None):
        """One decoder step. state: dict(lstm [(c, h)], att_w, att_cum, t);
        prev_frame (B, n_mels). Returns (new state, frames (B, r*n_mels),
        stop logits (B, r), attention weights (B, T_enc))."""
        c = self.c
        dt = c.dtype
        att_input = state["att_w"] if state["t"] == 0 or \
            not c.cumulate_att_w else state["att_cum"]
        query = state["lstm"][0][1]
        f = self.att_conv(att_input[..., None].to(dt))
        e = self.att_v(torch.tanh(
            processed + self.att_q(query)[:, None] + self.att_f(f)))[..., 0]
        e = torch.where(mem_mask, e.float(), torch.full_like(e.float(),
                                                             NEG_INF))
        att_w = torch.softmax(2.0 * e, dim=-1)
        context = torch.einsum("bt,btd->bd", att_w.to(memory.dtype), memory)
        att_cum = state["att_cum"] + att_w if c.cumulate_att_w else att_w

        h = prev_frame
        for i in range(c.prenet_layers):
            h = torch.relu(getattr(self, f"prenet{i}")(h))
            if c.dropout_rate > 0.0 and generator is not None:
                keep = ~bernoulli(h.shape, c.dropout_rate, generator,
                                   h.device)
                h = torch.where(keep, h / (1.0 - c.dropout_rate),
                                torch.zeros_like(h))
        x = torch.cat([context.to(dt), h.to(dt)], dim=-1)
        new_lstm = []
        for i in range(c.decoder_lstm_layers):
            cell = getattr(self, f"lstm{i}")
            prev_c, prev_h = state["lstm"][i]
            new_c, new_h = cell.step((prev_c, prev_h), cell.input_proj(x))
            new_c = self._zoneout(prev_c, new_c, generator)
            new_h = self._zoneout(prev_h, new_h, generator)
            new_lstm.append((new_c, new_h))
            x = new_h
        proj_in = torch.cat([x.to(dt), context.to(dt)], dim=-1)
        frames = self.feat_out(proj_in)
        stop_logits = self.prob_out(proj_in)
        new_state = {"lstm": new_lstm, "att_w": att_w, "att_cum": att_cum,
                     "t": state["t"] + 1}
        return new_state, frames, stop_logits, att_w


class Tacotron2(KernelRouted):
    def __init__(self, config: Tacotron2Config):
        super().__init__()
        c = self.config = config
        self.encoder = Tacotron2Encoder(c)
        mem_dim = c.encoder_lstm_units
        self.gst = None
        if c.use_gst:
            from espnet_tpu_torch.models.tts.gst import StyleEncoder

            self.gst = StyleEncoder(c.n_mels, c.gst_tokens,
                                    c.encoder_lstm_units, c.gst_heads,
                                    dtype=c.dtype)
        self.spk_cond = None
        if c.spks > 1 or c.langs > 1 or c.spk_embed_dim > 0:
            from espnet_tpu_torch.models.tts.spk_embed import \
                SpeakerConditioner

            self.spk_cond = SpeakerConditioner(
                spks=c.spks, langs=c.langs, spk_embed_dim=c.spk_embed_dim,
                integration_type=c.spk_embed_integration_type,
                units=c.encoder_lstm_units, dtype=c.dtype)
            mem_dim = self.spk_cond.out_dim
        self.att_mem_proj = Dense(mem_dim, c.att_dim, dtype=c.dtype)
        self.decoder = Tacotron2Decoder(c, mem_dim)
        self.postnet = Postnet(c.n_mels, c.postnet_channels,
                               c.postnet_layers, c.dtype)

    def _memory(self, text, text_lengths, generator, ref_mel=None, sids=None,
                lids=None, spembs=None):
        memory = self.encoder(text, text_lengths, generator)
        if self.gst is not None:
            if ref_mel is None:
                raise ValueError("use_gst inference needs a ref_mel")
            memory = memory + self.gst(ref_mel).to(memory.dtype)[:, None]
        if self.spk_cond is not None:
            memory = self.spk_cond(memory, sids, lids, spembs)
        return memory

    def _init_state(self, memory, text_lengths):
        c = self.config
        b, t_enc, _ = memory.shape
        z = memory.new_zeros(b, c.decoder_lstm_units, dtype=torch.float32)
        mask = make_valid_mask(text_lengths, t_enc)
        att_w = mask.float() / text_lengths.clamp(min=1)[:, None].float()
        state = {"lstm": [(z, z)] * c.decoder_lstm_layers, "att_w": att_w,
                 "att_cum": torch.zeros_like(att_w), "t": 0}
        return state, self.att_mem_proj(memory), mask

    def _teacher_forward(self, text, text_lengths, mel, generator,
                         sids=None, lids=None, spembs=None):
        c = self.config
        r = c.reduction_factor
        b, t, _ = mel.shape
        if t % r:
            raise ValueError(f"mel length {t} not a multiple of reduction "
                             f"{r}")
        memory = self._memory(text, text_lengths, generator, mel, sids, lids,
                              spembs)
        state, processed, mask = self._init_state(memory, text_lengths)
        teacher = torch.cat([mel.new_zeros(b, 1, c.n_mels),
                             mel[:, r - 1::r][:, :-1]], dim=1)
        frames, stops, atts = [], [], []
        for k in range(t // r):
            state, fr, st, aw = self.decoder.step(
                state, teacher[:, k].to(c.dtype), memory, processed, mask,
                generator)
            frames.append(fr)
            stops.append(st)
            atts.append(aw)
        return (torch.stack(frames, 1), torch.stack(stops, 1),
                torch.stack(atts, 1))

    @torch.no_grad()
    def teacher_attention(self, text, text_lengths, mel, mel_lengths,
                          generator=None):
        """(B, T_dec, T_enc) teacher-forced attention (the duration
        teacher's input, `fastspeech/duration_calculator.py`)."""
        return self._teacher_forward(text, text_lengths, mel, generator)[2]

    def forward(self, text, text_lengths, mel, mel_lengths, sids=None,
                lids=None, spembs=None, generator=None):
        c = self.config
        r = c.reduction_factor
        b, t, _ = mel.shape
        frames, stop_logits, att_ws = self._teacher_forward(
            text, text_lengths, mel, generator, sids, lids, spembs)
        mel_before = frames.reshape(b, t, c.n_mels)
        mel_post = mel_before + self.postnet(mel_before, generator)
        loss, stats = spectrogram_loss(mel_before, mel_post,
                                       stop_logits.reshape(b, t), mel,
                                       mel_lengths, c.n_mels,
                                       c.bce_pos_weight)
        if c.use_guided_attn:
            ga = guided_attention_loss(att_ws, text_lengths, mel_lengths // r,
                                       c.guided_attn_sigma)
            loss = loss + c.guided_attn_lambda * ga
            stats["attn_loss"] = ga
        stats["loss"] = loss
        return loss, stats, mel_post

    @torch.no_grad()
    def inference(self, text, text_lengths, max_frames: Optional[int] = None,
                  ref_mel=None, sids=None, lids=None, spembs=None,
                  generator=None):
        """Free-running synthesis: (mel (B, T_max, n_mels) zero past each
        length, lengths, attention (B, T_dec, T_enc))."""
        c = self.config
        r = c.reduction_factor
        n_dec = (max_frames or c.max_frames) // r
        memory = self._memory(text, text_lengths, generator, ref_mel, sids,
                              lids, spembs)
        state, processed, mask = self._init_state(memory, text_lengths)
        b = text.shape[0]
        prev = memory.new_zeros(b, c.n_mels)
        stopped = torch.zeros(b, dtype=torch.bool, device=memory.device)
        n_steps = torch.zeros(b, dtype=torch.long, device=memory.device)
        # steps still to run once every utterance has stopped: the frames
        # the postnet reads around the last valid one
        tail = -(-2 * c.postnet_layers // r)
        frames, atts, left = [], [], None
        for k in range(n_dec):
            state, fr, st, aw = self.decoder.step(
                state, prev, memory, processed, mask, generator)
            frames.append(fr)
            atts.append(aw)
            prev = fr.reshape(b, r, c.n_mels)[:, -1]
            n_steps += (~stopped).long()
            stopped = stopped | (torch.sigmoid(st[:, -1].float())
                                 > c.stop_threshold)
            if left is None and (k % 16 == 15 or k == n_dec - 1) \
                    and bool(stopped.all()):
                left = tail
            elif left is not None:
                left -= 1
            if left == 0:
                break
        run = len(frames)
        frames = torch.stack(frames, 1)
        atts = torch.stack(atts, 1)
        if run < n_dec:
            frames = F.pad(frames, (0, 0, 0, n_dec - run))
            atts = F.pad(atts, (0, 0, 0, n_dec - run))
        mel_before = frames.reshape(b, n_dec * r, c.n_mels)
        mel_post = mel_before + self.postnet(mel_before, None)
        out_lens = n_steps * r
        vmask = make_valid_mask(out_lens, n_dec * r)[..., None]
        return mel_post * vmask.to(mel_post.dtype), out_lens, atts


def spectrogram_loss(mel_before, mel_post, stop_logits, mel, mel_lengths,
                     n_mels: int, bce_pos_weight: float):
    """L1 + MSE of both mels over the valid frames, and the stop BCE with
    the last frame's positive weighted (`Tacotron2Loss:163`): (l1 + mse +
    bce, stats)."""
    t = mel.shape[1]
    fmask = make_valid_mask(mel_lengths, t).float()
    fm = fmask[..., None]
    n_el = fmask.sum().clamp(min=1.0) * n_mels
    mel = mel.float()
    mb, mp = mel_before.float(), mel_post.float()
    l1 = ((mb - mel).abs() * fm).sum() / n_el + \
        ((mp - mel).abs() * fm).sum() / n_el
    mse = (((mb - mel) ** 2) * fm).sum() / n_el + \
        (((mp - mel) ** 2) * fm).sum() / n_el
    target = (torch.arange(t, device=mel.device)[None, :]
              == (mel_lengths - 1)[:, None]).float()
    weight = torch.where(target > 0, torch.full_like(target, bce_pos_weight),
                         torch.ones_like(target))
    logits = stop_logits.float()
    bce = -(target * F.logsigmoid(logits) * weight
            + (1 - target) * F.logsigmoid(-logits))
    bce = (bce * fmask).sum() / fmask.sum().clamp(min=1.0)
    return l1 + mse + bce, {"l1_loss": l1, "mse_loss": mse, "bce_loss": bce}


def guided_attention_loss(att_ws, text_lengths, dec_lengths, sigma=0.4):
    """Diagonal-prior attention loss (`GuidedAttentionLoss:22`) of att_ws
    (B, T_dec, T_enc)."""
    b, t_dec, t_enc = att_ws.shape
    dev = att_ws.device
    u = torch.arange(t_enc, device=dev)[None, None, :] / \
        text_lengths.clamp(min=1)[:, None, None]
    t = torch.arange(t_dec, device=dev)[None, :, None] / \
        dec_lengths.clamp(min=1)[:, None, None]
    w = 1.0 - torch.exp(-((u - t) ** 2) / (2 * sigma ** 2))
    mask = (make_valid_mask(dec_lengths, t_dec)[:, :, None]
            & make_valid_mask(text_lengths, t_enc)[:, None, :]).float()
    return (att_ws.float() * w * mask).sum() / mask.sum().clamp(min=1.0)
