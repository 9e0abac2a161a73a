"""VITS, the generator side (port of espnet_tpu/models/tts/vits.py).

Behavioral spec: reference `espnet2/gan_tts/vits/`: a transformer text
encoder gives the prior (m_p, logs_p); a WaveNet posterior encoder over
the linear spectrogram gives z; a residual coupling flow maps z to z_p;
the monotonic alignment search ties z_p to the prior; a HiFiGAN decoder
turns a random z slice into audio. As in the JAX package, a convolutional
log-duration predictor (Glow-TTS style) stands in for the reference's
stochastic one.

`maximum_path` is the JAX package's two scans written as two loops of
tensor ops over T_feats on the tensors' device: a forward DP in float32
(NEG = -1e9 added up along unreachable cells, `torch.maximum`), then the
backtrack with JAX's tie rule (move to the diagonal only where v_here <
v_diag, strictly). It is launch-bound on the card (about ten launches a
frame); a kernel for it is ROADMAP queue 2 work.

The text encoder's layers are the port's `TransformerEncoderLayer`, so
its self-attention goes to the flash kernel (head dim 96 at 192 channels
and 2 heads, zero-padded to the kernel's 128) and its FFN, at 192, fails
the FFN kernels' tile gate and runs plain, as in JAX.

Randomness: the posterior's noise (`eps=`, else N(0, 1) from
`generator`), the segment starts (`starts=`, else uniform draws from
`generator` as JAX draws them: floor(u * (max_start + 1))) and dropout
(on while training and a generator is given). Slices clamp their start to
the valid range, as `lax.dynamic_slice` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from espnet_tpu_torch.models.embedding import add_positional_encoding
from espnet_tpu_torch.models.layers import (Dense, KernelRouted, LayerNorm,
                                            SameConv1d)
from espnet_tpu_torch.models.transformer import TransformerEncoderLayer
from espnet_tpu_torch.models.tts.hifigan import HiFiGANGenerator
from espnet_tpu_torch.ops.dropout import Dropout
from espnet_tpu_torch.ops.masks import attention_bias, make_valid_mask

NEG = -1.0e9


# ---------------------------------------------------------------------------
# monotonic alignment search
# ---------------------------------------------------------------------------

@torch.no_grad()
def maximum_path(neg_x_ent: torch.Tensor, feat_lengths: torch.Tensor,
                 text_lengths: torch.Tensor) -> torch.Tensor:
    """Monotonic max path (`monotonic_align/core.pyx:14`) over (B, T_feats,
    T_text) log-likelihoods: a 0/1 float32 alignment of the same shape."""
    b, t_y, t_x = neg_x_ent.shape
    dev = neg_x_ent.device
    v = neg_x_ent.float()
    x_idx = torch.arange(t_x, device=dev)[None, :]
    above_text = x_idx >= text_lengths[:, None]
    neg = torch.full((), NEG, device=dev)
    prev = torch.full((b, t_x), NEG, device=dev)
    rows = []
    for y in range(t_y):
        first = torch.full((b, 1), 0.0 if y == 0 else NEG, device=dev)
        v_prev = torch.cat([first, prev[:, :-1]], dim=1)
        v_cur = torch.where(x_idx == y, neg, prev)
        row = v[:, y] + torch.maximum(v_prev, v_cur)
        row = torch.where(x_idx > y, neg, row)
        row = torch.where(above_text, neg, row)
        rows.append(row)
        prev = row
    bi = torch.arange(b, device=dev)
    index = torch.zeros(b, dtype=torch.long, device=dev)
    last_feat = feat_lengths.long() - 1
    last_text = text_lengths.long() - 1
    path = torch.zeros(b, t_y, t_x, device=dev)
    for y in range(t_y - 1, -1, -1):
        row_prev = rows[y - 1] if y > 0 else torch.full((b, t_x), NEG,
                                                        device=dev)
        active = y <= last_feat
        index = torch.where(y == last_feat, last_text, index)
        path[:, y] = ((x_idx == index[:, None]) & active[:, None]).float()
        v_here = row_prev[bi, index]
        v_diag = row_prev[bi, (index - 1).clamp(min=0)]
        move = (index != 0) & ((index == y) | (v_here < v_diag)) & active
        index = torch.where(move, index - 1, index)
    return path


# ---------------------------------------------------------------------------
# WaveNet residual stack, posterior encoder, flow
# ---------------------------------------------------------------------------

class WaveNetStack(nn.Module):
    """Non-causal WaveNet residual/skip stack, optionally conditioned on a
    global vector g (a 1x1 per layer added to the gate pre-activations)."""

    def __init__(self, channels: int, kernel_size: int = 5, layers: int = 4,
                 dilation_rate: int = 1, global_channels: int = 0,
                 dtype=torch.float32):
        super().__init__()
        self.layers, self.channels = layers, channels
        for i in range(layers):
            dil = dilation_rate ** i if dilation_rate > 1 else 1
            self.add_module(f"in_conv{i}", SameConv1d(
                channels, 2 * channels, kernel_size, dilation=dil,
                dtype=dtype))
            if global_channels > 0:
                self.add_module(f"cond{i}", Dense(
                    global_channels, 2 * channels, bias=False, dtype=dtype))
            self.add_module(f"res_skip{i}", SameConv1d(
                channels, 2 * channels, 1, dtype=dtype))

    def forward(self, x, mask, g=None):
        skip_sum = 0.0
        c = self.channels
        for i in range(self.layers):
            h = getattr(self, f"in_conv{i}")(x * mask)
            if g is not None:
                h = h + getattr(self, f"cond{i}")(g)[:, None, :]
            h = torch.tanh(h[..., :c]) * torch.sigmoid(h[..., c:])
            out = getattr(self, f"res_skip{i}")(h)
            x = (x + out[..., :c]) * mask
            skip_sum = skip_sum + out[..., c:]
        return skip_sum * mask


class PosteriorEncoder(nn.Module):
    """Linear spectrogram (B, T, spec_dim) -> (z, m_q, logs_q)."""

    def __init__(self, in_dim: int, out_channels: int = 192,
                 hidden: int = 192, kernel_size: int = 5, layers: int = 16,
                 global_channels: int = 0, dtype=torch.float32):
        super().__init__()
        self.pre = SameConv1d(in_dim, hidden, 1, dtype=dtype)
        self.wavenet = WaveNetStack(hidden, kernel_size, layers,
                                    global_channels=global_channels,
                                    dtype=dtype)
        self.proj = SameConv1d(hidden, 2 * out_channels, 1, dtype=dtype)

    def forward(self, spec, lengths, eps=None, generator=None, g=None):
        mask = make_valid_mask(lengths, spec.shape[1])[:, :, None].to(
            spec.dtype)
        x = self.wavenet(self.pre(spec), mask, g)
        stats = self.proj(x) * mask
        m, logs = stats.chunk(2, dim=-1)
        if eps is None:
            dev = generator.device if generator is not None else m.device
            eps = torch.randn(m.shape, generator=generator, device=dev)
        z = (m + eps.to(m.device, m.dtype) * torch.exp(logs)) * mask
        return z, m, logs


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling; `post` starts at zero (the identity)."""

    def __init__(self, channels: int, hidden: int = 192,
                 kernel_size: int = 5, layers: int = 4,
                 global_channels: int = 0, dtype=torch.float32):
        super().__init__()
        self.half = channels // 2
        self.pre = SameConv1d(self.half, hidden, 1, dtype=dtype)
        self.wavenet = WaveNetStack(hidden, kernel_size, layers,
                                    global_channels=global_channels,
                                    dtype=dtype)
        self.post = SameConv1d(hidden, self.half, 1, dtype=dtype)

    def init_random_(self, generator):
        with torch.no_grad():
            self.post.weight.zero_()
            self.post.bias.zero_()

    def forward(self, x, mask, reverse: bool = False, g=None):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.wavenet(self.pre(x0), mask, g)
        m = self.post(h) * mask
        x1 = (x1 - m if reverse else x1 + m) * mask
        return torch.cat([x0, x1], dim=-1)


class ResidualCouplingBlock(nn.Module):
    """[coupling, channel flip] x flows."""

    def __init__(self, channels: int, hidden: int = 192, flows: int = 4,
                 kernel_size: int = 5, layers: int = 4,
                 global_channels: int = 0, dtype=torch.float32):
        super().__init__()
        self.flows = flows
        for i in range(flows):
            self.add_module(f"flow{i}", ResidualCouplingLayer(
                channels, hidden, kernel_size, layers, global_channels,
                dtype))

    def forward(self, x, mask, reverse: bool = False, g=None):
        order = range(self.flows - 1, -1, -1) if reverse else range(self.flows)
        for i in order:
            c = getattr(self, f"flow{i}")
            if not reverse:
                x = torch.flip(c(x, mask, False, g), [-1])
            else:
                x = c(torch.flip(x, [-1]), mask, True, g)
        return x


class TextEncoder(nn.Module):
    """Tokens -> (hidden, m_p, logs_p)."""

    def __init__(self, vocab_size: int, channels: int = 192,
                 num_heads: int = 2, d_ff: int = 768, num_layers: int = 6,
                 dropout_rate: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.embed = nn.Embedding(vocab_size, channels)
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                channels, num_heads, d_ff, dtype, dropout_rate))
        self.after_norm = LayerNorm(channels, dtype)
        self.proj = SameConv1d(channels, 2 * channels, 1, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, tokens, lengths, generator=None):
        x = add_positional_encoding(
            self.embed(tokens.long()).to(self.compute_dtype))
        bias = attention_bias(
            make_valid_mask(lengths, tokens.shape[1])[:, None, None, :])
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, bias, generator)
        x = self.after_norm(x)
        m, logs = self.proj(x).chunk(2, dim=-1)
        return x, m, logs


class DurationPredictor(nn.Module):
    """Conv log-duration predictor over the detached text states."""

    def __init__(self, d_in: int, hidden: int = 256, kernel_size: int = 3,
                 dropout_rate: float = 0.5, global_channels: int = 0,
                 dtype=torch.float32):
        super().__init__()
        if global_channels > 0:
            self.cond = Dense(global_channels, d_in, bias=False, dtype=dtype)
        for i in range(2):
            self.add_module(f"conv{i}", SameConv1d(
                d_in if i == 0 else hidden, hidden, kernel_size, dtype=dtype))
            self.add_module(f"norm{i}", LayerNorm(hidden, dtype))
        self.proj = Dense(hidden, 1, dtype=dtype)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, mask, generator=None, g=None):
        h = x.detach()
        if g is not None:
            h = h + self.cond(g.detach())[:, None]
        for i in range(2):
            h = torch.relu(getattr(self, f"conv{i}")(h))
            h = self.dropout(getattr(self, f"norm{i}")(h), generator)
        return self.proj(h)[..., 0] * mask


@dataclasses.dataclass(frozen=True)
class VITSConfig:
    vocab_size: int = -1
    channels: int = 192
    text_heads: int = 2
    text_d_ff: int = 768
    text_layers: int = 6
    spec_dim: int = 513
    posterior_layers: int = 16
    flows: int = 4
    flow_layers: int = 4
    decoder_channels: int = 512
    upsample_scales: Tuple[int, ...] = (8, 8, 2, 2)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    n_fft: int = 1024
    hop_length: int = 256
    segment_frames: int = 32
    spks: int = 0
    langs: int = 0
    spk_embed_dim: int = 0
    global_channels: int = 0
    dropout_rate: float = 0.1
    dtype: Any = torch.float32


def _uniform_starts(lengths, seg, generator, starts):
    """Segment starts: `starts` as given, else floor(u * (max(len - seg, 0)
    + 1)) with u uniform from `generator`."""
    if starts is not None:
        return starts.to(lengths.device).long()
    max_start = (lengths - seg).clamp(min=0)
    dev = generator.device if generator is not None else lengths.device
    u = torch.rand(lengths.shape, generator=generator, device=dev)
    return (u.to(lengths.device) * (max_start + 1)).long()


def _slice_segments(x, starts, seg):
    """x (B, T, C), starts (B,) -> (B, seg, C), each start clamped to [0,
    T - seg] as `lax.dynamic_slice` clamps it."""
    s = starts.long().clamp(0, x.shape[1] - seg)
    idx = s[:, None] + torch.arange(seg, device=x.device)[None, :]
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def slice_wav_segments(wav, starts, seg_samples, hop):
    """The raw-audio slices (B, seg_samples) that match frame starts."""
    return _slice_segments(wav[..., None], starts * hop, seg_samples)[..., 0]


def vits_kl_loss(z_p, m_p_exp, logs_p_exp, logs_q, feat_mask):
    """KL(q || p) with the sampled z_p (`loss.py` KLDivergenceLoss)."""
    kl = (logs_p_exp - logs_q - 0.5
          + 0.5 * (z_p - m_p_exp) ** 2 * torch.exp(-2.0 * logs_p_exp))
    mask = feat_mask.to(kl.dtype)
    return (kl * mask).sum() / mask.sum().clamp(min=1.0)


class VITSGenerator(KernelRouted):
    def __init__(self, config: VITSConfig):
        super().__init__()
        c = self.config = config
        multi = c.spks > 1 or c.langs > 1 or c.spk_embed_dim > 0
        if multi and c.global_channels <= 0:
            raise ValueError("multi-speaker VITS needs global_channels > 0")
        gc = c.global_channels if multi else 0
        self.text_encoder = TextEncoder(c.vocab_size, c.channels,
                                        c.text_heads, c.text_d_ff,
                                        c.text_layers, c.dropout_rate,
                                        c.dtype)
        self.posterior_encoder = PosteriorEncoder(
            c.spec_dim, c.channels, c.channels, layers=c.posterior_layers,
            global_channels=gc, dtype=c.dtype)
        self.flow = ResidualCouplingBlock(c.channels, c.channels, c.flows,
                                          layers=c.flow_layers,
                                          global_channels=gc, dtype=c.dtype)
        self.duration_predictor = DurationPredictor(
            c.channels, global_channels=gc, dtype=c.dtype)
        self.decoder = HiFiGANGenerator(
            in_channels=c.channels, channels=c.decoder_channels,
            upsample_scales=c.upsample_scales,
            resblock_kernel_sizes=c.resblock_kernel_sizes,
            global_channels=gc, dtype=c.dtype)
        if c.spks > 1:
            self.global_emb = nn.Embedding(c.spks, c.global_channels)
        if c.langs > 1:
            self.lang_emb = nn.Embedding(c.langs, c.global_channels)
        if c.spk_embed_dim > 0:
            self.spemb_proj = Dense(c.spk_embed_dim, c.global_channels,
                                    dtype=c.dtype)

    @property
    def upsample_factor(self) -> int:
        return int(np.prod(self.config.upsample_scales))

    def _global_cond(self, sids, lids, spembs):
        """(B, global_channels) g = global_emb(sid) [+ spemb_proj(spemb)]
        [+ lang_emb(lid)], or None for a single-speaker model."""
        from espnet_tpu_torch.models.tts.spk_embed import l2_normalize

        g = None
        if hasattr(self, "global_emb"):
            if sids is None:
                raise ValueError("spks > 1 but sids not provided")
            g = self.global_emb(sids.reshape(-1).long())
        if hasattr(self, "spemb_proj"):
            if spembs is None:
                raise ValueError("spk_embed_dim > 0 but spembs missing")
            e = self.spemb_proj(l2_normalize(spembs.float()).to(spembs.dtype))
            g = e if g is None else g + e
        if hasattr(self, "lang_emb"):
            if lids is None:
                raise ValueError("langs > 1 but lids not provided")
            e = self.lang_emb(lids.reshape(-1).long())
            g = e if g is None else g + e
        return g

    @torch.no_grad()
    def align_prior(self, z_p, m_p, logs_p, feat_lengths, text_lengths):
        """MAS between the flowed posterior and the text prior."""
        s_sq_inv = torch.exp(-2.0 * logs_p)
        neg = (-0.5 * torch.einsum("byc,bxc->byx", z_p ** 2, s_sq_inv)
               + torch.einsum("byc,bxc->byx", z_p, m_p * s_sq_inv)
               - 0.5 * torch.sum(m_p ** 2 * s_sq_inv + 2.0 * logs_p
                                 + np.log(2.0 * np.pi), dim=-1)[:, None, :])
        return maximum_path(neg, feat_lengths, text_lengths)

    def forward(self, tokens, text_lengths, spec, spec_lengths,
                generator: Optional[torch.Generator] = None, sids=None,
                lids=None, spembs=None, eps=None, starts=None):
        """The training forward: the dict the GAN step reads."""
        c = self.config
        drop = generator if self.training else None
        g = self._global_cond(sids, lids, spembs)
        h_text, m_p, logs_p = self.text_encoder(tokens, text_lengths, drop)
        z, m_q, logs_q = self.posterior_encoder(spec, spec_lengths, eps,
                                                generator, g)
        feat_mask = make_valid_mask(spec_lengths, spec.shape[1])[..., None]
        z_p = self.flow(z, feat_mask.to(z.dtype), reverse=False, g=g)
        path = self.align_prior(z_p.detach(), m_p.detach(), logs_p.detach(),
                                spec_lengths, text_lengths)
        durations = path.sum(1)
        m_p_exp = torch.einsum("byx,bxc->byc", path, m_p)
        logs_p_exp = torch.einsum("byx,bxc->byc", path, logs_p)
        text_mask = make_valid_mask(text_lengths, tokens.shape[1]).to(z.dtype)
        log_dur_pred = self.duration_predictor(h_text, text_mask, drop, g)
        log_dur_tgt = torch.log(durations + 1.0e-8) * text_mask
        seg = c.segment_frames
        starts = _uniform_starts(spec_lengths, seg, generator, starts)
        wav_seg = self.decoder(_slice_segments(z, starts, seg), g=g)
        return {
            "wav_seg": wav_seg[..., 0], "seg_starts": starts,
            "z_p": z_p, "m_p_exp": m_p_exp, "logs_p_exp": logs_p_exp,
            "m_q": m_q, "logs_q": logs_q,
            "log_dur_pred": log_dur_pred, "log_dur_tgt": log_dur_tgt,
            "durations": durations, "feat_mask": feat_mask,
            "text_mask": text_mask,
        }

    @torch.no_grad()
    def inference(self, tokens, text_lengths, max_frames: int = 1000,
                  noise_scale: float = 0.667, length_scale: float = 1.0,
                  sids=None, lids=None, spembs=None,
                  generator: Optional[torch.Generator] = None, eps=None):
        """Text -> (wav (B, max_frames * upsample), lengths in samples)."""
        g = self._global_cond(sids, lids, spembs)
        h_text, m_p, logs_p = self.text_encoder(tokens, text_lengths)
        text_mask = make_valid_mask(text_lengths, tokens.shape[1]).to(
            m_p.dtype)
        log_dur = self.duration_predictor(h_text, text_mask, None, g)
        durations = torch.ceil(torch.exp(log_dur) * length_scale) * text_mask
        durations = torch.maximum(durations, text_mask)
        feat_lengths = durations.sum(1).clamp(max=max_frames).long()
        ends = torch.cumsum(durations, dim=1)
        begins = ends - durations
        frame = torch.arange(max_frames, device=tokens.device)[None, :, None]
        expand = ((frame >= begins[:, None, :])
                  & (frame < ends[:, None, :])).to(m_p.dtype)
        m_p_exp = torch.einsum("byx,bxc->byc", expand, m_p)
        logs_p_exp = torch.einsum("byx,bxc->byc", expand, logs_p)
        feat_mask = make_valid_mask(feat_lengths, max_frames)[..., None]
        if eps is None:
            dev = generator.device if generator is not None \
                else m_p.device
            eps = torch.randn(m_p_exp.shape, generator=generator, device=dev)
        z_p = (m_p_exp + eps.to(m_p.device, m_p.dtype)
               * torch.exp(logs_p_exp) * noise_scale) * feat_mask
        z = self.flow(z_p, feat_mask.to(z_p.dtype), reverse=True, g=g)
        wav = self.decoder(z, g=g)[..., 0]
        return wav, feat_lengths * self.upsample_factor
