"""Pretrained SSL and Whisper models: wav2vec2 / HuBERT and Whisper (port
of espnet_tpu/models/ssl.py).

The architectures of ESPnet's external-model integrations
(`espnet2/asr/encoder/{wav2vec2,hubert,whisper}_encoder.py`,
`espnet2/asr/decoder/whisper_decoder.py`, `espnet2/asr/frontend/s3prl.py`),
written out with the parameterisation of the HuggingFace `transformers`
checkpoints so that one converts without loss (`train/hf_import.py`), and
with the JAX package's module and parameter names, so that its trees load
through `convert.py`:

* `ConvFeatureExtractor`: strided 1-D convs with exact GELU; per-channel
  GroupNorm after the first conv ("group", base models: over all frames,
  padding included, in float32) or a float32 LayerNorm after each
  ("layer", large models);
* `Wav2Vec2Model`: the extractor, the feature projection (LayerNorm, Dense,
  padding zeroed), the grouped convolutional positions (even kernels
  trimmed by one frame, as HF's SamePad), then post-LN (base) or pre-LN
  ("stable", large) layers; it returns every hidden state and the frame
  lengths;
* `SSLFrontend`: the S3PRL featurizer, a softmax-weighted sum of the hidden
  states with zero-initialised `layer_weights`; `freeze` runs the trunk
  without a graph (the JAX model's stop-gradient);
* `Wav2Vec2ASREncoder`: the trunk as the ASR encoder, with `output_layer`
  to the ASR's width when it differs from the trunk's;
* `WhisperEncoder` (two convs, fixed sinusoidal positions kept as a
  parameter, pre-LN layers, final LayerNorm) and `WhisperDecoder` (tied
  output embedding, a KV-cached `score_step` for the batched beam search);
  `whisper_log_mel` is Whisper's log-mel frontend.

As in JAX, the attention of these models is plain (`HFAttention`: q
pre-scaled by 1/sqrt(head dim), scores in float32, the softmax weights
cast to v's dtype before their product with v): the JAX package sends none
of them to a Pallas kernel, and the port keeps that routing. LayerNorm and
GroupNorm use eps 1e-5 here (HF's torch default), not the package's 1e-6.
Parameters are float32; `dtype` is the compute dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from espnet_tpu_torch.models.layers import Dense, LayerNorm
from espnet_tpu_torch.ops.dropout import Dropout
from espnet_tpu_torch.ops.masks import attention_bias, make_valid_mask
from espnet_tpu_torch.ops.stft import (mel_filterbank, stft,
                                       stft_frames_lengths)

LN_EPS = 1e-5  # HF's torch LayerNorm / GroupNorm default
# exact GELU (erf), as `jax.nn.gelu(approximate=False)`
gelu = nn.functional.gelu


class HFLayerNorm(LayerNorm):
    """The port's LayerNorm (float32 inside, `dtype` out) with eps 1e-5."""

    def __init__(self, d: int, dtype=torch.float32):
        super().__init__(d, dtype)
        self.eps = LN_EPS


class Conv(nn.Conv1d):
    """flax `nn.Conv` over channel-last (B, T, C) input, computed in
    `dtype`, with an explicit stride, symmetric padding and groups."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True,
                 dtype=torch.float32):
        super().__init__(c_in, c_out, kernel, stride=stride, padding=padding,
                         groups=groups, bias=bias)
        self.compute_dtype = dtype

    def channels_first(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C_in, T) -> (B, C_out, T') in `dtype`."""
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return nn.functional.conv1d(x.to(dt), self.weight.to(dt), b,
                                    self.stride, self.padding,
                                    groups=self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.channels_first(x.transpose(1, 2)).transpose(1, 2)


# ---------------------------------------------------------------------------
# wav2vec2 / HuBERT
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SSLConfig:
    """The HF Wav2Vec2Config / HubertConfig fields the trunk needs; the
    defaults are the wav2vec2-base / HuBERT-base geometry."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"     # "group" (base) | "layer" (large)
    do_stable_layer_norm: bool = False   # False: post-LN base; True: large
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    feat_proj_layer_norm: bool = True
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.float32


def ssl_output_lengths(cfg: SSLConfig, input_lengths):
    """Frames after the strided extractor (HF `_get_feat_extract_output_
    lengths`): floor((len - kernel) / stride) + 1 per layer."""
    lengths = input_lengths
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        lengths = (lengths - k) // s + 1
    return lengths


class ConvFeatureExtractor(nn.Module):
    """HF Wav2Vec2FeatureEncoder: `conv{i}` with GELU, `group_norm` after
    the first ("group") or `norm{i}` after each ("layer"). Runs channel-first
    inside: the (B, C, T) layout is the convolutions' own."""

    def __init__(self, cfg: SSLConfig):
        super().__init__()
        self.cfg = cfg
        c_in = 1
        for i, (dim, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel,
                                            cfg.conv_stride)):
            self.add_module(f"conv{i}", Conv(c_in, dim, k, stride=s,
                                             bias=cfg.conv_bias,
                                             dtype=cfg.dtype))
            if cfg.feat_extract_norm == "group" and i == 0:
                self.group_norm = nn.GroupNorm(dim, dim, eps=LN_EPS)
            elif cfg.feat_extract_norm == "layer":
                self.add_module(f"norm{i}", HFLayerNorm(dim, torch.float32))
            c_in = dim

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        """(B, N) -> (B, T', conv_dim[-1])."""
        c = self.cfg
        x = wave[:, None, :]
        for i in range(len(c.conv_dim)):
            x = getattr(self, f"conv{i}").channels_first(x)
            if c.feat_extract_norm == "group" and i == 0:
                gn = self.group_norm
                x = nn.functional.group_norm(
                    x.float(), gn.num_groups, gn.weight, gn.bias,
                    gn.eps).to(x.dtype)
            elif c.feat_extract_norm == "layer":
                x = getattr(self, f"norm{i}")(
                    x.transpose(1, 2)).to(x.dtype).transpose(1, 2)
            x = gelu(x)
        return x.transpose(1, 2)


class HFAttention(nn.Module):
    """MHA with the HF (BART-lineage) layout: `q_proj`, `k_proj` (bias
    optional: Whisper's has none), `v_proj`, `out_proj`; q pre-scaled by
    1/sqrt(head dim), scores in float32, weights cast to v's dtype. With a
    `cache` ({"k", "v"}: (B, H, Tmax, Dk)) and a one-step query it writes
    this step's k/v at `cache_index`, masks the later positions with -1e9
    (the JAX step bias) and returns (out, new cache)."""

    def __init__(self, num_heads: int, d_model: int, k_bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.d_model = d_model
        self.q_proj = Dense(d_model, d_model, dtype=dtype)
        self.k_proj = Dense(d_model, d_model, bias=k_bias, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.out_proj = Dense(d_model, d_model, dtype=dtype)

    def _split(self, y: torch.Tensor) -> torch.Tensor:
        b, t, _ = y.shape
        h = self.num_heads
        return y.reshape(b, t, h, self.d_model // h).transpose(1, 2)

    def forward(self, q_in, kv_in, bias=None, cache=None,
                cache_index: Optional[int] = None):
        dk = self.d_model // self.num_heads
        q = self._split(self.q_proj(q_in)) * (dk ** -0.5)
        k = self._split(self.k_proj(kv_in))
        v = self._split(self.v_proj(kv_in))
        new_cache = None
        if cache is not None:
            i = cache_index
            k_all, v_all = cache["k"].clone(), cache["v"].clone()
            k_all[:, :, i:i + 1] = k.to(k_all.dtype)
            v_all[:, :, i:i + 1] = v.to(v_all.dtype)
            k, v = k_all, v_all
            new_cache = {"k": k_all, "v": v_all}
            valid = torch.arange(k.shape[2], device=q.device) <= i
            step_bias = torch.where(valid, 0.0, -1e9).float()[
                None, None, None, :]
            bias = step_bias if bias is None else bias + step_bias
        scores = (q @ k.transpose(-1, -2)).float()
        if bias is not None:
            scores = scores + bias
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        o = w @ v
        b, _, t, _ = o.shape
        o = self.out_proj(o.transpose(1, 2).reshape(b, t, self.d_model))
        if cache is not None:
            return o, new_cache
        return o


class Wav2Vec2Layer(nn.Module):
    """HF Wav2Vec2EncoderLayer (post-LN) or, with `do_stable_layer_norm`,
    Wav2Vec2EncoderLayerStableLayerNorm (pre-LN)."""

    def __init__(self, cfg: SSLConfig):
        super().__init__()
        c = cfg
        self.stable = c.do_stable_layer_norm
        self.attention = HFAttention(c.num_heads, c.hidden_size,
                                     dtype=c.dtype)
        self.layer_norm = HFLayerNorm(c.hidden_size, c.dtype)
        self.intermediate_dense = Dense(c.hidden_size, c.ffn_size,
                                        dtype=c.dtype)
        self.output_dense = Dense(c.ffn_size, c.hidden_size, dtype=c.dtype)
        self.final_layer_norm = HFLayerNorm(c.hidden_size, c.dtype)
        self.dropout = Dropout(c.dropout_rate)

    def _ffn(self, h, generator):
        h = gelu(self.intermediate_dense(h))
        return self.output_dense(self.dropout(h, generator))

    def forward(self, x, bias, generator=None):
        drop = self.dropout
        if self.stable:
            h = self.layer_norm(x)
            x = x + drop(self.attention(h, h, bias), generator)
            h = self._ffn(self.final_layer_norm(x), generator)
            return x + drop(h, generator)
        x = x + drop(self.attention(x, x, bias), generator)
        x = self.layer_norm(x)
        x = x + drop(self._ffn(x, generator), generator)
        return self.final_layer_norm(x)


class Wav2Vec2Model(nn.Module):
    """The wav2vec2 / HuBERT trunk. `forward` returns (the num_layers + 1
    hidden states, each (B, T, D), frame lengths)."""

    def __init__(self, cfg: SSLConfig):
        super().__init__()
        c = cfg
        self.cfg = c
        self.feature_extractor = ConvFeatureExtractor(c)
        if c.feat_proj_layer_norm:
            self.proj_norm = HFLayerNorm(c.conv_dim[-1], c.dtype)
        self.projection = Dense(c.conv_dim[-1], c.hidden_size, dtype=c.dtype)
        k = c.num_conv_pos_embeddings
        self.pos_conv = Conv(c.hidden_size, c.hidden_size, k,
                             padding=k // 2,
                             groups=c.num_conv_pos_embedding_groups,
                             dtype=c.dtype)
        self.norm = HFLayerNorm(c.hidden_size, c.dtype)
        for i in range(c.num_layers):
            self.add_module(f"layer{i}", Wav2Vec2Layer(c))

    def forward(self, wave, wave_lengths, generator=None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        c = self.cfg
        feats = self.feature_extractor(wave)
        t = feats.shape[1]
        lengths = torch.clamp(ssl_output_lengths(c, wave_lengths), max=t)
        valid = make_valid_mask(lengths, t)
        h = self.proj_norm(feats) if c.feat_proj_layer_norm else feats
        h = self.projection(h)
        h = h * valid[:, :, None].to(h.dtype)
        pos = self.pos_conv(h)
        if c.num_conv_pos_embeddings % 2 == 0:
            pos = pos[:, :-1]
        h = h + gelu(pos)
        bias = attention_bias(valid[:, None, None, :])
        if not c.do_stable_layer_norm:
            h = self.norm(h)
        states = [h]
        for i in range(c.num_layers):
            h = getattr(self, f"layer{i}")(h, bias, generator)
            states.append(h)
        if c.do_stable_layer_norm:
            states[-1] = self.norm(h)
        return states, lengths


class SSLFrontend(nn.Module):
    """The S3PRL frontend: the trunk (`upstream`) and a learnable softmax
    mix of its hidden states (`layer_weights`, zeros at init). With
    `freeze` the trunk runs under torch.no_grad(): it gets no gradient and
    builds no graph."""

    def __init__(self, cfg: SSLConfig, freeze: bool = True):
        super().__init__()
        self.freeze = freeze
        self.upstream = Wav2Vec2Model(cfg)
        self.layer_weights = nn.Parameter(torch.zeros(cfg.num_layers + 1))

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        self.layer_weights.zero_()

    def forward(self, wave, wave_lengths, generator=None):
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze):
            states, lengths = self.upstream(wave, wave_lengths, generator)
            states = torch.stack(states)
        w = torch.softmax(self.layer_weights, dim=0).to(states.dtype)
        return torch.einsum("l,lbtd->btd", w, states), lengths


class Wav2Vec2ASREncoder(nn.Module):
    """The trunk (`upstream`) as the ASR encoder: its last hidden state,
    through `output_layer` when `output_size` differs from the trunk's
    width. `freeze` runs the trunk without a graph."""

    def __init__(self, cfg: SSLConfig, output_size: int,
                 freeze: bool = False):
        super().__init__()
        self.freeze = freeze
        self.upstream = Wav2Vec2Model(cfg)
        if output_size != cfg.hidden_size:
            self.output_layer = Dense(cfg.hidden_size, output_size,
                                      dtype=cfg.dtype)
        else:
            self.output_layer = None

    def forward(self, wave, wave_lengths, generator=None):
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze):
            states, lengths = self.upstream(wave, wave_lengths, generator)
        h = states[-1]
        if self.output_layer is not None:
            h = self.output_layer(h)
        return h, lengths


# ---------------------------------------------------------------------------
# Whisper
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """HF WhisperConfig's geometry (defaults: whisper-base)."""

    vocab_size: int = 51865
    n_mels: int = 80
    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    ffn_size: int = 2048
    max_source_positions: int = 1500
    max_target_positions: int = 448
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.float32


def sinusoidal_positions(length: int, channels: int) -> np.ndarray:
    """Whisper's `sinusoids`: [sin | cos] halves, log-spaced timescales."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(
        np.float32)


class WhisperLayer(nn.Module):
    """Pre-LN layer; with `cross`, cross-attention over the encoder's
    memory. Its attentions' `k_proj` has no bias."""

    def __init__(self, cfg: WhisperConfig, cross: bool = False):
        super().__init__()
        c = cfg
        self.cross = cross
        self.self_attn_layer_norm = HFLayerNorm(c.d_model, c.dtype)
        self.self_attn = HFAttention(c.num_heads, c.d_model, k_bias=False,
                                     dtype=c.dtype)
        if cross:
            self.encoder_attn_layer_norm = HFLayerNorm(c.d_model, c.dtype)
            self.encoder_attn = HFAttention(c.num_heads, c.d_model,
                                            k_bias=False, dtype=c.dtype)
        self.final_layer_norm = HFLayerNorm(c.d_model, c.dtype)
        self.fc1 = Dense(c.d_model, c.ffn_size, dtype=c.dtype)
        self.fc2 = Dense(c.ffn_size, c.d_model, dtype=c.dtype)
        self.dropout = Dropout(c.dropout_rate)

    def forward(self, x, self_bias, memory=None, memory_bias=None,
                generator=None, cache=None, cache_index=None):
        drop = self.dropout
        h = self.self_attn_layer_norm(x)
        new_cache = None
        if cache is not None:
            h, new_cache = self.self_attn(h, h, self_bias, cache, cache_index)
        else:
            h = self.self_attn(h, h, self_bias)
        x = x + drop(h, generator)
        if self.cross:
            h = self.encoder_attn(self.encoder_attn_layer_norm(x), memory,
                                  memory_bias)
            x = x + drop(h, generator)
        h = gelu(self.fc1(self.final_layer_norm(x)))
        x = x + drop(self.fc2(drop(h, generator)), generator)
        if cache is not None:
            return x, new_cache
        return x


class WhisperEncoder(nn.Module):
    """Whisper's audio encoder over log-mel features (B, T, n_mels): conv1
    (k 3), conv2 (k 3, stride 2), each with GELU, plus `positions`
    (initialised to sinusoids, a parameter so that pretrained tables load),
    pre-LN layers and a final `norm`. Output lengths (mel + 1) // 2."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        c = cfg
        self.cfg = c
        self.conv1 = Conv(c.n_mels, c.d_model, 3, padding=1, dtype=c.dtype)
        self.conv2 = Conv(c.d_model, c.d_model, 3, stride=2, padding=1,
                          dtype=c.dtype)
        self.positions = nn.Parameter(torch.from_numpy(
            sinusoidal_positions(c.max_source_positions, c.d_model)))
        for i in range(c.encoder_layers):
            self.add_module(f"layer{i}", WhisperLayer(c))
        self.norm = HFLayerNorm(c.d_model, c.dtype)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        c = self.cfg
        self.positions.copy_(torch.from_numpy(
            sinusoidal_positions(c.max_source_positions, c.d_model)))

    def forward(self, mel, mel_lengths, generator=None):
        c = self.cfg
        x = gelu(self.conv1(mel))
        x = gelu(self.conv2(x))
        t = x.shape[1]
        if t > c.max_source_positions:
            raise ValueError(f"{t} encoder frames exceed Whisper's "
                             f"max_source_positions {c.max_source_positions}"
                             f" ({2 * c.max_source_positions} mel frames)")
        lengths = torch.clamp(torch.div(mel_lengths + 1, 2,
                                        rounding_mode="floor"), max=t)
        x = x + self.positions[:t].to(x.dtype)
        bias = attention_bias(make_valid_mask(lengths, t)[:, None, None, :])
        for i in range(c.encoder_layers):
            x = getattr(self, f"layer{i}")(x, bias, generator=generator)
        return self.norm(x), lengths


class WhisperDecoder(nn.Module):
    """Whisper's text decoder: `embed_tokens`, learned `positions` (N(0,
    0.02) at init), cross-attention layers, `norm`, and logits through the
    tied embedding. `init_cache` / `score_step` serve the batched beam
    search with a per-layer KV cache."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        c = cfg
        self.cfg = c
        self.embed_tokens = nn.Embedding(c.vocab_size, c.d_model)
        self.positions = nn.Parameter(torch.zeros(c.max_target_positions,
                                                  c.d_model))
        for i in range(c.decoder_layers):
            self.add_module(f"layer{i}", WhisperLayer(c, cross=True))
        self.norm = HFLayerNorm(c.d_model, c.dtype)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        self.positions.copy_(0.02 * torch.randn(self.positions.shape,
                                                generator=generator))

    def layers(self) -> list:
        return [getattr(self, f"layer{i}")
                for i in range(self.cfg.decoder_layers)]

    def _embed(self, tokens):
        return nn.functional.embedding(
            tokens.long(), self.embed_tokens.weight.to(self.cfg.dtype))

    def _logits(self, x):
        return x @ self.embed_tokens.weight.to(x.dtype).t()

    def forward(self, tokens, token_lengths, memory, memory_lengths,
                generator=None):
        """Teacher-forced decode: tokens (B, U) -> logits (B, U, V)."""
        u = tokens.shape[1]
        x = self._embed(tokens) + self.positions[:u].to(self.cfg.dtype)
        valid = make_valid_mask(token_lengths, u)
        causal = torch.ones(u, u, dtype=torch.bool,
                            device=tokens.device).tril()
        self_bias = attention_bias(valid[:, None, None, :]
                                   & causal[None, None])
        mem_bias = attention_bias(make_valid_mask(
            memory_lengths, memory.shape[1])[:, None, None, :])
        for layer in self.layers():
            x = layer(x, self_bias, memory, mem_bias, generator)
        return self._logits(self.norm(x))

    def init_cache(self, batch: int, max_len: int, device=None) -> list:
        """Empty per-layer self-attention caches, (batch, H, max_len, Dk)."""
        c = self.cfg
        shape = (batch, c.num_heads, max_len, c.d_model // c.num_heads)
        return [{"k": torch.zeros(shape, dtype=c.dtype, device=device),
                 "v": torch.zeros(shape, dtype=c.dtype, device=device)}
                for _ in range(c.decoder_layers)]

    def score_step(self, tokens_step, pos: int, memory, memory_lengths,
                   cache):
        """tokens_step (N,) at position `pos` -> (float32 log-probs (N, V),
        new cache)."""
        c = self.cfg
        if pos >= c.max_target_positions:
            raise ValueError(f"position {pos} past Whisper's "
                             f"max_target_positions {c.max_target_positions}")
        x = self._embed(tokens_step[:, None]) + self.positions[pos].to(
            c.dtype)
        mem_bias = attention_bias(make_valid_mask(
            memory_lengths, memory.shape[1])[:, None, None, :])
        new_caches = []
        for layer, layer_cache in zip(self.layers(), cache):
            x, nc = layer(x, None, memory, mem_bias, None, layer_cache, pos)
            new_caches.append(nc)
        logits = self._logits(self.norm(x))[:, 0]
        return torch.log_softmax(logits.float(), dim=-1), new_caches


def whisper_log_mel(speech: torch.Tensor, speech_lengths: torch.Tensor,
                    fs: int = 16000, n_mels: int = 80):
    """Whisper's log-mel: n_fft 400, hop 160, Hann; power; slaney mel;
    the last STFT frame dropped; log10 clamped at each utterance's maximum
    over all its frames (padding included) minus 8; (x + 4) / 4. Returns
    (feats (B, T, n_mels), frame lengths)."""
    n_fft, hop = 400, 160
    real, imag = stft(speech, n_fft, hop, n_fft)
    power = (real ** 2 + imag ** 2)[:, :-1]
    mat = torch.from_numpy(mel_filterbank(fs, n_fft, n_mels)).to(
        power.device)
    log_spec = torch.log10(torch.clamp(power @ mat, min=1e-10))
    top = log_spec.amax(dim=(1, 2), keepdim=True)
    feats = (torch.maximum(log_spec, top - 8.0) + 4.0) / 4.0
    lengths = torch.clamp(stft_frames_lengths(speech_lengths, n_fft, hop),
                          max=feats.shape[1])
    return feats, lengths
