"""Enhancement building blocks (port of espnet_tpu/models/enh/layers.py).

The learned filterbank (`ConvEncoder` / `ConvDecoder`: a "VALID" strided
conv with ReLU, and flax's "VALID" `nn.ConvTranspose`, whose kernel is not
flipped), the STFT pair on the port's `ops/stft.py`, Conv-TasNet's
`TemporalConvNet` of `TCNBlock`s, and DPRNN's `DPRNNBlock` with the 50%
overlap `segment_sequence` / `merge_segments`.

Reference behaviour kept on purpose: gLN and cLN normalise with eps 1e-8,
gLN over every frame of the padded length; flax's `nn.PReLU` is one scalar
slope initialised at 0.01 (`models/layers.py` `PReLU`); the LSTMs run both
directions over the padding (flax `nn.RNN` without `seq_lengths`), their
cells named `OptimizedLSTMCell_{k}` in creation order as flax names them;
LayerNorm keeps the package's eps 1e-6. Parameter names are the JAX
tree's, so `convert.load_jax_params` carries a JAX checkpoint in.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from espnet_tpu_torch.models.layers import (ConvTranspose1d, Dense,
                                            LayerNorm, LSTMCell, PReLU,
                                            SameConv1d, lax_conv,
                                            lstm_sequence)
from espnet_tpu_torch.ops.stft import istft, stft, stft_frames_lengths

GLN_EPS = 1e-8


class _GammaBeta(nn.Module):
    """Per-channel `gamma` (ones) and `beta` (zeros), flax's names."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    @torch.no_grad()
    def init_random_(self, generator=None):
        self.gamma.fill_(1.0)
        self.beta.zero_()


class GlobalLayerNorm(_GammaBeta):
    """gLN: normalise (B, T, N) over (time, channels) jointly."""

    def forward(self, x):
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        return (x - mean) / torch.sqrt(var + GLN_EPS) * self.gamma + self.beta


class ChannelwiseLayerNorm(_GammaBeta):
    """cLN: per-frame channel normalisation of (B, T, N)."""

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + GLN_EPS) * self.gamma + self.beta


def make_norm(norm_type: str, dim: int) -> nn.Module:
    return GlobalLayerNorm(dim) if norm_type == "gLN" \
        else ChannelwiseLayerNorm(dim)


def crop_or_pad(wav: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(B, t) -> (B, n_samples): the first n_samples, or zeros appended."""
    t = wav.shape[1]
    if t >= n_samples:
        return wav[:, :n_samples]
    return nn.functional.pad(wav, (0, n_samples - t))


class ConvEncoder(nn.Module):
    """Learned analysis filterbank: (B, n) -> ((B, T, N), frame lengths)."""

    def __init__(self, channels: int = 256, kernel_size: int = 20,
                 stride: int = 10, dtype=torch.float32):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.conv = SameConv1d(1, channels, kernel_size, stride=stride,
                               bias=False, padding="VALID", dtype=dtype)

    def forward(self, wav, lengths):
        feat = torch.relu(self.conv(wav[:, :, None]))
        flens = torch.div(lengths - self.kernel_size, self.stride,
                          rounding_mode="floor") + 1
        return feat, flens


class ConvDecoder(nn.Module):
    """Synthesis filterbank: (B, T, N) -> (B, n_samples)."""

    def __init__(self, channels: int = 256, kernel_size: int = 20,
                 stride: int = 10, dtype=torch.float32):
        super().__init__()
        self.deconv = ConvTranspose1d(channels, 1, kernel_size, stride,
                                      bias=False, dtype=dtype,
                                      padding="VALID")

    def forward(self, feat, n_samples: int):
        return crop_or_pad(self.deconv(feat)[..., 0], n_samples)


class STFTEncoder(nn.Module):
    """(B, n) -> ((B, T, 2F) real || imag, frame lengths)."""

    def __init__(self, n_fft: int = 512, hop_length: int = 128,
                 dtype=torch.float32):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length

    @property
    def output_dim(self) -> int:
        return 2 * (self.n_fft // 2 + 1)

    def forward(self, wav, lengths):
        real, imag = stft(wav, self.n_fft, self.hop_length)
        flens = stft_frames_lengths(lengths, self.n_fft, self.hop_length)
        return torch.cat([real, imag], dim=-1), flens


class STFTDecoder(nn.Module):
    """(B, T, 2F) real || imag -> (B, n_samples) by the inverse STFT."""

    def __init__(self, n_fft: int = 512, hop_length: int = 128,
                 dtype=torch.float32):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length

    def forward(self, feat, n_samples: int):
        f = feat.shape[-1] // 2
        wav = istft(feat[..., :f], feat[..., f:], self.n_fft,
                    self.hop_length)
        return crop_or_pad(wav, n_samples)


class DepthwiseConv1d(nn.Module):
    """flax `nn.Conv(c, (k,), padding=[(lo, hi)], kernel_dilation=d,
    feature_group_count=c)` over (B, T, C); weight (C, 1, k)."""

    def __init__(self, channels: int, kernel: int, dilation: int = 1,
                 padding: Tuple[int, int] = (0, 0), bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.dilation, self.padding, self.dtype = dilation, padding, dtype
        conv = nn.Conv1d(channels, channels, kernel, groups=channels,
                         bias=bias)
        self.weight, self.bias = conv.weight, conv.bias

    def forward(self, x):
        y = lax_conv(x, self.weight, padding=[self.padding],
                     rhs_dilation=(self.dilation,),
                     groups=self.weight.shape[0], dtype=self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class TCNBlock(nn.Module):
    """1x1 -> PReLU -> norm -> dilated depthwise -> PReLU -> norm ->
    (residual 1x1, skip 1x1)."""

    def __init__(self, bottleneck: int, hidden: int, kernel: int,
                 dilation: int, norm_type: str = "gLN",
                 causal: bool = False, dtype=torch.float32):
        super().__init__()
        self.conv1x1 = Dense(bottleneck, hidden, dtype=dtype)
        self.PReLU_0 = PReLU()
        self.norm1 = make_norm(norm_type, hidden)
        pad = (kernel - 1) * dilation
        padding = (pad, 0) if causal else (pad // 2, pad - pad // 2)
        self.dconv = DepthwiseConv1d(hidden, kernel, dilation, padding,
                                     dtype=dtype)
        self.PReLU_1 = PReLU()
        self.norm2 = make_norm(norm_type, hidden)
        self.res_out = Dense(hidden, bottleneck, dtype=dtype)
        self.skip_out = Dense(hidden, bottleneck, dtype=dtype)

    def forward(self, x):
        h = self.norm1(self.PReLU_0(self.conv1x1(x)))
        h = self.norm2(self.PReLU_1(self.dconv(h)))
        return x + self.res_out(h), self.skip_out(h)


def mask_nonlinear(masks: torch.Tensor, kind: str) -> torch.Tensor:
    """relu | sigmoid | softmax (over the speaker axis 1) | tanh."""
    if kind == "relu":
        return torch.relu(masks)
    if kind == "sigmoid":
        return torch.sigmoid(masks)
    if kind == "softmax":
        return torch.softmax(masks, dim=1)
    return torch.tanh(masks)


class TemporalConvNet(nn.Module):
    """Conv-TasNet mask network: (B, T, N) -> masks (B, C, T, N)."""

    def __init__(self, input_dim: int, num_outputs: int, layers: int = 8,
                 stacks: int = 3, bottleneck: int = 128, hidden: int = 512,
                 kernel: int = 3, norm_type: str = "gLN",
                 causal: bool = False, mask_nonlinear: str = "relu",
                 dtype=torch.float32):
        super().__init__()
        self.input_dim, self.num_outputs = input_dim, num_outputs
        self.layers, self.stacks = layers, stacks
        self.nonlinear = mask_nonlinear
        self.ln = ChannelwiseLayerNorm(input_dim)
        self.bottleneck = Dense(input_dim, bottleneck, dtype=dtype)
        for s in range(stacks):
            for l in range(layers):
                self.add_module(f"stack{s}_layer{l}", TCNBlock(
                    bottleneck, hidden, kernel, 2 ** l, norm_type, causal,
                    dtype))
        self.PReLU_0 = PReLU()
        self.mask_out = Dense(bottleneck, num_outputs * input_dim,
                              dtype=dtype)

    def forward(self, feat):
        x = self.bottleneck(self.ln(feat))
        skip_sum = 0.0
        for s in range(self.stacks):
            for l in range(self.layers):
                x, skip = getattr(self, f"stack{s}_layer{l}")(x)
                skip_sum = skip_sum + skip
        h = self.mask_out(self.PReLU_0(skip_sum))
        b, t, _ = h.shape
        masks = h.reshape(b, t, self.num_outputs, self.input_dim)
        masks = masks.permute(0, 2, 1, 3)
        if self.nonlinear in ("relu", "sigmoid", "tanh"):
            return mask_nonlinear(masks, self.nonlinear)
        return torch.softmax(masks, dim=1)


def add_cells(module: nn.Module, specs) -> None:
    """Add flax's auto-named cells `OptimizedLSTMCell_{k}` to `module`, one
    per (d_in, hidden, dtype) of `specs`, in creation order."""
    for k, (d_in, hidden, dtype) in enumerate(specs):
        module.add_module(f"OptimizedLSTMCell_{k}",
                          LSTMCell(d_in, hidden, dtype))


def cell(module: nn.Module, k: int) -> LSTMCell:
    return getattr(module, f"OptimizedLSTMCell_{k}")


def bilstm(module: nn.Module, k: int, x: torch.Tensor) -> torch.Tensor:
    """concat(forward run of cell k, reverse run of cell k+1) over x."""
    fwd, _ = lstm_sequence(cell(module, k), x)
    bwd, _ = lstm_sequence(cell(module, k + 1), x, reverse=True)
    return torch.cat([fwd, bwd], dim=-1)


class DPRNNBlock(nn.Module):
    """Intra-chunk BiLSTM + inter-chunk (Bi)LSTM, each with a projection,
    LayerNorm and residual: (B, S, K, N) -> same."""

    def __init__(self, feature_dim: int, hidden: int,
                 causal_inter: bool = False, dtype=torch.float32):
        super().__init__()
        self.causal_inter = causal_inter
        n, f32 = feature_dim, torch.float32
        add_cells(self, [(n, hidden, f32)] * (3 if causal_inter else 4))
        self.intra_proj = Dense(2 * hidden, n, dtype=dtype)
        self.intra_norm = LayerNorm(n, dtype)
        self.inter_proj = Dense(hidden if causal_inter else 2 * hidden, n,
                                dtype=dtype)
        self.inter_norm = LayerNorm(n, dtype)

    def forward(self, x):
        b, s, k, n = x.shape
        h = self.intra_norm(self.intra_proj(bilstm(self, 0,
                                                   x.reshape(b * s, k, n))))
        x = x + h.reshape(b, s, k, n)
        h = x.transpose(1, 2).reshape(b * k, s, n)
        if self.causal_inter:
            h2, _ = lstm_sequence(cell(self, 2), h)
        else:
            h2 = bilstm(self, 2, h)
        h2 = self.inter_norm(self.inter_proj(h2))
        return x + h2.reshape(b, k, s, n).transpose(1, 2)


def _segment_index(n_chunks: int, chunk: int, device) -> torch.Tensor:
    hop = chunk // 2
    idx = (np.arange(n_chunks) * hop)[:, None] + np.arange(chunk)[None, :]
    return torch.from_numpy(idx).to(device)


def segment_sequence(x: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, int]:
    """(B, T, N) -> ((B, n_chunks, chunk, N) with 50% overlap, T)."""
    _, t, _ = x.shape
    hop = chunk // 2
    n_chunks = max(1, int(np.ceil(max(t - chunk, 0) / hop)) + 1)
    need = (n_chunks - 1) * hop + chunk
    xp = nn.functional.pad(x, (0, 0, 0, need - t))
    return xp[:, _segment_index(n_chunks, chunk, x.device)], t


def merge_segments(seg: torch.Tensor, t: int) -> torch.Tensor:
    """Inverse of segment_sequence: 50% overlap-add, divided by the count
    of chunks covering each frame (at least 1)."""
    b, s, k, n = seg.shape
    need = (s - 1) * (k // 2) + k
    idx = _segment_index(s, k, seg.device).reshape(-1)
    out = seg.new_zeros(b, need, n).index_add(1, idx,
                                              seg.reshape(b, s * k, n))
    wsum = seg.new_zeros(need).index_add(0, idx, seg.new_ones(s * k))
    return (out / wsum.clamp(min=1.0)[None, :, None])[:, :t]
