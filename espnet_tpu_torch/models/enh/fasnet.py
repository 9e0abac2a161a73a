"""FaSNet-TAC: filter-and-sum with transform-average-concatenate (port of
espnet_tpu/models/enh/fasnet.py).

Multichannel waveform (B, n, C) in, (B, n_spk, n) out. As in JAX the
per-lag loops are static gathers and einsums, and a channel mask
(B, C) stands for a variable channel count.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from espnet_tpu_torch.models.enh.layers import (add_cells, bilstm,
                                                merge_segments,
                                                segment_sequence)
from espnet_tpu_torch.models.layers import Dense, PReLU

F32 = torch.float32


def _idx(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class GlobLN(nn.Module):
    """GroupNorm(1, N): moments over every non-batch axis (eps 1e-8),
    per-feature scale and bias on the last."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        dims = tuple(range(1, x.ndim))
        mean = x.mean(dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dims, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-8) * self.weight + self.bias


class BiLSTMProj(nn.Module):
    """(B)LSTM + a projection back to N."""

    def __init__(self, features: int, hidden: int, dtype=F32):
        super().__init__()
        add_cells(self, [(features, hidden, F32)] * 2)
        self.proj = Dense(2 * hidden, features, dtype=dtype)

    def forward(self, x):
        return self.proj(bilstm(self, 0, x))


class DPRNNTACBlock(nn.Module):
    """Intra-segment BLSTM, inter-segment BLSTM, then TAC across channels,
    each with global layer norm and a residual: (B, C, S, K, N)."""

    def __init__(self, features: int, hidden: int, dtype=F32):
        super().__init__()
        n, h3 = features, 3 * hidden
        self.row_rnn = BiLSTMProj(n, hidden, dtype)
        self.row_norm = GlobLN(n)
        self.col_rnn = BiLSTMProj(n, hidden, dtype)
        self.col_norm = GlobLN(n)
        self.ch_transform = Dense(n, h3, dtype=dtype)
        self.PReLU_0 = PReLU()
        self.ch_average = Dense(h3, h3, dtype=dtype)
        self.PReLU_1 = PReLU()
        self.ch_concat = Dense(2 * h3, n, dtype=dtype)
        self.PReLU_2 = PReLU()
        self.ch_norm = GlobLN(n)

    def forward(self, x, ch_mask=None):
        b, c, s, k, n = x.shape
        h = self.row_rnn(x.reshape(b * c * s, k, n))
        x = x + self.row_norm(h.reshape(b * c, s, k, n)).reshape(b, c, s, k,
                                                                 n)
        h = x.transpose(2, 3).reshape(b * c * k, s, n)
        h = self.col_rnn(h).reshape(b * c, k, s, n).transpose(1, 2)
        x = x + self.col_norm(h).reshape(b, c, s, k, n)
        t = self.PReLU_0(self.ch_transform(x))
        if ch_mask is None:
            avg = t.mean(1, keepdim=True)
        else:
            m = ch_mask[:, :, None, None, None].to(t.dtype)
            avg = (t * m).sum(1, keepdim=True) / m.sum(1, keepdim=True).clamp(
                min=1.0)
        avg = self.PReLU_1(self.ch_average(avg)).expand_as(t)
        h = self.PReLU_2(self.ch_concat(torch.cat([t, avg], -1)))
        h = self.ch_norm(h.reshape(b * c, s, k, n)).reshape(b, c, s, k, n)
        return x + h


class FaSNetTAC(nn.Module):
    """Single-stage FaSNet + TAC: (wav (B, n, C), lengths, ch_mask) ->
    (B, num_spk, n)."""

    def __init__(self, enc_dim: int = 64, feature_dim: int = 64,
                 hidden_dim: int = 128, layers: int = 4,
                 segment_size: int = 50, num_spk: int = 2, win_ms: int = 4,
                 context_ms: int = 16, sr: int = 16000, dtype=F32):
        super().__init__()
        self.enc_dim, self.feature_dim = enc_dim, feature_dim
        self.layers, self.segment_size = layers, segment_size
        self.num_spk, self.dtype = num_spk, dtype
        self.window = max(int(sr * win_ms / 1000), 2)
        self.context = int(sr * context_ms / 1000)
        filter_dim = 2 * self.context + 1
        self.encoder = Dense(2 * self.context + self.window, enc_dim,
                             bias=False, dtype=dtype)
        self.enc_ln = GlobLN(enc_dim)
        self.bn = Dense(enc_dim + filter_dim, feature_dim, bias=False,
                        dtype=dtype)
        for i in range(layers):
            self.add_module(f"dprnn_tac{i}", DPRNNTACBlock(
                feature_dim, hidden_dim, dtype))
        self.PReLU_0 = PReLU()
        self.dprnn_out = Dense(feature_dim, feature_dim * num_spk,
                               dtype=dtype)
        self.output = Dense(feature_dim, filter_dim, dtype=dtype)
        self.output_gate = Dense(feature_dim, filter_dim, dtype=dtype)

    def forward(self, wav, lengths, ch_mask=None, generator=None):
        b, n_samples, c = wav.shape
        dev = wav.device
        window, context = self.window, self.context
        stride = window // 2
        filter_dim = 2 * context + 1
        x = wav.transpose(1, 2)
        rest = window - (stride + n_samples % window) % window
        x = nn.functional.pad(x, (stride, rest + stride))
        padded = x.shape[-1]
        x = nn.functional.pad(x, (context, context))
        n_chunks = 2 * padded // window - 1
        idx = (np.arange(n_chunks) * stride)[:, None] + np.arange(
            2 * context + window)[None, :]
        chunks = x[:, :, _idx(idx, dev)]                # (B, C, L, 2c+w)
        center = chunks[..., context:context + window]

        enc = self.encoder(chunks)
        enc = self.enc_ln(enc.reshape(b * c, n_chunks, self.enc_dim)
                          ).reshape(b, c, n_chunks, self.enc_dim)
        ref = center[:, 0]
        lag_idx = np.arange(filter_dim)[:, None] + np.arange(window)[None, :]
        ctx_win = chunks[..., _idx(lag_idx, dev)]       # (B, C, L, 2c+1, w)
        num = torch.einsum("bclkw,blw->bclk", ctx_win, ref)
        ref_n = torch.linalg.norm(ref, dim=-1)[:, None, :, None]
        win_n = torch.linalg.norm(ctx_win, dim=-1)
        cos = num / (win_n * ref_n + 1e-8)
        feat = torch.cat([enc.to(cos.dtype), cos], -1)

        h = self.bn(feat)
        seg, t_orig = segment_sequence(
            h.reshape(b * c, n_chunks, self.feature_dim), self.segment_size)
        s = seg.shape[1]
        seg = seg.reshape(b, c, s, self.segment_size, self.feature_dim)
        for i in range(self.layers):
            seg = getattr(self, f"dprnn_tac{i}")(seg, ch_mask)
        seg = self.dprnn_out(self.PReLU_0(seg))
        seg = seg.reshape(b, c, s, self.segment_size, self.num_spk,
                          self.feature_dim).permute(0, 1, 4, 2, 3, 5)
        h = merge_segments(seg.reshape(b * c * self.num_spk, s,
                                       self.segment_size, self.feature_dim),
                           t_orig)
        flt = torch.tanh(self.output(h)) * torch.sigmoid(
            self.output_gate(h))
        flt = flt.reshape(b, c, self.num_spk, n_chunks, filter_dim)
        conv_idx = np.arange(window)[:, None] + np.arange(filter_dim)[None, :]
        ctx2 = chunks[..., _idx(conv_idx, dev)]         # (B, C, L, w, 2c+1)
        bf = torch.einsum("bclwk,bcnlk->bcnlw", ctx2.to(flt.dtype), flt)
        oa_idx = ((np.arange(n_chunks) * stride)[:, None]
                  + np.arange(window)[None, :]).reshape(-1)
        sig = bf.new_zeros(b, c, self.num_spk, padded).index_add(
            3, _idx(oa_idx, dev),
            bf.reshape(b, c, self.num_spk, n_chunks * window))
        sig = sig[..., stride:padded - rest - stride]
        if ch_mask is None:
            return sig.mean(1)
        m = ch_mask[:, :, None, None].to(sig.dtype)
        return (sig * m).sum(1) / m.sum(1).clamp(min=1.0)


class FaSNetSeparator(nn.Module):
    """Waveform-to-waveform FaSNet: (B, n, C) -> ((B, n_spk, n), lengths,
    others)."""

    def __init__(self, enc_dim: int = 64, feature_dim: int = 64,
                 hidden_dim: int = 128, layers: int = 4,
                 segment_size: int = 50, num_spk: int = 2,
                 predict_noise: bool = False, win_ms: int = 4,
                 context_ms: int = 16, sr: int = 16000, dtype=F32):
        super().__init__()
        self.num_spk, self.predict_noise = num_spk, predict_noise
        n_out = num_spk + 1 if predict_noise else num_spk
        self.fasnet = FaSNetTAC(enc_dim, feature_dim, hidden_dim, layers,
                                segment_size, n_out, win_ms, context_ms, sr,
                                dtype)

    def forward(self, speech_mix, lengths, generator=None,
                ch_mask: Optional[torch.Tensor] = None):
        wavs = self.fasnet(speech_mix, lengths, ch_mask)
        others = {}
        if self.predict_noise:
            others["noise1"] = wavs[:, -1]
            wavs = wavs[:, :self.num_spk]
        return wavs, lengths, others
