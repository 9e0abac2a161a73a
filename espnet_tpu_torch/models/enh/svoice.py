"""SVoice separator (port of espnet_tpu/models/enh/svoice.py).

Waveform in and out: a 50%-overlap conv encoder with ReLU, dual-path
MulCat blocks (gated BiLSTMs) over the intra- and inter-segment axes, one
shared PReLU + Dense head per block output, and the average-pool decoder
with overlap-add. The final block's estimate is the output; the earlier
blocks' are `others["layer<i>"]`, as in JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from espnet_tpu_torch.models.enh.layers import (add_cells, bilstm, cell,
                                                merge_segments,
                                                segment_sequence)
from espnet_tpu_torch.models.layers import (Dense, PReLU, SameConv1d,
                                            lstm_sequence)

F32 = torch.float32


class MulCatBlock(nn.Module):
    """rnn_proj(lstm(x)) * gate_proj(gate_lstm(x)), then block_proj of
    [gated, x] back to the input size."""

    def __init__(self, input_size: int, hidden: int,
                 bidirectional: bool = True, dtype=F32):
        super().__init__()
        self.bidirectional = bidirectional
        per = 2 if bidirectional else 1
        add_cells(self, [(input_size, hidden, dtype)] * (2 * per))
        self.rnn_proj = Dense(per * hidden, input_size, dtype=dtype)
        self.gate_proj = Dense(per * hidden, input_size, dtype=dtype)
        self.block_proj = Dense(2 * input_size, input_size, dtype=dtype)

    def _lstm(self, k, x):
        if self.bidirectional:
            return bilstm(self, k, x)
        return lstm_sequence(cell(self, k), x)[0]

    def forward(self, x):
        per = 2 if self.bidirectional else 1
        gated = self.rnn_proj(self._lstm(0, x)) * self.gate_proj(
            self._lstm(per, x))
        return self.block_proj(torch.cat([gated, x], -1))


class SegmentLayerNorm(nn.Module):
    """flax LayerNorm(epsilon=1e-8, reduction_axes=(1, 2, 3)): moments
    over every non-batch axis, scale and bias on the last."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=(1, 2, 3), keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + 1e-8) * self.weight + self.bias
        return y.to(x.dtype)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, F, L) frames -> (B, (F-1)*hop + L) by strided accumulation."""
    b, f, ln = frames.shape
    idx = (np.arange(f) * hop)[:, None] + np.arange(ln)[None, :]
    idx = torch.from_numpy(idx.reshape(-1)).to(frames.device)
    return frames.new_zeros(b, (f - 1) * hop + ln).index_add(
        1, idx, frames.reshape(b, f * ln))


class SVoiceSeparator(nn.Module):
    """(B, N) mixture -> (est (B, n_spk, N), lengths, {layer<i>})."""

    def __init__(self, enc_dim: int = 128, kernel_size: int = 8,
                 hidden_size: int = 128, num_spk: int = 2,
                 num_layers: int = 4, segment_size: int = 20,
                 bidirectional: bool = True, input_normalize: bool = False,
                 dtype=F32):
        super().__init__()
        self.enc_dim, self.kernel_size = enc_dim, kernel_size
        self.num_spk, self.num_layers = num_spk, num_layers
        self.segment_size, self.input_normalize = segment_size, \
            input_normalize
        self.encoder = SameConv1d(1, enc_dim, kernel_size,
                                  stride=kernel_size // 2, bias=False,
                                  padding="VALID", dtype=dtype)
        for li in range(num_layers):
            for side in ("row", "col"):
                self.add_module(f"{side}{li}", MulCatBlock(
                    enc_dim, hidden_size, bidirectional, dtype))
                if input_normalize:
                    self.add_module(f"{side}_norm{li}",
                                    SegmentLayerNorm(enc_dim))
        self.out_prelu = PReLU()
        self.out_proj = Dense(enc_dim, enc_dim * num_spk, dtype=dtype)

    def forward(self, wav, lengths, generator=None):
        b, n_mix = wav.shape
        k, hop = self.kernel_size, self.kernel_size // 2
        kseg, n = self.segment_size, self.enc_dim
        frames = 1 + (n_mix - k) // hop
        feat = torch.relu(self.encoder(wav[:, :(frames - 1) * hop + k,
                                           None]))
        t = feat.shape[1]
        seg, _ = segment_sequence(feat, kseg)
        s = seg.shape[1]
        outputs, out = [], seg
        for li in range(self.num_layers):
            row = getattr(self, f"row{li}")(out.reshape(b * s, kseg, n))
            row = row.reshape(b, s, kseg, n)
            if self.input_normalize:
                row = getattr(self, f"row_norm{li}")(row)
            out = out + row
            col = getattr(self, f"col{li}")(
                out.transpose(1, 2).reshape(b * kseg, s, n))
            col = col.reshape(b, kseg, s, n).transpose(1, 2)
            if self.input_normalize:
                col = getattr(self, f"col_norm{li}")(col)
            out = out + col
            outputs.append(out)

        def to_wav(seg_feat):
            h = self.out_proj(self.out_prelu(seg_feat))
            h = h.reshape(b, s, kseg, self.num_spk, n).permute(0, 3, 1, 2, 4)
            feat_spk = merge_segments(h.reshape(b * self.num_spk, s, kseg,
                                                n), t)
            sub = feat_spk.reshape(b * self.num_spk, t, n // k, k).mean(-1)
            wav_est = overlap_add(sub, hop)
            pad = n_mix - wav_est.shape[-1]
            wav_est = (nn.functional.pad(wav_est, (0, pad)) if pad > 0
                       else wav_est[:, :n_mix])
            return wav_est.reshape(b, self.num_spk, n_mix)

        others: Dict[str, torch.Tensor] = {
            f"layer{li + 1}": to_wav(o) for li, o in enumerate(outputs[:-1])}
        return to_wav(outputs[-1]), lengths, others
