"""Global style tokens (port of espnet_tpu/models/tts/gst.py).

Behavioral spec: reference `espnet2/tts/gst/style_encoder.py`. The
`ReferenceEncoder` runs six 3x3 convolutions of stride 2 ("SAME" padding,
as flax pads: the extra row or column at the end) over the reference mel
(B, T, M) and a GRU over the frames that remain, padding included (the
JAX `nn.RNN(nn.GRUCell)` has no seq_lengths); its last state is the
reference embedding. `StyleTokenLayer` attends from it over tanh of the
learned tokens with `num_heads` heads.

`GRUCell` is flax's `GRUCell` written out: r = sigmoid(W_ir x + b_ir +
W_hr h), z alike, n = tanh(W_in x + b_in + r (W_hn h + b_hn)), h' = (1 - z)
n + z h; its Dense layers carry flax's names (ir, iz, in with a bias; hr,
hz without; hn with), so the converter maps them as any Dense. It computes
in float32, as the flax cell built without a dtype does.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from espnet_tpu_torch.models.layers import Dense

REF_CHANNELS = (32, 32, 64, 64, 128, 128)


class GRUCell(nn.Module):
    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in ("r", "z", "n"):
            self.add_module(f"i{g}", Dense(d_in, hidden))
        self.hr = Dense(hidden, hidden, bias=False)
        self.hz = Dense(hidden, hidden, bias=False)
        self.hn = Dense(hidden, hidden)

    def forward(self, h, x):
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


def conv2d_same(x, weight, bias, stride: int, dtype):
    """flax nn.Conv "SAME" over NCHW: out = ceil(in / stride), the padding
    split low = total // 2, high = the rest."""
    pads = []
    for size, k in zip(x.shape[2:][::-1], weight.shape[2:][::-1]):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x.to(dtype), pads), weight.to(dtype),
                    bias.to(dtype), stride=stride)


class ReferenceEncoder(nn.Module):
    """Strided conv stack + GRU over a reference mel (B, T, M) ->
    (B, gru_units)."""

    def __init__(self, n_mels: int, conv_channels: Sequence[int] =
                 REF_CHANNELS, gru_units: int = 128, dtype=torch.float32):
        super().__init__()
        self.n_conv = len(conv_channels)
        self.dtype = dtype
        c_in, m = 1, n_mels
        for i, ch in enumerate(conv_channels):
            self.add_module(f"conv{i}", nn.Conv2d(c_in, ch, 3))
            c_in, m = ch, -(-m // 2)
        self.GRUCell_0 = GRUCell(m * c_in, gru_units)

    def forward(self, mel):
        x = mel[:, None]  # (B, 1, T, M)
        for i in range(self.n_conv):
            conv = getattr(self, f"conv{i}")
            x = torch.relu(conv2d_same(x, conv.weight, conv.bias, 2,
                                       self.dtype))
        b, c, t, m = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, m * c).float()
        cell = self.GRUCell_0
        h = x.new_zeros(b, cell.hidden)
        for k in range(t):
            h = cell(h, x[:, k])
        return h


class StyleTokenLayer(nn.Module):
    """Multi-head attention of the reference embedding over the style
    tokens -> (B, token_dim)."""

    def __init__(self, ref_dim: int, num_tokens: int = 10,
                 token_dim: int = 256, num_heads: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.num_tokens, self.token_dim = num_tokens, token_dim
        self.num_heads = num_heads
        self.tokens = nn.Parameter(torch.zeros(num_tokens, token_dim))
        self.q = Dense(ref_dim, token_dim, dtype=dtype)
        self.k = Dense(token_dim, token_dim, dtype=dtype)
        self.v = Dense(token_dim, token_dim, dtype=dtype)

    def init_random_(self, generator):
        with torch.no_grad():
            self.tokens.copy_(0.5 * torch.randn(
                self.tokens.shape, generator=generator))

    def forward(self, ref_emb):
        h, kk = self.num_heads, self.num_tokens
        dk = self.token_dim // h
        keys = torch.tanh(self.tokens)
        q = self.q(ref_emb)
        b = q.shape[0]
        qh = q.reshape(b, h, dk)
        kh = self.k(keys).reshape(kk, h, dk)
        vh = self.v(keys).reshape(kk, h, dk)
        scores = torch.einsum("bhd,khd->bhk", qh, kh) / math.sqrt(float(dk))
        w = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        return torch.einsum("bhk,khd->bhd", w, vh).reshape(b, self.token_dim)


class StyleEncoder(nn.Module):
    """ReferenceEncoder + StyleTokenLayer -> style embedding (B,
    token_dim)."""

    def __init__(self, n_mels: int, num_tokens: int = 10,
                 token_dim: int = 256, num_heads: int = 4,
                 gru_units: int = 128, dtype=torch.float32):
        super().__init__()
        self.ref_enc = ReferenceEncoder(n_mels, gru_units=gru_units,
                                        dtype=dtype)
        self.style_tokens = StyleTokenLayer(gru_units, num_tokens, token_dim,
                                            num_heads, dtype)

    def forward(self, ref_mel):
        return self.style_tokens(self.ref_enc(ref_mel))
