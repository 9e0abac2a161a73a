"""Convolutional subsampling (port of espnet_tpu/models/subsampling.py).

Two or three 3x3-style strided conv+relu over a (B, 1, T, F) image, then a
linear projection of the flattened (reduced-freq x channels) axis. The
flatten is freq-major then channel, as in the JAX package, whose NHWC
activations reshape (B, T', F', C) -> (B, T', F'*C).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

_CONVS = {  # factor -> [(kernel, stride)]
    2: [(3, 2), (3, 1)],
    4: [(3, 2), (3, 2)],
    6: [(3, 2), (5, 3)],
    8: [(3, 2), (3, 2), (3, 2)],
}


class TooShortUttError(ValueError):
    """Utterance too short for the subsampling receptive field."""


def _conv_out_len(t, kernel: int = 3, stride: int = 2):
    return (t - kernel) // stride + 1


def _convs(factor: int) -> List[Tuple[int, int]]:
    if factor not in _CONVS:
        raise ValueError(f"unsupported subsampling factor {factor}")
    return _CONVS[factor]


def min_input_frames(factor: int) -> int:
    """Fewest input frames that give one output frame."""
    t = 1
    for k, s in reversed(_convs(factor)):
        t = (t - 1) * s + k
    return t


def subsampled_length(lengths, factor: int):
    """Output lengths after Conv2dSubsampling with total reduction factor."""
    out = lengths
    for k, s in _convs(factor):
        out = _conv_out_len(out, k, s)
    return out


class Conv2dSubsampling(nn.Module):
    """(B, T, F) features -> (B, T', d_model), T' ~ T/factor.

    Parameters are float32; the convs and the projection run in `dtype`.
    """

    def __init__(self, d_model: int, n_feats: int, factor: int = 4,
                 channels: int = 0, dtype=torch.float32):
        super().__init__()
        c = channels or d_model
        self.factor = factor
        self.dtype = dtype
        freq = n_feats
        c_in = 1
        for i, (k, s) in enumerate(_convs(factor)):
            self.add_module(f"conv{i}", nn.Conv2d(c_in, c, k, stride=s))
            c_in = c
            freq = _conv_out_len(freq, k, s)
        self.n_convs = len(_convs(factor))
        self.out = nn.Linear(freq * c, d_model)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        need = min_input_frames(self.factor)
        if x.shape[1] < need:
            raise TooShortUttError(
                f"input of {x.shape[1]} frames is too short for subsampling "
                f"x{self.factor} (needs at least {need})")
        h = x.to(self.dtype)[:, None]  # (B, 1, T, F)
        for i in range(self.n_convs):
            conv = getattr(self, f"conv{i}")
            h = torch.relu(nn.functional.conv2d(
                h, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                conv.stride))
        b, c, t, f = h.shape
        h = h.permute(0, 2, 3, 1).reshape(b, t, f * c)
        h = nn.functional.linear(h, self.out.weight.to(self.dtype),
                                 self.out.bias.to(self.dtype))
        return h, subsampled_length(lengths, self.factor)
