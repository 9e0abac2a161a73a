"""DC-CRN: densely-connected convolutional recurrent network separator
(port of espnet_tpu/models/enh/dc_crn.py).

Channels-last (B, T, F, C) as in JAX. flax's 2-D convs are `lax_conv`
with XLA's "SAME" padding; the decoder's transposed GLU convs are flax's
"SAME" `nn.ConvTranspose` (the input dilated by the stride and correlated
with the kernel unflipped: `lax_conv_transpose`), cut or zero-padded back
to the encoder's frequency sizes as JAX does. BatchNorm is flax's
(`models/layers.py` `BatchNorm`): batch statistics in training, the
running ones in eval. The grouped LSTM's cells run over the padding, as
flax's `nn.RNN` does.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from espnet_tpu_torch.models.enh.layers import add_cells, bilstm, cell
from espnet_tpu_torch.models.layers import (BatchNorm, Dense, LayerNorm,
                                            conv_transpose_padding,
                                            lax_conv, lax_conv_transpose,
                                            lstm_sequence,
                                            same_padding)

F32 = torch.float32


class Conv2d(nn.Module):
    """flax `nn.Conv` over (B, H, W, C) with "SAME" or explicit padding
    and strides, or flax's `nn.ConvTranspose` ("SAME" padding, kernel
    unflipped) when `transpose`; weight (out, in, kh, kw)."""

    def __init__(self, c_in: int, c_out: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding="SAME",
                 transpose: bool = False, dtype=F32):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.padding, self.transpose, self.dtype = padding, transpose, dtype
        conv = nn.Conv2d(c_in, c_out, kernel)
        self.weight, self.bias = conv.weight, conv.bias

    def forward(self, x):
        if self.transpose:
            pads = [conv_transpose_padding(k, s)
                    for k, s in zip(self.kernel, self.stride)]
            y = lax_conv_transpose(x, self.weight, self.stride, pads,
                                   self.dtype)
        else:
            pads = self.padding
            if pads == "SAME":
                pads = [same_padding(n, k, s) for n, k, s in
                        zip(x.shape[1:3], self.kernel, self.stride)]
            y = lax_conv(x, self.weight, self.stride, pads, dtype=self.dtype)
        return y + self.bias.to(self.dtype)


class GluConv(nn.Module):
    """conv(x) * sigmoid(gate(x))."""

    def __init__(self, c_in: int, features: int, kernel, stride=(1, 1),
                 padding="SAME", transpose: bool = False, dtype=F32):
        super().__init__()
        self.conv = Conv2d(c_in, features, kernel, stride, padding,
                           transpose, dtype)
        self.gate = Conv2d(c_in, features, kernel, stride, padding,
                           transpose, dtype)

    def forward(self, x):
        return self.conv(x) * torch.sigmoid(self.gate(x))


class DenselyConnectedBlock(nn.Module):
    """(layers-1) x [conv (1,3) + BatchNorm + ELU] densely concatenated,
    then a GLU conv: (1,4)/(1,2) down with freq padding (1,1), a
    shape-keeping (1,3)/(1,1), or a transposed one up to `out_freq`."""

    def __init__(self, c_in: int, out_channels: int, hid_channels: int = 8,
                 layers: int = 5, last_kernel=(1, 4), last_stride=(1, 2),
                 transpose: bool = False, out_freq: int = 0, dtype=F32):
        super().__init__()
        self.layers, self.transpose, self.out_freq = layers, transpose, \
            out_freq
        for i in range(layers - 1):
            self.add_module(f"conv{i}", Conv2d(c_in + i * hid_channels,
                                               hid_channels, (1, 3),
                                               dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(hid_channels,
                                                momentum=0.99))
        c_cat = c_in + (layers - 1) * hid_channels
        padding = "SAME" if transpose else ((0, 0), (1, 1))
        self.glu = GluConv(c_cat, out_channels, last_kernel, last_stride,
                           padding, transpose, dtype)

    def forward(self, x):
        outputs = [x]
        for i in range(self.layers - 1):
            h = getattr(self, f"conv{i}")(torch.cat(outputs, -1) if i else x)
            outputs.append(nn.functional.elu(getattr(self, f"bn{i}")(h)))
        h = self.glu(torch.cat(outputs, -1))
        if self.transpose:
            f = h.shape[2]
            if f > self.out_freq:
                h = h[:, :, :self.out_freq]
            elif f < self.out_freq:
                h = nn.functional.pad(h, (0, 0, 0, self.out_freq - f))
        return h


class GLSTM(nn.Module):
    """Grouped LSTM bottleneck over (B, T, F, C): the channel-major
    flattened C*F feature in groups, one (Bi)LSTM each; layer 0 interleaves
    the group outputs, later layers concatenate them, each layer followed
    by LayerNorm."""

    def __init__(self, total: int, groups: int = 2, layers: int = 2,
                 bidirectional: bool = False, rearrange: bool = False,
                 dtype=F32):
        super().__init__()
        if total % groups:
            raise ValueError(f"GLSTM: {total} features in {groups} groups")
        self.groups, self.layers = groups, layers
        self.bidirectional, self.rearrange = bidirectional, rearrange
        gsize = self.gsize = total // groups
        per = 2 if bidirectional else 1
        hid = gsize // 2 if bidirectional else gsize
        add_cells(self, [(gsize, hid, F32)] * (layers * groups * per))
        for li in range(layers):
            self.add_module(f"ln{li}", LayerNorm(total, dtype))

    def _group(self, k, xg):
        if self.bidirectional:
            return bilstm(self, k, xg)
        return lstm_sequence(cell(self, k), xg)[0]

    def forward(self, x):
        b, t, f, c = x.shape
        total = c * f
        h = x.permute(0, 1, 3, 2).reshape(b, t, total)
        per = 2 if self.bidirectional else 1
        k = 0
        chunks = h.chunk(self.groups, dim=-1)
        outs = []
        for g in range(self.groups):
            outs.append(self._group(k, chunks[g]))
            k += per
        h = self.ln0(torch.stack(outs, -1).reshape(b, t, total))
        for li in range(1, self.layers):
            if self.rearrange:
                h = h.reshape(b, t, self.groups, self.gsize).transpose(
                    2, 3).reshape(b, t, total)
            chunks = h.chunk(self.groups, dim=-1)
            outs = []
            for g in range(self.groups):
                outs.append(self._group(k, chunks[g]))
                k += per
            h = getattr(self, f"ln{li}")(torch.cat(outs, -1))
        return h.reshape(b, t, c, f).permute(0, 1, 3, 2)


class DC_CRNSeparator(nn.Module):
    """DC-CRN complex masking (or mapping) over STFTEncoder features
    (B, T, 2F) real || imag -> (masked (B, n_spk, T, 2F), lengths,
    {mask_spk<i>})."""

    def __init__(self, input_dim: int, num_spk: int = 2,
                 predict_noise: bool = False,
                 input_channels=(2, 16, 32, 64, 128, 256),
                 enc_hid_channels: int = 8, enc_layers: int = 5,
                 glstm_groups: int = 2, glstm_layers: int = 2,
                 glstm_bidirectional: bool = False,
                 glstm_rearrange: bool = False, mode: str = "masking",
                 dtype=F32):
        super().__init__()
        if mode not in ("masking", "mapping"):
            raise ValueError(f"unsupported DC-CRN mode {mode}")
        self.num_spk, self.predict_noise, self.mode = num_spk, \
            predict_noise, mode
        f = self.f = input_dim // 2
        chans = self.chans = tuple(input_channels)
        num_out = num_spk + 1 if predict_noise else num_spk
        freqs = [f]
        for i in range(1, len(chans)):
            self.add_module(f"enc{i - 1}", DenselyConnectedBlock(
                chans[i - 1], chans[i], enc_hid_channels, enc_layers,
                dtype=dtype))
            freqs.append(freqs[-1] // 2)
        self.glstm = GLSTM(chans[-1] * freqs[-1], glstm_groups,
                           glstm_layers, glstm_bidirectional,
                           glstm_rearrange, dtype)
        c_h = chans[-1]
        for d, i in enumerate(range(len(chans) - 1, 0, -1)):
            self.add_module(f"skip{d}", DenselyConnectedBlock(
                chans[i], chans[i], enc_hid_channels, enc_layers,
                last_kernel=(1, 3), last_stride=(1, 1), dtype=dtype))
            out_ch = chans[i - 1] if i != 1 else num_out * 2
            self.add_module(f"dec{d}", DenselyConnectedBlock(
                c_h + chans[i], out_ch, enc_hid_channels, enc_layers,
                transpose=True, out_freq=freqs[i - 1], dtype=dtype))
            c_h = out_ch
        self.fc_real = Dense(f, f, dtype=dtype)
        self.fc_imag = Dense(f, f, dtype=dtype)

    def forward(self, feat, lengths, generator=None):
        f = self.f
        re, im = feat[..., :f], feat[..., f:]
        h = torch.stack([re, im], -1)
        num_out = self.num_spk + 1 if self.predict_noise else self.num_spk
        n_blocks = len(self.chans) - 1
        enc_outs = []
        for i in range(n_blocks):
            h = getattr(self, f"enc{i}")(h)
            enc_outs.append(h)
        h = self.glstm(h)
        for d, i in enumerate(range(n_blocks, 0, -1)):
            res = getattr(self, f"skip{d}")(enc_outs[i - 1])
            h = getattr(self, f"dec{d}")(torch.cat([h, res], -1))
        m_re = self.fc_real(h[..., :num_out].transpose(2, 3))
        m_im = self.fc_imag(h[..., num_out:].transpose(2, 3))
        if self.mode == "masking":
            out_re = m_re * re[:, :, None] - m_im * im[:, :, None]
            out_im = m_re * im[:, :, None] + m_im * re[:, :, None]
        else:
            out_re, out_im = m_re, m_im
        masked = torch.cat([out_re, out_im], -1).transpose(1, 2)
        others = {f"mask_spk{i + 1}": torch.cat([m_re[:, :, i],
                                                  m_im[:, :, i]], -1)
                  for i in range(self.num_spk)}
        if self.predict_noise:
            others["noise1"] = masked[:, -1]
            masked = masked[:, :self.num_spk]
        return masked, lengths, others
