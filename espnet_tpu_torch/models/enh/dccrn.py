"""DCCRN: deep complex convolution recurrent network separator (port of
espnet_tpu/models/enh/dccrn.py).

Complex tensors are (real, imag) pairs in channels-last (B, T, F, C), as
in JAX. The complex convs are causal in time (kernel (2, 5), time padding
(1, 0)) with freq stride 2; the complex transposed convs are JAX's
`conv_general_dilated` with lhs dilation (1, 2), pads ((1, 1), (2, 3)) and
their raw (kt, kf, in, out) kernels `kernel_r` / `kernel_i`, then the
first frame cropped: torch's `output_padding` emulated by padding, as the
JAX module does (`lax_conv_transpose` here). Every mask applies to the
mixture. BatchNorm is flax's with momentum 0.99.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from espnet_tpu_torch.models.enh.layers import add_cells, cell
from espnet_tpu_torch.models.enh.dc_crn import Conv2d
from espnet_tpu_torch.models.layers import (BatchNorm, Dense, PReLU,
                                            lax_conv_transpose,
                                            lstm_sequence)

EPS = 1.1920929e-07
F32 = torch.float32


class ComplexConv(nn.Module):
    """Complex 2-D conv (kernel (2, 5), stride (1, freq_stride), causal
    time padding, centred freq padding)."""

    def __init__(self, c_in: int, features: int, kernel=(2, 5),
                 freq_stride: int = 2, dtype=F32):
        super().__init__()
        kt, kf = kernel
        pad = ((kt - 1, 0), (kf // 2, kf // 2))
        self.conv_r = Conv2d(c_in, features, kernel, (1, freq_stride), pad,
                             dtype=dtype)
        self.conv_i = Conv2d(c_in, features, kernel, (1, freq_stride), pad,
                             dtype=dtype)

    def forward(self, re, im):
        return (self.conv_r(re) - self.conv_i(im),
                self.conv_i(re) + self.conv_r(im))


class ComplexConvTranspose(nn.Module):
    """Complex transposed conv: freq F -> 2F, time T -> T."""

    def __init__(self, c_in: int, features: int, kernel=(2, 5), dtype=F32):
        super().__init__()
        kt, kf = self.kernel = tuple(kernel)
        self.dtype = dtype
        self.kernel_r = nn.Parameter(0.05 * torch.randn(kt, kf, c_in,
                                                        features))
        self.kernel_i = nn.Parameter(0.05 * torch.randn(kt, kf, c_in,
                                                        features))
        self.bias_r = nn.Parameter(torch.zeros(features))
        self.bias_i = nn.Parameter(torch.zeros(features))

    @torch.no_grad()
    def init_random_(self, generator=None):
        for w in (self.kernel_r, self.kernel_i):
            w.copy_(0.05 * torch.randn(w.shape, generator=generator))
        self.bias_r.zero_()
        self.bias_i.zero_()

    def _deconv(self, x, w):
        kt, kf = self.kernel
        return lax_conv_transpose(
            x, w.permute(3, 2, 0, 1), (1, 2),
            ((kt - 1, kt - 1), (kf // 2, kf // 2 + 1)), self.dtype)

    def forward(self, re, im):
        dt = self.dtype
        r = (self._deconv(re, self.kernel_r) - self._deconv(im, self.kernel_i)
             + self.bias_r.to(dt))
        i = (self._deconv(re, self.kernel_i) + self._deconv(im, self.kernel_r)
             + self.bias_i.to(dt))
        return r[:, 1:], i[:, 1:]


class ComplexLSTM(nn.Module):
    """Shared real and imaginary LSTMs combined by the complex product
    rule, with an optional per-part projection."""

    def __init__(self, d_in: int, units: int, projection: int = 0,
                 dtype=F32):
        super().__init__()
        add_cells(self, [(d_in, units, dtype)] * 2)
        self.projection = projection
        if projection:
            self.r_trans = Dense(units, projection, dtype=dtype)
            self.i_trans = Dense(units, projection, dtype=dtype)

    def forward(self, re, im):
        lstm_r, lstm_i = cell(self, 0), cell(self, 1)
        r2r, r2i = lstm_sequence(lstm_r, re)[0], lstm_sequence(lstm_i, re)[0]
        i2r, i2i = lstm_sequence(lstm_r, im)[0], lstm_sequence(lstm_i, im)[0]
        out_r, out_i = r2r - i2i, i2r + r2i
        if self.projection:
            out_r, out_i = self.r_trans(out_r), self.i_trans(out_i)
        return out_r, out_i


class DCCRNSeparator(nn.Module):
    """DCCRN complex U-Net separator over STFTEncoder features (B, T, 2F)
    -> (masked (B, n_spk, T, 2F), lengths, {mask_spk<i>})."""

    def __init__(self, input_dim: int, num_spk: int = 1, rnn_layer: int = 2,
                 rnn_units: int = 256, masking_mode: str = "E",
                 kernel_num=(32, 64, 128, 256, 256, 256),
                 use_noise_mask: bool = False, dtype=F32):
        super().__init__()
        if masking_mode not in ("E", "C", "R"):
            raise ValueError(f"unsupported masking mode {masking_mode}")
        self.num_spk, self.masking_mode = num_spk, masking_mode
        self.use_noise_mask, self.rnn_layer = use_noise_mask, rnn_layer
        f = self.f = input_dim // 2
        num_out = num_spk + 1 if use_noise_mask else num_spk
        cchans = self.cchans = [k // 2 for k in kernel_num]
        fz, c_in = f - 1, 1
        for li, ch in enumerate(cchans):
            self.add_module(f"enc{li}", ComplexConv(c_in, ch, dtype=dtype))
            self.add_module(f"bn{li}", BatchNorm(2 * ch, momentum=0.99))
            self.add_module(f"prelu{li}", PReLU())
            fz, c_in = (fz + 2 * 2 - 5) // 2 + 1, ch
        width = fz * cchans[-1]
        for li in range(rnn_layer):
            proj = width if li == rnn_layer - 1 else 0
            self.add_module(f"clstm{li}", ComplexLSTM(
                width if li == 0 else rnn_units // 2, rnn_units // 2, proj,
                dtype))
        n = len(cchans)
        c_h = cchans[-1]
        for di in range(n):
            last = di == n - 1
            out_ch = num_out if last else cchans[n - 2 - di]
            self.add_module(f"dec{di}", ComplexConvTranspose(
                c_h + cchans[n - 1 - di], out_ch, dtype=dtype))
            if not last:
                self.add_module(f"dec_bn{di}", BatchNorm(2 * out_ch,
                                                         momentum=0.99))
                self.add_module(f"dec_prelu{di}", PReLU())
            c_h = out_ch

    def forward(self, feat, lengths, generator=None):
        f = self.f
        mix_re, mix_im = feat[..., :f], feat[..., f:]
        re, im = mix_re[..., 1:, None], mix_im[..., 1:, None]
        skips, freqs = [], []
        for li, ch in enumerate(self.cchans):
            freqs.append(re.shape[2])
            re, im = getattr(self, f"enc{li}")(re, im)
            both = getattr(self, f"bn{li}")(torch.cat([re, im], -1))
            both = getattr(self, f"prelu{li}")(both)
            re, im = both[..., :ch], both[..., ch:]
            skips.append((re, im))
        b, t, fz, cz = re.shape
        rr, ii = re.reshape(b, t, fz * cz), im.reshape(b, t, fz * cz)
        for li in range(self.rnn_layer):
            rr, ii = getattr(self, f"clstm{li}")(rr, ii)
        re, im = rr.reshape(b, t, fz, cz), ii.reshape(b, t, fz, cz)
        n = len(self.cchans)
        for di in range(n):
            sk_re, sk_im = skips[n - 1 - di]
            re, im = getattr(self, f"dec{di}")(torch.cat([re, sk_re], -1),
                                               torch.cat([im, sk_im], -1))
            tgt = freqs[n - 1 - di]
            if re.shape[2] > tgt:
                re, im = re[:, :, :tgt], im[:, :, :tgt]
            elif re.shape[2] < tgt:
                pad = (0, 0, 0, tgt - re.shape[2])
                re, im = nn.functional.pad(re, pad), nn.functional.pad(im,
                                                                       pad)
            if di != n - 1:
                ch = re.shape[-1]
                both = getattr(self, f"dec_bn{di}")(torch.cat([re, im], -1))
                both = getattr(self, f"dec_prelu{di}")(both)
                re, im = both[..., :ch], both[..., ch:]
        mask_re = nn.functional.pad(re, (0, 0, 1, 0)).permute(0, 3, 1, 2)
        mask_im = nn.functional.pad(im, (0, 0, 1, 0)).permute(0, 3, 1, 2)
        est_re, est_im = self._apply_masks(mask_re, mask_im,
                                           mix_re[:, None], mix_im[:, None])
        masked = torch.cat([est_re, est_im], -1)
        others: Dict[str, torch.Tensor] = {
            f"mask_spk{i + 1}": torch.cat([mask_re[:, i], mask_im[:, i]], -1)
            for i in range(self.num_spk)}
        if self.use_noise_mask:
            others["mask_noise1"] = torch.cat([mask_re[:, -1],
                                               mask_im[:, -1]], -1)
            others["noise1"] = masked[:, -1]
            masked = masked[:, :self.num_spk]
        return masked, lengths, others

    def _apply_masks(self, mask_re, mask_im, re, im):
        if self.masking_mode == "E":
            spec_mags = torch.sqrt(re ** 2 + im ** 2 + 1e-8)
            spec_phase = torch.atan2(im, re)
            mask_mags_raw = torch.sqrt(mask_re ** 2 + mask_im ** 2)
            real_phase = mask_re / (mask_mags_raw + EPS)
            imag_phase = mask_im / (mask_mags_raw + EPS)
            mask_phase = torch.atan2(imag_phase, real_phase)
            est_mags = torch.tanh(mask_mags_raw) * spec_mags
            est_phase = spec_phase + mask_phase
            return (est_mags * torch.cos(est_phase),
                    est_mags * torch.sin(est_phase))
        if self.masking_mode == "C":
            return re * mask_re - im * mask_im, re * mask_im + im * mask_re
        return re * mask_re, im * mask_im
