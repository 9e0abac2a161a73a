"""iNeuBe: iterative neural and beamforming enhancement (port of
espnet_tpu/models/enh/ineube.py).

DNN1 (a TCNDenseUNet) predicts each source's complex STFT from the
multichannel mixture; `mfmcwf`, the multi-frame multi-channel Wiener
filter, beamforms the mixture towards each DNN1 estimate; DNN2 refines
from [mixture, DNN1, mfMCWF]. `output_from` picks dnn1, mfmcwf or dnn2.
Channels-last (B, T, F, C) as in JAX; the Wiener solve is complex64 with
the Tikhonov load detached (JAX's stop-gradient), never bfloat16 or TF32.
The upsampling convs keep their raw (kt, kf, in, out) JAX kernels as
`weight` in the torch layout, as every other 4-D kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from espnet_tpu_torch.models.enh.layers import DepthwiseConv1d
from espnet_tpu_torch.models.layers import (SameConv1d, lax_conv,
                                            lax_conv_transpose)
from espnet_tpu_torch.ops.stft import istft, stft

F32 = torch.float32


def _act(name):
    return {"elu": nn.functional.elu, "relu": torch.relu,
            "swish": lambda x: x * torch.sigmoid(x),
            "prelu": nn.functional.elu}[name]


def _lecun_(w: torch.Tensor, generator, fan_in=None) -> None:
    """flax's lecun_normal: a truncated normal of variance 1/fan_in (here
    untruncated, drawn from `generator`)."""
    fan_in = fan_in or w[0].numel()
    w.copy_(torch.randn(w.shape, generator=generator) * fan_in ** -0.5)


def _instance_norm(h, dims, scale, bias):
    mean = h.mean(dims, keepdim=True)
    var = ((h - mean) ** 2).mean(dims, keepdim=True)
    return (h - mean) * torch.rsqrt(var + 1e-8) * scale + bias


class _Conv(nn.Module):
    """flax `nn.Conv` holder (weight (out, in, kh, kw), bias)."""

    def __init__(self, c_in: int, c_out: int, ksz):
        super().__init__()
        conv = nn.Conv2d(c_in, c_out, tuple(ksz))
        self.weight, self.bias = conv.weight, conv.bias


class Conv2DActNorm(nn.Module):
    """Conv (reflect-padded time, given freq padding, freq stride) or the
    freq-upsampling transposed conv, then the activation and a
    per-channel instance norm over (T, F)."""

    def __init__(self, c_in: int, features: int, ksz=(3, 3),
                 freq_stride: int = 2, freq_pad: int = 0, time_pad: int = 1,
                 upsample: bool = False, activation: str = "elu",
                 dtype=F32):
        super().__init__()
        self.ksz, self.freq_stride = tuple(ksz), freq_stride
        self.freq_pad, self.time_pad = freq_pad, time_pad
        self.upsample, self.activation, self.dtype = upsample, activation, \
            dtype
        if upsample:
            conv = nn.Conv2d(c_in, features, self.ksz)
            self.weight = conv.weight
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.Conv_0 = _Conv(c_in, features, ksz)
        self.norm_scale = nn.Parameter(torch.ones(features))
        self.norm_bias = nn.Parameter(torch.zeros(features))

    @torch.no_grad()
    def init_random_(self, generator=None):
        if self.upsample:
            _lecun_(self.weight, generator)
            self.bias.zero_()
        self.norm_scale.fill_(1.0)
        self.norm_bias.zero_()

    def forward(self, x):
        kt, kf = self.ksz
        dt = self.dtype
        if self.upsample:
            h = lax_conv_transpose(x, self.weight, (1, self.freq_stride),
                                   ((kt - 2, kt - 2), (kf - 1, kf - 1)), dt)
            h = h + self.bias.to(dt)
        else:
            h = x.movedim(-1, 1)
            if self.time_pad or self.freq_pad:
                h = nn.functional.pad(h, (self.freq_pad, self.freq_pad,
                                          self.time_pad, self.time_pad),
                                      mode="reflect")
            h = lax_conv(h.movedim(1, -1), self.Conv_0.weight,
                         (1, self.freq_stride), dtype=dt)
            h = h + self.Conv_0.bias.to(dt)
        h = _act(self.activation)(h)
        return _instance_norm(h, (1, 2), self.norm_scale, self.norm_bias)


class FreqWiseBlock(nn.Module):
    """Pointwise bottleneck, then a pointwise conv over the freq axis."""

    def __init__(self, c_in: int, features: int, num_freqs: int,
                 activation: str = "elu", dtype=F32):
        super().__init__()
        self.bottleneck = Conv2DActNorm(c_in, features, (1, 1), 1, 0, 0,
                                        activation=activation, dtype=dtype)
        self.freq_proc = Conv2DActNorm(num_freqs, num_freqs, (1, 1), 1, 0,
                                       0, activation=activation, dtype=dtype)

    def forward(self, x):
        h = self.bottleneck(x).transpose(2, 3)
        return self.freq_proc(h).transpose(2, 3)


class DenseBlock(nn.Module):
    """Two pre convs, a freq-wise block and two post convs, densely
    concatenated."""

    def __init__(self, c_in: int, features: int, num_freqs: int,
                 hid_chans: int = 32, ksz=(3, 3), activation: str = "elu",
                 dtype=F32):
        super().__init__()
        kf = ksz[1]
        conv = lambda ci, co: Conv2DActNorm(ci, co, ksz, 1, kf // 2, 1,
                                            activation=activation,
                                            dtype=dtype)
        self.pre0 = conv(c_in, hid_chans)
        self.pre1 = conv(c_in + hid_chans, hid_chans)
        self.freqwise = FreqWiseBlock(c_in + 2 * hid_chans, hid_chans,
                                      num_freqs, activation, dtype)
        self.post0 = conv(c_in + 3 * hid_chans, hid_chans)
        self.post1 = conv(c_in + 4 * hid_chans, features)

    def forward(self, x):
        outs = [x]
        for mod in (self.pre0, self.pre1, self.freqwise, self.post0):
            outs.append(mod(torch.cat(outs, -1)))
        return self.post1(torch.cat(outs, -1))


class TCNResBlock(nn.Module):
    """Instance norm over time, activation, reflect-padded dilated
    depthwise conv, pointwise conv, residual: (B, T, C)."""

    def __init__(self, channels: int, features: int, ksz: int = 3,
                 dilation: int = 1, activation: str = "elu", dtype=F32):
        super().__init__()
        self.pad = dilation * (ksz - 1) // 2
        self.activation = activation
        self.norm_scale = nn.Parameter(torch.ones(channels))
        self.norm_bias = nn.Parameter(torch.zeros(channels))
        self.dconv = DepthwiseConv1d(channels, ksz, dilation, dtype=dtype)
        self.pconv = SameConv1d(channels, features, 1, dtype=dtype)

    @torch.no_grad()
    def init_random_(self, generator=None):
        self.norm_scale.fill_(1.0)
        self.norm_bias.zero_()

    def forward(self, x):
        h = _instance_norm(x, (1,), self.norm_scale, self.norm_bias)
        h = _act(self.activation)(h)
        h = nn.functional.pad(h.transpose(1, 2), (self.pad, self.pad),
                              mode="reflect").transpose(1, 2)
        return self.pconv(self.dconv(h)) + x


def freq_depth(num_freq: int):
    freqs = []
    while num_freq > 15:
        num_freq = int(num_freq / 2)
        freqs.append(num_freq)
    return freqs


class TCNDenseUNet(nn.Module):
    """Freq U-Net of dense blocks around a dilated-TCN bottleneck:
    (B, T, F, 2 C_in) stacked real/imag -> complex (B, n_spk, T, F)."""

    def __init__(self, n_spk: int = 1, in_freqs: int = 257,
                 mic_channels: int = 1, hid_chans: int = 32,
                 hid_chans_dense: int = 32, ksz_dense=(3, 3),
                 ksz_tcn: int = 3, tcn_repeats: int = 4, tcn_blocks: int = 7,
                 tcn_channels: int = 384, activation: str = "elu",
                 dtype=F32):
        super().__init__()
        hc, act, dt = hid_chans, activation, dtype
        self.n_spk, self.in_freqs, self.dtype = n_spk, in_freqs, dtype
        self.tcn_repeats, self.tcn_blocks = tcn_repeats, tcn_blocks
        num_freqs = in_freqs - 2
        self.depths = depths = freq_depth(num_freqs)
        dense = lambda ci, co, nf: DenseBlock(ci, co, nf, hid_chans_dense,
                                              ksz_dense, act, dt)
        down = lambda ci, co, s: Conv2DActNorm(ci, co, (3, 3), s, 0, 1,
                                               activation=act, dtype=dt)
        up = lambda ci, co, s: Conv2DActNorm(ci, co, (3, 3), s, 0, 1,
                                             upsample=True, activation=act,
                                             dtype=dt)
        self.first = _Conv(2 * mic_channels, hc, (3, 3))
        self.first_dense = dense(hc, hc, num_freqs)
        for li, nf in enumerate(depths):
            self.add_module(f"down{li}", down(hc, hc, 2))
            self.add_module(f"enc_dense{li}", dense(hc, hc, nf))
        self.down_a = down(hc, 2 * hc, 2)
        self.down_b = down(2 * hc, 4 * hc, 2)
        self.down_c = down(4 * hc, tcn_channels, 1)
        for r in range(tcn_repeats):
            for x_ in range(tcn_blocks):
                self.add_module(f"tcn{r}_{x_}", TCNResBlock(
                    tcn_channels, tcn_channels, ksz_tcn, 2 ** x_, act, dt))
        self.up_c = up(2 * tcn_channels, 4 * hc, 1)
        self.up_b = up(8 * hc, 2 * hc, 2)
        self.up_a = up(4 * hc, hc, 2)
        for di in range(len(depths)):
            nf = depths[len(depths) - di - 1]
            self.add_module(f"dec_dense{di}", dense(2 * hc, 2 * hc, nf))
            self.add_module(f"up{di}", up(2 * hc, hc, 2))
        self.last_dense = dense(2 * hc, 2 * hc, num_freqs)
        self.last_kernel = nn.Parameter(
            torch.randn(3, 3, 2 * hc, 2 * n_spk) * (2 * hc * 9) ** -0.5)
        self.last_bias = nn.Parameter(torch.zeros(2 * n_spk))

    @torch.no_grad()
    def init_random_(self, generator=None):
        w = self.last_kernel
        _lecun_(w, generator, w.shape[0] * w.shape[1] * w.shape[2])
        self.last_bias.zero_()

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        dt = self.dtype
        enc_out = []
        h = nn.functional.pad(x.movedim(-1, 1), (0, 0, 1, 1),
                              mode="reflect").movedim(1, -1)
        h = lax_conv(h, self.first.weight, dtype=dt) + self.first.bias.to(dt)
        h = self.first_dense(h)
        enc_out.append(h)
        for li in range(len(self.depths)):
            h = getattr(self, f"enc_dense{li}")(getattr(self, f"down{li}")(h))
            enc_out.append(h)
        for mod in (self.down_a, self.down_b, self.down_c):
            h = mod(h)
            enc_out.append(h)
        if h.shape[2] != 1:
            raise ValueError(f"TCNDenseUNet: {self.in_freqs} bins leave "
                             f"{h.shape[2]} at the bottleneck, not 1")
        z = h[:, :, 0, :]
        for r in range(self.tcn_repeats):
            for x_ in range(self.tcn_blocks):
                z = getattr(self, f"tcn{r}_{x_}")(z)
        h = z[:, :, None, :]
        h = self.up_c(torch.cat([h, enc_out[-1]], -1))
        h = self.up_b(torch.cat([h, enc_out[-2]], -1))
        h = self.up_a(torch.cat([h, enc_out[-3]], -1))
        for di in range(len(self.depths)):
            h = torch.cat([h, enc_out[-4 - di]], -1)
            h = getattr(self, f"up{di}")(getattr(self, f"dec_dense{di}")(h))
        h = self.last_dense(torch.cat([h, enc_out[0]], -1))
        h = lax_conv(h, self.last_kernel.permute(3, 2, 0, 1),
                     padding=((1, 1), (2, 2)), dtype=dt) \
            + self.last_bias.to(dt)
        h = h.float().reshape(b, t, self.in_freqs, 2, self.n_spk)
        out = torch.complex(h[..., 0, :], h[..., 1, :])
        return out.permute(0, 3, 1, 2)


def mfmcwf(mix: torch.Tensor, est: torch.Tensor, n_chunks: int,
           tik_eps: float) -> torch.Tensor:
    """Multi-frame multi-channel Wiener filter. mix: complex (B, T, C, F);
    est: complex (B', T, F), B' = B * n_spk -> complex (B', T, F)."""
    b, t, c, f = mix.shape
    spk = est.shape[0] // b
    ctx = 2 * n_chunks + 1
    if n_chunks > 0:
        pad = nn.functional.pad(mix, (0, 0, 0, 0, n_chunks, n_chunks))
        mix_unf = torch.stack([pad[:, i:i + t] for i in range(ctx)],
                              2).reshape(b, t, c * ctx, f)
    else:
        mix_unf = mix
    m = mix_unf.shape[2]
    mix_r = mix_unf.repeat_interleave(spk, 0)
    zeta = torch.einsum("btmf,btf->bmf", mix_r, est.conj())
    scm = torch.einsum("btmf,btnf->bmnf", mix_r, mix_r.conj())
    scm = scm.permute(0, 3, 1, 2)
    tr = torch.diagonal(scm, dim1=-2, dim2=-1).sum(-1).real.detach()
    load = (tr * tik_eps + 1e-8)[..., None, None]
    scm = scm + load * torch.eye(m, dtype=scm.dtype, device=scm.device)
    w = torch.linalg.solve(scm, zeta.transpose(1, 2)[..., None])[..., 0]
    return torch.einsum("bfm,btmf->btf", w.conj(), mix_r)


class iNeuBeSeparator(nn.Module):
    """(B, N) or (B, N, C) mixture -> (est (B, n_spk, N), lengths, others
    {"dnn1", "beam"} below the chosen output)."""

    def __init__(self, n_spk: int = 1, n_fft: int = 512, stride: int = 128,
                 mic_channels: int = 1, hid_chans: int = 32,
                 hid_chans_dense: int = 32, ksz_dense=(3, 3),
                 ksz_tcn: int = 3, tcn_repeats: int = 4, tcn_blocks: int = 7,
                 tcn_channels: int = 384, activation: str = "elu",
                 output_from: str = "dnn1", n_chunks: int = 3,
                 freeze_dnn1: bool = False, tik_eps: float = 1e-8,
                 dtype=F32):
        super().__init__()
        self.n_spk, self.n_fft, self.stride = n_spk, n_fft, stride
        self.mic_channels, self.output_from = mic_channels, output_from
        self.n_chunks, self.freeze_dnn1 = n_chunks, freeze_dnn1
        self.tik_eps = tik_eps
        kw = dict(in_freqs=n_fft // 2 + 1, hid_chans=hid_chans,
                  hid_chans_dense=hid_chans_dense, ksz_dense=ksz_dense,
                  ksz_tcn=ksz_tcn, tcn_repeats=tcn_repeats,
                  tcn_blocks=tcn_blocks, tcn_channels=tcn_channels,
                  activation=activation, dtype=dtype)
        self.dnn1 = TCNDenseUNet(n_spk=n_spk, mic_channels=mic_channels,
                                 **kw)
        if output_from == "dnn2":
            self.dnn2 = TCNDenseUNet(n_spk=1, mic_channels=mic_channels + 2,
                                     **kw)

    def forward(self, wav, lengths, generator=None):
        if wav.ndim == 2:
            wav = wav[..., None]
        b, n_mix, c = wav.shape
        if c != self.mic_channels:
            raise ValueError(f"iNeuBe built for {self.mic_channels} "
                             f"channels, given {c}")
        flat = wav.transpose(1, 2).reshape(b * c, n_mix)
        re, im = stft(flat, self.n_fft, self.stride, self.n_fft)
        t, f = re.shape[1], re.shape[2]
        mix = torch.complex(re, im).reshape(b, c, t, f).transpose(1, 2)
        feats = torch.cat([re.reshape(b, c, t, f), im.reshape(b, c, t, f)],
                          1).permute(0, 2, 3, 1)
        est1 = self.dnn1(feats)
        if self.freeze_dnn1:
            est1 = est1.detach()
        spk = self.n_spk

        def to_wav(cplx):
            flat_ = cplx.reshape(b * spk, t, f)
            w_ = istft(flat_.real, flat_.imag, self.n_fft, self.stride)
            if w_.shape[1] < n_mix:
                w_ = nn.functional.pad(w_, (0, n_mix - w_.shape[1]))
            return w_[:, :n_mix].reshape(b, spk, n_mix)

        others: Dict[str, torch.Tensor] = {}
        out1 = to_wav(est1)
        if self.output_from == "dnn1":
            return out1, lengths, others
        others["dnn1"] = out1
        est_bf = mfmcwf(mix, est1.reshape(b * spk, t, f), self.n_chunks,
                        self.tik_eps).reshape(b, spk, t, f)
        out_bf = to_wav(est_bf)
        if self.output_from == "mfmcwf":
            return out_bf, lengths, others
        others["beam"] = out_bf
        mix_rep = feats.repeat_interleave(spk, 0)
        e1 = est1.reshape(b * spk, t, f)
        eb = est_bf.reshape(b * spk, t, f)
        cat = torch.cat([mix_rep[..., :c], e1.real[..., None],
                         eb.real[..., None], mix_rep[..., c:],
                         e1.imag[..., None], eb.imag[..., None]], -1)
        est2 = self.dnn2(cat)
        return to_wav(est2[:, 0].reshape(b, spk, t, f)), lengths, others
