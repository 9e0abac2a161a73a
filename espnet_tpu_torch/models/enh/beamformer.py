"""The ASR frontend's DNN-WPE and mask-MVDR beamformer, and the
enhancement model's waveform beamformer (port of the `MaskEstimator`,
`DNNWPE`, `DNNBeamformer` and `BeamformerSeparator` of
espnet_tpu/models/enh/beamformer.py).

`MaskEstimator`: per-channel log1p magnitudes (B·C, T, F) through a
stacked BLSTM (each direction over the whole padded length, as the JAX
`nn.RNN` calls without `seq_lengths`), then one sigmoid Dense mask per
output. Its cells are named `OptimizedLSTMCell_{k}` in creation order, as
the JAX tree names them. `DNNWPE` estimates the source power from one
mask and takes one WPE step; `DNNBeamformer` averages its speech and noise
masks over channels, forms both PSDs and applies the Souden MVDR filter of
a fixed reference channel. The ASR model builds them in float32 whatever
its dtype, as the JAX model does.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from espnet_tpu_torch.models.layers import Dense, LSTMCell, lstm_sequence
from espnet_tpu_torch.ops.beamformer import (apply_beamformer, mvdr_weights,
                                             psd_matrix, wpe_one_iteration)


class MaskEstimator(nn.Module):
    """(B, F, C, T) complex -> `n_masks` masks (B, F, C, T) in [0, 1]."""

    def __init__(self, n_freq: int, n_masks: int = 2, hidden: int = 128,
                 num_layers: int = 2, dtype=torch.float32):
        super().__init__()
        self.n_masks = n_masks
        self.num_layers = num_layers
        for i in range(num_layers):
            d_in = n_freq if i == 0 else 2 * hidden
            for k in range(2):
                self.add_module(f"OptimizedLSTMCell_{2 * i + k}",
                                LSTMCell(d_in, hidden))
        for i in range(n_masks):
            self.add_module(f"mask_out{i}", Dense(2 * hidden, n_freq,
                                                  dtype=dtype))

    def forward(self, y) -> Tuple[torch.Tensor, ...]:
        b, f, c, t = y.shape
        x = torch.log1p(y.abs()).permute(0, 2, 3, 1).reshape(b * c, t, f)
        for i in range(self.num_layers):
            fwd, _ = lstm_sequence(
                getattr(self, f"OptimizedLSTMCell_{2 * i}"), x)
            bwd, _ = lstm_sequence(
                getattr(self, f"OptimizedLSTMCell_{2 * i + 1}"), x,
                reverse=True)
            x = torch.cat([fwd, bwd], dim=-1)
        masks = []
        for i in range(self.n_masks):
            m = torch.sigmoid(getattr(self, f"mask_out{i}")(x))
            masks.append(m.reshape(b, c, t, f).permute(0, 3, 1, 2))
        return tuple(masks)


class DNNWPE(nn.Module):
    """Mask-driven single-iteration WPE: y (B, F, C, T) -> (dereverberated,
    power mask)."""

    def __init__(self, n_freq: int, taps: int = 5, delay: int = 3,
                 hidden: int = 128, num_layers: int = 1,
                 use_dnn_mask: bool = True, dtype=torch.float32):
        super().__init__()
        self.taps = taps
        self.delay = delay
        self.use_dnn_mask = use_dnn_mask
        if use_dnn_mask:
            self.mask_est = MaskEstimator(n_freq, 1, hidden, num_layers,
                                          dtype)

    def forward(self, y):
        if self.use_dnn_mask:
            (mask,) = self.mask_est(y)
            power = (mask * y.abs() ** 2).mean(dim=-2)
        else:
            mask = torch.ones(y.shape, device=y.device)
            power = (y.abs() ** 2).mean(dim=-2)
        return wpe_one_iteration(y, power, self.taps, self.delay), mask


class DNNBeamformer(nn.Module):
    """Mask-based MVDR: y (B, F, C, T) -> (enhanced (B, F, T), masks)."""

    def __init__(self, n_freq: int, hidden: int = 128, num_layers: int = 2,
                 ref_channel: int = 0, dtype=torch.float32):
        super().__init__()
        self.ref_channel = ref_channel
        self.mask_est = MaskEstimator(n_freq, 2, hidden, num_layers, dtype)

    def forward(self, y):
        b, _, c, _ = y.shape
        mask_s, mask_n = self.mask_est(y)
        psd_s = psd_matrix(y, mask_s.mean(dim=-2))
        psd_n = psd_matrix(y, mask_n.mean(dim=-2))
        u = torch.zeros(b, c, device=y.device)
        u[:, self.ref_channel] = 1.0
        enhanced = apply_beamformer(mvdr_weights(psd_s, psd_n, u), y)
        return enhanced, {"mask_spk1": mask_s, "mask_noise1": mask_n}


class BeamformerSeparator(nn.Module):
    """Joint WPE + MVDR front end as a waveform-to-waveform enhancer: a
    multichannel mixture (B, n, C) is STFT'd per channel, optionally
    dereverberated, beamformed to one channel and inverse-STFT'd:
    ((B, 1, n), frame lengths, masks)."""

    def __init__(self, n_fft: int = 512, hop_length: int = 128,
                 use_wpe: bool = False, wpe_taps: int = 5,
                 wpe_delay: int = 3, hidden: int = 128, num_layers: int = 2,
                 ref_channel: int = 0, dtype=torch.float32):
        super().__init__()
        self.n_fft, self.hop_length, self.use_wpe = n_fft, hop_length, \
            use_wpe
        n_freq = n_fft // 2 + 1
        if use_wpe:
            self.wpe = DNNWPE(n_freq, wpe_taps, wpe_delay, hidden, 1,
                              dtype=dtype)
        self.beamformer = DNNBeamformer(n_freq, hidden, num_layers,
                                        ref_channel, dtype)

    def forward(self, speech_mix, lengths, generator=None):
        from espnet_tpu_torch.ops.stft import (istft, stft,
                                               stft_frames_lengths)

        b, n, c = speech_mix.shape
        flat = speech_mix.transpose(1, 2).reshape(b * c, n)
        real, imag = stft(flat, self.n_fft, self.hop_length)
        t, f = real.shape[1], real.shape[2]
        y = torch.complex(real, imag).reshape(b, c, t, f).permute(0, 3, 1, 2)
        others = {}
        if self.use_wpe:
            y, others["mask_dereverb1"] = self.wpe(y)
        enhanced, masks = self.beamformer(y)
        others.update(masks)
        spec = enhanced.transpose(1, 2)
        wav = istft(spec.real, spec.imag, self.n_fft, self.hop_length)
        wav = (wav[:, :n] if wav.shape[1] >= n
               else nn.functional.pad(wav, (0, n - wav.shape[1])))
        flens = stft_frames_lengths(lengths, self.n_fft, self.hop_length)
        return wav[:, None, :], flens, others
