"""End-to-end speech enhancement and separation (port of
espnet_tpu/models/enh/model.py).

`EnhConfig` carries every field and default of the JAX config (the dtype
as "float32" or "bfloat16", or a torch dtype). `EnhancementModel` is
encoder -> separator -> decoder (`forward_enhance`), or one waveform
separator (beamformer, fasnet, svoice, ineube), then `forward_loss`: every
criterion of `ops/enh_losses.py` under PIT, MixIT, the mask-label MSEs and
the deep-clustering loss, selected by `loss_type`. An unknown
`separator_type` resolves through `utils/registry.py` ("separator") and is
built as cls(feat_dim, num_spk, **separator_conf). Parameter names are the
JAX tree's (`encoder`, `separator`, `decoder`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from espnet_tpu_torch.models.enh.layers import (ConvDecoder, ConvEncoder,
                                                STFTDecoder, STFTEncoder)
from espnet_tpu_torch.models.enh.separators import (
    ConformerSeparator, DANSeparator, DPRNNSeparator, DPTNetSeparator,
    RNNSeparator, SkiMSeparator, TCNSeparator, TransformerSeparator)
from espnet_tpu_torch.models.layers import KernelRouted
from espnet_tpu_torch.ops.enh_losses import (ci_sdr_loss, dpcl_loss,
                                             mask_label, mixit_solve,
                                             pit_solve, si_snr_loss,
                                             snr_loss, spectral_l1_loss,
                                             tf_mse_loss, time_mse_loss)
from espnet_tpu_torch.ops.stft import stft, stft_frames_lengths

WAVEFORM_SEPARATORS = ("beamformer", "fasnet", "svoice", "ineube")


@dataclasses.dataclass(frozen=True)
class EnhConfig:
    num_spk: int = 2
    encoder_type: str = "conv"       # conv | stft
    # conv filterbank
    enc_channels: int = 256
    enc_kernel: int = 20
    enc_stride: int = 10
    # stft
    n_fft: int = 512
    hop_length: int = 128
    # separator: tcn | dprnn | transformer | dptnet | skim | conformer |
    # rnn | dan | dc_crn | dccrn | dpcl_e2e | svoice | ineube | fasnet |
    # beamformer, or a registered plug-in
    separator_type: str = "tcn"
    tcn_layers: int = 8
    tcn_stacks: int = 3
    tcn_bottleneck: int = 128
    tcn_hidden: int = 512
    tcn_kernel: int = 3
    dprnn_blocks: int = 6
    dprnn_hidden: int = 128
    dprnn_chunk: int = 100
    rnn_layers: int = 3
    rnn_hidden: int = 256
    dan_emb_dim: int = 20
    # dpcl_e2e soft k-means (fixed iteration count)
    dpcl_alpha: float = 5.0
    dpcl_kmeans_iters: int = 10
    trans_d_model: int = 256
    trans_heads: int = 4
    trans_d_ff: int = 1024
    trans_layers: int = 4
    conformer_kernel: int = 15
    skim_segment: int = 20
    skim_mem_type: str = "hc"
    # dc_crn (complex masking; needs encoder_type="stft")
    dc_crn_channels: Any = (2, 16, 32, 64)
    dc_crn_hid_channels: int = 8
    dc_crn_block_layers: int = 5
    glstm_groups: int = 2
    glstm_layers: int = 2
    dc_crn_mode: str = "masking"
    # dccrn (complex U-Net + complex LSTM; needs encoder_type="stft")
    dccrn_rnn_layer: int = 2
    dccrn_rnn_units: int = 256
    dccrn_masking_mode: str = "E"    # E | C | R
    dccrn_kernel_num: Any = (32, 64, 128, 256, 256, 256)
    dccrn_use_noise_mask: bool = False
    # fasnet (multichannel time domain)
    fasnet_enc_dim: int = 64
    fasnet_feature_dim: int = 64
    fasnet_hidden_dim: int = 128
    fasnet_layers: int = 4
    fasnet_segment_size: int = 50
    fasnet_win_ms: int = 4
    fasnet_context_ms: int = 16
    fasnet_sr: int = 16000
    # svoice (waveform-domain gated dual path, own encoder and decoder)
    svoice_enc_dim: int = 128
    svoice_kernel: int = 8
    svoice_hidden: int = 128
    svoice_layers: int = 4
    svoice_segment: int = 20
    svoice_normalize: bool = False
    # ineube (iterative neural beamforming, multichannel)
    ineube_mics: int = 1
    ineube_hid_chans: int = 32
    ineube_hid_chans_dense: int = 32
    ineube_tcn_repeats: int = 4
    ineube_tcn_blocks: int = 7
    ineube_tcn_channels: int = 384
    ineube_output_from: str = "dnn1"  # dnn1 | mfmcwf | dnn2
    ineube_n_chunks: int = 3
    ineube_freeze_dnn1: bool = False
    # neural beamformer (multichannel input)
    use_wpe: bool = False
    wpe_taps: int = 5
    wpe_delay: int = 3
    bf_hidden: int = 128
    bf_layers: int = 2
    ref_channel: int = 0
    nonlinear: str = "relu"
    # loss: si_snr | snr | ci_sdr | time_mse (PIT over waveforms);
    # tf_mse | spectral_l1 (PIT over magnitude STFTs);
    # mask_mse_ibm|irm|iam|psm|npsm (PIT over masks); dpcl; mixit
    separator_conf: Any = None
    loss_type: str = "si_snr"
    ci_sdr_filter_length: int = 512
    dropout_rate: float = 0.1
    dtype: Any = "float32"


def _build_separator(c: EnhConfig, feat_dim: int, dt) -> nn.Module:
    st = c.separator_type
    if st == "tcn":
        return TCNSeparator(feat_dim, c.num_spk, c.tcn_layers, c.tcn_stacks,
                            c.tcn_bottleneck, c.tcn_hidden, c.tcn_kernel,
                            nonlinear=c.nonlinear, dtype=dt)
    if st == "dprnn":
        return DPRNNSeparator(feat_dim, c.num_spk, c.dprnn_blocks,
                              c.dprnn_hidden, c.dprnn_chunk, c.nonlinear, dt)
    if st == "transformer":
        return TransformerSeparator(feat_dim, c.num_spk, c.trans_d_model,
                                    c.trans_heads, c.trans_d_ff,
                                    c.trans_layers, c.dropout_rate,
                                    c.nonlinear, dt)
    if st == "dptnet":
        return DPTNetSeparator(feat_dim, c.num_spk, c.dprnn_blocks, 0,
                               c.trans_heads, c.dprnn_hidden, c.dprnn_chunk,
                               c.nonlinear, c.dropout_rate, dt)
    if st == "skim":
        return SkiMSeparator(feat_dim, c.num_spk, c.dprnn_blocks,
                             c.dprnn_hidden, c.skim_segment, True,
                             c.skim_mem_type, c.nonlinear, dt)
    if st == "conformer":
        return ConformerSeparator(feat_dim, c.num_spk, c.trans_d_model,
                                  c.trans_heads, c.trans_d_ff,
                                  c.trans_layers, c.conformer_kernel,
                                  c.dropout_rate, c.nonlinear, dt)
    if st == "rnn":
        return RNNSeparator(feat_dim, c.num_spk, c.rnn_layers, c.rnn_hidden,
                            nonlinear=c.nonlinear, dtype=dt)
    if st == "dan":
        return DANSeparator(feat_dim, c.num_spk, c.rnn_layers, c.rnn_hidden,
                            c.dan_emb_dim, dt)
    if st in ("dc_crn", "dccrn") and c.encoder_type != "stft":
        raise ValueError(f"{st} needs encoder_type='stft' "
                         "(complex masking over STFT features)")
    if st == "dc_crn":
        from espnet_tpu_torch.models.enh.dc_crn import DC_CRNSeparator

        return DC_CRNSeparator(
            feat_dim, c.num_spk, input_channels=tuple(c.dc_crn_channels),
            enc_hid_channels=c.dc_crn_hid_channels,
            enc_layers=c.dc_crn_block_layers, glstm_groups=c.glstm_groups,
            glstm_layers=c.glstm_layers, mode=c.dc_crn_mode, dtype=dt)
    if st == "dpcl_e2e":
        from espnet_tpu_torch.models.enh.dpcl_e2e import DPCLE2ESeparator

        return DPCLE2ESeparator(
            feat_dim, c.num_spk, nonlinear=c.nonlinear, layers=c.rnn_layers,
            unit=c.rnn_hidden, emb_dim=c.dan_emb_dim, alpha=c.dpcl_alpha,
            kmeans_iters=c.dpcl_kmeans_iters,
            complex_pairs=c.encoder_type == "stft", dtype=dt)
    if st == "dccrn":
        from espnet_tpu_torch.models.enh.dccrn import DCCRNSeparator

        return DCCRNSeparator(
            feat_dim, c.num_spk, rnn_layer=c.dccrn_rnn_layer,
            rnn_units=c.dccrn_rnn_units, masking_mode=c.dccrn_masking_mode,
            kernel_num=tuple(c.dccrn_kernel_num),
            use_noise_mask=c.dccrn_use_noise_mask, dtype=dt)
    from espnet_tpu_torch.utils.registry import resolve

    cls = resolve("separator", st, f"unknown separator_type {st}")
    return cls(feat_dim, c.num_spk, **dict(c.separator_conf or {}))


def _build_waveform_separator(c: EnhConfig, dt) -> nn.Module:
    st = c.separator_type
    if st == "beamformer":
        from espnet_tpu_torch.models.enh.beamformer import \
            BeamformerSeparator

        return BeamformerSeparator(c.n_fft, c.hop_length, c.use_wpe,
                                   c.wpe_taps, c.wpe_delay, c.bf_hidden,
                                   c.bf_layers, c.ref_channel, dt)
    if st == "svoice":
        from espnet_tpu_torch.models.enh.svoice import SVoiceSeparator

        return SVoiceSeparator(
            enc_dim=c.svoice_enc_dim, kernel_size=c.svoice_kernel,
            hidden_size=c.svoice_hidden, num_spk=c.num_spk,
            num_layers=c.svoice_layers, segment_size=c.svoice_segment,
            bidirectional=True, input_normalize=c.svoice_normalize,
            dtype=dt)
    if st == "ineube":
        from espnet_tpu_torch.models.enh.ineube import iNeuBeSeparator

        return iNeuBeSeparator(
            n_spk=c.num_spk, n_fft=c.n_fft, stride=c.hop_length,
            mic_channels=c.ineube_mics, hid_chans=c.ineube_hid_chans,
            hid_chans_dense=c.ineube_hid_chans_dense,
            tcn_repeats=c.ineube_tcn_repeats,
            tcn_blocks=c.ineube_tcn_blocks,
            tcn_channels=c.ineube_tcn_channels,
            output_from=c.ineube_output_from, n_chunks=c.ineube_n_chunks,
            freeze_dnn1=c.ineube_freeze_dnn1, dtype=dt)
    from espnet_tpu_torch.models.enh.fasnet import FaSNetSeparator

    return FaSNetSeparator(
        c.fasnet_enc_dim, c.fasnet_feature_dim, c.fasnet_hidden_dim,
        c.fasnet_layers, c.fasnet_segment_size, c.num_spk,
        win_ms=c.fasnet_win_ms, context_ms=c.fasnet_context_ms,
        sr=c.fasnet_sr, dtype=dt)


class EnhancementModel(KernelRouted):
    """forward(speech_mix, speech_mix_lengths, speech_ref, generator) ->
    (loss, stats); speech_ref is (B, n, n_spk) (the collate layout) or
    (B, n_spk, n)."""

    def __init__(self, config: EnhConfig):
        super().__init__()
        c = self.config = config
        dt = getattr(torch, str(c.dtype).split(".")[-1])  # name or dtype
        self.encoder = self.decoder = None
        if c.separator_type in WAVEFORM_SEPARATORS:
            self.separator = _build_waveform_separator(c, dt)
            return
        if c.encoder_type == "conv":
            self.encoder = ConvEncoder(c.enc_channels, c.enc_kernel,
                                       c.enc_stride, dt)
            self.decoder = ConvDecoder(c.enc_channels, c.enc_kernel,
                                       c.enc_stride, dt)
            feat_dim = c.enc_channels
        elif c.encoder_type == "stft":
            self.encoder = STFTEncoder(c.n_fft, c.hop_length, dt)
            self.decoder = STFTDecoder(c.n_fft, c.hop_length, dt)
            feat_dim = self.encoder.output_dim
        else:
            raise ValueError(f"unknown encoder_type {c.encoder_type}")
        self.separator = _build_separator(c, feat_dim, dt)

    def forward_enhance(self, speech_mix, speech_lengths, generator=None):
        """Mixture -> (per-speaker waveforms (B, n_spk, n), others)."""
        if self.config.separator_type in WAVEFORM_SEPARATORS:
            wavs, _, others = self.separator(speech_mix, speech_lengths,
                                             generator)
            return wavs, others
        n = speech_mix.shape[1]
        feat, flens = self.encoder(speech_mix, speech_lengths)
        masked, _, others = self.separator(feat, flens, generator)
        b, c_spk = masked.shape[0], masked.shape[1]
        wavs = self.decoder(masked.reshape(b * c_spk, *masked.shape[2:]), n)
        return wavs.reshape(b, c_spk, n), others

    def forward(self, speech_mix, speech_mix_lengths, speech_ref,
                generator=None):
        c = self.config
        speech_refs = (speech_ref.transpose(1, 2)
                       if speech_ref.shape[-1] == c.num_spk else speech_ref)
        est, others = self.forward_enhance(speech_mix, speech_mix_lengths,
                                           generator)
        return self.forward_loss(est, others, speech_mix,
                                 speech_mix_lengths, speech_refs)

    def _stft(self, wav):
        return stft(wav, self.config.n_fft, self.config.hop_length)

    def _stft_lens(self, lengths):
        return stft_frames_lengths(lengths, self.config.n_fft,
                                   self.config.hop_length)

    def forward_loss(self, est, others, speech_mix, speech_mix_lengths,
                     speech_refs):
        """est (B, n_spk, n) waveforms; speech_refs (B, n_spk, n)."""
        c = self.config
        lt = c.loss_type
        lens = speech_mix_lengths
        stats: Dict[str, torch.Tensor] = {}
        time_crits = {
            "si_snr": si_snr_loss, "snr": snr_loss,
            "time_mse": time_mse_loss,
            "ci_sdr": lambda r, e, ln: ci_sdr_loss(
                r, e, ln, filter_length=c.ci_sdr_filter_length),
        }
        if lt in time_crits:
            crit = time_crits[lt]
            best, _ = pit_solve(lambda r, e: crit(r, e, lens), speech_refs,
                                est)
            loss = best.mean()
            if lt == "si_snr":
                stats["si_snr"] = -loss
            stats["loss"] = loss
            return loss, stats
        if lt == "mixit":
            best, _ = mixit_solve(lambda r, e: si_snr_loss(r, e, lens),
                                  speech_refs, est)
            loss = best.mean()
            stats["loss"] = loss
            return loss, stats
        if lt in ("tf_mse", "spectral_l1"):
            flens = self._stft_lens(lens)

            def mag(w):
                re, im = self._stft(w)
                return torch.sqrt(re ** 2 + im ** 2 + 1e-8)

            b, s, n = est.shape
            est_mag = mag(est.reshape(b * s, n))
            ref_mag = mag(speech_refs.reshape(b * s, n))
            est_mag = est_mag.reshape(b, s, *est_mag.shape[1:])
            ref_mag = ref_mag.reshape(b, s, *ref_mag.shape[1:])
            crit = tf_mse_loss if lt == "tf_mse" else spectral_l1_loss
            best, _ = pit_solve(lambda r, e: crit(r, e, flens), ref_mag,
                                est_mag)
            loss = best.mean()
            stats["loss"] = loss
            return loss, stats
        if lt.startswith("mask_mse_"):
            mask_type = lt[len("mask_mse_"):].upper()
            if c.encoder_type != "stft" or "mask_spk1" not in others:
                raise ValueError(
                    "mask_mse_* needs encoder_type='stft' and a masking "
                    "separator (predicted TF masks)")
            mix_re, mix_im = self._stft(speech_mix)
            flens = self._stft_lens(lens)
            f = mix_re.shape[-1]
            labels, preds = [], []
            for i in range(c.num_spk):
                ref_re, ref_im = self._stft(speech_refs[:, i])
                labels.append(mask_label(mix_re, mix_im, ref_re, ref_im,
                                         mask_type))
                m = others[f"mask_spk{i + 1}"]
                if m.shape[-1] == 2 * f:
                    m = 0.5 * (m[..., :f] + m[..., f:])
                preds.append(m)
            best, _ = pit_solve(lambda r, e: tf_mse_loss(r, e, flens),
                                torch.stack(labels, 1),
                                torch.stack(preds, 1))
            loss = best.mean()
            stats["loss"] = loss
            return loss, stats
        if lt == "dpcl":
            if "embedding" not in others:
                raise ValueError(
                    "loss_type='dpcl' needs a separator exposing TF "
                    "embeddings (separator_type='dan')")
            emb = others["embedding"]
            emb = emb / torch.linalg.norm(emb, dim=-1,
                                          keepdim=True).clamp(min=1e-8)
            mix_re, _ = self._stft(speech_mix)
            b, t, f = mix_re.shape
            mags = []
            for i in range(c.num_spk):
                re, im = self._stft(speech_refs[:, i])
                mags.append(torch.sqrt(re ** 2 + im ** 2 + 1e-8))
            dom = torch.stack(mags, -1).argmax(-1)
            if emb.shape[1] == t * 2 * f:
                dom = torch.cat([dom, dom], dim=-1)
            elif emb.shape[1] != t * f:
                raise ValueError(
                    f"embedding TF axis {emb.shape[1]} matches neither "
                    f"T*F={t * f} nor T*2F — dpcl needs encoder_type='stft'"
                    " with matching n_fft/hop_length")
            n_bins = emb.shape[1]
            ref_masks = nn.functional.one_hot(
                dom.reshape(b, n_bins), c.num_spk).to(emb.dtype)
            loss = dpcl_loss(emb, ref_masks).mean() / n_bins
            stats["loss"] = loss
            return loss, stats
        raise ValueError(f"unknown loss_type {lt}")
