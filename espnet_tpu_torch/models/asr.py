"""Joint CTC/attention ASR model (port of espnet_tpu/models/asr.py).

Every part that the JAX `ASRModel` selects through its `ASRConfig`: a
frontend (`input_type`: "raw" 16 kHz waveform -> log-mel, multichannel
(B, N, C) with DNN-WPE and the mask-MVDR beamformer when `num_channels` >
1; "feats", precomputed features passed through; "sliding_window",
raw-sample frames; "fused", two log-mel resolutions concatenated; "sinc",
`LightweightSincConvs`; "ssl", the S3PRL featurizer over a wav2vec2 /
HuBERT trunk, `models/ssl.py` `SSLFrontend`, configured by the `ssl`
section) -> SpecAug (training) -> global MVN (stats in the `mvn` buffers,
loaded from the JAX `mvn` collection), utterance MVN or none -> an encoder
(conformer, transformer, Branchformer, E-Branchformer, contextual-block
conformer, longformer, VGG-BLSTM, VGG-LSTM, "wav2vec2" (the trunk itself
on the raw waveform, with no frontend, SpecAug or normalisation),
"whisper" (Whisper's encoder on Whisper's log-mel, the `whisper` section),
or a plugin registered under `encoder_type` in `utils/registry.py`, built
from `encoder_conf`) -> a CTC head (when `ctc_weight` > 0) and a decoder
(when `ctc_weight` < 1: transformer, the v1 RNN decoder with the attention
of `rnn_att_type`, the S4 decoder, Whisper's decoder over the ASR's
vocabulary, or a registered plugin built from `decoder_conf`). `forward`
is the training loss (CTC weight `ctc_weight`, InterCTC on the encoder
layers `interctc_layer_idx` mixed into the CTC loss with
`interctc_weight`, label-smoothed attention loss); `encode`,
`encode_chunk` (the VGG-LSTM's carried chunk streaming), `ctc_log_probs`
and the decoder's step scoring serve inference. sos = eos = vocab_size - 1
and blank = 0, as in the JAX package. Parameters are float32;
`ASRConfig.dtype` is the compute dtype (bfloat16 for the bench model); the
multichannel frontend runs in float32 whatever it is, as in JAX.

The `ssl` and `whisper` sections take `SSLConfig` / `WhisperConfig`
instances or plain dicts (a config.yaml's); the model rebuilds the
dataclasses with lists as tuples and the compute dtype pinned to its own
(the JAX `_coerce_section`). `ssl_freeze` runs the trunk without a graph
(the JAX stop-gradient) in the SSL frontend and the wav2vec2 encoder.

Dropout and SpecAug are on while the model is training and the caller
passes a `torch.Generator`, from which all their randomness is drawn (the
FFN kernels' seeds included).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from espnet_tpu_torch.models.branchformer import VARIANTS, BranchformerEncoder
from espnet_tpu_torch.models.conformer import ConformerEncoder
from espnet_tpu_torch.models.enh.beamformer import DNNWPE, DNNBeamformer
from espnet_tpu_torch.models.layers import Dense, KernelRouted
from espnet_tpu_torch.models.longformer import LongformerEncoder
from espnet_tpu_torch.models.rnn import RNNDecoder, VGGRNNEncoder
from espnet_tpu_torch.models.s4_decoder import S4Decoder
from espnet_tpu_torch.models.sinc import LightweightSincConvs
from espnet_tpu_torch.models.ssl import (SSLConfig, SSLFrontend,
                                         Wav2Vec2ASREncoder, WhisperConfig,
                                         WhisperDecoder, WhisperEncoder,
                                         whisper_log_mel)
from espnet_tpu_torch.models.streaming import ContextualBlockConformerEncoder
from espnet_tpu_torch.models.transformer import (TransformerDecoder,
                                                 TransformerEncoder)
from espnet_tpu_torch.ops.ctc import ctc_loss, min_frames
from espnet_tpu_torch.ops.losses import label_smoothing_loss, token_accuracy
from espnet_tpu_torch.ops.masks import make_valid_mask
from espnet_tpu_torch.ops.normalize import global_mvn, utterance_mvn
from espnet_tpu_torch.ops.specaug import specaug
from espnet_tpu_torch.ops.stft import (frame_signal, log_mel,
                                       log_mel_spectrogram, stft,
                                       stft_frames_lengths)
from espnet_tpu_torch.utils import registry


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    """The fields of the JAX `ASRConfig`, with the JAX defaults: a frontend
    (`input_type`: "raw" | "feats" | "sliding_window" | "fused" | "sinc" |
    "ssl"; multichannel raw input with `num_channels` > 1) with SpecAug and
    a normalisation (`normalize`: "global_mvn" | "utterance_mvn" | "none"),
    an encoder (`encoder_type`: "conformer" | "transformer" |
    "branchformer" | "e_branchformer" | "contextual_block_conformer" |
    "longformer" | "vgg_blstm" | "vgg_lstm" | "wav2vec2" | "whisper" | a
    registered plugin), a CTC head and a decoder (`decoder_type`:
    "transformer" | "rnn" | "s4" | "whisper" | a registered plugin); `ssl`
    and `whisper` configure the SSL trunk and Whisper (`SSLConfig`,
    `WhisperConfig` or dicts of their fields)."""

    vocab_size: int
    input_type: str = "raw"
    sinc_out_dim: int = 256  # LightweightSincConvs' output width
    fused_n_fft2: int = 0  # second resolution of "fused" (0 = 2 * n_fft)
    # multichannel frontend: (B, N, C) raw input, optional DNN-WPE, then the
    # mask-MVDR beamformer (or the reference channel), when num_channels > 1
    num_channels: int = 1
    use_wpe: bool = False
    use_beamformer: bool = True
    wpe_taps: int = 5
    wpe_delay: int = 3
    ref_channel: int = 0
    frontend_hidden: int = 128
    frontend_layers: int = 2
    fs: int = 16000
    n_fft: int = 512
    hop_length: int = 128
    win_length: Optional[int] = None
    n_mels: int = 80
    use_specaug: bool = True
    num_freq_masks: int = 2
    freq_mask_width: Tuple[int, int] = (0, 20)
    num_time_masks: int = 2
    time_mask_width: Tuple[int, int] = (0, 40)
    normalize: str = "global_mvn"
    encoder_type: str = "conformer"
    # longformer band half-width, in subsampled frames
    attention_window: int = 100
    # streaming (contextual_block_conformer) geometry, in subsampled frames
    block_size: int = 40
    stream_hop_size: int = 16
    look_ahead: int = 16
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 2048
    num_encoder_layers: int = 12
    subsampling_factor: int = 4
    # recompute each encoder block's activations in the backward pass
    # (conformer and transformer; inert for the branchformers, as in JAX)
    remat_encoder: bool = False
    # JAX checkpoints of the conformer hold one stacked `block` (convert.py)
    scan_encoder_layers: bool = False
    conformer_kernel_size: int = 31
    # the SSL trunk (input_type ssl, encoder_type wav2vec2) and Whisper
    # (encoder_type / decoder_type whisper); ssl_freeze: no gradient into
    # the trunk
    ssl: Any = None
    whisper: Any = None
    ssl_freeze: bool = True
    decoder_type: str = "transformer"
    num_decoder_layers: int = 6
    decoder_d_ff: int = 2048
    # the RNN decoder's attention (the v1 zoo) and scheduled sampling
    rnn_att_type: str = "location"
    sampling_probability: float = 0.0
    # plugins: an encoder_type / decoder_type that is not built in is looked
    # up in utils/registry.py and built from this dict
    encoder_conf: Any = None
    decoder_conf: Any = None
    ctc_weight: float = 0.3
    # InterCTC: auxiliary CTC on these 1-based encoder layers
    interctc_layer_idx: Tuple[int, ...] = ()
    interctc_weight: float = 0.0
    lsm_weight: float = 0.1
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.float32

    @property
    def sos_id(self) -> int:
        return self.vocab_size - 1

    @property
    def eos_id(self) -> int:
        return self.vocab_size - 1

    @property
    def blank_id(self) -> int:
        return 0


NORMALIZE = ("global_mvn", "utterance_mvn", "none")
INPUT_TYPES = ("raw", "feats", "sliding_window", "fused", "sinc", "ssl")
MERGE_KERNEL = 3  # the JAX BranchformerEncoder's default; no config field


def coerce_section(value, cls, dtype):
    """The `ssl` / `whisper` section as a `cls` dataclass (None stays None):
    a dict (YAML, or a dataclass's asdict) with lists as tuples, its dtype
    pinned to the model's compute `dtype`."""
    if value is None:
        return None
    if isinstance(value, cls):
        return dataclasses.replace(value, dtype=dtype)
    d = {k: tuple(v) if isinstance(v, list) else v
         for k, v in dict(value).items()}
    d.pop("dtype", None)
    return cls(dtype=dtype, **d)


def with_sections(c: ASRConfig) -> ASRConfig:
    """`c` with its `ssl` and `whisper` sections as dataclasses (the
    defaults of one when an SSL or Whisper part is selected without it);
    the model keeps this form."""
    ssl = coerce_section(c.ssl, SSLConfig, c.dtype)
    whisper = coerce_section(c.whisper, WhisperConfig, c.dtype)
    if ssl is None and (c.input_type == "ssl"
                        or c.encoder_type == "wav2vec2"):
        ssl = SSLConfig(dtype=c.dtype)
    if whisper is None and "whisper" in (c.encoder_type, c.decoder_type):
        whisper = WhisperConfig(dtype=c.dtype)
    return dataclasses.replace(c, ssl=ssl, whisper=whisper)


def encoder_output_dim(c: ASRConfig) -> int:
    """The encoder's output width: Whisper's d_model for its encoder, else
    d_model (the wav2vec2 encoder projects to it)."""
    if c.encoder_type == "whisper":
        return with_sections(c).whisper.d_model
    return c.d_model


def feature_dim(c: ASRConfig) -> int:
    """The width of the frontend's features: the encoder's input width and
    the global MVN's (the JAX `GlobalMVN(feat_dim)`): `win_length` (400
    unset) samples for "sliding_window", 2 x n_mels for "fused",
    `sinc_out_dim` for "sinc", the trunk's `hidden_size` for "ssl",
    Whisper's `n_mels` for raw input into the Whisper encoder (JAX sizes
    that MVN by the ASR's n_mels: ROADMAP.md queue 3), else n_mels
    (precomputed "feats" must be n_mels wide)."""
    if c.input_type == "ssl":
        return with_sections(c).ssl.hidden_size
    if c.input_type == "raw" and c.encoder_type == "whisper":
        return with_sections(c).whisper.n_mels
    if c.input_type == "sinc":
        return c.sinc_out_dim
    if c.input_type == "sliding_window":
        return c.win_length or 400
    if c.input_type == "fused":
        return 2 * c.n_mels
    return c.n_mels


class GlobalMVN(nn.Module):
    """Global mean/variance normalisation with its stats in non-trainable
    buffers `mean` and `inv_std` (the JAX variables
    {"mvn": {"mvn": {"mean", "inv_std"}}}, filled by the collect-stats
    pass); identity stats until loaded."""

    def __init__(self, dim: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("inv_std", torch.ones(dim))

    def forward(self, x, lengths):
        return global_mvn(x, lengths, self.mean, self.inv_std)


def build_encoder(c: ASRConfig,
                  encoder_options: Optional[Dict] = None) -> nn.Module:
    """The encoder of `c.encoder_type`, built as the JAX `ASRModel` builds
    it (the branchformers' cgMLP width is d_ff, their conv kernel the
    conformer's; they have no InterCTC and no remat), its input width the
    frontend's (`feature_dim`). `encoder_options` are further keyword
    arguments of the encoder's constructor that the JAX `ASRConfig` has no
    field for: the conformer's kernel routes `fused_conv` and
    `fused_conv_split`. The VGG-RNN encoders' units and projections are
    both `d_model`, as the JAX model ties them. Any other `encoder_type`
    is a plugin of `utils/registry.py`, built from `encoder_conf` alone."""
    opts = dict(encoder_options or {})
    n_feats = feature_dim(c)
    capture = tuple(c.interctc_layer_idx)
    if c.encoder_type == "conformer":
        return ConformerEncoder(
            n_feats, c.d_model, c.num_heads, c.d_ff, c.num_encoder_layers,
            c.conformer_kernel_size, c.subsampling_factor, c.dtype,
            c.dropout_rate, capture_layers=capture, remat=c.remat_encoder,
            scan_layers=c.scan_encoder_layers, **opts)
    if c.encoder_type == "transformer":
        return TransformerEncoder(
            n_feats, c.d_model, c.num_heads, c.d_ff, c.num_encoder_layers,
            c.subsampling_factor, c.dtype, c.dropout_rate,
            capture_layers=capture, remat=c.remat_encoder, **opts)
    if c.encoder_type in VARIANTS:
        return BranchformerEncoder(
            n_feats, c.d_model, c.num_heads, c.d_ff, c.num_encoder_layers,
            cgmlp_hidden=c.d_ff, cgmlp_kernel=c.conformer_kernel_size,
            subsampling_factor=c.subsampling_factor, variant=c.encoder_type,
            merge_kernel=MERGE_KERNEL, dtype=c.dtype,
            dropout_rate=c.dropout_rate, **opts)
    if c.encoder_type == "contextual_block_conformer":
        return ContextualBlockConformerEncoder(
            n_feats, c.d_model, c.num_heads, c.d_ff, c.num_encoder_layers,
            c.conformer_kernel_size, c.dropout_rate, c.subsampling_factor,
            c.block_size, c.stream_hop_size, c.look_ahead, dtype=c.dtype,
            **opts)
    if c.encoder_type == "longformer":
        return LongformerEncoder(
            n_feats, c.d_model, c.num_heads, c.d_ff, c.num_encoder_layers,
            c.attention_window, c.conformer_kernel_size, c.dropout_rate,
            c.subsampling_factor, c.dtype)
    if c.encoder_type in ("vgg_blstm", "vgg_lstm"):
        return VGGRNNEncoder(
            n_feats, c.d_model, c.d_model, c.num_encoder_layers,
            c.encoder_type == "vgg_blstm", c.dropout_rate, c.dtype)
    if c.encoder_type == "wav2vec2":
        return Wav2Vec2ASREncoder(with_sections(c).ssl, c.d_model,
                                  freeze=c.ssl_freeze)
    if c.encoder_type == "whisper":
        return WhisperEncoder(with_sections(c).whisper)
    cls = registry.resolve("encoder", c.encoder_type,
                           f"unknown encoder_type {c.encoder_type}")
    return cls(**dict(c.encoder_conf or {}))


def build_decoder(c: ASRConfig) -> Optional[nn.Module]:
    """The decoder of `c.decoder_type` (None without one, ctc_weight 1):
    the transformer, the v1 RNN decoder (embedding, units and the
    attention's output all `d_model` wide, as the JAX model builds it), the
    S4 decoder, Whisper's decoder (its geometry the `whisper` section's,
    its vocabulary the ASR's), or a plugin of `utils/registry.py` built from
    `decoder_conf` alone."""
    if c.ctc_weight >= 1.0:
        return None
    if c.decoder_type == "transformer":
        return TransformerDecoder(c.vocab_size, c.d_model, c.num_heads,
                                  c.decoder_d_ff, c.num_decoder_layers,
                                  c.dtype, c.dropout_rate)
    if c.decoder_type == "rnn":
        return RNNDecoder(
            c.vocab_size, encoder_dim=c.d_model, embed_dim=c.d_model,
            hidden=c.d_model, num_layers=c.num_decoder_layers,
            att_type=c.rnn_att_type,
            sampling_probability=c.sampling_probability,
            dropout_rate=c.dropout_rate, dtype=c.dtype)
    if c.decoder_type == "s4":
        return S4Decoder(c.vocab_size, c.d_model, c.num_heads,
                         c.decoder_d_ff, c.num_decoder_layers,
                         dropout_rate=c.dropout_rate, dtype=c.dtype)
    if c.decoder_type == "whisper":
        return WhisperDecoder(dataclasses.replace(with_sections(c).whisper,
                                                  vocab_size=c.vocab_size))
    cls = registry.resolve("decoder", c.decoder_type,
                           f"unknown decoder_type {c.decoder_type}")
    return cls(**dict(c.decoder_conf or {}))


class ASRBase(KernelRouted):
    """What the ASR models share: the generator that training with dropout
    or SpecAug needs, the CTC head's log-posteriors, and the frontend of
    the JAX Mask-CTC, mulenc and asr_mix models."""

    def require_generator(self, generator) -> None:
        c = self.config
        if (self.training and generator is None
                and (c.dropout_rate > 0.0 or c.use_specaug)):
            raise ValueError("training with dropout or SpecAug needs a "
                             "torch.Generator")

    def ctc_log_probs(self, encoder_out):
        return torch.log_softmax(self.ctc_head(encoder_out).float(), dim=-1)

    def task_frontend(self, speech, speech_lengths, generator=None,
                      win_length=None, features: bool = False):
        """The JAX models' `_frontend`: log-mel of the waveforms
        (`features`: precomputed features, passed through), SpecAug with
        its default masks while training, utterance MVN when
        `config.normalize` says so (they read no global-MVN stats)."""
        c = self.config
        if features:
            feats, flens = speech, speech_lengths
        else:
            feats, flens = log_mel_spectrogram(
                speech, speech_lengths, c.fs, c.n_fft, c.hop_length,
                win_length, c.n_mels)
        if c.use_specaug and self.training and generator is not None:
            feats = specaug(generator, feats, flens)
        if c.normalize == "utterance_mvn":
            feats = utterance_mvn(feats, flens)
        return feats, flens


class ASRModel(ASRBase):
    """Frontend + encoder + CTC head (ctc_weight > 0) + decoder (ctc_weight
    < 1). `encoder_options` go to `build_encoder`. A model without a
    decoder has `decoder` None, one without a CTC head `ctc_head` None, so
    their state dicts hold exactly the JAX model's leaves; the multichannel
    frontend's modules are `frontend_wpe` and `frontend_beamformer`, the
    sinc frontend `sinc_frontend`, as JAX names them."""

    def __init__(self, config: ASRConfig,
                 encoder_options: Optional[Dict] = None):
        super().__init__()
        c = config
        if not 0.0 <= c.ctc_weight <= 1.0:
            raise ValueError(f"ctc_weight {c.ctc_weight} not in [0, 1]")
        if c.normalize is None:  # the CLI's "none" (as in JAX)
            c = dataclasses.replace(c, normalize="none")
        if c.normalize not in NORMALIZE:
            raise ValueError(f"normalize {c.normalize!r} not in {NORMALIZE}")
        if c.input_type not in INPUT_TYPES:
            raise ValueError(f"input_type {c.input_type!r} not in "
                             f"{INPUT_TYPES}")
        if c.interctc_layer_idx and c.encoder_type not in ("conformer",
                                                           "transformer"):
            raise ValueError(
                "interctc_layer_idx requires a conformer/transformer encoder")
        if not all(isinstance(i, int)
                   and 1 <= i <= c.num_encoder_layers
                   for i in c.interctc_layer_idx):
            # the JAX model silently captures nothing for a string such as
            # the CLI's "6" (a list needs "6," or "[6]")
            raise ValueError(
                f"interctc_layer_idx {c.interctc_layer_idx!r}: give 1-based "
                f"layer numbers up to {c.num_encoder_layers} as a list "
                "(--model.interctc_layer_idx 6, or [6] in YAML)")
        c = with_sections(c)
        self.config = c
        self.encoder_options = dict(encoder_options or {})
        # the wav2vec2 encoder takes the raw waveform: no normalisation (the
        # JAX model never calls its GlobalMVN there, so it has no stats)
        if c.normalize == "global_mvn" and c.encoder_type != "wav2vec2":
            self.mvn = GlobalMVN(feature_dim(c))
        if c.input_type == "ssl":
            self.ssl_frontend = SSLFrontend(c.ssl, freeze=c.ssl_freeze)
        if (c.encoder_type == "whisper" and c.ctc_weight < 1.0
                and c.decoder_type != "whisper"
                and c.whisper.d_model != c.d_model):
            raise ValueError(
                f"the Whisper encoder's output is {c.whisper.d_model} wide "
                f"and the {c.decoder_type} decoder's memory d_model "
                f"{c.d_model}: set d_model to Whisper's")
        self.encoder = build_encoder(c, self.encoder_options)
        self.decoder = build_decoder(c)
        self.ctc_head = (Dense(encoder_output_dim(c), c.vocab_size,
                               dtype=c.dtype)
                         if c.ctc_weight > 0.0 else None)
        if self.multichannel:
            n_freq = c.n_fft // 2 + 1
            if c.use_wpe:
                self.frontend_wpe = DNNWPE(n_freq, c.wpe_taps, c.wpe_delay,
                                           c.frontend_hidden, 1)
            if c.use_beamformer:
                self.frontend_beamformer = DNNBeamformer(
                    n_freq, c.frontend_hidden, c.frontend_layers,
                    c.ref_channel)
        if c.input_type == "sinc":
            self.sinc_frontend = LightweightSincConvs(
                fs=c.fs, win_length=c.win_length or 400,
                hop_length=c.hop_length, out_dim=c.sinc_out_dim,
                dropout_rate=c.dropout_rate, dtype=c.dtype)

    @property
    def multichannel(self) -> bool:
        return self.config.num_channels > 1 and self.config.input_type == "raw"

    def multichannel_frontend(self, speech, speech_lengths):
        """(B, N, C) waveforms -> (log-mel (B, T, n_mels), lengths): the STFT
        of every channel, optional DNN-WPE, the mask-MVDR beamformer (or the
        reference channel), power, log-mel; in float32."""
        c = self.config
        b, n, ch = speech.shape
        flat = speech.float().transpose(1, 2).reshape(b * ch, n)
        real, imag = stft(flat, c.n_fft, c.hop_length, c.win_length)
        t, f = real.shape[1], real.shape[2]
        y = torch.complex(real, imag).reshape(b, ch, t, f).permute(0, 3, 1, 2)
        if c.use_wpe:
            y, _ = self.frontend_wpe(y)  # (B, F, C, T)
        spec = (self.frontend_beamformer(y)[0] if c.use_beamformer
                else y[:, :, c.ref_channel])  # (B, F, T)
        p = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)
        feats = log_mel(p, c.fs, c.n_fft, c.n_mels)
        feat_lengths = stft_frames_lengths(speech_lengths, c.n_fft,
                                           c.hop_length)
        mask = make_valid_mask(feat_lengths, feats.shape[1])
        return feats * mask[:, :, None].to(feats.dtype), feat_lengths

    def frontend(self, speech, speech_lengths, generator=None):
        """speech (B, N) waveforms ((B, N, C) multichannel), or (B, T, D)
        features for "feats" -> (normalised features (B, T, feature_dim),
        lengths); the waveforms themselves for the wav2vec2 encoder."""
        c = self.config
        if c.encoder_type == "wav2vec2":
            return speech, speech_lengths
        if self.multichannel:
            feats, feat_lengths = self.multichannel_frontend(speech,
                                                             speech_lengths)
        elif c.input_type == "sinc":
            feats, feat_lengths = self.sinc_frontend(speech, speech_lengths,
                                                     generator)
        elif c.input_type == "ssl":
            feats, feat_lengths = self.ssl_frontend(speech, speech_lengths,
                                                    generator)
        elif c.input_type == "raw" and c.encoder_type == "whisper":
            feats, feat_lengths = whisper_log_mel(speech, speech_lengths,
                                                  c.fs, c.whisper.n_mels)
        elif c.input_type == "raw":
            feats, feat_lengths = log_mel_spectrogram(
                speech, speech_lengths, c.fs, c.n_fft, c.hop_length,
                c.win_length, c.n_mels)
        elif c.input_type == "sliding_window":
            # raw-sample frames as features
            # (`espnet2/asr/frontend/windowing.py` SlidingWindow)
            feats = frame_signal(speech, c.win_length or 400, c.hop_length,
                                 center=True)
            feat_lengths = torch.clamp(
                torch.div(speech_lengths, c.hop_length,
                          rounding_mode="floor") + 1, max=feats.shape[1])
        elif c.input_type == "fused":
            # two spectral resolutions on the same hop grid, concatenated
            # (`espnet2/asr/frontend/fused.py` FusedFrontends)
            f1, feat_lengths = log_mel_spectrogram(
                speech, speech_lengths, c.fs, c.n_fft, c.hop_length,
                c.win_length, c.n_mels)
            f2, _ = log_mel_spectrogram(
                speech, speech_lengths, c.fs, c.fused_n_fft2 or 2 * c.n_fft,
                c.hop_length, None, c.n_mels)
            t = min(f1.shape[1], f2.shape[1])
            feats = torch.cat([f1[:, :t], f2[:, :t]], dim=-1)
            feat_lengths = torch.clamp(feat_lengths, max=t)
        else:  # "feats": precomputed features
            feats, feat_lengths = speech, speech_lengths
        if c.use_specaug and self.training and generator is not None:
            feats = specaug(generator, feats, feat_lengths,
                            num_freq_masks=c.num_freq_masks,
                            freq_mask_width=c.freq_mask_width,
                            num_time_masks=c.num_time_masks,
                            time_mask_width=c.time_mask_width)
        if c.normalize == "global_mvn":
            feats = self.mvn(feats, feat_lengths)
        elif c.normalize == "utterance_mvn":
            feats = utterance_mvn(feats, feat_lengths)
        return feats, feat_lengths

    def encode_with_intermediates(self, speech, speech_lengths,
                                  generator=None):
        """(encoder out (B, T', D), output lengths, [(layer, its output),
        ...] of the InterCTC layers, empty without them)."""
        feats, feat_lengths = self.frontend(speech, speech_lengths, generator)
        out = self.encoder(feats, feat_lengths, generator)
        if len(out) == 3:
            return out
        return out[0], out[1], []

    def encode(self, speech, speech_lengths, generator=None):
        """(B, N) waveform, (B,) lengths -> (encoder out (B, T', D),
        output lengths); InterCTC intermediates are dropped."""
        out = self.encode_with_intermediates(speech, speech_lengths,
                                             generator)
        return out[0], out[1]

    def encode_chunk(self, speech, speech_lengths, carry):
        """The v1 chunk-streaming encode (`decode/streaming_v1.py`): the
        frontend, then the unidirectional VGG-LSTM resuming from `carry`.
        Returns (enc, enc_lengths, new carry)."""
        if self.config.encoder_type != "vgg_lstm":
            raise ValueError("encode_chunk needs encoder_type=vgg_lstm")
        feats, feat_lengths = self.frontend(speech, speech_lengths)
        return self.encoder(feats, feat_lengths, None, carry=carry,
                            return_carry=True)

    def encoder_carry(self, batch: int, device=None):
        return self.encoder.init_carry(batch, device)

    def forward(self, speech, speech_lengths, text, text_lengths,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training loss: (loss, stats). The stats are the JAX model's:
        loss_ctc, loss_interctc_layer{i} and loss_interctc (InterCTC),
        ctc_infeasible (with a CTC head), loss_att and acc (with a decoder),
        and loss. text: (B, U) int labels padded past text_lengths. In
        training mode `generator` drives dropout and SpecAug and is required
        when either is configured."""
        c = self.config
        self.require_generator(generator)
        enc, enc_lengths, inters = self.encode_with_intermediates(
            speech, speech_lengths, generator)
        text = text.long()
        text_lengths = text_lengths.long()
        stats = {}
        loss_ctc = loss_att = 0.0
        if self.ctc_head is not None:
            loss_ctc = ctc_loss(self.ctc_head(enc), text, enc_lengths,
                                text_lengths, c.blank_id,
                                use_kernels=self.use_kernels)
            stats["loss_ctc"] = loss_ctc
            if inters and c.interctc_weight > 0.0:
                # auxiliary CTC on intermediate layers, the same CTC head
                # (`espnet2/asr/espnet_model.py:244-286`)
                loss_inter = 0.0
                for idx, h in inters:
                    li = ctc_loss(self.ctc_head(h), text, enc_lengths,
                                  text_lengths, c.blank_id,
                                  use_kernels=self.use_kernels)
                    stats[f"loss_interctc_layer{idx}"] = li
                    loss_inter = loss_inter + li
                loss_inter = loss_inter / len(inters)
                loss_ctc = ((1.0 - c.interctc_weight) * loss_ctc
                            + c.interctc_weight * loss_inter)
                stats["loss_interctc"] = loss_inter
            # utterances too short for any CTC alignment (zero_infinity
            # zeroes them; a high share means the data or subsampling is
            # wrong)
            need = text_lengths + min_frames(text, text_lengths)
            stats["ctc_infeasible"] = (enc_lengths < need).float().mean()
        if self.decoder is not None:
            ys_in, ys_out, ys_lengths = add_sos_eos(text, text_lengths,
                                                    c.sos_id, c.eos_id)
            logits = self.decoder(ys_in, ys_lengths, enc, enc_lengths,
                                  generator)
            valid = make_valid_mask(ys_lengths, ys_in.shape[1])
            loss_att = label_smoothing_loss(logits, ys_out, valid,
                                            c.lsm_weight)
            stats["loss_att"] = loss_att
            stats["acc"] = token_accuracy(logits, ys_out, valid)
        loss = c.ctc_weight * loss_ctc + (1.0 - c.ctc_weight) * loss_att
        stats["loss"] = loss
        return loss, stats

    def decoder_score_step(self, tokens_step, pos, memory, memory_lengths,
                           cache):
        return self.decoder.score_step(tokens_step, pos, memory,
                                       memory_lengths, cache)

    @property
    def decoder_max_steps(self) -> Optional[int]:
        """The most label steps the decoder can score: Whisper's positions
        end at max_target_positions (the search stops one short of it);
        None for the others. (The JAX decoder clamps the position index
        past its table: ROADMAP.md queue 3.)"""
        if self.config.decoder_type == "whisper" and self.decoder is not None:
            return self.config.whisper.max_target_positions - 1
        return None

    def decoder_init_cache(self, batch, max_len, memory=None,
                           memory_lengths=None):
        """The decoder's empty beam cache for `batch` hypotheses, on the
        memory's device (the parameters' without a memory); the RNN
        decoder's depends on the memory (its attention's first alignment)
        and needs it, as in JAX."""
        if self.config.decoder_type == "rnn":
            return self.decoder.score_memory_cache(batch, memory,
                                                   memory_lengths)
        device = (memory.device if memory is not None
                  else next(self.parameters()).device)
        return self.decoder.init_cache(batch, max_len, device=device)


def add_sos_eos(text, text_lengths, sos: int, eos: int):
    """(B, U) -> decoder input [sos, y] (B, U+1), target [y, eos] with 0
    past the end (B, U+1), and the output lengths text_lengths + 1."""
    b, u = text.shape
    ys_in = torch.cat([torch.full((b, 1), sos, dtype=text.dtype,
                                  device=text.device), text], dim=1)
    ys_out = torch.cat([text, torch.zeros((b, 1), dtype=text.dtype,
                                          device=text.device)], dim=1)
    pos = torch.arange(u + 1, device=text.device)[None, :]
    ys_out = torch.where(pos == text_lengths[:, None], eos, ys_out)
    ys_out = torch.where(pos > text_lengths[:, None], 0, ys_out)
    return ys_in, ys_out, text_lengths + 1


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from `generator`, in place: Xavier-uniform
    weights, N(0, 1) embeddings, zero biases and position biases, unit
    LayerNorm scales (the JAX package's initialisers, drawn from torch);
    a module with an `init_random_` of its own (the S4 layer, the sinc
    filters, the S3PRL featurizer's layer weights, Whisper's position
    tables, HuBERT's mask embedding) fills its own parameters itself."""
    own = set()
    for mod_name, mod in model.named_modules():
        if hasattr(mod, "init_random_"):
            mod.init_random_(generator)
            own.update(f"{mod_name}.{n}" if mod_name else n for n, _ in
                       mod.named_parameters(recurse=False))
    for name, prm in model.named_parameters():
        if name in own:
            continue
        owner = name.split(".")[-2]
        if name.endswith((".bias", "pos_bias_u", "pos_bias_v")):
            prm.zero_()
        elif "norm" in owner or (prm.ndim == 1
                                  and name.endswith(".weight")):
            prm.fill_(1.0)  # LayerNorm, BatchNorm and GroupNorm scales
        elif owner == "embed":
            prm.copy_(torch.randn(prm.shape, generator=generator))
        else:
            receptive = prm[0, 0].numel() if prm.ndim > 2 else 1
            fan_in, fan_out = prm.shape[1] * receptive, prm.shape[0] * receptive
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            prm.copy_((torch.rand(prm.shape, generator=generator) * 2 - 1)
                      * bound)
    return model
