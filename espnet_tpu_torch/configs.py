"""The named full-size configurations of the port, one home for
`chip_smoke.py` and `profile_train.py`.

    bench_config(torch.bfloat16, "e_branchformer")

gives the `ASRConfig` of bench.py's model (raw input, SpecAug, utterance
MVN, 12 x 256 encoder, 6 x 2048 decoder, CTC weight 0.3, label smoothing
0.1, dropout 0.1, vocab 5000) with the encoder of the named configuration
(`ENCODERS`); keyword overrides replace any field after that.
`encoder_options(name)` gives the configuration's encoder options (the
`encoder_options` of `ASRModel`): the conformer's conv routes, which the
JAX `ASRConfig` has no field for.

    transducer_conformer(torch.bfloat16)

gives the `TransducerConfig` of the conformer RNN-T: the JAX
`TransducerConfig` defaults (raw 16 kHz input, n_fft 512, hop 128, 80 mels,
SpecAug, utterance MVN; a 12 x 256 conformer, 4 heads, FFN 2048, kernel 31,
subsampling 4; a 1-layer 256 LSTM prediction network on 256-wide
embeddings; a joint of width 320; dropout 0.1; no aux CTC) with bench.py's
vocab of 5000: the widths of ESPnet's conformer-RNN-T recipes for
LibriSpeech-100. 37,088,264 parameters.

    longformer_conformer(torch.bfloat16)

gives bench.py's model with the longformer encoder (12 x 256, 4 heads, FFN
2048, conv kernel 31, attention window 100: the JAX `ASRConfig` defaults),
46,043,920 parameters;

    vgg_blstm_rnn(torch.bfloat16)

the v1 VGG-BLSTMP + AttLoc model: a 4-layer VGG-BLSTM encoder of 320 units
and projections (the JAX model ties both to d_model), a 1-layer RNN decoder
of 320 units with location attention (320 dims, 10 conv channels, 100
filters: the JAX `RNNDecoder` defaults, ESPnet v1's), CTC weight 0.3,
vocab 5000, utterance MVN; 16,312,578 parameters. `FAMILIES` adds the S4
decoder, the sinc frontend and the multichannel frontend (with and
without WPE) to bench.py's conformer, as overrides of `bench_config`.

    maskctc_conformer(torch.bfloat16)

gives the `MaskCTCConfig` of Mask-CTC: the `ASRConfig` defaults that it
inherits, which are bench.py's 12 x 256 conformer (4 heads, FFN 2048,
kernel 31) with a 6 x 2048 MLM decoder over vocab 5000 + <mask>, utterance
MVN as the other configurations;

    mulenc_transformer(torch.bfloat16)

the `MulEncConfig` defaults: two streams of 4 x 256 transformer encoders
(4 heads, FFN 1024), a 4 x 1024 HAN decoder, CTC weight 0.3;

    asr_mix_conformer(torch.bfloat16)

the `ASRMixConfig` defaults: two speakers, 4 shared + 2 x 4 branch conformer
blocks (d 256, 4 heads, FFN 1024, kernel 15), a 4 x 1024 decoder, CTC
weight 0.5; and

    transformer_lm()

the `LMModelConfig` defaults, a 6 x 256 transformer LM with FFN 1024, built
over `LM_VOCAB` tokens by `tasks.lm.LMTask.build_model` (which takes the
compute dtype);

    mt_transformer(torch.bfloat16)

the `MTConfig` defaults: a 6 x 256 token encoder (4 heads, FFN 2048) and a
6 x 2048 decoder, source and target vocab 5000; 21,208,968 parameters;

    st_conformer(torch.bfloat16)

the `STConfig` defaults on bench.py's conformer (12 x 256, 4 heads, FFN
2048, kernel 31, a 6 x 2048 translation decoder, utterance MVN as the other
configurations), `asr_weight` 0.3 and `mtlalpha` 1.0 (so a CTC head over
the source vocabulary and no ASR decoder), source and target vocab 5000;
46,836,496 parameters.

    ssl_conformer(torch.bfloat16), wav2vec2_ctc(...), whisper_base(...)

the SSL and Whisper parts of the ASR model (`models/ssl.py`), at the
published geometry of the JAX `SSLConfig` / `WhisperConfig` defaults:
`ssl_conformer` is ESPnet's S3PRL-frontend recipe, a frozen wav2vec2-base
/ HuBERT-base trunk (768 wide, 12 layers, 12 heads, FFN 3072, conv 512 x
7) through the softmax layer mix into bench.py's model (SpecAug, utterance
MVN, 12 x 256 conformer, 6 x 2048 decoder, CTC 0.3, vocab 5000);
`wav2vec2_ctc` fine-tunes that trunk as the encoder (`output_layer` to 256,
CTC 0.3, the 6-layer decoder); `whisper_base` is whisper-base's encoder
and decoder (d 512, 6 + 6 layers, 8 heads, FFN 2048, 80 mels, vocab 51865,
no normalisation, CTC weight 0 as ESPnet's Whisper fine-tuning configs);

    hubert_pretrain(torch.bfloat16)

the JAX `HubertConfig` defaults (a 6 x 256 transformer, 4 heads, FFN 1024,
100 k-means classes, log-mel at hop 128). All use random weights from a
seed; all but `whisper_base` vocab 5000.
"""

from __future__ import annotations

from espnet_tpu_torch.models.asr import ASRConfig
from espnet_tpu_torch.models.asr_mix import ASRMixConfig
from espnet_tpu_torch.models.hubert import HubertConfig
from espnet_tpu_torch.models.maskctc import MaskCTCConfig
from espnet_tpu_torch.models.mt import MTConfig
from espnet_tpu_torch.models.mulenc import MulEncConfig
from espnet_tpu_torch.models.ssl import SSLConfig, WhisperConfig
from espnet_tpu_torch.models.st import STConfig
from espnet_tpu_torch.models.transducer import TransducerConfig
from espnet_tpu_torch.tasks.lm import LMModelConfig

BENCH = dict(
    vocab_size=5000, n_mels=80, d_model=256, num_heads=4, d_ff=2048,
    num_encoder_layers=12, num_decoder_layers=6, decoder_d_ff=2048,
    conformer_kernel_size=31, subsampling_factor=4, ctc_weight=0.3,
    lsm_weight=0.1, dropout_rate=0.1, use_specaug=True,
    normalize="utterance_mvn")

ENCODERS = {
    # bench.py's conformer: 12 x 256, 4 heads, FFN 2048, conv kernel 31
    "conformer": {"encoder_type": "conformer"},
    # ESPnet egs2/aishell/asr1/conf/train_asr_transformer.yaml widths:
    # 12 x 256, 4 heads, FFN 2048
    "transformer": {"encoder_type": "transformer"},
    # ESPnet egs2/librispeech_100 E-Branchformer (e12, size 256, mlp 1024,
    # linear 1024): 12 x 256, 4 heads, d_ff = cgMLP units 1024, cgMLP
    # kernel 31. The merge conv's kernel is 3, the JAX package's (its
    # ASRConfig has no field for it): a departure from the recipe, which
    # sets merge_conv_kernel 31.
    "e_branchformer": {"encoder_type": "e_branchformer", "d_ff": 1024},
    # bench.py's conformer with its conv sub-block through the head and tail
    # kernels (JAX: fused_conv_split) or the whole-module kernel (fused_conv)
    "conformer_conv_split": {"encoder_type": "conformer"},
    "conformer_conv_module": {"encoder_type": "conformer"},
    # the bench conformer's widths as ESPnet's streaming encoder
    # (contextual_block_conformer: block 40, hop 16, look-ahead 16, its
    # defaults and the JAX ASRConfig's), with global MVN: the streaming
    # engines refuse utterance MVN, which needs the whole utterance
    "streaming_conformer": {
        "encoder_type": "contextual_block_conformer", "block_size": 40,
        "stream_hop_size": 16, "look_ahead": 16, "normalize": "global_mvn"},
}
OPTIONS = {
    "conformer_conv_split": {"fused_conv_split": True},
    "conformer_conv_module": {"fused_conv": True},
}


def bench_config(dtype, name: str = "conformer", **overrides) -> ASRConfig:
    """bench.py's model with the encoder of configuration `name`."""
    if name not in ENCODERS:
        raise ValueError(f"unknown configuration {name!r}; one of "
                         f"{sorted(ENCODERS)}")
    fields = {**BENCH, **ENCODERS[name], "dtype": dtype, **overrides}
    return ASRConfig(**fields)


def encoder_options(name: str) -> dict:
    """The encoder options of configuration `name` (empty for most)."""
    if name not in ENCODERS:
        raise ValueError(f"unknown configuration {name!r}; one of "
                         f"{sorted(ENCODERS)}")
    return dict(OPTIONS.get(name, {}))


def transducer_conformer(dtype, **overrides) -> TransducerConfig:
    """The conformer RNN-T at full width (the JAX defaults, vocab 5000)."""
    fields = {"vocab_size": BENCH["vocab_size"], "dtype": dtype,
              **overrides}
    return TransducerConfig(**fields)


def longformer_conformer(dtype, **overrides) -> ASRConfig:
    """bench.py's model with the longformer encoder (window 100)."""
    return bench_config(dtype, "conformer", **{
        "encoder_type": "longformer", "attention_window": 100, **overrides})


VGG_BLSTM_RNN = dict(
    encoder_type="vgg_blstm", d_model=320, num_encoder_layers=4,
    decoder_type="rnn", num_decoder_layers=1, rnn_att_type="location")


def vgg_blstm_rnn(dtype, **overrides) -> ASRConfig:
    """The v1 VGG-BLSTMP + AttLoc model at ESPnet v1's widths."""
    return bench_config(dtype, "conformer", **{**VGG_BLSTM_RNN, **overrides})


# the other families of the JAX ASRModel on bench.py's conformer: name ->
# bench_config overrides
FAMILIES = {
    "s4_decoder": {"decoder_type": "s4"},
    "sinc": {"input_type": "sinc", "sinc_out_dim": 256},
    "multichannel": {"num_channels": 2},
    "multichannel_wpe": {"num_channels": 2, "use_wpe": True},
}


def maskctc_conformer(dtype, **overrides) -> MaskCTCConfig:
    """Mask-CTC with the JAX `ASRConfig` defaults (bench.py's widths) and
    utterance MVN."""
    fields = {"vocab_size": BENCH["vocab_size"], "dtype": dtype,
              "normalize": "utterance_mvn", **overrides}
    return MaskCTCConfig(**fields)


def mulenc_transformer(dtype, **overrides) -> MulEncConfig:
    """The JAX `MulEncConfig` defaults with vocab 5000."""
    return MulEncConfig(**{"vocab_size": BENCH["vocab_size"], "dtype": dtype,
                           **overrides})


def asr_mix_conformer(dtype, **overrides) -> ASRMixConfig:
    """The JAX `ASRMixConfig` defaults with vocab 5000."""
    return ASRMixConfig(**{"vocab_size": BENCH["vocab_size"], "dtype": dtype,
                           **overrides})


LM_VOCAB = BENCH["vocab_size"]


def transformer_lm(**overrides) -> LMModelConfig:
    """The JAX `LMModelConfig` defaults (a 6 x 256 transformer LM, FFN
    1024)."""
    return LMModelConfig(**overrides)


def mt_transformer(dtype, **overrides) -> MTConfig:
    """The JAX `MTConfig` defaults with source and target vocab 5000."""
    return MTConfig(**{"vocab_size": BENCH["vocab_size"],
                       "src_vocab_size": BENCH["vocab_size"], "dtype": dtype,
                       **overrides})


def st_conformer(dtype, **overrides) -> STConfig:
    """The JAX `STConfig` defaults on bench.py's conformer: asr_weight 0.3,
    mtlalpha 1.0, source and target vocab 5000, utterance MVN."""
    fields = {**BENCH, "encoder_type": "conformer",
              "src_vocab_size": BENCH["vocab_size"], "asr_weight": 0.3,
              "mtlalpha": 1.0, "dtype": dtype, **overrides}
    return STConfig(**fields)


def ssl_conformer(dtype, **overrides) -> ASRConfig:
    """bench.py's model behind the frozen S3PRL frontend (wav2vec2-base /
    HuBERT-base trunk)."""
    return bench_config(dtype, "conformer", **{
        "input_type": "ssl", "ssl": SSLConfig(), "ssl_freeze": True,
        **overrides})


def wav2vec2_ctc(dtype, **overrides) -> ASRConfig:
    """The wav2vec2-base trunk fine-tuned as the encoder (output_layer to
    256), CTC 0.3 and bench.py's 6-layer decoder."""
    return bench_config(dtype, "conformer", **{
        "encoder_type": "wav2vec2", "ssl": SSLConfig(),
        "ssl_freeze": False, **overrides})


WHISPER_VOCAB = WhisperConfig().vocab_size


def whisper_base(dtype, **overrides) -> ASRConfig:
    """whisper-base's encoder and decoder over its 51865 tokens, CTC weight
    0, no normalisation (Whisper's log-mel is its own)."""
    return bench_config(dtype, "conformer", **{
        "encoder_type": "whisper", "decoder_type": "whisper",
        "whisper": WhisperConfig(), "vocab_size": WHISPER_VOCAB,
        "ctc_weight": 0.0, "normalize": "none", **overrides})


def hubert_pretrain(dtype, **overrides) -> HubertConfig:
    """The JAX `HubertConfig` defaults (6 x 256, FFN 1024, 100 classes)."""
    return HubertConfig(**{"dtype": dtype, **overrides})
