"""The named full-size configurations of the port, one home for
`chip_smoke.py` and `profile_train.py`.

    bench_config(torch.bfloat16, "e_branchformer")

gives the `ASRConfig` of bench.py's model (raw input, SpecAug, utterance
MVN, 12 x 256 encoder, 6 x 2048 decoder, CTC weight 0.3, label smoothing
0.1, dropout 0.1, vocab 5000) with the encoder of the named configuration
(`ENCODERS`); keyword overrides replace any field after that.
"""

from __future__ import annotations

from espnet_tpu_torch.models.asr import ASRConfig

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
}


def bench_config(dtype, name: str = "conformer", **overrides) -> ASRConfig:
    """bench.py's model with the encoder of configuration `name`."""
    if name not in ENCODERS:
        raise ValueError(f"unknown configuration {name!r}; one of "
                         f"{sorted(ENCODERS)}")
    fields = {**BENCH, **ENCODERS[name], "dtype": dtype, **overrides}
    return ASRConfig(**fields)
