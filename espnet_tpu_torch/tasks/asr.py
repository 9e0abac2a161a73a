"""ASR task: data dirs -> tokenizer/token-list -> collect-stats -> train
(port of espnet_tpu/tasks/asr.py).

The sections, their fields and defaults are the JAX package's, so a command
line or a config.yaml means the same run in both. `ASRModelSection` carries
every field of the JAX `ASRConfig`; `build_model` maps it onto the port's
`ASRConfig` (`dtype` "float32" or "bfloat16" becomes the torch dtype only
there). The sections `ssl`, `whisper` (the SSL trunk's and Whisper's
geometry, `models/ssl.py`) and the plugin sections `encoder_conf` and
`decoder_conf` are dicts in a config.yaml; given on the command line
(`--model.ssl '{hidden_size: 768}'`) the string is read as a YAML flow
map. `ssl_freeze` stops the gradient into the SSL trunk. `frontend_
precision`, the TPU's matmul precision for the frontend, is inert (the
port's frontend runs its matmuls in float32), and so is `remat_encoder`
for the branchformers, as in JAX.

Global MVN needs statistics of the features that the model normalises.
For the Whisper encoder the collect-stats pass takes Whisper's own log-mel
(`whisper_log_mel`, Whisper's n_mels wide), where the JAX pass takes the
ASR's log-mel at its n_fft and hop; with `input_type ssl` there are no
features to take them of before the trunk's weights arrive (the JAX pass
fails on the raw waveforms), so `run` refuses to collect them and names
the remedy (`--model.normalize utterance_mvn` or none, or
`--run.collect_stats false`). ROADMAP.md queue 3 has both.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from espnet_tpu_torch.data.dataset import (ASRDataset, EpochIterator,
                                           process_topology)
from espnet_tpu_torch.data.sampler import build_batches
from espnet_tpu_torch.data.tokenizer import (TokenIDConverter,
                                             build_token_list,
                                             build_tokenizer)
from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel
from espnet_tpu_torch.tasks.abs_task import AbsTask, OptimConfig, RunConfig
from espnet_tpu_torch.train.collect_stats import (collect_stats, load_stats,
                                                  mvn_variables)
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.train.trainer import Trainer, TrainerOptions

logger = logging.getLogger("espnet_tpu")


@dataclasses.dataclass(frozen=True)
class ASRDataConfig:
    train_dir: str = ""
    valid_dir: str = ""
    fs: int = 16000
    input_type: str = "raw"            # raw (wav.scp) | feats (feats.scp)
    token_type: str = "char"           # char | word | bpe
    token_list: str = ""               # path; built from train text if missing
    bpe_model: str = ""
    bpe_vocab_size: int = 300
    batch_bins: int = 0
    batch_size: int = 16
    length_quantum: int = 4096
    text_quantum: int = 8
    # 0 = auto: one shard per process of the torch.distributed group
    num_shards: int = 0
    shard_index: int = -1
    # batches sized to a multiple of this (0 = 1)
    size_multiple: int = 0
    # keep (N, C) multichannel wavs
    multichannel: bool = False
    # on-access augmentation (train split only)
    rir_scp: str = ""
    rir_apply_prob: float = 1.0
    noise_scp: str = ""
    noise_apply_prob: float = 1.0
    noise_db_range: str = "13_15"
    # rescale waveform peak to this value (applies to valid/decode too)
    speech_volume_normalize: float = 0.0
    # YAML transform pipeline applied to loaded speech on access
    preprocess_conf: str = ""


@dataclasses.dataclass(frozen=True)
class ASRModelSection:
    """Every field of the JAX `ASRConfig`, with its default, plus
    `vocab_size` (injected from the token list at build)."""

    vocab_size: int = -1
    input_type: str = "raw"
    sinc_out_dim: int = 256
    fused_n_fft2: int = 0
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
    frontend_precision: str = "high"
    use_specaug: bool = True
    num_freq_masks: int = 2
    freq_mask_width: Tuple[int, int] = (0, 20)
    num_time_masks: int = 2
    time_mask_width: Tuple[int, int] = (0, 40)
    normalize: str = "global_mvn"
    encoder_type: str = "conformer"
    attention_window: int = 100
    block_size: int = 40
    stream_hop_size: int = 16
    look_ahead: int = 16
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 2048
    num_encoder_layers: int = 12
    subsampling_factor: int = 4
    remat_encoder: bool = False
    scan_encoder_layers: bool = False
    conformer_kernel_size: int = 31
    ssl: Any = None
    whisper: Any = None
    ssl_freeze: bool = True
    decoder_type: str = "transformer"
    num_decoder_layers: int = 6
    decoder_d_ff: int = 2048
    rnn_att_type: str = "location"
    sampling_probability: float = 0.0
    encoder_conf: Any = None
    decoder_conf: Any = None
    ctc_weight: float = 0.3
    interctc_layer_idx: Tuple[int, ...] = ()
    interctc_weight: float = 0.0
    lsm_weight: float = 0.1
    dropout_rate: float = 0.1
    dtype: str = "float32"  # "float32" | "bfloat16"


# sections given as YAML flow maps on the command line
MAP_SECTIONS = ("ssl", "whisper", "encoder_conf", "decoder_conf")
DTYPES = ("float32", "bfloat16")


def torch_dtype(name):
    """A model section's named `dtype` ("float32" | "bfloat16", or a
    dtype's repr) as the torch dtype."""
    import torch

    dtype = str(name).split(".")[-1]
    if dtype not in DTYPES:
        raise ValueError(f"--model.dtype {name!r} not in {DTYPES}")
    return getattr(torch, dtype)


def model_kwargs(section, config_cls) -> Dict[str, Any]:
    """The fields of the model configuration `config_cls` but vocab_size
    and dtype, read from a model section (YAML lists as tuples)."""
    kw = {}
    for f in dataclasses.fields(config_cls):
        if f.name not in ("vocab_size", "dtype"):
            value = getattr(section, f.name)
            kw[f.name] = tuple(value) if isinstance(value, list) else value
    return kw


class ASRTask(AbsTask):
    name = "asr"
    sections = {
        "run": RunConfig,
        "optim": OptimConfig,
        "data": ASRDataConfig,
        "model": ASRModelSection,
    }

    # --- builders --------------------------------------------------------
    @classmethod
    def build_tokenizer(cls, data: ASRDataConfig, output_dir: Path,
                        texts=None):
        if data.token_type == "bpe":
            model_path = data.bpe_model or str(output_dir / "bpe.json")
            if not Path(model_path).exists():
                if texts is None:
                    raise FileNotFoundError(f"bpe model missing: {model_path}")
                from espnet_tpu_torch.data.tokenizer import BpeTokenizer

                logger.info("training BPE model -> %s", model_path)
                BpeTokenizer.train(texts, data.bpe_vocab_size, model_path)
            return build_tokenizer("bpe", model_path)
        return build_tokenizer(data.token_type)

    @classmethod
    def build_token_list(cls, data, output_dir: Path, tokenizer, texts=None):
        path = (Path(data.token_list) if data.token_list
                else output_dir / "tokens.txt")
        if path.exists():
            return TokenIDConverter.from_file(path)
        if texts is None:
            raise FileNotFoundError(f"token list missing: {path}")
        conv = TokenIDConverter(build_token_list(texts, tokenizer))
        conv.save(path)
        logger.info("built token list (%d) -> %s", len(conv), path)
        return conv

    @classmethod
    def build_dataset(cls, data: ASRDataConfig, datadir, tokenizer,
                      converter, train: bool = True):
        dd = Path(datadir)
        kw = dict(text=dd / "text", tokenizer=tokenizer, converter=converter,
                  fs=data.fs)
        if data.preprocess_conf:
            from espnet_tpu_torch.data.transform import Transformation

            kw["transform"] = Transformation(data.preprocess_conf)
            kw["transform_train"] = train
        if data.input_type == "raw":
            pre = None
            if (data.rir_scp or data.noise_scp
                    or data.speech_volume_normalize):
                from espnet_tpu_torch.data.preprocess import (
                    SpeechPreprocessor)

                pre = SpeechPreprocessor(
                    rir_scp=data.rir_scp or None,
                    rir_apply_prob=data.rir_apply_prob,
                    noise_scp=data.noise_scp or None,
                    noise_apply_prob=data.noise_apply_prob,
                    noise_db_range=data.noise_db_range,
                    speech_volume_normalize=(
                        data.speech_volume_normalize or None),
                    train=train,
                )
            return ASRDataset(wav_scp=dd / "wav.scp",
                              multichannel=data.multichannel,
                              preprocessor=pre, **kw)
        return ASRDataset(feats_scp=dd / "feats.scp", **kw)

    @classmethod
    def build_model(cls, model_cfg: ASRModelSection,
                    vocab_size: int) -> ASRModel:
        kw = model_kwargs(model_cfg, ASRConfig)
        for name in MAP_SECTIONS:
            if isinstance(kw[name], str):
                from espnet_tpu_torch.utils.config import loads_yaml

                kw[name] = loads_yaml(kw[name])
        return ASRModel(ASRConfig(vocab_size=vocab_size,
                                  dtype=torch_dtype(model_cfg.dtype), **kw))

    # --- run -------------------------------------------------------------
    @classmethod
    def run(cls, cfg: Dict[str, Any], device="cuda"):
        dev = resolve_device(device)
        run: RunConfig = cfg["run"]
        data: ASRDataConfig = cfg["data"]
        out = Path(run.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        cls.dump_config(cfg, out)

        from espnet_tpu_torch.data.fileio import read_2column_text

        train_texts = list(
            read_2column_text(Path(data.train_dir) / "text").values())
        tokenizer = cls.build_tokenizer(data, out, train_texts)
        converter = cls.build_token_list(data, out, tokenizer, train_texts)
        train_ds = cls.build_dataset(data, data.train_dir, tokenizer,
                                     converter)
        valid_ds = (
            cls.build_dataset(data, data.valid_dir, tokenizer, converter,
                              train=False)
            if data.valid_dir else None
        )

        # each process of a torch.distributed group takes every
        # num_shards-th batch
        world, rank = process_topology()
        num_shards = data.num_shards or world
        shard_index = data.shard_index if data.shard_index >= 0 else rank
        size_multiple = data.size_multiple or 1

        def make_batches(ds):
            shapes = {"speech": ds.speech_lengths(),
                      "text": ds.text_lengths()}
            return build_batches(
                shapes,
                batch_bins=data.batch_bins,
                batch_size=0 if data.batch_bins else data.batch_size,
                length_quantum=data.length_quantum,
                text_quantum=data.text_quantum,
                size_multiple=size_multiple,
            )

        train_batches = make_batches(train_ds)
        train_iter = EpochIterator(
            train_ds, train_batches, seed=run.seed,
            num_shards=num_shards, shard_index=shard_index,
        )
        valid_iter = (
            EpochIterator(valid_ds, make_batches(valid_ds), seed=run.seed,
                          shuffle=False, num_shards=num_shards,
                          shard_index=shard_index)
            if valid_ds else None
        )

        model = cls.build_model(cfg["model"], len(converter))

        # collect-stats stage (global MVN)
        extra_init = None
        mc = model.config
        if mc.normalize == "global_mvn" and run.collect_stats:
            if mc.input_type == "ssl":
                raise ValueError(
                    "--model.input_type ssl normalises the SSL trunk's "
                    "features, which exist only once its weights are "
                    "loaded: collect-stats cannot take their global MVN "
                    "statistics (the JAX pass fails on the raw waveforms). "
                    "Use --model.normalize utterance_mvn (or none), or "
                    "--run.collect_stats false for identity statistics")
            stats_path = out / "stats" / "feats_stats.npz"
            if not stats_path.exists():
                logger.info("collect_stats -> %s", stats_path.parent)
                collect_stats(
                    train_ds, train_batches, stats_path.parent,
                    fs=data.fs, n_fft=model.config.n_fft,
                    hop_length=model.config.hop_length,
                    n_mels=model.config.n_mels,
                    input_type=model.config.input_type, device=dev,
                    whisper_mels=(mc.whisper.n_mels
                                  if mc.encoder_type == "whisper" else 0),
                )
            # the transducer has no global-MVN buffers: as in JAX it gets
            # the stats collected and never reads them
            if hasattr(model, "mvn"):
                extra_init = {"mvn": mvn_variables(load_stats(stats_path))}
        if run.stats_only:
            logger.info("stats_only: stopping after collect-stats stage")
            return None

        opt: OptimConfig = cfg["optim"]
        tx = build_optimizer(
            opt.name, opt.lr, opt.schedule, opt.warmup_steps,
            model.config.d_model, opt.weight_decay,
            (opt.b1, opt.b2), opt.eps, opt.grad_clip,
        )
        phase, key, mode = run.best_metric.split(".")
        trainer = Trainer(
            model, tx, out,
            options=TrainerOptions(
                max_epoch=run.max_epoch,
                patience=run.patience,
                keep_nbest=run.keep_nbest,
                best_metric=(phase, key, mode),
                log_interval=run.log_interval,
                seed=run.seed,
                resume=run.resume,
                accum_grad=run.accum_grad,
                init_param=tuple(
                    s for s in run.init_param.split(",,") if s
                ),
                plot_attention=run.plot_attention,
                use_wandb=run.use_wandb,
                wandb_project=run.wandb_project,
                profile_steps=run.profile_steps,
            ),
            device=dev,
        )
        state = trainer.init_state(extra_init)
        state = trainer.run(state, train_iter, valid_iter)
        logger.info("training finished: %s", out)
        return state, trainer, model, tokenizer, converter
