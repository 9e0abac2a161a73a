"""TTS task (port of espnet_tpu/tasks/tts.py).

Behavioral spec: reference `espnet2/tasks/tts.py` and the recipe
`egs2/TEMPLATE/tts1/tts.sh` (token list, stats, train). Text and raw wavs
in a data dir; the mel targets are computed on the device by the model.
FastSpeech2 and ProDiff read a `durations` file in the data dir ("<uid>
d1 d2 ..." frames per token, written by `bin/tts_teacher_durations` from
a trained Tacotron2); their pitch and energy targets are zeros, as in JAX
(the batches carry no such fields). The sections, fields and defaults are
the JAX task's, the model section's nested configurations with `dtype`
named ("float32" | "bfloat16"), so a command line or a config.yaml means
the same run in both packages (`--model.tacotron2.embed_dim 16`).

Global MVN: the collect-stats pass takes the log-mel at the model's n_fft,
hop and n_mels but the frontend's default band (fmin 0, no fmax), where
the model's features use fmin 80 and fmax 7600: the JAX task does the
same, and the port copies it (ROADMAP.md queue 3).
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from espnet_tpu_torch.data.dataset import ASRDataset, EpochIterator
from espnet_tpu_torch.data.fileio import read_2column_text
from espnet_tpu_torch.data.sampler import build_batches
from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.models.tts.fastspeech2 import FastSpeech2Config
from espnet_tpu_torch.models.tts.model import TTSModel, TTSTaskConfig
from espnet_tpu_torch.models.tts.prodiff import ProDiffConfig
from espnet_tpu_torch.models.tts.tacotron2 import Tacotron2Config
from espnet_tpu_torch.models.tts.transformer_tts import TransformerTTSConfig
from espnet_tpu_torch.tasks.abs_task import AbsTask, OptimConfig, RunConfig
from espnet_tpu_torch.tasks.asr import ASRTask, torch_dtype
from espnet_tpu_torch.train.collect_stats import (collect_stats, load_stats,
                                                  mvn_variables)
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.train.trainer import Trainer, TrainerOptions

logger = logging.getLogger("espnet_tpu")

TTS_BATCH_KEYS = ("text", "text_lengths", "speech", "speech_lengths")


@dataclasses.dataclass(frozen=True)
class TTSDataConfig:
    train_dir: str = ""
    valid_dir: str = ""
    fs: int = 16000
    token_type: str = "char"
    token_list: str = ""
    bpe_model: str = ""
    batch_size: int = 16
    length_quantum: int = 8192
    text_quantum: int = 8


@dataclasses.dataclass(frozen=True)
class TTSModelSection:
    tts_type: str = "tacotron2"
    fs: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: Optional[int] = None
    n_mels: int = 80
    fmin: float = 80.0
    fmax: Optional[float] = 7600.0
    normalize: str = "global_mvn"
    tacotron2: Tacotron2Config = Tacotron2Config(dtype="float32")
    fastspeech2: FastSpeech2Config = FastSpeech2Config(dtype="float32")
    transformer: TransformerTTSConfig = TransformerTTSConfig(
        dtype="float32")
    prodiff: ProDiffConfig = ProDiffConfig(dtype="float32")


class TTSDatasetWithDurations(ASRDataset):
    """ASRDataset + the token-level `durations` where the data dir has
    them."""

    def __init__(self, *a, durations_path=None, **kw):
        super().__init__(*a, **kw)
        self.durations = (
            {k: np.asarray([int(x) for x in v.split()], np.int32)
             for k, v in read_2column_text(durations_path).items()}
            if durations_path and Path(durations_path).exists() else None)

    def __getitem__(self, key):
        out = super().__getitem__(key)
        if self.durations is not None:
            out["durations"] = self.durations[key]
        return out


def tokenizer_section(data: TTSDataConfig):
    """The ASR data section that builds this task's tokenizer and token
    list (the JAX task reuses ASRTask's builders)."""
    return dataclasses.replace(
        ASRTask.sections["data"](), token_type=data.token_type,
        token_list=data.token_list, bpe_model=data.bpe_model, fs=data.fs)


def batch_keys(tts_type: str):
    if tts_type in ("fastspeech2", "prodiff"):
        return TTS_BATCH_KEYS + ("durations",)
    return TTS_BATCH_KEYS


class TTSTask(AbsTask):
    name = "tts"
    sections = {
        "run": RunConfig,
        "optim": OptimConfig,
        "data": TTSDataConfig,
        "model": TTSModelSection,
    }

    @classmethod
    def task_config(cls, mc: TTSModelSection,
                    vocab_size: int) -> TTSTaskConfig:
        def fix(cfg):
            return dataclasses.replace(cfg, dtype=torch_dtype(cfg.dtype),
                                       vocab_size=vocab_size,
                                       n_mels=mc.n_mels)

        return TTSTaskConfig(
            tts_type=mc.tts_type, vocab_size=vocab_size, fs=mc.fs,
            n_fft=mc.n_fft, hop_length=mc.hop_length,
            win_length=mc.win_length, n_mels=mc.n_mels, fmin=mc.fmin,
            fmax=mc.fmax, normalize=mc.normalize,
            tacotron2=fix(mc.tacotron2), fastspeech2=fix(mc.fastspeech2),
            transformer=fix(mc.transformer), prodiff=fix(mc.prodiff))

    @classmethod
    def build_model(cls, mc: TTSModelSection, vocab_size: int) -> TTSModel:
        return TTSModel(cls.task_config(mc, vocab_size))

    @classmethod
    def make_batches(cls, ds, data: TTSDataConfig, batch_size=None):
        shapes = {"speech": ds.speech_lengths(), "text": ds.text_lengths()}
        return build_batches(shapes, batch_size=batch_size or data.batch_size,
                             length_quantum=data.length_quantum,
                             text_quantum=data.text_quantum)

    @classmethod
    def run(cls, cfg: Dict[str, Any], device="cuda"):
        dev = resolve_device(device)
        run: RunConfig = cfg["run"]
        data: TTSDataConfig = cfg["data"]
        mc: TTSModelSection = cfg["model"]
        out = Path(run.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        cls.dump_config(cfg, out)

        train_texts = list(
            read_2column_text(Path(data.train_dir) / "text").values())
        tok = tokenizer_section(data)
        tokenizer = ASRTask.build_tokenizer(tok, out, train_texts)
        converter = ASRTask.build_token_list(tok, out, tokenizer, train_texts)

        fields = ("speech", "text", "durations")

        def make_ds(datadir):
            dd = Path(datadir)
            return TTSDatasetWithDurations(
                wav_scp=dd / "wav.scp", text=dd / "text",
                tokenizer=tokenizer, converter=converter, fs=data.fs,
                durations_path=dd / "durations")

        train_ds = make_ds(data.train_dir)
        valid_ds = make_ds(data.valid_dir) if data.valid_dir else None
        train_batches = cls.make_batches(train_ds, data)
        train_iter = EpochIterator(train_ds, train_batches, seed=run.seed,
                                   fields=fields)
        valid_iter = (EpochIterator(valid_ds, cls.make_batches(valid_ds, data),
                                    seed=run.seed, shuffle=False,
                                    fields=fields)
                      if valid_ds else None)

        model = cls.build_model(mc, len(converter))
        extra_init = None
        if mc.normalize == "global_mvn":
            stats_path = out / "stats" / "feats_stats.npz"
            if not stats_path.exists():
                collect_stats(train_ds, train_batches, stats_path.parent,
                              fs=mc.fs, n_fft=mc.n_fft,
                              hop_length=mc.hop_length, n_mels=mc.n_mels,
                              device=dev)
            extra_init = {"mvn": mvn_variables(load_stats(stats_path))}

        opt: OptimConfig = cfg["optim"]
        tx = build_optimizer(opt.name, opt.lr, opt.schedule,
                             opt.warmup_steps, 256, opt.weight_decay,
                             (opt.b1, opt.b2), opt.eps, opt.grad_clip)
        phase = "valid" if valid_iter else "train"
        trainer = Trainer(
            model, tx, out,
            options=TrainerOptions(
                max_epoch=run.max_epoch, patience=run.patience,
                keep_nbest=run.keep_nbest, best_metric=(phase, "loss", "min"),
                log_interval=run.log_interval, seed=run.seed,
                resume=run.resume, plot_attention=run.plot_attention,
                use_wandb=run.use_wandb, wandb_project=run.wandb_project),
            device=dev, batch_arg_names=batch_keys(mc.tts_type))
        state = trainer.init_state(extra_init)
        state = trainer.run(state, train_iter, valid_iter)
        logger.info("tts training finished: %s", out)
        return state, trainer, model, tokenizer, converter
