"""Multi-encoder ASR task (port of espnet_tpu/tasks/asr_mulenc.py).

One waveform per encoder stream (`wav_enc<i>.scp`) and one transcript
(`text`) a data dir (`data/dataset.py` `ASRMulEncDataset`); the batches
carry the streams as (B, N, E) with their lengths (B, E) in
`speech_stream_lengths`, which the model takes in place of
`speech_lengths`. The sections, fields and defaults are the JAX task's; the
trainer gets the options that the JAX task passes it.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict

from espnet_tpu_torch.data.dataset import ASRMulEncDataset, EpochIterator
from espnet_tpu_torch.data.fileio import read_2column_text
from espnet_tpu_torch.data.sampler import build_batches
from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.models.mulenc import ASRMulEncModel, MulEncConfig
from espnet_tpu_torch.tasks.abs_task import AbsTask, OptimConfig, RunConfig
from espnet_tpu_torch.tasks.asr import ASRTask, model_kwargs, torch_dtype
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.train.trainer import Trainer, TrainerOptions

logger = logging.getLogger("espnet_tpu")

MULENC_BATCH_KEYS = ("speech", "speech_stream_lengths", "text",
                     "text_lengths")


@dataclasses.dataclass(frozen=True)
class MulEncModelSection(MulEncConfig):
    """Every field of the JAX `MulEncConfig`, with its default;
    `vocab_size` is injected from the token list at build and `dtype` is
    named ("float32" | "bfloat16")."""

    vocab_size: int = -1
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MulEncDataConfig:
    train_dir: str = ""
    valid_dir: str = ""
    fs: int = 16000
    token_type: str = "char"
    token_list: str = ""
    bpe_model: str = ""
    batch_size: int = 8
    length_quantum: int = 4096
    text_quantum: int = 4


def token_data(data) -> Any:
    """The ASR data section that the tokenizer builders read, from a
    multi-stream or mixture data section."""
    return dataclasses.replace(
        ASRTask.sections["data"](), token_type=data.token_type,
        token_list=data.token_list, bpe_model=data.bpe_model, fs=data.fs)


def run_multi_task(task, cfg, device, make_ds, fields, batch_keys,
                   train_texts):
    """The shared body of the multi-stream and mixture tasks' runs: token
    list, datasets, batches of the dataset's `fields`, model, optimizer,
    trainer on `batch_keys`; returns (state, trainer, model, tokenizer,
    converter)."""
    dev = resolve_device(device)
    run: RunConfig = cfg["run"]
    data = cfg["data"]
    mc = cfg["model"]
    out = Path(run.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    task.dump_config(cfg, out)
    tok_data = token_data(data)
    tokenizer = ASRTask.build_tokenizer(tok_data, out, train_texts)
    converter = ASRTask.build_token_list(tok_data, out, tokenizer,
                                         train_texts)
    train_ds = make_ds(data.train_dir, tokenizer, converter)
    valid_ds = (make_ds(data.valid_dir, tokenizer, converter)
                if data.valid_dir else None)

    def batches(ds):
        return build_batches(
            {"speech": ds.speech_lengths(), "text": ds.text_lengths()},
            batch_size=data.batch_size, length_quantum=data.length_quantum,
            text_quantum=data.text_quantum)

    train_iter = EpochIterator(train_ds, batches(train_ds), seed=run.seed,
                               fields=fields)
    valid_iter = (EpochIterator(valid_ds, batches(valid_ds), seed=run.seed,
                                shuffle=False, fields=fields)
                  if valid_ds else None)
    model = task.build_model(mc, len(converter))
    opt: OptimConfig = cfg["optim"]
    tx = build_optimizer(
        opt.name, opt.lr, opt.schedule, opt.warmup_steps, mc.d_model,
        opt.weight_decay, (opt.b1, opt.b2), opt.eps, opt.grad_clip)
    phase, key, mode = run.best_metric.split(".")
    trainer = Trainer(
        model, tx, out,
        options=TrainerOptions(
            max_epoch=run.max_epoch, patience=run.patience,
            keep_nbest=run.keep_nbest, best_metric=(phase, key, mode),
            log_interval=run.log_interval, seed=run.seed, resume=run.resume),
        device=dev, batch_arg_names=batch_keys)
    state = trainer.init_state()
    state = trainer.run(state, train_iter, valid_iter)
    logger.info("%s training finished: %s", task.name, out)
    return state, trainer, model, tokenizer, converter


class ASRMulEncTask(AbsTask):
    name = "asr_mulenc"
    sections = {
        "run": RunConfig,
        "optim": OptimConfig,
        "data": MulEncDataConfig,
        "model": MulEncModelSection,
    }

    @classmethod
    def build_model(cls, mc: MulEncModelSection,
                    vocab_size: int) -> ASRMulEncModel:
        return ASRMulEncModel(MulEncConfig(
            vocab_size=vocab_size, dtype=torch_dtype(mc.dtype),
            **model_kwargs(mc, MulEncConfig)))

    @classmethod
    def run(cls, cfg: Dict[str, Any], device="cuda"):
        data: MulEncDataConfig = cfg["data"]
        n_enc = cfg["model"].num_encoders
        train_texts = list(
            read_2column_text(Path(data.train_dir) / "text").values())

        def make_ds(datadir, tokenizer, converter):
            return ASRMulEncDataset(datadir, tokenizer, converter, n_enc,
                                    data.fs)

        return run_multi_task(
            cls, cfg, device, make_ds,
            ("speech", "speech_stream_lengths", "text"), MULENC_BATCH_KEYS,
            train_texts)
