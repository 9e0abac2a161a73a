"""Enhancement and separation task (port of espnet_tpu/tasks/enh.py).

Data: wav.scp is the mixture, spk<i>.scp the references (`EnhDataset`).
`EnhDataConfig` has the JAX fields and defaults: the sequence iterator
(length-bucketed batches) or the chunk iterator (fixed windows pooled
across utterances, every batch one shape; its draws are the JAX
iterator's `RandomState` ones). `EnhTask` trains `EnhancementModel` on the
batch fields (speech_mix, speech_mix_lengths, speech_ref) and ranks epochs
by `run.best_metric`, as JAX does.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict

from espnet_tpu_torch.data.dataset import (ChunkIterator, EnhDataset,
                                           EpochIterator)
from espnet_tpu_torch.data.sampler import build_batches
from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.models.enh import EnhancementModel, EnhConfig
from espnet_tpu_torch.tasks.abs_task import AbsTask, OptimConfig, RunConfig
from espnet_tpu_torch.tasks.asr import torch_dtype
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.train.trainer import Trainer, TrainerOptions

logger = logging.getLogger("espnet_tpu")

ENH_BATCH_KEYS = ("speech_mix", "speech_mix_lengths", "speech_ref")


@dataclasses.dataclass(frozen=True)
class EnhDataConfig:
    train_dir: str = ""
    valid_dir: str = ""
    fs: int = 16000
    batch_bins: int = 0
    batch_size: int = 8
    length_quantum: int = 4096
    num_shards: int = 1
    shard_index: int = 0
    # sequence | chunk (fixed windows pooled across utterances)
    iterator_type: str = "sequence"
    chunk_length: int = 32000
    chunk_shift_ratio: float = 0.5


def make_batches(ds: EnhDataset, data: EnhDataConfig, batch_size=None):
    """Length-bucketed batches of the mixtures, as the JAX task makes."""
    return build_batches(
        {"speech_mix": ds.speech_lengths()},
        batch_bins=data.batch_bins if batch_size is None else 0,
        batch_size=(batch_size if batch_size is not None
                     else 0 if data.batch_bins else data.batch_size),
        length_quantum=data.length_quantum, input_field="speech_mix")


class EnhTask(AbsTask):
    name = "enh"
    sections = {
        "run": RunConfig,
        "optim": OptimConfig,
        "data": EnhDataConfig,
        "model": EnhConfig,
    }

    @classmethod
    def build_model(cls, model_cfg: EnhConfig) -> EnhancementModel:
        """The model of the section; its `dtype` must name float32 or
        bfloat16."""
        return EnhancementModel(dataclasses.replace(
            model_cfg, dtype=torch_dtype(model_cfg.dtype)))

    @classmethod
    def train_iterator(cls, ds: EnhDataset, data: EnhDataConfig, seed: int):
        fields = ("speech_mix", "speech_ref")
        if data.iterator_type == "chunk":
            return ChunkIterator(
                ds, ds.keys(), data.chunk_length, data.batch_size,
                data.chunk_shift_ratio, seed=seed, fields=fields,
                num_shards=data.num_shards, shard_index=data.shard_index)
        if data.iterator_type == "sequence":
            return EpochIterator(
                ds, make_batches(ds, data), seed=seed,
                num_shards=data.num_shards, shard_index=data.shard_index,
                fields=fields)
        raise ValueError(f"unknown iterator_type {data.iterator_type!r} "
                         "(sequence | chunk)")

    @classmethod
    def run(cls, cfg: Dict[str, Any], device="cuda"):
        dev = resolve_device(device)
        run: RunConfig = cfg["run"]
        data: EnhDataConfig = cfg["data"]
        model_cfg: EnhConfig = cfg["model"]
        out = Path(run.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        cls.dump_config(cfg, out)

        train_ds = EnhDataset(data.train_dir, model_cfg.num_spk, data.fs)
        valid_ds = (EnhDataset(data.valid_dir, model_cfg.num_spk, data.fs)
                    if data.valid_dir else None)
        train_iter = cls.train_iterator(train_ds, data, run.seed)
        valid_iter = (
            EpochIterator(valid_ds, make_batches(valid_ds, data),
                          seed=run.seed, shuffle=False,
                          num_shards=data.num_shards,
                          shard_index=data.shard_index,
                          fields=("speech_mix", "speech_ref"))
            if valid_ds else None)

        model = cls.build_model(model_cfg)
        opt: OptimConfig = cfg["optim"]
        tx = build_optimizer(opt.name, opt.lr, opt.schedule,
                             opt.warmup_steps, 256, opt.weight_decay,
                             (opt.b1, opt.b2), opt.eps, opt.grad_clip)
        phase, key, mode = run.best_metric.split(".")
        trainer = Trainer(
            model, tx, out,
            options=TrainerOptions(
                max_epoch=run.max_epoch, patience=run.patience,
                keep_nbest=run.keep_nbest, best_metric=(phase, key, mode),
                log_interval=run.log_interval, seed=run.seed,
                resume=run.resume),
            device=dev, batch_arg_names=ENH_BATCH_KEYS)
        state = trainer.init_state()
        state = trainer.run(state, train_iter, valid_iter)
        logger.info("training finished: %s", out)
        return state, trainer, model
