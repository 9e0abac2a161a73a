"""Machine translation task (port of espnet_tpu/tasks/mt.py).

Behavioral spec: reference `espnet2/tasks/mt.py`. A data dir holds
`src_text` and `text` (no audio); both sides are tokenized with the data
section's tokenizer into their own token lists (`tokens.txt` and
`src_tokens.txt` in the experiment directory, or the files the data
section names). Batches are sorted and padded by the source field
(`input_field="src_text"`), and the model takes the fields
`MT_BATCH_KEYS`. The sections, fields and defaults are the JAX task's, so
a command line or a config.yaml means the same run in both packages.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from espnet_tpu_torch.data.dataset import EpochIterator
from espnet_tpu_torch.data.fileio import read_2column_text
from espnet_tpu_torch.data.sampler import build_batches
from espnet_tpu_torch.data.tokenizer import (TokenIDConverter,
                                             build_token_list,
                                             build_tokenizer)
from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.models.mt import MTConfig, MTModel
from espnet_tpu_torch.tasks.abs_task import AbsTask, OptimConfig, RunConfig
from espnet_tpu_torch.tasks.asr import model_kwargs, torch_dtype
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.train.trainer import Trainer, TrainerOptions

logger = logging.getLogger("espnet_tpu")

MT_BATCH_KEYS = ("src_text", "src_text_lengths", "text", "text_lengths")


@dataclasses.dataclass(frozen=True)
class MTDataConfig:
    train_dir: str = ""
    valid_dir: str = ""
    token_type: str = "char"
    token_list: str = ""
    src_token_list: str = ""
    batch_size: int = 32
    text_quantum: int = 8
    num_shards: int = 1
    shard_index: int = 0


@dataclasses.dataclass(frozen=True)
class MTModelSection(MTConfig):
    """The JAX `MTConfig`'s fields and defaults, `dtype` named
    ("float32" | "bfloat16")."""

    dtype: str = "float32"


class MTDataset:
    """Paired src_text/text dataset (token ids on access)."""

    def __init__(self, data_dir, tokenizer, converter, src_converter):
        dd = Path(data_dir)
        self.src = read_2column_text(dd / "src_text")
        self.tgt = read_2column_text(dd / "text")
        self.tokenizer = tokenizer
        self.converter = converter
        self.src_converter = src_converter

    def keys(self) -> List[str]:
        return list(self.src)

    def __len__(self):
        return len(self.src)

    def __getitem__(self, key):
        st = self.tokenizer.text2tokens(self.src[key])
        tt = self.tokenizer.text2tokens(self.tgt[key])
        return {
            "src_text": np.asarray(self.src_converter.tokens2ids(st),
                                   np.int32),
            "text": np.asarray(self.converter.tokens2ids(tt), np.int32),
        }

    def src_lengths(self):
        return {k: len(self.tokenizer.text2tokens(v))
                for k, v in self.src.items()}

    def tgt_lengths(self):
        return {k: len(self.tokenizer.text2tokens(v))
                for k, v in self.tgt.items()}


class MTTask(AbsTask):
    name = "mt"
    sections = {
        "run": RunConfig,
        "optim": OptimConfig,
        "data": MTDataConfig,
        "model": MTModelSection,
    }

    @classmethod
    def build_model(cls, model_cfg: MTModelSection, vocab_size: int,
                    src_vocab_size: int) -> MTModel:
        kw = model_kwargs(model_cfg, MTConfig)
        kw["src_vocab_size"] = src_vocab_size
        return MTModel(MTConfig(vocab_size=vocab_size,
                                dtype=torch_dtype(model_cfg.dtype), **kw))

    @classmethod
    def make_batches(cls, ds: MTDataset, data: MTDataConfig):
        """The batches of `ds`, sorted and padded by the source side."""
        return build_batches(
            {"src_text": ds.src_lengths(), "text": ds.tgt_lengths()},
            batch_size=data.batch_size, length_quantum=data.text_quantum,
            text_quantum=data.text_quantum, input_field="src_text")

    @classmethod
    def run(cls, cfg: Dict[str, Any], device="cuda"):
        dev = resolve_device(device)
        run: RunConfig = cfg["run"]
        data: MTDataConfig = cfg["data"]
        out = Path(run.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        cls.dump_config(cfg, out)

        tdir = Path(data.train_dir)
        tgt_texts = list(read_2column_text(tdir / "text").values())
        src_texts = list(read_2column_text(tdir / "src_text").values())
        tokenizer = build_tokenizer(data.token_type)

        def get_conv(path, texts):
            if path.exists():
                return TokenIDConverter.from_file(path)
            conv = TokenIDConverter(build_token_list(texts, tokenizer))
            conv.save(path)
            return conv

        conv = get_conv(Path(data.token_list) if data.token_list
                        else out / "tokens.txt", tgt_texts)
        src_conv = get_conv(Path(data.src_token_list) if data.src_token_list
                            else out / "src_tokens.txt", src_texts)

        def build_ds(d):
            return MTDataset(d, tokenizer, conv, src_conv)

        train_ds = build_ds(data.train_dir)
        valid_ds = build_ds(data.valid_dir) if data.valid_dir else None

        fields = ("src_text", "text")
        train_iter = EpochIterator(
            train_ds, cls.make_batches(train_ds, data), seed=run.seed,
            num_shards=data.num_shards, shard_index=data.shard_index,
            fields=fields,
        )
        valid_iter = (
            EpochIterator(valid_ds, cls.make_batches(valid_ds, data),
                          seed=run.seed,
                          shuffle=False, num_shards=data.num_shards,
                          shard_index=data.shard_index, fields=fields)
            if valid_ds else None
        )

        model = cls.build_model(cfg["model"], len(conv), len(src_conv))
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
                max_epoch=run.max_epoch, patience=run.patience,
                keep_nbest=run.keep_nbest, best_metric=(phase, key, mode),
                log_interval=run.log_interval, seed=run.seed,
                resume=run.resume),
            device=dev, batch_arg_names=MT_BATCH_KEYS)
        state = trainer.init_state()
        state = trainer.run(state, train_iter, valid_iter)
        logger.info("training finished: %s", out)
        return state, trainer, model, tokenizer, conv
