"""LM task: text -> token ids -> causal LM training and perplexity (port of
espnet_tpu/tasks/lm.py).

`LMTrainModel` wraps an LM (`lm`: the JAX params live under that key) with
the sos/eos cross-entropy of ESPnet's ESPnetLanguageModel; `TextDataset`
reads a 2-column `text`; `LMTask` has the JAX sections, fields and
defaults, trains on the batch fields (text, text_lengths) and, with the
default best metric "valid.acc.max" (an LM has no accuracy), ranks epochs
by the valid loss (the train loss without a valid set), as JAX does.
`build_model` and `build_inference_lm` take a compute `dtype` (float32 by
default; the JAX task builds float32 LMs and has no field for it).
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from espnet_tpu_torch.data.fileio import read_2column_text
from espnet_tpu_torch.data.sampler import build_batches
from espnet_tpu_torch.data.tokenizer import (TokenIDConverter,
                                             build_token_list,
                                             build_tokenizer)
from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.models.asr import add_sos_eos
from espnet_tpu_torch.models.layers import KernelRouted
from espnet_tpu_torch.models.lm import RNNLM, TransformerLM, lm_loss
from espnet_tpu_torch.ops.masks import make_valid_mask
from espnet_tpu_torch.tasks.abs_task import AbsTask, OptimConfig, RunConfig
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.train.trainer import Trainer, TrainerOptions

logger = logging.getLogger("espnet_tpu")

LM_BATCH_KEYS = ("text", "text_lengths")


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    train_dir: str = ""
    valid_dir: str = ""
    token_type: str = "char"
    token_list: str = ""
    bpe_model: str = ""
    batch_size: int = 32
    text_quantum: int = 16


@dataclasses.dataclass(frozen=True)
class LMModelConfig:
    lm_type: str = "transformer"  # transformer | rnn
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 1024
    num_layers: int = 6
    dropout_rate: float = 0.1


class LMTrainModel(KernelRouted):
    """An LM with the sos/eos cross-entropy loss."""

    def __init__(self, lm: nn.Module, sos_id: int, eos_id: int):
        super().__init__()
        self.lm = lm
        self.sos_id = sos_id
        self.eos_id = eos_id

    def forward(self, text, text_lengths, generator=None):
        """(loss, stats {loss, ppl, nll_sum, ntokens})."""
        ys_in, ys_out, ys_lengths = add_sos_eos(
            text.long(), text_lengths.long(), self.sos_id, self.eos_id)
        logits = self.lm(ys_in, ys_lengths, generator)
        valid = make_valid_mask(ys_lengths, ys_in.shape[1]).float()
        return lm_loss(logits, ys_out, valid)


class TextDataset:
    """A `text` file -> token id arrays (field "text")."""

    def __init__(self, text_path, tokenizer, converter):
        self.text = read_2column_text(text_path)
        self.tokenizer = tokenizer
        self.converter = converter

    def keys(self):
        return list(self.text)

    def __len__(self):
        return len(self.text)

    def __getitem__(self, key):
        toks = self.tokenizer.text2tokens(self.text[key])
        return {"text": np.asarray(self.converter.tokens2ids(toks), np.int32)}

    def text_lengths(self):
        return {k: len(self.tokenizer.text2tokens(v))
                for k, v in self.text.items()}


def lm_tokenizer(data: LMDataConfig):
    if data.token_type == "bpe":
        return build_tokenizer("bpe", data.bpe_model)
    return build_tokenizer(data.token_type)


class LMTask(AbsTask):
    name = "lm"
    sections = {
        "run": RunConfig,
        "optim": OptimConfig,
        "data": LMDataConfig,
        "model": LMModelConfig,
    }

    @classmethod
    def build_model(cls, mc: LMModelConfig, vocab_size: int,
                    dtype=torch.float32) -> LMTrainModel:
        if mc.lm_type == "transformer":
            lm = TransformerLM(vocab_size, mc.d_model, mc.num_heads, mc.d_ff,
                               mc.num_layers, mc.dropout_rate, dtype)
        elif mc.lm_type == "rnn":
            lm = RNNLM(vocab_size, mc.d_model, mc.num_layers,
                       mc.dropout_rate, dtype)
        else:
            raise ValueError(f"unknown lm_type {mc.lm_type}")
        return LMTrainModel(lm, vocab_size - 1, vocab_size - 1)

    @classmethod
    def build_inference_lm(cls, mc: LMModelConfig, vocab_size: int,
                           dtype=torch.float32) -> nn.Module:
        """The bare LM for shallow fusion; its params live under the `lm`
        key of the trained LMTrainModel's."""
        return cls.build_model(mc, vocab_size, dtype).lm

    @classmethod
    def run(cls, cfg: Dict[str, Any], device="cuda"):
        dev = resolve_device(device)
        run: RunConfig = cfg["run"]
        data: LMDataConfig = cfg["data"]
        out = Path(run.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        cls.dump_config(cfg, out)

        train_texts = list(
            read_2column_text(Path(data.train_dir) / "text").values())
        tokenizer = lm_tokenizer(data)
        tl_path = (Path(data.token_list) if data.token_list
                   else out / "tokens.txt")
        if tl_path.exists():
            converter = TokenIDConverter.from_file(tl_path)
        else:
            converter = TokenIDConverter(build_token_list(train_texts,
                                                          tokenizer))
            converter.save(tl_path)

        train_ds = TextDataset(Path(data.train_dir) / "text", tokenizer,
                               converter)
        valid_ds = (TextDataset(Path(data.valid_dir) / "text", tokenizer,
                                converter) if data.valid_dir else None)

        from espnet_tpu_torch.data.dataset import EpochIterator

        def iters(ds, shuffle):
            batches = build_batches(
                {"text": ds.text_lengths()}, batch_size=data.batch_size,
                length_quantum=data.text_quantum,
                text_quantum=data.text_quantum, input_field="text")
            return EpochIterator(ds, batches, seed=run.seed, shuffle=shuffle,
                                 fields=("text",))

        train_iter = iters(train_ds, True)
        valid_iter = iters(valid_ds, False) if valid_ds else None

        mc: LMModelConfig = cfg["model"]
        model = cls.build_model(mc, len(converter))
        opt: OptimConfig = cfg["optim"]
        tx = build_optimizer(
            opt.name, opt.lr, opt.schedule, opt.warmup_steps, mc.d_model,
            opt.weight_decay, (opt.b1, opt.b2), opt.eps, opt.grad_clip)
        if run.best_metric != "valid.acc.max":
            phase, key, mode = run.best_metric.split(".")
        else:
            phase, key, mode = ("valid" if valid_iter else "train", "loss",
                                "min")
        trainer = Trainer(
            model, tx, out,
            options=TrainerOptions(
                max_epoch=run.max_epoch, patience=run.patience,
                keep_nbest=run.keep_nbest, best_metric=(phase, key, mode),
                log_interval=run.log_interval, seed=run.seed,
                resume=run.resume),
            device=dev, batch_arg_names=LM_BATCH_KEYS)
        state = trainer.init_state()
        state = trainer.run(state, train_iter, valid_iter)
        logger.info("lm training finished: %s", out)
        return state, trainer, model, tokenizer, converter
