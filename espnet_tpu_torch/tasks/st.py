"""Speech translation task (port of espnet_tpu/tasks/st.py).

Behavioral spec: reference `espnet2/tasks/st.py` and the
`egs2/TEMPLATE/st1` data layout: `text` is the translation, `src_text` the
transcript. The target's tokenizer and token list are the ASR task's; the
source token list `src_tokens.txt` is built in the experiment directory
with the same tokenizer. The model section is the ASR task's plus
`src_vocab_size`, `asr_weight`, `mtlalpha` and `num_asr_decoder_layers`
(the JAX `STModelSection`), and the model takes the batch fields
`ST_BATCH_KEYS`. As in JAX, the task collects no feature statistics: a
model with global MVN trains and decodes with the identity statistics of
its init.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict

from espnet_tpu_torch.data.dataset import (ASRDataset, EpochIterator,
                                           process_topology)
from espnet_tpu_torch.data.fileio import read_2column_text
from espnet_tpu_torch.data.sampler import build_batches
from espnet_tpu_torch.data.tokenizer import TokenIDConverter, build_token_list
from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.models.st import STConfig, STModel
from espnet_tpu_torch.tasks.abs_task import OptimConfig, RunConfig
from espnet_tpu_torch.tasks.asr import (ASRDataConfig, ASRModelSection,
                                        ASRTask, model_kwargs, torch_dtype)
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.train.trainer import Trainer, TrainerOptions

logger = logging.getLogger("espnet_tpu")

ST_BATCH_KEYS = ("speech", "speech_lengths", "text", "text_lengths",
                 "src_text", "src_text_lengths")


@dataclasses.dataclass(frozen=True)
class STModelSection(ASRModelSection):
    """The ASR model section's fields plus STConfig's own, with the JAX
    defaults."""

    src_vocab_size: int = -1
    asr_weight: float = 0.3
    mtlalpha: float = 1.0
    num_asr_decoder_layers: int = 2


class STTask(ASRTask):
    name = "st"
    sections = {
        "run": RunConfig,
        "optim": OptimConfig,
        "data": ASRDataConfig,
        "model": STModelSection,
    }

    @classmethod
    def build_model(cls, model_cfg: STModelSection, vocab_size: int,
                    src_vocab_size: int = 0) -> STModel:
        kw = model_kwargs(model_cfg, STConfig)
        kw["src_vocab_size"] = src_vocab_size
        return STModel(STConfig(vocab_size=vocab_size,
                                dtype=torch_dtype(model_cfg.dtype), **kw))

    @classmethod
    def src_token_list(cls, exp) -> TokenIDConverter:
        return TokenIDConverter.from_file(Path(exp) / "src_tokens.txt")

    @classmethod
    def make_batches(cls, ds: ASRDataset, data: ASRDataConfig):
        """The batches of `ds` over its speech, text and src_text."""
        shapes = {
            "speech": ds.speech_lengths(),
            "text": ds.text_lengths(),
            "src_text": {k: len(ds.src_tokenizer.text2tokens(v))
                         for k, v in ds.src_text.items()},
        }
        return build_batches(
            shapes,
            batch_bins=data.batch_bins,
            batch_size=0 if data.batch_bins else data.batch_size,
            length_quantum=data.length_quantum,
            text_quantum=data.text_quantum,
        )

    @classmethod
    def build_st_dataset(cls, data: ASRDataConfig, datadir, tokenizer,
                         converter, src_converter) -> ASRDataset:
        """A training data dir: speech, `text` and `src_text`."""
        dd = Path(datadir)
        kw = dict(text=dd / "text", tokenizer=tokenizer, converter=converter,
                  fs=data.fs, src_text=dd / "src_text",
                  src_converter=src_converter)
        if data.input_type == "raw":
            return ASRDataset(wav_scp=dd / "wav.scp", **kw)
        return ASRDataset(feats_scp=dd / "feats.scp", **kw)

    @classmethod
    def run(cls, cfg: Dict[str, Any], device="cuda"):
        dev = resolve_device(device)
        run: RunConfig = cfg["run"]
        data: ASRDataConfig = cfg["data"]
        out = Path(run.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        cls.dump_config(cfg, out)

        tdir = Path(data.train_dir)
        tgt_texts = list(read_2column_text(tdir / "text").values())
        src_texts = list(read_2column_text(tdir / "src_text").values())
        tokenizer = cls.build_tokenizer(data, out, tgt_texts)
        conv = cls.build_token_list(data, out, tokenizer, tgt_texts)
        src_path = out / "src_tokens.txt"
        if src_path.exists():
            src_conv = TokenIDConverter.from_file(src_path)
        else:
            src_conv = TokenIDConverter(build_token_list(src_texts,
                                                         tokenizer))
            src_conv.save(src_path)

        def build_ds(datadir):
            return cls.build_st_dataset(data, datadir, tokenizer, conv,
                                        src_conv)

        train_ds = build_ds(data.train_dir)
        valid_ds = build_ds(data.valid_dir) if data.valid_dir else None
        world, rank = process_topology()
        num_shards = data.num_shards or world
        shard_index = data.shard_index if data.shard_index >= 0 else rank

        fields = ("speech", "text", "src_text")
        train_iter = EpochIterator(
            train_ds, cls.make_batches(train_ds, data), seed=run.seed,
            num_shards=num_shards, shard_index=shard_index, fields=fields)
        valid_iter = (
            EpochIterator(valid_ds, cls.make_batches(valid_ds, data),
                          seed=run.seed,
                          shuffle=False, num_shards=num_shards,
                          shard_index=shard_index, fields=fields)
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
            device=dev, batch_arg_names=ST_BATCH_KEYS)
        state = trainer.init_state()
        state = trainer.run(state, train_iter, valid_iter)
        logger.info("training finished: %s", out)
        return state, trainer, model, tokenizer, conv
