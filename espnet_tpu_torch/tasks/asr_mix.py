"""Multi-speaker (mixture) ASR task (port of espnet_tpu/tasks/asr_mix.py).

A mixture `wav.scp` and one transcript a speaker (`text_spk<i>`) a data
dir (`data/dataset.py` `ASRMixDataset`); the batches carry the transcripts
as (B, U, S) with their lengths (B, S) in `text_spk_lengths`, which the
model takes in place of `text_lengths`. The sections, fields and defaults
are the JAX task's.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict

from espnet_tpu_torch.data.dataset import ASRMixDataset
from espnet_tpu_torch.data.fileio import read_2column_text
from espnet_tpu_torch.models.asr_mix import ASRMixConfig, ASRMixModel
from espnet_tpu_torch.tasks.abs_task import AbsTask, OptimConfig, RunConfig
from espnet_tpu_torch.tasks.asr import model_kwargs, torch_dtype
from espnet_tpu_torch.tasks.asr_mulenc import run_multi_task

MIX_BATCH_KEYS = ("speech", "speech_lengths", "text", "text_spk_lengths")


@dataclasses.dataclass(frozen=True)
class ASRMixModelSection(ASRMixConfig):
    """Every field of the JAX `ASRMixConfig`, with its default;
    `vocab_size` is injected from the token list at build and `dtype` is
    named ("float32" | "bfloat16")."""

    vocab_size: int = -1
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ASRMixDataConfig:
    train_dir: str = ""
    valid_dir: str = ""
    fs: int = 16000
    token_type: str = "char"
    token_list: str = ""
    bpe_model: str = ""
    batch_size: int = 8
    length_quantum: int = 4096
    text_quantum: int = 4


class ASRMixTask(AbsTask):
    name = "asr_mix"
    sections = {
        "run": RunConfig,
        "optim": OptimConfig,
        "data": ASRMixDataConfig,
        "model": ASRMixModelSection,
    }

    @classmethod
    def build_model(cls, mc: ASRMixModelSection,
                    vocab_size: int) -> ASRMixModel:
        return ASRMixModel(ASRMixConfig(
            vocab_size=vocab_size, dtype=torch_dtype(mc.dtype),
            **model_kwargs(mc, ASRMixConfig)))

    @classmethod
    def run(cls, cfg: Dict[str, Any], device="cuda"):
        data: ASRMixDataConfig = cfg["data"]
        n_spk = cfg["model"].num_spk
        train_texts = []
        for i in range(n_spk):
            train_texts += list(read_2column_text(
                Path(data.train_dir) / f"text_spk{i + 1}").values())

        def make_ds(datadir, tokenizer, converter):
            return ASRMixDataset(datadir, tokenizer, converter, n_spk,
                                 data.fs)

        return run_multi_task(cls, cfg, device, make_ds,
                              ("speech", "text", "text_spk_lengths"),
                              MIX_BATCH_KEYS, train_texts)
