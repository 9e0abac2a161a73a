"""Transducer ASR task (port of espnet_tpu/tasks/transducer.py).

The ASR task's data plane (wav.scp/text dirs, tokenizer, length-bucketed
batches), trainer and experiment directory with the transducer model:
`TransducerModelSection` carries every field of the JAX `TransducerConfig`
with its default, `build_model` maps it onto the port's `TransducerConfig`
(`dtype` "float32" or "bfloat16" becomes the torch dtype only there). With
`normalize` "global_mvn" the run collects the feature stats, as in JAX, and
the model ignores them (`models/transducer.py`).
"""

from __future__ import annotations

import dataclasses

from espnet_tpu_torch.models.transducer import (TransducerASRModel,
                                                TransducerConfig)
from espnet_tpu_torch.tasks.abs_task import OptimConfig, RunConfig
from espnet_tpu_torch.tasks.asr import (ASRDataConfig, ASRTask,
                                        model_kwargs, torch_dtype)


@dataclasses.dataclass(frozen=True)
class TransducerModelSection(TransducerConfig):
    """Every field of the JAX `TransducerConfig`, with its default;
    `vocab_size` is injected from the token list at build and `dtype` is
    named ("float32" | "bfloat16")."""

    vocab_size: int = -1
    dtype: str = "float32"


class TransducerTask(ASRTask):
    name = "asr_transducer"
    sections = {
        "run": RunConfig,
        "optim": OptimConfig,
        "data": ASRDataConfig,
        "model": TransducerModelSection,
    }

    @classmethod
    def build_model(cls, model_cfg: TransducerModelSection,
                    vocab_size: int) -> TransducerASRModel:
        return TransducerASRModel(TransducerConfig(
            vocab_size=vocab_size, dtype=torch_dtype(model_cfg.dtype),
            **model_kwargs(model_cfg, TransducerConfig)))
