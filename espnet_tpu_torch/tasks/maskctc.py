"""Mask-CTC ASR task (port of espnet_tpu/tasks/maskctc.py).

The ASR task's data plane, trainer and experiment directory with
`MaskCTCModel`. `MaskCTCModelSection` carries every field of the JAX
`ASRConfig` with its default (the JAX section is a `MaskCTCConfig`, which
is one); `build_model` maps it onto the port's `MaskCTCConfig` (`dtype`
"float32" or "bfloat16" becomes the torch dtype only there). The fields
that the JAX `MaskCTCModel` never reads (the SSL and Whisper sections, the
plugin sections, the v1 decoders' and the streaming encoder's) are inert
here too. The JAX task draws the training masks from an rng stream of
their own, `mask`; the port's trainer has one generator, from which the
masks are drawn after SpecAug. With `normalize` "global_mvn" the run
collects the feature stats and the model never reads them, as in JAX.
"""

from __future__ import annotations

import dataclasses

from espnet_tpu_torch.models.maskctc import MaskCTCConfig, MaskCTCModel
from espnet_tpu_torch.tasks.abs_task import OptimConfig, RunConfig
from espnet_tpu_torch.tasks.asr import (ASRDataConfig, ASRModelSection,
                                        ASRTask, model_kwargs, torch_dtype)


@dataclasses.dataclass(frozen=True)
class MaskCTCModelSection(ASRModelSection):
    """The JAX `MaskCTCModelSection`: every `ASRConfig` field, with
    `vocab_size` injected from the token list at build."""


class MaskCTCTask(ASRTask):
    name = "asr_maskctc"
    sections = {
        "run": RunConfig,
        "optim": OptimConfig,
        "data": ASRDataConfig,
        "model": MaskCTCModelSection,
    }

    @classmethod
    def build_model(cls, model_cfg: MaskCTCModelSection,
                    vocab_size: int) -> MaskCTCModel:
        return MaskCTCModel(MaskCTCConfig(
            vocab_size=vocab_size, dtype=torch_dtype(model_cfg.dtype),
            **model_kwargs(model_cfg, MaskCTCConfig)))
