"""Spoken language understanding task (port of espnet_tpu/tasks/slu.py).

SLU is the ASR stack over transcripts whose first word is a semantic label
(`<intent> transcript words ...`, the SLURP / FSC recipe convention), so
the task is `ASRTask` under its own name; `bin/slu_inference.py` adds the
intent accuracy to the ASR decode.
"""

from __future__ import annotations

from espnet_tpu_torch.tasks.asr import ASRTask


class SLUTask(ASRTask):
    name = "slu"
