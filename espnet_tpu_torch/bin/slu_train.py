"""SLU training CLI (port of espnet_tpu/bin/slu_train.py): `asr_train` on
transcripts whose first word is the intent. Usage:

    python -m espnet_tpu_torch.bin.slu_train \
        --data.train_dir data/train --data.valid_dir data/dev \
        --run.output_dir exp/slu [--device cpu]

Same flags, files and experiment directory as the JAX package's CLI. Runs
on the CUDA card unless `--device cpu` is given, and raises without a card.
With ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch counts are
appended to that file at exit (`ops/launches.py`).
"""

from espnet_tpu_torch.ops.launches import log_at_exit
from espnet_tpu_torch.tasks.slu import SLUTask


def main(argv=None):
    log_at_exit("slu_train")
    return SLUTask.main(argv)


if __name__ == "__main__":
    main()
