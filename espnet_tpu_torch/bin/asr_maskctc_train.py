"""Mask-CTC ASR training CLI (port of espnet_tpu/bin/asr_maskctc_train.py).
Usage:

    python -m espnet_tpu_torch.bin.asr_maskctc_train \
        --data.train_dir data/train --data.valid_dir data/dev \
        --run.output_dir exp/maskctc [--device cpu]

Same flags, files and experiment directory as the JAX package's CLI (the
model reports acc_mlm, not acc: pick `--run.best_metric valid.acc_mlm.max`
or a loss). Runs on the CUDA card unless `--device cpu` is given, and raises
without a card. With ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch
counts are appended to that file at exit (`ops/launches.py`).
"""

from espnet_tpu_torch.ops.launches import log_at_exit
from espnet_tpu_torch.tasks.maskctc import MaskCTCTask


def main(argv=None):
    log_at_exit("asr_maskctc_train")
    return MaskCTCTask.main(argv)


if __name__ == "__main__":
    main()
