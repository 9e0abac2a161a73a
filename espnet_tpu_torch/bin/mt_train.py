"""MT training CLI (port of espnet_tpu/bin/mt_train.py; reference
`espnet2/bin/mt_train.py`). Usage:

    python -m espnet_tpu_torch.bin.mt_train \
        --data.train_dir data/train --data.valid_dir data/dev \
        --run.output_dir exp/mt [--device cpu]

Each data dir holds `src_text` and `text`. Same flags, files and experiment
directory as the JAX package's CLI. Runs on the CUDA card unless
`--device cpu` is given, and raises without a card. With
ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch counts are appended to
that file at exit (`ops/launches.py`).
"""

from espnet_tpu_torch.ops.launches import log_at_exit
from espnet_tpu_torch.tasks.mt import MTTask


def main(argv=None):
    log_at_exit("mt_train")
    return MTTask.main(argv)


if __name__ == "__main__":
    main()
