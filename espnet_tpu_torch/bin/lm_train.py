"""LM training CLI (port of espnet_tpu/bin/lm_train.py). Usage:

    python -m espnet_tpu_torch.bin.lm_train --config conf/lm.yaml \
        --data.train_dir data/train --run.output_dir exp/lm \
        --data.token_list exp/asr/tokens.txt [--device cpu]

Same flags, files and experiment directory as the JAX package's CLI. Runs on
the CUDA card unless `--device cpu` is given, and raises without a card.
With ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch counts are
appended to that file at exit (`ops/launches.py`).
"""

from espnet_tpu_torch.ops.launches import log_at_exit
from espnet_tpu_torch.tasks.lm import LMTask


def main(argv=None):
    log_at_exit("lm_train")
    return LMTask.main(argv)


if __name__ == "__main__":
    main()
