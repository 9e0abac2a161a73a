"""ASR training CLI (port of espnet_tpu/bin/asr_train.py). Usage:

    python -m espnet_tpu_torch.bin.asr_train --config conf/train.yaml \
        --data.train_dir data/train --data.valid_dir data/dev \
        --run.output_dir exp/asr --model.d_model 256 [--device cpu]

Same flags, files and experiment directory as the JAX package's CLI. Runs
on the CUDA card unless `--device cpu` is given, and raises without a card.
`--print_config true` dumps the resolved config and exits. With
ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch counts are appended to
that file at exit (`ops/launches.py`).
"""

from espnet_tpu_torch.ops.launches import log_at_exit
from espnet_tpu_torch.tasks.asr import ASRTask


def main(argv=None):
    log_at_exit("asr_train")
    return ASRTask.main(argv)


if __name__ == "__main__":
    main()
