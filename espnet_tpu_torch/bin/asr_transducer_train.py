"""Transducer ASR training CLI (port of
espnet_tpu/bin/asr_transducer_train.py). Usage:

    python -m espnet_tpu_torch.bin.asr_transducer_train \
        --config conf/train.yaml --data.train_dir data/train \
        --run.output_dir exp/rnnt --run.best_metric valid.loss.min \
        [--device cpu]

Same flags, files and experiment directory as the JAX package's CLI (the
model has no accuracy stat: pick a loss as the best metric). Runs on the
CUDA card unless `--device cpu` is given, and raises without a card. With
ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch counts are appended to
that file at exit (`ops/launches.py`).
"""

from espnet_tpu_torch.ops.launches import log_at_exit
from espnet_tpu_torch.tasks.transducer import TransducerTask


def main(argv=None):
    log_at_exit("asr_transducer_train")
    return TransducerTask.main(argv)


if __name__ == "__main__":
    main()
