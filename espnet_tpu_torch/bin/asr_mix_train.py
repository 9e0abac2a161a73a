"""Multi-speaker (mixture) ASR training CLI (port of
espnet_tpu/bin/asr_mix_train.py). Usage:

    python -m espnet_tpu_torch.bin.asr_mix_train \
        --data.train_dir data/train --data.valid_dir data/dev \
        --run.output_dir exp/mix [--device cpu]

Each data dir holds the mixtures' `wav.scp` and `text_spk1`, `text_spk2`,
... Same flags, files and experiment directory as the JAX package's CLI.
Runs on the CUDA card unless `--device cpu` is given, and raises without a
card. With ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch counts are
appended to that file at exit (`ops/launches.py`).
"""

from espnet_tpu_torch.ops.launches import log_at_exit
from espnet_tpu_torch.tasks.asr_mix import ASRMixTask


def main(argv=None):
    log_at_exit("asr_mix_train")
    return ASRMixTask.main(argv)


if __name__ == "__main__":
    main()
