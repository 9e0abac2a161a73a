"""ST training CLI (port of espnet_tpu/bin/st_train.py; reference
`espnet2/bin/st_train.py`). Usage:

    python -m espnet_tpu_torch.bin.st_train \
        --data.train_dir data/train --data.valid_dir data/dev \
        --run.output_dir exp/st [--device cpu]

Each data dir holds `wav.scp` (or `feats.scp`), `text` (the translation)
and `src_text` (the transcript). Same flags, files and experiment directory
as the JAX package's CLI. Runs on the CUDA card unless `--device cpu` is
given, and raises without a card. With ESPNET_TPU_TORCH_LAUNCH_LOG set, the
kernels' launch counts are appended to that file at exit
(`ops/launches.py`).
"""

from espnet_tpu_torch.ops.launches import log_at_exit
from espnet_tpu_torch.tasks.st import STTask


def main(argv=None):
    log_at_exit("st_train")
    return STTask.main(argv)


if __name__ == "__main__":
    main()
