"""HuBERT pretraining CLI (port of espnet_tpu/bin/hubert_train.py). Usage:

    python -m espnet_tpu_torch.bin.hubert_train --data.train_dir data/train \
        --run.output_dir exp/hubert [--model.num_classes 100] [--device cpu]

Same flags, files and experiment directory as the JAX package's CLI: the
k-means stage writes `km_centroids.npy` and `labels/`, then training writes
the port's checkpoint and `ep<N>.params.msgpack`. Runs on the CUDA card
unless `--device cpu` is given, and raises without a card. With
ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch counts are appended to
that file at exit (`ops/launches.py`).
"""

from espnet_tpu_torch.ops.launches import log_at_exit
from espnet_tpu_torch.tasks.hubert import HubertTask


def main(argv=None):
    log_at_exit("hubert_train")
    return HubertTask.main(argv)


if __name__ == "__main__":
    main()
