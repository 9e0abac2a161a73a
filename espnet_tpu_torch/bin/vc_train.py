"""Voice conversion training CLI (port of espnet_tpu/bin/vc_train.py;
reference `espnet/bin/vc_train.py`). Usage:

    python -m espnet_tpu_torch.bin.vc_train --data.train_dir data/train \
        --run.output_dir exp/vc [--model.vc_type transformer] [--device cpu]

A data dir holds `wav.scp` (source) and `tgt_wav.scp` (target). Runs on the
CUDA card unless `--device cpu` is given.
"""

from espnet_tpu_torch.ops.launches import log_at_exit
from espnet_tpu_torch.tasks.vc import VCTask


def main(argv=None):
    log_at_exit("vc_train")
    return VCTask.main(argv)


if __name__ == "__main__":
    main()
