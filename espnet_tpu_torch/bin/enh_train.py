"""Enhancement training CLI (port of espnet_tpu/bin/enh_train.py;
reference `espnet2/bin/enh_train.py`). Usage:

    python -m espnet_tpu_torch.bin.enh_train --data.train_dir data/train \
        --run.output_dir exp/enh --model.separator_type tcn \
        --run.best_metric valid.loss.min [--device cpu]

The sections, fields and defaults are the JAX task's; the experiment
directory (config.yaml, params, resume state) is one that either
package's enhancement CLIs read.
"""

from espnet_tpu_torch.tasks.enh import EnhTask


def main(argv=None):
    return EnhTask.main(argv)


if __name__ == "__main__":
    main()
