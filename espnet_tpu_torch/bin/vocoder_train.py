"""GAN vocoder training CLI (port of espnet_tpu/bin/vocoder_train.py):

    python -m espnet_tpu_torch.bin.vocoder_train --data.train_dir D \
        --run.output_dir E [--model.generator_type hifigan] [--device cpu]

Runs on the card unless `--device cpu` is given, and raises without a
card. With ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch counts are
appended to that file at exit.
"""

from espnet_tpu_torch.ops.launches import log_at_exit
from espnet_tpu_torch.tasks.vocoder import VocoderTask


def main(argv=None):
    log_at_exit("vocoder_train")
    return VocoderTask.main(argv)


if __name__ == "__main__":
    main()
