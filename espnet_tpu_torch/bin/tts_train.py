"""TTS training CLI (port of espnet_tpu/bin/tts_train.py; reference
`espnet2/bin/tts_train.py`). Usage:

    python -m espnet_tpu_torch.bin.tts_train --config conf/tacotron2.yaml \
        --data.train_dir data/train --run.output_dir exp/tts \
        --model.tts_type tacotron2 [--device cpu]

FastSpeech2 and ProDiff also need a `durations` file in the data dirs
(`bin.tts_teacher_durations`). Same flags, files and experiment directory
as the JAX package's CLI. Runs on the CUDA card unless `--device cpu` is
given, and raises without a card. With ESPNET_TPU_TORCH_LAUNCH_LOG set, the
kernels' launch counts are appended to that file at exit.
"""

from espnet_tpu_torch.ops.launches import log_at_exit
from espnet_tpu_torch.tasks.tts import TTSTask


def main(argv=None):
    log_at_exit("tts_train")
    return TTSTask.main(argv)


if __name__ == "__main__":
    main()
