"""Token durations from a trained Tacotron2 (the teacher) for FastSpeech2
and ProDiff (port of espnet_tpu/bin/tts_teacher_durations.py).

Behavioral spec: reference
`espnet/nets/pytorch_backend/fastspeech/duration_calculator.py`: d[u] is
the number of decoder frames whose teacher-forced attention argmax is
token u (the first of equal maxima, numpy's argmax, as in JAX), times the
reduction factor. Writes a `durations` file into the data dir. The
prenet's dropout (always on) draws from a generator seeded 2. Usage:

    python -m espnet_tpu_torch.bin.tts_teacher_durations \
        --exp_dir exp/tts_taco --data_dir data/train [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger("espnet_tpu")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--params", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    args = p.parse_args(argv)
    import torch

    from espnet_tpu_torch.bin.tts_inference import load_tts_experiment
    from espnet_tpu_torch.data.dataset import EpochIterator
    from espnet_tpu_torch.data.fileio import write_2column_text
    from espnet_tpu_torch.device import resolve_device
    from espnet_tpu_torch.ops.launches import log_at_exit
    from espnet_tpu_torch.tasks.tts import TTSDatasetWithDurations, TTSTask

    log_at_exit("tts_teacher_durations")
    device = resolve_device(args.device)
    exp = Path(args.exp_dir)
    model, cfg, tokenizer, converter, _ = load_tts_experiment(
        exp, args.params, device)
    data, mc = cfg["data"], cfg["model"]
    if mc.tts_type != "tacotron2":
        raise ValueError("the teacher must be a tacotron2 experiment")
    dd = Path(args.data_dir)
    ds = TTSDatasetWithDurations(wav_scp=dd / "wav.scp", text=dd / "text",
                                 tokenizer=tokenizer, converter=converter,
                                 fs=data.fs)
    batches = TTSTask.make_batches(ds, data, args.batch_size)
    it = EpochIterator(ds, batches, shuffle=False)
    r = mc.tacotron2.reduction_factor
    gen = torch.Generator().manual_seed(2)
    durations = {}
    with torch.no_grad():
        for batch in it.epoch(0):
            keys = batch.pop("keys")
            t = {k: torch.from_numpy(batch[k]).to(device) for k in
                 ("text", "text_lengths", "speech", "speech_lengths")}
            mel, ml = model._fit_reduction(*model.extract_feats(
                t["speech"], t["speech_lengths"]))
            att = model.tts.teacher_attention(t["text"], t["text_lengths"],
                                              mel, ml, generator=gen)
            att, ml = att.float().cpu().numpy(), ml.cpu().numpy()
            for i, k in enumerate(keys):
                n_dec = int(ml[i]) // r
                ul = int(batch["text_lengths"][i])
                arg = att[i, :n_dec].argmax(-1)
                d = np.bincount(np.clip(arg, 0, ul - 1), minlength=ul)[:ul]
                durations[k] = " ".join(str(int(x)) for x in d * r)
            logger.info("durations for %d utts", len(durations))
    write_2column_text(dd / "durations", durations)
    logger.info("wrote %s", dd / "durations")


if __name__ == "__main__":
    main()
