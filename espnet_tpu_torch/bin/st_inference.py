"""ST inference CLI: translate a speech data dir (port of
espnet_tpu/bin/st_inference.py; reference `espnet2/bin/st_inference.py`).
Usage:

    python -m espnet_tpu_torch.bin.st_inference --exp_dir exp/st \
        --data_dir data/test --output_dir exp/st/decode [--device cpu]

The parser is the JAX CLI's, plus `--device` (default cuda: the card,
raising without one). The experiment directory may come from either
package. `decode/asr_inference.py` `Speech2Text` searches over the
translation decoder alone (CTC weight 0; `--max_steps` 160). Writes `text`,
`rtf.txt` and, with a reference `text` (the translation), `score_wer.txt`:
the word error rate against the reference translation (the recipes report
BLEU; WER is the built-in analogue, as in JAX). A global-MVN model reads
`stats/feats_stats.npz` where the experiment has one, else the identity
statistics that the ST task trains with. With ESPNET_TPU_TORCH_LAUNCH_LOG
set, the kernels' launch counts are appended to that file at exit
(`ops/launches.py`).
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np

logger = logging.getLogger("espnet_tpu")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--params", default=None)
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--penalty", type=float, default=0.0)
    p.add_argument("--maxlenratio", type=float, default=0.0)
    p.add_argument("--minlenratio", type=float, default=0.0)
    p.add_argument("--max_steps", type=int, default=160)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    return p


def load_st_experiment(exp: Path, params=None):
    """(STModel with its parameters, the config, tokenizer, target token
    converter) of an ST experiment directory of either package."""
    from espnet_tpu_torch.bin.asr_inference import load_variables
    from espnet_tpu_torch.tasks.st import STTask

    cfg = STTask.load_config(exp)
    data = cfg["data"]
    tokenizer = STTask.build_tokenizer(data, exp)
    conv = STTask.build_token_list(data, exp, tokenizer)
    model = STTask.build_model(cfg["model"], len(conv),
                               len(STTask.src_token_list(exp)))
    load_variables(model, exp, params)
    return model, cfg, tokenizer, conv


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.ops.launches import log_at_exit

    log_at_exit("st_inference")
    from espnet_tpu_torch.data.dataset import EpochIterator
    from espnet_tpu_torch.data.fileio import (read_2column_text,
                                              write_2column_text)
    from espnet_tpu_torch.data.sampler import build_batches
    from espnet_tpu_torch.decode.asr_inference import Speech2Text
    from espnet_tpu_torch.device import resolve_device
    from espnet_tpu_torch.tasks.st import STTask
    from espnet_tpu_torch.utils.metrics import sclite_report

    device = resolve_device(args.device)
    exp = Path(args.exp_dir)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    model, cfg, tokenizer, conv = load_st_experiment(exp, args.params)
    data = cfg["data"]
    ds = STTask.build_dataset(data, args.data_dir, tokenizer, conv,
                              train=False)
    shapes = {"speech": ds.speech_lengths(), "text": ds.text_lengths()}
    batches = build_batches(
        shapes, batch_size=args.batch_size,
        length_quantum=data.length_quantum, text_quantum=data.text_quantum,
    )
    it = EpochIterator(ds, batches, shuffle=False, prefetch=2)
    s2t = Speech2Text(
        model, device=device, beam_size=args.beam_size, ctc_weight=0.0,
        penalty=args.penalty, maxlenratio=args.maxlenratio,
        minlenratio=args.minlenratio, max_steps=args.max_steps,
        tokenizer=tokenizer, converter=conv)

    hyps_text = {}
    audio_seconds = decode_seconds = 0.0
    for batch in it.epoch(0):
        keys = batch.pop("keys")
        if data.input_type == "raw":
            audio_seconds += float(np.sum(batch["speech_lengths"])) / data.fs
        t0 = time.perf_counter()
        for r in s2t(batch["speech"], batch["speech_lengths"], keys=keys):
            hyps_text[r.key] = r.text
        decode_seconds += time.perf_counter() - t0
        logger.info("translated %d utts", len(hyps_text))
    write_2column_text(out / "text", hyps_text)
    if audio_seconds > 0:
        rtf = decode_seconds / audio_seconds
        (out / "rtf.txt").write_text(
            f"decode_s {decode_seconds:.3f} audio_s {audio_seconds:.3f} "
            f"RTF {rtf:.4f}\n")
        logger.info("RTF %.4f (%.1fs decode / %.1fs audio)", rtf,
                    decode_seconds, audio_seconds)

    ref_path = Path(args.data_dir) / "text"
    if ref_path.exists():
        refs = {k: v.split() for k, v in read_2column_text(ref_path).items()
                if k in hyps_text}
        hyp_words = {k: v.split() for k, v in hyps_text.items()}
        report = sclite_report(refs, hyp_words)
        (out / "score_wer.txt").write_text(report + "\n")
        logger.info("WER %s", report)
    return out


if __name__ == "__main__":
    main()
