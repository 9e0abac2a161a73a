"""MT inference CLI: translate a data dir's `src_text` (port of
espnet_tpu/bin/mt_inference.py; reference `espnet2/bin/mt_inference.py`).
Usage:

    python -m espnet_tpu_torch.bin.mt_inference --exp_dir exp/mt \
        --data_dir data/test --output_dir exp/mt/decode [--device cpu]

The parser is the JAX CLI's, plus `--device` (default cuda: the card,
raising without one). The experiment directory may come from either
package. The source sentences are batched in the data dir's key order and
translated by `decode/asr_inference.py` `Speech2Text` (attention only:
CTC weight 0; `--max_steps` 64). Writes `text`, `rtf.txt` (decode seconds
per source sentence) and, with a reference `text`, `score_wer.txt`. With
ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch counts are appended to
that file at exit (`ops/launches.py`).
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
    p.add_argument("--max_steps", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    return p


def pad_ids(arrays):
    """(padded (B, L) int32 ids, (B,) lengths)."""
    maxlen = max(len(a) for a in arrays)
    buf = np.zeros((len(arrays), maxlen), np.int32)
    lens = np.zeros((len(arrays),), np.int32)
    for j, a in enumerate(arrays):
        buf[j, : len(a)] = a
        lens[j] = len(a)
    return buf, lens


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.ops.launches import log_at_exit

    log_at_exit("mt_inference")
    from espnet_tpu_torch.bin.asr_inference import load_variables
    from espnet_tpu_torch.data.fileio import (read_2column_text,
                                              write_2column_text)
    from espnet_tpu_torch.data.tokenizer import (TokenIDConverter,
                                                 build_tokenizer)
    from espnet_tpu_torch.decode.asr_inference import Speech2Text
    from espnet_tpu_torch.device import resolve_device
    from espnet_tpu_torch.tasks.mt import MTTask
    from espnet_tpu_torch.utils.metrics import sclite_report

    device = resolve_device(args.device)
    exp = Path(args.exp_dir)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = MTTask.load_config(exp)
    data = cfg["data"]
    tokenizer = build_tokenizer(data.token_type)
    conv = TokenIDConverter.from_file(exp / "tokens.txt")
    src_conv = TokenIDConverter.from_file(exp / "src_tokens.txt")
    model = load_variables(
        MTTask.build_model(cfg["model"], len(conv), len(src_conv)), exp,
        args.params)

    src = read_2column_text(Path(args.data_dir) / "src_text")
    keys = list(src)
    s2t = Speech2Text(
        model, device=device, beam_size=args.beam_size, ctc_weight=0.0,
        penalty=args.penalty, maxlenratio=args.maxlenratio,
        minlenratio=args.minlenratio, max_steps=args.max_steps,
        tokenizer=tokenizer, converter=conv)

    hyps_text = {}
    decode_seconds = 0.0
    for i in range(0, len(keys), args.batch_size):
        chunk = keys[i:i + args.batch_size]
        buf, lens = pad_ids([
            np.asarray(src_conv.tokens2ids(tokenizer.text2tokens(src[k])),
                       np.int32) for k in chunk])
        t0 = time.perf_counter()
        for r in s2t(buf, lens, keys=chunk):
            hyps_text[r.key] = r.text
        decode_seconds += time.perf_counter() - t0
        logger.info("translated %d utts", len(hyps_text))
    write_2column_text(out / "text", hyps_text)
    (out / "rtf.txt").write_text(
        f"decode_s {decode_seconds:.3f} sentences {len(keys)} "
        f"s_per_sentence {decode_seconds / max(len(keys), 1):.5f}\n")

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
