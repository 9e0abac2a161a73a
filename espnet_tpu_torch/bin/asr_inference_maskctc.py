"""Mask-CTC non-autoregressive inference CLI (port of
espnet_tpu/bin/asr_inference_maskctc.py). Usage:

    python -m espnet_tpu_torch.bin.asr_inference_maskctc \
        --exp_dir exp/maskctc --data_dir data/test --output_dir exp/decode \
        --maskctc_n_iterations 10 --maskctc_threshold_probability 0.99 \
        [--params path.msgpack] [--device cpu]

The parser is the JAX CLI's, plus `--device` (default cuda: the card,
raising without one). The experiment directory may come from either
package. Greedy CTC, low-confidence tokens masked, then K rounds of MLM
infilling (`models/maskctc.py` `MaskCTCInference`). Writes `text`,
`nbest.jsonl` ({"key", "text"} rows), `rtf.txt` and, with a reference
`text`, `score_wer.txt`. With `normalize` global_mvn the JAX CLI passes the
stats, which the model never reads; the port drops them, so both decode
unnormalised. With ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch
counts are appended to that file at exit (`ops/launches.py`).
"""

from __future__ import annotations

import argparse
import json
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
    p.add_argument("--maskctc_n_iterations", type=int, default=10,
                   help="MLM infilling rounds (reference "
                        "--maskctc_n_iterations)")
    p.add_argument("--maskctc_threshold_probability", type=float,
                   default=0.99,
                   help="CTC confidence below which a token is masked")
    p.add_argument("--max_tokens", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.ops.launches import log_at_exit

    log_at_exit("asr_inference_maskctc")
    from espnet_tpu_torch.bin.asr_inference import pick_params_file
    from espnet_tpu_torch.convert import load_jax_params
    from espnet_tpu_torch.data.dataset import EpochIterator
    from espnet_tpu_torch.data.fileio import (read_2column_text,
                                              write_2column_text)
    from espnet_tpu_torch.data.sampler import build_batches
    from espnet_tpu_torch.device import resolve_device
    from espnet_tpu_torch.models.maskctc import MaskCTCInference
    from espnet_tpu_torch.tasks.maskctc import MaskCTCTask
    from espnet_tpu_torch.train.msgpack_io import load_tree
    from espnet_tpu_torch.utils.metrics import sclite_report

    device = resolve_device(args.device)
    exp = Path(args.exp_dir)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = MaskCTCTask.load_config(exp)
    data = cfg["data"]
    tokenizer = MaskCTCTask.build_tokenizer(data, exp)
    converter = MaskCTCTask.build_token_list(data, exp, tokenizer)
    model = MaskCTCTask.build_model(cfg["model"], len(converter))
    ds = MaskCTCTask.build_dataset(data, args.data_dir, tokenizer, converter,
                                   train=False)
    shapes = {"speech": ds.speech_lengths(), "text": ds.text_lengths()}
    batches = build_batches(
        shapes, batch_size=args.batch_size,
        length_quantum=data.length_quantum, text_quantum=data.text_quantum,
    )
    it = EpochIterator(ds, batches, shuffle=False, prefetch=2)
    params_file = Path(args.params) if args.params else pick_params_file(exp)
    logger.info("loading params: %s", params_file)
    load_jax_params(model, {"params": load_tree(params_file)})

    infer = MaskCTCInference(
        model, device=device, n_iterations=args.maskctc_n_iterations,
        threshold_probability=args.maskctc_threshold_probability,
        max_tokens=args.max_tokens)

    hyps_text = {}
    rows = []
    audio_seconds = decode_seconds = 0.0
    for batch in it.epoch(0):
        keys = batch.pop("keys")
        if data.input_type == "raw":
            audio_seconds += float(np.sum(batch["speech_lengths"])) / data.fs
        t0 = time.perf_counter()
        id_lists = infer(batch["speech"], batch["speech_lengths"])
        decode_seconds += time.perf_counter() - t0
        for key, ids in zip(keys, id_lists):
            text = tokenizer.tokens2text(converter.ids2tokens(ids))
            hyps_text[key] = text
            rows.append({"key": key, "text": text})
        logger.info("decoded %d utts", len(hyps_text))
    write_2column_text(out / "text", hyps_text)
    with open(out / "nbest.jsonl", "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
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
