"""Streaming ASR inference CLI: simulated chunked online decoding (port of
espnet_tpu/bin/asr_inference_streaming.py). Each utterance is fed in
`--sim_chunk_length`-sample chunks, the last with is_final. The model must
have been trained with encoder_type contextual_block_conformer. Usage:

    python -m espnet_tpu_torch.bin.asr_inference_streaming \
        --exp_dir exp/stream --data_dir data/test --output_dir exp/decode \
        --sim_chunk_length 1600 --search beam --beam_size 10 \
        [--engine device|host] [--device cpu]

`--engine device` (the default) is `decode/streaming_device.py`, which keeps
its rolling state on the device and advances one audio quantum a step;
`host` is `decode/streaming_inference.py`. The parser is the JAX CLI's, plus
`--device` (default cuda: the card, raising without one). Writes `text`,
`nbest.jsonl` and, with a reference `text`, `score_wer.txt`. With
ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch counts are appended to
that file at exit (`ops/launches.py`).
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger("espnet_tpu")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--params", default=None)
    p.add_argument("--sim_chunk_length", type=int, default=1600,
                   help="samples per simulated streaming chunk")
    p.add_argument("--search", choices=["greedy", "beam"], default="greedy")
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--ctc_weight", type=float, default=0.3)
    p.add_argument("--penalty", type=float, default=0.0)
    p.add_argument("--max_steps", type=int, default=64)
    p.add_argument("--engine", choices=["device", "host"], default="device",
                   help="'device' = the device-resident recognizer "
                        "(decode/streaming_device.py, one step per "
                        "quantum); 'host' = the host-buffered one "
                        "(decode/streaming_inference.py)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.ops.launches import log_at_exit

    log_at_exit("asr_inference_streaming")
    from espnet_tpu_torch.bin.asr_inference import load_experiment
    from espnet_tpu_torch.data.fileio import (read_2column_text,
                                              write_2column_text)
    from espnet_tpu_torch.device import resolve_device
    from espnet_tpu_torch.utils.metrics import sclite_report

    if args.engine == "device":
        from espnet_tpu_torch.decode.streaming_device import \
            DeviceStreamingRecognizer as Recognizer
    else:
        from espnet_tpu_torch.decode.streaming_inference import \
            Speech2TextStreaming as Recognizer

    device = resolve_device(args.device)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    model, data, ds, tokenizer, converter = load_experiment(
        Path(args.exp_dir), args.data_dir, args.params)
    if data.input_type != "raw":
        raise ValueError("streaming inference consumes raw waveforms")
    s2t = Recognizer(model, tokenizer, converter, search=args.search,
                     beam_size=args.beam_size, ctc_weight=args.ctc_weight,
                     penalty=args.penalty, max_steps=args.max_steps,
                     device=device)

    hyps_text = {}
    rows = []
    chunk = max(1, args.sim_chunk_length)
    for key in ds.keys():
        wave = np.asarray(ds[key]["speech"], np.float32).reshape(-1)
        res = None
        for i in range(0, max(len(wave), 1), chunk):
            res = s2t(wave[i:i + chunk], is_final=i + chunk >= len(wave))
        hyps_text[key] = res["text"]
        rows.append({"key": key, "text": res["text"],
                     "token_ids": res["token_ids"]})
        if len(hyps_text) % 10 == 0:
            logger.info("decoded %d utts", len(hyps_text))
    logger.info("decoded %d utts", len(hyps_text))
    write_2column_text(out / "text", hyps_text)
    with open(out / "nbest.jsonl", "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")

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
