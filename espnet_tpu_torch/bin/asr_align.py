"""CTC segmentation CLI: align transcripts to audio with a trained model
(port of espnet_tpu/bin/asr_align.py). Usage:

    python -m espnet_tpu_torch.bin.asr_align --exp_dir exp/asr \
        --data_dir data/test --output_dir exp/align [--params p.msgpack] \
        [--batch_size 8] [--device cpu]

Encodes each batch of `data_dir` with the experiment's model (written by
either package), takes the CTC head's log-probs and force-aligns the
reference transcript (`ops/ctc_align.py`), then writes `segments`, one
`<utt> <token> <start_s> <end_s>` line per aligned token, the JAX CLI's
format, with the frame shift hop_length x subsampling_factor / fs. The
parser is the JAX CLI's, plus `--device` (default cuda: the card, raising
without one). With ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch
counts are appended to that file at exit (`ops/launches.py`).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

logger = logging.getLogger("espnet_tpu")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--params", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    return p


def align_lines(model, data, ds, converter, batch_size, device):
    """The `segments` lines of dataset `ds` aligned by `model` (on
    `device`), batched as the CLI batches them."""
    import torch

    from espnet_tpu_torch.data.dataset import EpochIterator
    from espnet_tpu_torch.data.sampler import build_batches
    from espnet_tpu_torch.ops.ctc_align import (alignment_to_segments,
                                                ctc_forced_align)

    if model.ctc_head is None:
        raise ValueError("asr_align needs a model with a CTC head")
    model = model.to(device).eval()
    shapes = {"speech": ds.speech_lengths(), "text": ds.text_lengths()}
    batches = build_batches(
        shapes, batch_size=batch_size, length_quantum=data.length_quantum,
        text_quantum=data.text_quantum)
    it = EpochIterator(ds, batches, shuffle=False, prefetch=2)
    mc = model.config
    frame_shift = mc.hop_length * mc.subsampling_factor / mc.fs
    lines = []
    for batch in it.epoch(0):
        keys = batch.pop("keys")
        t = {k: torch.from_numpy(batch[k]).to(device) for k in
             ("speech", "speech_lengths", "text", "text_lengths")}
        with torch.no_grad():
            enc, elens = model.encode(t["speech"], t["speech_lengths"])
            frame_ids = ctc_forced_align(model.ctc_log_probs(enc), t["text"],
                                         elens, t["text_lengths"])
        segs = alignment_to_segments(frame_ids, batch["text"],
                                     batch["text_lengths"], frame_shift)
        for key, utt_segs in zip(keys, segs):
            for tok, s, e in utt_segs:
                token = converter.ids2tokens([tok])[0]
                lines.append(f"{key} {token} {s:.3f} {e:.3f}")
        logger.info("aligned %d utts", len(lines))
    return lines


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.ops.launches import log_at_exit

    log_at_exit("asr_align")
    from espnet_tpu_torch.bin.asr_inference import load_experiment
    from espnet_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    model, data, ds, _, converter = load_experiment(
        Path(args.exp_dir), args.data_dir, args.params)
    lines = align_lines(model, data, ds, converter, args.batch_size, device)
    (out / "segments").write_text("\n".join(lines) + "\n")
    return out


if __name__ == "__main__":
    main()
