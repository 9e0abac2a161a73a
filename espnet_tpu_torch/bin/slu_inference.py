"""SLU inference CLI: the ASR decode and the intent accuracy (port of
espnet_tpu/bin/slu_inference.py). Usage:

    python -m espnet_tpu_torch.bin.slu_inference --exp_dir exp/slu \
        --data_dir data/test --output_dir exp/slu/decode [--device cpu]

Takes every flag of `bin.asr_inference` and runs it; then, with a reference
`text`, the first word of each hypothesis is held against the first word
of its reference (the intent label) and the share that agree is written to
`intent_acc.txt`.
"""

from __future__ import annotations

import logging
from pathlib import Path

logger = logging.getLogger("espnet_tpu")


def intent_accuracy(refs, hyps):
    """(accuracy, correct, n): the share of the keys of `hyps` whose first
    word equals that of `refs` (an empty text's is "")."""
    n = correct = 0
    for k, ref in refs.items():
        if k not in hyps:
            continue
        n += 1
        ref_intent = ref.split()[0] if ref.split() else ""
        hyp_intent = hyps[k].split()[0] if hyps[k].split() else ""
        correct += int(ref_intent == hyp_intent)
    return correct / max(n, 1), correct, n


def main(argv=None):
    from espnet_tpu_torch.bin.asr_inference import get_parser
    from espnet_tpu_torch.bin.asr_inference import main as asr_main
    from espnet_tpu_torch.data.fileio import read_2column_text

    args = get_parser().parse_args(argv)
    asr_main(argv)
    out = Path(args.output_dir)
    ref_path = Path(args.data_dir) / "text"
    if ref_path.exists():
        acc, correct, n = intent_accuracy(read_2column_text(ref_path),
                                          read_2column_text(out / "text"))
        (out / "intent_acc.txt").write_text(f"{acc:.4f}\n")
        logger.info("intent accuracy: %.4f (%d/%d)", acc, correct, n)
    return out


if __name__ == "__main__":
    main()
