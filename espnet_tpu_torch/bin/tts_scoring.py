"""Score synthesised speech against the reference audio with MCD (port of
espnet_tpu/bin/tts_scoring.py). For every utterance in both the reference
data dir's wav.scp and the synthesis dir's wav/, the DTW-aligned
mel-cepstral distortion (`utils/tts_metrics.py`); writes score_mcd.txt.
Host only. Usage:

    python -m espnet_tpu_torch.bin.tts_scoring \
        --ref_dir data/test --synth_dir exp/tts/synth --output_dir exp/score
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger("espnet_tpu")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ref_dir", required=True)
    p.add_argument("--synth_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--n_mcep", type=int, default=13)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.data.fileio import read_2column_text, read_wav
    from espnet_tpu_torch.utils.tts_metrics import mel_cepstral_distortion

    refs = read_2column_text(Path(args.ref_dir) / "wav.scp")
    synth_wav = Path(args.synth_dir) / "wav"
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows, vals = [], []
    for utt, ref_path in sorted(refs.items()):
        syn_path = synth_wav / f"{utt}.wav"
        if not syn_path.exists():
            logger.warning("no synthesis for %s, skipping", utt)
            continue
        r, _ = read_wav(ref_path)
        s, _ = read_wav(syn_path)
        mcd = mel_cepstral_distortion(r, s, fs=args.fs, n_mcep=args.n_mcep)
        rows.append(f"{utt} {mcd:.3f}\n")
        vals.append(mcd)
    mean = float(np.mean(vals)) if vals else float("nan")
    report = (f"| # Utt {len(vals)} | MCD mean {mean:.3f} "
              f"| min {min(vals):.3f} | max {max(vals):.3f} |\n"
              if vals else "no scored utterances\n")
    (out / "score_mcd.txt").write_text(report + "".join(rows))
    logger.info("MCD mean %.3f over %d utts -> %s", mean, len(vals),
                out / "score_mcd.txt")
    return mean


if __name__ == "__main__":
    main()
