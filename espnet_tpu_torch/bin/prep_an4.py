"""Prepare the AN4 corpus into data dirs (port of
espnet_tpu/bin/prep_an4.py).

Behavioral spec: `egs/mini_an4/asr1/local/data_prep.py` + the split logic
in `egs/mini_an4/asr1/run.sh:92-116` — parse the CMU Sphinx transcription
files (`<s> WORDS </s> (file-id)` lines), emit sorted wav.scp/text/utt2spk/
spk2utt per set, then carve a dev set from the first `--dev_utts`
train utterances (reference `utils/subset_data_dir.sh --first data/train 2`)
and the remainder into `train_nodev`.

Unlike the reference there is no sph2pipe pipe: wav.scp points straight at
the .sph files — `espnet_tpu_torch.data.fileio` reads NIST SPHERE natively.

Usage:
  python -m espnet_tpu_torch.bin.prep_an4 --an4_root downloads/an4 \
      --output_dir data
  python -m espnet_tpu_torch.bin.prep_an4 --tar .../downloads.tar.gz \
      --workdir w --output_dir data
"""

from __future__ import annotations

import argparse
import re
import tarfile
from pathlib import Path

_SPH_DIR = {"train": "an4_clstk", "test": "an4test_clstk"}


def parse_transcription(path: Path):
    """Yield (utt_id, words, speaker, wav_relpath) sorted by utt_id."""
    out = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        m = re.match(r"^(.*) \((.*)\)$", line)
        if not m:
            raise ValueError(f"{path}: unparseable line: {line!r}")
        words, source = m.group(1), m.group(2)
        words = re.sub(r"^<s> ", "", re.sub(r" </s>$", "", words))
        pre, mid, last = source.split("-")
        utt_id = "-".join([mid, pre, last])
        out.append((utt_id, words, mid, f"{mid}/{source}.sph"))
    return sorted(out)


def write_datadir(entries, wav_root: Path, out: Path):
    out.mkdir(parents=True, exist_ok=True)
    spk2utt = {}
    with open(out / "wav.scp", "w") as wf, open(out / "text", "w") as tf, \
            open(out / "utt2spk", "w") as uf:
        for utt_id, words, spk, rel in entries:
            wav = (wav_root / rel).resolve()
            if not wav.exists():
                raise FileNotFoundError(f"{wav} (listed in transcription)")
            wf.write(f"{utt_id} {wav}\n")
            tf.write(f"{utt_id} {words}\n")
            uf.write(f"{utt_id} {spk}\n")
            spk2utt.setdefault(spk, []).append(utt_id)
    with open(out / "spk2utt", "w") as f:
        for spk in sorted(spk2utt):
            f.write(f"{spk} {' '.join(spk2utt[spk])}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--an4_root", type=Path, default=None,
                    help="extracted an4 dir (contains etc/ and wav/)")
    ap.add_argument("--tar", type=Path, default=None,
                    help="downloads.tar.gz to extract first")
    ap.add_argument("--workdir", type=Path, default=Path("an4_extract"),
                    help="extraction dir when --tar is given")
    ap.add_argument("--output_dir", type=Path, required=True)
    ap.add_argument("--dev_utts", type=int, default=2,
                    help="first N train utts -> dev (run.sh:113)")
    args = ap.parse_args(argv)

    root = args.an4_root
    if args.tar is not None:
        args.workdir.mkdir(parents=True, exist_ok=True)
        with tarfile.open(args.tar) as tf:
            tf.extractall(args.workdir, filter="data")
        root = args.workdir / "downloads" / "an4"
    if root is None or not (root / "etc").is_dir():
        raise SystemExit(f"an4 root not found: {root}")

    for x in ["train", "test"]:
        entries = parse_transcription(root / "etc" / f"an4_{x}.transcription")
        wav_root = root / "wav" / _SPH_DIR[x]
        write_datadir(entries, wav_root, args.output_dir / x)
        if x == "train":
            write_datadir(entries[:args.dev_utts], wav_root,
                          args.output_dir / "train_dev")
            write_datadir(entries[args.dev_utts:], wav_root,
                          args.output_dir / "train_nodev")
        print(f"{x}: {len(entries)} utts")


if __name__ == "__main__":
    main()
