"""LibriSpeech data preparation (port of espnet_tpu/bin/prep_librispeech.py;
local/data.sh + data_prep.sh analogue).

Behavioral spec: reference `egs2/librispeech_100/asr1/local/data.sh`
stages 2-3 and `local/data_prep.sh` (Kaldi-style): walk the
`LibriSpeech/<part>/<reader>/<chapter>/` tree, emit per-part data dirs
with `wav.scp` (utt -> flac path, decoded natively by the port's `data/flac.py` —
no `flac` binary needed), `text` (from `<reader>-<chapter>.trans.txt`),
`utt2spk`/`spk2utt` (speaker = reader, Kaldi prefix convention
`reader-chapter`), and `spk2gender` (from `SPEAKERS.TXT`); then combine
`dev_clean` + `dev_other` into `dev` (combine_data.sh role).

Usage:
  python -m espnet_tpu_torch.bin.prep_librispeech \
      --librispeech /path/to/LibriSpeech \
      --output_dir data \
      --parts train-clean-100 dev-clean dev-other test-clean test-other

Then run the committed flagship recipe config with
`python -m espnet_tpu_torch.bin.run --config
egs/librispeech_100/conf/train_asr_conformer.yaml`.
"""

from __future__ import annotations

import argparse
import logging
import re
from pathlib import Path

logger = logging.getLogger("espnet_tpu")


def parse_speakers(path: Path) -> dict:
    """SPEAKERS.TXT: `ID | SEX | SUBSET | MINUTES | NAME` -> {id: m/f}."""
    out = {}
    if not path.exists():
        return out
    for line in path.read_text(errors="replace").splitlines():
        if line.startswith(";") or "|" not in line:
            continue
        fields = [f.strip() for f in line.split("|")]
        if len(fields) >= 2 and fields[0].isdigit():
            out[fields[0]] = fields[1].lower()
    return out


def prep_part(src: Path, dst: Path, spk2gender: dict) -> int:
    """One part (e.g. train-clean-100) -> Kaldi-style data dir. Returns
    the utterance count."""
    from espnet_tpu_torch.data.fileio import DatadirWriter

    if not src.is_dir():
        raise FileNotFoundError(f"no such part directory: {src}")
    n = 0
    genders = {}
    spk2utt: dict = {}
    with DatadirWriter(dst) as w:
        for reader_dir in sorted(src.iterdir()):
            if not reader_dir.is_dir() or not reader_dir.name.isdigit():
                continue
            reader = reader_dir.name
            for chapter_dir in sorted(reader_dir.iterdir()):
                if not chapter_dir.is_dir() or not chapter_dir.name.isdigit():
                    continue
                chapter = chapter_dir.name
                trans = chapter_dir / f"{reader}-{chapter}.trans.txt"
                if not trans.exists():
                    raise FileNotFoundError(f"missing transcript {trans}")
                texts = {}
                for line in trans.read_text().splitlines():
                    if not line.strip():
                        continue
                    utt, _, words = line.partition(" ")
                    texts[utt] = words.strip()
                for flac in sorted(chapter_dir.glob("*.flac")):
                    utt = flac.stem
                    if utt not in texts:
                        raise ValueError(
                            f"{flac} has no transcript in {trans}")
                    w["wav.scp"][utt] = str(flac)
                    w["text"][utt] = texts[utt]
                    spk = f"{reader}-{chapter}"
                    w["utt2spk"][utt] = spk
                    spk2utt.setdefault(spk, []).append(utt)
                    n += 1
            if reader in spk2gender:
                genders[reader] = spk2gender[reader]
    (dst / "spk2utt").write_text("".join(
        f"{s} {' '.join(us)}\n" for s, us in sorted(spk2utt.items())))
    if genders:
        (dst / "spk2gender").write_text("".join(
            f"{s} {g}\n" for s, g in sorted(genders.items())))
    return n


def combine(dsts, out: Path) -> None:
    """utils/combine_data.sh role: concatenate data dirs key-sorted."""
    from espnet_tpu_torch.data.fileio import DatadirWriter, read_2column_text

    files = ("wav.scp", "text", "utt2spk")
    with DatadirWriter(out) as w:
        for f in files:
            merged = {}
            for d in dsts:
                merged.update(read_2column_text(Path(d) / f))
            for k in sorted(merged):
                w[f][k] = merged[k]
    spk2utt: dict = {}
    for k, s in read_2column_text(out / "utt2spk").items():
        spk2utt.setdefault(s, []).append(k)
    (out / "spk2utt").write_text("".join(
        f"{s} {' '.join(us)}\n" for s, us in sorted(spk2utt.items())))


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--librispeech", required=True,
                   help="path to the LibriSpeech root (containing the "
                        "part directories)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--parts", nargs="+",
                   default=["train-clean-100", "dev-clean", "dev-other",
                            "test-clean", "test-other"])
    p.add_argument("--combine_dev", default="true",
                   help="combine dev-clean+dev-other into dev "
                        "(data.sh stage 3)")
    args = p.parse_args(argv)

    root = Path(args.librispeech)
    out = Path(args.output_dir)
    spk2gender = parse_speakers(root / "SPEAKERS.TXT")
    done = []
    for part in args.parts:
        dst = out / part.replace("-", "_")
        n = prep_part(root / part, dst, spk2gender)
        logger.info("%s: %d utterances -> %s", part, n, dst)
        done.append(dst.name)
    if (args.combine_dev.lower() in ("1", "true", "yes")
            and "dev_clean" in done and "dev_other" in done):
        combine([out / "dev_clean", out / "dev_other"], out / "dev")
        logger.info("combined dev_clean+dev_other -> %s", out / "dev")


if __name__ == "__main__":
    main()
