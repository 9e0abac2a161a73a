"""Staged speech-enhancement recipe driver, the `enh.sh` analogue (port of
espnet_tpu/recipe_enh.py).

Behavioral spec: `egs2/TEMPLATE/enh1/enh.sh`: data prep, data
validation, the duration filter, stats, training, separation and scoring,
resumable through `.stage<N>.done` markers under the experiment dir. The
heavy stages run the port's CLIs (`bin.enh_train`, `bin.enh_inference`,
`bin.enh_scoring`) as subprocesses, as the JAX recipe runs its own;
`device` ("cuda", the card, or "cpu") goes to the training and separation
CLIs as their `--device`.

Stage map (reference enh.sh roles):
  1  data prep (synthetic multi-speaker mixtures or external command)
  2  validate data dirs (wav.scp + spk<i>.scp key agreement)
  3  remove long/short utterances
  4  stats (mixture duration / per-speaker count summary)
  5  enh training
  6  enhance/separate test sets
  7  score: STOI/ESTOI/SI-SNR/SDR/pesq_py per set
"""

from __future__ import annotations

import dataclasses
import json
import logging
import shlex
import subprocess
from pathlib import Path
from typing import List

from espnet_tpu_torch.recipe import _run_cli

logger = logging.getLogger("espnet_tpu")


@dataclasses.dataclass
class RecipeEnhConfig:
    expdir: str = "exp/enh1"
    datadir: str = "data"
    train_set: str = "train"
    valid_set: str = ""              # "" = validate on train_set
    test_sets: str = "test"          # space-separated
    # stage 1: "" = expect dirs; "synth" = synthetic 2-spk mixtures;
    # anything else = run as a shell command (local/data.sh role)
    local_data: str = "synth"
    synth_utts: int = 16
    num_spk: int = 2
    min_duration_s: float = 0.1
    max_duration_s: float = 30.0
    fs: int = 16000
    enh_args: str = ""               # extra bin/enh_train flags
    inference_args: str = ""         # extra bin/enh_inference flags
    stage: int = 1
    stop_stage: int = 7


class RecipeEnh:
    def __init__(self, cfg: RecipeEnhConfig, device: str = "cuda"):
        self.cfg = cfg
        self.device = device
        self.exp = Path(cfg.expdir)
        self.exp.mkdir(parents=True, exist_ok=True)
        self.data = Path(cfg.datadir)
        self.test_sets = cfg.test_sets.split()

    def _marker(self, n: int) -> Path:
        return self.exp / f".stage{n}.done"

    def done(self, n: int) -> bool:
        return self._marker(n).exists()

    def mark(self, n: int) -> None:
        self._marker(n).write_text("done\n")

    def _sets(self) -> List[str]:
        c = self.cfg
        sets = [c.train_set] + ([c.valid_set] if c.valid_set else []) \
            + self.test_sets
        return list(dict.fromkeys(sets))

    def _spk_scps(self) -> List[str]:
        return [f"spk{i + 1}.scp" for i in range(self.cfg.num_spk)]

    def train_dir(self) -> Path:
        d = self.data / (self.cfg.train_set + "_filtered")
        return d if d.exists() else self.data / self.cfg.train_set

    # -- stage bodies -----------------------------------------------------
    def stage1_data(self):
        c = self.cfg
        if c.local_data == "synth":
            from espnet_tpu_torch.data.synth import generate_mixture_corpus

            for i, name in enumerate(self._sets()):
                d = self.data / name
                n = c.synth_utts if name == c.train_set \
                    else max(3, c.synth_utts // 4)
                if not (d / "wav.scp").exists():
                    generate_mixture_corpus(d, n_utts=n, num_spk=c.num_spk,
                                            fs=c.fs, seed=31 * i)
        elif c.local_data:
            subprocess.run(c.local_data, shell=True, check=True)
        for name in self._sets():
            d = self.data / name
            need = ["wav.scp"] + self._spk_scps()
            for f in need:
                if not (d / f).exists():
                    raise FileNotFoundError(f"stage 1: {d} lacks {f}")

    def stage2_validate(self):
        from espnet_tpu_torch.data.fileio import read_2column_text

        for name in self._sets():
            d = self.data / name
            mix = read_2column_text(d / "wav.scp")
            for scp in self._spk_scps():
                refs = read_2column_text(d / scp)
                if refs.keys() != mix.keys():
                    raise ValueError(
                        f"stage 2: {d}: {scp} keys != wav.scp keys")
            logger.info("stage 2: %s ok (%d mixtures, %d spk)", d,
                        len(mix), self.cfg.num_spk)

    def stage3_filter(self):
        from espnet_tpu_torch.data.fileio import (
            DatadirWriter, read_2column_text, wav_duration)

        c = self.cfg
        src = self.data / c.train_set
        out = self.data / (c.train_set + "_filtered")
        mix = read_2column_text(src / "wav.scp")
        refs = {scp: read_2column_text(src / scp)
                for scp in self._spk_scps()}
        kept = dropped = 0
        with DatadirWriter(out) as w:
            for utt, path in mix.items():
                dur = wav_duration(path)
                if c.min_duration_s <= dur <= c.max_duration_s:
                    w["wav.scp"][utt] = path
                    for scp in self._spk_scps():
                        w[scp][utt] = refs[scp][utt]
                    kept += 1
                else:
                    dropped += 1
        logger.info("stage 3: kept %d dropped %d -> %s", kept, dropped, out)

    def stage4_stats(self):
        from espnet_tpu_torch.data.fileio import read_2column_text, wav_duration

        stats = {}
        for name in self._sets():
            d = self.data / name if name != self.cfg.train_set \
                else self.train_dir()
            mix = read_2column_text(d / "wav.scp")
            durs = [wav_duration(p) for p in mix.values()]
            stats[name] = {
                "n_utts": len(mix),
                "total_s": round(sum(durs), 2),
                "mean_s": round(sum(durs) / max(len(durs), 1), 2),
                "num_spk": self.cfg.num_spk,
            }
        out = self.exp / "stats"
        out.mkdir(parents=True, exist_ok=True)
        (out / "data_stats.json").write_text(json.dumps(stats, indent=2))
        logger.info("stage 4: %s", stats)

    def stage5_train(self):
        c = self.cfg
        valid = self.data / c.valid_set if c.valid_set else self.train_dir()
        _run_cli("espnet_tpu_torch.bin.enh_train", [
            "--run.output_dir", str(self.exp / "enh"),
            "--run.best_metric", "valid.loss.min",
            "--data.train_dir", str(self.train_dir()),
            "--data.valid_dir", str(valid),
        ] + shlex.split(c.enh_args) + ["--device", self.device])

    def stage6_enhance(self):
        for name in self.test_sets:
            _run_cli("espnet_tpu_torch.bin.enh_inference", [
                "--exp_dir", str(self.exp / "enh"),
                "--data_dir", str(self.data / name),
                "--output_dir", str(self.exp / f"enhanced_{name}"),
            ] + shlex.split(self.cfg.inference_args)
                + ["--device", self.device])

    def stage7_score(self):
        lines = ["# ENH RESULTS", ""]
        results = {}
        for name in self.test_sets:
            sep = self.exp / f"enhanced_{name}"
            _run_cli("espnet_tpu_torch.bin.enh_scoring", [
                "--output_dir", str(self.exp / f"score_{name}"),
                *sum((["--ref_scp", str(self.data / name / scp)]
                      for scp in self._spk_scps()), []),
                *sum((["--inf_scp", str(sep / scp)]
                      for scp in self._spk_scps()), []),
                "--fs", str(self.cfg.fs),
            ])
            body = (self.exp / f"score_{name}" / "RESULTS").read_text()
            results[name] = dict(
                ln.split(": ") for ln in body.strip().splitlines())
            lines += [f"## {name}", "```", body.strip(), "```", ""]
        (self.exp / "RESULTS.md").write_text("\n".join(lines))
        (self.exp / "results.json").write_text(json.dumps(results, indent=2))
        logger.info("stage 7: wrote %s", self.exp / "RESULTS.md")

    STAGES = {
        1: ("data prep (mixtures)", "stage1_data"),
        2: ("validate data dirs", "stage2_validate"),
        3: ("filter long/short", "stage3_filter"),
        4: ("stats", "stage4_stats"),
        5: ("enh train", "stage5_train"),
        6: ("enhance/separate", "stage6_enhance"),
        7: ("score (SE metrics)", "stage7_score"),
    }

    def run(self, force: bool = False):
        c = self.cfg
        for n in range(c.stage, c.stop_stage + 1):
            if n not in self.STAGES:
                continue
            title, fn = self.STAGES[n]
            if self.done(n) and not force:
                logger.info("stage %d (%s): already done, skipping", n, title)
                continue
            logger.info("===== stage %d: %s =====", n, title)
            getattr(self, fn)()
            self.mark(n)
