"""Staged, resumable recipe pipeline (port of espnet_tpu/recipe.py).

Behavioral spec: `egs2/TEMPLATE/asr1/asr.sh:493-1432`: numbered stages
selected with `stage`/`stop_stage`, per-stage artifacts and idempotent
re-runs. The model stages shell out to the port's CLIs
(`python -m espnet_tpu_torch.bin.<cli>`), so a recipe run exercises what a
user would type; light data plumbing (validation, filtering, speed
perturbation) runs in-process.

Stage map (reference asr.sh line refs):
  1  data prep (synthetic corpus or external command)        asr.sh:493
  2  speed perturbation                                      asr.sh:500
  3  format/validate data dirs                               asr.sh:526
  4  remove long/short utterances                            asr.sh:652
  5  token list / BPE model                                  asr.sh:730
  6  LM training (optional)                                  asr.sh:829
  7  n-gram training (optional)                              asr.sh:1009
  8  ASR collect-stats                                       asr.sh:1021
  9  ASR training                                            asr.sh:1133
  10 decoding (each test set)                                asr.sh:1299
  11 scoring summary                                         asr.sh:1432
  12 pack                                                    asr.sh:1534

Completion markers `.stage<N>.done` under the experiment dir make re-runs
resume where they stopped. The files and directories are the JAX recipe's.
`device` ("cuda", the card, or "cpu") is passed to the CLIs that run a
model (`asr_train`, `lm_train`, `asr_inference`) as their `--device`; it is
never written into a config. `use_lm` trains the neural LM in stage 6
(`bin.lm_train` on the training text with the recipe's token list and
`lm_args`) and passes `--lm_exp_dir` to decoding, as JAX does: the fusion
weight comes from `decode_args` (`--lm_weight`). `use_ngram` trains an
`ngram_order`-gram on the training text in stage 7 (`bin.ngram_train`, the
recipe's token type, into `<expdir>/ngram/<order>gram.arpa`) and passes
`--ngram_file` to decoding; as in JAX it passes no weight, so the n-gram is
fused only where `decode_args` names an `--ngram_weight` > 0.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import shlex
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Sequence

logger = logging.getLogger("espnet_tpu")

@dataclasses.dataclass
class RecipeConfig:
    expdir: str = "exp/asr1"
    datadir: str = "data"
    train_set: str = "train"
    valid_set: str = "dev"
    test_sets: str = "test"          # space-separated
    # stage 1: "" = expect dirs to exist; "synth" = generate the smoke
    # corpus; "synth_hard" = the harder synthetic corpus; anything else =
    # run it as a shell command (local/data.sh)
    local_data: str = "synth"
    synth_utts: int = 24
    speed_perturb: str = ""          # e.g. "0.9 1.0 1.1"
    min_duration_s: float = 0.1      # stage 4 bounds (asr.sh:652)
    max_duration_s: float = 30.0
    token_type: str = "char"         # char | word | bpe
    bpe_vocab_size: int = 300
    use_lm: bool = False
    use_ngram: bool = False
    ngram_order: int = 3
    fs: int = 16000
    # extra CLI args forwarded verbatim (lists of "--k v" tokens)
    asr_args: str = ""
    lm_args: str = ""
    decode_args: str = ""
    stage: int = 1
    stop_stage: int = 12


def _run_cli(module: str, args: Sequence[str]) -> None:
    cmd = [sys.executable, "-m", module] + list(args)
    logger.info("+ %s", " ".join(shlex.quote(c) for c in cmd))
    proc = subprocess.run(cmd)
    if proc.returncode != 0:
        raise RuntimeError(f"{module} failed with rc={proc.returncode}")


class Recipe:
    def __init__(self, cfg: RecipeConfig, device: str = "cuda"):
        self.cfg = cfg
        self.device = device
        self.exp = Path(cfg.expdir)
        self.data = Path(cfg.datadir)
        self.exp.mkdir(parents=True, exist_ok=True)
        self.test_sets = cfg.test_sets.split()

    # -- marker helpers ---------------------------------------------------
    def _marker(self, n: int) -> Path:
        return self.exp / f".stage{n}.done"

    def done(self, n: int) -> bool:
        return self._marker(n).exists()

    def mark(self, n: int) -> None:
        self._marker(n).write_text("done\n")

    # -- stage bodies -----------------------------------------------------
    def train_dir(self) -> Path:
        """The training dir after optional perturb/filter stages."""
        name = self.cfg.train_set
        if self.cfg.speed_perturb:
            name = name + "_sp"
        d = self.data / (name + "_filtered")
        return d if d.exists() else self.data / name

    def stage1_data(self):
        c = self.cfg
        sets = [c.train_set, c.valid_set] + self.test_sets
        if c.local_data == "synth":
            for i, name in enumerate(dict.fromkeys(sets)):
                d = self.data / name
                n = (c.synth_utts if name == c.train_set
                     else max(4, c.synth_utts // 4))
                if not (d / "wav.scp").exists():
                    _run_cli("espnet_tpu_torch.bin.make_synth_data", [
                        "--output_dir", str(d),
                        "--n_utts", str(n),
                        "--seed", str(17 * i),
                    ])
        elif c.local_data == "synth_hard":
            # disjoint seeds per split: disjoint utterances and unseen test
            # speakers (data/synth.py generate_hard_corpus)
            from espnet_tpu_torch.data.synth import generate_hard_corpus

            for i, name in enumerate(dict.fromkeys(sets)):
                d = self.data / name
                n = (c.synth_utts if name == c.train_set
                     else max(20, c.synth_utts // 5))
                if not (d / "wav.scp").exists():
                    generate_hard_corpus(d, n_utts=n, seed=i)
        elif c.local_data:
            subprocess.run(c.local_data, shell=True, check=True)
        for name in dict.fromkeys(sets):
            d = self.data / name
            if not (d / "wav.scp").exists() or not (d / "text").exists():
                raise FileNotFoundError(f"stage 1: {d} lacks wav.scp/text")

    def stage2_speed_perturb(self):
        c = self.cfg
        if not c.speed_perturb:
            return
        from espnet_tpu_torch.ops.perturb import speed_perturb_corpus

        factors = [float(f) for f in c.speed_perturb.split()]
        out = self.data / (c.train_set + "_sp")
        if not (out / "wav.scp").exists():
            speed_perturb_corpus(self.data / c.train_set, out, factors, c.fs)

    def stage3_validate(self):
        from espnet_tpu_torch.data.fileio import read_2column_text

        c = self.cfg
        names = [c.train_set + ("_sp" if c.speed_perturb else ""),
                 c.valid_set] + self.test_sets
        for name in dict.fromkeys(names):
            d = self.data / name
            wavs = read_2column_text(d / "wav.scp")
            texts = read_2column_text(d / "text")
            missing = set(wavs) ^ set(texts)
            if missing:
                raise ValueError(
                    f"stage 3: {d}: wav.scp/text key mismatch: "
                    f"{sorted(missing)[:5]}...")
            logger.info("stage 3: %s ok (%d utts)", d, len(wavs))

    def stage4_filter(self):
        """Drop utterances outside [min, max] duration (asr.sh:652)."""
        from espnet_tpu_torch.data.fileio import (DatadirWriter,
                                                  read_2column_text,
                                                  wav_duration)

        c = self.cfg
        name = c.train_set + ("_sp" if c.speed_perturb else "")
        src = self.data / name
        out = self.data / (name + "_filtered")
        if (out / "wav.scp").exists():
            return
        wavs = read_2column_text(src / "wav.scp")
        texts = read_2column_text(src / "text")
        kept, dropped = 0, 0
        with DatadirWriter(out) as w:
            for key, path in wavs.items():
                dur = wav_duration(path)
                if (c.min_duration_s <= dur <= c.max_duration_s
                        and texts.get(key)):
                    w["wav.scp"][key] = path
                    w["text"][key] = texts[key]
                    kept += 1
                else:
                    dropped += 1
        logger.info("stage 4: kept %d dropped %d -> %s", kept, dropped, out)

    def stage5_token_list(self):
        _run_cli("espnet_tpu_torch.bin.build_token_list", [
            "--text", str(self.train_dir() / "text"),
            "--output_dir", str(self.exp / "tokens"),
            "--token_type", self.cfg.token_type,
            "--bpe_vocab_size", str(self.cfg.bpe_vocab_size),
        ])

    def stage6_lm(self):
        if not self.cfg.use_lm:
            return
        _run_cli("espnet_tpu_torch.bin.lm_train", [
            "--run.output_dir", str(self.exp / "lm"),
            "--data.train_dir", str(self.train_dir()),
            "--data.valid_dir", str(self.data / self.cfg.valid_set),
            "--data.token_list", str(self.exp / "tokens" / "tokens.txt"),
        ] + shlex.split(self.cfg.lm_args) + ["--device", self.device])

    def ngram_file(self) -> Path:
        return self.exp / "ngram" / f"{self.cfg.ngram_order}gram.arpa"

    def stage7_ngram(self):
        if not self.cfg.use_ngram:
            return
        c = self.cfg
        (self.exp / "ngram").mkdir(exist_ok=True)
        args = [
            "--data_dir", str(self.train_dir()),
            "--output", str(self.ngram_file()),
            "--order", str(c.ngram_order),
            "--token_type", c.token_type,
        ]
        if c.token_type == "bpe":
            args += ["--bpe_model", str(self.exp / "tokens" / "bpe.json")]
        _run_cli("espnet_tpu_torch.bin.ngram_train", args)

    def _asr_common_args(self) -> List[str]:
        c = self.cfg
        args = [
            "--data.train_dir", str(self.train_dir()),
            "--data.valid_dir", str(self.data / c.valid_set),
            "--data.token_list", str(self.exp / "tokens" / "tokens.txt"),
            "--data.token_type", c.token_type,
        ]
        if c.token_type == "bpe":
            args += ["--data.bpe_model", str(self.exp / "tokens" / "bpe.json")]
        return args + shlex.split(c.asr_args) + ["--device", self.device]

    def stage8_collect_stats(self):
        _run_cli("espnet_tpu_torch.bin.asr_train", [
            "--run.output_dir", str(self.exp / "asr"),
            "--run.stats_only", "true",
        ] + self._asr_common_args())

    def stage9_train(self):
        _run_cli("espnet_tpu_torch.bin.asr_train", [
            "--run.output_dir", str(self.exp / "asr"),
        ] + self._asr_common_args())

    def stage10_decode(self):
        for name in self.test_sets:
            out = self.exp / f"decode_{name}"
            args = [
                "--exp_dir", str(self.exp / "asr"),
                "--data_dir", str(self.data / name),
                "--output_dir", str(out),
            ] + shlex.split(self.cfg.decode_args) + ["--device", self.device]
            if self.cfg.use_lm:
                args += ["--lm_exp_dir", str(self.exp / "lm")]
            if self.cfg.use_ngram:
                args += ["--ngram_file", str(self.ngram_file())]
            _run_cli("espnet_tpu_torch.bin.asr_inference", args)

    def stage11_score(self):
        """Aggregate per-set scores into RESULTS.md (asr.sh:1432)."""
        lines = ["# RESULTS", ""]
        results = {}
        for name in self.test_sets:
            f = self.exp / f"decode_{name}" / "score_wer.txt"
            if f.exists():
                body = f.read_text()
                results[name] = body
                lines += [f"## {name}", "```", body.strip(), "```", ""]
        (self.exp / "RESULTS.md").write_text("\n".join(lines))
        (self.exp / "results.json").write_text(json.dumps(
            {k: v.splitlines()[:3] for k, v in results.items()}, indent=2))
        logger.info("stage 11: wrote %s", self.exp / "RESULTS.md")

    def stage12_pack(self):
        _run_cli("espnet_tpu_torch.bin.pack", [
            "--exp_dir", str(self.exp / "asr"),
            "--output", str(self.exp / "packed_model.zip"),
        ])

    # -- the stage loop -------------------------------------------------
    STAGES = {
        1: ("data prep", "stage1_data"),
        2: ("speed perturb", "stage2_speed_perturb"),
        3: ("validate data dirs", "stage3_validate"),
        4: ("filter long/short", "stage4_filter"),
        5: ("token list", "stage5_token_list"),
        6: ("lm train", "stage6_lm"),
        7: ("ngram train", "stage7_ngram"),
        8: ("collect stats", "stage8_collect_stats"),
        9: ("asr train", "stage9_train"),
        10: ("decode", "stage10_decode"),
        11: ("score", "stage11_score"),
        12: ("pack", "stage12_pack"),
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
            t0 = time.perf_counter()
            getattr(self, fn)()
            self.mark(n)
            logger.info("stage %d (%s) done in %.2fs", n, title,
                        time.perf_counter() - t0)
