"""Staged TTS recipe driver, the `tts.sh` analogue (port of
espnet_tpu/recipe_tts.py).

Behavioral spec: `egs2/TEMPLATE/tts1/tts.sh:307-1094`: data prep, data
validation, the duration filter, the token list, x-vectors (`:346`,
`bin.spk_embed_extract`), training, the teacher durations, synthesis and
MCD scoring, resumable through `.stage<N>.done` markers under the
experiment dir. For FastSpeech2 and ProDiff the reference's teacher flow
runs: durations from a trained Tacotron2 (`teacher_exp`) before training
(stage 6), or from this experiment's own Tacotron2 in stage 7
(`dump_durations`). Each stage runs the port's CLIs as subprocesses;
`device` ("cuda", the card, or "cpu") goes to every CLI that runs a model
as its `--device`.
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
class RecipeTTSConfig:
    expdir: str = "exp/tts1"
    datadir: str = "data"
    train_set: str = "train"
    valid_set: str = ""              # "" = no validation set
    test_sets: str = "test"          # space-separated
    # stage 1: "" = expect dirs; "synth" = synthetic corpus; else shell cmd
    local_data: str = "synth"
    synth_utts: int = 12
    min_duration_s: float = 0.1
    max_duration_s: float = 30.0
    token_type: str = "char"
    bpe_vocab_size: int = 300
    tts_type: str = "tacotron2"      # tacotron2|transformer|fastspeech2|prodiff
    # x-vector stage (tts.sh:346): train the spk embedder + dump embeddings
    use_xvector: bool = False
    xvector_args: str = ""
    # duration teacher: existing taco2 exp dir (required by
    # fastspeech2/prodiff unless `durations` files already exist)
    teacher_exp: str = ""
    # stage 7: also dump durations from THIS exp's stage-6 model (so a
    # tacotron2 recipe can act as duration teacher for a later FS2 run)
    dump_durations: bool = False
    tts_args: str = ""
    synth_args: str = ""
    stage: int = 1
    stop_stage: int = 9


class RecipeTTS:
    def __init__(self, cfg: RecipeTTSConfig, device: str = "cuda"):
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

    def train_dir(self) -> Path:
        d = self.data / (self.cfg.train_set + "_filtered")
        return d if d.exists() else self.data / self.cfg.train_set

    # -- stage bodies -----------------------------------------------------
    def stage1_data(self):
        c = self.cfg
        if c.local_data == "synth":
            for i, name in enumerate(self._sets()):
                d = self.data / name
                n = c.synth_utts if name == c.train_set \
                    else max(2, c.synth_utts // 4)
                if not (d / "wav.scp").exists():
                    _run_cli("espnet_tpu_torch.bin.make_synth_data", [
                        "--output_dir", str(d),
                        "--n_utts", str(n),
                        "--seed", str(23 * i),
                    ])
        elif c.local_data:
            subprocess.run(c.local_data, shell=True, check=True)
        for name in self._sets():
            d = self.data / name
            if not (d / "wav.scp").exists() or not (d / "text").exists():
                raise FileNotFoundError(f"stage 1: {d} lacks wav.scp/text")

    def stage2_validate(self):
        from espnet_tpu_torch.data.fileio import read_2column_text

        for name in self._sets():
            d = self.data / name
            wavs = read_2column_text(d / "wav.scp")
            texts = read_2column_text(d / "text")
            if wavs.keys() != texts.keys():
                raise ValueError(f"stage 2: {d}: wav.scp/text key mismatch")
            logger.info("stage 2: %s ok (%d utts)", d, len(wavs))

    def stage3_filter(self):
        from espnet_tpu_torch.data.fileio import (
            DatadirWriter, read_2column_text, wav_duration)

        c = self.cfg
        src = self.data / c.train_set
        out = self.data / (c.train_set + "_filtered")
        wavs = read_2column_text(src / "wav.scp")
        texts = read_2column_text(src / "text")
        kept = dropped = 0
        with DatadirWriter(out) as w:
            for utt, path in wavs.items():
                dur = wav_duration(path)
                if c.min_duration_s <= dur <= c.max_duration_s:
                    w["wav.scp"][utt] = path
                    w["text"][utt] = texts[utt]
                    kept += 1
                else:
                    dropped += 1
        for extra in ("utt2spk", "spk_embed.scp", "spk2emb.scp"):
            if (src / extra).exists():
                mapping = read_2column_text(src / extra)
                keep_keys = read_2column_text(out / "wav.scp").keys()
                (out / extra).write_text("".join(
                    f"{k} {v}\n" for k, v in mapping.items()
                    if k in keep_keys or extra == "spk2emb.scp"))
        logger.info("stage 3: kept %d dropped %d -> %s", kept, dropped, out)

    def stage4_token_list(self):
        _run_cli("espnet_tpu_torch.bin.build_token_list", [
            "--text", str(self.train_dir() / "text"),
            "--output_dir", str(self.exp / "tokens"),
            "--token_type", self.cfg.token_type,
            "--bpe_vocab_size", str(self.cfg.bpe_vocab_size),
        ])

    def stage5_xvector(self):
        c = self.cfg
        if not c.use_xvector:
            return
        _run_cli("espnet_tpu_torch.bin.spk_embed_extract", [
            "--train_dir", str(self.train_dir()),
            "--dump_dirs", *[str(self.data / s) for s in self._sets()],
            str(self.train_dir()),
            "--output_dir", str(self.exp / "spk_embed"),
        ] + shlex.split(c.xvector_args) + ["--device", self.device])

    def _tts_common_args(self) -> List[str]:
        c = self.cfg
        args = [
            "--data.train_dir", str(self.train_dir()),
            "--data.token_list", str(self.exp / "tokens" / "tokens.txt"),
            "--data.token_type", c.token_type,
            "--model.tts_type", c.tts_type,
        ]
        if c.valid_set:
            args += ["--data.valid_dir", str(self.data / c.valid_set)]
        if c.token_type == "bpe":
            args += ["--data.bpe_model", str(self.exp / "tokens" / "bpe.json")]
        return args + shlex.split(c.tts_args) + ["--device", self.device]

    def _ensure_durations(self):
        """FastSpeech-family models need per-token durations BEFORE stage 6
        (reference: `tts.sh` trains the teacher first and FS consumes
        teacher_dumpdir durations). When `teacher_exp` points at a trained
        Tacotron2, extract durations into every data dir the trainer will
        read; without a teacher this raises with a clear message instead
        of the trainer's KeyError('durations')."""
        c = self.cfg
        dirs = [self.train_dir()]
        if c.valid_set:
            dirs.append(self.data / c.valid_set)
        missing = [d for d in dirs if not (Path(d) / "durations").exists()]
        if not missing:
            return
        teacher = c.teacher_exp
        if not teacher:
            raise RuntimeError(
                f"tts_type={c.tts_type} needs `durations` in "
                f"{[str(d) for d in missing]}; set --recipe.teacher_exp to "
                "a trained tacotron2 exp (tts.sh teacher_dumpdir flow) or "
                "provide durations files")
        for d in missing:
            _run_cli("espnet_tpu_torch.bin.tts_teacher_durations", [
                "--exp_dir", teacher,
                "--data_dir", str(d),
                "--device", self.device,
            ])

    def stage6_train(self):
        if self.cfg.tts_type in ("fastspeech2", "prodiff"):
            self._ensure_durations()
        _run_cli("espnet_tpu_torch.bin.tts_train", [
            "--run.output_dir", str(self.exp / "tts"),
        ] + self._tts_common_args())

    def stage7_teacher_durations(self):
        """Post-hoc duration dump from THIS exp's stage-6 model (e.g. a
        tacotron2 exp acting as duration teacher for a later FS2 recipe);
        for duration-consuming tts_types stage 6 already ensured its own
        inputs via `_ensure_durations`."""
        c = self.cfg
        teacher = c.teacher_exp or str(self.exp / "tts")
        if c.tts_type not in ("fastspeech2", "prodiff") and not c.dump_durations:
            return
        _run_cli("espnet_tpu_torch.bin.tts_teacher_durations", [
            "--exp_dir", teacher,
            "--data_dir", str(self.train_dir()),
            "--device", self.device,
        ])

    def stage8_synth(self):
        for name in self.test_sets:
            _run_cli("espnet_tpu_torch.bin.tts_inference", [
                "--exp_dir", str(self.exp / "tts"),
                "--data_dir", str(self.data / name),
                "--output_dir", str(self.exp / f"synth_{name}"),
            ] + shlex.split(self.cfg.synth_args) + ["--device", self.device])

    def stage9_score(self):
        lines = ["# TTS RESULTS (MCD)", ""]
        results = {}
        for name in self.test_sets:
            _run_cli("espnet_tpu_torch.bin.tts_scoring", [
                "--ref_dir", str(self.data / name),
                "--synth_dir", str(self.exp / f"synth_{name}"),
                "--output_dir", str(self.exp / f"score_{name}"),
            ])
            body = (self.exp / f"score_{name}" / "score_mcd.txt").read_text()
            results[name] = body.splitlines()[0]
            lines += [f"## {name}", "```", body.strip(), "```", ""]
        (self.exp / "RESULTS.md").write_text("\n".join(lines))
        (self.exp / "results.json").write_text(json.dumps(results, indent=2))
        logger.info("stage 9: wrote %s", self.exp / "RESULTS.md")

    STAGES = {
        1: ("data prep", "stage1_data"),
        2: ("validate data dirs", "stage2_validate"),
        3: ("filter long/short", "stage3_filter"),
        4: ("token list", "stage4_token_list"),
        5: ("x-vector / spk embeddings", "stage5_xvector"),
        6: ("tts train", "stage6_train"),
        7: ("teacher durations", "stage7_teacher_durations"),
        8: ("synthesize", "stage8_synth"),
        9: ("score (MCD)", "stage9_score"),
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
