"""Voice conversion task (port of espnet_tpu/tasks/vc.py).

Behavioral spec: reference `espnet/vc/pytorch_backend/vc.py`. A data dir
holds `wav.scp` (the source speaker) and `tgt_wav.scp` (the parallel
target speaker); both go through the same log-mel frontend on the device.
The model section's nested configurations are the JAX task's, with
`input_type` "feats" and `dtype` named.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from espnet_tpu_torch.data.dataset import EpochIterator
from espnet_tpu_torch.data.fileio import SoundScpReader
from espnet_tpu_torch.data.sampler import build_batches
from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.models.tts.tacotron2 import Tacotron2Config
from espnet_tpu_torch.models.tts.transformer_tts import TransformerTTSConfig
from espnet_tpu_torch.models.tts.vc import (VC_BATCH_KEYS, VCModel,
                                           VCTaskConfig)
from espnet_tpu_torch.tasks.abs_task import AbsTask, OptimConfig, RunConfig
from espnet_tpu_torch.tasks.asr import torch_dtype
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.train.trainer import Trainer, TrainerOptions

logger = logging.getLogger("espnet_tpu")


@dataclasses.dataclass(frozen=True)
class VCDataConfig:
    train_dir: str = ""
    valid_dir: str = ""
    fs: int = 16000
    batch_size: int = 8
    length_quantum: int = 8192
    num_shards: int = 1
    shard_index: int = 0


@dataclasses.dataclass(frozen=True)
class VCModelSection:
    fs: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 80
    fmin: float = 80.0
    fmax: Optional[float] = 7600.0
    vc_type: str = "tacotron2"  # tacotron2 | transformer (VTN)
    tacotron2: Tacotron2Config = Tacotron2Config(input_type="feats",
                                                 dtype="float32")
    transformer: TransformerTTSConfig = TransformerTTSConfig(
        input_type="feats", dtype="float32")


class VCDataset:
    """Parallel (source wav, target wav) pairs."""

    def __init__(self, data_dir, fs: int = 16000):
        dd = Path(data_dir)
        self.src = SoundScpReader(dd / "wav.scp")
        self.tgt = SoundScpReader(dd / "tgt_wav.scp")
        self.fs = fs

    def keys(self) -> List[str]:
        return list(self.src.keys())

    def __len__(self):
        return len(self.src)

    def __getitem__(self, key):
        s, _ = self.src[key]
        t, _ = self.tgt[key]
        if s.ndim > 1:
            s = s[:, 0]
        if t.ndim > 1:
            t = t[:, 0]
        return {"src_speech": s.astype(np.float32),
                "speech": t.astype(np.float32)}

    def speech_lengths(self) -> Dict[str, int]:
        import wave as wave_mod

        out = {}
        for k in self.src.keys():
            try:
                with wave_mod.open(self.src.data[k]) as w:
                    out[k] = w.getnframes()
            except Exception:
                out[k] = len(self.src[k][0])
        return out


class VCTask(AbsTask):
    name = "vc"
    sections = {
        "run": RunConfig,
        "optim": OptimConfig,
        "data": VCDataConfig,
        "model": VCModelSection,
    }

    @classmethod
    def build_model(cls, mc: VCModelSection) -> VCModel:
        d: Dict[str, Any] = {"input_type": "feats", "input_dim": mc.n_mels,
                             "n_mels": mc.n_mels, "vocab_size": 1}
        t2 = dataclasses.replace(mc.tacotron2, dtype=torch_dtype(
            mc.tacotron2.dtype), **d)
        tr = dataclasses.replace(mc.transformer, dtype=torch_dtype(
            mc.transformer.dtype), **d)
        return VCModel(VCTaskConfig(
            fs=mc.fs, n_fft=mc.n_fft, hop_length=mc.hop_length,
            n_mels=mc.n_mels, fmin=mc.fmin, fmax=mc.fmax,
            vc_type=mc.vc_type, tacotron2=t2, transformer=tr))

    @classmethod
    def make_batches(cls, ds: VCDataset, data: VCDataConfig):
        return build_batches({"speech": ds.speech_lengths()},
                             batch_size=data.batch_size,
                             length_quantum=data.length_quantum)

    @classmethod
    def run(cls, cfg: Dict[str, Any], device="cuda"):
        dev = resolve_device(device)
        run: RunConfig = cfg["run"]
        data: VCDataConfig = cfg["data"]
        out = Path(run.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        cls.dump_config(cfg, out)

        train_ds = VCDataset(data.train_dir, data.fs)
        valid_ds = VCDataset(data.valid_dir, data.fs) \
            if data.valid_dir else None
        fields = ("src_speech", "speech")
        train_iter = EpochIterator(
            train_ds, cls.make_batches(train_ds, data), seed=run.seed,
            num_shards=data.num_shards, shard_index=data.shard_index,
            fields=fields)
        valid_iter = (EpochIterator(valid_ds, cls.make_batches(valid_ds, data),
                                    seed=run.seed, shuffle=False,
                                    fields=fields)
                      if valid_ds else None)

        model = cls.build_model(cfg["model"])
        opt: OptimConfig = cfg["optim"]
        tx = build_optimizer(opt.name, opt.lr, opt.schedule,
                             opt.warmup_steps, 256, opt.weight_decay,
                             (opt.b1, opt.b2), opt.eps, opt.grad_clip)
        phase, key, mode = run.best_metric.split(".")
        trainer = Trainer(
            model, tx, out,
            options=TrainerOptions(
                max_epoch=run.max_epoch, patience=run.patience,
                keep_nbest=run.keep_nbest, best_metric=(phase, key, mode),
                log_interval=run.log_interval, seed=run.seed,
                resume=run.resume),
            device=dev, batch_arg_names=VC_BATCH_KEYS)
        state = trainer.init_state()
        state = trainer.run(state, train_iter, valid_iter)
        logger.info("vc training finished: %s", out)
        return state, trainer, model
