"""HuBERT pretraining task: the k-means label stage, then masked-prediction
training (port of espnet_tpu/tasks/hubert.py).

ESPnet's `espnet2/tasks/hubert.py` with the ssl1 recipe's label stage.
`generate_labels` takes the log-mel of every utterance of a data dir (the
port's `ops/stft.py` on the run's device, one utterance at a time as in
JAX), fits k-means on a sample of at most `kmeans_sample_frames` frames
(drawn with `RandomState(0)`; `ops/kmeans.py`, host numpy) unless
`km_centroids.npy` exists, and writes one `labels/<key>.npy` of frame
labels per utterance. `HubertDataset` reads wav.scp and those labels;
`HubertTask.run` trains `models.hubert.HubertModel` on the batch fields
(speech, speech_lengths, labels) with the port's trainer. The sections,
fields and defaults are the JAX task's.
"""

from __future__ import annotations

import dataclasses
import logging
import wave as wave_mod
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from espnet_tpu_torch.data.dataset import EpochIterator
from espnet_tpu_torch.data.fileio import SoundScpReader
from espnet_tpu_torch.data.sampler import build_batches
from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.models.hubert import HubertConfig, HubertModel
from espnet_tpu_torch.ops.kmeans import kmeans_assign, kmeans_fit
from espnet_tpu_torch.ops.stft import log_mel_spectrogram
from espnet_tpu_torch.tasks.abs_task import AbsTask, OptimConfig, RunConfig
from espnet_tpu_torch.tasks.asr import torch_dtype
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.train.trainer import Trainer, TrainerOptions

logger = logging.getLogger("espnet_tpu")

HUBERT_BATCH_KEYS = ("speech", "speech_lengths", "labels")


@dataclasses.dataclass(frozen=True)
class HubertDataConfig:
    train_dir: str = ""
    valid_dir: str = ""
    fs: int = 16000
    batch_size: int = 8
    length_quantum: int = 4096
    kmeans_iters: int = 15
    kmeans_sample_frames: int = 20000
    num_shards: int = 1
    shard_index: int = 0


@dataclasses.dataclass(frozen=True)
class HubertModelSection:
    """The JAX `HubertConfig` fields with their defaults; `dtype` by name
    ("float32" | "bfloat16")."""

    num_classes: int = 100
    input_type: str = "raw"
    fs: int = 16000
    n_fft: int = 512
    hop_length: int = 128
    n_mels: int = 80
    normalize: str = "utterance_mvn"
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 1024
    num_encoder_layers: int = 6
    dropout_rate: float = 0.1
    mask_prob: float = 0.08
    mask_length: int = 10
    pred_masked_weight: float = 1.0
    pred_nomask_weight: float = 0.0
    dtype: str = "float32"


class HubertDataset:
    """wav.scp + one frame-label npy per utterance (`generate_labels`)."""

    def __init__(self, data_dir, label_dir, fs: int = 16000):
        self.speech = SoundScpReader(Path(data_dir) / "wav.scp")
        self.label_dir = Path(label_dir)
        self.fs = fs

    def keys(self) -> List[str]:
        return list(self.speech.keys())

    def __len__(self):
        return len(self.speech)

    def __getitem__(self, key):
        wav, _ = self.speech[key]
        if wav.ndim > 1:
            wav = wav[:, 0]
        labels = np.load(self.label_dir / f"{key}.npy")
        return {"speech": wav.astype(np.float32),
                "labels": labels.astype(np.int32)}

    def speech_lengths(self) -> Dict[str, int]:
        out = {}
        for k in self.speech.keys():
            try:
                with wave_mod.open(self.speech.data[k]) as w:
                    out[k] = w.getnframes()
            except Exception:
                out[k] = len(self.speech[k][0])
        return out


class HubertTask(AbsTask):
    name = "hubert"
    sections = {
        "run": RunConfig,
        "optim": OptimConfig,
        "data": HubertDataConfig,
        "model": HubertModelSection,
    }

    @classmethod
    def model_config(cls, section) -> HubertConfig:
        """The model section (or a HubertConfig) as a HubertConfig with the
        torch compute dtype."""
        d = dataclasses.asdict(section)
        dtype = d.pop("dtype")
        if not isinstance(dtype, torch.dtype):
            dtype = torch_dtype(dtype)
        return HubertConfig(dtype=dtype, **d)

    @classmethod
    def build_model(cls, section) -> HubertModel:
        return HubertModel(cls.model_config(section))

    @classmethod
    def generate_labels(cls, data: HubertDataConfig, model_cfg, data_dir,
                        out_dir: Path, device="cuda") -> Path:
        """Stage 1: k-means over log-mel frames -> per-utterance label
        npys under `out_dir/labels`; the centroids in
        `out_dir/km_centroids.npy` (reused when present)."""
        dev = resolve_device(device)
        label_dir = Path(out_dir) / "labels"
        label_dir.mkdir(parents=True, exist_ok=True)
        centroids_path = Path(out_dir) / "km_centroids.npy"
        reader = SoundScpReader(Path(data_dir) / "wav.scp")
        all_feats = {}
        with torch.no_grad():
            for k in reader.keys():
                wav, _ = reader[k]
                if wav.ndim > 1:
                    wav = wav[:, 0]
                f, fl = log_mel_spectrogram(
                    torch.from_numpy(wav.astype(np.float32))[None].to(dev),
                    torch.tensor([len(wav)], device=dev), model_cfg.fs,
                    model_cfg.n_fft, model_cfg.hop_length, None,
                    model_cfg.n_mels)
                all_feats[k] = f[0, :int(fl[0])].cpu().numpy()
        if centroids_path.exists():
            centroids = np.load(centroids_path)
        else:
            pool = np.concatenate(list(all_feats.values()), 0)
            rng = np.random.RandomState(0)
            if len(pool) > data.kmeans_sample_frames:
                pool = pool[rng.choice(len(pool), data.kmeans_sample_frames,
                                       replace=False)]
            logger.info("k-means: %d frames -> %d clusters", len(pool),
                        model_cfg.num_classes)
            centroids = kmeans_fit(pool, model_cfg.num_classes,
                                   data.kmeans_iters)
            np.save(centroids_path, centroids)
        for k, f in all_feats.items():
            np.save(label_dir / f"{k}.npy", kmeans_assign(f, centroids))
        return label_dir

    @classmethod
    def run(cls, cfg: Dict[str, Any], device="cuda"):
        dev = resolve_device(device)
        run: RunConfig = cfg["run"]
        data: HubertDataConfig = cfg["data"]
        mcfg = cls.model_config(cfg["model"])
        out = Path(run.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        cls.dump_config(cfg, out)

        label_dir = cls.generate_labels(data, mcfg, data.train_dir, out, dev)
        train_ds = HubertDataset(data.train_dir, label_dir, data.fs)
        valid_ds = None
        if data.valid_dir:
            vdir = (cls.generate_labels(data, mcfg, data.valid_dir,
                                        out / "valid", dev)
                    if data.valid_dir != data.train_dir else label_dir)
            valid_ds = HubertDataset(data.valid_dir, vdir, data.fs)

        def make_batches(ds):
            return build_batches({"speech": ds.speech_lengths()},
                                 batch_size=data.batch_size,
                                 length_quantum=data.length_quantum)

        fields = ("speech", "labels")
        train_iter = EpochIterator(
            train_ds, make_batches(train_ds), seed=run.seed,
            num_shards=data.num_shards, shard_index=data.shard_index,
            fields=fields)
        valid_iter = (EpochIterator(valid_ds, make_batches(valid_ds),
                                    seed=run.seed, shuffle=False,
                                    fields=fields)
                      if valid_ds else None)

        model = HubertModel(mcfg)
        opt: OptimConfig = cfg["optim"]
        tx = build_optimizer(
            opt.name, opt.lr, opt.schedule, opt.warmup_steps, mcfg.d_model,
            opt.weight_decay, (opt.b1, opt.b2), opt.eps, opt.grad_clip)
        phase, key, mode = run.best_metric.split(".")
        trainer = Trainer(
            model, tx, out,
            options=TrainerOptions(
                max_epoch=run.max_epoch, patience=run.patience,
                keep_nbest=run.keep_nbest, best_metric=(phase, key, mode),
                log_interval=run.log_interval, seed=run.seed,
                resume=run.resume),
            device=dev, batch_arg_names=HUBERT_BATCH_KEYS)
        state = trainer.init_state()
        state = trainer.run(state, train_iter, valid_iter)
        logger.info("training finished: %s", out)
        return state, trainer, model
