"""GAN vocoder training task (port of espnet_tpu/tasks/vocoder.py).

Behavioral spec: reference `espnet2/train/gan_trainer.py:52` over the
`espnet2/gan_tts/` vocoders, with segment-level training (random crops of
`segment_size` samples) as parallel_wavegan-style recipes do. Data: a
wav.scp dir; the mels are the frontend's log-mel (fmin 0, no fmax) of each
crop, the features the TTS models produce. The sections, fields and
defaults are the JAX task's, so a command line or a config.yaml means the
same run in both packages.

The crops are drawn as the JAX task draws them, from numpy's
`RandomState(seed)`: per batch item an utterance index, then a start.
Each epoch writes `generator.msgpack` and `discriminator.msgpack` (the
JAX package's layout, which its `tts_inference --vocoder_dir` loads) and
the port's resume state `checkpoint.pt` (both modules, both optimizer
states, the epoch); with `--run.resume` (the default) a run continues from
it. `convert.gan_state_to_jax` / `load_jax_gan_state` carry such a state
to and from the JAX package's `GANTrainState`.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.tasks.abs_task import AbsTask, RunConfig

logger = logging.getLogger("espnet_tpu")


@dataclasses.dataclass(frozen=True)
class VocoderDataConfig:
    train_dir: str = ""
    fs: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 80
    batch_size: int = 16
    segment_size: int = 8192
    steps_per_epoch: int = 200


@dataclasses.dataclass(frozen=True)
class VocoderModelConfig:
    # hifigan | melgan | multiband_melgan | parallel_wavegan | style_melgan
    generator_type: str = "hifigan"
    # "" = the generator's partner; or hifigan_multi | melgan_multi | pwg |
    # style_melgan
    discriminator_type: str = ""
    channels: int = 512
    kernel_size: int = 7
    upsample_scales: tuple = (8, 8, 2, 2)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    pwg_layers: int = 30
    pwg_stacks: int = 3
    style_channels: int = 64
    lambda_feat_match: float = 2.0
    lambda_mel: float = 45.0
    lambda_stft: float = 0.0


@dataclasses.dataclass(frozen=True)
class VocoderOptimConfig:
    gen_lr: float = 2.0e-4
    disc_lr: float = 2.0e-4
    b1: float = 0.8
    b2: float = 0.99
    grad_clip: float = 5.0


def crop(wav: np.ndarray, seg: int, rng: np.random.RandomState) -> np.ndarray:
    start = rng.randint(0, len(wav) - seg + 1)
    return wav[start:start + seg]


def gan_state(gen, disc, opt: VocoderOptimConfig, seed: int, device):
    """A fresh `GANTrainState`: both modules drawn by `init_random_` from
    `seed`, the optimizers the task's, draws from a generator seeded
    seed + 2."""
    from espnet_tpu_torch.models.asr import init_random_
    from espnet_tpu_torch.train.gan_steps import GANTrainState, gan_optimizer

    init_random_(gen, torch.Generator().manual_seed(seed))
    init_random_(disc, torch.Generator().manual_seed(seed + 1))
    gen.to(device).train()
    disc.to(device).train()
    rng = torch.Generator(device=device).manual_seed(seed + 2)
    return GANTrainState(
        gen, disc, gan_optimizer(opt.gen_lr, opt.b1, opt.b2, opt.grad_clip),
        gan_optimizer(opt.disc_lr, opt.b1, opt.b2, opt.grad_clip), rng)


def save_gan_epoch(out: Path, state, epoch: int) -> None:
    """generator.msgpack and discriminator.msgpack in the JAX layout, and
    the port's resume state checkpoint.pt."""
    from espnet_tpu_torch.convert import model_params
    from espnet_tpu_torch.train.msgpack_io import save_tree

    save_tree(out / "generator.msgpack", model_params(state.generator))
    save_tree(out / "discriminator.msgpack",
              model_params(state.discriminator))
    torch.save({"epoch": epoch, "state": state.state_dict()},
               out / "checkpoint.pt")


def resume_gan(out: Path, state, resume: bool) -> int:
    """The epoch that `checkpoint.pt` ends, loaded into `state`, or 0."""
    path = out / "checkpoint.pt"
    if not (resume and path.exists()):
        return 0
    blob = torch.load(path, map_location=state.gen_flat.device,
                      weights_only=True)
    state.load_state_dict(blob["state"])
    logger.info("resumed %s at epoch %d", path, blob["epoch"])
    return int(blob["epoch"])


def log_epoch(name: str, epoch: int, agg: Dict[str, float], n: int) -> None:
    msg = ", ".join(f"{k}={v / n:.4g}" for k, v in sorted(agg.items()))
    logger.info("%s epoch %d: %s", name, epoch, msg)


class VocoderTask(AbsTask):
    name = "vocoder"
    sections = {
        "run": RunConfig,
        "optim": VocoderOptimConfig,
        "data": VocoderDataConfig,
        "model": VocoderModelConfig,
    }

    @classmethod
    def build_models(cls, model_cfg: VocoderModelConfig, n_mels: int):
        """(generator, discriminator) as the JAX task builds them."""
        from espnet_tpu_torch.models.tts.hifigan import (
            HiFiGANGenerator, HiFiGANMultiDiscriminator)
        from espnet_tpu_torch.models.tts.vocoders import (
            MelGANGenerator, MelGANMultiScaleDiscriminator,
            ParallelWaveGANDiscriminator, ParallelWaveGANGenerator,
            StyleMelGANDiscriminator, StyleMelGANGenerator)

        g = model_cfg.generator_type
        if g == "hifigan":
            gen = HiFiGANGenerator(
                in_channels=n_mels, channels=model_cfg.channels,
                kernel_size=model_cfg.kernel_size,
                upsample_scales=tuple(model_cfg.upsample_scales),
                resblock_kernel_sizes=tuple(model_cfg.resblock_kernel_sizes))
            default_disc = "hifigan_multi"
        elif g in ("melgan", "multiband_melgan"):
            gen = MelGANGenerator(
                in_channels=n_mels,
                out_channels=4 if g == "multiband_melgan" else 1,
                channels=model_cfg.channels,
                kernel_size=model_cfg.kernel_size,
                upsample_scales=tuple(model_cfg.upsample_scales))
            default_disc = "melgan_multi"
        elif g == "parallel_wavegan":
            gen = ParallelWaveGANGenerator(
                in_channels=n_mels, layers=model_cfg.pwg_layers,
                stacks=model_cfg.pwg_stacks,
                upsample_scales=tuple(model_cfg.upsample_scales))
            default_disc = "pwg"
        elif g == "style_melgan":
            gen = StyleMelGANGenerator(aux_channels=n_mels,
                                       channels=model_cfg.style_channels)
            default_disc = "style_melgan"
        else:
            raise ValueError(f"unknown generator_type {g}")
        d = model_cfg.discriminator_type or default_disc
        discs = {"hifigan_multi": HiFiGANMultiDiscriminator,
                 "melgan_multi": MelGANMultiScaleDiscriminator,
                 "pwg": ParallelWaveGANDiscriminator,
                 "style_melgan": StyleMelGANDiscriminator}
        if d not in discs:
            raise ValueError(f"unknown discriminator_type {d}")
        return gen, discs[d]()

    @classmethod
    def run(cls, cfg: Dict[str, Any], device="cuda"):
        from espnet_tpu_torch.data.fileio import SoundScpReader
        from espnet_tpu_torch.ops.stft import log_mel_spectrogram
        from espnet_tpu_torch.train.gan_steps import (GANLossWeights,
                                                      make_gan_train_step)

        dev = resolve_device(device)
        run: RunConfig = cfg["run"]
        data: VocoderDataConfig = cfg["data"]
        model_cfg: VocoderModelConfig = cfg["model"]
        opt: VocoderOptimConfig = cfg["optim"]
        out = Path(run.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        cls.dump_config(cfg, out)

        gen, disc = cls.build_models(model_cfg, data.n_mels)
        if gen.upsample_factor != data.hop_length:
            logger.warning(
                "upsample factor %d != hop_length %d — generator output "
                "length will not match the mel grid", gen.upsample_factor,
                data.hop_length)
        seg = data.segment_size - data.segment_size % data.hop_length
        mel_frames = seg // data.hop_length

        reader = SoundScpReader(Path(data.train_dir) / "wav.scp")
        waves = []
        for k in reader.keys():
            w, _ = reader[k]
            if w.ndim > 1:
                w = w[:, 0]
            if len(w) >= seg + data.n_fft:
                waves.append(w.astype(np.float32))
        if not waves:
            raise ValueError(f"no utterance longer than segment_size={seg} "
                             f"in {data.train_dir}")
        logger.info("vocoder corpus: %d usable utterances", len(waves))

        state = gan_state(gen, disc, opt, run.seed, dev)
        first = resume_gan(out, state, run.resume) + 1
        step_fn = make_gan_train_step(GANLossWeights(
            adv=1.0, feat_match=model_cfg.lambda_feat_match,
            mel=model_cfg.lambda_mel, stft=model_cfg.lambda_stft,
            fs=data.fs, n_fft=data.n_fft, hop_length=data.hop_length,
            n_mels=data.n_mels))
        lens = torch.full((data.batch_size,), seg, dtype=torch.long,
                          device=dev)
        np_rng = np.random.RandomState(run.seed)
        for epoch in range(1, run.max_epoch + 1):
            agg: Dict[str, float] = {}
            for _ in range(data.steps_per_epoch):
                batch = np.stack([
                    crop(waves[np_rng.randint(len(waves))], seg, np_rng)
                    for _ in range(data.batch_size)])
                if epoch < first:  # replay the resumed epochs' crops
                    continue
                wav = torch.from_numpy(batch).to(dev)
                mel = log_mel_spectrogram(wav, lens, data.fs, data.n_fft,
                                          data.hop_length, None,
                                          data.n_mels)[0][:, :mel_frames]
                stats = step_fn(state, mel, wav)
                for k, v in stats.items():
                    agg[k] = agg.get(k, 0.0) + float(v)
            if epoch < first:
                continue
            log_epoch("vocoder", epoch, agg, data.steps_per_epoch)
            save_gan_epoch(out, state, epoch)
        logger.info("vocoder training finished: %s", out)
        return state, gen
