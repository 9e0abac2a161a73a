"""JETS end-to-end text-to-wave task (port of espnet_tpu/tasks/jets.py).

Behavioral spec: reference `espnet2/tasks/gan_tts.py` with the JETS model
(`espnet2/gan_tts/jets/jets.py`) under the GAN trainer. Data: the TTS
layout (wav.scp + text); the log-mel features, frame pitch and frame
energy are computed on the device (`ops/stft.py`, `ops/pitch.py`). The
corpus, batches, checkpoints and resume are the VITS task's
(`tasks/vits.py`); the sections, fields and defaults are the JAX task's.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.tasks.abs_task import AbsTask, RunConfig
from espnet_tpu_torch.tasks.vits import (draw_batch, load_text_corpus,
                                         run_gan_epochs, slab_sizes)
from espnet_tpu_torch.tasks.vocoder import VocoderOptimConfig, gan_state


@dataclasses.dataclass(frozen=True)
class JETSDataConfig:
    train_dir: str = ""
    fs: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 80
    token_type: str = "char"
    token_list: str = ""
    batch_size: int = 8
    max_seconds: float = 6.0
    steps_per_epoch: int = 0


@dataclasses.dataclass(frozen=True)
class JETSModelSection:
    adim: int = 256
    num_heads: int = 2
    d_ff: int = 1024
    encoder_layers: int = 4
    decoder_layers: int = 4
    decoder_channels: int = 512
    upsample_scales: tuple = (8, 8, 2, 2)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    segment_frames: int = 32
    dropout_rate: float = 0.1
    lambda_mel: float = 45.0
    lambda_fm: float = 2.0
    lambda_var: float = 1.0
    lambda_align: float = 2.0


JETSOptimConfig = VocoderOptimConfig


def jets_features(wav, wav_lens, data):
    """(log-mel (B, T, n_mels), frame lengths, pitch (B, T), energy (B, T))
    of a padded wave batch."""
    from espnet_tpu_torch.ops.pitch import autocorr_f0, frame_energy
    from espnet_tpu_torch.ops.stft import log_mel_spectrogram

    feats, flens = log_mel_spectrogram(wav, wav_lens, data.fs, data.n_fft,
                                       data.hop_length, None, data.n_mels)
    pitch = autocorr_f0(wav, data.fs, data.n_fft, data.hop_length)[0]
    energy = frame_energy(wav, data.n_fft, data.hop_length)
    t = feats.shape[1]
    return feats, flens, pitch[:, :t], energy[:, :t]


class JETSTask(AbsTask):
    name = "jets"
    sections = {
        "run": RunConfig,
        "optim": JETSOptimConfig,
        "data": JETSDataConfig,
        "model": JETSModelSection,
    }

    @classmethod
    def build_models(cls, model_cfg: JETSModelSection, data: JETSDataConfig,
                     vocab_size: int):
        from espnet_tpu_torch.models.tts.hifigan import (
            HiFiGANMultiDiscriminator)
        from espnet_tpu_torch.models.tts.jets import JETSConfig, JETSGenerator

        if int(np.prod(model_cfg.upsample_scales)) != data.hop_length:
            raise ValueError(
                f"prod(upsample_scales)={np.prod(model_cfg.upsample_scales)}"
                f" must equal hop_length={data.hop_length}")
        gen = JETSGenerator(JETSConfig(
            vocab_size=vocab_size, n_mels=data.n_mels, adim=model_cfg.adim,
            num_heads=model_cfg.num_heads, d_ff=model_cfg.d_ff,
            encoder_layers=model_cfg.encoder_layers,
            decoder_layers=model_cfg.decoder_layers,
            decoder_channels=model_cfg.decoder_channels,
            upsample_scales=tuple(model_cfg.upsample_scales),
            resblock_kernel_sizes=tuple(model_cfg.resblock_kernel_sizes),
            segment_frames=model_cfg.segment_frames,
            dropout_rate=model_cfg.dropout_rate))
        return gen, HiFiGANMultiDiscriminator()

    @classmethod
    def run(cls, cfg: Dict[str, Any], device="cuda"):
        from espnet_tpu_torch.train.gan_steps import make_jets_train_step

        dev = resolve_device(device)
        run: RunConfig = cfg["run"]
        data: JETSDataConfig = cfg["data"]
        mc: JETSModelSection = cfg["model"]
        out = Path(run.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        cls.dump_config(cfg, out)
        _, conv, items = load_text_corpus(data, out)
        gen, disc = cls.build_models(mc, data, len(conv))
        u_max, n_max = slab_sizes(items, mc.segment_frames * data.hop_length,
                                  data)
        state = gan_state(gen, disc, cfg["optim"], run.seed, dev)
        step_fn = make_jets_train_step(
            hop_length=data.hop_length, lambda_fm=mc.lambda_fm,
            lambda_mel=mc.lambda_mel, lambda_var=mc.lambda_var,
            lambda_align=mc.lambda_align, mel_fs=data.fs,
            mel_n_fft=data.n_fft, mel_bins=data.n_mels)

        def step_once(idx):
            toks, tlens, wavs, wlens = (torch.from_numpy(a).to(dev) for a in
                                        draw_batch(items, idx, u_max, n_max))
            feats, flens, pitch, energy = jets_features(wavs, wlens, data)
            return step_fn(state, toks, tlens, feats, flens, pitch, energy,
                           wavs)

        run_gan_epochs("jets", run, data, items, out, state, step_once)
        return state, gen
