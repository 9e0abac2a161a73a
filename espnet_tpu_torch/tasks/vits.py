"""VITS end-to-end text-to-wave task (port of espnet_tpu/tasks/vits.py).

Behavioral spec: reference `espnet2/tasks/gan_tts.py` with
`espnet2/gan_tts/vits/vits.py` under the GAN trainer. Data: the TTS
layout (wav.scp + text), each wave cut to `max_seconds` and to whole hops;
the linear spectrogram the posterior encoder reads is computed on the
device. The sections, fields and defaults are the JAX task's. As in JAX,
the whole corpus pads to one (token, sample) slab and each step draws
`batch_size` utterances with numpy's `RandomState(seed).choice`.

Each epoch writes `generator.msgpack` and `discriminator.msgpack` in the
JAX layout and the port's resume state `checkpoint.pt`; `tokens.txt` is
the experiment's token list, as the JAX task writes it.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.tasks.abs_task import AbsTask, RunConfig
from espnet_tpu_torch.tasks.vocoder import (VocoderOptimConfig, gan_state,
                                            log_epoch, resume_gan,
                                            save_gan_epoch)

logger = logging.getLogger("espnet_tpu")


@dataclasses.dataclass(frozen=True)
class VITSDataConfig:
    train_dir: str = ""
    fs: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    token_type: str = "char"
    token_list: str = ""
    batch_size: int = 8
    max_seconds: float = 6.0
    steps_per_epoch: int = 0     # 0 = one pass over the corpus


@dataclasses.dataclass(frozen=True)
class VITSModelSection:
    channels: int = 192
    text_heads: int = 2
    text_d_ff: int = 768
    text_layers: int = 6
    posterior_layers: int = 16
    flows: int = 4
    flow_layers: int = 4
    decoder_channels: int = 512
    upsample_scales: tuple = (8, 8, 2, 2)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    segment_frames: int = 32
    dropout_rate: float = 0.1
    lambda_mel: float = 45.0
    lambda_kl: float = 1.0
    lambda_dur: float = 1.0
    lambda_fm: float = 2.0


VITSOptimConfig = VocoderOptimConfig


def load_text_corpus(data, out: Path):
    """(tokenizer, converter, [(token ids, wave)]) of a TTS data dir: the
    token list from `data.token_list`, else the experiment's `tokens.txt`
    (built from the texts and written when missing); each wave cut to
    `max_seconds` and to whole hops, as the JAX tasks cut it."""
    from espnet_tpu_torch.data.fileio import SoundScpReader, read_2column_text
    from espnet_tpu_torch.data.tokenizer import (TokenIDConverter,
                                                 build_token_list,
                                                 build_tokenizer)

    texts = read_2column_text(Path(data.train_dir) / "text")
    tokenizer = build_tokenizer(data.token_type)
    tok_path = Path(data.token_list) if data.token_list else out / "tokens.txt"
    if tok_path.exists():
        conv = TokenIDConverter.from_file(tok_path)
    else:
        conv = TokenIDConverter(build_token_list(list(texts.values()),
                                                 tokenizer))
        conv.save(tok_path)
    reader = SoundScpReader(Path(data.train_dir) / "wav.scp")
    max_samples = int(data.max_seconds * data.fs)
    max_samples -= max_samples % data.hop_length
    items = []
    for k in reader.keys():
        wav, _ = reader[k]
        if wav.ndim > 1:
            wav = wav[:, 0]
        wav = wav.astype(np.float32)[:max_samples]
        n = len(wav) - len(wav) % data.hop_length
        ids = conv.tokens2ids(tokenizer.text2tokens(texts[k]))
        items.append((np.asarray(ids, np.int32), wav[:n]))
    return tokenizer, conv, items


def slab_sizes(items, seg_samples: int, data) -> Tuple[int, int]:
    """(tokens, samples) of the corpus slab: the longest text, and the
    longest wave but at least one segment plus n_fft, in whole hops."""
    u_max = max(len(i[0]) for i in items)
    n_max = max(max(len(i[1]) for i in items), seg_samples + data.n_fft)
    return u_max, n_max + (-n_max) % data.hop_length


def draw_batch(items: List, idx, u_max: int, n_max: int):
    """Tokens, token lengths, waves and wave lengths of items `idx`, padded
    to the slab (numpy)."""
    bsz = len(idx)
    toks = np.zeros((bsz, u_max), np.int64)
    tlens = np.zeros((bsz,), np.int64)
    wavs = np.zeros((bsz, n_max), np.float32)
    wlens = np.zeros((bsz,), np.int64)
    for j, ii in enumerate(idx):
        ids, wav = items[ii]
        toks[j, :len(ids)] = ids
        tlens[j] = len(ids)
        wavs[j, :len(wav)] = wav
        wlens[j] = len(wav)
    return toks, tlens, wavs, wlens


def linear_spectrogram(wav: torch.Tensor, n_fft: int, hop: int):
    """|STFT| (B, frames, n_fft/2 + 1), the posterior encoder's input."""
    from espnet_tpu_torch.ops.stft import power_spectrum, stft

    return power_spectrum(*stft(wav, n_fft, hop)) ** 0.5


def run_gan_epochs(name: str, run: RunConfig, data, items, out: Path,
                   state, step_once) -> None:
    """The JAX tasks' loop: `steps_per_epoch` steps an epoch (0: one pass),
    each on `batch_size` items drawn with RandomState(seed).choice and
    given to `step_once(idx) -> stats`; both modules and the resume state
    saved each epoch. A resumed run replays the finished epochs' draws."""
    first = resume_gan(out, state, run.resume) + 1
    np_rng = np.random.RandomState(run.seed)
    steps = data.steps_per_epoch or max(1, len(items) // data.batch_size)
    for epoch in range(1, run.max_epoch + 1):
        agg: Dict[str, float] = {}
        for _ in range(steps):
            idx = np_rng.choice(len(items), data.batch_size)
            if epoch < first:
                continue
            for k, v in step_once(idx).items():
                agg[k] = agg.get(k, 0.0) + float(v)
        if epoch < first:
            continue
        log_epoch(name, epoch, agg, steps)
        save_gan_epoch(out, state, epoch)
    logger.info("%s training finished: %s", name, out)


class VITSTask(AbsTask):
    name = "vits"
    sections = {
        "run": RunConfig,
        "optim": VITSOptimConfig,
        "data": VITSDataConfig,
        "model": VITSModelSection,
    }

    @classmethod
    def build_models(cls, model_cfg: VITSModelSection, data: VITSDataConfig,
                     vocab_size: int):
        from espnet_tpu_torch.models.tts.hifigan import (
            HiFiGANMultiDiscriminator)
        from espnet_tpu_torch.models.tts.vits import (VITSConfig,
                                                      VITSGenerator)

        if int(np.prod(model_cfg.upsample_scales)) != data.hop_length:
            raise ValueError(
                f"prod(upsample_scales)={np.prod(model_cfg.upsample_scales)} "
                f"must equal hop_length={data.hop_length}")
        gen = VITSGenerator(VITSConfig(
            vocab_size=vocab_size, channels=model_cfg.channels,
            text_heads=model_cfg.text_heads, text_d_ff=model_cfg.text_d_ff,
            text_layers=model_cfg.text_layers,
            spec_dim=data.n_fft // 2 + 1,
            posterior_layers=model_cfg.posterior_layers,
            flows=model_cfg.flows, flow_layers=model_cfg.flow_layers,
            decoder_channels=model_cfg.decoder_channels,
            upsample_scales=tuple(model_cfg.upsample_scales),
            resblock_kernel_sizes=tuple(model_cfg.resblock_kernel_sizes),
            n_fft=data.n_fft, hop_length=data.hop_length,
            segment_frames=model_cfg.segment_frames,
            dropout_rate=model_cfg.dropout_rate))
        return gen, HiFiGANMultiDiscriminator()

    @classmethod
    def run(cls, cfg: Dict[str, Any], device="cuda"):
        from espnet_tpu_torch.train.gan_steps import make_vits_train_step

        dev = resolve_device(device)
        run: RunConfig = cfg["run"]
        data: VITSDataConfig = cfg["data"]
        mc: VITSModelSection = cfg["model"]
        out = Path(run.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        cls.dump_config(cfg, out)
        _, conv, items = load_text_corpus(data, out)
        gen, disc = cls.build_models(mc, data, len(conv))
        upsample = int(np.prod(mc.upsample_scales))
        u_max, n_max = slab_sizes(items, mc.segment_frames * upsample, data)
        state = gan_state(gen, disc, cfg["optim"], run.seed, dev)
        step_fn = make_vits_train_step(
            hop_length=data.hop_length, upsample=upsample,
            lambda_fm=mc.lambda_fm, lambda_mel=mc.lambda_mel,
            lambda_kl=mc.lambda_kl, lambda_dur=mc.lambda_dur,
            mel_fs=data.fs, mel_n_fft=data.n_fft)

        def step_once(idx):
            toks, tlens, wavs, wlens = (torch.from_numpy(a).to(dev) for a in
                                        draw_batch(items, idx, u_max, n_max))
            spec = linear_spectrogram(wavs, data.n_fft, data.hop_length)
            return step_fn(state, toks, tlens, spec,
                           wlens // data.hop_length + 1, wavs)

        run_gan_epochs("vits", run, data, items, out, state, step_once)
        return state, gen
