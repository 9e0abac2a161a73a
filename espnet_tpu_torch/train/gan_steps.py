"""GAN training steps: vocoders, VITS and JETS (port of
espnet_tpu/train/gan_steps.py).

Behavioral spec: reference `espnet2/train/gan_trainer.py:52` with the
HiFiGAN criteria (`espnet2/gan_tts/hifigan/loss.py`), as the JAX package
fuses them into one step: first the discriminator is updated on the
detached fake (least-squares real/fake loss), then the generator's loss
(adversarial + feature matching + mel L1, plus the model's own terms) is
taken against the UPDATED discriminator. The JAX step applies the
generator twice with the same draws; here one forward serves both halves
(its output detached for the first).

`GANTrainState` holds both modules' parameters as flat float32 vectors
(`train/optim.py` `flatten_parameters_`) with one `FlatAdam` state each:
optax chain(clip_by_global_norm, adam(b1, b2)) as the JAX tasks build it
(eps 1e-8). Its `rng` (a torch generator) draws the noise of Parallel
WaveGAN and StyleMelGAN, VITS's posterior noise, the segment starts and
dropout. A test passes `draws` instead (the JAX step's own draws: `noise`,
or `eps` and `starts`), which also turns dropout off.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from espnet_tpu_torch.models.tts.hifigan import (
    discriminator_adversarial_loss, feature_match_loss,
    generator_adversarial_loss, mel_spectrogram_loss)
from espnet_tpu_torch.train.optim import (FlatAdam, flat_grads,
                                          flatten_parameters_)
from espnet_tpu_torch.train.schedulers import constant_schedule


def gan_optimizer(lr: float, b1: float = 0.8, b2: float = 0.99,
                  grad_clip: float = 5.0) -> FlatAdam:
    """optax chain(clip_by_global_norm(grad_clip), adam(lr, b1, b2))."""
    return FlatAdam(sched=constant_schedule(lr), b1=b1, b2=b2, eps=1e-8,
                    grad_clip=grad_clip)


class GANTrainState:
    """Both modules (their parameters made views of one flat vector each),
    both optimizer states, the step count and the generator of draws."""

    def __init__(self, generator: nn.Module, discriminator: nn.Module,
                 gen_opt: FlatAdam, disc_opt: FlatAdam,
                 rng: Optional[torch.Generator] = None):
        self.generator, self.discriminator = generator, discriminator
        self.gen_opt, self.disc_opt = gen_opt, disc_opt
        self.gen_flat = flatten_parameters_(generator)
        self.disc_flat = flatten_parameters_(discriminator)
        self.gen_state = gen_opt.init(self.gen_flat)
        self.disc_state = disc_opt.init(self.disc_flat)
        self.step = 0
        self.rng = rng if rng is not None else torch.Generator(
            device=self.gen_flat.device).manual_seed(0)

    def state_dict(self) -> Dict:
        return {"step": self.step,
                "generator": self.generator.state_dict(),
                "discriminator": self.discriminator.state_dict(),
                "gen_opt": dict(self.gen_state),
                "disc_opt": dict(self.disc_state),
                "rng": self.rng.get_state()}

    def load_state_dict(self, blob: Dict) -> None:
        with torch.no_grad():
            self.generator.load_state_dict(blob["generator"])
            self.discriminator.load_state_dict(blob["discriminator"])
            for own, new in ((self.gen_state, blob["gen_opt"]),
                             (self.disc_state, blob["disc_opt"])):
                for k, v in new.items():
                    own[k].copy_(v)
        self.step = int(blob["step"])
        if "rng" in blob:
            self.rng.set_state(blob["rng"])


@dataclasses.dataclass(frozen=True)
class GANLossWeights:
    adv: float = 1.0
    feat_match: float = 2.0
    mel: float = 45.0
    stft: float = 0.0
    fs: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 80


def _update(module, flat, opt, opt_state):
    grad_norm, _ = opt.apply_(flat, flat_grads(module), opt_state)
    module.zero_grad(set_to_none=True)
    return grad_norm


def _discriminator_update(state: GANTrainState, real, fake):
    """One discriminator step on (B, T, 1) real and detached fake audio;
    returns (loss, real part, fake part)."""
    disc = state.discriminator
    disc.zero_grad(set_to_none=True)
    lr, lf = discriminator_adversarial_loss(disc(real), disc(fake.detach()))
    loss = lr + lf
    loss.backward()
    _update(disc, state.disc_flat, state.disc_opt, state.disc_state)
    return loss.detach(), lr.detach(), lf.detach()


def _adversarial_terms(state: GANTrainState, real, fake):
    """(adversarial, feature matching) of fake against the (updated)
    discriminator; the discriminator takes no gradient."""
    disc = state.discriminator
    disc.requires_grad_(False)
    try:
        fake_outs = disc(fake)
        with torch.no_grad():
            real_outs = disc(real)
        return (generator_adversarial_loss(fake_outs),
                feature_match_loss(real_outs, fake_outs))
    finally:
        disc.requires_grad_(True)


def _generator_update(state: GANTrainState, loss):
    state.generator.zero_grad(set_to_none=True)
    loss.backward()
    _update(state.generator, state.gen_flat, state.gen_opt, state.gen_state)
    state.step += 1


def make_gan_train_step(weights: GANLossWeights = GANLossWeights()
                        ) -> Callable:
    """step(state, mel (B, T, M), wav (B, N), draws=None) -> stats."""
    w = weights

    def step(state: GANTrainState, mel, wav, draws=None):
        gen = state.generator
        real = wav[:, :, None]
        if draws is not None:
            fake = gen(mel, noise=draws.get("noise"))
        else:
            fake = gen(mel, generator=state.rng)
        n, t = real.shape[1], fake.shape[1]
        fake = fake[:, :n] if t >= n else nn.functional.pad(
            fake, (0, 0, 0, n - t))
        d_loss, d_real, d_fake = _discriminator_update(state, real, fake)
        adv, fm = _adversarial_terms(state, real, fake)
        mel_l1 = mel_spectrogram_loss(wav, fake[..., 0], w.fs, w.n_fft,
                                      w.hop_length, w.n_mels)
        loss = w.adv * adv + w.feat_match * fm + w.mel * mel_l1
        if w.stft > 0.0:
            from espnet_tpu_torch.models.tts.vocoders import (
                multi_resolution_stft_loss)

            loss = loss + w.stft * multi_resolution_stft_loss(
                fake[..., 0], wav)
        _generator_update(state, loss)
        return {"loss": loss.detach(), "generator_adv_loss": adv.detach(),
                "feat_match_loss": fm.detach(), "mel_loss": mel_l1.detach(),
                "discriminator_loss": d_loss, "disc_real_loss": d_real,
                "disc_fake_loss": d_fake}

    return step


def _masked_mse(pred, target, mask):
    return ((pred - target) ** 2 * mask).sum() / mask.sum().clamp(min=1.0)


def make_vits_train_step(*, hop_length: int, upsample: int,
                         lambda_adv: float = 1.0, lambda_fm: float = 2.0,
                         lambda_mel: float = 45.0, lambda_kl: float = 1.0,
                         lambda_dur: float = 1.0, mel_fs: int = 16000,
                         mel_n_fft: int = 1024, mel_bins: int = 80
                         ) -> Callable:
    """step(state, tokens, tlens, spec, slens, wav, draws=None) -> stats;
    `draws`: {"eps": posterior noise (B, T, C), "starts": (B,)}."""
    from espnet_tpu_torch.models.tts.vits import (slice_wav_segments,
                                                  vits_kl_loss)

    def step(state: GANTrainState, tokens, tlens, spec, slens, wav,
             draws=None):
        gen = state.generator
        seg_samples = gen.config.segment_frames * upsample
        if draws is not None:
            o = gen(tokens, tlens, spec, slens, eps=draws["eps"],
                    starts=draws["starts"])
        else:
            o = gen(tokens, tlens, spec, slens, generator=state.rng)
        real = slice_wav_segments(wav, o["seg_starts"], seg_samples,
                                  hop_length)
        d_loss, _, _ = _discriminator_update(state, real[:, :, None],
                                             o["wav_seg"][:, :, None])
        adv, fm = _adversarial_terms(state, real[:, :, None],
                                     o["wav_seg"][:, :, None])
        mel = mel_spectrogram_loss(real, o["wav_seg"], mel_fs, mel_n_fft,
                                   hop_length, mel_bins)
        kl = vits_kl_loss(o["z_p"], o["m_p_exp"], o["logs_p_exp"],
                          o["logs_q"], o["feat_mask"])
        dur = _masked_mse(o["log_dur_pred"], o["log_dur_tgt"],
                          o["text_mask"])
        loss = (lambda_adv * adv + lambda_fm * fm + lambda_mel * mel
                + lambda_kl * kl + lambda_dur * dur)
        _generator_update(state, loss)
        return {"loss": loss.detach(), "generator_adv_loss": adv.detach(),
                "feat_match_loss": fm.detach(), "mel_loss": mel.detach(),
                "kl_loss": kl.detach(), "dur_loss": dur.detach(),
                "discriminator_loss": d_loss}

    return step


def make_jets_train_step(*, hop_length: int, lambda_adv: float = 1.0,
                         lambda_fm: float = 2.0, lambda_mel: float = 45.0,
                         lambda_var: float = 1.0, lambda_align: float = 2.0,
                         mel_fs: int = 16000, mel_n_fft: int = 1024,
                         mel_bins: int = 80) -> Callable:
    """step(state, tokens, tlens, feats, flens, pitch, energy, wav,
    draws=None) -> stats; `draws`: {"starts": (B,)}."""
    from espnet_tpu_torch.models.tts.jets import forward_sum_loss
    from espnet_tpu_torch.models.tts.vits import slice_wav_segments

    def step(state: GANTrainState, tokens, tlens, feats, flens, pitch,
             energy, wav, draws=None):
        gen = state.generator
        seg_samples = gen.config.segment_frames * gen.upsample_factor
        if draws is not None:
            o = gen(tokens, tlens, feats, flens, pitch, energy,
                    starts=draws["starts"])
        else:
            o = gen(tokens, tlens, feats, flens, pitch, energy,
                    generator=state.rng)
        real = slice_wav_segments(wav, o["seg_starts"], seg_samples,
                                  hop_length)
        d_loss, _, _ = _discriminator_update(state, real[:, :, None],
                                             o["wav_seg"][:, :, None])
        adv, fm = _adversarial_terms(state, real[:, :, None],
                                     o["wav_seg"][:, :, None])
        mel = mel_spectrogram_loss(real, o["wav_seg"], mel_fs, mel_n_fft,
                                   hop_length, mel_bins)
        tm = o["text_mask"]
        dur = _masked_mse(o["d_pred"], torch.log(o["durations"] + 1.0), tm)
        pit = _masked_mse(o["p_pred"], o["p_tgt"], tm)
        ene = _masked_mse(o["e_pred"], o["e_tgt"], tm)
        align = forward_sum_loss(o["log_p_attn"], tlens, flens,
                                 use_kernels=gen.use_kernels)
        loss = (lambda_adv * adv + lambda_fm * fm + lambda_mel * mel
                + lambda_var * (dur + pit + ene) + lambda_align * align)
        _generator_update(state, loss)
        return {"loss": loss.detach(), "generator_adv_loss": adv.detach(),
                "feat_match_loss": fm.detach(), "mel_loss": mel.detach(),
                "duration_loss": dur.detach(), "pitch_loss": pit.detach(),
                "energy_loss": ene.detach(),
                "forward_sum_loss": align.detach(),
                "discriminator_loss": d_loss}

    return step
