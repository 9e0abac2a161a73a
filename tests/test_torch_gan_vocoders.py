"""The port's GAN vocoders (`ops/pqmf.py`, `models/tts/{hifigan,vocoders,
wavenet}.py`, `train/gan_steps.py` `make_gan_train_step`) against the JAX
package's, float32 on the CPU.

Every module runs on the JAX module's own parameters (flax's init, carried
by `convert.load_jax_params`) on numpy inputs from a seed. The noise of
Parallel WaveGAN and StyleMelGAN is drawn in numpy and given to both (the
JAX modules' `jax.random.normal` monkeypatched to return it); WaveNet's
sampling takes JAX's own uniforms, drawn with the JAX scan's key splits.
The GAN step runs with optax chain(clip, sgd) against the port's FlatSGD,
so that each parameter's update is its clipped gradient times the rate:
both optimizers' updates are compared leaf by leaf (1e-3 of the leaf's
largest update, with a floor), against the updated discriminator as the
step defines it. Tolerances: outputs and losses 1e-4 (absolute and
relative), 2e-4 through the deep generators and the STFT losses.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from espnet_tpu.models.tts import hifigan as jhg
from espnet_tpu.models.tts import vocoders as jvoc
from espnet_tpu.models.tts import wavenet as jwn
from espnet_tpu.ops import pqmf as jpqmf
from espnet_tpu.train import gan_steps as jgan
from espnet_tpu_torch.convert import (jax_params_to_state_dict,
                                      load_jax_params, model_params)
from espnet_tpu_torch.models import layers as tlayers
from espnet_tpu_torch.models.tts import hifigan as thg
from espnet_tpu_torch.models.tts import vocoders as tvoc
from espnet_tpu_torch.models.tts import wavenet as twn
from espnet_tpu_torch.ops import pqmf as tpqmf
from espnet_tpu_torch.train import gan_steps as tgan
from espnet_tpu_torch.train.optim import build_optimizer

TOL = 1e-4
DEEP_TOL = 2e-4
UPD_TOL = 1e-3
UPD_FLOOR = 1e-5  # a leaf with updates below this has a zero gradient


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _pair(jmod, tmod, *args, rngs=None):
    """flax init of `jmod` on args; the params loaded into `tmod`."""
    params = jax.device_get(jmod.init(
        rngs if rngs is not None else jax.random.PRNGKey(0), *args)["params"])
    load_jax_params(tmod, params)
    return params


def _outs_close(got, want, tol=TOL):
    """[(score, feature maps)] of a discriminator, both packages."""
    assert len(got) == len(want)
    for (gs, gf), (ws, wf) in zip(got, want):
        _close(gs, ws, tol)
        assert len(gf) == len(wf)
        for a, b in zip(gf, wf):
            assert tuple(a.shape) == tuple(b.shape)
            _close(a, b, tol)


@pytest.fixture
def fixed_normal(monkeypatch):
    """jax.random.normal returning the numpy draws given to `set`."""
    box = {}

    def normal(key, shape, dtype=jnp.float32):
        draw = box["draw"]
        assert tuple(draw.shape) == tuple(shape)
        return jnp.asarray(draw, dtype)

    monkeypatch.setattr(jax.random, "normal", normal)
    return box


# --- PQMF and the flax-equivalent layers ----------------------------------

@pytest.mark.parametrize("bands", [2, 4, 8])
def test_pqmf_banks_analysis_and_synthesis(bands):
    ja, js = jpqmf.pqmf_banks(bands)
    ta, ts = tpqmf.pqmf_banks(bands)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(ts, js)
    assert tpqmf._optimal_cutoff(bands, 62, 9.0) == \
        jpqmf._optimal_cutoff(bands, 62, 9.0)
    rng = np.random.RandomState(bands)
    x = rng.randn(2, 203).astype(np.float32)
    _close(tpqmf.pqmf_analysis(_t(x), bands),
           jpqmf.pqmf_analysis(jnp.asarray(x), bands))
    y = rng.randn(2, 17, bands).astype(np.float32)
    _close(tpqmf.pqmf_synthesis(_t(y), bands),
           jpqmf.pqmf_synthesis(jnp.asarray(y), bands))


@pytest.mark.parametrize("kernel,stride,dilation,groups,length", [
    (41, 2, 1, 4, 37), (41, 4, 1, 4, 64), (4, 1, 1, 1, 9), (2, 1, 1, 1, 9),
    (5, 1, 3, 1, 17), (21, 2, 1, 2, 33)])
def test_same_conv_matches_flax(kernel, stride, dilation, groups, length):
    """XLA's "SAME" split (floor half left), strided, dilated, grouped."""
    x = np.random.RandomState(0).randn(2, length, 8).astype(np.float32)
    m = fnn.Conv(8, (kernel,), strides=(stride,), kernel_dilation=(dilation,),
                 padding="SAME", feature_group_count=groups)
    t = tlayers.SameConv1d(8, 8, kernel, stride, dilation, groups)
    p = _pair(m, t, jnp.asarray(x))
    _close(t(_t(x)), m.apply({"params": p}, jnp.asarray(x)))


@pytest.mark.parametrize("stride", [2, 3, 4, 5, 8])
def test_conv_transpose_matches_flax(stride):
    """flax's ConvTranspose (kernel 2s, kernel not flipped, "SAME")."""
    x = np.random.RandomState(stride).randn(2, 7, 6).astype(np.float32)
    m = fnn.ConvTranspose(5, (2 * stride,), strides=(stride,),
                          padding="SAME")
    t = tlayers.ConvTranspose1d(6, 5, 2 * stride, stride)
    p = _pair(m, t, jnp.asarray(x))
    want = m.apply({"params": p}, jnp.asarray(x))
    assert want.shape == (2, 7 * stride, 5)
    _close(t(_t(x)), want)


@pytest.mark.parametrize("length", [9, 10, 33])
def test_avg_pool_matches_flax(length):
    x = np.random.RandomState(length).randn(2, length, 3).astype(np.float32)
    _close(tlayers.avg_pool_same(_t(x), 4, 2),
           fnn.avg_pool(jnp.asarray(x), (4,), strides=(2,), padding="SAME"))


# --- HiFiGAN ---------------------------------------------------------------

HIFI = dict(in_channels=6, channels=16, kernel_size=7, upsample_scales=(4, 2),
            resblock_kernel_sizes=(3, 5),
            resblock_dilations=((1, 3, 5), (1, 3, 5)))


@pytest.mark.parametrize("global_cond", [False, True])
def test_hifigan_generator(global_cond):
    rng = np.random.RandomState(1)
    mel = rng.randn(2, 9, 6).astype(np.float32)
    g = rng.randn(2, 5).astype(np.float32) if global_cond else None
    jm = jhg.HiFiGANGenerator(**HIFI)
    tm = thg.HiFiGANGenerator(**HIFI, global_channels=5 if g is not None
                              else 0)
    args = (jnp.asarray(mel),) + ((jnp.asarray(g),) if g is not None else ())
    p = _pair(jm, tm, *args)
    want = jm.apply({"params": p}, *args)
    assert want.shape == (2, 72, 1)
    got = tm(_t(mel), None if g is None else _t(g))
    _close(got, want, DEEP_TOL)
    assert tm.upsample_factor == jm.upsample_factor == 8


def test_period_and_scale_discriminators():
    rng = np.random.RandomState(2)
    wav = rng.randn(2, 100, 1).astype(np.float32) * 0.5
    for period in (3, 7):  # 100 % 3 != 0: reflect padding
        jm = jhg.PeriodDiscriminator(period, channels=4, max_channels=16)
        tm = thg.PeriodDiscriminator(period, channels=4, max_channels=16)
        p = _pair(jm, tm, jnp.asarray(wav))
        _outs_close([tm(_t(wav))], [jm.apply({"params": p},
                                             jnp.asarray(wav))])
    jm = jhg.ScaleDiscriminator(channels=8, max_channels=32, max_groups=4)
    tm = thg.ScaleDiscriminator(channels=8, max_channels=32, max_groups=4)
    p = _pair(jm, tm, jnp.asarray(wav))
    _outs_close([tm(_t(wav))], [jm.apply({"params": p}, jnp.asarray(wav))])


def test_hifigan_multi_discriminator_at_its_width():
    """The task's discriminator as built (three scales of 128-1024
    channels, periods 2-11) on a short wave: the pooled scales too."""
    wav = np.random.RandomState(3).randn(1, 150, 1).astype(np.float32) * 0.3
    jm, tm = jhg.HiFiGANMultiDiscriminator(), thg.HiFiGANMultiDiscriminator()
    # 79M parameters: flax's init and apply jitted, not op by op
    p = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(wav))["params"])
    load_jax_params(tm, p)
    _outs_close(tm(_t(wav)), jax.jit(jm.apply)({"params": p},
                                               jnp.asarray(wav)))
    # the port's tree goes back to flax unchanged
    back = model_params(tm)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, p))


def test_gan_losses():
    rng = np.random.RandomState(4)

    def outs(seed):
        r = np.random.RandomState(seed)
        return [(r.randn(2, 7).astype(np.float32),
                 [r.randn(2, 5, 3).astype(np.float32) for _ in range(2)])
                for _ in range(3)]

    real, fake = outs(5), outs(6)

    def conv(o, fn):
        return [(fn(s), [fn(f) for f in fs]) for s, fs in o]

    jr, jf = conv(real, jnp.asarray), conv(fake, jnp.asarray)
    tr, tf = conv(real, _t), conv(fake, _t)
    _close(thg.generator_adversarial_loss(tf),
           jhg.generator_adversarial_loss(jf))
    for a, b in zip(thg.discriminator_adversarial_loss(tr, tf),
                    jhg.discriminator_adversarial_loss(jr, jf)):
        _close(a, b)
    _close(thg.feature_match_loss(tr, tf), jhg.feature_match_loss(jr, jf))
    x = rng.randn(2, 1200).astype(np.float32) * 0.3
    y = rng.randn(2, 1200).astype(np.float32) * 0.3
    _close(thg.mel_spectrogram_loss(_t(x), _t(y), 16000, 256, 64, 20),
           jhg.mel_spectrogram_loss(jnp.asarray(x), jnp.asarray(y), 16000,
                                    256, 64, 20), DEEP_TOL)
    res = ((256, 30, 120), (128, 16, 64))
    for a, b in zip(tvoc.stft_loss(_t(x), _t(y), 256, 30, 120),
                    jvoc.stft_loss(jnp.asarray(x), jnp.asarray(y), 256, 30,
                                   120)):
        _close(a, b, DEEP_TOL)
    _close(tvoc.multi_resolution_stft_loss(_t(x), _t(y), res),
           jvoc.multi_resolution_stft_loss(jnp.asarray(x), jnp.asarray(y),
                                           res), DEEP_TOL)


# --- MelGAN, Parallel WaveGAN, StyleMelGAN -------------------------------

@pytest.mark.parametrize("bands", [1, 4])
def test_melgan_generator_and_multiband(bands):
    mel = np.random.RandomState(7).randn(2, 6, 5).astype(np.float32)
    kw = dict(in_channels=5, out_channels=bands, channels=16,
              upsample_scales=(2, 2), stacks=2)
    jm, tm = jvoc.MelGANGenerator(**kw), tvoc.MelGANGenerator(**kw)
    p = _pair(jm, tm, jnp.asarray(mel))
    want = jm.apply({"params": p}, jnp.asarray(mel))
    assert want.shape == (2, 6 * 4 * bands, 1)
    _close(tm(_t(mel)), want, DEEP_TOL)
    assert tm.upsample_factor == jm.upsample_factor


def test_melgan_multiscale_discriminator():
    wav = np.random.RandomState(8).randn(2, 300, 1).astype(np.float32) * 0.3
    jm = jvoc.MelGANMultiScaleDiscriminator(scales=2, channels=4)
    tm = tvoc.MelGANMultiScaleDiscriminator(scales=2, channels=4)
    p = _pair(jm, tm, jnp.asarray(wav))
    _outs_close(tm(_t(wav)), jm.apply({"params": p}, jnp.asarray(wav)))


def test_parallel_wavegan(fixed_normal):
    rng = np.random.RandomState(9)
    mel = rng.randn(2, 5, 6).astype(np.float32)
    fixed_normal["draw"] = rng.randn(2, 20, 1).astype(np.float32)
    kw = dict(in_channels=6, layers=4, stacks=2, residual_channels=8,
              gate_channels=8, skip_channels=8, upsample_scales=(2, 2))
    jm, tm = (jvoc.ParallelWaveGANGenerator(**kw),
              tvoc.ParallelWaveGANGenerator(**kw))
    key = jax.random.PRNGKey(0)
    p = _pair(jm, tm, jnp.asarray(mel), rngs={"params": key, "noise": key})
    want = jm.apply({"params": p}, jnp.asarray(mel), rngs={"noise": key})
    _close(tm(_t(mel), noise=_t(fixed_normal["draw"])), want)
    wav = rng.randn(2, 40, 1).astype(np.float32)
    jd = jvoc.ParallelWaveGANDiscriminator(layers=4, channels=8)
    td = tvoc.ParallelWaveGANDiscriminator(layers=4, channels=8)
    p = _pair(jd, td, jnp.asarray(wav))
    _outs_close(td(_t(wav)), jd.apply({"params": p}, jnp.asarray(wav)))


def test_style_melgan(fixed_normal):
    rng = np.random.RandomState(10)
    mel = rng.randn(2, 5, 6).astype(np.float32)
    fixed_normal["draw"] = rng.randn(2, 5, 4).astype(np.float32)
    kw = dict(aux_channels=6, channels=8, noise_dim=4, kernel_size=5,
              block_upsamples=(2, 2))
    jm, tm = (jvoc.StyleMelGANGenerator(**kw),
              tvoc.StyleMelGANGenerator(**kw))
    key = jax.random.PRNGKey(0)
    p = _pair(jm, tm, jnp.asarray(mel), rngs={"params": key, "noise": key})
    want = jm.apply({"params": p}, jnp.asarray(mel), rngs={"noise": key})
    assert want.shape == (2, 20, 1)
    _close(tm(_t(mel), noise=_t(fixed_normal["draw"])), want, DEEP_TOL)
    wav = rng.randn(2, 700, 1).astype(np.float32) * 0.3
    kw = dict(repeats=2, window_sizes=(256, 512), pqmf_bands=(1, 4))
    jd, td = (jvoc.StyleMelGANDiscriminator(**kw),
              tvoc.StyleMelGANDiscriminator(**kw))
    p = _pair(jd, td, jnp.asarray(wav))
    _outs_close(td(_t(wav)), jd.apply({"params": p}, jnp.asarray(wav)))


# --- WaveNet ---------------------------------------------------------------

def test_wavenet_forward_loss_and_generate():
    cfg = dict(quantize=16, residual_channels=8, skip_channels=8,
               aux_channels=4, dilation_depth=3, dilation_repeat=2,
               hop_length=4)
    jm = jwn.WaveNet(jwn.WaveNetConfig(**cfg))
    tm = twn.WaveNet(twn.WaveNetConfig(**cfg))
    assert tm.config.dilations == jm.config.dilations
    assert tm.config.receptive_field == jm.config.receptive_field
    rng = np.random.RandomState(11)
    wav = np.clip(rng.randn(2, 30) * 0.4, -1, 1).astype(np.float32)
    mel = rng.randn(2, 8, 4).astype(np.float32)
    lens = np.array([30, 21], np.int32)
    ids = np.asarray(jwn.mulaw_encode(jnp.asarray(wav), 16))
    np.testing.assert_array_equal(twn.mulaw_encode(_t(wav), 16).numpy(), ids)
    _close(twn.mulaw_decode(_t(ids), 16), jwn.mulaw_decode(jnp.asarray(ids),
                                                           16))
    p = _pair(jm, tm, jnp.asarray(ids), jnp.asarray(mel))
    _close(tm(_t(ids), _t(mel)),
           jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mel)))
    (jl, jstats), (tl, tstats) = (
        jm.apply({"params": p}, jnp.asarray(wav), jnp.asarray(mel),
                 jnp.asarray(lens), method=jwn.WaveNet.loss),
        tm.loss(_t(wav), _t(mel), _t(lens)))
    _close(tl, jl)
    _close(tstats["acc"], jstats["acc"])
    # generation: JAX's scan splits its key once a step and samples
    # categorical(sub, logits), i.e. argmax(logits + gumbel(uniform(sub)))
    n, key = 12, jax.random.PRNGKey(5)
    want = jm.apply({"params": p}, jnp.asarray(mel), n, key,
                    method=jwn.WaveNet.generate)
    tiny = float(jnp.finfo(jnp.float32).tiny)
    uniforms = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        uniforms.append(np.asarray(jax.random.uniform(
            sub, (2, 16), minval=tiny, maxval=1.0)))
    got = tm.generate(_t(mel), n, uniforms=_t(np.stack(uniforms)))
    _close(got, want)


# --- the GAN step ----------------------------------------------------------

def _sgd(lr):
    return optax.chain(optax.clip_by_global_norm(5.0),
                       optax.sgd(lr, momentum=0.9))


def _updates_close(module, before, after_jax):
    """The port's update of each leaf (new - old) against JAX's."""
    old = jax_params_to_state_dict(before)
    new_jax = jax_params_to_state_dict(jax.device_get(after_jax))
    own = module.state_dict()
    assert set(old) == set(own)
    for name in old:
        want = (new_jax[name] - old[name]).numpy()
        got = (own[name] - old[name]).numpy()
        scale = max(float(np.abs(want).max()), UPD_FLOOR)
        err = float(np.abs(got - want).max())
        assert err <= UPD_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("kind", ["hifigan", "pwg"])
def test_gan_train_step_updates_both_sides_like_jax(kind, fixed_normal):
    """One step: the discriminator's update on the detached fake, then the
    generator's against the updated discriminator, both optimizers."""
    rng = np.random.RandomState(12)
    mel = rng.randn(2, 8, 6).astype(np.float32)
    wav = (rng.randn(2, 64) * 0.3).astype(np.float32)
    if kind == "hifigan":
        jg, tg = jhg.HiFiGANGenerator(**HIFI), thg.HiFiGANGenerator(**HIFI)
    else:
        kw = dict(in_channels=6, layers=4, stacks=2, residual_channels=8,
                  gate_channels=8, skip_channels=8, upsample_scales=(4, 2))
        jg, tg = (jvoc.ParallelWaveGANGenerator(**kw),
                  tvoc.ParallelWaveGANGenerator(**kw))
        fixed_normal["draw"] = rng.randn(2, 64, 1).astype(np.float32)
    jd = jvoc.ParallelWaveGANDiscriminator(layers=4, channels=8)
    td = tvoc.ParallelWaveGANDiscriminator(layers=4, channels=8)
    key = jax.random.PRNGKey(0)
    gp = _pair(jg, tg, jnp.asarray(mel), rngs={"params": key, "noise": key})
    dp = _pair(jd, td, jnp.asarray(wav)[:, :, None])
    weights = dict(adv=1.0, feat_match=2.0, mel=45.0, stft=1.0, fs=16000,
                   n_fft=128, hop_length=32, n_mels=10)
    res = ((64, 16, 32), (32, 8, 16))
    jstep = jax.jit(jgan.make_gan_train_step(
        jg, jd, _sgd(0.05), _sgd(0.05), jgan.GANLossWeights(**weights)))
    jstate = jgan.GANTrainState.create(gp, _sgd(0.05), dp, _sgd(0.05))
    jorig, torig = (jvoc.multi_resolution_stft_loss,
                    tvoc.multi_resolution_stft_loss)
    with pytest.MonkeyPatch.context() as mp:  # smaller STFTs for 64 samples
        mp.setattr(jvoc, "multi_resolution_stft_loss",
                   lambda x, y: jorig(x, y, res))
        mp.setattr(tvoc, "multi_resolution_stft_loss",
                   lambda x, y: torig(x, y, res))
        jnew, jstats = jstep(jstate, jnp.asarray(mel), jnp.asarray(wav))
        state = tgan.GANTrainState(
            tg, td, build_optimizer("sgd", 0.05, "constant", grad_clip=5.0),
            build_optimizer("sgd", 0.05, "constant", grad_clip=5.0))
        draws = {"noise": _t(fixed_normal["draw"])} if kind == "pwg" else {}
        stats = tgan.make_gan_train_step(tgan.GANLossWeights(**weights))(
            state, _t(mel), _t(wav), draws=draws)
    for k in ("loss", "generator_adv_loss", "feat_match_loss", "mel_loss",
              "discriminator_loss", "disc_real_loss", "disc_fake_loss"):
        _close(stats[k], jstats[k], DEEP_TOL)
    assert state.step == int(jnew.step) == 1
    _updates_close(td, dp, jnew.disc_params)
    _updates_close(tg, gp, jnew.gen_params)


def test_gan_optimizer_is_optax_clip_adam():
    """`gan_optimizer` against optax chain(clip_by_global_norm, adam(b1,
    b2)) over three steps, one clipped."""
    rng = np.random.RandomState(13)
    p0 = rng.randn(50).astype(np.float32)
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.adam(2e-4, b1=0.8, b2=0.99))
    jp, jstate = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    opt = tgan.gan_optimizer(2e-4)
    tp = _t(p0)
    tstate = opt.init(tp)
    for scale in (0.1, 3.0, 0.5):
        g = (rng.randn(50) * scale).astype(np.float32)
        upd, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.apply_(tp, _t(g), tstate)
        _close(tp, jp, 1e-6)
