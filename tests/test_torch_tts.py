"""The port's TTS modules (`models/tts/`, `ops/stft.istft`,
`ops/griffin_lim.py`, `ops/pitch.py`, `utils/tts_metrics.py`) against the
JAX package's, float32 on the CPU.

Every model runs on the JAX module's own parameters (drawn by flax's init,
carried by `convert.load_jax_params`) with its `batch_stats` perturbed
from their initial values, so that eval mode reads them. Randomness: the
dropouts the configurations can switch off are at rate 0 (Tacotron2's
prenet and encoder, Transformer-TTS's prenet, every transformer layer);
the ones fixed at 0.5 (the variance predictors', the postnet's) are
monkeypatched to the identity on the JAX side and off on the port's (no
generator). Zoneout runs as its expectation on both sides (JAX without a
'zoneout' rng, the port without a generator). ProDiff's timestep and
noise, and Griffin-Lim's initial phase, are drawn with JAX's keys and
injected into the port. Tolerances: losses and outputs 1e-4 (absolute and
relative), gradients 1e-3 relative to each leaf's largest value with a
floor; the recurrent models sum over more steps and get 2e-4 on outputs.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models.tts import fastspeech2 as jfs2
from espnet_tpu.models.tts import gst as jgst
from espnet_tpu.models.tts import model as jmodel
from espnet_tpu.models.tts import prodiff as jprodiff
from espnet_tpu.models.tts import spk_embed as jspk
from espnet_tpu.models.tts import tacotron2 as jtaco
from espnet_tpu.models.tts import transformer_tts as jtr
from espnet_tpu.models.tts import vc as jvc
from espnet_tpu.ops import griffin_lim as jgl
from espnet_tpu.ops import pitch as jpitch
from espnet_tpu.ops import stft as jstft
from espnet_tpu.utils import tts_metrics as jmetrics
from espnet_tpu_torch.convert import (jax_params_to_state_dict,
                                      load_jax_params, model_variables)
from espnet_tpu_torch.models.tts import fastspeech2 as tfs2
from espnet_tpu_torch.models.tts import gst as tgst
from espnet_tpu_torch.models.tts import model as tmodel
from espnet_tpu_torch.models.tts import prodiff as tprodiff
from espnet_tpu_torch.models.tts import spk_embed as tspk
from espnet_tpu_torch.models.tts import tacotron2 as ttaco
from espnet_tpu_torch.models.tts import transformer_tts as ttr
from espnet_tpu_torch.models.tts import vc as tvc
from espnet_tpu_torch.ops import flash_attention as tflash
from espnet_tpu_torch.ops import griffin_lim as tgl
from espnet_tpu_torch.ops import pitch as tpitch
from espnet_tpu_torch.ops import stft as tstft
from espnet_tpu_torch.utils import tts_metrics as tmetrics

TOL = 1e-4
RNN_TOL = 2e-4
GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-2
FRONT = dict(n_fft=64, hop_length=16, n_mels=8, fmin=0.0, fmax=None)
V = 11


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    """flax nn.Dropout as the identity (the rates fixed at 0.5)."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _grads_close(model, jgrads):
    want = jax_params_to_state_dict(jax.device_get(jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(want) == set(got)
    for name, w in want.items():
        # a leaf that reaches no output (ProDiff's last residual) has no
        # gradient in torch, zeros in JAX
        g = got[name] if got[name] is not None else torch.zeros(w.shape)
        w = w.numpy()
        scale = max(float(np.abs(w).max()), GRAD_FLOOR)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


def _perturb_stats(variables, seed=3):
    """Running statistics away from 0/1, so that eval mode reads them."""
    rng = np.random.RandomState(seed)
    out = dict(variables)
    if "batch_stats" in out:
        out["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (np.asarray(a) + 0.3 * rng.rand(*a.shape)
                       ).astype(np.float32), out["batch_stats"])
    return out


# --- ops ---------------------------------------------------------------

def test_istft_matches_jax_and_inverts_stft():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 900).astype(np.float32)
    jr, ji = jstft.stft(jnp.asarray(x), 64, 16)
    tr, ti = tstft.stft(_t(x), 64, 16)
    _close(tr, jr, 1e-3)
    want = jstft.istft(jr, ji, 64, 16, length=900)
    got = tstft.istft(_t(np.asarray(jr)), _t(np.asarray(ji)), 64, 16,
                      length=900)
    _close(got, want)
    assert got.shape == (2, 896)  # 57 frames at hop 16, centre cut
    _close(got, x[:, :896], 1e-4)
    # no length: the centre padding is cut off both ends
    assert tuple(tstft.istft(tr, ti, 64, 16).shape) == \
        tuple(jstft.istft(jr, ji, 64, 16).shape)


def test_griffin_lim_with_jax_phase_injected_matches_jax():
    rng = np.random.RandomState(1)
    logmel = rng.randn(2, 12, 8).astype(np.float32) - 2.0
    want = jgl.logmel_to_wav(jnp.asarray(logmel), 16000, 64, 16, None, 8, 3)
    mag = tgl.logmel_to_linear(_t(logmel), 16000, 64, 8)
    _close(mag, jgl.logmel_to_linear(jnp.asarray(logmel), 16000, 64, 8))
    angle = jax.random.uniform(jax.random.PRNGKey(0), mag.shape,
                               minval=-np.pi, maxval=np.pi)
    got = tgl.logmel_to_wav(_t(logmel), 16000, 64, 16, None, 8, 3,
                            angle=_t(np.asarray(angle)))
    assert got.shape == want.shape
    _close(got, want, 2e-4)
    # the port's own draw: seeded 0 unless a generator is given
    a = tgl.griffin_lim(mag, 64, 16, n_iter=1)
    b = tgl.griffin_lim(mag, 64, 16, n_iter=1)
    c = tgl.griffin_lim(mag, 64, 16, n_iter=1,
                        generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_pitch_and_energy_match_jax():
    rng = np.random.RandomState(2)
    n = 4000
    t = np.arange(n) / 16000.0
    wav = np.stack([0.5 * np.sin(2 * np.pi * 180 * t),
                    0.3 * rng.randn(n)]).astype(np.float32)
    _close(tpitch.frame_energy(_t(wav), 512, 128),
           jpitch.frame_energy(jnp.asarray(wav), 512, 128), 1e-3)
    jf0, jv = jpitch.autocorr_f0(jnp.asarray(wav), n_fft=512, hop_length=128)
    tf0, tv = tpitch.autocorr_f0(_t(wav), n_fft=512, hop_length=128)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _close(tf0, jf0, 1e-5)
    assert float(tv[0].mean()) > 0.5  # the sine is voiced
    # the first of equal maxima, as jnp.argmax
    band = torch.tensor([0.1, 0.7, 0.7, 0.2])
    assert int(torch.argmax(band, -1)) == int(jnp.argmax(band.numpy(), -1))


def test_mcd_matches_jax():
    rng = np.random.RandomState(4)
    ref = (0.3 * rng.randn(3000)).astype(np.float32)
    syn = (ref[:2800] + 0.05 * rng.randn(2800)).astype(np.float32)
    want = jmetrics.mel_cepstral_distortion(ref, syn)
    got = tmetrics.mel_cepstral_distortion(ref, syn)
    assert abs(got - want) <= 1e-3 * max(1.0, abs(want))
    assert tmetrics.mel_cepstral_distortion(ref, ref) == pytest.approx(
        0.0, abs=1e-6)


def test_flash_takes_head_dim_192():
    """FastSpeech2's heads (384 / 2): the flash kernel's own list of head
    dims reaches 192 (zero padding up to it); the rel-pos kernels stay at
    128."""
    from espnet_tpu_torch.ops import relpos_attention as trel

    for d, want in ((64, 64), (128, 128), (136, 192), (192, 192)):
        assert tflash.flash_head_dim(d) == want
    with pytest.raises(ValueError, match="up to 192"):
        tflash.flash_head_dim(200)
    with pytest.raises(ValueError, match="up to 128"):
        trel.kernel_head_dim(192)


# --- FastSpeech2's pieces ----------------------------------------------

def test_length_regulate_matches_jax():
    rng = np.random.RandomState(5)
    hs = rng.randn(3, 6, 4).astype(np.float32)
    dur = np.array([[2, 0, 3, 1, 0, 4], [1, 1, 1, 0, 0, 0],
                    [5, 5, 5, 5, 5, 5]], np.int32)
    for max_frames in (12, 30):
        want, wl = jfs2.length_regulate(jnp.asarray(hs), jnp.asarray(dur),
                                        max_frames)
        got, gl = tfs2.length_regulate(_t(hs), _t(dur), max_frames)
        assert got.shape == (3, max_frames, 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_postnet_train_and_eval_modes_match_flax_batchnorm(no_jax_dropout):
    rng = np.random.RandomState(6)
    x = rng.randn(3, 9, 8).astype(np.float32)
    jm = jfs2.Postnet(8, 6, 3)
    v = _perturb_stats(fnn.meta.unbox(jm.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x))))
    tm = tfs2.Postnet(8, 6, 3)
    tm.load_state_dict(jax_params_to_state_dict(v))
    tm.eval()
    _close(tm(_t(x)), jm.apply(v, jnp.asarray(x), True))
    want, upd = jm.apply(v, jnp.asarray(x), False, mutable=["batch_stats"],
                         rngs={"dropout": jax.random.PRNGKey(1)})
    tm.train()
    _close(tm(_t(x)), want)
    got = jax_params_to_state_dict({"params": {}, "batch_stats":
                                    jax.device_get(upd["batch_stats"])})
    for k, w in got.items():
        _close(tm.get_buffer(k), w.numpy(), 1e-5)
    # flax updates with the biased variance, torch's BatchNorm1d would not
    flat = x.reshape(-1, 8)
    assert not np.allclose(flat.var(0), flat.var(0, ddof=1))


# --- the four TTS models through TTSModel --------------------------------

SUBS = {
    "tacotron2": ("tacotron2", jtaco.Tacotron2Config, ttaco.Tacotron2Config,
                  dict(embed_dim=16, encoder_conv_layers=2,
                       encoder_conv_channels=16, encoder_lstm_units=16,
                       prenet_layers=2, prenet_units=8,
                       decoder_lstm_units=16, decoder_lstm_layers=2,
                       att_dim=8, att_conv_channels=4, att_conv_kernel=5,
                       postnet_layers=2, postnet_channels=8,
                       reduction_factor=2, dropout_rate=0.0,
                       max_frames=40)),
    "fastspeech2": ("fastspeech2", jfs2.FastSpeech2Config,
                    tfs2.FastSpeech2Config,
                    dict(d_model=16, num_heads=2, d_ff=32, encoder_layers=1,
                         decoder_layers=1, predictor_channels=8,
                         postnet_layers=2, postnet_channels=8,
                         dropout_rate=0.0, max_frames=48)),
    "transformer": ("transformer", jtr.TransformerTTSConfig,
                    ttr.TransformerTTSConfig,
                    dict(d_model=16, num_heads=2, d_ff=32,
                         num_encoder_layers=2, num_decoder_layers=2,
                         prenet_units=8, prenet_dropout=0.0,
                         postnet_layers=2, postnet_channels=8,
                         reduction_factor=2, dropout_rate=0.0,
                         max_frames=40)),
    "prodiff": ("prodiff", jprodiff.ProDiffConfig, tprodiff.ProDiffConfig,
                dict(d_model=16, num_heads=2, d_ff=32, encoder_layers=1,
                     predictor_channels=8, denoiser_channels=8,
                     denoiser_layers=3, timesteps=4, dropout_rate=0.0,
                     max_frames=48)),
}


def _configs(tts_type, **extra):
    field, jc, tc, kw = SUBS[tts_type]
    kw = dict(kw, vocab_size=V, n_mels=8, **extra)
    common = dict(tts_type=tts_type, vocab_size=V, **FRONT)
    return (jmodel.TTSTaskConfig(**common, **{field: jc(**kw)}),
            tmodel.TTSTaskConfig(**common, **{field: tc(**kw)}))


def _batch(seed=7):
    rng = np.random.RandomState(seed)
    speech_lens = np.array([700, 560, 420], np.int32)
    speech = np.zeros((3, 700), np.float32)
    for i, n in enumerate(speech_lens):
        speech[i, :n] = 0.3 * rng.randn(n)
    text_lens = np.array([6, 4, 3], np.int32)
    text = np.zeros((3, 6), np.int32)
    for i, n in enumerate(text_lens):
        text[i, :n] = rng.randint(1, V, n)
    # durations that fill the frames (44, 36, 27 frames at hop 16)
    dur = np.zeros((3, 6), np.int32)
    for i, n in enumerate(text_lens):
        frames = speech_lens[i] // 16 + 1
        d = np.full(n, frames // n)
        d[0] += frames - d.sum()
        dur[i, :n] = d
    return text, text_lens, speech, speech_lens, dur


def _pair(tts_type, seed=0, spk=None, **extra):
    """(JAX model, its variables with perturbed stats and mvn, port model
    loaded with them); `spk`: the speaker inputs (numpy) the model takes."""
    jcfg, tcfg = _configs(tts_type, **extra)
    jm = jmodel.TTSModel(jcfg)
    text, tl, speech, sl, dur = _batch()
    kw = {k: jnp.asarray(a) for k, a in (spk or {}).items()}
    if tts_type in ("fastspeech2", "prodiff"):
        kw["durations"] = jnp.asarray(dur)
    v = fnn.meta.unbox(jm.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(1),
         "diffusion": jax.random.PRNGKey(2)},
        jnp.asarray(text), jnp.asarray(tl), jnp.asarray(speech),
        jnp.asarray(sl), **kw))
    v = _perturb_stats(jax.device_get(v))
    rng = np.random.RandomState(seed + 10)
    v["mvn"] = {"mvn": {"mean": rng.randn(8).astype(np.float32),
                        "inv_std": (0.5 + rng.rand(8)).astype(np.float32)}}
    tm = tmodel.TTSModel(tcfg)
    load_jax_params(tm, v)
    return jm, v, tm


def _inject_diffusion(monkeypatch, t, noise):
    """ProDiff's training draws (jax.random.randint / normal) as given."""
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(t, jnp.int32))
    monkeypatch.setattr(jax.random, "normal",
                        lambda *a, **k: jnp.asarray(noise))


# Tacotron2's case also runs GST (the flax GRUCell, the strided "SAME"
# convolutions, the style tokens) and the speaker conditioner (a sid
# table, concatenated L2-normalised embeddings)
GST_SPK = dict(use_gst=True, gst_tokens=3, gst_heads=2, spks=3,
               spk_embed_dim=5)
SPK = {"sids": np.array([0, 2, 1], np.int32),
       "spembs": np.random.RandomState(11).randn(3, 5).astype(np.float32)}


@pytest.mark.parametrize("tts_type", sorted(SUBS))
def test_tts_model_loss_stats_grads_and_batch_stats_match_jax(
        tts_type, no_jax_dropout, monkeypatch):
    spk = SPK if tts_type == "tacotron2" else {}
    extra = GST_SPK if tts_type == "tacotron2" else {}
    jm, v, tm = _pair(tts_type, spk=spk, **extra)
    # the converter's reverse gives back JAX's variables, leaf for leaf
    back = model_variables(tm)
    assert set(back) == ({"params", "batch_stats"} & set(v))
    for col in back:
        want = jax_params_to_state_dict({"params": {}, col: v[col]}) \
            if col == "batch_stats" else jax_params_to_state_dict(v[col])
        got = jax_params_to_state_dict({"params": {}, col: back[col]}) \
            if col == "batch_stats" else jax_params_to_state_dict(back[col])
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    text, tl, speech, sl, dur = _batch()
    targs = [_t(text), _t(tl), _t(speech), _t(sl)]
    jargs = list(map(jnp.asarray, (text, tl, speech, sl)))
    kw_t = {k: _t(a) for k, a in spk.items()}
    kw_j = {k: jnp.asarray(a) for k, a in spk.items()}
    if tts_type in ("fastspeech2", "prodiff"):
        kw_t["durations"], kw_j["durations"] = _t(dur), jnp.asarray(dur)
    if tts_type == "prodiff":
        tsteps = np.array([3, 0, 2], np.int32)
        frames = int(sl.max()) // 16 + 1
        noise = np.random.RandomState(9).randn(3, frames, 8).astype(
            np.float32)
        _inject_diffusion(monkeypatch, tsteps, noise)
        kw_t.update(t=_t(tsteps), noise=_t(noise))
    params = v["params"]
    rest = {k: x for k, x in v.items() if k != "params"}

    def loss_fn(p):
        (loss, stats), upd = jm.apply(
            {"params": p, **rest}, *jargs, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(4),
                  "diffusion": jax.random.PRNGKey(5),
                  "prenet": jax.random.PRNGKey(6)},
            mutable=["batch_stats"], **kw_j)
        return loss, (stats, upd)

    (jloss, (jstats, jupd)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    tm.train()
    if tts_type == "prodiff":
        loss, stats = tm.tts(*_prodiff_inputs(tm, targs, kw_t))[:2]
    else:
        loss, stats = tm(*targs, **kw_t)
    loss.backward()
    assert set(stats) == set(jstats)
    for k in jstats:
        _close(stats[k], jstats[k], RNN_TOL if tts_type == "tacotron2"
               else TOL)
    _grads_close(tm, jgrads)
    if "batch_stats" in jupd:
        for k, w in jax_params_to_state_dict(
                {"params": {}, "batch_stats":
                 jax.device_get(jupd["batch_stats"])}).items():
            _close(tm.get_buffer(k), w.numpy(), 1e-5)


def _prodiff_inputs(tm, targs, kw):
    """TTSModel's path into ProDiff with the injected draws."""
    text, tl, speech, sl = targs
    mel, ml = tm.extract_feats(speech, sl)
    z = torch.zeros(text.shape)
    return (text, tl, mel, ml, kw["durations"], z, z, None, kw["t"],
            kw["noise"])


# (seed, stop kernel scale, stop bias shift): utterances that stop at
# different steps, one at the first
STOP = {"tacotron2": (1, 40.0, 0.0), "transformer": (2, 10.0, -1.0)}


def _sharpen_stop(v, tts_type):
    """Scale the stop projection so that its logits sit far from the
    threshold: the stopping step is then no coin toss between two float
    orders."""
    _, scale, shift = STOP[tts_type]
    p = v["params"]["tts"]
    node = p["decoder"]["prob_out"] if tts_type == "tacotron2" \
        else p["prob_out"]
    node["kernel"] = np.asarray(node["kernel"]) * scale
    node["bias"] = np.asarray(node["bias"]) + shift
    return v


@pytest.mark.parametrize("tts_type", sorted(SUBS))
def test_tts_inference_matches_jax(tts_type, monkeypatch):
    jm, v, tm = _pair(tts_type, seed=STOP.get(tts_type, (1,))[0])
    if tts_type in ("tacotron2", "transformer"):
        v = _sharpen_stop(v, tts_type)
        load_jax_params(tm, v)
    text, tl = _batch()[:2]
    jargs = (jnp.asarray(text), jnp.asarray(tl))
    kw = {}
    if tts_type == "prodiff":
        frames = SUBS["prodiff"][3]["max_frames"]
        draws = [np.random.RandomState(20 + i).randn(3, frames, 8).astype(
            np.float32) for i in range(4)]
        it = iter(draws)
        monkeypatch.setattr(jax.random, "normal",
                            lambda *a, **k: jnp.asarray(next(it)))
        kw["noise"] = [_t(d) for d in draws]
        want, wl = jm.apply(v, *jargs, None, method=jmodel.TTSModel.inference,
                            rngs={"diffusion": jax.random.PRNGKey(3)})
        got, gl = tm.tts.inference(_t(text), _t(tl), None, **kw)
    else:
        want, wl = jax.jit(lambda v, a, b: jm.apply(
            v, a, b, None, method=jmodel.TTSModel.inference,
            rngs={"dropout": jax.random.PRNGKey(3)}))(v, *jargs)
        got, gl = tm.inference(_t(text), _t(tl))
    assert got.shape == want.shape
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    if tts_type in ("tacotron2", "transformer"):
        # some utterances stop before max_frames, and not all together
        assert 0 < int(gl.min()) and len(set(gl.tolist())) > 1
    _close(got, want, RNN_TOL)


def test_tacotron2_teacher_attention_matches_jax():
    jm, v, tm = _pair("tacotron2", seed=2)
    text, tl, speech, sl, _ = _batch()

    def att(m, text, tl, speech, sl):
        mel, ml = m.extract_feats(speech, sl)
        mel, ml = m._fit_reduction(mel, ml)
        return m.tts.teacher_attention(text, tl, mel, ml), ml

    want, wl = jax.jit(lambda v, *a: jm.apply(v, *a, method=att))(
        v, *map(jnp.asarray, (text, tl, speech, sl)))
    tm.eval()
    mel, ml = tm._fit_reduction(*tm.extract_feats(_t(speech), _t(sl)))
    got = tm.tts.teacher_attention(_t(text), _t(tl), mel, ml)
    np.testing.assert_array_equal(ml.numpy(), np.asarray(wl))
    _close(got, want, RNN_TOL)


def test_style_encoder_and_speaker_modules_match_jax():
    rng = np.random.RandomState(12)
    ref = rng.randn(2, 23, 10).astype(np.float32)
    jm = jgst.StyleEncoder(num_tokens=4, token_dim=8, num_heads=2,
                           gru_units=6)
    v = jax.device_get(fnn.meta.unbox(jm.init(jax.random.PRNGKey(0),
                                              jnp.asarray(ref))))
    tm = tgst.StyleEncoder(10, num_tokens=4, token_dim=8, num_heads=2,
                           gru_units=6)
    tm.load_state_dict(jax_params_to_state_dict(v))
    _close(tm(_t(ref)), jm.apply(v, jnp.asarray(ref)))

    hs = rng.randn(3, 5, 8).astype(np.float32)
    sids, lids = np.array([1, 0, 2], np.int32), np.array([0, 1, 1], np.int32)
    se = rng.randn(3, 4).astype(np.float32)
    for integration in ("add", "concat"):
        jc = jspk.SpeakerConditioner(spks=3, langs=2, spk_embed_dim=4,
                                     integration_type=integration, units=8)
        args = (jnp.asarray(hs), jnp.asarray(sids), jnp.asarray(lids),
                jnp.asarray(se))
        v = jax.device_get(jc.init(jax.random.PRNGKey(1), *args))
        tc = tspk.SpeakerConditioner(3, 2, 4, integration, 8)
        tc.load_state_dict(jax_params_to_state_dict(v))
        got = tc(_t(hs), _t(sids), _t(lids), _t(se))
        assert got.shape[-1] == tc.out_dim
        _close(got, jc.apply(v, *args))

    feats = rng.randn(3, 17, 8).astype(np.float32)
    lens = np.array([17, 11, 4], np.int32)
    je = jspk.SpeakerEmbeddingExtractor(n_spk=4, embed_dim=6, channels=8)
    v = jax.device_get(je.init(jax.random.PRNGKey(2), jnp.asarray(feats),
                               jnp.asarray(lens), True))
    te = tspk.SpeakerEmbeddingExtractor(8, n_spk=4, embed_dim=6, channels=8)
    te.load_state_dict(jax_params_to_state_dict(v))
    emb, logits = te(_t(feats), _t(lens), logits=True)
    jemb, jlogits = je.apply(v, jnp.asarray(feats), jnp.asarray(lens), True)
    _close(emb, jemb)
    _close(logits, jlogits)
    _close(te(_t(feats), _t(lens)), je.apply(v, jnp.asarray(feats),
                                              jnp.asarray(lens)))


@pytest.mark.parametrize("vc_type", ["tacotron2", "transformer"])
def test_vc_model_loss_grads_and_conversion_match_jax(vc_type,
                                                      no_jax_dropout):
    field, jc, tc, kw = SUBS[vc_type]
    kw = dict(kw, vocab_size=1, n_mels=8, input_type="feats", input_dim=8)
    front = dict(FRONT)
    jm = jvc.VCModel(jvc.VCTaskConfig(vc_type=vc_type, **front,
                                      **{field: jc(**kw)}))
    tm = tvc.VCModel(tvc.VCTaskConfig(vc_type=vc_type, **front,
                                      **{field: tc(**kw)}))
    _, _, speech, sl, _ = _batch()
    src = np.roll(speech, 5, axis=1)
    args = list(map(jnp.asarray, (src, sl, speech, sl)))
    v = _perturb_stats(jax.device_get(fnn.meta.unbox(jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *args))))
    v = _sharpen_stop(
        {"params": {"tts": v["params"]["tts"]}, **{
            k: x for k, x in v.items() if k != "params"}}, vc_type)
    load_jax_params(tm, v)
    rest = {k: x for k, x in v.items() if k != "params"}

    def loss_fn(p):
        (loss, stats), _ = jm.apply(
            {"params": p, **rest}, *args, deterministic=False,
            mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(4),
                  "prenet": jax.random.PRNGKey(5)})
        return loss, stats

    (_, jstats), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    tm.train()
    loss, stats = tm(*(_t(a) for a in (src, sl, speech, sl)))
    loss.backward()
    for k in jstats:
        _close(stats[k], jstats[k], RNN_TOL)
    _grads_close(tm, jgrads)
    load_jax_params(tm, v)  # the running statistics before the step
    want, wl = jax.jit(lambda v, a, b: jm.apply(
        v, a, b, 24, method=jvc.VCModel.inference,
        rngs={"dropout": jax.random.PRNGKey(3)}))(v, args[0], args[1])
    got, gl = tm.inference(_t(src), _t(sl), 24)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    _close(got, want, RNN_TOL)
