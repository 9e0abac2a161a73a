"""The port's VITS and JETS (`models/tts/{vits,jets}.py`, the VITS and
JETS steps of `train/gan_steps.py`) against the JAX package's, float32 on
the CPU, at reduced widths.

The models run on the JAX modules' parameters (flax's init, every leaf
moved by 0.05 N(0, 1) so that the flow's zero-initialised `post` convs
carry signal), carried by `convert.load_jax_params`. The draws are
injected: VITS's posterior noise and both models' segment draws are numpy
arrays that `jax.random.normal` / `jax.random.uniform` return on the JAX
side (monkeypatched) and that the port takes as `eps=` and `starts=`;
flax's dropouts fixed at 0.5 (the duration and variance predictors) are
the identity on the JAX side and off on the port's (no generator); the
configurations' own dropout is 0. The steps run with optax chain(clip,
sgd) against the port's FlatSGD, so that each leaf's update is its
gradient times the rate: both sides' updates agree to 1e-3 of the leaf's
largest (with a floor). Tolerances: outputs and losses 2e-4 (absolute and
relative); `maximum_path` exactly, ties included.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from espnet_tpu.models.tts import jets as jjets
from espnet_tpu.models.tts import vits as jvits
from espnet_tpu.models.tts import vocoders as jvoc
from espnet_tpu.train import gan_steps as jgan
from espnet_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from espnet_tpu_torch.models.tts import jets as tjets
from espnet_tpu_torch.models.tts import vits as tvits
from espnet_tpu_torch.models.tts import vocoders as tvoc
from espnet_tpu_torch.train import gan_steps as tgan
from espnet_tpu_torch.train.optim import build_optimizer

TOL = 2e-4
UPD_TOL = 1e-3
# a leaf whose updates stay below this has a zero gradient (the attention's
# key bias: softmax ignores a per-query constant) and holds rounding noise
UPD_FLOOR = 1e-5
V = 11
N_FFT, HOP = 64, 8
VITS_CFG = dict(vocab_size=V, channels=16, text_heads=2, text_d_ff=32,
                text_layers=1, spec_dim=N_FFT // 2 + 1, posterior_layers=2,
                flows=2, flow_layers=2, decoder_channels=16,
                upsample_scales=(4, 2), resblock_kernel_sizes=(3,),
                n_fft=N_FFT, hop_length=HOP, segment_frames=4,
                dropout_rate=0.0)
JETS_CFG = dict(vocab_size=V, n_mels=8, adim=16, num_heads=2, d_ff=32,
                encoder_layers=1, decoder_layers=1, predictor_layers=1,
                predictor_channels=8, decoder_channels=16,
                upsample_scales=(4, 2), resblock_kernel_sizes=(3,),
                segment_frames=4, max_frames=40, dropout_rate=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def draws(monkeypatch):
    """jax.random.normal / uniform return the numpy arrays put under their
    shapes; flax's nn.Dropout is the identity."""
    box = {}

    def fixed(key, shape, dtype=jnp.float32, *a, **k):
        return jnp.asarray(box[tuple(shape)], dtype)

    monkeypatch.setattr(jax.random, "normal", fixed)
    monkeypatch.setattr(jax.random, "uniform", fixed)
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    return box


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _perturb(params, seed=0):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*np.shape(a))
                   ).astype(np.float32), jax.device_get(params))


def _starts(u, lengths, seg):
    """JAX's segment starts from its uniform draws."""
    return (u * (np.maximum(lengths - seg, 0) + 1).astype(np.float32)
            ).astype(np.int32)


def _sgd(lr=0.05):
    return optax.chain(optax.clip_by_global_norm(5.0),
                       optax.sgd(lr, momentum=0.9))


def _port_sgd(lr=0.05):
    return build_optimizer("sgd", lr, "constant", grad_clip=5.0)


def _updates_close(module, before, after_jax):
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


# --- monotonic alignment search --------------------------------------------

@pytest.mark.parametrize("kind", ["random", "ties", "integer_ties"])
def test_maximum_path_is_jaxs_exactly(kind):
    """Ragged lengths (one text as long as its frames, one a single token);
    with ties everywhere the backtrack's strict v_here < v_diag decides."""
    rng = np.random.RandomState(0)
    b, t_y, t_x = 4, 11, 6
    if kind == "random":
        x = rng.randn(b, t_y, t_x).astype(np.float32)
    elif kind == "ties":
        x = np.zeros((b, t_y, t_x), np.float32)
    else:
        x = rng.randint(-2, 2, size=(b, t_y, t_x)).astype(np.float32)
    flens = np.array([11, 7, 6, 5], np.int32)
    tlens = np.array([6, 3, 6, 1], np.int32)
    want = np.asarray(jvits.maximum_path(jnp.asarray(x), jnp.asarray(flens),
                                         jnp.asarray(tlens)))
    got = tvits.maximum_path(_t(x), _t(flens), _t(tlens)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == flens.sum()


# --- VITS --------------------------------------------------------------------

def _vits_batch(seed=1):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, V, size=(2, 7)).astype(np.int32)
    tlens = np.array([7, 5], np.int32)
    spec = np.abs(rng.randn(2, 12, N_FFT // 2 + 1)).astype(np.float32)
    slens = np.array([12, 10], np.int32)
    wav = (rng.randn(2, 11 * HOP) * 0.3).astype(np.float32)
    return tokens, tlens, spec, slens, wav


def _vits_pair(cfg):
    jm = jvits.VITSGenerator(jvits.VITSConfig(**cfg))
    tm = tvits.VITSGenerator(tvits.VITSConfig(**cfg))
    tokens, tlens, spec, slens, _ = _vits_batch()
    key = jax.random.PRNGKey(0)
    kw = {}
    if cfg.get("spks"):
        kw = dict(sids=jnp.array([1, 2]), lids=jnp.array([0, 1]),
                  spembs=jnp.ones((2, 6)))
    params = fnn.meta.unbox(jm.init(
        {"params": key, "posterior": key, "segment": key, "dropout": key},
        jnp.asarray(tokens), jnp.asarray(tlens), jnp.asarray(spec),
        jnp.asarray(slens), **kw))["params"]
    params = _perturb(params)
    load_jax_params(tm, params)
    return jm, tm.eval(), params


MULTI = dict(spks=3, langs=2, spk_embed_dim=6, global_channels=8)


@pytest.mark.parametrize("speakers", ["single", "multi"])
def test_vits_forward_and_inference(speakers, draws):
    cfg = dict(VITS_CFG, **(MULTI if speakers == "multi" else {}))
    tokens, tlens, spec, slens, _ = _vits_batch()
    rng = np.random.RandomState(2)
    eps = rng.randn(2, 12, 16).astype(np.float32)
    u = rng.rand(2).astype(np.float32)
    draws[(2, 12, 16)], draws[(2,)] = eps, u
    jm, tm, params = _vits_pair(cfg)
    cond, tcond = {}, {}
    if speakers == "multi":
        spembs = rng.randn(2, 6).astype(np.float32)
        cond = dict(sids=jnp.array([1, 2]), lids=jnp.array([0, 1]),
                    spembs=jnp.asarray(spembs))
        tcond = dict(sids=_t(np.array([1, 2])), lids=_t(np.array([0, 1])),
                     spembs=_t(spembs))
    key = jax.random.PRNGKey(0)
    want = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a, False, rngs={"posterior": key, "segment": key,
                                        "dropout": key}, **cond))(
        params, jnp.asarray(tokens), jnp.asarray(tlens), jnp.asarray(spec),
        jnp.asarray(slens))
    got = tm(_t(tokens), _t(tlens), _t(spec), _t(slens), eps=_t(eps),
             starts=_t(_starts(u, slens, 4)), **tcond)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    # inference with noise_scale 0: the same waves
    draws[(2, 30, 16)] = rng.randn(2, 30, 16).astype(np.float32)
    jw, jl = jax.jit(lambda p, t, tl: jm.apply(
        {"params": p}, t, tl, 30, 0.0, method=jm.inference,
        rngs={"posterior": key}, **cond))(params, jnp.asarray(tokens),
                                          jnp.asarray(tlens))
    tw, tl = tm.inference(_t(tokens), _t(tlens), 30, 0.0, **tcond)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close(tw, jw)


def test_vits_train_step_updates_like_jax(draws):
    tokens, tlens, spec, slens, wav = _vits_batch()
    rng = np.random.RandomState(3)
    eps = rng.randn(2, 12, 16).astype(np.float32)
    u = rng.rand(2).astype(np.float32)
    draws[(2, 12, 16)], draws[(2,)] = eps, u
    jm, tm, params = _vits_pair(VITS_CFG)
    tm.train()
    jd = jvoc.ParallelWaveGANDiscriminator(layers=3, channels=4)
    td = tvoc.ParallelWaveGANDiscriminator(layers=3, channels=4)
    dp = jax.device_get(jd.init(jax.random.PRNGKey(1),
                                jnp.zeros((1, 32, 1)))["params"])
    load_jax_params(td, dp)
    kw = dict(hop_length=HOP, upsample=8, mel_fs=16000, mel_n_fft=N_FFT,
              mel_bins=8)
    jstep = jax.jit(jgan.make_vits_train_step(jm, jd, _sgd(), _sgd(), **kw))
    jnew, jstats = jstep(jgan.GANTrainState.create(params, _sgd(), dp,
                                                   _sgd()),
                         jnp.asarray(tokens), jnp.asarray(tlens),
                         jnp.asarray(spec), jnp.asarray(slens),
                         jnp.asarray(wav), jax.random.PRNGKey(0))
    state = tgan.GANTrainState(tm, td, _port_sgd(), _port_sgd())
    stats = tgan.make_vits_train_step(**kw)(
        state, _t(tokens), _t(tlens), _t(spec), _t(slens), _t(wav),
        draws={"eps": _t(eps), "starts": _t(_starts(u, slens, 4))})
    assert set(stats) == set(jstats)
    for k in stats:
        _close(stats[k], jstats[k])
    _updates_close(td, dp, jnew.disc_params)
    _updates_close(tm, params, jnew.gen_params)


# --- JETS --------------------------------------------------------------------

def _jets_batch(seed=4):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, V, size=(2, 6)).astype(np.int32)
    tlens = np.array([6, 4], np.int32)
    feats = rng.randn(2, 14, 8).astype(np.float32)
    flens = np.array([14, 9], np.int32)
    pitch = rng.randn(2, 14).astype(np.float32)
    energy = np.abs(rng.randn(2, 14)).astype(np.float32)
    wav = (rng.randn(2, 14 * HOP) * 0.3).astype(np.float32)
    return tokens, tlens, feats, flens, pitch, energy, wav


def _jets_pair():
    jm = jjets.JETSGenerator(jjets.JETSConfig(**JETS_CFG))
    tm = tjets.JETSGenerator(tjets.JETSConfig(**JETS_CFG))
    b = _jets_batch()
    key = jax.random.PRNGKey(0)
    params = fnn.meta.unbox(jm.init(
        {"params": key, "segment": key, "dropout": key},
        *(jnp.asarray(a) for a in b[:6])))["params"]
    params = _perturb(params, 1)
    load_jax_params(tm, params)
    return jm, tm.eval(), params


def test_forward_sum_loss_and_gradient():
    """The alignment CTC at S = 2U+1 on the port's lattice pair (plain on
    the CPU) against JAX's, value and gradient."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 13, 5).astype(np.float32)
    tlens, flens = np.array([5, 3, 1]), np.array([13, 9, 4])
    logp = jax.nn.log_softmax(jnp.asarray(x), -1)

    def jloss(lp):
        return jjets.forward_sum_loss(lp, jnp.asarray(tlens),
                                      jnp.asarray(flens))

    want, wgrad = jax.jit(jax.value_and_grad(jloss))(logp)
    t = _t(np.asarray(logp)).requires_grad_(True)
    got = tjets.forward_sum_loss(t, _t(tlens), _t(flens))
    got.backward()
    _close(got, want)
    _close(t.grad, wgrad)


def test_jets_forward_and_inference(draws):
    b = _jets_batch()
    u = np.random.RandomState(6).rand(2).astype(np.float32)
    draws[(2,)] = u
    jm, tm, params = _jets_pair()
    key = jax.random.PRNGKey(0)
    want = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a, False, rngs={"segment": key, "dropout": key}))(
        params, *(jnp.asarray(a) for a in b[:6]))
    got = tm(*(_t(a) for a in b[:6]), starts=_t(_starts(u, b[3], 4)))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    jw, jl = jax.jit(lambda p, t, tl: jm.apply(
        {"params": p}, t, tl, method=jm.inference))(
        params, jnp.asarray(b[0]), jnp.asarray(b[1]))
    tw, tl = tm.inference(_t(b[0]), _t(b[1]))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close(tw, jw)


def test_jets_train_step_updates_like_jax(draws):
    b = _jets_batch()
    u = np.random.RandomState(7).rand(2).astype(np.float32)
    draws[(2,)] = u
    jm, tm, params = _jets_pair()
    tm.train()
    jd = jvoc.ParallelWaveGANDiscriminator(layers=3, channels=4)
    td = tvoc.ParallelWaveGANDiscriminator(layers=3, channels=4)
    dp = jax.device_get(jd.init(jax.random.PRNGKey(1),
                                jnp.zeros((1, 32, 1)))["params"])
    load_jax_params(td, dp)
    kw = dict(hop_length=HOP, mel_fs=16000, mel_n_fft=N_FFT, mel_bins=8)
    jstep = jax.jit(jgan.make_jets_train_step(jm, jd, _sgd(), _sgd(), **kw))
    jnew, jstats = jstep(jgan.GANTrainState.create(params, _sgd(), dp,
                                                   _sgd()),
                         *(jnp.asarray(a) for a in b),
                         jax.random.PRNGKey(0))
    state = tgan.GANTrainState(tm, td, _port_sgd(), _port_sgd())
    stats = tgan.make_jets_train_step(**kw)(
        state, *(_t(a) for a in b),
        draws={"starts": _t(_starts(u, b[3], 4))})
    assert set(stats) == set(jstats)
    for k in stats:
        _close(stats[k], jstats[k])
    _updates_close(td, dp, jnew.disc_params)
    _updates_close(tm, params, jnew.gen_params)
