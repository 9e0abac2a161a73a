"""The port's multichannel frontend against the JAX package's, on the CPU
in complex64: `psd_matrix`, `mvdr_weights`, `wpe` (3 iterations),
`apply_beamformer`, `gcc_phat_tdoa` and `delay_and_sum` on seeded
signals; then a reduced `num_channels` 2 `ASRModel` (a 2-layer d 32
conformer behind the mask-MVDR beamformer, with and without DNN-WPE) with
the same parameters in both packages: encode, the loss and every
gradient, and the converter's round trip."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models.asr import ASRConfig as JASRConfig
from espnet_tpu.models.asr import ASRModel as JASRModel
from espnet_tpu.ops import beamformer as jbf
from espnet_tpu_torch.convert import (jax_params_to_state_dict,
                                      load_jax_params,
                                      state_dict_to_jax_params)
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel, init_random_
from espnet_tpu_torch.ops import beamformer as tbf

# complex64 solves of 4x4 and 10x10 systems, LAPACK on both sides
OP_TOL = 1e-4
ENC_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
KEYS = ("speech", "speech_lengths", "text", "text_lengths")
BASE = dict(vocab_size=24, n_mels=16, n_fft=64, hop_length=32,
            use_specaug=False, d_model=32, num_heads=4, d_ff=64,
            num_encoder_layers=2, num_decoder_layers=1, decoder_d_ff=64,
            conformer_kernel_size=5, dropout_rate=0.0,
            normalize="utterance_mvn", num_channels=2, frontend_hidden=8,
            frontend_layers=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The LSTM loops are thousands of tiny ops: one intra-op thread keeps
    them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=OP_TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol,
                               err_msg=msg)


def _complex(rng, *shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def test_ops_match_jax():
    rng = np.random.RandomState(0)
    y = _complex(rng, 2, 5, 4, 30)          # (B, F, C, T)
    mask = rng.rand(2, 5, 30).astype(np.float32)
    noise = rng.rand(2, 5, 30).astype(np.float32)
    u = np.zeros((2, 4), np.float32)
    u[:, 1] = 1.0
    jps = jbf.psd_matrix(jnp.asarray(y), jnp.asarray(mask))
    jpn = jbf.psd_matrix(jnp.asarray(y), jnp.asarray(noise))
    tps = tbf.psd_matrix(_t(y), _t(mask))
    tpn = tbf.psd_matrix(_t(y), _t(noise))
    _close(tps, jps, msg="psd_matrix")
    jw = jbf.mvdr_weights(jps, jpn, jnp.asarray(u))
    tw = tbf.mvdr_weights(tps, tpn, _t(u))
    _close(tw, jw, msg="mvdr_weights")
    _close(tbf.apply_beamformer(tw, _t(y)),
           jbf.apply_beamformer(jw, jnp.asarray(y)), msg="apply_beamformer")
    jwpe = jax.jit(jbf.wpe, static_argnames=("taps", "delay"))
    _close(tbf.wpe(_t(y[:, :, :2]), taps=3, delay=2),
           jwpe(jnp.asarray(y[:, :, :2]), taps=3, delay=2), msg="wpe")


def test_gcc_phat_and_delay_and_sum_match_jax():
    rng = np.random.RandomState(1)
    ref = rng.randn(2000).astype(np.float32)
    chans = np.stack([ref, np.roll(ref, 7), 0.5 * np.roll(ref, -12)
                      + 0.05 * rng.randn(2000).astype(np.float32)])
    for i in range(3):
        got = int(tbf.gcc_phat_tdoa(_t(chans[0]), _t(chans[i]), 50))
        assert got == int(jbf.gcc_phat_tdoa(jnp.asarray(chans[0]),
                                            jnp.asarray(chans[i]), 50))
    assert int(tbf.gcc_phat_tdoa(_t(chans[0]), _t(chans[1]), 50)) == 7
    for weighted in (True, False):
        _close(tbf.delay_and_sum(_t(chans), 0, 50, weighted),
               jbf.delay_and_sum(jnp.asarray(chans), 0, 50, weighted),
               tol=1e-5, msg=f"delay_and_sum weighted={weighted}")


@pytest.fixture(scope="module", params=[False, True], ids=["mvdr", "wpe"])
def reduced(request):
    cfg = ASRConfig(**BASE, use_wpe=request.param)
    rng = np.random.RandomState(0)
    lens = np.array([3200, 2400], np.int32)  # 101 and 76 STFT frames
    speech = (0.1 * rng.randn(2, 3200, 2)).astype(np.float32)
    speech[np.arange(3200)[None] >= lens[:, None]] = 0.0
    text = rng.randint(1, 23, (2, 5)).astype(np.int32)
    tlens = np.array([5, 3], np.int32)
    text[np.arange(5)[None] >= tlens[:, None]] = 0
    batch = dict(zip(KEYS, (speech, lens, text, tlens)))
    jm = JASRModel(JASRConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(cfg)
                                 if f.name != "dtype"}))
    jb = tuple(jnp.asarray(batch[k]) for k in KEYS)
    return cfg, jm, port_drawn_params(cfg), jb, batch


def port_drawn_params(cfg):
    """A JAX parameter tree drawn by the port's initialiser and perturbed
    (zero-initialised leaves too); its layout is held against JAX's own
    by `assert_jax_layout`."""
    model = init_random_(ASRModel(cfg), torch.Generator().manual_seed(0))
    prng = np.random.RandomState(1)
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * prng.randn(*a.shape).astype(np.float32),
        state_dict_to_jax_params(model.state_dict()))


def assert_jax_layout(jm, jb, params):
    """`params` has the keys and shapes of the JAX model's own tree."""
    want = jax.eval_shape(lambda: fnn.meta.unbox(jm.init(
        jax.random.PRNGKey(0), *jb, True))["params"])

    def shapes(tree):
        return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)

    assert shapes(want) == shapes(params)


def test_reduced_encode_loss_and_gradients_match_jax(reduced):
    cfg, jm, params, jb, batch = reduced

    def loss_and_encode(p):
        loss, stats = jm.apply({"params": p}, *jb, True)
        enc = jm.apply({"params": p}, *jb[:2], method=JASRModel.encode)
        return loss, (stats, enc)

    (jloss, (jstats, (je, jl))), jgrads = jax.jit(jax.value_and_grad(
        loss_and_encode, has_aux=True))(params)
    tm = load_jax_params(ASRModel(cfg), params).train()
    with torch.no_grad():
        te, tl = tm.encode(_t(batch["speech"]), _t(batch["speech_lengths"]))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close(te, je, ENC_TOL, "encode")
    tloss, tstats = tm(*(_t(batch[k]) for k in KEYS))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    want = jax_params_to_state_dict(jgrads)
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    assert any(n.startswith("frontend_beamformer.mask_est.") for n in got)
    assert cfg.use_wpe == any(n.startswith("frontend_wpe.") for n in got)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * max(1.0, np.abs(w).max()),
                                   err_msg=name)
    assert_jax_layout(jm, jb, params)
    back = state_dict_to_jax_params(tm.state_dict())
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(back))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        params, back)
