"""The port's S4 decoder and sinc frontend against the JAX package's,
float32 on the CPU: the S4D kernel, the layer's convolution mode against
its recurrence, the S4 decoder teacher-forced against its step-by-step
scoring, `SincConv` and `LightweightSincConvs`; then two reduced
`ASRModel`s with the same parameters in both packages (a 2-layer d 32
conformer with the S4 decoder, and one behind the sinc frontend): the
loss, every gradient and the beam search's token ids against the JAX
`Speech2Text`; the S4 configuration's full-width count and the
converter's round trip."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.decode.asr_inference import Speech2Text as JSpeech2Text
from espnet_tpu.models import sinc as jsinc
from espnet_tpu.models.asr import ASRConfig as JASRConfig
from espnet_tpu.models.asr import ASRModel as JASRModel
from espnet_tpu.ops import s4 as js4
from espnet_tpu_torch.configs import FAMILIES, bench_config
from espnet_tpu_torch.convert import (jax_params_to_state_dict,
                                      load_jax_params,
                                      state_dict_to_jax_params)
from espnet_tpu_torch.decode.asr_inference import Speech2Text
from espnet_tpu_torch.models import sinc as tsinc
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel, init_random_
from espnet_tpu_torch.models.s4_decoder import S4Decoder
from espnet_tpu_torch.ops import s4 as ts4

S4_FULL_WIDTH_PARAMS = 46_641_424
OP_TOL = 1e-5     # one layer, float32 (complex64 inside S4D)
SINC_TOL = 1e-4   # a 101-tap filter bank and three LayerNorms
LOSS_TOL = 1e-5
GRAD_TOL = 5e-4
KEYS = ("speech", "speech_lengths", "text", "text_lengths")
BASE = dict(vocab_size=24, n_mels=16, use_specaug=False, d_model=32,
            num_heads=4, d_ff=64, num_encoder_layers=2, num_decoder_layers=2,
            decoder_d_ff=64, conformer_kernel_size=5, dropout_rate=0.0,
            normalize="utterance_mvn")
MODELS = {"s4": dict(decoder_type="s4"),
          "sinc": dict(input_type="sinc", sinc_out_dim=24)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The beam searches and the Viterbi are loops of tiny ops: one
    intra-op thread keeps them from contending with the other test
    workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturb(tree, seed=1):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(
            np.float32), tree)


def _close(got, want, tol=OP_TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol, err_msg=msg)


def test_s4d_kernel_and_both_modes_match_jax():
    rng = np.random.RandomState(0)
    u = rng.randn(2, 13, 8).astype(np.float32)
    jm = js4.S4DLayer(8, 16)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(u))
    params = _perturb(v["params"])
    tm = ts4.S4DLayer(8, 16)
    tm.load_state_dict(jax_params_to_state_dict(params))
    with torch.no_grad():
        _close(tm.kernel(13), jm.apply({"params": params}, 13,
                                       method=js4.S4DLayer.kernel))
        y = tm(_t(u))
        _close(y, jm.apply({"params": params}, jnp.asarray(u)))
        state, steps = tm.init_state(2), []
        for i in range(13):
            y_t, state = tm.step(state, _t(u[:, i]))
            steps.append(y_t)
    _close(torch.stack(steps, 1), y.numpy())
    a_re, a_im, log_dt = ts4.s4d_init(8, 16)
    for got, want in zip((a_re, a_im, log_dt), js4.s4d_init(8, 16)):
        np.testing.assert_array_equal(got, want)


def test_s4_decoder_teacher_forcing_equals_steps():
    torch.manual_seed(0)
    dec = S4Decoder(20, d_model=16, num_heads=2, d_ff=32, num_layers=2,
                    state_dim=8, dropout_rate=0.0).eval()
    mem = torch.randn(2, 9, 16)
    mlens = torch.tensor([9, 6])
    tokens = torch.randint(1, 19, (2, 6))
    with torch.no_grad():
        logits = dec(tokens, None, mem, mlens)
        cache = dec.init_cache(2)
        for i in range(6):
            lp, cache = dec.score_step(tokens[:, i], i, mem, mlens, cache)
            _close(lp, torch.log_softmax(logits[:, i], -1).numpy())
    assert cache[0].dtype == torch.complex64


def test_sinc_conv_and_lightweight_sinc_convs_match_jax():
    rng = np.random.RandomState(2)
    speech = (0.1 * rng.randn(2, 3000)).astype(np.float32)
    lens = np.array([3000, 2100], np.int32)
    # parameters drawn by the port (no JAX init to compile)
    tm = init_random_(tsinc.LightweightSincConvs(
        win_length=400, hop_length=160, sinc_channels=16, out_dim=12),
        torch.Generator().manual_seed(0))
    params = _perturb(state_dict_to_jax_params(tm.state_dict()))
    tm.load_state_dict(jax_params_to_state_dict(params))
    jm = jsinc.LightweightSincConvs(win_length=400, hop_length=160,
                                    sinc_channels=16, out_dim=12)
    jf, jl = jax.jit(jm.apply)({"params": params}, jnp.asarray(speech),
                               jnp.asarray(lens))
    with torch.no_grad():
        tf, tl = tm(_t(speech), _t(lens))
        js = jax.jit(jsinc.SincConv(16).apply)(
            {"params": params["sinc"]}, jnp.asarray(speech[:, :500]))
        ts = tm.sinc(_t(speech[:, :500]))
    _close(ts, js, SINC_TOL, "SincConv")
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close(tf, jf, SINC_TOL, "LightweightSincConvs")


@pytest.fixture(scope="module", params=sorted(MODELS))
def reduced(request):
    cfg = ASRConfig(**BASE, **MODELS[request.param])
    rng = np.random.RandomState(0)
    lens = np.array([8000, 6000], np.int32)
    speech = (0.1 * rng.randn(2, 8000)).astype(np.float32)
    speech[np.arange(8000)[None] >= lens[:, None]] = 0.0
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


def test_reduced_loss_gradients_and_decode_match_jax(reduced):
    cfg, jm, params, jb, batch = reduced
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, *jb, True), has_aux=True))(params)
    tm = load_jax_params(ASRModel(cfg), params).train()
    tloss, tstats = tm(*(_t(batch[k]) for k in KEYS))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    for k in ("loss_ctc", "loss_att", "acc"):
        np.testing.assert_allclose(float(tstats[k].detach()),
                                   float(jstats[k]), rtol=LOSS_TOL,
                                   atol=1e-7, err_msg=k)
    want = jax_params_to_state_dict(jgrads)
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * max(1.0, np.abs(w).max()),
                                   err_msg=name)
    # the beam search (beam 3, CTC 0.3, 6 label steps); the S4 cache is a
    # list of complex states reordered with every other leaf
    js = JSpeech2Text(jm, params, beam_size=3, ctc_weight=0.3, max_steps=6)
    jy, jl, jsc = map(np.asarray, js._decode_jit(*jb[:2]))
    ts = Speech2Text(tm.eval(), device="cpu", beam_size=3, ctc_weight=0.3,
                     max_steps=6)
    ty, tl, tsc = (a.numpy() for a in ts.decode_batch(
        _t(batch["speech"]), _t(batch["speech_lengths"]).long()))
    np.testing.assert_array_equal(tl, jl)
    for bi in range(jy.shape[0]):
        for wi in range(jy.shape[1]):
            np.testing.assert_array_equal(ty[bi, wi, :tl[bi, wi]],
                                          jy[bi, wi, :jl[bi, wi]])
    np.testing.assert_allclose(tsc, jsc, atol=1e-4, rtol=1e-5)


def test_full_width_count_and_round_trip(reduced):
    full = ASRModel(bench_config(torch.float32, **FAMILIES["s4_decoder"]))
    assert sum(p.numel() for p in full.parameters()) == S4_FULL_WIDTH_PARAMS
    cfg, jm, params, jb, _ = reduced
    assert_jax_layout(jm, jb, params)
    back = state_dict_to_jax_params(
        load_jax_params(ASRModel(cfg), params).state_dict())
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(back))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        params, back)
