"""The slice as a whole: a tiny conformer ASR model (d=64, 2 encoder and 2
decoder layers, vocab 32, conv kernel 7) built in JAX, its parameters carried
into the PyTorch port, then encode, CTC log-probs and Speech2Text's n-best
compared on three ragged utterances, float32 on the CPU."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from espnet_tpu.decode.asr_inference import Speech2Text as JSpeech2Text
from espnet_tpu.decode.scorers import length_bonus_scorer as jlength_bonus
from espnet_tpu.models.asr import ASRConfig as JASRConfig
from espnet_tpu.models.asr import ASRModel as JASRModel
from espnet_tpu.ops.normalize import global_mvn as jglobal_mvn
from espnet_tpu.ops.normalize import global_mvn_params as jglobal_mvn_params
from espnet_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from espnet_tpu_torch.decode.asr_inference import Speech2Text
from espnet_tpu_torch.decode.scorers import length_bonus_scorer
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel
from espnet_tpu_torch.ops.normalize import global_mvn, global_mvn_params

ENC_TOL = 1e-4     # float32, 2 conformer blocks over the log-mel frontend
SCORE_TOL = 1e-3   # summed log-probs over <= 15 label steps


def _torch_config():
    return ASRConfig(vocab_size=32, d_model=64, num_heads=4, d_ff=128,
                     num_encoder_layers=2, num_decoder_layers=2,
                     decoder_d_ff=128, conformer_kernel_size=7,
                     ctc_weight=0.3, normalize="utterance_mvn")


@pytest.fixture(scope="module")
def slice_models():
    rng = np.random.RandomState(0)
    lens = np.array([4000, 6500, 8000], np.int32)
    speech = (0.1 * rng.randn(3, 8000)).astype(np.float32)
    speech[np.arange(8000)[None] >= lens[:, None]] = 0.0
    jcfg = _flagship_config(conformer_kernel_size=7)
    jm = JASRModel(jcfg)
    init = jax.jit(jm.init, static_argnums=(5,))
    v = fnn.meta.unbox(init(
        jax.random.PRNGKey(0), jnp.asarray(speech), jnp.asarray(lens),
        jnp.ones((3, 4), jnp.int32), jnp.full((3,), 4, jnp.int32), True))
    # perturb every leaf so zero-initialised biases are exercised too
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a)
        + 0.05 * rng.randn(*a.shape).astype(np.float32), v["params"])
    tm = load_jax_params(ASRModel(_torch_config()), params)
    return jm, params, tm, speech, lens


def test_config_mirrors_the_jax_config():
    """Every field the port has exists in JAX with the same default, so a
    config that leaves a field out means the same model in both."""
    jdefaults = {f.name: f.default for f in dataclasses.fields(JASRConfig)}
    for f in dataclasses.fields(ASRConfig):
        assert f.name in jdefaults, f.name
        want = jdefaults[f.name]
        if f.name == "dtype":  # jnp.float32 vs torch.float32
            assert str(f.default).split(".")[-1] == want.__name__
        else:
            assert f.default == want, (f.name, f.default, want)
    tc, jc = _torch_config(), _flagship_config()
    assert (tc.sos_id, tc.eos_id, tc.blank_id) == (jc.sos_id, jc.eos_id,
                                                   jc.blank_id)


def test_unported_choices_raise():
    for kw in (dict(ctc_weight=1.0), dict(ctc_weight=0.0),
               dict(encoder_type="longformer")):
        with pytest.raises(NotImplementedError):
            ASRModel(dataclasses.replace(_torch_config(), **kw))
    with pytest.raises(ValueError, match="normalize"):
        ASRModel(dataclasses.replace(_torch_config(), normalize="cmvn"))


def test_encode_and_ctc_log_probs_match(slice_models):
    jm, params, tm, speech, lens = slice_models
    je, jl = jm.apply({"params": params}, jnp.asarray(speech),
                      jnp.asarray(lens), method=JASRModel.encode)
    jlp = jm.apply({"params": params}, je, method=JASRModel.ctc_log_probs)
    with torch.no_grad():
        te, tl = tm.encode(torch.from_numpy(speech), torch.from_numpy(lens))
        tlp = tm.ctc_log_probs(te)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=ENC_TOL,
                               rtol=ENC_TOL)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=ENC_TOL,
                               rtol=ENC_TOL)


def _assert_same_nbest(jres, tres):
    for jr, tr in zip(jres, tres):
        assert len(jr.nbest) == len(tr.nbest)
        for (jids, jsc), (tids, tsc) in zip(jr.nbest, tr.nbest):
            assert tids == jids
            np.testing.assert_allclose(tsc, jsc, atol=SCORE_TOL,
                                       rtol=SCORE_TOL)
        assert tr.token_ids == jr.token_ids


@pytest.mark.parametrize("kw", [dict(), dict(max_steps=6)],
                         ids=["encoder_length", "max_steps"])
def test_speech2text_nbest_matches(slice_models, kw):
    jm, params, tm, speech, lens = slice_models
    jres = JSpeech2Text(jm, params, beam_size=4, ctc_weight=0.3, **kw)(
        speech, lens, nbest=4)
    tres = Speech2Text(tm, device="cpu", beam_size=4, ctc_weight=0.3, **kw)(
        speech, lens, nbest=4)
    assert all(np.isfinite(r.score) and r.token_ids for r in tres)
    _assert_same_nbest(jres, tres)


def test_speech2text_extra_scorer_matches(slice_models):
    jm, params, tm, speech, lens = slice_models
    jres = JSpeech2Text(jm, params, beam_size=3, ctc_weight=0.3, max_steps=5,
                        extra_scorers=[jlength_bonus(32, 0.7)])(
        speech, lens, nbest=3)
    tres = Speech2Text(tm, device="cpu", beam_size=3, ctc_weight=0.3,
                       max_steps=5, extra_scorers=[length_bonus_scorer(32, 0.7)])(
        speech, lens, nbest=3)
    _assert_same_nbest(jres, tres)


def test_converter_layouts(slice_models):
    _, params, tm, _, _ = slice_models
    sd = jax_params_to_state_dict(params)
    enc = params["encoder"]
    np.testing.assert_array_equal(
        sd["encoder.embed.conv1.weight"].numpy(),
        np.transpose(enc["embed"]["conv1"]["kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(
        sd["encoder.layer0.conv.depthwise_conv.weight"].numpy(),
        np.transpose(enc["layer0"]["conv"]["depthwise_conv"]["kernel"],
                     (2, 1, 0)))
    np.testing.assert_array_equal(
        sd["encoder.layer0.ff1.w1.weight"].numpy(),
        enc["layer0"]["ff1"]["w1"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["encoder.layer0.norm_ff1.weight"].numpy(),
        enc["layer0"]["norm_ff1"]["scale"])
    np.testing.assert_array_equal(
        sd["encoder.layer0.self_attn.pos_bias_u"].numpy(),
        enc["layer0"]["self_attn"]["pos_bias_u"])
    assert tm.encoder.layer0.norm_ff1.eps == 1e-6


def test_converter_refuses_what_it_cannot_place(slice_models):
    _, params, _, _, _ = slice_models
    with pytest.raises(NotImplementedError, match="scan_layers"):
        jax_params_to_state_dict(
            {"encoder": {"layers": {"block": {"norm_ff1": {
                "scale": np.ones((2, 64), np.float32)}}}}})
    extra = dict(params, extra_head={"kernel": np.zeros((64, 3), np.float32)})
    with pytest.raises(KeyError, match="extra_head"):
        load_jax_params(ASRModel(_torch_config()), extra)
    short = {k: v for k, v in params.items() if k != "ctc_head"}
    with pytest.raises(KeyError, match="ctc_head"):
        load_jax_params(ASRModel(_torch_config()), short)
    wrong = ASRModel(dataclasses.replace(_torch_config(), d_ff=256))
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(wrong, params)


def test_global_mvn_model_loads_its_stats_and_matches():
    """The JAX default config normalises with global MVN: with random
    (non-identity) statistics in the `mvn` collection, the port carries them
    and encodes the same; from the params alone it refuses to load."""
    rng = np.random.RandomState(3)
    lens = np.array([6000, 4000], np.int32)
    speech = (0.1 * rng.randn(2, 6000)).astype(np.float32)
    jcfg = _flagship_config(normalize="global_mvn")
    jm = JASRModel(jcfg)
    v = fnn.meta.unbox(jax.jit(jm.init, static_argnums=(5,))(
        jax.random.PRNGKey(0), jnp.asarray(speech), jnp.asarray(lens),
        jnp.ones((2, 3), jnp.int32), jnp.full((2,), 3, jnp.int32), True))
    mvn = {"mvn": {"mean": rng.randn(80).astype(np.float32),
                   "inv_std": (0.5 + rng.rand(80)).astype(np.float32)}}
    variables = {"params": v["params"], "mvn": mvn}
    je, _ = jm.apply(variables, jnp.asarray(speech), jnp.asarray(lens),
                     method=JASRModel.encode)
    tcfg = dataclasses.replace(_torch_config(), normalize="global_mvn")
    assert ASRConfig(vocab_size=32).normalize == "global_mvn"
    with pytest.raises(KeyError, match="global MVN"):
        load_jax_params(ASRModel(tcfg), v["params"])
    tm = load_jax_params(ASRModel(tcfg), variables).eval()
    np.testing.assert_array_equal(tm.mvn.inv_std.numpy(),
                                  mvn["mvn"]["inv_std"])
    with torch.no_grad():
        te, _ = tm.encode(torch.from_numpy(speech), torch.from_numpy(lens))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=ENC_TOL,
                               rtol=ENC_TOL)
    with pytest.raises(KeyError, match="mvn"):  # stats the model cannot use
        load_jax_params(ASRModel(_torch_config()), variables)


@pytest.mark.parametrize("norm_means,norm_vars", [(True, True), (True, False),
                                                  (False, True)])
def test_global_mvn_stats_and_apply_match_jax(norm_means, norm_vars):
    """{count, sum, sum_square} -> (mean, inv_std), then the padded apply."""
    rng = np.random.RandomState(4)
    feats = (2.0 + rng.randn(500, 6)).astype(np.float32)
    stats = {"count": 500, "sum": feats.sum(0),
             "sum_square": (feats.astype(np.float64) ** 2).sum(0)}
    want = jglobal_mvn_params(stats, norm_means, norm_vars)
    got = global_mvn_params(stats, norm_means, norm_vars)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    x = rng.randn(2, 7, 6).astype(np.float32)
    lens = np.array([7, 4], np.int32)
    np.testing.assert_allclose(
        global_mvn(torch.from_numpy(x), torch.from_numpy(lens),
                   *map(torch.from_numpy, got)).numpy(),
        np.asarray(jglobal_mvn(jnp.asarray(x), jnp.asarray(lens),
                               *map(jnp.asarray, want))),
        atol=1e-6, rtol=1e-6)
