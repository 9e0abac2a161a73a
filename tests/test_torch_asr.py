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
from espnet_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from espnet_tpu_torch.decode.asr_inference import Speech2Text
from espnet_tpu_torch.decode.scorers import length_bonus_scorer
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel

ENC_TOL = 1e-4     # float32, 2 conformer blocks over the log-mel frontend
SCORE_TOL = 1e-3   # summed log-probs over <= 15 label steps


def _torch_config():
    return ASRConfig(vocab_size=32, d_model=64, num_heads=4, d_ff=128,
                     num_encoder_layers=2, num_decoder_layers=2,
                     decoder_d_ff=128, conformer_kernel_size=7,
                     ctc_weight=0.3)


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
    jfields = {f.name for f in dataclasses.fields(JASRConfig)}
    tfields = {f.name for f in dataclasses.fields(ASRConfig)}
    assert tfields <= jfields
    tc, jc = _torch_config(), _flagship_config()
    assert (tc.sos_id, tc.eos_id, tc.blank_id) == (jc.sos_id, jc.eos_id,
                                                   jc.blank_id)


def test_unported_choices_raise():
    for kw in (dict(ctc_weight=1.0), dict(ctc_weight=0.0)):
        with pytest.raises(NotImplementedError):
            ASRModel(dataclasses.replace(_torch_config(), **kw))
    with pytest.raises(TypeError):  # only the bench model's choices exist
        ASRConfig(vocab_size=8, encoder_type="transformer")


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
