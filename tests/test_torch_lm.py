"""The port's language models (`models/lm.py`, `tasks/lm.py`) and shallow
fusion (`decode/scorers.py` `lm_scorer`, `Speech2Text(lm_model=...)`)
against the JAX package's, float32 on the CPU.

Reduced LMs (a 2-layer transformer LM of d_model 64 and FFN 128, a 2-layer
LSTM LM of 64 units; vocab 20; dropout off) with parameters carried over
from JAX: the sos/eos loss of `LMTrainModel`, its perplexity stats and
every gradient on ragged lengths, and `score_step` from `init_cache`
token by token against JAX's. Then a reduced ASR model (one transformer
layer of d_model 64, a one-layer decoder) decoded with the transformer LM
at weight 0.5 (beam 3, 8 label steps): the port's `Speech2Text` against
JAX's with the same LM, token ids equal and scores within 1e-4.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.decode.asr_inference import Speech2Text as JSpeech2Text
from espnet_tpu.models import asr as jasr
from espnet_tpu.tasks import lm as jlm
from espnet_tpu_torch.configs import LM_VOCAB, transformer_lm
from espnet_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from espnet_tpu_torch.decode.asr_inference import Speech2Text
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel
from espnet_tpu_torch.tasks.lm import LMModelConfig, LMTask

FULL_WIDTH_PARAMS = 7_304_072
# float32 sums in another order through 2 layers; gradients through one
# more pass; the search's scores add up to 8 steps of such log-probs
LOSS_TOL = 1e-5
GRAD_TOL = 5e-4
STEP_TOL = 1e-5
SCORE_TOL = 1e-4
VOCAB = 20

LMS = {
    "transformer": dict(lm_type="transformer", d_model=64, num_heads=4,
                        d_ff=128, num_layers=2, dropout_rate=0.0),
    "rnn": dict(lm_type="rnn", d_model=64, num_layers=2, dropout_rate=0.0),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _text():
    rng = np.random.RandomState(0)
    text = rng.randint(1, VOCAB - 1, (3, 7)).astype(np.int32)
    tlen = np.array([7, 4, 1], np.int32)
    text[np.arange(7)[None, :] >= tlen[:, None]] = 0
    return text, tlen


def _jax_lm(kind):
    """(JAX LMTrainModel, its params perturbed from init)."""
    jm = jlm.LMTask.build_model(jlm.LMModelConfig(**LMS[kind]), VOCAB)
    v = fnn.meta.unbox(jax.jit(jm.init, static_argnums=(3,))(
        jax.random.PRNGKey(0), *map(jnp.asarray, _text()), True))
    rng = np.random.RandomState(1)
    return jm, jax.tree_util.tree_map(
        lambda a: np.asarray(a)
        + 0.05 * rng.randn(*a.shape).astype(np.float32), v["params"])


STEPS = ([19, 19, 19], [4, 7, 1], [2, 2, 9], [5, 3, 3])


@pytest.fixture(scope="module", params=sorted(LMS))
def lm(request):
    kind = request.param
    jm, params = _jax_lm(kind)
    text = tuple(map(jnp.asarray, _text()))
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, *text, True), has_aux=True))(
        params)
    inner = jm.lm

    @jax.jit
    def steps(p):
        v = {"params": p["lm"]}
        cache = inner.apply(v, 3, len(STEPS),
                            method=type(inner).init_cache)
        out = []
        for pos, tok in enumerate(STEPS):
            lp, cache = inner.apply(v, jnp.asarray(tok), pos, cache,
                                    method=type(inner).score_step)
            out.append(lp)
        return jnp.stack(out)

    return kind, params, (jloss, jstats, jgrads), steps(params)


def _port_lm(kind, params):
    return load_jax_params(
        LMTask.build_model(LMModelConfig(**LMS[kind]), VOCAB), params)


def test_loss_stats_and_every_gradient_match_jax(lm):
    kind, params, (jloss, jstats, jgrads), _ = lm
    model = _port_lm(kind, params).train()
    loss, stats = model(*(_t(a) for a in _text()))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    assert set(stats) == set(jstats) == {"loss", "ppl", "nll_sum",
                                         "ntokens"}
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()),
                                   float(jstats[k]), rtol=LOSS_TOL,
                                   err_msg=k)
    want = jax_params_to_state_dict(jgrads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def test_score_step_matches_jax(lm):
    kind, params, _, jsteps = lm
    inner = _port_lm(kind, params).lm.eval()
    with torch.no_grad():
        cache = inner.init_cache(3, len(STEPS))
        lps = []
        for pos, tok in enumerate(STEPS):
            lp, cache = inner.score_step(torch.tensor(tok), pos, cache)
            lps.append(lp)
    np.testing.assert_allclose(torch.stack(lps).numpy(), np.asarray(jsteps),
                               rtol=STEP_TOL, atol=STEP_TOL)


ASR = dict(vocab_size=VOCAB, n_mels=16, use_specaug=False,
           normalize="utterance_mvn", encoder_type="transformer",
           d_model=64, num_heads=4, d_ff=128, num_encoder_layers=1,
           num_decoder_layers=1, decoder_d_ff=128, dropout_rate=0.0)


def test_shallow_fusion_matches_jax_speech2text():
    rng = np.random.RandomState(2)
    slen = np.array([8000, 5600], np.int32)
    speech = np.zeros((2, 8000), np.float32)
    for i, n in enumerate(slen):
        speech[i, :n] = 0.1 * rng.randn(n)
    jm = jasr.ASRModel(jasr.ASRConfig(**ASR))
    v = fnn.meta.unbox(jax.jit(jm.init, static_argnums=(5,))(
        jax.random.PRNGKey(0), jnp.asarray(speech), jnp.asarray(slen),
        jnp.zeros((2, 3), jnp.int32), jnp.array([3, 3]), True))
    asr_params = jax.tree_util.tree_map(
        lambda a: np.asarray(a)
        + 0.1 * rng.randn(*a.shape).astype(np.float32), v["params"])
    jtrain, lm_params = _jax_lm("transformer")
    kw = dict(beam_size=3, ctc_weight=0.3, max_steps=8)
    jres = JSpeech2Text(jm, asr_params, lm_model=jtrain.lm,
                        lm_params=lm_params["lm"], lm_weight=0.5, **kw)(
        speech, slen, nbest=3)
    model = load_jax_params(ASRModel(ASRConfig(**ASR)), asr_params)
    lm_model = _port_lm("transformer", lm_params).lm
    got = Speech2Text(model, device="cpu", lm_model=lm_model, lm_weight=0.5,
                      **kw)(speech, slen, nbest=3)
    plain = Speech2Text(model, device="cpu", **kw)(speech, slen, nbest=3)
    for g, j in zip(got, jres):
        assert [ids for ids, _ in g.nbest] == [ids for ids, _ in j.nbest]
        for (_, gs), (_, js) in zip(g.nbest, j.nbest):
            assert abs(gs - js) <= SCORE_TOL * max(1.0, abs(js))
    assert [r.score for r in got] != [r.score for r in plain]


def test_config_and_full_width_lm():
    jf = {f.name: f.default for f in dataclasses.fields(jlm.LMModelConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(LMModelConfig)}
    assert jf == tf
    jd = {f.name: f.default for f in dataclasses.fields(jlm.LMDataConfig)}
    td = {f.name: f.default for f in dataclasses.fields(
        LMTask.sections["data"])}
    assert jd == td
    model = LMTask.build_model(transformer_lm(), LM_VOCAB, torch.bfloat16)
    assert sum(p.numel() for p in model.parameters()) == FULL_WIDTH_PARAMS
    assert model.lm.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="lm_type"):
        LMTask.build_model(LMModelConfig(lm_type="ngram"), VOCAB)
