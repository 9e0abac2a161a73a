"""The port's multi-encoder ASR (`models/mulenc.py`) and its search
(`bin/asr_mulenc_inference.py` `Speech2TextMulEnc`) against the JAX
package's, float32 on the CPU.

A reduced model (two streams of one transformer layer at d_model 64, a
one-layer HAN decoder, vocab 20, SpecAug and dropout off, training CTC
weights 2:1 and decoding weights 1:3) on streams of different lengths, with
parameters carried over from JAX: the loss, its per-stream stats and every
gradient, the log-linear CTC fusion, the decoder's incremental
`score_step` (three steps against a cache), and the beam search's token ids
(beam 3, 8 label steps) with its scores.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.bin.asr_mulenc_inference import \
    Speech2TextMulEnc as JSpeech2TextMulEnc
from espnet_tpu.models import mulenc as jme
from espnet_tpu.tasks.asr_mulenc import MulEncModelSection as JSection
from espnet_tpu_torch.bin.asr_mulenc_inference import Speech2TextMulEnc
from espnet_tpu_torch.configs import mulenc_transformer
from espnet_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from espnet_tpu_torch.models import mulenc as tme
from espnet_tpu_torch.tasks.asr_mulenc import (ASRMulEncTask,
                                               MulEncModelSection)

FULL_WIDTH_PARAMS = 20_399_264
# two encoders, the HAN decoder and E + 1 losses: float32 sums in another
# order; gradients through one more pass; the search's scores add up to
# 8 steps of such log-probs
LOSS_TOL = 1e-5
GRAD_TOL = 5e-4
STEP_TOL = 1e-5
SCORE_TOL = 1e-4

REDUCED = dict(vocab_size=20, n_mels=16, use_specaug=False, d_model=64,
               num_heads=4, d_ff=128, num_encoder_layers=1,
               num_decoder_layers=1, decoder_d_ff=128, dropout_rate=0.0,
               weights_ctc_train="2,1", weights_ctc_dec="1,3")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch():
    rng = np.random.RandomState(0)
    slen = np.array([[8000, 7000], [6000, 6400], [4000, 3000]], np.int32)
    speech = np.zeros((3, 8000, 2), np.float32)
    for i in range(3):
        for e in range(2):
            speech[i, :slen[i, e], e] = 0.1 * rng.randn(slen[i, e])
    text = rng.randint(1, 19, (3, 5)).astype(np.int32)
    tlen = np.array([5, 3, 2], np.int32)
    text[np.arange(5)[None, :] >= tlen[:, None]] = 0
    return speech, slen, text, tlen


@pytest.fixture(scope="module")
def reduced():
    jm = jme.ASRMulEncModel(jme.MulEncConfig(**REDUCED))
    batch = tuple(jnp.asarray(a) for a in _batch())
    v = fnn.meta.unbox(jax.jit(jm.init, static_argnums=(5,))(
        jax.random.PRNGKey(0), *batch, True))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a)
        + 0.05 * rng.randn(*a.shape).astype(np.float32), v["params"])
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, *batch, True), has_aux=True))(
        params)

    @jax.jit
    def steps(p):
        enc, elen = jm.apply({"params": p}, batch[0], batch[1],
                             method=jme.ASRMulEncModel.encode)
        fused = jm.apply({"params": p}, enc, method=jme.ASRMulEncModel
                         .ctc_log_probs)
        cache = jm.apply({"params": p}, 3, 4,
                         method=jme.ASRMulEncModel.decoder_init_cache)
        out = []
        for pos, tok in enumerate(([19, 19, 19], [4, 7, 1], [2, 2, 9])):
            lp, cache = jm.apply(
                {"params": p}, jnp.asarray(tok), pos, enc, elen, cache,
                method=jme.ASRMulEncModel.decoder_score_step)
            out.append(lp)
        return fused, jnp.stack(out)

    fused, step_lps = steps(params)
    conv = _Conv()
    search = JSpeech2TextMulEnc(jm, {"params": params}, conv, 3, 0.3, 8)
    decoded = search(batch[0], batch[1], ["a", "b", "c"])
    return params, (jloss, jstats, jgrads), (fused, step_lps), decoded


class _Conv:
    """Token ids as letters (the searches' text)."""

    def ids2tokens(self, ids):
        return [chr(ord("a") + i) for i in ids]


def _port(params):
    return load_jax_params(
        tme.ASRMulEncModel(tme.MulEncConfig(**REDUCED)), params)


def test_parse_weights():
    assert tme.parse_weights("", 2) == (0.5, 0.5)
    np.testing.assert_allclose(tme.parse_weights("3,1", 2), (0.75, 0.25))
    with pytest.raises(ValueError):
        tme.parse_weights("1,2,3", 2)


def test_loss_stats_and_every_gradient_match_jax(reduced):
    params, (jloss, jstats, jgrads), _, _ = reduced
    model = _port(params).train()
    loss, stats = model(*(_t(a) for a in _batch()))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    assert set(stats) == set(jstats) == {"loss_ctc1", "loss_ctc2",
                                         "loss_ctc", "loss_att", "acc",
                                         "loss"}
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()),
                                   float(jstats[k]), rtol=LOSS_TOL,
                                   atol=1e-7, err_msg=k)
    want = jax_params_to_state_dict(jgrads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def test_ctc_fusion_and_score_step_match_jax(reduced):
    params, _, (jfused, jsteps), _ = reduced
    speech, slen, _, _ = _batch()
    model = _port(params).eval()
    with torch.no_grad():
        enc, elen = model.encode(_t(speech), _t(slen))
        fused = model.ctc_log_probs(enc)
        cache = model.decoder_init_cache(3, 4)
        lps = []
        for pos, tok in enumerate(([19, 19, 19], [4, 7, 1], [2, 2, 9])):
            lp, cache = model.decoder_score_step(torch.tensor(tok), pos, enc,
                                                 elen, cache)
            lps.append(lp)
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfused),
                               rtol=STEP_TOL, atol=STEP_TOL)
    np.testing.assert_allclose(torch.stack(lps).numpy(), np.asarray(jsteps),
                               rtol=STEP_TOL, atol=STEP_TOL)


def test_search_ids_and_scores_match_jax(reduced):
    params, _, _, jdecoded = reduced
    speech, slen, _, _ = _batch()
    s2t = Speech2TextMulEnc(_port(params), _Conv(), beam_size=3,
                            ctc_weight=0.3, max_steps=8, device="cpu")
    got = s2t(speech, slen, ["a", "b", "c"])
    assert [g[:2] for g in got] == [j[:2] for j in jdecoded]
    for g, j in zip(got, jdecoded):
        assert abs(g[2] - j[2]) <= SCORE_TOL * max(1.0, abs(j[2]))


def test_config_section_and_full_width_model():
    jf = {f.name: f.default for f in dataclasses.fields(JSection)}
    tf = {f.name: f.default for f in dataclasses.fields(MulEncModelSection)}
    assert set(jf) == set(tf)
    assert all(tf[k] == jf[k] for k in jf if k != "dtype")
    model = tme.ASRMulEncModel(mulenc_transformer(torch.float32))
    assert sum(p.numel() for p in model.parameters()) == FULL_WIDTH_PARAMS
    shared = ASRMulEncTask.build_model(MulEncModelSection(
        **{k: v for k, v in REDUCED.items() if k != "vocab_size"},
        share_ctc=True, dtype="bfloat16"), 20)
    assert shared.config.dtype == torch.bfloat16
    assert hasattr(shared, "ctc_head0") and not hasattr(shared, "ctc_head1")
