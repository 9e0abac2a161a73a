"""The port's MT and ST models (`models/mt.py`, `models/st.py`) and their
searches against the JAX package's, float32 on the CPU.

Reduced models (2 encoder and 2 decoder layers of d_model 64, 4 heads, FFN
128; vocab 12 target and 10 source; dropout and SpecAug off) on ragged
batches, with parameters drawn by the port's initialiser in JAX's layout
(`assert_jax_layout` holds it against `jax.eval_shape` of the JAX init) and
perturbed: the loss, its stats and every gradient. ST runs four
`asr_weight` / `mtlalpha` cases: the `st_conformer` setting (CTC head over
the source vocabulary only), CTC and the ASR decoder (with global MVN from
injected statistics), the ASR decoder only, and no auxiliary loss. The JAX
encoder layers route their attention and FFN to plain XLA at these shapes
and the port's plain versions stand for its kernels on the CPU, so the two
differ by float32 rounding alone. Then `Speech2Text` on the MT model
(integer source ids) against JAX's: token ids equal, scores within 1e-4.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.decode.asr_inference import Speech2Text as JSpeech2Text
from espnet_tpu.models import mt as jmt
from espnet_tpu.models import st as jst
from espnet_tpu.tasks.mt import MTTask as JMTTask
from espnet_tpu.tasks.st import STTask as JSTTask
from espnet_tpu_torch.configs import mt_transformer, st_conformer
from espnet_tpu_torch.convert import (jax_params_to_state_dict,
                                      load_jax_params, model_params,
                                      state_dict_to_jax_params)
from espnet_tpu_torch.decode.asr_inference import Speech2Text
from espnet_tpu_torch.models import mt as tmt
from espnet_tpu_torch.models import st as tst
from espnet_tpu_torch.models.asr import init_random_
from espnet_tpu_torch.tasks.mt import MTTask
from espnet_tpu_torch.tasks.st import STTask

# the JAX model's count at full width (`jax.eval_shape` of its init)
MT_FULL_WIDTH_PARAMS = 21_208_968
ST_FULL_WIDTH_PARAMS = 46_836_496
# float32 sums in another order through 2 + 2 layers; gradients through one
# more pass; the search's scores add up to 8 steps of such log-probs
LOSS_TOL = 1e-5
GRAD_TOL = 5e-4
SCORE_TOL = 1e-4

MT = dict(vocab_size=12, src_vocab_size=10, d_model=64, num_heads=4,
          d_ff=128, num_encoder_layers=2, num_decoder_layers=2,
          decoder_d_ff=128, dropout_rate=0.0)
ST = dict(vocab_size=12, src_vocab_size=10, n_mels=16, use_specaug=False,
          normalize="utterance_mvn", d_model=64, num_heads=4, d_ff=128,
          num_encoder_layers=2, num_decoder_layers=2, decoder_d_ff=128,
          num_asr_decoder_layers=1, dropout_rate=0.0,
          conformer_kernel_size=7)
ST_CASES = {
    "conformer_ctc": dict(encoder_type="conformer", asr_weight=0.3,
                          mtlalpha=1.0),
    "conformer_ctc_att_global_mvn": dict(
        encoder_type="conformer", asr_weight=0.3, mtlalpha=0.5,
        normalize="global_mvn"),
    "transformer_att": dict(encoder_type="transformer", asr_weight=0.3,
                            mtlalpha=0.0),
    "transformer_st_only": dict(encoder_type="transformer", asr_weight=0.0),
}
ST_STATS = {
    "conformer_ctc": {"loss_st", "acc", "loss_asr_ctc", "loss"},
    "conformer_ctc_att_global_mvn": {"loss_st", "acc", "loss_asr_ctc",
                                     "loss_asr_att", "asr_acc", "loss"},
    "transformer_att": {"loss_st", "acc", "loss_asr_att", "asr_acc",
                        "loss"},
    "transformer_st_only": {"loss_st", "acc", "loss"},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ragged(rng, b, n, vocab, lengths):
    ids = rng.randint(1, vocab - 1, (b, n)).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    ids[np.arange(n)[None, :] >= lens[:, None]] = 0
    return ids, lens


def _mt_batch():
    rng = np.random.RandomState(0)
    return (*_ragged(rng, 3, 7, 10, [7, 4, 2]),
            *_ragged(rng, 3, 5, 12, [5, 3, 1]))


def _st_batch():
    rng = np.random.RandomState(0)
    slen = np.array([8000, 6000, 4000], np.int32)
    speech = np.zeros((3, 8000), np.float32)
    for i, n in enumerate(slen):
        speech[i, :n] = 0.1 * rng.randn(n)
    return (speech, slen, *_ragged(rng, 3, 5, 12, [5, 3, 1]),
            *_ragged(rng, 3, 6, 10, [6, 4, 2]))


def _drawn(model):
    """The port model's random parameters as a perturbed JAX tree."""
    init_random_(model, torch.Generator().manual_seed(0))
    prng = np.random.RandomState(1)
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * prng.randn(*a.shape).astype(np.float32),
        state_dict_to_jax_params(model.state_dict()))


def assert_jax_layout(jm, jb, params):
    """`params` has the keys and shapes of the JAX model's own tree."""
    want = jax.eval_shape(lambda: fnn.meta.unbox(jm.init(
        jax.random.PRNGKey(0), *jb))["params"])

    def shapes(tree):
        return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)

    assert shapes(want) == shapes(params)


def _mvn(dim):
    rng = np.random.RandomState(3)
    return {"mvn": {"mean": rng.randn(dim).astype(np.float32),
                    "inv_std": (0.5 + rng.rand(dim)).astype(np.float32)}}


def _grads_match(model, jgrads):
    want = jax_params_to_state_dict(jgrads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def _stats_match(stats, jstats, keys):
    assert set(stats) == set(jstats) == keys
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()),
                                   float(jstats[k]), rtol=LOSS_TOL,
                                   atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def mt_reduced():
    batch = _mt_batch()
    jm = jmt.MTModel(jmt.MTConfig(**MT))
    jb = tuple(map(jnp.asarray, batch))
    params = _drawn(tmt.MTModel(tmt.MTConfig(**MT)))
    assert_jax_layout(jm, jb, params)
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, *jb), has_aux=True))(params)
    return jm, params, (jloss, jstats, jgrads)


def test_mt_loss_stats_and_every_gradient_match_jax(mt_reduced):
    _, params, (jloss, jstats, jgrads) = mt_reduced
    model = load_jax_params(tmt.MTModel(tmt.MTConfig(**MT)), params).train()
    loss, stats = model(*(_t(a) for a in _mt_batch()))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    _stats_match(stats, jstats, {"loss", "acc"})
    _grads_match(model, jgrads)


def test_mt_search_on_token_ids_matches_jax(mt_reduced):
    jm, params, _ = mt_reduced
    src, slen, _, _ = _mt_batch()
    kw = dict(beam_size=3, ctc_weight=0.0, max_steps=8)
    jres = JSpeech2Text(jm, params, **kw)(src, slen, nbest=3)
    model = load_jax_params(tmt.MTModel(tmt.MTConfig(**MT)), params)
    got = Speech2Text(model, device="cpu", **kw)(src, slen, nbest=3)
    for g, j in zip(got, jres):
        assert [ids for ids, _ in g.nbest] == [ids for ids, _ in j.nbest]
        for (_, gs), (_, js) in zip(g.nbest, j.nbest):
            assert abs(gs - js) <= SCORE_TOL * max(1.0, abs(js))


@pytest.mark.parametrize("case", sorted(ST_CASES))
def test_st_loss_stats_and_every_gradient_match_jax(case):
    cfg = {**ST, **ST_CASES[case]}
    batch = _st_batch()
    jm = jst.STModel(jst.STConfig(**cfg))
    jb = tuple(map(jnp.asarray, batch))
    model = tst.STModel(tst.STConfig(**cfg))
    params = _drawn(model)
    assert_jax_layout(jm, jb, params)
    variables = {"params": params}
    if cfg["normalize"] == "global_mvn":
        variables["mvn"] = _mvn(cfg["n_mels"])
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({**variables, "params": p}, *jb),
        has_aux=True))(params)
    model = load_jax_params(model, variables).train()
    assert (model.ctc_head is None) == (
        cfg["asr_weight"] == 0 or cfg.get("mtlalpha", 1.0) == 0)
    assert (model.asr_decoder is None) == (
        cfg["asr_weight"] == 0 or cfg.get("mtlalpha", 1.0) == 1.0)
    loss, stats = model(*(_t(a) for a in batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    _stats_match(stats, jstats, ST_STATS[case])
    _grads_match(model, jgrads)
    # the tree goes back to JAX's layout unchanged
    back = model_params(model)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), b,
                                                rtol=0, atol=0),
        params, back)


def test_sections_and_full_width_configurations():
    for jtask, ttask in ((JMTTask, MTTask), (JSTTask, STTask)):
        for sec in ("data", "model"):
            jf = {f.name: f.default
                  for f in dataclasses.fields(jtask.sections[sec])}
            tf = {f.name: f.default
                  for f in dataclasses.fields(ttask.sections[sec])}
            assert set(jf) == set(tf), (jtask.name, sec)
            assert all(tf[k] == jf[k] for k in jf if k != "dtype"), sec
    mt = tmt.MTModel(mt_transformer(torch.bfloat16))
    st = tst.STModel(st_conformer(torch.bfloat16))
    assert sum(p.numel() for p in mt.parameters()) == MT_FULL_WIDTH_PARAMS
    assert sum(p.numel() for p in st.parameters()) == ST_FULL_WIDTH_PARAMS
    assert st.asr_decoder is None and st.ctc_head.out_features == 5000
    jcfg = jst.STConfig(**{
        k: v for k, v in dataclasses.asdict(st.config).items()
        if k != "dtype"})
    jshape = jax.eval_shape(lambda: jst.STModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16000)), jnp.array([16000]),
        jnp.ones((1, 3), jnp.int32), jnp.array([3]),
        jnp.ones((1, 3), jnp.int32), jnp.array([3]))["params"])
    assert sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        jshape)) == ST_FULL_WIDTH_PARAMS
    jmcfg = jmt.MTConfig(**{k: v for k, v in
                            dataclasses.asdict(mt.config).items()
                            if k != "dtype"})
    jshape = jax.eval_shape(lambda: jmt.MTModel(jmcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 3), jnp.int32),
        jnp.array([3]), jnp.ones((1, 3), jnp.int32), jnp.array([3]))[
        "params"])
    assert sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        jshape)) == MT_FULL_WIDTH_PARAMS
    built = STTask.build_model(STTask.sections["model"](dtype="bfloat16"),
                               40, 30)
    assert built.config.dtype == torch.bfloat16
    assert built.config.src_vocab_size == 30


def test_st_global_mvn_experiment_decodes_where_the_jax_cli_fails(
        tmp_path):
    """ST with its default global MVN: the task collects no statistics, so
    the model trains with its init's identity statistics. JAX's
    `st_inference` passes no `mvn` collection and fails with
    ScopeCollectionNotFound (ROADMAP.md queue 3); the port's decodes with
    the identity statistics, to the text of JAX's own search given them."""
    import flax.errors
    import flax.serialization as fser

    from espnet_tpu.bin import st_inference as jst_inference
    from espnet_tpu.data.dataset import EpochIterator as JEpochIterator
    from espnet_tpu.data.sampler import build_batches as jbuild_batches
    from espnet_tpu_torch.bin import st_inference, st_train
    from espnet_tpu_torch.data.fileio import read_2column_text
    from espnet_tpu_torch.data.synth import generate_st_corpus

    generate_st_corpus(tmp_path / "data", n_utts=4, max_words=2)
    st_train.main([
        "--run.output_dir", str(tmp_path / "exp"), "--run.max_epoch", "1",
        "--run.log_interval", "1000", "--run.best_metric",
        "train.loss.min", "--data.train_dir", str(tmp_path / "data"),
        "--data.batch_size", "4", "--model.n_mels", "16",
        "--model.use_specaug", "false", "--model.encoder_type",
        "transformer", "--model.d_model", "16", "--model.num_heads", "2",
        "--model.d_ff", "32", "--model.num_encoder_layers", "1",
        "--model.num_decoder_layers", "1", "--model.decoder_d_ff", "32",
        "--model.dropout_rate", "0.0", "--device", "cpu"])
    exp = tmp_path / "exp"
    dec = ["--exp_dir", str(exp), "--data_dir", str(tmp_path / "data"),
           "--beam_size", "2", "--max_steps", "6", "--batch_size", "4"]
    with pytest.raises(flax.errors.ScopeCollectionNotFound):
        jst_inference.main(dec + ["--output_dir", str(tmp_path / "jdec")])
    st_inference.main(dec + ["--output_dir", str(tmp_path / "tdec"),
                             "--device", "cpu"])
    got = read_2column_text(tmp_path / "tdec" / "text")
    cfg = JSTTask.load_config(exp)
    data = cfg["data"]
    tok = JSTTask.build_tokenizer(data, exp)
    conv = JSTTask.build_token_list(data, exp, tok)
    src = len((exp / "src_tokens.txt").read_text().split())
    jm = JSTTask.build_model(cfg["model"], len(conv), src)
    assert jm.config.normalize == "global_mvn"
    ds = JSTTask.build_dataset(data, tmp_path / "data", tok, conv,
                               train=False)
    batches = jbuild_batches(
        {"speech": ds.speech_lengths(), "text": ds.text_lengths()},
        batch_size=4, length_quantum=data.length_quantum,
        text_quantum=data.text_quantum)
    batch = next(JEpochIterator(ds, batches, shuffle=False).epoch(0))
    identity = {"mvn": {"mvn": {"mean": np.zeros(16, np.float32),
                                "inv_std": np.ones(16, np.float32)}}}
    params = fser.msgpack_restore((exp / "ep1.params.msgpack").read_bytes())
    want = JSpeech2Text(jm, params, identity, tok, conv, beam_size=2,
                        ctc_weight=0.0, max_steps=6)(
        batch["speech"], batch["speech_lengths"], keys=batch["keys"])
    assert got == {r.key: r.text for r in want}
