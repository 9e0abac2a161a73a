"""The port's n-gram (`lm/ngram.py`), its scorer in the search
(`decode/scorers.py` `ngram_scorer_adapter`, `Speech2Text(ngram_scorer=...)`),
`bin/ngram_train.py` and the recipe's stage 7 against the JAX package's.

Back-off models of orders 2 to 4 trained on seeded random sentences over a
17-letter alphabet: the ARPA file byte for byte, and the dense tables
(`scores`, `next_ctx`, `eos_scores`, `start_ctx`) with `np.array_equal`
over a token list with an out-of-vocabulary token and `<sos/eos>`. The
search step and `prefix_scorer` against JAX's `make_score_fn` token by token
(exactly: the same float32 rows) and against `NgramModel.logp` (1e-4 in
natural log: the tables are float32). Then a reduced ASR model (one
transformer layer of d_model 64, a one-layer decoder, vocab 20) decoded
with the 3-gram at weight 0.5 (beam 3, 8 label steps): the port's
`Speech2Text` against JAX's, token ids equal and scores within 1e-4.
"""

import dataclasses
import math
import shutil
from pathlib import Path

import flax.linen as fnn
import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.bin import ngram_train as jngram_train
from espnet_tpu.data.tokenizer import build_tokenizer as jbuild_tokenizer
from espnet_tpu.decode.asr_inference import Speech2Text as JSpeech2Text
from espnet_tpu.lm import ngram as jng
from espnet_tpu.models import asr as jasr
from espnet_tpu.tasks.asr import ASRTask as JASRTask
from espnet_tpu.train.collect_stats import load_stats as jload_stats
from espnet_tpu.train.collect_stats import mvn_variables as jmvn_variables
from espnet_tpu_torch import recipe
from espnet_tpu_torch.bin import ngram_train
from espnet_tpu_torch.bin.asr_inference import load_experiment
from espnet_tpu_torch.convert import load_jax_params
from espnet_tpu_torch.data.fileio import read_2column_text, write_2column_text
from espnet_tpu_torch.data.synth import generate_corpus
from espnet_tpu_torch.decode.asr_inference import Speech2Text
from espnet_tpu_torch.lm import ngram as tng
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel
from espnet_tpu_torch.tasks.asr import ASRTask


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one thread, and one for the subprocesses this file
    starts: the suite's xdist workers share the CPU, and a worker's extra
    threads oversubscribe it."""
    import os

    import torch as _torch

    n, env = _torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    _torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    _torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env

# the dense tables are float32 natural logs of float64 log10 sums
LOGP_TOL = 1e-4
SCORE_TOL = 1e-4
LETTERS = list("abcdefghijklmnopq")
# the ASR token list: a letter the n-gram never saw ("q") scores as <unk>
TOKENS = ["<blank>", "<unk>", *LETTERS, "<sos/eos>"]
WEIGHT = 0.5


def _sentences(n=60, seed=0):
    rng = np.random.RandomState(seed)
    return [[LETTERS[i] for i in rng.randint(0, 16, rng.randint(1, 9))]
            for _ in range(n)]


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    """{order: (JAX model, port model, path of JAX's ARPA file)}."""
    d = tmp_path_factory.mktemp("ngram")
    out = {}
    for order in (2, 3, 4):
        jm = jng.NgramModel.train(_sentences(), order=order)
        tm = tng.NgramModel.train(_sentences(), order=order)
        jm.save_arpa(d / f"j{order}.arpa")
        tm.save_arpa(d / f"t{order}.arpa")
        out[order] = (jm, tm, d / f"j{order}.arpa", d / f"t{order}.arpa")
    return out


@pytest.mark.parametrize("order", [2, 3, 4])
def test_arpa_file_is_jax_byte_for_byte(arpa, order):
    _, _, jpath, tpath = arpa[order]
    assert tpath.read_bytes() == jpath.read_bytes()
    # and reading it back writes it again unchanged
    again = tpath.with_suffix(".again")
    tng.NgramModel.load_arpa(jpath).save_arpa(again)
    assert again.read_bytes() == jpath.read_bytes()


@pytest.mark.parametrize("order", [2, 3, 4])
def test_dense_tables_equal_jax(arpa, order):
    _, _, jpath, _ = arpa[order]
    j = jng.DenseNgramScorer(jng.NgramModel.load_arpa(jpath), TOKENS)
    t = tng.DenseNgramScorer(tng.NgramModel.load_arpa(jpath), TOKENS)
    assert np.array_equal(t.scores, j.scores)
    assert np.array_equal(t.next_ctx, j.next_ctx)
    assert np.array_equal(t.eos_scores, j.eos_scores)
    assert t.start_ctx == j.start_ctx
    assert t.scores.dtype == np.float32 and t.next_ctx.dtype == np.int32


def test_search_step_and_prefix_scorer_walk_jax_tables(arpa):
    jm, tm, jpath, _ = arpa[3]
    j = jng.DenseNgramScorer(jm, TOKENS)
    t = tng.DenseNgramScorer(tm, TOKENS)
    rng = np.random.RandomState(5)
    seqs = rng.randint(2, len(TOKENS) - 1, (4, 9))
    jfn, tfn = j.make_score_fn(), t.make_score_fn(torch.device("cpu"))
    jc, tc = j.init_cache(4), t.init_cache(4)
    eos = len(TOKENS) - 1
    for step in [np.full(4, eos)] + list(seqs.T):
        jrow, jc = jfn(jnp.asarray(step), 0, jc)
        trow, tc = tfn(torch.from_numpy(step), 0, tc)
        assert np.array_equal(trow.numpy(), np.asarray(jrow))
        assert np.array_equal(tc.numpy(), np.asarray(jc))
    lm_score = t.prefix_scorer()
    for seq in seqs:
        for k in range(len(seq)):
            prefix, c = list(seq[:k]), int(seq[k])
            got = lm_score(prefix, c)
            ctx = j.start_ctx
            for tok in prefix:
                ctx = j.next_ctx[ctx, tok]
            assert got == float(j.scores[ctx, c])
            want = tm.logp(["<s>"] + [TOKENS[i] for i in prefix],
                           TOKENS[c]) * math.log(10.0)
            assert abs(got - want) <= LOGP_TOL, (prefix, c)
    # <sos/eos> scores as </s> and restarts at (<s>,)
    assert lm_score([3, 4], eos) == pytest.approx(
        tm.logp(["<s>", "b", "c"], "</s>") * math.log(10.0), abs=LOGP_TOL)
    assert lm_score.context_id([3, 4, eos]) == t.start_ctx


ASR = dict(vocab_size=len(TOKENS), n_mels=16, use_specaug=False,
           normalize="utterance_mvn", encoder_type="transformer",
           d_model=64, num_heads=4, d_ff=128, num_encoder_layers=1,
           num_decoder_layers=1, decoder_d_ff=128, dropout_rate=0.0)


def test_ngram_fusion_matches_jax_speech2text(arpa):
    rng = np.random.RandomState(2)
    slen = np.array([8000, 5600], np.int32)
    speech = np.zeros((2, 8000), np.float32)
    for i, n in enumerate(slen):
        speech[i, :n] = 0.1 * rng.randn(n)
    jm = jasr.ASRModel(jasr.ASRConfig(**ASR))
    v = fnn.meta.unbox(jax.jit(jm.init, static_argnums=(5,))(
        jax.random.PRNGKey(0), jnp.asarray(speech), jnp.asarray(slen),
        jnp.zeros((2, 3), jnp.int32), jnp.array([3, 3]), True))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a)
        + 0.1 * rng.randn(*a.shape).astype(np.float32), v["params"])
    jpath = arpa[3][2]
    kw = dict(beam_size=3, ctc_weight=0.3, max_steps=8)
    jres = JSpeech2Text(
        jm, params, ngram_scorer=jng.DenseNgramScorer(
            jng.NgramModel.load_arpa(jpath), TOKENS),
        ngram_weight=WEIGHT, **kw)(speech, slen, nbest=3)
    model = load_jax_params(ASRModel(ASRConfig(**ASR)), params)
    scorer = tng.DenseNgramScorer(tng.NgramModel.load_arpa(jpath), TOKENS)
    got = Speech2Text(model, device="cpu", ngram_scorer=scorer,
                      ngram_weight=WEIGHT, **kw)(speech, slen, nbest=3)
    plain = Speech2Text(model, device="cpu", ngram_scorer=scorer,
                        ngram_weight=0.0, **kw)(speech, slen, nbest=3)
    for g, j in zip(got, jres):
        assert [ids for ids, _ in g.nbest] == [ids for ids, _ in j.nbest]
        for (_, gs), (_, js) in zip(g.nbest, j.nbest):
            assert abs(gs - js) <= SCORE_TOL * max(1.0, abs(js))
    assert [r.score for r in got] != [r.score for r in plain]


@pytest.mark.parametrize("source", ["token_type", "exp_dir"])
def test_ngram_train_cli_writes_jax_arpa(tmp_path, source):
    generate_corpus(tmp_path / "train", n_utts=12, seed=0)
    if source == "token_type":
        flags = ["--token_type", "char"]
    else:
        ASRTask.dump_config(ASRTask.parse_config([]), tmp_path / "exp")
        flags = ["--exp_dir", str(tmp_path / "exp")]
    for main, name in ((ngram_train.main, "t"), (jngram_train.main, "j")):
        main(["--data_dir", str(tmp_path / "train"), "--order", "3",
              "--output", str(tmp_path / f"{name}.arpa"), *flags])
    assert (tmp_path / "t.arpa").read_bytes() == \
        (tmp_path / "j.arpa").read_bytes()
    assert b"\\3-grams:" in (tmp_path / "t.arpa").read_bytes()


def test_recipe_stage7_trains_the_ngram(tmp_path):
    """Stage 7 runs `bin.ngram_train` on the training text with the
    recipe's token type; its ARPA file is JAX's trainer's."""
    texts = {f"u{i}": " ".join("".join(s) for s in _sentences(3, i))
             for i in range(10)}
    write_2column_text(tmp_path / "data" / "train" / "text", texts)
    r = recipe.Recipe(recipe.RecipeConfig(
        expdir=str(tmp_path / "exp"), datadir=str(tmp_path / "data"),
        use_ngram=True, ngram_order=4, token_type="word", stage=7,
        stop_stage=7), device="cpu")
    r.run()
    assert r.done(7)
    got = tmp_path / "exp" / "ngram" / "4gram.arpa"
    tok = jbuild_tokenizer("word")
    jng.NgramModel.train([tok.text2tokens(t) for t in texts.values()],
                         order=4).save_arpa(tmp_path / "want.arpa")
    assert got.read_bytes() == (tmp_path / "want.arpa").read_bytes()
    shutil.rmtree(tmp_path / "exp" / "ngram")
    recipe.Recipe(dataclasses.replace(r.cfg, use_ngram=False),
                  device="cpu").stage7_ngram()
    assert not (tmp_path / "exp" / "ngram").exists()


REPO = Path(__file__).resolve().parents[1]
SYNTH = Path("egs_work/synth_hard")


def test_synth_hard_ngram_decode_is_pinned(tmp_path, monkeypatch):
    """The JAX-trained synth_hard conformer with the 3-gram of its training
    text at weight 0.3 (beam 5, CTC 0.3, 60 steps) on chip_smoke.py's
    pinned test utterances: the port's ids and scores are JAX's (1e-4) and
    its texts the reference transcripts, which the card's decode in
    chip_smoke.py's lm-fusion phase must give too."""
    import chip_smoke

    monkeypatch.chdir(REPO)
    exp = SYNTH / "exp/asr"
    params = exp / "valid.acc.ave.params.msgpack"
    keys = sorted(read_2column_text(SYNTH / "data/test/wav.scp"))[
        :chip_smoke.FUSION_PINNED]
    for f in ("wav.scp", "text"):
        rows = read_2column_text(SYNTH / "data/test" / f)
        write_2column_text(tmp_path / "test" / f, {k: rows[k] for k in keys})
    arpa = tmp_path / "3gram.arpa"
    ngram_train.main(["--data_dir", str(SYNTH / "data/train"),
                      "--exp_dir", str(exp), "--output", str(arpa)])
    cfg = JASRTask.load_config(exp)
    tok = JASRTask.build_tokenizer(cfg["data"], exp)
    conv = JASRTask.build_token_list(cfg["data"], exp, tok)
    jm = JASRTask.build_model(cfg["model"], len(conv))
    extra = {"mvn": jmvn_variables(jload_stats(exp / "stats" /
                                               "feats_stats.npz"))}
    model, _, ds, ttok, tconv = load_experiment(exp, tmp_path / "test",
                                                params)
    waves = [np.asarray(ds[k]["speech"], np.float32) for k in keys]
    speech = np.zeros((len(keys), max(map(len, waves))), np.float32)
    for i, w in enumerate(waves):
        speech[i, :len(w)] = w
    lens = np.array([len(w) for w in waves], np.int32)
    kw = dict(beam_size=5, ctc_weight=0.3, max_steps=60)
    want = JSpeech2Text(
        jm, fser.msgpack_restore(params.read_bytes()), extra, tok, conv,
        ngram_scorer=jng.DenseNgramScorer(jng.NgramModel.load_arpa(arpa),
                                          conv.token_list),
        ngram_weight=0.3, **kw)(speech, lens, keys=keys)
    got = Speech2Text(
        model, device="cpu", tokenizer=ttok, converter=tconv,
        ngram_scorer=tng.DenseNgramScorer(tng.NgramModel.load_arpa(arpa),
                                          tconv.token_list),
        ngram_weight=0.3, **kw)(speech, lens, keys=keys)
    refs = read_2column_text(SYNTH / "exp/decode_test/text")
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids
        assert abs(g.score - w.score) <= SCORE_TOL * max(1.0, abs(w.score))
        assert g.text == w.text == refs[g.key]
