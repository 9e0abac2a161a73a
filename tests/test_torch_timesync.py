"""The port's time-synchronous search (`decode/timesync.py`, `asr_inference
--search timesync`) against the JAX package's, on the CPU.

* `ctc_prefix_beam_search` against JAX's on seeded log-posteriors (T 40,
  V 12, beam 4, pruning width 6), plain, with tied posteriors (rounded to
  one decimal: the tie orders of `np.argsort` and of `sorted` over dict
  insertion order) and with a callable LM score: the same n-best, exactly.
* The JAX-trained synth_hard conformer on its first 4 test utterances
  (beam 5): the port's `Speech2TextTimeSync` against JAX's, the same n-best
  token ids with scores within 1e-4 (the posteriors differ by float32
  rounding). The port's text is the tokenizer's, the reference transcript;
  JAX's joins the tokens, so its text keeps the character model's
  "<space>" tokens (ROADMAP.md queue 3).
* The n-gram repair: JAX's `Speech2TextTimeSync` with a `DenseNgramScorer`
  and weight 0.3 raises AttributeError (it calls a `score_step` the scorer
  does not have). The port decodes; its n-best equals JAX's
  `ctc_prefix_beam_search` on JAX's posteriors given an `lm_score` that
  this test builds from JAX's dense tables (walk `next_ctx` from
  `start_ctx`, read `scores[ctx, c]`), which agrees with
  `NgramModel.logp` within 1e-4 (float32 tables); and the CLI with
  `--ngram_file --ngram_weight 0.3` decodes where JAX's raises.
"""

import math
from pathlib import Path

import flax.serialization as fser
import numpy as np
import pytest

from espnet_tpu.bin import asr_inference as jinference
from espnet_tpu.decode import timesync as jts
from espnet_tpu.lm import ngram as jng
from espnet_tpu.tasks.asr import ASRTask as JASRTask
from espnet_tpu.train.collect_stats import load_stats as jload_stats
from espnet_tpu.train.collect_stats import mvn_variables as jmvn_variables
from espnet_tpu_torch.bin import asr_inference as tinference
from espnet_tpu_torch.bin import ngram_train
from espnet_tpu_torch.bin.asr_inference import load_experiment
from espnet_tpu_torch.data.fileio import read_2column_text, write_2column_text
from espnet_tpu_torch.decode import timesync as tts
from espnet_tpu_torch.lm import ngram as tng


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

REPO = Path(__file__).resolve().parents[1]
SYNTH = Path("egs_work/synth_hard")
EXP = SYNTH / "exp/asr"
PARAMS = EXP / "valid.acc.ave.params.msgpack"
SCORE_TOL = 1e-4
LOGP_TOL = 1e-4
WEIGHT = 0.3
BEAM = 5


@pytest.fixture(autouse=True)
def repo_root(monkeypatch):
    """The experiment names its files relative to the repository."""
    monkeypatch.chdir(REPO)


@pytest.mark.parametrize("case", ["plain", "ties", "lm"])
def test_prefix_search_matches_jax(case):
    rng = np.random.RandomState(0)
    logits = rng.randn(40, 12) * 3.0
    if case == "ties":
        logits = np.round(logits / 3.0, 1) * 3.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lm = None
    if case == "lm":
        table = rng.randn(12, 12)

        def lm(prefix, c):
            return float(table[prefix[-1] if prefix else 0, c])

    kw = dict(beam_size=4, pruning_width=6, lm_score=lm, lm_weight=0.5)
    got = tts.ctc_prefix_beam_search(lp.astype(np.float32), **kw)
    want = jts.ctc_prefix_beam_search(lp.astype(np.float32), **kw)
    assert got == want and len(got) == 4


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """(data dir of the first 4 test utterances, the 3-gram of the training
    text as ARPA, JAX's model pieces, the port's model pieces)."""
    ws = tmp_path_factory.mktemp("timesync")
    keys = sorted(read_2column_text(REPO / SYNTH / "data/test/wav.scp"))[:4]
    for f in ("wav.scp", "text"):
        rows = read_2column_text(REPO / SYNTH / "data/test" / f)
        write_2column_text(ws / "test" / f, {k: rows[k] for k in keys})
    arpa = ws / "3gram.arpa"
    ngram_train.main(["--data_dir", str(REPO / SYNTH / "data/train"),
                      "--exp_dir", str(REPO / EXP), "--output", str(arpa)])
    cfg = JASRTask.load_config(REPO / EXP)
    tok = JASRTask.build_tokenizer(cfg["data"], REPO / EXP)
    conv = JASRTask.build_token_list(cfg["data"], REPO / EXP, tok)
    jm = JASRTask.build_model(cfg["model"], len(conv))
    jparams = fser.msgpack_restore((REPO / PARAMS).read_bytes())
    extra = {"mvn": jmvn_variables(jload_stats(REPO / EXP / "stats" /
                                               "feats_stats.npz"))}
    model, _, ds, ttok, tconv = load_experiment(REPO / EXP, ws / "test",
                                                REPO / PARAMS)
    waves = [np.asarray(ds[k]["speech"], np.float32) for k in keys]
    speech = np.zeros((4, max(len(w) for w in waves)), np.float32)
    for i, w in enumerate(waves):
        speech[i, :len(w)] = w
    lens = np.array([len(w) for w in waves], np.int32)
    return dict(ws=ws, keys=keys, arpa=arpa, speech=speech, lens=lens,
                jax=(jm, jparams, extra, tok, conv),
                port=(model, ttok, tconv),
                refs=read_2column_text(ws / "test" / "text"))


def _same_nbest(got, want):
    for g, w in zip(got, want):
        assert [ids for ids, _ in g] == [list(ids) for ids, _ in w]
        for (_, gs), (_, ws) in zip(g, w):
            assert abs(gs - ws) <= SCORE_TOL * max(1.0, abs(ws))


def test_timesync_decode_matches_jax(synth):
    jm, jparams, extra, tok, conv = synth["jax"]
    model, ttok, tconv = synth["port"]
    s, lens, keys = synth["speech"], synth["lens"], synth["keys"]
    want = jts.Speech2TextTimeSync(jm, jparams, extra, tok, conv,
                                   beam_size=BEAM)(s, lens, keys, nbest=3)
    got = tts.Speech2TextTimeSync(model, ttok, tconv, beam_size=BEAM,
                                  device="cpu")(s, lens, keys, nbest=3)
    _same_nbest([g.nbest for g in got], [w.nbest for w in want])
    for g, w in zip(got, want):
        assert g.text == synth["refs"][g.key]
        assert w.text == "".join(conv.ids2tokens(w.nbest[0][0]))
        assert "<space>" in w.text


def test_ngram_repair_against_jax_search_and_logp(synth):
    jm, jparams, extra, tok, conv = synth["jax"]
    model, ttok, tconv = synth["port"]
    s, lens, keys = synth["speech"], synth["lens"], synth["keys"]
    jmodel = jng.NgramModel.load_arpa(synth["arpa"])
    jdense = jng.DenseNgramScorer(jmodel, conv.token_list)
    jdec = jts.Speech2TextTimeSync(jm, jparams, extra, tok, conv,
                                   beam_size=BEAM, ngram_scorer=jdense,
                                   ngram_weight=WEIGHT)
    with pytest.raises(AttributeError, match="score_step"):
        jdec(s, lens, keys)

    def lm_score(prefix, c):
        ctx = jdense.start_ctx
        for t in prefix:
            ctx = jdense.next_ctx[ctx, t]
        return float(jdense.scores[ctx, c])

    lp, elens = (np.asarray(a) for a in jdec._posteriors(s, lens))
    want = [jts.ctc_prefix_beam_search(lp[i, :int(elens[i])], BEAM,
                                       lm_score=lm_score,
                                       lm_weight=WEIGHT)[:3]
            for i in range(len(keys))]
    scorer = tng.DenseNgramScorer(tng.NgramModel.load_arpa(synth["arpa"]),
                                  tconv.token_list)
    got = tts.Speech2TextTimeSync(model, ttok, tconv, beam_size=BEAM,
                                  ngram_scorer=scorer, ngram_weight=WEIGHT,
                                  device="cpu")(s, lens, keys, nbest=3)
    _same_nbest([g.nbest for g in got], want)
    plain = tts.Speech2TextTimeSync(model, ttok, tconv, beam_size=BEAM,
                                    device="cpu")(s, lens, keys)
    assert [g.score for g in got] != [p.score for p in plain]
    # the test's lm_score is the n-gram's own probability
    port_score = scorer.prefix_scorer()
    for g in got:
        ids = g.nbest[0][0]
        for k, c in enumerate(ids):
            word = conv.token_list[c]
            want_lp = jmodel.logp(["<s>"] + [conv.token_list[i]
                                             for i in ids[:k]], word)
            assert abs(lm_score(ids[:k], c) - want_lp * math.log(10.0)) \
                <= LOGP_TOL
            assert port_score(ids[:k], c) == lm_score(ids[:k], c)


def test_timesync_cli_with_ngram_decodes_where_jax_raises(synth):
    argv = ["--exp_dir", str(EXP), "--params", str(PARAMS), "--data_dir",
            str(synth["ws"] / "test"), "--beam_size", str(BEAM),
            "--batch_size", "4", "--search", "timesync", "--ngram_file",
            str(synth["arpa"]), "--ngram_weight", str(WEIGHT)]
    got = tinference.main(argv + ["--output_dir",
                                  str(synth["ws"] / "t"), "--device",
                                  "cpu"])
    assert got == synth["refs"]
    assert "| Err 0.0 |" in (synth["ws"] / "t" / "score_wer.txt").read_text()
    with pytest.raises(AttributeError, match="score_step"):
        jinference.main(argv + ["--output_dir", str(synth["ws"] / "j")])
