"""The port's word LMs for character search (`decode/extlm.py`) and their
`asr_inference` flags against the JAX package's, float32 on the CPU.

* `make_lexical_tree`: the arrays equal JAX's, on a sorted word list with
  shared prefixes, a word with a character outside the subword list, and
  the special tokens.
* `LookAheadWordLM` and `MultiLevelLM` step by step (10 steps of 3
  hypotheses that cross word boundaries, an unknown word and <sos/eos>):
  the log-probabilities and the carried node ids against JAX's, with one
  tiny RNN word LM (and a character LM) carried across from JAX parameters
  (1 layer of 32 units, perturbed). Tolerance 1e-5: float32 softmax,
  cumulative sums and their differences, in another order.
* `bin.asr_inference --word_lm_exp_dir` alone (look-ahead) and with
  `--lm_exp_dir` (multi-level) on the JAX-trained synth_hard conformer and
  its first 4 test utterances (beam 5, CTC 0.3, 60 steps, LM weight 0.3),
  with a word LM and a character LM trained by the port's `bin.lm_train`
  on 200 lines of synth_hard's training text: both packages' CLIs write
  the same texts, the reference transcripts, with the same n-best scores
  (1e-4), and a non-rnn LM is refused.
"""

import json
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.bin import asr_inference as jinference
from espnet_tpu.decode import extlm as jx
from espnet_tpu.tasks import lm as jlm
from espnet_tpu_torch.bin import asr_inference as tinference
from espnet_tpu_torch.bin import lm_train
from espnet_tpu_torch.convert import load_jax_params
from espnet_tpu_torch.data.fileio import read_2column_text, write_2column_text
from espnet_tpu_torch.decode import extlm as tx
from espnet_tpu_torch.tasks.lm import LMModelConfig, LMTask

REPO = Path(__file__).resolve().parents[1]
SYNTH = "egs_work/synth_hard"
STEP_TOL = 1e-5
SCORE_TOL = 1e-4
CHARS = ["<blank>", "<unk>", "<space>", *"abcde", "<sos/eos>"]
WORDS = ["<blank>", "<unk>", "a", "ab", "abc", "abx", "bad", "bed", "cab",
         "dab", "ea", "<sos/eos>"]
LM = dict(lm_type="rnn", d_model=32, num_layers=1, dropout_rate=0.0)
# steps x hypotheses: <sos/eos> first, words separated by <space> (2),
# "abx" and "ee" are not in the tree
SEQS = np.array([[8, 3, 4, 2, 6, 5, 4, 2, 7, 8],
                 [8, 4, 5, 2, 3, 2, 6, 7, 2, 8],
                 [8, 7, 7, 2, 3, 3, 3, 2, 4, 5]]).T


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dicts():
    return ({w: i for i, w in enumerate(WORDS)},
            {c: i for i, c in enumerate(CHARS)})


def test_lexical_tree_equals_jax():
    wd, cd = _dicts()
    jt = jx.make_lexical_tree(wd, cd, wd["<unk>"])
    tt = tx.make_lexical_tree(wd, cd, wd["<unk>"])
    for name, a, b in zip(jx.LexicalTree._fields, jt, tt):
        assert np.array_equal(a, b), name
        assert a.dtype == b.dtype, name
    # "abx" has a character outside the subword list: not in the tree
    assert wd["abx"] not in tt.word_id and wd["abc"] in tt.word_id


def _lms():
    """(JAX (step, cache_init), port (step, cache_init)) of a word LM and
    a character LM."""
    out = []
    for vocab, seed in ((len(WORDS), 0), (len(CHARS), 1)):
        jm = jlm.LMTask.build_model(jlm.LMModelConfig(**LM), vocab)
        v = fnn.meta.unbox(jm.init(jax.random.PRNGKey(seed),
                                   jnp.zeros((1, 4), jnp.int32),
                                   jnp.asarray([4]), True))
        rng = np.random.RandomState(seed)
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a)
            + 0.3 * rng.randn(*a.shape).astype(np.float32), v["params"])
        inner, iv = jm.lm, {"params": params["lm"]}
        jfns = (lambda c, t, inner=inner, iv=iv: inner.apply(
                    iv, t, 0, c, method=type(inner).score_step),
                lambda b, inner=inner, iv=iv: inner.apply(
                    iv, b, method=type(inner).init_cache))
        lm = load_jax_params(LMTask.build_model(LMModelConfig(**LM), vocab),
                             params).lm.eval()
        tfns = (lambda c, t, lm=lm: lm.score_step(t, 0, c),
                lambda b, d, lm=lm: lm.init_cache(b, device=d))
        out.append((jfns, tfns))
    return out


@pytest.mark.parametrize("kind", ["lookahead", "multilevel"])
def test_word_lm_steps_match_jax(kind):
    wd, cd = _dicts()
    common = dict(word_eos=wd["<sos/eos>"], word_unk=wd["<unk>"],
                  space=cd["<space>"], eos=cd["<sos/eos>"],
                  subword_size=len(CHARS))
    jtree = jx.make_lexical_tree(wd, cd, wd["<unk>"])
    (jw, tw), (jc, tc) = _lms()
    if kind == "lookahead":
        j = jx.LookAheadWordLM(*jw, jtree, **common)
        t = tx.LookAheadWordLM(*tw, jtree, **common)
        node_at = 2
    else:
        j = jx.MultiLevelLM(*jw, *jc, jtree, **common)
        t = tx.MultiLevelLM(*tw, *tc, jtree, **common)
        node_at = 3
    jf, tf = j.make_score_fn(), t.make_score_fn()
    jcache, tcache = j.init_cache(3), t.init_cache(3, torch.device("cpu"))
    with torch.no_grad():
        for step in SEQS:
            jl, jcache = jf(jnp.asarray(step), 0, jcache)
            tl, tcache = tf(torch.from_numpy(step), 0, tcache)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=STEP_TOL, atol=STEP_TOL)
            np.testing.assert_array_equal(tcache[node_at].numpy(),
                                          np.asarray(jcache[node_at]))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A 4-utterance data dir of synth_hard's test set, a word LM and a
    character LM trained by the port's lm_train on 200 training lines."""
    ws = tmp_path_factory.mktemp("extlm")
    keys = sorted(read_2column_text(REPO / SYNTH / "data/test/wav.scp"))[:4]
    for f in ("wav.scp", "text"):
        rows = read_2column_text(REPO / SYNTH / "data/test" / f)
        write_2column_text(ws / "test" / f,
                           {k: str(REPO / rows[k]) if f == "wav.scp"
                            else rows[k] for k in keys})
    rows = read_2column_text(REPO / SYNTH / "data/train/text")
    write_2column_text(ws / "train" / "text", dict(list(rows.items())[:200]))
    common = ["--run.max_epoch", "1", "--run.log_interval", "100",
              "--model.lm_type", "rnn", "--model.d_model", "32",
              "--model.num_layers", "1", "--model.dropout_rate", "0.0",
              "--optim.schedule", "constant", "--optim.lr", "0.01",
              "--data.train_dir", str(ws / "train"), "--device", "cpu"]
    lm_train.main(common + ["--data.token_type", "word",
                            "--run.output_dir", str(ws / "wlm")])
    lm_train.main(common + ["--data.token_list",
                            str(REPO / SYNTH / "exp/tokens/tokens.txt"),
                            "--run.output_dir", str(ws / "clm")])
    # the word LM's token list is sorted, as the lexical tree needs
    words = (ws / "wlm" / "tokens.txt").read_text().split()
    assert words[2:-1] == sorted(words[2:-1])
    return ws


def _scores(path):
    return [json.loads(ln)["score"] for ln in path.read_text().splitlines()]


@pytest.mark.parametrize("kind", ["lookahead", "multilevel"])
def test_word_lm_decode_through_asr_inference_matches_jax(synth, kind,
                                                          monkeypatch):
    monkeypatch.chdir(REPO)
    exp = REPO / SYNTH / "exp/asr"
    argv = ["--exp_dir", str(exp), "--params",
            str(exp / "valid.acc.ave.params.msgpack"), "--data_dir",
            str(synth / "test"), "--beam_size", "5", "--ctc_weight", "0.3",
            "--max_steps", "60", "--batch_size", "4", "--lm_weight", "0.3",
            "--word_lm_exp_dir", str(synth / "wlm")]
    if kind == "multilevel":
        argv += ["--lm_exp_dir", str(synth / "clm")]
    out = synth / kind
    got = tinference.main(argv + ["--output_dir", str(out / "t"),
                                  "--device", "cpu"])
    jinference.main(argv + ["--output_dir", str(out / "j")])
    assert got == read_2column_text(out / "j" / "text")
    assert got == read_2column_text(synth / "test" / "text")
    np.testing.assert_allclose(_scores(out / "t" / "nbest.jsonl"),
                               _scores(out / "j" / "nbest.jsonl"),
                               rtol=SCORE_TOL)


def test_non_rnn_word_lm_is_refused(synth, monkeypatch, tmp_path):
    monkeypatch.chdir(REPO)
    wlm = tmp_path / "wlm"
    wlm.mkdir()
    conf = (synth / "wlm" / "config.yaml").read_text()
    (wlm / "config.yaml").write_text(conf.replace("lm_type: rnn",
                                                  "lm_type: transformer"))
    exp = REPO / SYNTH / "exp/asr"
    with pytest.raises(ValueError, match="lm_type=rnn"):
        tinference.main(["--exp_dir", str(exp), "--data_dir",
                         str(synth / "test"), "--output_dir",
                         str(tmp_path / "out"), "--lm_weight", "0.3",
                         "--word_lm_exp_dir", str(wlm), "--device", "cpu"])
