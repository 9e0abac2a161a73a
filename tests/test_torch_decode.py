"""CTC prefix scoring and the batched beam search of the PyTorch port
against the JAX package, float32 on the CPU, with scorers built from the
same numpy tables on both sides."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.decode import beam_search as jbs
from espnet_tpu.decode import ctc_prefix as jctc
from espnet_tpu_torch.decode import beam_search as tbs
from espnet_tpu_torch.decode import ctc_prefix as tctc


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

# float32 log-space sums over <= 12 frames
TOL = 1e-5


def _log_softmax(x, axis=-1):
    x = x - x.max(axis=axis, keepdims=True)
    return (x - np.log(np.exp(x).sum(axis=axis, keepdims=True))).astype(np.float32)


def _ctc_inputs(seed, b=2, t=9, v=7):
    rng = np.random.RandomState(seed)
    lp = _log_softmax(2 * rng.randn(b, t, v))
    lens = np.array([t, t - 4][:b], np.int32)
    return lp, lens


def test_ctc_prefix_init_matches():
    lp, lens = _ctc_inputs(0)
    jlp, js = jctc.ctc_prefix_init(jnp.asarray(lp), jnp.asarray(lens), 3)
    tlp, ts = tctc.ctc_prefix_init(torch.from_numpy(lp),
                                   torch.from_numpy(lens).long(), 3)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=0)
    np.testing.assert_allclose(ts.r.numpy(), np.asarray(js.r), atol=TOL,
                               rtol=TOL)
    np.testing.assert_array_equal(ts.last.numpy(), np.asarray(js.last))


def test_ctc_prefix_score_and_select_match_over_two_steps():
    lp, lens = _ctc_inputs(1)
    b, w, k = 2, 3, 4
    rng = np.random.RandomState(2)
    jlp, js = jctc.ctc_prefix_init(jnp.asarray(lp), jnp.asarray(lens), w)
    tlp, ts = tctc.ctc_prefix_init(torch.from_numpy(lp),
                                   torch.from_numpy(lens).long(), w)
    tl = torch.from_numpy(lens).long()
    for _ in range(2):
        # candidate sets that repeat the last token, so both phi branches run
        cand = rng.randint(1, 7, (b, w, k)).astype(np.int32)
        cand[:, :, 0] = np.where(np.asarray(js.last) > 0, np.asarray(js.last),
                                 cand[:, :, 0])
        jpsi, jr, jeos = jctc.ctc_prefix_score(js, jlp, jnp.asarray(lens),
                                               jnp.asarray(cand))
        tpsi, tr, teos = tctc.ctc_prefix_score(ts, tlp, tl,
                                               torch.from_numpy(cand).long())
        for got, want in ((tpsi, jpsi), (tr, jr), (teos, jeos)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TOL, rtol=TOL)
        src_h = rng.randint(0, w, (b, w)).astype(np.int32)
        src_c = rng.randint(0, k, (b, w)).astype(np.int32)
        js = jctc.ctc_prefix_select(js, jr, jpsi, jnp.asarray(cand),
                                    jnp.asarray(src_h), jnp.asarray(src_c))
        ts = tctc.ctc_prefix_select(ts, tr, tpsi,
                                    torch.from_numpy(cand).long(),
                                    torch.from_numpy(src_h).long(),
                                    torch.from_numpy(src_c).long())
        np.testing.assert_allclose(ts.psi.numpy(), np.asarray(js.psi),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(ts.last.numpy(), np.asarray(js.last))


def test_ctc_prefix_score_with_an_empty_utterance_matches():
    lp, _ = _ctc_inputs(5)
    lens = np.array([9, 0], np.int32)
    cand = np.random.RandomState(6).randint(1, 7, (2, 2, 3)).astype(np.int32)
    jlp, js = jctc.ctc_prefix_init(jnp.asarray(lp), jnp.asarray(lens), 2)
    tlp, ts = tctc.ctc_prefix_init(torch.from_numpy(lp),
                                   torch.from_numpy(lens).long(), 2)
    jout = jctc.ctc_prefix_score(js, jlp, jnp.asarray(lens), jnp.asarray(cand))
    tout = tctc.ctc_prefix_score(ts, tlp, torch.from_numpy(lens).long(),
                                 torch.from_numpy(cand).long())
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


def test_logaddexp_floor_matches():
    a = np.array([-1e30, -2e30, 0.0, -5.0, -1e30], np.float32)
    b = np.array([-1e30, -3e30, -1.0, -1e30, 3.0], np.float32)
    np.testing.assert_allclose(
        tctc.logaddexp(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jctc._logaddexp(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6, rtol=1e-6)


def _table_scorers(seed, b, w, vocab, steps):
    """An attention-like scorer from a fixed table logp[pos, last token],
    with a (N, 1) cache that counts steps, in both frameworks."""
    rng = np.random.RandomState(seed)
    table = _log_softmax(3 * rng.randn(steps + 1, vocab, vocab))
    jt, tt = jnp.asarray(table), torch.from_numpy(table)

    def jfn(tokens, pos, cache):
        return jt[pos][tokens], cache + 1.0

    def tfn(tokens, pos, cache):
        return tt[pos][tokens], cache + 1.0

    n = b * w
    return (jfn, jnp.zeros((n, 1))), (tfn, torch.zeros(n, 1))


@pytest.mark.parametrize("cfg", [
    dict(beam_size=3, ctc_weight=0.3, att_weight=0.7),
    dict(beam_size=4, ctc_weight=0.5, att_weight=0.5, minlenratio=0.3),
    dict(beam_size=2, ctc_weight=0.0, att_weight=1.0, penalty=0.5),
    dict(beam_size=1, ctc_weight=0.3, att_weight=0.7, maxlenratio=0.5),
], ids=["joint", "minlen", "no_ctc_penalty", "greedy_maxlen"])
def test_batched_beam_search_matches(cfg):
    vocab, steps = 9, 8
    lp, lens = _ctc_inputs(3, b=2, t=12, v=vocab)
    jcfg = jbs.BeamSearchConfig(**cfg)
    tcfg = tbs.BeamSearchConfig(**cfg)
    (jfn, jc), (tfn, tc) = _table_scorers(4, 2, cfg["beam_size"], vocab, steps)
    sos = eos = vocab - 1
    jout = jbs.batched_beam_search(
        jcfg, sos, eos, vocab, jnp.asarray(lens), jfn, jc,
        ctc_log_probs=jnp.asarray(lp), max_steps=steps)
    tout = tbs.batched_beam_search(
        tcfg, sos, eos, vocab, torch.from_numpy(lens).long(), tfn, tc,
        ctc_log_probs=torch.from_numpy(lp), max_steps=steps)
    jy, jl, js = (np.asarray(a) for a in jout)
    ty, tl, ts = (a.numpy() for a in tout)
    assert (js > -1e20).any(), "the search finished no hypothesis"
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(ts, js, atol=1e-4, rtol=1e-5)
    for bi in range(jy.shape[0]):
        for wi in range(jy.shape[1]):
            np.testing.assert_array_equal(ty[bi, wi, :tl[bi, wi]],
                                          jy[bi, wi, :jl[bi, wi]])


def test_topk_breaks_ties_like_lax_top_k():
    import jax

    x = np.array([[1.0, 3.0, 3.0, -1e30, 3.0, -1e30]], np.float32)
    js, ji = jax.lax.top_k(jnp.asarray(x), 5)
    ts, ti = tbs._topk(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    ts, ti = tbs._topk(torch.from_numpy(x), 8)  # padded past the width
    assert ts.shape == (1, 8) and (ts.numpy()[0, 6:] == tbs.NEG_INF).all()


def test_config_fields_match():
    jf = {f.name: f.default for f in dataclasses.fields(jbs.BeamSearchConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tbs.BeamSearchConfig)}
    assert jf == tf
