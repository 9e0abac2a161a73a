"""The block-synchronous online beam search against the JAX package's, on
the fixtures of tests/test_online_beam_search.py (a seeded table scorer in
place of the decoder, V = 8, beam 3, seeded CTC posteriors): the blank-path
extension `ctc_prefix_extend` (float32, 1e-5), every block of
`process_block` (the same committed steps, tokens and scores within 1e-4),
the resumed `batched_beam_search` (`initial_state`), the final streaming
result against the port's offline search, and the non-final blocks'
committed steps (no eos, no repeated token)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.decode import ctc_prefix as jctc
from espnet_tpu.decode import online_beam_search as jonline
from espnet_tpu.decode.beam_search import BeamSearchConfig as JConfig
from espnet_tpu.decode.beam_search import batched_beam_search as jsearch
from espnet_tpu_torch.decode import ctc_prefix as tctc
from espnet_tpu_torch.decode import online_beam_search as tonline
from espnet_tpu_torch.decode.beam_search import (BeamSearchConfig,
                                                 batched_beam_search)


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

V, SOS_EOS = 8, 7
T_MAX, MAX_STEPS, W, ENC_LEN = 16, 12, 3, 14
TOL = 1e-5       # float32 log-space recursions, the same order
SCORE_TOL = 1e-4  # summed over up to 12 steps


def _table(seed, maxlen=32):
    rng = np.random.RandomState(seed)
    return np.asarray(jax.nn.log_softmax(
        jnp.asarray(rng.randn(V, maxlen, V) * 2.0), -1))


def _scorers(seed):
    table = _table(seed)
    tt = torch.from_numpy(table)

    def jfn(tokens, pos, cache):
        return jnp.asarray(table)[tokens, pos], cache

    def tfn(tokens, pos, cache):
        return tt[tokens, pos], cache

    return jfn, tfn


def _logp(seed, blank_boost):
    rng = np.random.RandomState(seed)
    logits = rng.randn(1, T_MAX, V) * 1.5
    logits[..., 0] += blank_boost
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))


def _cfgs(ctc_weight):
    kw = dict(beam_size=W, att_weight=1.0 - ctc_weight,
              ctc_weight=ctc_weight, maxlenratio=0.7)
    return JConfig(**kw), BeamSearchConfig(**kw)


def _best(yseq, ylen, score):
    n = int(np.asarray(ylen)[0, 0])
    return list(np.asarray(yseq)[0, 0, :n]), float(np.asarray(score)[0, 0])


def test_ctc_prefix_extend_matches_jax():
    rng = np.random.RandomState(3)
    lp = np.asarray(jax.nn.log_softmax(
        jnp.asarray(rng.randn(2, T_MAX, V)), -1)).astype(np.float32)
    old, new = np.array([3, 5]), np.array([9, 12])
    jlp, jst = jctc.ctc_prefix_init(jnp.asarray(lp), jnp.asarray(old), W)
    # a non-trivial stored state: one scoring step selected
    cand = rng.randint(1, V, (2, W, 4))
    psi, r_new, _ = jctc.ctc_prefix_score(jst, jlp, jnp.asarray(old),
                                          jnp.asarray(cand))
    sel = jnp.asarray(rng.randint(0, 4, (2, W)))
    jst = jctc.ctc_prefix_select(jst, r_new, psi, jnp.asarray(cand),
                                 jnp.zeros((2, W), jnp.int32), sel)
    jpad = jctc.pad_log_probs(jnp.asarray(lp), jnp.asarray(new))
    want = jctc.ctc_prefix_extend(jst, jpad, jnp.asarray(old),
                                  jnp.asarray(new))
    tst = tctc.CTCPrefixState(
        r=torch.from_numpy(np.array(jst.r)),
        psi=torch.from_numpy(np.array(jst.psi)),
        last=torch.from_numpy(np.array(jst.last)).long())
    got = tctc.ctc_prefix_extend(
        tst, tctc.pad_log_probs(torch.from_numpy(lp), torch.from_numpy(new)),
        torch.from_numpy(old), torch.from_numpy(new))
    np.testing.assert_allclose(got.r.numpy(), np.asarray(want.r), atol=TOL,
                               rtol=TOL)
    assert torch.equal(got.last, tst.last)
    # no new frames: unchanged
    same = tctc.ctc_prefix_extend(tst, torch.from_numpy(lp),
                                  torch.from_numpy(new),
                                  torch.from_numpy(new))
    assert torch.equal(same.r, tst.r)


def _stream(ctc_weight, blocks, seed_lp, seed_table, boost):
    """Both packages' online searches over the same blocks; returns the
    per-block (JAX, port) outputs and the port's offline result."""
    jcfg, tcfg = _cfgs(ctc_weight)
    jfn, tfn = _scorers(seed_table)
    lp = _logp(seed_lp, boost)
    jstate = jonline.init_online_state(jcfg, SOS_EOS, SOS_EOS, 1, T_MAX,
                                       MAX_STEPS, jnp.zeros((W, 1)),
                                       vocab_size=V)
    tstate = tonline.init_online_state(tcfg, SOS_EOS, SOS_EOS, 1, T_MAX,
                                       MAX_STEPS, torch.zeros(W, 1),
                                       vocab_size=V)
    buf = np.zeros((1, T_MAX, V), np.float32)
    old, outs = 0, []
    for new in blocks:
        buf[:, old:new] = lp[:, old:new]
        final = new == ENC_LEN
        jstate, *jres = jonline.process_block(
            jcfg, SOS_EOS, SOS_EOS, V, jstate, jnp.asarray(buf),
            jnp.asarray([old]), jnp.asarray([new]), jfn, is_final=final,
            max_steps=MAX_STEPS)
        tstate, *tres = tonline.process_block(
            tcfg, SOS_EOS, SOS_EOS, V, tstate, torch.from_numpy(buf),
            torch.tensor([old]), torch.tensor([new]), tfn, is_final=final,
            max_steps=MAX_STEPS)
        outs.append((jstate, jres, tstate, tres))
        old = new
    off = batched_beam_search(
        tcfg, SOS_EOS, SOS_EOS, V, torch.tensor([ENC_LEN]), tfn,
        torch.zeros(W, 1),
        ctc_log_probs=(torch.from_numpy(lp[:, :ENC_LEN]) if ctc_weight
                       else None), max_steps=MAX_STEPS)
    return outs, off


@pytest.mark.parametrize("ctc_weight", [0.0, 0.3])
def test_process_block_matches_jax_and_offline(ctc_weight):
    outs, off = _stream(ctc_weight, (5, 10, ENC_LEN), 11, 4, 4.0)
    for jstate, jres, tstate, tres in outs:
        assert tstate.step == int(jstate.step)
        for j, t in zip(jres[:2], tres[:2]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        live = np.asarray(jres[2]) > -1e29
        np.testing.assert_allclose(tres[2].numpy()[live],
                                   np.asarray(jres[2])[live],
                                   atol=SCORE_TOL, rtol=SCORE_TOL)
        if ctc_weight:
            np.testing.assert_allclose(tstate.ctc.r.numpy(),
                                       np.asarray(jstate.ctc.r), atol=TOL,
                                       rtol=TOL)
    # the final streaming 1-best is the offline 1-best (its score too
    # without CTC, whose extension approximates the prefix scores)
    got, want = _best(*outs[-1][3]), _best(*off)
    assert got[0] == want[0]
    if ctc_weight == 0.0:
        assert abs(got[1] - want[1]) < SCORE_TOL


def test_nonfinal_blocks_commit_only_safe_steps():
    outs, _ = _stream(0.3, (8,), 2, 9, 0.0)
    jstate, _, tstate, (yseq, ylen, _) = outs[0]
    assert tstate.step == int(jstate.step) and 0 <= tstate.step <= 8
    for wi in range(W):
        toks = yseq[0, wi, :int(ylen[0, wi])].tolist()
        assert SOS_EOS not in toks
        assert len(set(toks)) == len(toks)


def test_resumed_search_matches_jax():
    """`batched_beam_search(initial_state=...)` from the state of a
    non-final block, against JAX's resume."""
    outs, _ = _stream(0.3, (8,), 11, 4, 4.0)
    jstate, _, tstate, _ = outs[0]
    jcfg, tcfg = _cfgs(0.3)
    jfn, tfn = _scorers(4)
    lp = _logp(11, 4.0).astype(np.float32)  # the T_MAX-frame buffer
    lp[:, ENC_LEN:] = 0.0
    want = jsearch(jcfg, SOS_EOS, SOS_EOS, V, jnp.asarray([ENC_LEN]), jfn,
                   jstate.att_cache, ctc_log_probs=jnp.asarray(lp),
                   max_steps=MAX_STEPS, initial_state=jstate)
    got = batched_beam_search(tcfg, SOS_EOS, SOS_EOS, V,
                              torch.tensor([ENC_LEN]), tfn, tstate.att_cache,
                              ctc_log_probs=torch.from_numpy(lp),
                              max_steps=MAX_STEPS, initial_state=tstate)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    live = np.asarray(want[2]) > -1e29
    np.testing.assert_allclose(got[2].numpy()[live], np.asarray(want[2])[live],
                               atol=SCORE_TOL, rtol=SCORE_TOL)
