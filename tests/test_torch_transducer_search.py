"""The port's four batched transducer searches (`decode/transducer_search
.py`) against the JAX package's on a tiny joint and prediction network
(numpy weights, the same callbacks written in jnp and in torch): the same
tokens and scores within 1e-4 for mAES, ALSD, TSD and NSC over ragged
lengths, and mAES and NSC against the JAX numpy oracles. Then the ranking's
tie order and `Speech2TextTransducer`'s choice of search.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.decode import transducer_search as js
from espnet_tpu_torch.decode import transducer_search as ts
from espnet_tpu_torch.decode.transducer_inference import \
    Speech2TextTransducer
from espnet_tpu_torch.models import transducer as ttm


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

# float32 scores summed over a few frames in the same order
SCORE_TOL = 1e-4
DE, H, V = 6, 5, 7


def _toy(seed):
    """joint(e, d) = [e, d] @ wj + bias (the blank's bias -1, so that
    every search emits labels); the prediction network's output is its
    state, step = tanh(E[token] + W state), BOS = the blank's embedding."""
    rng = np.random.RandomState(seed)
    wj = rng.randn(DE + H, V).astype(np.float32) * 0.7
    bias = np.zeros(V, np.float32)
    bias[0] = -1.0
    emb = rng.randn(V, H).astype(np.float32) * 0.7
    wr = rng.randn(H, H).astype(np.float32) * 0.5

    def numpy_side():
        def joint(e, d):
            return np.concatenate([e, d]) @ wj + bias

        def init():
            out = np.tanh(emb[0])
            return out, out

        def step(state, tok):
            out = np.tanh(emb[tok] + wr @ state)
            return out, out

        return joint, init, step

    def jax_side():
        wj_j, emb_j, wr_j, b_j = map(jnp.asarray, (wj, emb, wr, bias))

        def joint(e, d):
            return jnp.concatenate([e, d], -1) @ wj_j + b_j

        def init(n):
            out = jnp.tanh(jnp.tile(emb_j[0][None], (n, 1)))
            return out, out

        def step(state, tok):
            out = jnp.tanh(emb_j[tok] + state @ wr_j.T)
            return out, out

        return {"joint_fn": joint, "dec_init": init, "dec_step": step}

    def torch_side():
        wj_t, emb_t, wr_t, b_t = map(torch.from_numpy, (wj, emb, wr, bias))

        def joint(e, d):
            return torch.cat([e, d], -1) @ wj_t + b_t

        def init(n):
            out = torch.tanh(emb_t[0][None].repeat(n, 1))
            return out, out

        def step(state, tok):
            out = torch.tanh(emb_t[tok] + state @ wr_t.T)
            return out, out

        return {"joint_fn": joint, "dec_init": init, "dec_step": step}

    return numpy_side(), jax_side(), torch_side()


def _enc(seed, b=3, t=6):
    rng = np.random.RandomState(100 + seed)
    return (rng.randn(b, t, DE).astype(np.float32),
            np.array([t, 4, 2][:b], np.int32))


SEARCHES = [
    # (name, config kwargs, extra kwargs)
    ("batched_transducer_beam_search", {"max_expansions": 1}, {}),
    ("batched_transducer_beam_search", {"max_expansions": 2}, {}),
    ("batched_transducer_alsd", {}, {"u_max": 4}),
    ("batched_transducer_tsd", {"max_expansions": 2}, {}),
    ("batched_transducer_nsc", {"max_expansions": 1}, {}),
    ("batched_transducer_nsc", {"max_expansions": 3}, {}),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,cfg,extra", SEARCHES,
                         ids=[f"{n.split('_')[-1]}-{c}" for n, c, _ in
                              SEARCHES])
def test_batched_searches_match_jax(seed, name, cfg, extra):
    _, jfns, tfns = _toy(seed)
    enc, lens = _enc(seed)
    kw = dict(beam_size=4, max_tokens=8, **cfg)
    want = jax.jit(lambda e, l: getattr(js, name)(
        e, l, config=js.TransducerSearchConfig(**kw), **jfns, **extra))(
            jnp.asarray(enc), jnp.asarray(lens))
    got = getattr(ts, name)(torch.from_numpy(enc), torch.from_numpy(lens),
                            config=ts.TransducerSearchConfig(**kw), **tfns,
                            **extra)
    wt, wl, wsc = map(np.asarray, want)
    gt, gl, gsc = (x.numpy() for x in got)
    np.testing.assert_array_equal(gl, wl)
    for i in range(len(lens)):
        assert gt[i, :gl[i]].tolist() == wt[i, :wl[i]].tolist(), i
    np.testing.assert_allclose(gsc, wsc, rtol=SCORE_TOL, atol=SCORE_TOL)
    assert gl.max() > 0, "a search that emits nothing tests little"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_maes_and_nsc_match_the_numpy_oracles(seed):
    (jn, din, dsn), _, tfns = _toy(seed)
    enc, lens = _enc(seed)
    for e in (1, 2):
        toks, tlens, scores = ts.batched_transducer_beam_search(
            torch.from_numpy(enc), torch.from_numpy(lens), **tfns,
            config=ts.TransducerSearchConfig(beam_size=4, max_expansions=e,
                                             max_tokens=32))
        for i in range(len(lens)):
            ref, ref_score = js.transducer_beam_search_numpy(
                enc[i, :lens[i]], joint_fn=jn, dec_init=din, dec_step=dsn,
                beam_size=4, max_expansions=e)
            assert toks[i, :tlens[i]].tolist() == ref
            assert abs(float(scores[i]) - ref_score) < 1e-3
    for nstep in (1, 2):
        toks, tlens, scores = ts.batched_transducer_nsc(
            torch.from_numpy(enc), torch.from_numpy(lens), **tfns,
            config=ts.TransducerSearchConfig(beam_size=4,
                                             max_expansions=nstep,
                                             max_tokens=32))
        for i in range(len(lens)):
            ref, ref_score = js.transducer_nsc_numpy(
                enc[i, :lens[i]], joint_fn=jn, dec_init=din, dec_step=dsn,
                beam_size=4, nstep=nstep)
            assert toks[i, :tlens[i]].tolist() == ref
            assert abs(float(scores[i]) - ref_score) < 1e-3


def test_ranking_breaks_ties_toward_the_lower_index_as_jax_does():
    x = np.array([[-1e30, 3.0, -1e30, 3.0, -1e30, 1.0, -1e30]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 5)
    got_v, got_i = ts.top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("beam,search,method", [
    (1, "maes", "greedy_search"), (3, "maes", "beam_search"),
    (3, "nsc", "nsc_search"), (3, "tsd", "tsd_search"),
    (3, "alsd", "alsd_search"), (3, "greedy", "greedy_search"),
])
def test_speech2text_transducer_picks_the_search(monkeypatch, beam, search,
                                                 method):
    cfg = ttm.TransducerConfig(
        vocab_size=10, input_type="feats", n_mels=8, use_specaug=False,
        encoder_type="transformer", d_model=16, num_heads=2, d_ff=32,
        num_encoder_layers=1, decoder_embed_dim=16, decoder_hidden=16,
        joint_dim=16, dropout_rate=0.0)
    model = ttm.TransducerASRModel(cfg)
    called = []
    original = getattr(ttm.TransducerASRModel, method)

    def spy(self, *a, **k):
        called.append(method)
        return original(self, *a, **k)

    monkeypatch.setattr(ttm.TransducerASRModel, method, spy)
    s2t = Speech2TextTransducer(model, device="cpu", beam_size=beam,
                                max_tokens=16, search=search)
    rng = np.random.RandomState(0)
    out = s2t(rng.randn(2, 40, 8).astype(np.float32), np.array([40, 25]),
              keys=["a", "b"])
    assert called == [method]
    assert [r.key for r in out] == ["a", "b"]
    for r in out:
        assert r.nbest == [(r.token_ids, r.score)]
        assert all(0 <= i < 10 for i in r.token_ids)
        if method == "greedy_search":
            assert r.score == 0.0
    with pytest.raises(ValueError, match="search"):
        Speech2TextTransducer(model, device="cpu", search="beam")
