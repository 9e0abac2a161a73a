"""The port's v1 RNN stack against the JAX package's, float32 on the CPU:
the LSTM runner (flax `nn.RNN` over `OptimizedLSTMCell`, both directions
over the padding, with a carry), VGG2L, the VGG-BLSTM and (with a carried
state) VGG-LSTM encoders, each of the 14 attentions of the v1 zoo for 3
steps, the RNN decoder teacher-forced against its own step-by-step
scoring and, with every scheduled-sampling coin injected as heads, against
JAX; then a reduced VGG-BLSTM + RNN-decoder `ASRModel` (1 encoder layer
of d 32, 16 mels, location attention; the encoder tests above stack 2), the same parameters in both
packages (drawn by the port's initialiser in JAX's layout): the loss,
every gradient, one fused-Adam step and the beam search's token ids
against the JAX `Speech2Text`; the full-width configuration's count and
the converter's round trip."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from espnet_tpu.decode.asr_inference import Speech2Text as JSpeech2Text
from espnet_tpu.models import rnn as jrnn
from espnet_tpu.models import rnn_attentions as jatt
from espnet_tpu.models.asr import ASRConfig as JASRConfig
from espnet_tpu.models.asr import ASRModel as JASRModel
from espnet_tpu.train import optim as joptim
from espnet_tpu.train.steps import TrainState as JTrainState
from espnet_tpu.train.steps import make_train_step as jmake_train_step
from espnet_tpu_torch.configs import vgg_blstm_rnn
from espnet_tpu_torch.convert import (jax_params_to_state_dict,
                                      load_jax_params,
                                      state_dict_to_jax_params,
                                      torch_to_jax_tree)
from espnet_tpu_torch.decode.asr_inference import Speech2Text
from espnet_tpu_torch.models import rnn as trnn
from espnet_tpu_torch.models import rnn_attentions as tatt
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel, init_random_
from espnet_tpu_torch.models.layers import LSTMCell, lstm_sequence
from espnet_tpu_torch.train import optim as toptim
from espnet_tpu_torch.train.steps import TrainState, make_train_step

FULL_WIDTH_PARAMS = 16_312_578
OP_TOL = 1e-5     # one module, float32
ENC_TOL = 1e-4    # an encoder over a log-mel frontend
LOSS_TOL = 1e-5
GRAD_TOL = 5e-4
KEYS = ("speech", "speech_lengths", "text", "text_lengths")
REDUCED = dict(vocab_size=24, n_mels=16, use_specaug=False, d_model=32,
               num_encoder_layers=1, encoder_type="vgg_blstm",
               decoder_type="rnn", num_decoder_layers=1, dropout_rate=0.0,
               normalize="utterance_mvn", rnn_att_type="location")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The LSTM loops are thousands of tiny ops: one intra-op thread keeps
    them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturb(tree, seed=1):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(
            np.float32), tree)


def _drawn(module):
    """`module` filled by the port's initialiser (then perturbed) and its
    parameters as a JAX tree: no JAX init to compile."""
    init_random_(module, torch.Generator().manual_seed(0))
    params = _perturb(state_dict_to_jax_params(module.state_dict()))
    return _load(module, params), params


def _load(module, params):
    module.load_state_dict(jax_params_to_state_dict(params))
    return module


def _close(got, want, tol=OP_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), atol=tol, rtol=tol,
        err_msg=msg)


class _JBiRNN(fnn.Module):
    """nn.RNN forward with a carry in and out, and reversed."""

    @fnn.compact
    def __call__(self, x, carry):
        c, fwd = fnn.RNN(fnn.OptimizedLSTMCell(6))(
            x, initial_carry=carry, return_carry=True)
        bwd = fnn.RNN(fnn.OptimizedLSTMCell(6), reverse=True,
                      keep_order=True)(x)
        return fwd, bwd, c


def test_lstm_runner_matches_flax_rnn():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 5).astype(np.float32)
    x[1, 4:] = 0.0  # padding: both directions still run over it
    carry = tuple(rng.randn(2, 6).astype(np.float32) for _ in range(2))
    cells, params = _drawn(torch.nn.ModuleDict(
        {f"OptimizedLSTMCell_{k}": LSTMCell(5, 6) for k in range(2)}))
    cells = list(cells.values())
    jf, jb, (jc, jh) = _JBiRNN().apply({"params": params}, jnp.asarray(x),
                                       carry)
    with torch.no_grad():
        tf, (tc, th) = lstm_sequence(cells[0], _t(x),
                                     carry=tuple(map(_t, carry)))
        tb, _ = lstm_sequence(cells[1], _t(x), reverse=True)
    for got, want in ((tf, jf), (tb, jb), (tc, jc), (th, jh)):
        _close(got, want)


@pytest.fixture(scope="module")
def feats():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 21, 16).astype(np.float32)
    lens = np.array([21, 13], np.int32)
    x[1, 13:] = 0.0
    return x, lens


def test_vgg2l_matches_jax(feats):
    x, lens = feats
    tm, params = _drawn(trnn.VGG2L(16, 12))
    jy, jl = jrnn.VGG2L(12).apply({"params": params}, jnp.asarray(x),
                                  jnp.asarray(lens))
    with torch.no_grad():
        ty, tl = tm(_t(x), _t(lens))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close(ty, jy)


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["vgg_blstm", "vgg_lstm_carry"])
def test_vgg_rnn_encoder_matches_jax(feats, bidirectional):
    x, lens = feats
    m = jrnn.VGGRNNEncoder(d_model=12, hidden=10, num_layers=2,
                           bidirectional=bidirectional)
    tm, params = _drawn(trnn.VGGRNNEncoder(16, 12, 10, 2, bidirectional))
    if bidirectional:
        jy, jl = m.apply({"params": params}, jnp.asarray(x),
                         jnp.asarray(lens))
        with torch.no_grad():
            ty, tl = tm(_t(x), _t(lens))
    else:  # resume from a carried state, return the new one
        rng = np.random.RandomState(3)
        carry = [tuple(rng.randn(2, 10).astype(np.float32) for _ in "ch")
                 for _ in range(2)]
        jy, jl, jc = m.apply({"params": params}, jnp.asarray(x),
                             jnp.asarray(lens), carry=carry,
                             return_carry=True)
        with torch.no_grad():
            ty, tl, tc = tm(_t(x), _t(lens), carry=[tuple(map(_t, c))
                                                    for c in carry],
                            return_carry=True)
        for got, want in zip(tc, jc):
            _close(got[0], want[0])
            _close(got[1], want[1])
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close(ty, jy)


ENC_DIM, DEC_DIM, OUT_PREV = 6, 5, 4


@pytest.mark.parametrize("att_type", jatt.ATT_TYPES)
def test_attention_three_steps_match_jax(att_type):
    rng = np.random.RandomState(4)
    b, t = 2, 9
    enc = rng.randn(b, t, ENC_DIM).astype(np.float32)
    mask = np.arange(t)[None] < np.array([9, 6])[:, None]
    decs = rng.randn(3, b, DEC_DIM).astype(np.float32)
    outs = rng.randn(3, b, OUT_PREV).astype(np.float32)
    kw = dict(att_dim=8, conv_channels=3, conv_kernel=7, heads=2, att_win=3,
              out_dim=ENC_DIM)
    jm = jatt.make_attention(att_type, **kw)
    jstate = jm.init_state(b, t, jnp.asarray(mask))
    out_prev = jnp.asarray(outs[0]) if att_type == "forward_ta" else None
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(enc), jnp.asarray(mask),
                jnp.asarray(decs[0]), jstate, out_prev)
    params = _perturb(v.get("params", {}))
    tm = tatt.make_attention(att_type, ENC_DIM, DEC_DIM,
                             out_prev_dim=OUT_PREV, **kw)
    if params:
        _load(tm, params)
    tstate = tm.init_state(b, t, _t(mask))
    apply = jax.jit(jm.apply)
    for step in range(3):
        out_prev = (outs[step] if att_type == "forward_ta" else None)
        jc, jw, jstate = apply(
            {"params": params}, jnp.asarray(enc), jnp.asarray(mask),
            jnp.asarray(decs[step]), jstate,
            None if out_prev is None else jnp.asarray(out_prev))
        with torch.no_grad():
            tc, tw, tstate = tm(_t(enc), _t(mask), _t(decs[step]), tstate,
                                None if out_prev is None else _t(out_prev))
        _close(tc, jc, msg=f"{att_type} context, step {step}")
        _close(tw, jw, msg=f"{att_type} weights, step {step}")
        assert set(tstate) == set(jstate)
        for k in tstate:
            assert tstate[k].shape[0] == b  # the beam search's row axis
            _close(tstate[k], jstate[k], msg=f"{att_type} {k}, step {step}")


def _decoder_inputs():
    rng = np.random.RandomState(5)
    mem = rng.randn(2, 11, 8).astype(np.float32)
    mlens = np.array([11, 7], np.int32)
    tokens = rng.randint(1, 19, (2, 5)).astype(np.int32)
    return mem, mlens, tokens


def test_rnn_decoder_teacher_forcing_equals_steps():
    """The teacher-forced logits equal the beam interface's step-by-step
    log-probs (after a log-softmax), with and without injected coins."""
    torch.manual_seed(0)
    mem, mlens, tokens = map(_t, _decoder_inputs())
    dec = trnn.RNNDecoder(20, encoder_dim=8, embed_dim=6, hidden=7,
                          num_layers=2, att_type="location", att_dim=9,
                          sampling_probability=0.5, dropout_rate=0.0)
    coins = [True, False, True, True, False]
    with torch.no_grad():
        for sampled in (False, True):
            dec.train(sampled)
            logits = dec(tokens, None, mem, mlens,
                         coins=coins if sampled else None)
            cache = dec.score_memory_cache(2, mem, mlens)
            prev = None
            for i in range(tokens.shape[1]):
                tok = tokens[:, i]
                if sampled and coins[i] and i > 0:
                    tok = prev.argmax(-1)
                lp, cache = dec.score_step(tok, i, mem, mlens, cache)
                _close(lp, torch.log_softmax(logits[:, i], -1))
                prev = lp
            assert cache["h"].shape == (2, 2, 7)


def test_scheduled_sampling_with_injected_coins_matches_jax(monkeypatch):
    """Every coin heads: from the second step on each input is the previous
    step's argmax, in both packages (JAX's draw patched to True)."""
    mem, mlens, tokens = _decoder_inputs()
    jd = jrnn.RNNDecoder(20, encoder_dim=8, embed_dim=6, hidden=7,
                         num_layers=1, sampling_probability=0.5,
                         dropout_rate=0.0)
    args = (jnp.asarray(tokens), None, jnp.asarray(mem), jnp.asarray(mlens))
    td, params = _drawn(trnn.RNNDecoder(
        20, encoder_dim=8, embed_dim=6, hidden=7, num_layers=1,
        sampling_probability=0.5, dropout_rate=0.0))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.bool_(True))
    want = jd.apply({"params": params}, *args, False,
                    rngs={"sampling": jax.random.PRNGKey(1)})
    td.train()
    with torch.no_grad():
        got = td(_t(tokens), None, _t(mem), _t(mlens), coins=[True] * 5)
        teacher = td.eval()(_t(tokens), None, _t(mem), _t(mlens))
    _close(got, want, tol=ENC_TOL)
    assert not torch.allclose(got[:, 1:], teacher[:, 1:])


# ------------------------------------------------------------ reduced model

def jax_config(cfg: ASRConfig) -> JASRConfig:
    return JASRConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)
                         if f.name != "dtype"})


@pytest.fixture(scope="module")
def reduced():
    cfg = ASRConfig(**REDUCED)
    rng = np.random.RandomState(0)
    lens = np.array([8000, 6000], np.int32)  # T' 15 and 11
    speech = (0.1 * rng.randn(2, 8000)).astype(np.float32)
    speech[np.arange(8000)[None] >= lens[:, None]] = 0.0
    text = rng.randint(1, 23, (2, 5)).astype(np.int32)
    tlens = np.array([5, 3], np.int32)
    text[np.arange(5)[None] >= tlens[:, None]] = 0
    batch = dict(zip(KEYS, (speech, lens, text, tlens)))
    jm = JASRModel(jax_config(cfg))
    jb = tuple(jnp.asarray(batch[k]) for k in KEYS)
    return cfg, jm, port_drawn_params(cfg), jb, batch


def port_drawn_params(cfg):
    """A JAX parameter tree drawn by the port's initialiser and perturbed
    (zero-initialised leaves too); its layout is held against JAX's own
    by `assert_jax_layout`."""
    model = init_random_(ASRModel(cfg), torch.Generator().manual_seed(0))
    prng = np.random.RandomState(1)
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * prng.randn(*a.shape).astype(np.float32),
        state_dict_to_jax_params(model.state_dict()))


def assert_jax_layout(jm, jb, params):
    """`params` has the keys and shapes of the JAX model's own tree."""
    want = jax.eval_shape(lambda: fnn.meta.unbox(jm.init(
        jax.random.PRNGKey(0), *jb, True))["params"])

    def shapes(tree):
        return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)

    assert shapes(want) == shapes(params)


def test_reduced_loss_and_every_gradient_match_jax(reduced):
    cfg, jm, params, jb, batch = reduced
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, *jb, True), has_aux=True))(params)
    tm = load_jax_params(ASRModel(cfg), params).train()
    tloss, tstats = tm(*(_t(batch[k]) for k in KEYS))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    for k in ("loss_ctc", "loss_att", "acc"):
        np.testing.assert_allclose(float(tstats[k].detach()),
                                   float(jstats[k]), rtol=LOSS_TOL,
                                   atol=1e-7, err_msg=k)
    want = jax_params_to_state_dict(jgrads)
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def test_reduced_train_step_gives_the_same_parameters(reduced):
    """One fused-Adam step in each package (eps 1e-3, as the ASR slice's
    test explains), every parameter after it within 1e-5."""
    cfg, jm, params, jb, batch = reduced
    kw = dict(lr=2e-3, schedule="warmuplr", warmup_steps=10, eps=1e-3,
              grad_clip=5.0)
    jtx = joptim.build_optimizer("fused_adam", **kw)
    flat, unravel = ravel_pytree(params)
    jstep = jmake_train_step(jm, jtx, donate=False, unravel=unravel)
    jstate, jstats = jstep(JTrainState.create(flat, jtx, {}),
                           dict(zip(KEYS, jb)), jax.random.PRNGKey(0))
    tm = load_jax_params(ASRModel(cfg), params)
    ttx = toptim.build_optimizer("fused_adam", **kw)
    state, tstats = make_train_step(tm, ttx, device="cpu")(
        TrainState.create(tm, ttx), batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(tstats["loss"]), float(jstats["loss"]),
                               rtol=LOSS_TOL)
    got = torch_to_jax_tree(dict(tm.named_parameters()), params)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                                atol=2e-6),
        got, unravel(jstate.params))


def test_beam_search_tokens_match_jax(reduced):
    """Beam 3, CTC weight 0.3, 6 label steps: the RNN cache (h and c
    stacked on axis 1 and the attention's dict) reordered by the port's
    search gives JAX's n-best token ids and scores."""
    cfg, jm, params, _, batch = reduced
    js = JSpeech2Text(jm, params, beam_size=3, ctc_weight=0.3, max_steps=6)
    jy, jl, jsc = map(np.asarray, js._decode_jit(
        jnp.asarray(batch["speech"]), jnp.asarray(batch["speech_lengths"])))
    ts = Speech2Text(load_jax_params(ASRModel(cfg), params), device="cpu",
                     beam_size=3, ctc_weight=0.3, max_steps=6)
    ty, tl, tsc = (a.numpy() for a in ts.decode_batch(
        _t(batch["speech"]), _t(batch["speech_lengths"]).long()))
    np.testing.assert_array_equal(tl, jl)
    for bi in range(jy.shape[0]):
        for wi in range(jy.shape[1]):
            np.testing.assert_array_equal(ty[bi, wi, :tl[bi, wi]],
                                          jy[bi, wi, :jl[bi, wi]])
    np.testing.assert_allclose(tsc, jsc, atol=1e-4, rtol=1e-5)


def test_full_width_count_and_round_trip(reduced):
    full = ASRModel(vgg_blstm_rnn(torch.float32))
    assert sum(p.numel() for p in full.parameters()) == FULL_WIDTH_PARAMS
    cfg, jm, params, jb, _ = reduced
    assert_jax_layout(jm, jb, params)
    back = state_dict_to_jax_params(
        load_jax_params(ASRModel(cfg), params).state_dict())
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(back))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        params, back)
