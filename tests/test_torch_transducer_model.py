"""The port's transducer model (`models/transducer.py`) against the JAX
package's, float32 on the CPU: the configuration mirror and the full-width
parameter tree, the prediction network (flax's `OptimizedLSTMCell`, step by
step and over a whole sequence), and reduced models (2 encoder layers of
d_model 64, vocab 32; conformer and transformer; 1- and 2-layer LSTMs) with
parameters carried over from JAX: the loss with aux CTC, the aux transducer
through the frozen joint, the symmetric KL and the LM loss, every gradient,
and greedy search. Then the converter's round trip and the configuration
errors that JAX does not raise.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models import transducer as jtm
from espnet_tpu.tasks.transducer import \
    TransducerModelSection as JModelSection
from espnet_tpu_torch.configs import transducer_conformer
from espnet_tpu_torch.convert import (jax_params_to_state_dict,
                                      load_jax_params,
                                      state_dict_to_jax_params)
from espnet_tpu_torch.models import transducer as ttm
from espnet_tpu_torch.tasks.transducer import (TransducerModelSection,
                                               TransducerTask)


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

FULL_WIDTH_PARAMS = 37_088_264
# the whole model: 2 encoder layers, a log-mel frontend and up to four
# losses, summed in another order; gradients through one more pass
LOSS_TOL = 1e-5
GRAD_TOL = 5e-4
OP_TOL = 1e-5

REDUCED = dict(vocab_size=32, n_mels=16, use_specaug=False, d_model=64,
               num_heads=4, d_ff=128, num_encoder_layers=2,
               decoder_embed_dim=32, decoder_hidden=48, joint_dim=40,
               dropout_rate=0.0)
AUX = dict(ctc_weight=0.3, aux_transducer_weight=0.3, symm_kl_weight=0.2,
           lm_loss_weight=0.1, aux_layers=(1,))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_config_mirrors_the_jax_config():
    jf = {f.name: f.default for f in dataclasses.fields(jtm.TransducerConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ttm.TransducerConfig)}
    assert set(jf) == set(tf)
    for name in jf:
        if name == "dtype":
            assert tf[name] == torch.float32
        elif name != "vocab_size":
            assert tf[name] == jf[name], name
    js = {f.name: f.default for f in dataclasses.fields(JModelSection)}
    ts = {f.name: f.default for f in dataclasses.fields(
        TransducerModelSection)}
    assert set(js) == set(ts)
    assert all(ts[k] == js[k] for k in js if k != "dtype")
    assert ts["dtype"] == "float32"


def test_full_width_model_has_the_jax_tree():
    """transducer_conformer: 37,088,264 parameters, each leaf of the JAX
    tree with its shape (traced with jax.eval_shape)."""
    cfg = transducer_conformer(torch.float32)
    model = ttm.TransducerASRModel(cfg)
    assert sum(p.numel() for p in model.parameters()) == FULL_WIDTH_PARAMS
    jcfg = jtm.TransducerConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "dtype"})
    shapes = jax.eval_shape(lambda: fnn.meta.unbox(
        jtm.TransducerASRModel(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16000)),
            jnp.array([16000]), jnp.zeros((1, 3), jnp.int32),
            jnp.array([3]), True))["params"])
    flat = jax.tree_util.tree_leaves_with_path(shapes)
    assert sum(int(np.prod(x.shape)) for _, x in flat) == FULL_WIDTH_PARAMS
    fake = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                                  shapes)
    sd = jax_params_to_state_dict(fake)
    own = model.state_dict()
    assert set(sd) == set(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in sd)


def _lstm_params(rng, d_in, hidden, layers):
    tree = {}
    for i in range(layers):
        cell = {}
        for g in "ifgo":
            cell[f"i{g}"] = {"kernel": rng.randn(
                d_in if i == 0 else hidden, hidden).astype(np.float32) * 0.3}
            cell[f"h{g}"] = {
                "kernel": rng.randn(hidden, hidden).astype(np.float32) * 0.3,
                "bias": rng.randn(hidden).astype(np.float32) * 0.3}
        tree[f"lstm{i}"] = cell
    return tree


@pytest.mark.parametrize("layers", [1, 2])
def test_prediction_network_full_and_step_match_jax(layers):
    """The full-sequence forward (blank as BOS) against JAX's, and the port's
    `step` from the initial state token by token against its full forward
    (JAX test_prediction_network_step_matches_full)."""
    v, e, h = 11, 6, 8
    rng = np.random.RandomState(layers)
    params = {"embed": {"embedding": rng.randn(v, e).astype(np.float32)},
              **_lstm_params(rng, e, h, layers)}
    tokens = rng.randint(1, v, (3, 5)).astype(np.int32)
    jnet = jtm.PredictionNetwork(v, e, h, layers, 0.0)
    want = jnet.apply({"params": params}, jnp.asarray(tokens))
    net = ttm.PredictionNetwork(v, e, h, layers, 0.0)
    net.load_state_dict(jax_params_to_state_dict(params))
    got = net(_t(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=OP_TOL, atol=OP_TOL)
    state = net.init_state(3)
    outs = []
    for tok in np.concatenate([np.zeros((3, 1), np.int32), tokens], 1).T:
        out, state = net.step(state, _t(tok))
        outs.append(out)
    torch.testing.assert_close(torch.stack(outs, 1), got, rtol=OP_TOL,
                               atol=OP_TOL)
    jout, _ = jnet.apply({"params": params}, jnet.apply(
        {"params": params}, 3, method=jtm.PredictionNetwork.init_state),
        jnp.asarray(tokens[:, 0]), method=jtm.PredictionNetwork.step)
    out, _ = net.step(net.init_state(3), _t(tokens[:, 0]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=OP_TOL, atol=OP_TOL)


def _batch():
    rng = np.random.RandomState(0)
    slen = np.array([16000, 11000, 7000], np.int32)
    speech = np.zeros((3, 16000), np.float32)
    for i, n in enumerate(slen):
        speech[i, :n] = 0.1 * rng.randn(n)
    text = rng.randint(1, 31, (3, 5)).astype(np.int32)
    tlen = np.array([5, 3, 0], np.int32)
    text[np.arange(5)[None, :] >= tlen[:, None]] = 0
    return speech, slen, text, tlen


@pytest.fixture(scope="module", params=[("conformer", 2), ("transformer", 1)],
                ids=["conformer_lstm2", "transformer_lstm1"])
def reduced(request):
    encoder, lstm = request.param
    kw = dict(REDUCED, encoder_type=encoder, decoder_layers=lstm, **AUX)
    jm = jtm.TransducerASRModel(jtm.TransducerConfig(**kw))
    batch = tuple(jnp.asarray(a) for a in _batch())
    v = fnn.meta.unbox(jax.jit(jm.init, static_argnums=(5,))(
        jax.random.PRNGKey(0), *batch, True))
    rng = np.random.RandomState(1)  # exercise zero-initialised leaves too
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a)
        + 0.05 * rng.randn(*a.shape).astype(np.float32), v["params"])

    def loss_fn(p):
        return jm.apply({"params": p}, *batch, True)

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    @jax.jit
    def greedy(p):
        enc, elen = jm.apply({"params": p}, batch[0], batch[1],
                             method=jtm.TransducerASRModel.encode)
        return jm.apply({"params": p}, enc, elen, 12,
                        method=jtm.TransducerASRModel.greedy_search)

    return (kw, params, (jloss, jstats, jgrads), greedy(params))


def test_reduced_model_loss_and_every_gradient_match_jax(reduced):
    kw, params, (jloss, jstats, jgrads), _ = reduced
    tm = load_jax_params(ttm.TransducerASRModel(ttm.TransducerConfig(**kw)),
                         params).train()
    loss, stats = tm(*(_t(a) for a in _batch()))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    assert set(stats) == set(jstats)
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()),
                                   float(jstats[k]), rtol=LOSS_TOL, err_msg=k)
    want = jax_params_to_state_dict(jgrads)
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def test_reduced_model_greedy_search_matches_jax(reduced):
    kw, params, _, (jtoks, jlens) = reduced
    tm = load_jax_params(ttm.TransducerASRModel(ttm.TransducerConfig(**kw)),
                         params).eval()
    speech, slen, _, _ = _batch()
    with torch.no_grad():
        enc, elen = tm.encode(_t(speech), _t(slen))
        toks, lens = tm.greedy_search(enc, elen, 12)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))


def test_the_aux_transducer_leaves_the_joint_frozen():
    """The aux transducer reaches aux_mlp and the encoder, never the joint:
    the joint's gradient is the same with and without the aux term."""
    kw = dict(REDUCED, encoder_type="transformer", aux_layers=(1,),
              aux_transducer_weight=0.5)
    with_aux = ttm.TransducerASRModel(ttm.TransducerConfig(**kw))
    torch.manual_seed(0)
    for p in with_aux.parameters():
        torch.nn.init.normal_(p, std=0.2)
    without = ttm.TransducerASRModel(ttm.TransducerConfig(
        **dict(kw, aux_transducer_weight=0.0)))
    without.load_state_dict({k: v for k, v in with_aux.state_dict().items()
                             if not k.startswith("aux_mlp.")})
    batch = [_t(a) for a in _batch()]
    grads = {}
    for name, model in (("with", with_aux), ("without", without)):
        loss, stats = model.train()(*batch)
        loss.backward()
        grads[name] = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert float(stats["loss"].detach()) > 0
    for n in grads["without"]:
        if n.startswith("joint."):
            torch.testing.assert_close(grads["with"][n], grads["without"][n],
                                       rtol=1e-6, atol=1e-7)
    assert float(grads["with"]["aux_mlp.weight"].abs().max()) > 0
    enc = "encoder.layer0.ff.w1.weight"
    assert not torch.allclose(grads["with"][enc], grads["without"][enc])


def test_converter_round_trip_and_the_global_mvn_collection(reduced):
    """The port's tree back in the JAX layout equals the JAX tree; a
    variables dict with the global-MVN collection loads into the
    transducer, which drops it (the JAX model never reads it)."""
    kw, params, _, _ = reduced
    tm = load_jax_params(ttm.TransducerASRModel(ttm.TransducerConfig(**kw)),
                         params)
    back = state_dict_to_jax_params(tm.state_dict())
    want = {jax.tree_util.keystr(p): x
            for p, x in jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(p): x
           for p, x in jax.tree_util.tree_leaves_with_path(back)}
    assert set(got) == set(want)
    for k, x in want.items():
        np.testing.assert_array_equal(got[k], x, err_msg=k)
    mvn = {"mvn": {"mean": np.ones(16, np.float32),
                   "inv_std": np.ones(16, np.float32)}}
    again = ttm.TransducerASRModel(ttm.TransducerConfig(**kw))
    load_jax_params(again, {"params": params, "mvn": mvn})
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(again.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("overrides,match", [
    ({"encoder_type": "e_branchformer"}, "encoder_type"),
    ({"aux_transducer_weight": 0.3}, "aux_layers"),
    ({"aux_transducer_weight": 0.3, "aux_layers": (3,)}, "aux_layers"),
])
def test_configurations_jax_accepts_silently_raise(overrides, match):
    """JAX builds a transformer for any other encoder type and drops the
    aux transducer when its layer list captures nothing."""
    with pytest.raises(ValueError, match=match):
        ttm.TransducerASRModel(ttm.TransducerConfig(**dict(REDUCED,
                                                           **overrides)))


def test_task_builds_the_model_in_the_section_dtype():
    section = TransducerModelSection(**dict(
        {k: v for k, v in REDUCED.items() if k != "vocab_size"},
        dtype="bfloat16", aux_layers=[1]))
    model = TransducerTask.build_model(section, 32)
    assert model.config.dtype == torch.bfloat16
    assert model.config.aux_layers == (1,)
    assert model.config.vocab_size == 32
