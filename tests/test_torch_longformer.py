"""The port's longformer encoder (`models/longformer.py`) against the JAX
package's, float32 on the CPU: `LocalSelfAttention`'s band (ragged
lengths, T' over several blocks) and its window >= T case, which is full
attention; then a reduced longformer `ASRModel` (2 layers, d 64, window 8,
T' = 30: four blocks), the same parameters in both packages (drawn by
the port's initialiser in JAX's layout): encode, the loss and every
gradient; the full-width configuration's parameter count; and the
converter's round trip on the longformer tree."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models.asr import ASRConfig as JASRConfig
from espnet_tpu.models.asr import ASRModel as JASRModel
from espnet_tpu.models.longformer import LocalSelfAttention as JLocal
from espnet_tpu_torch.configs import longformer_conformer
from espnet_tpu_torch.convert import (jax_params_to_state_dict,
                                      load_jax_params,
                                      state_dict_to_jax_params)
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel, init_random_
from espnet_tpu_torch.models.longformer import LocalSelfAttention


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

FULL_WIDTH_PARAMS = 46_043_920
ATT_TOL = 1e-5   # one attention layer, float32
ENC_TOL = 1e-4   # 2 layers over a log-mel frontend, summed in another order
LOSS_TOL = 1e-5
GRAD_TOL = 5e-4
KEYS = ("speech", "speech_lengths", "text", "text_lengths")
REDUCED = dict(vocab_size=48, n_mels=20, use_specaug=False, d_model=64,
               num_heads=4, d_ff=128, num_encoder_layers=2,
               num_decoder_layers=1, decoder_d_ff=128,
               conformer_kernel_size=7, dropout_rate=0.0,
               normalize="utterance_mvn", encoder_type="longformer",
               attention_window=8)


def jax_config(cfg: ASRConfig) -> JASRConfig:
    return JASRConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)
                         if f.name != "dtype"})


def _t(a):
    return torch.from_numpy(np.array(a))


def test_local_attention_band_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 23, 16).astype(np.float32)
    mask = np.arange(23)[None] < np.array([23, 15])[:, None]
    jm = JLocal(2, 16, 5)
    v = fnn.meta.unbox(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               jnp.asarray(mask)))
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(mask))
    tm = LocalSelfAttention(2, 16, 5)
    tm.load_state_dict(jax_params_to_state_dict(v["params"]))
    with torch.no_grad():
        got = tm(_t(x), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATT_TOL,
                               rtol=ATT_TOL)
    assert not got[1, 15:].any()  # padded queries zeroed


def test_window_at_least_t_is_full_attention():
    """With w >= T there is one block: every query sees every valid key."""
    torch.manual_seed(0)
    t, d, h = 11, 16, 2
    m = LocalSelfAttention(h, d, window=t)
    x = torch.randn(2, t, d)
    mask = torch.arange(t)[None] < torch.tensor([t, 7])[:, None]
    with torch.no_grad():
        got = m(x, mask)

        def heads(y):
            return y.reshape(2, t, h, d // h).transpose(1, 2)

        q, k, v = heads(m.q_proj(x)), heads(m.k_proj(x)), heads(m.v_proj(x))
        s = q @ k.transpose(-1, -2) / (d // h) ** 0.5
        s = s.masked_fill(~mask[:, None, None, :], torch.finfo(s.dtype).min)
        out = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(2, t, d)
        want = m.out_proj(out) * mask[:, :, None]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATT_TOL,
                               rtol=ATT_TOL)


@pytest.fixture(scope="module")
def reduced():
    cfg = ASRConfig(**REDUCED)
    rng = np.random.RandomState(0)
    lens = np.array([16000, 11000], np.int32)  # T' 30 and 20
    speech = (0.1 * rng.randn(2, 16000)).astype(np.float32)
    speech[np.arange(16000)[None] >= lens[:, None]] = 0.0
    text = rng.randint(1, 47, (2, 6)).astype(np.int32)
    tlens = np.array([6, 4], np.int32)
    text[np.arange(6)[None] >= tlens[:, None]] = 0
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


def test_reduced_encode_loss_and_gradients_match_jax(reduced):
    cfg, jm, params, jb, batch = reduced

    def loss_and_encode(p):
        loss, stats = jm.apply({"params": p}, *jb, True)
        enc = jm.apply({"params": p}, *jb[:2], method=JASRModel.encode)
        return loss, (stats, enc)

    (jloss, (jstats, (je, jl))), jgrads = jax.jit(jax.value_and_grad(
        loss_and_encode, has_aux=True))(params)
    tm = load_jax_params(ASRModel(cfg), params).train()
    with torch.no_grad():
        te, tl = tm.encode(_t(batch["speech"]), _t(batch["speech_lengths"]))
    assert te.shape[1] == 30 > 3 * cfg.attention_window
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=ENC_TOL,
                               rtol=ENC_TOL)
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


def test_full_width_count_and_round_trip(reduced):
    """46,043,920 parameters at full width (the JAX count); the reduced
    tree has JAX's layout (`jax.eval_shape` of its init) and comes back
    unchanged through the port."""
    full = ASRModel(longformer_conformer(torch.float32))
    assert sum(p.numel() for p in full.parameters()) == FULL_WIDTH_PARAMS
    cfg, jm, params, jb, _ = reduced
    assert_jax_layout(jm, jb, params)
    back = state_dict_to_jax_params(
        load_jax_params(ASRModel(cfg), params).state_dict())
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        params, back)
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(back))
