"""The port's Mask-CTC model (`models/maskctc.py`) against the JAX
package's, float32 on the CPU.

A reduced model (one conformer layer of d_model 64, a one-layer MLM decoder,
vocab 20, utterance MVN, SpecAug and dropout off) with parameters carried
over from JAX: the loss, its stats and every gradient with the masked
positions injected (JAX's own draw in deterministic mode, the fixed key
PRNGKey(0), repeated here), the encoder output, and `MaskCTCInference`'s
token ids against JAX's on three utterances whose tokens all fall below the
confidence threshold (so every infilling round runs). Then the port's mask
draw, the configuration mirror, the task and the converter's handling of
the global-MVN collection, which the model never reads.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models import maskctc as jmc
from espnet_tpu.tasks.maskctc import MaskCTCModelSection as JSection
from espnet_tpu_torch.configs import maskctc_conformer
from espnet_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from espnet_tpu_torch.models import maskctc as tmc
from espnet_tpu_torch.tasks.maskctc import MaskCTCModelSection, MaskCTCTask

FULL_WIDTH_PARAMS = 46_837_009
# one conformer layer, a log-mel frontend and two losses: float32 sums in
# another order; the gradients through one more pass
LOSS_TOL = 1e-5
GRAD_TOL = 5e-4
ENC_TOL = 1e-4

REDUCED = dict(vocab_size=20, n_mels=16, use_specaug=False, d_model=64,
               num_heads=4, d_ff=128, num_encoder_layers=1,
               num_decoder_layers=1, decoder_d_ff=128, dropout_rate=0.0,
               normalize="utterance_mvn", conformer_kernel_size=5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: one intra-op thread keeps them from contending with the
    other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch():
    rng = np.random.RandomState(0)
    slen = np.array([8000, 6000, 4000], np.int32)
    speech = np.zeros((3, 8000), np.float32)
    for i, n in enumerate(slen):
        speech[i, :n] = 0.1 * rng.randn(n)
    text = rng.randint(1, 19, (3, 5)).astype(np.int32)
    tlen = np.array([5, 3, 1], np.int32)
    text[np.arange(5)[None, :] >= tlen[:, None]] = 0
    return speech, slen, text, tlen


def jax_deterministic_mask(tlen, u):
    """The positions the JAX model masks with deterministic=True (its
    mask_uniform draw from PRNGKey(0))."""
    b = len(tlen)
    tl = jnp.asarray(tlen)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    lens_f = jnp.maximum(tl.astype(jnp.float32), 1.0)
    num = jax.random.randint(k1, (b,), 1, jnp.maximum(tl, 1) + 1)
    rate = num.astype(jnp.float32) / lens_f
    valid = jnp.arange(u)[None, :] < tl[:, None]
    masked = (jax.random.uniform(k2, (b, u)) < rate[:, None]) & valid
    first = jnp.zeros((b, u), bool).at[:, 0].set(True) & valid
    return np.asarray(jnp.where(jnp.any(masked, 1, keepdims=True), masked,
                                first))


@pytest.fixture(scope="module")
def reduced():
    jm = jmc.MaskCTCModel(jmc.MaskCTCConfig(**REDUCED))
    batch = tuple(jnp.asarray(a) for a in _batch())
    v = fnn.meta.unbox(jax.jit(jm.init, static_argnums=(5,))(
        jax.random.PRNGKey(0), *batch, True))
    rng = np.random.RandomState(1)  # exercise zero-initialised leaves too
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a)
        + 0.05 * rng.randn(*a.shape).astype(np.float32), v["params"])
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, *batch, True), has_aux=True))(
        params)
    enc, elen = jax.jit(lambda p: jm.apply(
        {"params": p}, batch[0], batch[1],
        method=jmc.MaskCTCModel.encode))(params)
    ids = jmc.MaskCTCInference(jm, {"params": params}, n_iterations=3,
                               threshold_probability=0.99)(
        _batch()[0], _batch()[1])
    return params, (jloss, jstats, jgrads), (enc, elen), ids


def _port(params):
    return load_jax_params(
        tmc.MaskCTCModel(tmc.MaskCTCConfig(**REDUCED)), params)


def test_loss_stats_and_every_gradient_match_jax(reduced):
    params, (jloss, jstats, jgrads), _, _ = reduced
    speech, slen, text, tlen = _batch()
    masked = jax_deterministic_mask(tlen, text.shape[1])
    model = _port(params).train()
    loss, stats = model(_t(speech), _t(slen), _t(text), _t(tlen),
                        masked=_t(masked))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    assert set(stats) == set(jstats) == {"loss_ctc", "loss_mlm", "acc_mlm",
                                         "loss"}
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()),
                                   float(jstats[k]), rtol=LOSS_TOL,
                                   atol=1e-7, err_msg=k)
    want = jax_params_to_state_dict(jgrads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def test_encoder_output_and_inference_ids_match_jax(reduced):
    params, _, (jenc, jelen), jids = reduced
    speech, slen, _, _ = _batch()
    model = _port(params).eval()
    with torch.no_grad():
        enc, elen = model.encode(_t(speech), _t(slen))
    np.testing.assert_array_equal(elen.numpy(), np.asarray(jelen))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), rtol=ENC_TOL,
                               atol=ENC_TOL)
    infer = tmc.MaskCTCInference(model, device="cpu", n_iterations=3,
                                 threshold_probability=0.99)
    ids = infer(speech, slen)
    assert ids == jids
    assert sum(len(x) for x in ids) > 3  # the infilling rounds ran


def test_mask_draw_masks_valid_positions_at_least_one_each():
    lens = torch.tensor([7, 1, 0, 4])
    for seed in range(20):
        m = tmc.draw_mask(torch.Generator().manual_seed(seed), lens, 9)
        valid = torch.arange(9)[None, :] < lens[:, None]
        assert not (m & ~valid).any()
        assert (m.sum(1) >= (lens > 0).long()).all()
    a = tmc.draw_mask(torch.Generator().manual_seed(3), lens, 9)
    b = tmc.draw_mask(torch.Generator().manual_seed(3), lens, 9)
    assert torch.equal(a, b)


def test_training_draws_the_mask_from_the_generator(reduced):
    params, _, _, _ = reduced
    model = _port(params).train()
    batch = [_t(a) for a in _batch()]
    runs = [model(*batch, generator=torch.Generator().manual_seed(s))[1]
            for s in (5, 5, 6)]
    assert float(runs[0]["loss_mlm"].detach()) == float(
        runs[1]["loss_mlm"].detach())
    assert float(runs[0]["loss_ctc"].detach()) == float(
        runs[2]["loss_ctc"].detach())


def test_config_section_and_full_width_model():
    jf = {f.name: f.default for f in dataclasses.fields(JSection)}
    tf = {f.name: f.default for f in dataclasses.fields(MaskCTCModelSection)}
    assert set(jf) == set(tf)
    assert all(tf[k] == jf[k] for k in jf if k != "dtype")
    model = tmc.MaskCTCModel(maskctc_conformer(torch.float32))
    assert sum(p.numel() for p in model.parameters()) == FULL_WIDTH_PARAMS
    assert model.decoder.out_proj.out_features == 5001  # + <mask>
    built = MaskCTCTask.build_model(MaskCTCModelSection(
        **{k: v for k, v in REDUCED.items() if k != "vocab_size"},
        dtype="bfloat16"), 20)
    assert built.config.dtype == torch.bfloat16
    assert built.config.mask_token == 20
    with pytest.raises(ValueError, match="encoder_type"):
        tmc.MaskCTCModel(tmc.MaskCTCConfig(**dict(
            REDUCED, encoder_type="e_branchformer")))


def test_global_mvn_stats_are_dropped(reduced):
    """With normalize global_mvn the JAX CLI passes the stats; the model has
    no place for them and reads none, so the converter drops them."""
    params, _, _, _ = reduced
    mvn = {"mvn": {"mean": np.ones(16, np.float32),
                   "inv_std": np.ones(16, np.float32)}}
    cfg = tmc.MaskCTCConfig(**dict(REDUCED, normalize="global_mvn"))
    model = load_jax_params(tmc.MaskCTCModel(cfg),
                            {"params": params, "mvn": mvn})
    assert not any(k.startswith("mvn") for k in model.state_dict())
