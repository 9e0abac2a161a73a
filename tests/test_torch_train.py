"""The port's training slice against the JAX package, float32 on the CPU:
SpecAug with JAX's random draws injected, FastDropout's keep rule, the
label-smoothing loss, the schedules, the flat Adam update (clip and
NaN-skip), and the whole bench-style model at a reduced geometry: the same
loss and every parameter gradient as `jax.value_and_grad`, then one train
step of each framework giving the same parameters."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from __graft_entry__ import _flagship_config
from espnet_tpu.models.asr import ASRModel as JASRModel
from espnet_tpu.ops import losses as jlosses
from espnet_tpu.ops import specaug as jspec
from espnet_tpu.train import optim as joptim
from espnet_tpu.train import schedulers as jsched
from espnet_tpu.train.steps import TrainState as JTrainState
from espnet_tpu.train.steps import make_train_step as jmake_train_step
from espnet_tpu_torch.convert import (jax_params_to_state_dict,
                                      load_jax_params, torch_to_jax_tree)
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel
from espnet_tpu_torch.ops import dropout as tdrop
from espnet_tpu_torch.ops import losses as tlosses
from espnet_tpu_torch.ops import specaug as tspec
from espnet_tpu_torch.train import optim as toptim
from espnet_tpu_torch.train import schedulers as tsched
from espnet_tpu_torch.train.steps import (TrainState, make_eval_step,
                                          make_train_step)


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

# float32 elementwise math in the same order: interpolation weights and
# log-softmax sums over <= 64 classes
OP_TOL = 1e-5
# the whole model: 2 + 2 layers, a log-mel frontend and two losses, summed
# in another order; gradients through one more (backward) pass
LOSS_TOL = 1e-4
GRAD_TOL = 5e-4


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- SpecAug

def _jax_draws(key, b, window=5, nf=2, fw=(0, 20), nt=2, tw=(0, 40)):
    """The draws `espnet_tpu.ops.specaug.specaug` makes from `key`, in the
    port's parameter layout."""
    key, sub = jax.random.split(key)
    kc, kw = jax.random.split(sub)
    warp = (jax.random.uniform(kc, (b,)),
            jax.random.randint(kw, (b,), -window, window + 1))
    masks = []
    for n, width in ((nf, fw), (nt, tw)):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        masks.append((jax.random.randint(k1, (b, n), width[0], width[1]),
                      jax.random.uniform(k2, (b, n))))
    return {"time_warp": tuple(map(_t, warp)),
            "freq": tuple(map(_t, masks[0])),
            "time": tuple(map(_t, masks[1]))}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_specaug_with_injected_draws_matches_jax(seed):
    """Lengths: full, a short one where the adaptive width cap binds, and
    one of 12 frames (<= 2*5+2: the warp is the identity)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 90, 24).astype(np.float32)
    lens = np.array([90, 30, 12], np.int32)
    key = jax.random.PRNGKey(seed)
    want = jspec.specaug(key, jnp.asarray(x), jnp.asarray(lens),
                         time_mask_width=(0, 40))
    got = tspec.specaug_apply(_t(x), _t(lens), _jax_draws(key, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_TOL,
                               rtol=OP_TOL)


def test_specaug_parts_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 50, 16).astype(np.float32)
    lens = np.array([50, 20], np.int32)
    key = jax.random.PRNGKey(7)
    kc, kw = jax.random.split(key)
    u, shift = jax.random.uniform(kc, (2,)), jax.random.randint(
        kw, (2,), -5, 6)
    np.testing.assert_allclose(
        tspec.time_warp(_t(x), _t(lens), _t(u), _t(shift)).numpy(),
        np.asarray(jax.jit(jspec.time_warp)(key, jnp.asarray(x),
                                            jnp.asarray(lens))),
        atol=OP_TOL, rtol=OP_TOL)
    for axis, width in ((1, (0, 40)), (2, (0, 20))):
        k1, k2 = jax.random.split(key)
        w = jax.random.randint(k1, (2, 2), width[0], width[1])
        uu = jax.random.uniform(k2, (2, 2))
        np.testing.assert_array_equal(
            tspec.mask_along_axis(_t(x), _t(lens), axis, _t(w), _t(uu)).numpy(),
            np.asarray(jax.jit(jspec._mask_along_axis, static_argnums=(
                3, 4, 5))(key, jnp.asarray(x), jnp.asarray(lens), axis, 2,
                          width)))


def test_specaug_draws_follow_the_generator():
    x = torch.randn(2, 60, 10)
    lens = torch.tensor([60, 40])
    a = tspec.specaug(torch.Generator().manual_seed(1), x, lens)
    b = tspec.specaug(torch.Generator().manual_seed(1), x, lens)
    c = tspec.specaug(torch.Generator().manual_seed(2), x, lens)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


# ---------------------------------------------------------------- dropout

def test_fast_dropout_keep_rate_scale_and_backward():
    x = torch.ones(400, 500, requires_grad=True)
    y = tdrop.fast_dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    q = tdrop.quantize_rate(0.1)
    assert q == 26
    assert abs(float(kept.float().mean()) - (1 - q / 256)) < 0.005
    np.testing.assert_allclose(y[kept].detach().numpy(), 256 / (256 - q),
                               rtol=1e-7)
    y.backward(torch.full_like(y, 3.0))
    # the backward regenerates the forward's mask from its seed
    torch.testing.assert_close(x.grad, 3.0 * y.detach(), rtol=0, atol=0)
    assert tdrop.fast_dropout(x, 0.0, torch.Generator()) is x
    assert float(tdrop.fast_dropout(x, 1.0, torch.Generator()).abs().sum()) == 0
    module = tdrop.FastDropout(0.1)
    g = torch.Generator().manual_seed(0)
    assert not torch.equal(module(x, g), x)
    module.eval()
    assert module(x, g) is x


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("normalize_length", [False, True])
@pytest.mark.parametrize("smoothing", [0.1, 0.0])
def test_label_smoothing_loss_and_accuracy_match_jax(normalize_length,
                                                     smoothing):
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 7, 64).astype(np.float32)
    targets = rng.randint(0, 64, (3, 7)).astype(np.int32)
    valid = np.arange(7)[None] < np.array([7, 4, 1])[:, None]
    targets[0, :3] = logits[0, :3].argmax(-1)  # some right answers
    jargs = tuple(map(jnp.asarray, (logits, targets, valid)))
    want = jlosses.label_smoothing_loss(*jargs, smoothing, normalize_length)
    got = tlosses.label_smoothing_loss(_t(logits), _t(targets), _t(valid),
                                       smoothing, normalize_length)
    np.testing.assert_allclose(float(got), float(want), rtol=OP_TOL)
    np.testing.assert_allclose(
        float(tlosses.token_accuracy(_t(logits), _t(targets), _t(valid))),
        float(jlosses.token_accuracy(*jargs)), rtol=1e-7)


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("name", ["noam", "warmuplr", "constant",
                                  "exponential"])
def test_schedules_match_jax(name):
    kw = dict(warmup_steps=100, d_model=256)
    jfn = jsched.build_schedule(name, 2e-3, **kw)
    tfn = tsched.build_schedule(name, 2e-3, **kw)
    for step in (0, 1, 7, 100, 101, 5000):
        np.testing.assert_allclose(
            float(tfn(torch.tensor(step, dtype=torch.int32))),
            float(jfn(jnp.asarray(step, jnp.int32))), rtol=1e-6)


# ---------------------------------------------------------------- FlatAdam

class _Linear(fnn.Module):
    """loss = sum(w * speech): the gradient is the batch's `speech`."""

    @fnn.compact
    def __call__(self, speech, speech_lengths, text, text_lengths,
                 deterministic=True):
        w = self.param("w", lambda k, s: jnp.linspace(-1.0, 1.0, s[0]),
                       speech.shape)
        loss = jnp.sum(w * speech)
        return loss, {"loss": loss}


def test_flat_adam_clip_and_nan_skip_match_jax():
    n = 64
    rng = np.random.RandomState(5)
    grads = [rng.randn(n).astype(np.float32) * s for s in (10.0, 0.1, 1.0)]
    grads.insert(2, np.full(n, np.nan, np.float32))  # the third step skips
    kw = dict(lr=3e-2, schedule="warmuplr", warmup_steps=3, grad_clip=5.0)
    jtx = joptim.build_optimizer("fused_adam", **kw)
    ttx = toptim.build_optimizer("fused_adam", **kw)
    model = _Linear()
    dummy = {"speech": jnp.asarray(grads[0]), "speech_lengths": jnp.zeros(1),
             "text": jnp.zeros(1), "text_lengths": jnp.zeros(1)}
    params = model.init(jax.random.PRNGKey(0), *dummy.values())["params"]
    flat, unravel = ravel_pytree(params)
    jstate = JTrainState.create(flat, jtx, {})
    jstep = jmake_train_step(model, jtx, rng_names=("dropout",),
                             donate=False, unravel=unravel)
    tparams = _t(flat)
    tstate = ttx.init(tparams)
    # float32 vector math in one order (XLA may fuse the multiply-adds)
    tol = dict(rtol=1e-5, atol=1e-8)
    for g in grads:
        jstate, jstats = jstep(jstate, dict(dummy, speech=jnp.asarray(g)),
                               jax.random.PRNGKey(1))
        gnorm, skipped = ttx.apply_(tparams, _t(g), tstate)
        np.testing.assert_allclose(tparams.numpy(), np.asarray(jstate.params),
                                   **tol)
        for k in ("mu", "nu"):
            np.testing.assert_allclose(tstate[k].numpy(),
                                       np.asarray(jstate.opt_state[k]), **tol)
        assert int(tstate["count"]) == int(jstate.opt_state["count"])
        assert float(skipped) == float(jstats["skipped"])
        if np.isfinite(float(jstats["grad_norm"])):
            np.testing.assert_allclose(float(gnorm),
                                       float(jstats["grad_norm"]), rtol=1e-6)
    assert int(tstate["count"]) == 3


def test_build_optimizer_takes_fused_adam_only():
    """Every name of the JAX build_optimizer builds a flat optimizer (the
    port's train step takes no other); an unknown name raises as in JAX."""
    for name in ("fused_adam", "adam", "adamw", "sgd", "adadelta"):
        assert isinstance(toptim.build_optimizer(name), toptim.FlatOptimizer)
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.build_optimizer("lamb")


# ---------------------------------------------------------------- the slice

def _slice_configs():
    kw = dict(vocab_size=64, d_model=64, num_heads=2, d_ff=128,
              num_encoder_layers=2, num_decoder_layers=2, decoder_d_ff=128,
              conformer_kernel_size=7, ctc_weight=0.3, lsm_weight=0.1,
              dropout_rate=0.0, use_specaug=False, normalize="utterance_mvn")
    jcfg = _flagship_config(vocab=64, **{k: v for k, v in kw.items()
                                         if k != "vocab_size"})
    return jcfg, ASRConfig(**kw)


def _batch():
    rng = np.random.RandomState(0)
    lens = np.array([8000, 6500, 4000], np.int32)
    speech = (0.1 * rng.randn(3, 8000)).astype(np.float32)
    speech[np.arange(8000)[None] >= lens[:, None]] = 0.0
    text = rng.randint(1, 63, (3, 5)).astype(np.int32)
    tlens = np.array([5, 3, 4], np.int32)
    text[np.arange(5)[None] >= tlens[:, None]] = 0
    return {"speech": speech, "speech_lengths": lens, "text": text,
            "text_lengths": tlens}


@pytest.fixture(scope="module")
def slice_setup():
    jcfg, tcfg = _slice_configs()
    batch = _batch()
    jm = JASRModel(jcfg)
    jb = tuple(jnp.asarray(batch[k]) for k in
               ("speech", "speech_lengths", "text", "text_lengths"))
    v = fnn.meta.unbox(jax.jit(jm.init, static_argnums=(5,))(
        jax.random.PRNGKey(0), *jb, True))
    rng = np.random.RandomState(1)  # exercise zero-initialised leaves too
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a)
        + 0.05 * rng.randn(*a.shape).astype(np.float32), v["params"])
    return jm, params, jb, tcfg, batch


def test_slice_loss_and_every_gradient_match_jax(slice_setup):
    jm, params, jb, tcfg, batch = slice_setup

    def loss_fn(p):
        return jm.apply({"params": p}, *jb, True)

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    tm = load_jax_params(ASRModel(tcfg), params).train()
    tloss, tstats = tm(*(_t(batch[k]) for k in
                         ("speech", "speech_lengths", "text",
                          "text_lengths")))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    for k in ("loss_ctc", "loss_att", "acc", "ctc_infeasible"):
        np.testing.assert_allclose(float(tstats[k].detach()),
                                   float(jstats[k]),
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    want = jax_params_to_state_dict(jgrads)
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def test_slice_train_step_gives_the_same_parameters(slice_setup):
    """One step of each framework's train step with its fused Adam. eps is
    raised to 1e-3 in both: at the first step Adam moves each parameter by
    lr * g / (|g| + eps), and with eps = 1e-9 a gradient that is zero up to
    rounding (the key projection's bias: softmax ignores it) would move by
    +-lr depending on the sign of its rounding noise."""
    jm, params, jb, tcfg, batch = slice_setup
    kw = dict(lr=2e-3, schedule="warmuplr", warmup_steps=10, eps=1e-3,
              grad_clip=5.0)
    jtx = joptim.build_optimizer("fused_adam", **kw)
    flat, unravel = ravel_pytree(params)
    jstep = jmake_train_step(jm, jtx, donate=False, unravel=unravel)
    jstate, jstats = jstep(JTrainState.create(flat, jtx, {}),
                           dict(zip(("speech", "speech_lengths", "text",
                                     "text_lengths"), jb)),
                           jax.random.PRNGKey(0))
    tm = load_jax_params(ASRModel(tcfg), params)
    ttx = toptim.build_optimizer("fused_adam", **kw)
    step = make_train_step(tm, ttx, device="cpu")
    state = TrainState.create(tm, ttx)
    state, tstats = step(state, batch, torch.Generator().manual_seed(0))
    assert state.step == 1 and float(tstats["skipped"]) == 0.0
    np.testing.assert_allclose(float(tstats["loss"]), float(jstats["loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(tstats["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=LOSS_TOL)
    got = torch_to_jax_tree(dict(tm.named_parameters()), params)
    want = unravel(jstate.params)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                                atol=2e-6), got, want)
    moved = np.abs(ravel_pytree(got)[0] - flat).max()
    assert moved > 1e-4  # the step did move the parameters
    stats = make_eval_step(tm, device="cpu")(state, batch)
    assert np.isfinite(float(stats["loss"]))


def test_slice_accumulation_averages_micro_batches(slice_setup):
    """accum_steps=3 on 3 utterances: the mean of three one-utterance
    gradients, as the JAX micro-batch scan computes it."""
    jm, params, jb, tcfg, batch = slice_setup
    kw = dict(lr=2e-3, schedule="warmuplr", warmup_steps=10, eps=1e-3)
    jtx = joptim.build_optimizer("fused_adam", **kw)
    flat, unravel = ravel_pytree(params)
    jstep = jmake_train_step(jm, jtx, donate=False, unravel=unravel,
                             accum_steps=3)
    _, jstats = jstep(JTrainState.create(flat, jtx, {}),
                      dict(zip(("speech", "speech_lengths", "text",
                                "text_lengths"), jb)), jax.random.PRNGKey(0))
    tm = load_jax_params(ASRModel(tcfg), params)
    ttx = toptim.build_optimizer("fused_adam", **kw)
    step = make_train_step(tm, ttx, device="cpu", accum_steps=3)
    _, tstats = step(TrainState.create(tm, ttx), batch, torch.Generator())
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tstats[k].detach()),
                                   float(jstats[k]),
                                   rtol=LOSS_TOL, err_msg=k)


def test_training_needs_a_generator_when_it_is_random():
    _, tcfg = _slice_configs()
    import dataclasses

    tm = ASRModel(dataclasses.replace(tcfg, dropout_rate=0.1)).train()
    b = _batch()
    with pytest.raises(ValueError, match="Generator"):
        tm(*(_t(b[k]) for k in ("speech", "speech_lengths", "text",
                                "text_lengths")))
