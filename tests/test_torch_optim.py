"""The port's optimizers against the JAX package's `build_optimizer` chains.

A 1,000-element float32 parameter vector takes 6 steps of the JAX train step
(optax chain, the step-level NaN-skip) and of the port's flat optimizer,
with warmuplr. The gradients are given: the model's loss is sum(w * speech),
so its gradient is the batch's `speech`. One step's gradient norm is above
the clip, and one step's gradient holds a NaN, which both skip.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.train import optim as joptim
from espnet_tpu.train.steps import TrainState as JTrainState
from espnet_tpu.train.steps import make_train_step as jmake_train_step
from espnet_tpu_torch.train import optim as toptim


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

N = 1000
RTOL, ATOL = 1e-6, 1e-7
CLIP = 5.0


class _Linear(fnn.Module):
    @fnn.compact
    def __call__(self, speech, speech_lengths, text, text_lengths,
                 deterministic=True):
        w = self.param("w", lambda k, s: jnp.linspace(-1.0, 1.0, s[0]),
                       speech.shape)
        loss = jnp.sum(w * speech)
        return loss, {"loss": loss}


def _grads():
    rng = np.random.RandomState(3)
    scales = (0.01, 1.0, 0.05, None, 0.02, 0.03)  # the second is clipped
    out = []
    for s in scales:
        if s is None:
            g = rng.randn(N).astype(np.float32)
            g[17] = np.nan
        else:
            g = (s * rng.randn(N)).astype(np.float32)
        out.append(g)
    assert np.linalg.norm(out[1]) > CLIP
    assert all(np.linalg.norm(g) < CLIP for g in out[2:3] + out[4:])
    return out


@pytest.mark.parametrize("name, kw", [
    ("adam", {}),
    ("adamw", {"weight_decay": 1e-2}),
    ("sgd", {}),
    ("adadelta", {}),
], ids=["adam", "adamw", "sgd", "adadelta"])
def test_optimizer_matches_the_jax_chain(name, kw):
    kw = dict(lr=2e-2, schedule="warmuplr", warmup_steps=4, grad_clip=CLIP,
              **kw)
    jtx = joptim.build_optimizer(name, **kw)
    ttx = toptim.build_optimizer(name, **kw)
    assert isinstance(ttx, toptim.FlatOptimizer)
    grads = _grads()
    model = _Linear()
    dummy = {"speech": jnp.asarray(grads[0]), "speech_lengths": jnp.zeros(1),
             "text": jnp.zeros(1), "text_lengths": jnp.zeros(1)}
    params = model.init(jax.random.PRNGKey(0), *dummy.values())["params"]
    jstate = JTrainState.create(params, jtx, {})
    jstep = jmake_train_step(model, jtx, rng_names=("dropout",),
                             donate=False)
    tparams = torch.from_numpy(np.array(params["w"]))
    tstate = ttx.init(tparams)
    for i, g in enumerate(grads):
        jstate, jstats = jstep(jstate, dict(dummy, speech=jnp.asarray(g)),
                               jax.random.PRNGKey(1))
        gnorm, skipped = ttx.apply_(tparams, torch.from_numpy(g), tstate)
        np.testing.assert_allclose(
            tparams.numpy(), np.asarray(jstate.params["w"]), rtol=RTOL,
            atol=ATOL, err_msg=f"{name}, step {i + 1}")
        assert float(skipped) == float(jstats["skipped"]) == float(i == 3)
        if i != 3:
            np.testing.assert_allclose(float(gnorm),
                                       float(jstats["grad_norm"]), rtol=RTOL)
    assert int(tstate["count"]) == 5
    moved = np.abs(tparams.numpy() - np.linspace(-1.0, 1.0, N)).max()
    assert moved > 1e-4  # adadelta's steps are the smallest, ~3e-4

