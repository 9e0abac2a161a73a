"""CTC from log-probabilities (`ops/ctc.py` `ctc_loss_from_log_probs`) and
the port's multi-speaker ASR (`models/asr_mix.py`) against the JAX
package's, float32 on the CPU.

The loss: ragged input and label lengths, repeated labels, an empty label
sequence and an infeasible utterance (loss 0, gradient 0), with a non-unit
upstream gradient. The model: a reduced mixture model (one shared and one
branch conformer layer a speaker at d_model 64, a one-layer decoder, vocab
20, SpecAug and dropout off) with parameters carried over from JAX, its
transcripts in the collate's (B, U, S) layout: the loss, its stats and
every gradient; then the same with the two speaker branches given equal
parameters, so that both permutations tie for every utterance and only
the first-minimum rule of `jnp.argmin` decides which transcript each branch
is trained on; and greedy CTC on every branch.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models import asr_mix as jmix
from espnet_tpu.ops.ctc import ctc_loss_from_log_probs as jctc
from espnet_tpu.tasks.asr_mix import ASRMixModelSection as JSection
from espnet_tpu_torch.bin.asr_mix_inference import (best_permutation_errors,
                                                    greedy_paths)
from espnet_tpu_torch.configs import asr_mix_conformer
from espnet_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from espnet_tpu_torch.models import asr_mix as tmix
from espnet_tpu_torch.ops.ctc import ctc_loss_from_log_probs
from espnet_tpu_torch.tasks.asr_mix import ASRMixModelSection, ASRMixTask

FULL_WIDTH_PARAMS = 28_921_104
# the CTC lattice in float32 over 40 frames
CTC_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 5e-4

REDUCED = dict(vocab_size=20, n_mels=16, use_specaug=False, d_model=64,
               num_heads=4, d_ff=128, num_shared_layers=1,
               num_branch_layers=1, conformer_kernel_size=5,
               num_decoder_layers=1, decoder_d_ff=128, dropout_rate=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_ctc_from_log_probs_loss_and_gradient_match_jax():
    rng = np.random.RandomState(0)
    b, t, v, u = 5, 40, 12, 8
    logits = rng.randn(b, t, v).astype(np.float32)
    log_probs = np.asarray(jax.nn.log_softmax(logits, -1))
    labels = rng.randint(1, v, (b, u)).astype(np.int32)
    labels[1, 2] = labels[1, 1]  # a repeat needs a blank between
    input_lengths = np.array([40, 33, 20, 3, 17], np.int32)
    # utterance 3: 5 labels in 3 frames, infeasible; utterance 4: empty
    label_lengths = np.array([8, 6, 4, 5, 0], np.int32)
    g = np.array([1.0, 0.5, 2.0, 1.0, 1.5], np.float32)

    def f(lp):
        return jnp.sum(jctc(lp, jnp.asarray(labels),
                            jnp.asarray(input_lengths),
                            jnp.asarray(label_lengths)) * g)

    jloss = jax.jit(jctc)(jnp.asarray(log_probs), jnp.asarray(labels),
                          jnp.asarray(input_lengths),
                          jnp.asarray(label_lengths))
    jgrad = jax.jit(jax.grad(f))(jnp.asarray(log_probs))
    lp = _t(log_probs).requires_grad_(True)
    loss = ctc_loss_from_log_probs(lp, _t(labels), _t(input_lengths),
                                   _t(label_lengths))
    (loss * _t(g)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               rtol=CTC_TOL, atol=CTC_TOL)
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(jgrad),
                               rtol=CTC_TOL, atol=CTC_TOL)
    assert float(loss[3].detach()) == 0.0
    assert float(lp.grad[3].abs().max()) == 0.0
    assert float(lp.grad[1, 33:].abs().max()) == 0.0  # past its length
    # no softmax term: the gradient is minus the occupancy, which sums to
    # -1 a frame within the length (float32 exponentials of log-space sums
    # near 1e2: a few ulps each)
    np.testing.assert_allclose(lp.grad[0].sum(-1).numpy(), -1.0, atol=1e-4)


def _batch():
    rng = np.random.RandomState(0)
    slen = np.array([8000, 6400, 4800], np.int32)
    speech = np.zeros((3, 8000), np.float32)
    for i, n in enumerate(slen):
        speech[i, :n] = 0.1 * rng.randn(n)
    # (B, U, S): the collate's layout
    text = rng.randint(1, 19, (3, 5, 2)).astype(np.int32)
    tlen = np.array([[5, 3], [2, 4], [1, 3]], np.int32)
    for s in range(2):
        text[np.arange(5)[None, :] >= tlen[:, s:s + 1], s] = 0
    return speech, slen, text, tlen


def _tied(params):
    """The speaker-1 branch with speaker 0's parameters."""
    p = dict(params)
    enc = dict(p["encoder"])
    enc["spk1_layer0"] = enc["spk0_layer0"]
    p["encoder"] = enc
    return p


@pytest.fixture(scope="module")
def reduced():
    jm = jmix.ASRMixModel(jmix.ASRMixConfig(**REDUCED))
    batch = tuple(jnp.asarray(a) for a in _batch())
    v = fnn.meta.unbox(jax.jit(jm.init, static_argnums=(5,))(
        jax.random.PRNGKey(0), *batch, True))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a)
        + 0.05 * rng.randn(*a.shape).astype(np.float32), v["params"])
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, *batch, True), has_aux=True))

    @jax.jit
    def greedy(p):
        enc, elens = jm.apply({"params": p}, batch[0], batch[1],
                              method=jmix.ASRMixModel.encode)
        b, s, t, _ = enc.shape
        lp = jm.apply({"params": p}, enc.reshape(b * s, t, -1),
                      method=jmix.ASRMixModel.ctc_log_probs)
        return jnp.argmax(lp, -1).reshape(b, s, t), elens

    return {name: (p, grad_fn(p), greedy(p))
            for name, p in (("distinct", params), ("tied", _tied(params)))}


@pytest.mark.parametrize("case", ["distinct", "tied"])
def test_loss_stats_and_every_gradient_match_jax(reduced, case):
    params, ((jloss, jstats), jgrads), _ = reduced[case]
    model = load_jax_params(tmix.ASRMixModel(tmix.ASRMixConfig(**REDUCED)),
                            params).train()
    loss, stats = model(*(_t(a) for a in _batch()))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    assert set(stats) == set(jstats) == {"loss_ctc", "loss_att", "acc",
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
    if case == "tied":
        # the tie goes to the identity permutation: the branches are
        # trained on different transcripts, so their gradients differ
        a = got["encoder.spk0_layer0.ff1.w1.weight"]
        b = got["encoder.spk1_layer0.ff1.w1.weight"]
        assert not torch.allclose(a, b)


def test_greedy_paths_match_jax(reduced):
    params, _, (jpaths, jelens) = reduced["distinct"]
    model = load_jax_params(tmix.ASRMixModel(tmix.ASRMixConfig(**REDUCED)),
                            params).eval()
    speech, slen, _, _ = _batch()
    paths, elens = greedy_paths(model, _t(speech), _t(slen))
    np.testing.assert_array_equal(elens, np.asarray(jelens))
    np.testing.assert_array_equal(paths, np.asarray(jpaths))


def test_best_permutation_errors():
    refs = [["a", "b"], ["c"]]
    assert best_permutation_errors(refs, [["c"], ["a", "b"]]) == 0
    assert best_permutation_errors(refs, [["a"], ["c"]]) == 1


def test_config_section_and_full_width_model():
    jf = {f.name: f.default for f in dataclasses.fields(JSection)}
    tf = {f.name: f.default for f in dataclasses.fields(ASRMixModelSection)}
    assert set(jf) == set(tf)
    assert all(tf[k] == jf[k] for k in jf if k != "dtype")
    model = tmix.ASRMixModel(asr_mix_conformer(torch.float32))
    assert sum(p.numel() for p in model.parameters()) == FULL_WIDTH_PARAMS
    built = ASRMixTask.build_model(ASRMixModelSection(
        **{k: v for k, v in REDUCED.items() if k != "vocab_size"},
        dtype="bfloat16", num_spk=3), 20)
    assert built.config.dtype == torch.bfloat16
    assert hasattr(built.encoder, "spk2_layer0")
