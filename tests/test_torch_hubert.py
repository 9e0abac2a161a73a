"""The port's HuBERT pretraining (`models/hubert.py`, `ops/kmeans.py`,
`tasks/hubert.py`, `bin/hubert_train.py`) against the JAX package's,
float32 on the CPU.

A reduced HubertModel (2 layers of d_model 16, 8 classes, dropout off;
drawn by the port's initialiser in JAX's layout and perturbed) with the
span starts that JAX draws from its mask key injected into the port: the
loss, its stats and every gradient. The dilation of span starts into
spans against the JAX model's own `_span_mask`. k-means on the same
frames gives JAX's centroids; and `bin.hubert_train` on a synthetic corpus
writes `km_centroids.npy` within 1e-5 of what the JAX task's label stage
writes on it, the same frame labels, and a checkpoint after one epoch.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models import hubert as jhubert
from espnet_tpu.ops import kmeans as jkmeans
from espnet_tpu.tasks.hubert import HubertTask as JHubertTask
from espnet_tpu_torch.convert import (jax_params_to_state_dict,
                                      load_jax_params,
                                      state_dict_to_jax_params)
from espnet_tpu_torch.models import hubert as thubert
from espnet_tpu_torch.models.asr import init_random_
from espnet_tpu_torch.ops import kmeans as tkmeans

LOSS_TOL = 1e-5
GRAD_TOL = 5e-4
GRAD_FLOOR = 1e-3
KMEANS_TOL = 1e-5

CFG = dict(num_classes=8, input_type="raw", n_fft=256, hop_length=128,
           n_mels=12, d_model=16, num_heads=2, d_ff=32, num_encoder_layers=2,
           dropout_rate=0.0, mask_prob=0.2, mask_length=3,
           pred_masked_weight=1.0, pred_nomask_weight=0.5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.RandomState(0)
    n = 8000
    speech = np.zeros((3, n), np.float32)
    lens = np.array([8000, 5000, 2600], np.int32)
    for i, k in enumerate(lens):
        speech[i, :k] = 0.3 * rng.randn(k)
    labels = rng.randint(0, CFG["num_classes"], (3, 70)).astype(np.int32)
    return speech, lens, labels


def _starts(key, valid_shape):
    """The span starts JAX's `_span_mask` draws from `key`."""
    return np.array(jax.random.uniform(key, valid_shape)
                    < CFG["mask_prob"])


@pytest.fixture(scope="module")
def reduced():
    speech, lens, labels = _batch()
    jm = jhubert.HubertModel(jhubert.HubertConfig(**CFG))
    model = thubert.HubertModel(thubert.HubertConfig(**CFG))
    init_random_(model, torch.Generator().manual_seed(0))
    prng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * prng.randn(*a.shape).astype(np.float32),
        state_dict_to_jax_params(model.state_dict()))
    jb = tuple(map(jnp.asarray, (speech, lens, labels)))
    # deterministic (dropout is off): the JAX model draws its span starts
    # from PRNGKey(0) itself, which the test repeats for the port
    key = jax.random.PRNGKey(0)
    want = jax.eval_shape(lambda: fnn.meta.unbox(jm.init(key, *jb))[
        "params"])
    assert jax.tree_util.tree_map(lambda a: a.shape, want) == \
        jax.tree_util.tree_map(lambda a: a.shape, params)
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, *jb), has_aux=True))(params)
    return jm, params, key, (jloss, jstats, jgrads)


def test_hubert_loss_stats_and_every_gradient_match_jax(reduced):
    _, params, key, (jloss, jstats, jgrads) = reduced
    speech, lens, labels = (torch.from_numpy(a) for a in _batch())
    model = load_jax_params(thubert.HubertModel(thubert.HubertConfig(**CFG)),
                            params).train()
    frames = int(lens.max()) // CFG["hop_length"] + 1
    starts = torch.from_numpy(_starts(key, (3, frames)))
    loss, stats = model(speech, lens, labels, generator=None,
                        starts=starts)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    assert set(stats) == set(jstats)
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    assert 0.0 < float(stats["mask_ratio"]) < 1.0
    want = jax_params_to_state_dict(jgrads)
    total = float(torch.sqrt(sum((w.double() ** 2).sum()
                                 for w in want.values())))
    for name, p in model.named_parameters():
        w = want[name].double()
        err = float((p.grad.double() - w).norm()) / max(float(w.norm()),
                                                        GRAD_FLOOR * total)
        assert err <= GRAD_TOL, (name, err)


def test_span_dilation_matches_jax(reduced):
    jm, params, _, _ = reduced
    model = thubert.HubertModel(thubert.HubertConfig(**CFG))
    valid = np.arange(40)[None, :] < np.array([40, 31, 7])[:, None]
    for k in range(3):
        key = jax.random.PRNGKey(10 + k)
        want = jm.apply({"params": params}, key, valid.shape,
                        jnp.asarray(valid),
                        method=jhubert.HubertModel._span_mask)
        got = model.span_mask(torch.from_numpy(valid),
                              starts=torch.from_numpy(
                                  _starts(key, valid.shape)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a start at t covers t .. t + mask_length - 1, clipped at the end
    starts = torch.zeros(1, 8, dtype=torch.bool)
    starts[0, [1, 6]] = True
    assert thubert.dilate_spans(starts, 3)[0].tolist() == [
        False, True, True, True, False, False, True, True]
    # eval draws from a generator seeded 0: the same mask every call
    valid_t = torch.from_numpy(valid)
    model.eval()
    assert torch.equal(model.span_mask(valid_t), model.span_mask(valid_t))


def test_kmeans_fit_and_assign_equal_jax():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(150, 5) + 4, rng.randn(150, 5) - 4,
                        rng.randn(100, 5) * 3]).astype(np.float32)
    c = tkmeans.kmeans_fit(x, 6, n_iter=5, seed=3)
    np.testing.assert_array_equal(c, jkmeans.kmeans_fit(x, 6, n_iter=5,
                                                        seed=3))
    np.testing.assert_array_equal(tkmeans.kmeans_assign(x, c),
                                  jkmeans.kmeans_assign(x, c))


def test_hubert_train_cli_labels_and_checkpoint(tmp_path):
    """bin.hubert_train for one epoch: the k-means stage on the port's
    log-mel gives the centroids (within 1e-5) and frame labels of the JAX
    task's stage on JAX's log-mel, then a checkpoint."""
    from espnet_tpu.data.synth import generate_corpus
    from espnet_tpu_torch.bin import hubert_train
    from espnet_tpu_torch.tasks.hubert import HubertTask

    generate_corpus(tmp_path / "data", n_utts=6, min_words=2, max_words=3)
    argv = ["--run.output_dir", str(tmp_path / "exp"),
            "--run.max_epoch", "1", "--run.log_interval", "1000",
            "--run.best_metric", "train.loss.min",
            "--data.train_dir", str(tmp_path / "data"),
            "--data.batch_size", "3", "--data.kmeans_iters", "3",
            "--data.kmeans_sample_frames", "2000",
            "--model.num_classes", "8", "--model.n_fft", "256",
            "--model.n_mels", "12", "--model.d_model", "16",
            "--model.num_heads", "2", "--model.d_ff", "32",
            "--model.num_encoder_layers", "1", "--model.dropout_rate", "0.0",
            "--optim.schedule", "constant", "--optim.lr", "0.002",
            "--device", "cpu"]
    state, trainer, model = hubert_train.main(argv)
    exp = tmp_path / "exp"
    assert (exp / "checkpoint.pt").exists()
    assert (exp / "ep1.params.msgpack").exists()
    assert len(trainer.epoch_seconds) == 1
    cfg = HubertTask.load_config(exp)
    jcfg = JHubertTask.parse_config([a for a in argv[:-2]])
    jdir = tmp_path / "jax"
    jdir.mkdir()
    JHubertTask.generate_labels(jcfg["data"], jcfg["model"],
                                tmp_path / "data", jdir)
    got = np.load(exp / "km_centroids.npy")
    want = np.load(jdir / "km_centroids.npy")
    assert got.shape == want.shape == (8, 12)
    np.testing.assert_allclose(got, want, atol=KMEANS_TOL, rtol=0)
    keys = sorted(p.stem for p in (jdir / "labels").glob("*.npy"))
    assert len(keys) == 6 and keys == sorted(
        p.stem for p in (exp / "labels").glob("*.npy"))
    for k in keys:
        np.testing.assert_array_equal(np.load(exp / "labels" / f"{k}.npy"),
                                      np.load(jdir / "labels" / f"{k}.npy"))
    assert cfg["model"].num_classes == 8 and cfg["data"].kmeans_iters == 3
