"""The contextual-block (streaming) conformer encoder against the JAX
package's: 2 layers, d 32 (2 heads), FFN 64, conv kernel 7, block 8 / hop 4 /
look-ahead 2 (as tests/test_streaming_device.py), on seeded features,
float32 on the CPU with dropout off. Both the parallel `forward` and the
blockwise `forward_blockwise` against JAX's `__call__` and
`forward_blockwise` (1e-5), the short path (T' <= block), every parameter
gradient against `jax.grad` (relative L2 1e-5, each norm floored at
1e-3 of the whole gradient's), and the port's blockwise
output against its parallel output (1e-6); then the whole `ASRModel` with
this encoder (encode and loss) and the converter both ways."""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models.asr import ASRConfig as JASRConfig
from espnet_tpu.models.asr import ASRModel as JASRModel
from espnet_tpu.models.streaming import \
    ContextualBlockConformerEncoder as JEncoder
from espnet_tpu_torch.convert import (jax_params_to_state_dict,
                                      load_jax_params, model_params,
                                      torch_to_jax_tree)
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel
from espnet_tpu_torch.models.streaming import (ContextualBlockConformerEncoder,
                                               _block_geometry)


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

TOL = 1e-5        # float32, 2 layers, summed in another order
GRAD_TOL = 1e-5   # relative L2 per tensor
SAME_TOL = 1e-6   # the port's two modes: batched vs one block at a time
GEOM = dict(block_size=8, hop_size=4, look_ahead=2)
N_FEATS = 12


def _encoders():
    kw = dict(d_model=32, num_heads=2, d_ff=64, num_layers=2, kernel_size=7,
              dropout_rate=0.0, **GEOM)
    return JEncoder(**kw), ContextualBlockConformerEncoder(N_FEATS, **kw)


def _feats(t, lens, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(len(lens), t, N_FEATS).astype(np.float32)
    return x, np.asarray(lens, np.int32)


@pytest.fixture(scope="module")
def encoders():
    jenc, tenc = _encoders()
    x, lens = _feats(120, [120, 90])
    params = fnn.meta.unbox(jax.jit(jenc.init)(jax.random.PRNGKey(0), x,
                                               lens))
    rng = np.random.RandomState(1)  # exercise zero-initialised leaves too
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a)
        + 0.05 * rng.randn(*a.shape).astype(np.float32), params["params"])
    tenc.load_state_dict(jax_params_to_state_dict(params))
    return jenc, params, tenc.eval()


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("t,lens", [(120, [120, 90]), (30, [30, 22])],
                         ids=["blocks", "short"])
@pytest.mark.parametrize("mode", ["forward", "forward_blockwise"])
def test_encoder_matches_jax(encoders, t, lens, mode):
    jenc, params, tenc = encoders
    x, lens = _feats(t, lens, seed=t)
    want, wlens = jax.jit(functools.partial(
        jenc.apply, method=None if mode == "forward" else
        JEncoder.forward_blockwise))({"params": params}, x, lens)
    with torch.no_grad():
        got, glens = getattr(tenc, mode)(torch.from_numpy(x),
                                         torch.from_numpy(lens))
    np.testing.assert_array_equal(glens.numpy(), np.asarray(wlens))
    _close(got.numpy(), want, TOL)


def test_geometry_matches_jax():
    from espnet_tpu.models.streaming import _block_geometry as jgeom

    for t in (9, 12, 29, 57, 100):
        for geo in ((8, 4, 2), (40, 16, 16)):
            want = jgeom(t, *geo)
            got = _block_geometry(t, *geo)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])


def test_blockwise_equals_parallel(encoders):
    _, _, tenc = encoders
    x, lens = _feats(160, [160, 133], seed=3)
    args = torch.from_numpy(x), torch.from_numpy(lens)
    with torch.no_grad():
        par, _ = tenc(*args)
        blk, _ = tenc.forward_blockwise(*args)
    _close(blk.numpy(), par.numpy(), SAME_TOL)


@pytest.mark.parametrize("t", [120, 30], ids=["blocks", "short"])
def test_gradients_match_jax(encoders, t):
    jenc, params, tenc = encoders
    x, lens = _feats(t, [t, t - 11], seed=7)
    rng = np.random.RandomState(8)
    w = None

    def jloss(p):
        out, _ = jenc.apply({"params": p}, x, lens)
        return jnp.sum(out * w)

    with torch.no_grad():
        out, _ = tenc(torch.from_numpy(x), torch.from_numpy(lens))
    w = rng.randn(*out.shape).astype(np.float32)
    jgrads = jax.jit(jax.grad(jloss))(params)
    tenc.zero_grad()
    out, _ = tenc(torch.from_numpy(x), torch.from_numpy(lens))
    (out * torch.from_numpy(w)).sum().backward()
    got = torch_to_jax_tree({n: p.grad for n, p in tenc.named_parameters()},
                            jgrads)
    flat_want = jax.tree_util.tree_leaves_with_path(jgrads)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_got) == len(flat_want)
    # the key projections' bias gradients are 0 but for rounding (softmax
    # ignores a per-query constant): each reference norm is floored at
    # 1e-3 of the whole gradient's
    total = np.sqrt(sum(float(np.sum(np.square(g))) for _, g in flat_want))
    for path, g_want in flat_want:
        g_want = np.asarray(g_want)
        g_got = flat_got[path]
        ref = max(np.linalg.norm(g_want), 1e-3 * total)
        err = np.linalg.norm(g_got - g_want) / ref
        assert err < GRAD_TOL, (jax.tree_util.keystr(path), err)


def _model_configs():
    kw = dict(vocab_size=16, n_fft=256, hop_length=128, n_mels=N_FEATS,
              use_specaug=False, normalize="none",
              encoder_type="contextual_block_conformer", d_model=32,
              num_heads=2, d_ff=64, num_encoder_layers=2,
              num_decoder_layers=1, decoder_d_ff=64, conformer_kernel_size=7,
              block_size=8, stream_hop_size=4, look_ahead=2,
              dropout_rate=0.0, ctc_weight=0.3)
    return JASRConfig(**kw), ASRConfig(**kw)


def test_asr_model_matches_jax():
    """The whole model: encode and the training loss, and the converter's
    tree both ways."""
    jcfg, tcfg = _model_configs()
    rng = np.random.RandomState(0)
    n = 16000
    speech = (0.3 * rng.randn(2, n)).astype(np.float32)
    lens = np.array([n, 11000], np.int32)
    speech[1, 11000:] = 0.0
    text = rng.randint(1, 15, (2, 4)).astype(np.int32)
    tlens = np.array([4, 3], np.int32)
    jm = JASRModel(jcfg)
    v = fnn.meta.unbox(jax.jit(jm.init, static_argnums=(5,))(
        jax.random.PRNGKey(0), speech, lens, text, tlens, True))
    tm = load_jax_params(ASRModel(tcfg), {"params": v["params"]}).eval()
    want_enc, _ = jax.jit(functools.partial(
        jm.apply, method=JASRModel.encode))(v, speech, lens)
    want_loss, _ = jax.jit(jm.apply, static_argnums=(5,))(
        v, speech, lens, text, tlens, True)
    with torch.no_grad():
        args = [torch.from_numpy(a) for a in (speech, lens, text, tlens)]
        got_enc, _ = tm.encode(args[0], args[1])
        got_loss, _ = tm(*args)
    _close(got_enc.numpy(), want_enc, TOL)
    assert abs(float(got_loss) - float(want_loss)) <= TOL * max(
        1.0, abs(float(want_loss)))
    back = model_params(tm)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(v["params"]):
        np.testing.assert_array_equal(flat_back[path], np.asarray(leaf))
    assert len(flat_back) == len(jax.tree_util.tree_leaves(v["params"]))


def test_config_defaults_mirror_jax():
    jcfg, _ = _model_configs()
    port = ASRConfig(vocab_size=16)
    ref = JASRConfig(vocab_size=16)
    for f in ("block_size", "stream_hop_size", "look_ahead"):
        assert getattr(port, f) == getattr(ref, f)
    assert dataclasses.replace(port, block_size=8).block_size == 8
    assert jcfg.encoder_type == "contextual_block_conformer"
