"""Encoder and decoder modules of the PyTorch port against their flax
counterparts: same (perturbed) JAX parameters carried over with the port's
converter, same numpy inputs, float32 on the CPU."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models import attention as jatt
from espnet_tpu.models import conformer as jconf
from espnet_tpu.models import subsampling as jsub
from espnet_tpu.models import transformer as jtr
from espnet_tpu.models.embedding import rel_position_encoding
from espnet_tpu.ops.masks import attention_bias, make_valid_mask
from espnet_tpu_torch.convert import jax_params_to_state_dict
from espnet_tpu_torch.models import attention as tatt
from espnet_tpu_torch.models import conformer as tconf
from espnet_tpu_torch.models import subsampling as tsub
from espnet_tpu_torch.models import transformer as ttr

# float32 on the CPU, different summation order; a conformer block adds
# some 10 products of width <= 128 between LayerNorms
TOL = 1e-4


def _init(module, *args, seed=0, method=None):
    """flax params of `module` (unboxed), every leaf perturbed from a numpy
    seed so that zero-initialised biases are exercised too."""
    kw = {} if method is None else {"method": method}
    v = fnn.meta.unbox(module.init(jax.random.PRNGKey(seed), *args, **kw))
    rng = np.random.RandomState(seed + 100)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(np.float32),
        v["params"])


def _load(tmod, params):
    tmod.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return tmod.eval()


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("factor", [2, 4, 6, 8])
def test_conv2d_subsampling_matches(factor):
    rng = np.random.RandomState(factor)
    x = rng.randn(2, 40, 20).astype(np.float32)
    lens = np.array([40, 23], np.int32)
    jm = jsub.Conv2dSubsampling(16, factor)
    params = _init(jm, jnp.asarray(x), jnp.asarray(lens))
    jy, jl = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(lens))
    tm = _load(tsub.Conv2dSubsampling(16, 20, factor), params)
    with torch.no_grad():
        ty, tl = tm(*_t(x, lens))
    _close(ty, jy)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(
        tsub.subsampled_length(torch.from_numpy(lens), factor).numpy(),
        np.asarray(jsub.subsampled_length(jnp.asarray(lens), factor)))


@pytest.mark.parametrize("factor,need", [(2, 7), (4, 7), (6, 11), (8, 15)])
def test_too_short_utterance_raises(factor, need):
    tm = tsub.Conv2dSubsampling(8, 20, factor)
    assert tsub.min_input_frames(factor) == need
    with pytest.raises(tsub.TooShortUttError, match=f"at least {need}"):
        tm(torch.zeros(1, need - 1, 20), torch.tensor([need - 1]))
    y, _ = tm(torch.zeros(1, need, 20), torch.tensor([need]))
    assert y.shape[1] == 1


def test_multi_head_attention_matches():
    rng = np.random.RandomState(0)
    q = rng.randn(2, 5, 32).astype(np.float32)
    kv = rng.randn(2, 9, 32).astype(np.float32)
    mask = np.arange(9)[None] < np.array([9, 4])[:, None]
    bias = np.asarray(attention_bias(jnp.asarray(mask[:, None, None, :])))
    jm = jatt.MultiHeadAttention(4, 32)
    params = _init(jm, *map(jnp.asarray, (q, kv, kv, bias)))
    jy = jm.apply({"params": params}, *map(jnp.asarray, (q, kv, kv, bias)))
    tm = _load(tatt.MultiHeadAttention(4, 32), params)
    with torch.no_grad():
        _close(tm(*_t(q, kv, kv, bias)), jy)


def test_multi_head_attention_cache_step_matches():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 1, 32).astype(np.float32)
    cache = {"k": rng.randn(3, 4, 6, 8).astype(np.float32),
             "v": rng.randn(3, 4, 6, 8).astype(np.float32)}
    jm = jatt.MultiHeadAttention(4, 32)
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    params = _init(jm, *map(jnp.asarray, (x, x, x)), None, jcache, 2)
    jy, jc = jm.apply({"params": params}, *map(jnp.asarray, (x, x, x)), None,
                      jcache, 2)
    tm = _load(tatt.MultiHeadAttention(4, 32), params)
    tcache = {k: torch.from_numpy(v) for k, v in cache.items()}
    with torch.no_grad():
        ty, tc = tm(*_t(x, x, x), None, tcache, 2)
    _close(ty, jy)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    np.testing.assert_array_equal(tcache["k"].numpy(), cache["k"])  # not mutated


@pytest.mark.parametrize("t,lengths", [(11, [11, 6]), (3, [3, 1])])
def test_rel_position_attention_matches(t, lengths):
    rng = np.random.RandomState(t)
    x = rng.randn(2, t, 32).astype(np.float32)
    pos = np.asarray(rel_position_encoding(t, 32))
    mask = np.arange(t)[None] < np.array(lengths)[:, None]
    bias = np.asarray(attention_bias(jnp.asarray(mask[:, None, None, :])))
    jm = jatt.RelPositionMultiHeadAttention(2, 32)
    params = _init(jm, *map(jnp.asarray, (x, pos, bias)))
    jy = jm.apply({"params": params}, *map(jnp.asarray, (x, pos, bias)))
    tm = _load(tatt.RelPositionMultiHeadAttention(2, 32), params)
    with torch.no_grad():
        _close(tm(*_t(x, pos, bias)), jy)


def _decoder_inputs(seed, b=2, u=5, t=7, d=32, vocab=11):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (b, u)).astype(np.int32)
    tlens = np.array([u, u - 2][:b], np.int32)
    mem = rng.randn(b, t, d).astype(np.float32)
    mlens = np.array([t, t - 3][:b], np.int32)
    return tokens, tlens, mem, mlens


def test_transformer_decoder_forward_matches():
    tokens, tlens, mem, mlens = _decoder_inputs(0)
    jm = jtr.TransformerDecoder(11, 32, 4, 64, 2)
    jargs = tuple(map(jnp.asarray, (tokens, tlens, mem, mlens)))
    params = _init(jm, *jargs)
    jy = jm.apply({"params": params}, *jargs)
    tm = _load(ttr.TransformerDecoder(11, 32, 4, 64, 2), params)
    with torch.no_grad():
        ty = tm(*_t(tokens.astype(np.int64), tlens, mem, mlens))
    _close(ty, jy)


def test_transformer_decoder_score_steps_match_jax_and_full_forward():
    """k incremental steps: equal to the JAX score_step and to the
    log-softmax of the port's own teacher-forced forward."""
    k, vocab = 4, 11
    tokens, _, mem, mlens = _decoder_inputs(1, u=k)
    tlens = np.full((2,), k, np.int32)
    jm = jtr.TransformerDecoder(vocab, 32, 4, 64, 2)
    params = _init(jm, *map(jnp.asarray, (tokens, tlens, mem, mlens)))
    tm = _load(ttr.TransformerDecoder(vocab, 32, 4, 64, 2), params)
    jcache = jm.apply({"params": params}, 2, k + 1,
                      method=jtr.TransformerDecoder.init_cache)
    tcache = tm.init_cache(2, k + 1)
    ttok = torch.from_numpy(tokens.astype(np.int64))
    with torch.no_grad():
        full = torch.log_softmax(
            tm(ttok, *_t(tlens, mem, mlens)), dim=-1).numpy()
        for pos in range(k):
            jlp, jcache = jm.apply(
                {"params": params}, jnp.asarray(tokens[:, pos]), pos,
                jnp.asarray(mem), jnp.asarray(mlens), jcache,
                method=jtr.TransformerDecoder.score_step)
            tlp, tcache = tm.score_step(ttok[:, pos], pos, *_t(mem, mlens),
                                        tcache)
            _close(tlp, jlp)
            _close(tlp, full[:, pos])


def test_convolution_module_matches():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 16).astype(np.float32)
    mask = np.arange(9)[None] < np.array([9, 5])[:, None]
    jm = jconf.ConvolutionModule(16, 5)
    params = _init(jm, jnp.asarray(x), jnp.asarray(mask))
    jy = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    tm = _load(tconf.ConvolutionModule(16, 5), params)
    with torch.no_grad():
        _close(tm(*_t(x, mask)), jy)


def test_conformer_block_matches():
    rng = np.random.RandomState(3)
    t, d = 13, 32
    x = rng.randn(2, t, d).astype(np.float32)
    pos = np.asarray(rel_position_encoding(t, d))
    mask = np.arange(t)[None] < np.array([t, 7])[:, None]
    bias = np.asarray(attention_bias(jnp.asarray(mask[:, None, None, :])))
    jm = jconf.ConformerBlock(d, 4, 64, kernel_size=5)
    jargs = tuple(map(jnp.asarray, (x, pos, bias, mask)))
    params = _init(jm, *jargs)
    jy = jm.apply({"params": params}, *jargs)
    tm = _load(tconf.ConformerBlock(d, 4, 64, kernel_size=5), params)
    with torch.no_grad():
        _close(tm(*_t(x, pos, bias, mask)), jy)


def test_conformer_encoder_matches():
    rng = np.random.RandomState(4)
    feats = rng.randn(3, 45, 20).astype(np.float32)
    lens = np.array([45, 30, 9], np.int32)
    jm = jconf.ConformerEncoder(d_model=32, num_heads=4, d_ff=64,
                                num_layers=2, kernel_size=5)
    params = _init(jm, jnp.asarray(feats), jnp.asarray(lens))
    jy, jl = jm.apply({"params": params}, jnp.asarray(feats),
                      jnp.asarray(lens))
    tm = _load(tconf.ConformerEncoder(20, 32, 4, 64, 2, 5), params)
    with torch.no_grad():
        ty, tl = tm(*_t(feats, lens))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    valid = np.asarray(make_valid_mask(jl, ty.shape[1]))[:, :, None]
    _close(ty.numpy() * valid, np.asarray(jy) * valid)
    _close(ty, jy)
