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


# gradients of the modules' parameters, float32 on the CPU: the same
# summation-order difference as TOL, through one more (backward) pass
GRAD_TOL = 2e-4


def _param_grads_match(jm, params, jargs, tm, targs, seed):
    """jax.grad and torch autograd of sum(out * ct) w.r.t. every parameter,
    compared leaf by leaf in the port's names and layouts."""
    def first(out):
        return out[0] if isinstance(out, tuple) else out

    shape = jax.eval_shape(lambda p: first(jm.apply({"params": p}, *jargs)),
                           params).shape
    ct = np.random.RandomState(seed).randn(*shape).astype(np.float32)

    def loss(p):
        return jnp.sum(first(jm.apply({"params": p}, *jargs)) * ct)

    want = jax_params_to_state_dict(jax.jit(jax.grad(loss))(params))
    (first(tm(*targs)) * torch.from_numpy(ct)).sum().backward()
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


def test_conformer_block_gradients_match():
    rng = np.random.RandomState(7)
    t, d = 13, 32
    x = rng.randn(2, t, d).astype(np.float32)
    pos = np.asarray(rel_position_encoding(t, d))
    mask = np.arange(t)[None] < np.array([t, 7])[:, None]
    bias = np.asarray(attention_bias(jnp.asarray(mask[:, None, None, :])))
    jm = jconf.ConformerBlock(d, 4, 64, kernel_size=5)
    jargs = tuple(map(jnp.asarray, (x, pos, bias, mask)))
    params = _init(jm, *jargs, seed=3)
    tm = _load(tconf.ConformerBlock(d, 4, 64, kernel_size=5), params)
    _param_grads_match(jm, params, jargs, tm, _t(x, pos, bias, mask), 1)


def test_transformer_decoder_gradients_match():
    rng = np.random.RandomState(8)
    tokens = rng.randint(0, 11, (2, 6)).astype(np.int32)
    tlens = np.array([6, 3], np.int32)
    mem = rng.randn(2, 9, 32).astype(np.float32)
    mlens = np.array([9, 5], np.int32)
    jm = jtr.TransformerDecoder(11, 32, 4, 64, 2)
    jargs = tuple(map(jnp.asarray, (tokens, tlens, mem, mlens)))
    params = _init(jm, *jargs, seed=4)
    tm = _load(ttr.TransformerDecoder(11, 32, 4, 64, 2), params)
    _param_grads_match(jm, params, jargs, tm,
                       _t(tokens.astype(np.int64), tlens, mem, mlens), 2)


def test_macaron_dropout_goes_through_the_kernel_hash():
    """In training, a macaron FFN draws its two seeds from the generator and
    drops exactly what the Pallas kernel drops for those seeds; the other
    dropout sites follow the generator too, and eval mode ignores it."""
    from espnet_tpu.ops.pallas_ffn import fused_prenorm_ffn
    from espnet_tpu_torch.ops.dropout import draw_seeds

    rng = np.random.RandomState(9)
    t, d = 300, 128  # 300 rows over two 256-row tiles of the hash
    x = rng.randn(1, t, d).astype(np.float32)
    pos = np.asarray(rel_position_encoding(t, d))
    mask = np.ones((1, t), bool)
    bias = np.zeros((1, 1, 1, t), np.float32)
    jm = jconf.ConformerBlock(d, 4, 128, kernel_size=5)
    params = _init(jm, *map(jnp.asarray, (x[:, :8], pos[:, :15],
                                          bias[..., :8], mask[:, :8])))
    tm = _load(tconf.ConformerBlock(d, 4, 128, kernel_size=5), params)
    tm.train()
    g = torch.Generator().manual_seed(5)
    seeds = draw_seeds(torch.Generator().manual_seed(5), 2)
    got = tm._macaron(torch.from_numpy(x), tm.norm_ff1, tm.ff1, g)
    p = params
    want = fused_prenorm_ffn(
        jnp.asarray(x), p["norm_ff1"]["scale"], p["norm_ff1"]["bias"],
        p["ff1"]["w1"]["kernel"], p["ff1"]["w1"]["bias"],
        p["ff1"]["w2"]["kernel"], p["ff1"]["w2"]["bias"],
        jnp.asarray(seeds, jnp.int32), drop_rate=0.1, activation="swish",
        residual_scale=0.5, interpret=True)
    _close(got.detach(), want)
    args = _t(x, pos, bias, mask)
    y1 = tm(*args, generator=torch.Generator().manual_seed(1))
    y2 = tm(*args, generator=torch.Generator().manual_seed(1))
    y3 = tm(*args, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    assert not torch.equal(y1, y3)
    tm.eval()
    torch.testing.assert_close(tm(*args, generator=g), tm(*args), rtol=0,
                               atol=0)
