"""The port's rel-pos attention and pre-norm FFN: their plain versions (and
the plain versions' gradients) against the Pallas kernels (interpret mode)
and the Pallas files' own references, float32 on the CPU, the FFN's hash
dropout bit for bit, and the wrapper rules. The CUDA kernels themselves are
held against their plain versions on the card by tests/test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.ops.masks import attention_bias
from espnet_tpu.ops.pallas_ffn import (_keep_mask, fused_prenorm_ffn,
                                       prenorm_ffn_reference)
from espnet_tpu.ops.pallas_relpos_attention import (relpos_attention_reference,
                                                    relpos_flash_attention)
from espnet_tpu_torch.ops import prenorm_ffn as tffn
from espnet_tpu_torch.ops import relpos_attention as trel


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

# float32 on the CPU: softmax-weighted sums of O(1) values, different
# summation order (blocked online softmax vs one pass)
ATTN_TOL = 2e-5
FFN_TOL = 2e-5


def _relpos_inputs(b, h, t, d, lengths, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    p = rng.randn(h, 2 * t - 1, d).astype(np.float32)
    u, vb = (0.3 * rng.randn(h, d).astype(np.float32) for _ in range(2))
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    bias = np.asarray(attention_bias(jnp.asarray(mask[:, None, None, :])))
    return q, k, v, p, u, vb, np.array(bias), mask


@pytest.mark.parametrize("t,lengths", [
    (37, [37, 20, 0]),          # one utterance with every key masked
    (130, [130, 64, 1]),        # T above one 128 tile, not a multiple of it
    (5, [5, 3, 2]),
])
def test_relpos_plain_matches_pallas_and_reference(t, lengths):
    b, h, d = len(lengths), 2, 16
    q, k, v, p, u, vb, bias, mask = _relpos_inputs(b, h, t, d, lengths, t)
    jargs = tuple(jnp.asarray(a) for a in (q, k, v, p, u, vb, bias))
    ref = np.asarray(relpos_attention_reference(*jargs))
    pal = np.asarray(relpos_flash_attention(*jargs, interpret=True))
    got = trel.relpos_attention(*(torch.from_numpy(a) for a in
                                  (q, k, v, p, u, vb, bias))).numpy()
    np.testing.assert_allclose(got, ref, atol=ATTN_TOL, rtol=ATTN_TOL)
    # The Pallas kernel returns 0 for a query whose keys are all masked; the
    # reference and the port return the uniform average of v. Elsewhere all
    # three agree.
    some = np.array(lengths) > 0
    np.testing.assert_allclose(got[some], pal[some], atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    if not some.all():
        uniform = v[~some].mean(axis=2, keepdims=True)
        np.testing.assert_allclose(got[~some],
                                   np.broadcast_to(uniform, got[~some].shape),
                                   atol=ATTN_TOL, rtol=ATTN_TOL)


def test_relpos_bias_forms():
    """No bias, a -inf bias and a broadcast (1, 1, 1, T) bias."""
    b, h, t, d = 2, 2, 9, 16
    q, k, v, p, u, vb, _, mask = _relpos_inputs(b, h, t, d, [9, 4], 0)
    jargs = tuple(jnp.asarray(a) for a in (q, k, v, p, u, vb))
    targs = tuple(torch.from_numpy(a) for a in (q, k, v, p, u, vb))
    np.testing.assert_allclose(
        trel.relpos_attention(*targs).numpy(),
        np.asarray(relpos_attention_reference(*jargs)),
        atol=ATTN_TOL, rtol=ATTN_TOL)
    inf_bias = np.where(mask, 0.0, -np.inf).astype(np.float32)[:, None, None]
    np.testing.assert_allclose(
        trel.relpos_attention(*targs, torch.from_numpy(inf_bias)).numpy(),
        np.asarray(relpos_attention_reference(*jargs, jnp.asarray(inf_bias))),
        atol=ATTN_TOL, rtol=ATTN_TOL)
    one = np.where(np.arange(t) < 6, 0.0, -1e9).astype(np.float32)[None, None, None]
    np.testing.assert_allclose(
        trel.relpos_attention(*targs, torch.from_numpy(one)).numpy(),
        np.asarray(relpos_attention_reference(*jargs, jnp.asarray(one))),
        atol=ATTN_TOL, rtol=ATTN_TOL)


def _ffn_inputs(m, d, f, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, d).astype(np.float32)
    lns = (1 + 0.2 * rng.randn(d)).astype(np.float32)
    lnb = (0.2 * rng.randn(d)).astype(np.float32)
    w1 = (rng.randn(d, f) / np.sqrt(d)).astype(np.float32)
    b1 = (0.2 * rng.randn(f)).astype(np.float32)
    w2 = (rng.randn(f, d) / np.sqrt(f)).astype(np.float32)
    b2 = (0.2 * rng.randn(d)).astype(np.float32)
    return x, lns, lnb, w1, b1, w2, b2


@pytest.mark.parametrize("activation,scale", [("swish", 0.5), ("relu", 1.0)])
@pytest.mark.parametrize("m", [37, 300])  # ragged row counts
def test_prenorm_ffn_plain_matches_pallas_and_reference(m, activation, scale):
    args = _ffn_inputs(m, 128, 256, m)
    jargs = tuple(jnp.asarray(a) for a in args)
    kw = dict(activation=activation, residual_scale=scale)
    ref = np.asarray(prenorm_ffn_reference(*jargs, **kw))
    pal = np.asarray(fused_prenorm_ffn(*jargs, **kw, tile_m=128,
                                       interpret=True))
    got = tffn.prenorm_ffn(*(torch.from_numpy(a) for a in args), **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=FFN_TOL, rtol=FFN_TOL)
    np.testing.assert_allclose(got, pal, atol=FFN_TOL, rtol=FFN_TOL)


def test_prenorm_ffn_leading_dims_kept():
    args = _ffn_inputs(12, 64, 128, 0)
    x3 = torch.from_numpy(args[0]).reshape(3, 4, 64)
    rest = tuple(torch.from_numpy(a) for a in args[1:])
    y = tffn.prenorm_ffn(x3, *rest)
    assert y.shape == (3, 4, 64)
    np.testing.assert_allclose(
        y.reshape(12, 64).numpy(),
        tffn.prenorm_ffn(torch.from_numpy(args[0]), *rest).numpy(), atol=0)


def test_cpu_tensors_take_the_plain_versions():
    args = tuple(torch.from_numpy(a) for a in _ffn_inputs(8, 64, 128, 1))
    before = tffn.prenorm_ffn.launches
    torch.testing.assert_close(tffn.prenorm_ffn(*args),
                               tffn.prenorm_ffn_plain(*args), rtol=0, atol=0)
    assert tffn.prenorm_ffn.launches == before
    q, k, v, p, u, vb, bias, _ = _relpos_inputs(1, 2, 6, 16, [6], 2)
    targs = tuple(torch.from_numpy(a) for a in (q, k, v, p, u, vb, bias))
    before = trel.relpos_attention.launches
    torch.testing.assert_close(trel.relpos_attention(*targs),
                               trel.relpos_attention_plain(*targs),
                               rtol=0, atol=0)
    assert trel.relpos_attention.launches == before


def test_wrappers_refuse_what_this_slice_lacks():
    args = tuple(torch.from_numpy(a) for a in _ffn_inputs(4, 64, 128, 3))
    with pytest.raises(ValueError, match="seeds"):  # dropout needs its seeds
        tffn.prenorm_ffn(*args, drop_rate=0.1)
    with pytest.raises(ValueError):
        tffn.prenorm_ffn(*args, activation="gelu")
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="unsupported device"):
        tffn.prenorm_ffn(*meta)
    q = torch.zeros(1, 1, 3, 32, device="meta")
    p = torch.zeros(1, 5, 32, device="meta")
    u = torch.zeros(1, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trel.relpos_attention(q, q, q, p, u, u)



# gradients: float32 on the CPU, sums over <= 130 keys or 300 rows in
# another order than the Pallas kernels' blocked ones
GRAD_TOL = 1e-4


def _torch_grads(fn, arrays, n_diff):
    leaves = [torch.from_numpy(a).requires_grad_(i < n_diff)
              for i, a in enumerate(arrays)]
    out = fn(*leaves)
    out.backward(torch.from_numpy(_cotangent(out.shape)))
    return out, [leaf.grad for leaf in leaves[:n_diff]]


def _cotangent(shape):
    return np.random.RandomState(11).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("t,lengths", [
    (130, [130, 64]),   # two 128-blocks (the Pallas general backward path)
    (37, [37, 20]),     # one block (the fused single-block backward)
])
def test_relpos_plain_gradients_match_pallas_and_reference(t, lengths):
    b, h, d = len(lengths), 2, 16
    q, k, v, p, u, vb, bias, _ = _relpos_inputs(b, h, t, d, lengths, t + 1)
    ct = jnp.asarray(_cotangent((b, h, t, d)))

    def jgrads(fn, **kw):
        return jax.grad(lambda *a: jnp.sum(fn(*a, jnp.asarray(bias), **kw)
                                           * ct), argnums=range(6))(
            *(jnp.asarray(a) for a in (q, k, v, p, u, vb)))

    ref = jgrads(relpos_attention_reference)
    pal = jgrads(relpos_flash_attention, interpret=True)
    _, got = _torch_grads(trel.relpos_attention,
                          (q, k, v, p, u, vb, bias), 6)
    for name, g, r, pa in zip("q k v p u vb".split(), got, ref, pal):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(pa), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)
    # masked keys get no gradient
    assert float(got[1][1, :, lengths[1]:].abs().max()) == 0.0
    assert float(got[2][1, :, lengths[1]:].abs().max()) == 0.0


def test_relpos_gradient_of_all_masked_query_is_the_uniform_average():
    """The port follows the reference where every key is masked: the output
    is the plain mean of v, so dv spreads the cotangent evenly."""
    b, h, t, d = 2, 2, 9, 16
    q, k, v, p, u, vb, bias, _ = _relpos_inputs(b, h, t, d, [9, 0], 4)
    ct = _cotangent((b, h, t, d))
    ref = jax.grad(lambda *a: jnp.sum(relpos_attention_reference(
        *a, jnp.asarray(bias)) * ct), argnums=range(6))(
        *(jnp.asarray(a) for a in (q, k, v, p, u, vb)))
    _, got = _torch_grads(trel.relpos_attention,
                          (q, k, v, p, u, vb, bias), 6)
    for name, g, r in zip("q k v p u vb".split(), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)
    np.testing.assert_allclose(
        got[2][1].numpy(),
        np.broadcast_to(ct[1].sum(axis=1, keepdims=True) / t, (h, t, d)),
        atol=GRAD_TOL, rtol=GRAD_TOL)


SEEDS = (123456789, -98765)


@pytest.mark.parametrize("seed", [SEEDS[0], SEEDS[1], 0, -2 ** 31])
@pytest.mark.parametrize("cols", [2048, 256])
def test_ffn_keep_mask_is_bit_exact(seed, cols):
    """300 rows: two 256-row tiles, the second ragged."""
    q = tffn.quantize_rate(0.1)
    assert q == 26
    want = np.concatenate([
        np.asarray(_keep_mask((256, cols), jnp.int32(seed), jnp.int32(i), q))
        for i in range(2)])[:300]
    got = tffn.keep_mask(300, cols, seed, q).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1 - 26 / 256)) < 0.01


@pytest.mark.parametrize("activation,scale", [("swish", 0.5), ("relu", 1.0)])
def test_prenorm_ffn_dropout_matches_reference_and_pallas(activation, scale):
    m, d, f = 300, 128, 256
    args = _ffn_inputs(m, d, f, 5)
    seeds = np.array(SEEDS, np.int32)
    kw = dict(drop_rate=0.1, activation=activation, residual_scale=scale)
    jargs = tuple(jnp.asarray(a) for a in args)
    ref = np.asarray(prenorm_ffn_reference(*jargs, jnp.asarray(seeds), **kw))
    got = tffn.prenorm_ffn(*(torch.from_numpy(a) for a in args),
                           seeds=SEEDS, **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=FFN_TOL, rtol=FFN_TOL)
    # the dropped positions of stream 1 are exactly the residual
    keep1 = tffn.keep_mask(m, d, SEEDS[1], 26).numpy()
    np.testing.assert_array_equal(got[~keep1], args[0][~keep1])

    ct = jnp.asarray(_cotangent((m, d)))
    pal_grads = jax.grad(
        lambda *a: jnp.sum(fused_prenorm_ffn(
            *a, jnp.asarray(seeds), tile_m=256, interpret=True, **kw) * ct),
        argnums=range(7))(*jargs)
    _, got_grads = _torch_grads(
        lambda *a: tffn.prenorm_ffn(*a, seeds=SEEDS, **kw), args, 7)
    for name, g, pg in zip("x lns lnb w1 b1 w2 b2".split(), got_grads,
                           pal_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(pg), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)
