"""The port's two kernels: their plain versions against the Pallas kernels
(interpret mode) and the Pallas files' own references, float32 on the CPU,
and the wrapper rules. The CUDA kernels themselves are held against their
plain versions on the card by tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.ops.masks import attention_bias
from espnet_tpu.ops.pallas_ffn import fused_prenorm_ffn, prenorm_ffn_reference
from espnet_tpu.ops.pallas_relpos_attention import (relpos_attention_reference,
                                                    relpos_flash_attention)
from espnet_tpu_torch.ops import prenorm_ffn as tffn
from espnet_tpu_torch.ops import relpos_attention as trel

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
    with pytest.raises(NotImplementedError):
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

