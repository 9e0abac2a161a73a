"""The port's position-wise FFN (`ops/ffn.py`, the `fused_ffn` slice): its
plain version and that version's gradients against the Pallas `fused_ffn`
(interpret mode) and the Pallas file's own `ffn_reference`, float32 on the
CPU, with the hash dropout bit for bit, and the wrapper rules. The CUDA
kernels are held against the plain version on the card by
tests/test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.ops.pallas_ffn import ffn_reference, fused_ffn
from espnet_tpu_torch.ops import ffn as tffn
from espnet_tpu_torch.ops import ffn_common
from espnet_tpu_torch.ops import prenorm_ffn as tpffn

# float32 on the CPU: products of width <= 256 summed in another order
FWD_ATOL = 1e-5
# gradients: relative L2 per tensor, sums over 300 rows in another order
GRAD_REL_L2 = 1e-4
SEED = 20240601


def _inputs(m, d, f, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, d).astype(np.float32)
    w1 = (rng.randn(d, f) / np.sqrt(d)).astype(np.float32)
    b1 = (0.2 * rng.randn(f)).astype(np.float32)
    w2 = (rng.randn(f, d) / np.sqrt(f)).astype(np.float32)
    b2 = (0.2 * rng.randn(d)).astype(np.float32)
    return x, w1, b1, w2, b2


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("activation", ["swish", "relu"])
def test_fused_ffn_plain_matches_pallas_and_reference(activation, drop):
    """M = 300: two 256-row tiles, the second padded."""
    m, d, f = 300, 64, 256
    args = _inputs(m, d, f, 3)
    jargs = tuple(jnp.asarray(a) for a in args)
    seed = jnp.asarray([SEED], jnp.int32)
    kw = dict(drop_rate=drop, activation=activation)
    ref = np.asarray(ffn_reference(*jargs, seed, **kw))
    pal = np.asarray(fused_ffn(*jargs, seed, tile_m=256, interpret=True, **kw))
    got = tffn.fused_ffn(*(torch.from_numpy(a) for a in args), seed=SEED,
                         **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=FWD_ATOL, rtol=FWD_ATOL)
    np.testing.assert_allclose(got, pal, atol=FWD_ATOL, rtol=FWD_ATOL)

    ct = np.random.RandomState(11).randn(m, d).astype(np.float32)
    pal_grads = jax.grad(
        lambda *a: jnp.sum(fused_ffn(*a, seed, tile_m=256, interpret=True,
                                     **kw) * jnp.asarray(ct)),
        argnums=range(5))(*jargs)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    tffn.fused_ffn(*leaves, seed=SEED, **kw).backward(torch.from_numpy(ct))
    for name, leaf, pg in zip("x w1 b1 w2 b2".split(), leaves, pal_grads):
        err = _rel_l2(leaf.grad.numpy(), np.asarray(pg))
        assert err <= GRAD_REL_L2, (name, err)


def test_fused_ffn_mask_is_the_first_prenorm_mask():
    """The one mask of `fused_ffn` is stream 0 of the pre-norm FFN's hash:
    the elements it drops are exactly those of `keep_mask` with its seed."""
    m, d, f = 300, 64, 128
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _inputs(m, d, f, 4))
    w2 = torch.eye(f, d)  # y = drop(act(h)) for the first d hidden units
    b2 = torch.zeros(d)
    y = tffn.fused_ffn(x, w1, b1, w2, b2, seed=SEED, drop_rate=0.1,
                       activation="relu")
    keep = tpffn.keep_mask(m, f, SEED, tpffn.quantize_rate(0.1))[:, :d]
    h = torch.relu(x @ w1 + b1)[:, :d]
    assert torch.equal(y == 0, (~keep) | (h == 0))


def test_fused_ffn_leading_dims_and_cpu_route():
    args = [torch.from_numpy(a) for a in _inputs(12, 64, 128, 0)]
    before = tffn.fused_ffn.launches
    y = tffn.fused_ffn(args[0].reshape(3, 4, 64), *args[1:])
    assert y.shape == (3, 4, 64) and tffn.fused_ffn.launches == before
    torch.testing.assert_close(y.reshape(12, 64),
                               tffn.fused_ffn_plain(*args), rtol=0, atol=0)


def test_fused_ffn_wrapper_rules():
    args = [torch.from_numpy(a) for a in _inputs(4, 64, 128, 1)]
    with pytest.raises(ValueError, match="seed"):
        tffn.fused_ffn(*args, drop_rate=0.1)
    with pytest.raises(ValueError):
        tffn.fused_ffn(*args, activation="gelu")
    with pytest.raises(ValueError, match="unsupported device"):
        tffn.fused_ffn(*(a.to("meta") for a in args))


@pytest.mark.parametrize("d,f,takes", [
    (256, 1024, True), (512, 2048, True), (128, 512, True),
    (384, 1536, True), (1024, 4096, True), (144, 576, False),
    (256, 1000, False), (64, 256, False),
])
def test_ffn_shape_gates(d, f, takes):
    """The shape gate of both FFN ops, decided from the shapes alone, is
    the JAX package's `_ffn_tileable` less its row count: d_model and d_ff
    multiples of 128."""
    from espnet_tpu.models.transformer import _ffn_tileable

    assert ffn_common.kernel_takes(d, f) is takes
    rows = jnp.zeros((256, 1))
    assert _ffn_tileable(rows, d, f, 256) is takes
    # within the gate, the kernels themselves take d_model up to 512; a
    # larger one raises on the card (see tests/test_torch_gpu.py)
    if takes:
        assert (d in ffn_common.KERNEL_MODEL_DIMS) is (d <= 512)
