"""The port's attention with a key-padding bias (`ops/flash_attention.py`,
the `flash_attention` slice): its plain version and that version's
gradients against the Pallas `flash_attention` (interpret mode; its custom
VJP recomputes through `_reference_attention`), float32 on the CPU, the
all-masked query as the reference has it, the wrapper rules, and
`MultiHeadAttention`'s kernel route against the JAX module at T >= 512,
where the JAX module takes the Pallas kernel. The CUDA kernel is held
against the plain version on the card by tests/test_torch_gpu.py."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models import attention as jatt
from espnet_tpu.ops.masks import attention_bias
from espnet_tpu.ops.pallas_attention import (_reference_attention,
                                             flash_attention)
from espnet_tpu_torch.convert import jax_params_to_state_dict
from espnet_tpu_torch.models import attention as tatt
from espnet_tpu_torch.ops import flash_attention as tflash
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

# float32 on the CPU: softmax-weighted sums over <= 600 keys, blocked
# online softmax vs one pass
FWD_ATOL = 2e-5
# gradients: relative L2 per tensor
GRAD_REL_L2 = 1e-4
# bf16 gradients against the Pallas VJP on the same bf16 inputs: both
# differentiate `_reference_attention` in its rounding (a bf16 score
# product, bf16 weights), so what is left is the order of the CPU's float32
# sums inside each bf16 product and the rounding it feeds (2e-5 to 3e-5 at
# this test's shape); a float32 recompute differentiates another function,
# 5e-3 away
BF16_GRAD_REL_L2 = 1e-3


def _inputs(b, h, t, d, lengths, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    bias = np.asarray(attention_bias(jnp.asarray(mask[:, None, None, :])))
    return q, k, v, np.array(bias)


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


@pytest.mark.parametrize("t,lengths", [
    (600, [600, 437]),   # T >= 512, not a multiple of either Pallas block
    (515, [300, 515]),
])
def test_flash_plain_matches_pallas_forward_and_gradients(t, lengths):
    args = _inputs(2, 2, t, 16, lengths, t)
    jargs = tuple(jnp.asarray(a) for a in args)
    pal = np.asarray(flash_attention(*jargs, interpret=True))
    got = tflash.flash_attention(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), pal, atol=FWD_ATOL,
                               rtol=FWD_ATOL)

    ct = np.random.RandomState(7).randn(*got.shape).astype(np.float32)
    pal_grads = jax.grad(
        lambda q, k, v: jnp.sum(flash_attention(q, k, v, jargs[3],
                                                interpret=True)
                                * jnp.asarray(ct)),
        argnums=(0, 1, 2))(*jargs[:3])
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args[:3]]
    tflash.flash_attention(*leaves, torch.from_numpy(args[3])).backward(
        torch.from_numpy(ct))
    for name, leaf, pg in zip("qkv", leaves, pal_grads):
        err = _rel_l2(leaf.grad.numpy(), np.asarray(pg))
        assert err <= GRAD_REL_L2, (name, err)


@pytest.mark.parametrize("route", ["flash_attention", "flash_attention_plain"])
def test_bf16_gradients_are_the_pallas_vjp(route):
    """bf16 q, k, v and a float32 cotangent: dq, dk, dv of the CPU route
    (`flash_attention`) and of the comparator route (`flash_attention_plain`,
    which `MultiHeadAttention.use_kernel = False` takes) against `jax.grad`
    of the Pallas `flash_attention` in interpret mode, whose custom VJP
    differentiates `_reference_attention` in bf16. The forward stays float32
    inside, as `_flash_kernel` is."""
    q, k, v, bias = _inputs(2, 2, 520, 16, [520, 300], 520)
    bf = jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(bf) for a in (q, k, v))
    ct = np.random.RandomState(11).randn(*q.shape).astype(np.float32)
    pal_grads = jax.grad(
        lambda q, k, v: jnp.sum(flash_attention(q, k, v, jnp.asarray(bias),
                                                interpret=True)
                                * jnp.asarray(ct)),
        argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_(True) for a in (jq, jk, jv)]
    out = getattr(tflash, route)(*leaves, torch.from_numpy(bias))
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(ct)).sum().backward()
    for name, leaf, pg in zip("qkv", leaves, pal_grads):
        assert leaf.grad.dtype == torch.bfloat16
        err = _rel_l2(leaf.grad.float().numpy(),
                      np.asarray(pg.astype(jnp.float32)))
        assert err <= BF16_GRAD_REL_L2, (name, err)


def test_reference_attention_is_the_jax_reference_in_bf16():
    """`reference_attention` keeps the input dtype as `_reference_attention`
    does: a bf16 score product, a float32 softmax, bf16 weights."""
    q, k, v, bias = _inputs(2, 2, 40, 16, [40, 23], 3)
    bf = jnp.bfloat16
    jargs = [jnp.asarray(a).astype(bf) for a in (q, k, v)]
    want = np.asarray(_reference_attention(*jargs, jnp.asarray(bias))
                      .astype(jnp.float32))
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in jargs]
    got = tflash.reference_attention(*targs, torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of the output (|out| < 4: 2^-6) where the two round a
    # value near a bf16 boundary differently
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -6,
                               rtol=0)
    assert _rel_l2(got.float().numpy(), want) <= 1e-3


def test_all_masked_query_averages_v_as_the_reference():
    """Every key of utterance 1 masked: the port follows
    `_reference_attention` (the uniform average of v over the T keys), not
    the Pallas kernel (which averages over its padded key length)."""
    args = _inputs(2, 2, 40, 8, [40, 0], 1)
    ref = np.asarray(_reference_attention(*(jnp.asarray(a) for a in args)))
    got = tflash.flash_attention(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), ref, atol=FWD_ATOL,
                               rtol=FWD_ATOL)
    np.testing.assert_allclose(
        got[1].numpy(), np.broadcast_to(args[2][1].mean(axis=1,
                                                        keepdims=True),
                                        (2, 40, 8)), atol=FWD_ATOL)


def test_flash_wrapper_rules():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(1, 2, 6, 32, [6],
                                                          2))
    before = tflash.flash_attention.launches
    torch.testing.assert_close(tflash.flash_attention(q, k, v, bias),
                               tflash.flash_attention_plain(q, k, v, bias),
                               rtol=0, atol=0)
    assert tflash.flash_attention.launches == before
    causal = torch.zeros(1, 1, 6, 6)
    assert not tflash.key_padding_only(causal)
    assert tflash.key_padding_only(bias) and tflash.key_padding_only(None)
    with pytest.raises(ValueError, match="key-padding"):
        tflash.flash_attention(q, k, v, causal)
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    # the head-dim gate of both attention kernels: the JAX module's
    # dk % 8 == 0; within it the kernels pad to 32, 64 or 128 and raise
    # past 128 (on the card, see tests/test_torch_gpu.py)
    for d, takes, kernel_d in ((64, True, 64), (128, True, 128),
                               (16, True, 32), (96, True, 128),
                               (36, False, 64), (136, True, None)):
        assert trel.kernel_takes(d) is takes
        if kernel_d is None:
            with pytest.raises(ValueError, match="up to 128"):
                trel.kernel_head_dim(d)
        else:
            assert trel.kernel_head_dim(d) == kernel_d


def test_multi_head_attention_kernel_route_matches_jax_at_t_512(monkeypatch):
    """T = 530 >= 512: the JAX module takes its Pallas kernel (interpret
    mode on the CPU), the port's its flash route (the plain version on the
    CPU); both with the same perturbed parameters."""
    rng = np.random.RandomState(0)
    t = 530
    x = rng.randn(2, t, 64).astype(np.float32)
    mask = np.arange(t)[None] < np.array([t, 301])[:, None]
    bias = np.array(attention_bias(jnp.asarray(mask[:, None, None, :])))
    jm = jatt.MultiHeadAttention(2, 64)  # dk 32
    jx = jnp.asarray(x)
    v = fnn.meta.unbox(jm.init(jax.random.PRNGKey(0), jx, jx, jx,
                               jnp.asarray(bias)))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(
            np.float32), v["params"])
    jy = jm.apply({"params": params}, jx, jx, jx, jnp.asarray(bias))
    tm = tatt.MultiHeadAttention(2, 64)
    tm.load_state_dict(jax_params_to_state_dict(params))
    tx, tb = torch.from_numpy(x), torch.from_numpy(bias)
    calls = []
    plain = tflash.flash_attention_plain

    def spy(*a):
        calls.append(a[0].shape)
        return plain(*a)

    monkeypatch.setattr(tflash, "flash_attention_plain", spy)
    with torch.no_grad():
        got = tm(tx, tx, tx, tb)
    assert calls == [(2, 2, t, 32)]  # the kernel route, plain on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
