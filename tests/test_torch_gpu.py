"""Each CUDA kernel of the port against its plain PyTorch version, on the
card only (the kernels have no CPU mode; here every test skips).

This file imports no JAX, so it also runs on the card's machine, which has
none: `python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`.
"""

import numpy as np
import pytest
import torch

from espnet_tpu_torch.ops import prenorm_ffn as tffn
from espnet_tpu_torch.ops import relpos_attention as trel

# (atol, rtol): float32 sums in another order; bf16 outputs round to 8 bits
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _relpos_args(device, dtype, b=3, h=4, t=200, d=64, lengths=(200, 77, 0)):
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    p = rng.randn(h, 2 * t - 1, d).astype(np.float32)
    u, vb = (0.3 * rng.randn(h, d).astype(np.float32) for _ in range(2))
    valid = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    bias = np.where(valid, 0.0, np.finfo(np.float32).min).astype(np.float32)
    args = [torch.from_numpy(a).to(device) for a in
            (q, k, v, p, u, vb, bias[:, None, None, :])]
    return [a.to(dtype) for a in args[:4]] + args[4:]


def _ffn_args(device, dtype, m=333, d=256, f=1024):
    rng = np.random.RandomState(6)
    x = rng.randn(m, d)
    lns, lnb = 1 + 0.2 * rng.randn(d), 0.2 * rng.randn(d)
    w1, b1 = rng.randn(d, f) / np.sqrt(d), 0.2 * rng.randn(f)
    w2, b2 = rng.randn(f, d) / np.sqrt(f), 0.2 * rng.randn(d)
    args = [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (x, lns, lnb, w1, b1, w2, b2)]
    for i in (0, 3, 5):  # x and the weights in the compute dtype
        args[i] = args[i].to(dtype)
    return args


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [200, 1, 64, 65])
def test_relpos_kernel_matches_plain(cuda, dtype, t):
    lengths = (t, max(1, t // 3), 0)
    args = _relpos_args(cuda, dtype, t=t, lengths=lengths)
    before = trel.relpos_attention.launches
    got = trel.relpos_attention(*args)
    torch.cuda.synchronize()
    assert trel.relpos_attention.launches == before + 1
    want = trel.relpos_attention_plain(*args)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation,scale", [("swish", 0.5), ("relu", 1.0)])
def test_prenorm_ffn_kernel_matches_plain(cuda, dtype, activation, scale):
    args = _ffn_args(cuda, dtype)
    kw = dict(activation=activation, residual_scale=scale)
    before = tffn.prenorm_ffn.launches
    got = tffn.prenorm_ffn(*args, **kw)
    torch.cuda.synchronize()
    assert tffn.prenorm_ffn.launches == before + 1
    want = tffn.prenorm_ffn_plain(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
def test_wrappers_check_their_arguments_on_card(cuda):
    args = _relpos_args(cuda, torch.float32)
    with pytest.raises(ValueError, match="not contiguous"):
        trel.relpos_attention(args[0].transpose(2, 3).contiguous()
                              .transpose(2, 3), *args[1:])
    with pytest.raises(TypeError):
        trel.relpos_attention(args[0].half(), *args[1:])
    fargs = _ffn_args(cuda, torch.float32)
    with pytest.raises(ValueError, match="shape"):
        tffn.prenorm_ffn(*fargs[:5], fargs[5][:1000], fargs[6])
    with pytest.raises(TypeError):
        tffn.prenorm_ffn(fargs[0].bfloat16(), *fargs[1:])
