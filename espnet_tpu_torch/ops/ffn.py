"""Position-wise FFN with hash dropout: CUDA kernels and plain version.

Port of `fused_ffn` and its oracle `ffn_reference`
(`espnet_tpu/ops/pallas_ffn.py`):

    y = drop(act(x @ W1 + b1)) @ W2 + b2

with act swish or relu, no LayerNorm and no residual. Dropout is the Pallas
kernel's counter hash with one int32 seed over 256-row tiles: the first mask
of the pre-norm FFN (`ops.ffn_common.keep_mask` with its seed), bit for
bit, so the port and the JAX package drop the same elements for the same
seed.

`fused_ffn` is the entry point: a CPU tensor goes to `fused_ffn_plain`
(whose gradient is torch autograd's), a CUDA tensor to the kernels in
`csrc/ffn.cu` through an autograd Function (forward kernel; backward kernel
pair, counted once per backward call by `fused_ffn_bwd.launches`), which
keep the (M, d_ff) hidden activation out of device memory; anything else
raises. Callers apply the shape gate `ffn_common.kernel_takes` first (the
kernels are those of the pre-norm FFN without LayerNorm). Both round
act(.) and dh to x's dtype before each product, as the Pallas kernels do,
and accumulate in float32. The weight gradients come back in the weights'
dtype, the bias gradients in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from espnet_tpu_torch.ops.cuda_build import check_launch, kernel_library
from espnet_tpu_torch.ops.ffn_common import (ACTIVATIONS, DTYPE_CODES, act,
                                             bwd_grid, check_kernel_dims,
                                             drop_args, keep_mask,
                                             quantize_rate, stream)


def _check_options(drop_rate: float, seed, activation: str) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {activation!r}")
    if drop_rate > 0.0 and seed is None:
        raise ValueError("fused_ffn: dropout needs an int32 seed")


def fused_ffn_plain(x, w1, b1, w2, b2, seed: Optional[int] = None,
                    drop_rate: float = 0.0, activation: str = "swish"):
    """Plain PyTorch version. x: (..., D); w1: (D, F); w2: (F, D) in x's
    dtype; b1, b2 float32; seed: one int32 seed when drop_rate > 0."""
    _check_options(drop_rate, seed, activation)
    q = quantize_rate(drop_rate)
    dt = x.dtype
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    h = xf @ w1.float() + b1.float()
    a = act(h, activation)
    if q:
        keep = keep_mask(a.shape[0], a.shape[1], seed, q, x.device)
        a = torch.where(keep, a * (256.0 / (256 - q)), torch.zeros_like(a))
    y = a.to(dt).float() @ w2.float() + b2.float()
    return y.to(dt).reshape(x.shape)


def _check_cuda_args(x2, w1, b1, w2, b2):
    m, d = x2.shape
    f = w1.shape[-1]
    check_kernel_dims("fused_ffn", x2, f)
    expect = {
        "x": (x2, (m, d), x2.dtype), "w1": (w1, (d, f), x2.dtype),
        "w2": (w2, (f, d), x2.dtype), "b1": (b1, (f,), torch.float32),
        "b2": (b2, (d,), torch.float32),
    }
    for name, (t, shape, dtype) in expect.items():
        if t.device != x2.device:
            raise ValueError(f"fused_ffn: {name} is on {t.device}, "
                             f"x on {x2.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_ffn: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"fused_ffn: {name} is {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_ffn: {name} is not contiguous")


def _kernel_fwd(x2, w1, b1, w2, b2, activation, q, seed):
    y = torch.empty_like(x2)
    q, dscale, s0, _ = drop_args(q, None if seed is None else (seed,))
    code = kernel_library().espnet_ffn_fwd(
        x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), x2.shape[0], x2.shape[1], w1.shape[1],
        ACTIVATIONS[activation], q, dscale, s0, DTYPE_CODES[x2.dtype],
        stream(x2))
    check_launch("fused_ffn", code)
    fused_ffn.launches += 1
    return y


def fused_ffn_bwd(x2, w1, b1, w2, gy, activation, q, seed):
    """Gradients of the kernel's forward (the CUDA backward kernel pair):
    (dx, dw1, db1, dw2, db2). `fused_ffn_bwd.launches` counts calls."""
    if x2.device.type != "cuda":
        raise ValueError(f"fused_ffn_bwd: unsupported device {x2.device}")
    m, d = x2.shape
    f = w1.shape[1]
    gy = gy.to(x2.dtype).contiguous()
    lib = kernel_library()
    n_blocks, groups = bwd_grid(m, f)
    f32 = dict(dtype=torch.float32, device=x2.device)
    dx = torch.empty_like(x2)
    partial = torch.empty(n_blocks, d, **f32)  # per-block sums of db2
    dw1p = torch.empty(groups, d, f, **f32)
    dw2p = torch.empty(groups, f, d, **f32)
    db1p = torch.empty(groups, f, **f32)
    q, dscale, s0, _ = drop_args(q, None if seed is None else (seed,))
    code = lib.espnet_ffn_bwd(
        x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        gy.data_ptr(), dx.data_ptr(), partial.data_ptr(), dw1p.data_ptr(),
        dw2p.data_ptr(), db1p.data_ptr(), m, d, f, groups,
        ACTIVATIONS[activation], q, dscale, s0, DTYPE_CODES[x2.dtype],
        stream(x2))
    check_launch("fused_ffn_bwd", code)
    fused_ffn_bwd.launches += 1
    return (dx, dw1p.sum(dim=0).to(w1.dtype), db1p.sum(dim=0),
            dw2p.sum(dim=0).to(w2.dtype), partial.sum(dim=0))


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, activation, q, seed):
        ctx.save_for_backward(x2, w1, b1, w2)
        ctx.opts = (activation, q, seed)
        return _kernel_fwd(x2, w1, b1, w2, b2, activation, q, seed)

    @staticmethod
    def backward(ctx, gy):
        x2, w1, b1, w2 = ctx.saved_tensors
        grads = fused_ffn_bwd(x2, w1, b1, w2, gy, *ctx.opts)
        return grads + (None,) * 3


def fused_ffn(x, w1, b1, w2, b2, seed: Optional[int] = None,
              drop_rate: float = 0.0, activation: str = "swish"):
    """FFN: the CUDA kernels on the card, the plain version on the CPU.
    Arguments as in `fused_ffn_plain`; returns x's shape and dtype.

    Replaces `fused_ffn` (espnet_tpu/ops/pallas_ffn.py). `fused_ffn.launches`
    counts forward kernel launches.
    """
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1, b1, w2, b2, seed, drop_rate, activation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    _check_options(drop_rate, seed, activation)
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    _check_cuda_args(x2, w1, b1, w2, b2)
    q = quantize_rate(drop_rate)
    y = _FusedFFN.apply(x2, w1, b1, w2, b2, activation, q,
                        int(seed) if q else None)
    return y.reshape(x.shape)


fused_ffn.launches = 0
fused_ffn_bwd.launches = 0
