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
                                             aligned16, bwd_buffers,
                                             check_args, check_kernel_dims,
                                             drop_args, keep_mask, ptr,
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
    check_args("fused_ffn", {
        "x": (x2, (m, d), x2.dtype), "w1": (w1, (d, f), x2.dtype),
        "w2": (w2, (f, d), x2.dtype), "b1": (b1, (f,), torch.float32),
        "b2": (b2, (d,), torch.float32),
    }, x2)


def _kernel_fwd(x2, w1, b1, w2, b2, activation, q, seed):
    if x2.dtype == torch.bfloat16:  # tensor cores: 16-byte copies
        x2, w1, w2 = (aligned16(t) for t in (x2, w1, w2))
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
    (dx, dw1, db1, dw2, db2). bf16 runs on tensor cores (with two transient
    (M, F) buffers), float32 on the CUDA cores. `fused_ffn_bwd.launches`
    counts calls."""
    if x2.device.type != "cuda":
        raise ValueError(f"fused_ffn_bwd: unsupported device {x2.device}")
    m, d = x2.shape
    f = w1.shape[1]
    gy = gy.to(x2.dtype).contiguous()
    if x2.dtype == torch.bfloat16:
        x2, w1, w2, gy = (aligned16(t) for t in (x2, w1, w2, gy))
    lay, buf = bwd_buffers(x2, f, 1)  # partial: the per-block sums of db2
    q, dscale, s0, _ = drop_args(q, None if seed is None else (seed,))
    code = kernel_library().espnet_ffn_bwd(
        x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        gy.data_ptr(), buf["dx"].data_ptr(), ptr(buf["a"]), ptr(buf["dh"]),
        buf["partial"].data_ptr(), buf["dw1p"].data_ptr(),
        buf["dw2p"].data_ptr(), buf["db1p"].data_ptr(), m, d, f, lay.groups,
        lay.rows_per_group, ACTIVATIONS[activation], q, dscale, s0,
        DTYPE_CODES[x2.dtype], stream(x2))
    check_launch("fused_ffn_bwd", code)
    fused_ffn_bwd.launches += 1
    return (buf["dx"], buf["dw1p"].sum(dim=0).to(w1.dtype),
            buf["db1p"].sum(dim=0), buf["dw2p"].sum(dim=0).to(w2.dtype),
            buf["partial"].sum(dim=0)[0])


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
