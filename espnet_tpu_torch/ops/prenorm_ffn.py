"""Pre-norm position-wise FFN with residual and hash dropout: CUDA kernels
and plain version.

Port of `fused_prenorm_ffn` and its oracle `prenorm_ffn_reference`
(`espnet_tpu/ops/pallas_ffn.py`):

    y = x + residual_scale * drop1(drop0(act(LN(x) @ W1 + b1)) @ W2 + b2)

with LayerNorm eps 1e-6 and act swish (the conformer's macaron FFN, scale
0.5) or relu. Dropout is the Pallas kernel's counter hash (`_keep_mask`) bit
for bit, so the port and the JAX package drop the same elements for the same
two int32 seeds: `keep_mask` is its plain version, and the kernels compute
it inline in forward and backward alike (nothing is stored).

`prenorm_ffn` is the entry point: a CPU tensor goes to `prenorm_ffn_plain`
(whose gradient is torch autograd's), a CUDA tensor to the kernels in
`csrc/prenorm_ffn.cu` through an autograd Function (forward kernel; backward
kernel pair, counted once per backward call by `prenorm_ffn_bwd.launches`),
which keep the (M, d_ff) hidden activation out of device memory; anything
else raises. Callers apply the shape gate `ffn_common.kernel_takes` first.
Both round LN(x) and act(.) to x's dtype before each product,
as the Pallas kernel does, and accumulate in float32. The weight gradients
come back in the weights' dtype, as the Pallas kernel's do.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from espnet_tpu_torch.ops.cuda_build import check_launch, kernel_library
from espnet_tpu_torch.ops.ffn_common import (ACTIVATIONS, DTYPE_CODES, act,
                                             aligned16, bwd_buffers,
                                             check_args, check_kernel_dims,
                                             drop_args, keep_mask,
                                             layer_norm, ptr, quantize_rate,
                                             stream)


def _check_options(drop_rate: float, seeds, activation: str) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {activation!r}")
    if drop_rate > 0.0 and (seeds is None or len(seeds) != 2):
        raise ValueError("prenorm_ffn: dropout needs two int32 seeds")


def prenorm_ffn_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                      activation: str = "swish", residual_scale: float = 1.0,
                      drop_rate: float = 0.0,
                      seeds: Optional[Sequence[int]] = None):
    """Plain PyTorch version. x: (..., D); w1: (D, F); w2: (F, D) in x's
    dtype; ln_scale, ln_bias, b1, b2 float32; seeds: two int32 seeds
    (streams 0 and 1) when drop_rate > 0."""
    _check_options(drop_rate, seeds, activation)
    q = quantize_rate(drop_rate)
    dt = x.dtype
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    m = xf.shape[0]
    xn = layer_norm(xf, ln_scale, ln_bias)
    h = xn.to(dt).float() @ w1.float() + b1.float()
    a = act(h, activation)
    scale = 256.0 / (256 - q) if q else 1.0
    if q:
        keep0 = keep_mask(m, a.shape[1], seeds[0], q, x.device)
        a = torch.where(keep0, a * scale, torch.zeros_like(a))
    z = a.to(dt).float() @ w2.float() + b2.float()
    if q:
        keep1 = keep_mask(m, d, seeds[1], q, x.device)
        z = torch.where(keep1, z * scale, torch.zeros_like(z))
    return (xf + residual_scale * z).to(dt).reshape(x.shape)


def _check_cuda_args(x2, ln_scale, ln_bias, w1, b1, w2, b2):
    m, d = x2.shape
    f = w1.shape[-1]
    check_kernel_dims("prenorm_ffn", x2, f)
    f32 = torch.float32
    check_args("prenorm_ffn", {
        "x": (x2, (m, d), x2.dtype), "w1": (w1, (d, f), x2.dtype),
        "w2": (w2, (f, d), x2.dtype), "ln_scale": (ln_scale, (d,), f32),
        "ln_bias": (ln_bias, (d,), f32), "b1": (b1, (f,), f32),
        "b2": (b2, (d,), f32),
    }, x2)


def _kernel_fwd(x2, ln_scale, ln_bias, w1, b1, w2, b2, activation,
                residual_scale, q, seeds):
    if x2.dtype == torch.bfloat16:  # tensor cores: 16-byte copies
        x2, w1, w2 = (aligned16(t) for t in (x2, w1, w2))
    y = torch.empty_like(x2)
    q, dscale, s0, s1 = drop_args(q, seeds)
    code = kernel_library().espnet_prenorm_ffn_fwd(
        x2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), x2.shape[0], x2.shape[1], w1.shape[1],
        float(residual_scale), ACTIVATIONS[activation], q, dscale, s0, s1,
        DTYPE_CODES[x2.dtype], stream(x2))
    check_launch("prenorm_ffn", code)
    prenorm_ffn.launches += 1
    return y


def prenorm_ffn_bwd(x2, ln_scale, ln_bias, w1, b1, w2, gy, activation,
                    residual_scale, q, seeds):
    """Gradients of the kernel's forward (the CUDA backward kernel pair):
    (dx, dln_scale, dln_bias, dw1, db1, dw2, db2). bf16 runs on tensor
    cores (with two transient (M, F) buffers), float32 on the CUDA cores.
    `prenorm_ffn_bwd.launches` counts calls."""
    if x2.device.type != "cuda":
        raise ValueError(f"prenorm_ffn_bwd: unsupported device {x2.device}")
    m, d = x2.shape
    f = w1.shape[1]
    gy = gy.to(x2.dtype).contiguous()
    if x2.dtype == torch.bfloat16:
        x2, w1, w2, gy = (aligned16(t) for t in (x2, w1, w2, gy))
    lay, buf = bwd_buffers(x2, f, 3)
    xn_buf = torch.empty_like(x2)
    dz_buf = torch.empty_like(x2)
    q, dscale, s0, s1 = drop_args(q, seeds)
    code = kernel_library().espnet_prenorm_ffn_bwd(
        x2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), gy.data_ptr(),
        buf["dx"].data_ptr(), xn_buf.data_ptr(), dz_buf.data_ptr(),
        ptr(buf["a"]), ptr(buf["dh"]), buf["partial"].data_ptr(),
        buf["dw1p"].data_ptr(), buf["dw2p"].data_ptr(),
        buf["db1p"].data_ptr(), m, d, f, lay.groups, lay.rows_per_group,
        float(residual_scale), ACTIVATIONS[activation], q, dscale, s0, s1,
        DTYPE_CODES[x2.dtype], stream(x2))
    check_launch("prenorm_ffn_bwd", code)
    prenorm_ffn_bwd.launches += 1
    sums = buf["partial"].sum(dim=0)
    return (buf["dx"], sums[0], sums[1], buf["dw1p"].sum(dim=0).to(w1.dtype),
            buf["db1p"].sum(dim=0), buf["dw2p"].sum(dim=0).to(w2.dtype),
            sums[2])


class _PrenormFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, ln_scale, ln_bias, w1, b1, w2, b2, activation,
                residual_scale, q, seeds):
        ctx.save_for_backward(x2, ln_scale, ln_bias, w1, b1, w2)
        ctx.opts = (activation, residual_scale, q, seeds)
        return _kernel_fwd(x2, ln_scale, ln_bias, w1, b1, w2, b2, activation,
                           residual_scale, q, seeds)

    @staticmethod
    def backward(ctx, gy):
        x2, ln_scale, ln_bias, w1, b1, w2 = ctx.saved_tensors
        grads = prenorm_ffn_bwd(x2, ln_scale, ln_bias, w1, b1, w2, gy,
                                *ctx.opts)
        return grads + (None,) * 4


def prenorm_ffn(x, ln_scale, ln_bias, w1, b1, w2, b2,
                activation: str = "swish", residual_scale: float = 1.0,
                drop_rate: float = 0.0,
                seeds: Optional[Sequence[int]] = None):
    """Pre-norm FFN: the CUDA kernels on the card, the plain version on the
    CPU. Arguments as in `prenorm_ffn_plain`; returns x's shape and dtype.

    Replaces `fused_prenorm_ffn` (espnet_tpu/ops/pallas_ffn.py).
    `prenorm_ffn.launches` counts forward kernel launches.
    """
    if x.device.type == "cpu":
        return prenorm_ffn_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                 activation, residual_scale, drop_rate, seeds)
    if x.device.type != "cuda":
        raise ValueError(f"prenorm_ffn: unsupported device {x.device}")
    _check_options(drop_rate, seeds, activation)
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    _check_cuda_args(x2, ln_scale, ln_bias, w1, b1, w2, b2)
    q = quantize_rate(drop_rate)
    y = _PrenormFFN.apply(x2, ln_scale, ln_bias, w1, b1, w2, b2, activation,
                          float(residual_scale), q,
                          tuple(seeds) if q else None)
    return y.reshape(x.shape)


prenorm_ffn.launches = 0
prenorm_ffn_bwd.launches = 0
