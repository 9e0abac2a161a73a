"""The conformer conv module's head and tail: CUDA kernels and plain versions.

Port of `fused_prenorm_glu` and `fused_postnorm_proj` and their oracles
`prenorm_glu_reference` and `postnorm_proj_reference`
(`espnet_tpu/ops/pallas_conv_glu.py`), the two matmul-anchored ends of the
conv sub-block around a depthwise conv that runs between them, outside
the kernels:

    head: g = GLU(LN(x) @ W1 + b1)                   W1 (D, 2D)
    tail: y = x_res + drop(swish(LN(g)) @ W2 + b2)   W2 (D, D)

with LayerNorm eps 1e-6. LN(x) and swish(LN(g)) are rounded to the input's
dtype before each product and the sums are taken in float32, as the Pallas
kernels do. The tail drops with the Pallas hash (`ffn_common.keep_mask`,
one int32 seed, 256-row tiles over the flattened rows), bit for bit.

`prenorm_glu` and `postnorm_proj` are the entry points: a CPU tensor goes to
the plain version (whose gradient is torch autograd's), a CUDA tensor to the
kernels in `csrc/conv_glu.cu` through an autograd Function whose backward is
a kernel too (`prenorm_glu_bwd`, `postnorm_proj_bwd`; `.launches` on each of
the four counts its calls); anything else raises. The weight gradients come
back in the weights' dtype, those of b1, b2 and the LayerNorms in float32;
the tail passes dy straight through to x_res. Callers apply the shape gate
`ffn_common.kernel_takes(D, D)` first (the JAX gate `_ffn_tileable(x, d, d,
256)` less its row count): D a multiple of 128, which the kernels take up to
512.

Two designs, picked by dtype in the C library. float32, the parity mode,
runs float32 FMAs on the CUDA cores. bf16 runs its products on tensor cores
(mma.sync with float32 sums; the rounding points above are the operands'):
a row kernel per forward, and per backward a row kernel followed by the
tensor-core A^T B kernel for the weight gradient. bf16 inputs pass through
`aligned16`, as the kernels copy 16-byte chunks. The backward's grid is
Python (`bwd_layout`): row blocks of 32 rows (float32) or
`TC_ROWS_PER_BLOCK[D]` (bf16), whose per-block partial sums are added
here, and the weight gradient's row groups (`wgrad_groups`;
`wgrad_split` in bf16). On the card the wrapper checks that the C
library's rows per block agree with `rows_per_block`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from espnet_tpu_torch.ops.cuda_build import check_launch, kernel_library
from espnet_tpu_torch.ops.ffn_common import (DTYPE_CODES, FP32_ROWS_PER_BLOCK,
                                             TC_ROWS_PER_BLOCK, aligned16,
                                             check_args, check_kernel_dims,
                                             drop_args, keep_mask, layer_norm,
                                             quantize_rate, stream,
                                             wgrad_groups, wgrad_split)


class GluLayout(NamedTuple):
    row_blocks: int      # blocks of the row kernel: rows of `partial`
    groups: int          # row groups of the weight gradient's partial sums
    rows_per_group: int  # group g sums rows [g, g + 1) * rows_per_group


def rows_per_block(d: int, dtype: torch.dtype) -> int:
    """Rows a block of the backward's row kernel owns at width d: 32 in
    float32 (csrc `BM`), `TC_ROWS_PER_BLOCK[d]` in bf16 (csrc `TcGlu`)."""
    if dtype == torch.bfloat16:
        return TC_ROWS_PER_BLOCK[d]
    return FP32_ROWS_PER_BLOCK


def bwd_layout(m: int, d: int, n: int, dtype: torch.dtype) -> GluLayout:
    """The backward's grid for m rows of width d whose weight gradient has
    n columns (2d for the head's W1, d for the tail's W2): the row blocks
    of `rows_per_block`, and the row groups of the A^T B kernel
    (`wgrad_split` on the tensor cores in bf16, `wgrad_groups` in
    float32)."""
    blocks = -(-m // rows_per_block(d, dtype))
    if dtype == torch.bfloat16:
        return GluLayout(blocks, *wgrad_split(m, d, n))
    groups = wgrad_groups(m, d, n)
    return GluLayout(blocks, groups, -(-m // groups))


@functools.lru_cache(maxsize=None)
def _check_rows_per_block(d: int, dtype: torch.dtype) -> None:
    """Raise unless the C library's rows per block at (d, dtype) are
    `rows_per_block`'s: partials sized for another block height would sum
    rows that no block wrote."""
    want = rows_per_block(d, dtype)
    got = kernel_library().espnet_conv_glu_rows_per_block(d,
                                                          DTYPE_CODES[dtype])
    if got != want:
        raise RuntimeError(f"conv_glu: the kernels own {got} rows a block "
                           f"at D={d} {dtype}, rows_per_block {want}")


def _aligned(*ts):
    """bf16 tensors at 16-byte aligned addresses (the tensor-core kernels
    copy 16-byte chunks); float32 ones as they are."""
    if ts[0].dtype != torch.bfloat16:
        return ts
    return tuple(aligned16(t) for t in ts)


def prenorm_glu_plain(x, ln_scale, ln_bias, w1, b1):
    """Plain PyTorch version. x: (..., D); w1: (D, 2D) in x's dtype;
    ln_scale, ln_bias (D,), b1 (2D,) float32. Returns x's shape and dtype."""
    dt = x.dtype
    d = x.shape[-1]
    xn = layer_norm(x.reshape(-1, d).float(), ln_scale, ln_bias)
    h = xn.to(dt).float() @ w1.float() + b1.float()
    a, gate = h[:, :d], h[:, d:]
    return (a * torch.sigmoid(gate)).to(dt).reshape(x.shape)


def postnorm_proj_plain(g, x_res, ln_scale, ln_bias, w2, b2,
                        seed: Optional[int] = None, drop_rate: float = 0.0):
    """Plain PyTorch version. g, x_res: (..., D); w2: (D, D) in g's dtype;
    ln_scale, ln_bias, b2 (D,) float32; seed: one int32 seed when
    drop_rate > 0. Returns g's shape and dtype."""
    _check_seed("postnorm_proj", drop_rate, seed)
    q = quantize_rate(drop_rate)
    dt = g.dtype
    d = g.shape[-1]
    gn = layer_norm(g.reshape(-1, d).float(), ln_scale, ln_bias)
    a = gn * torch.sigmoid(gn)
    z = a.to(dt).float() @ w2.float() + b2.float()
    if q:
        keep = keep_mask(z.shape[0], d, seed, q, g.device)
        z = torch.where(keep, z * (256.0 / (256 - q)), torch.zeros_like(z))
    y = x_res.reshape(-1, d).float() + z
    return y.to(dt).reshape(g.shape)


def _check_seed(name, drop_rate, seed):
    if drop_rate > 0.0 and seed is None:
        raise ValueError(f"{name}: dropout needs an int32 seed")


def _f32(n, device, *shape):
    return torch.empty(n, *shape, dtype=torch.float32, device=device)


def _head_fwd(x2, ln_scale, ln_bias, w1, b1):
    m, d = x2.shape
    x2, w1 = _aligned(x2, w1)
    g = torch.empty_like(x2)
    code = kernel_library().espnet_conv_glu_fwd(
        x2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), g.data_ptr(), m, d,
        DTYPE_CODES[x2.dtype], stream(x2))
    check_launch("prenorm_glu", code)
    prenorm_glu.launches += 1
    return g


def prenorm_glu_bwd(x2, ln_scale, ln_bias, w1, b1, dg):
    """Gradients of the head kernel's forward (the CUDA backward kernels):
    (dx, dln_scale, dln_bias, dw1, db1). `prenorm_glu_bwd.launches` counts
    calls."""
    if x2.device.type != "cuda":
        raise ValueError(f"prenorm_glu_bwd: unsupported device {x2.device}")
    m, d = x2.shape
    x2, w1, dg = _aligned(x2, w1, dg.to(x2.dtype).contiguous())
    _check_rows_per_block(d, x2.dtype)
    lay = bwd_layout(m, d, 2 * d, x2.dtype)
    dev = x2.device
    dx = torch.empty_like(x2)
    xn_buf = torch.empty_like(x2)
    dh_buf = torch.empty(m, 2 * d, dtype=x2.dtype, device=dev)
    partial = _f32(lay.row_blocks, dev, 4, d)  # dLN scale, bias, db1 (2D)
    dw1p = _f32(lay.groups, dev, d, 2 * d)
    code = kernel_library().espnet_conv_glu_bwd(
        x2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), dg.data_ptr(), dx.data_ptr(),
        xn_buf.data_ptr(), dh_buf.data_ptr(), partial.data_ptr(),
        dw1p.data_ptr(), m, d, lay.groups, lay.rows_per_group,
        DTYPE_CODES[x2.dtype], stream(x2))
    check_launch("prenorm_glu_bwd", code)
    prenorm_glu_bwd.launches += 1
    sums = partial.sum(dim=0)
    return (dx, sums[0], sums[1], dw1p.sum(dim=0).to(w1.dtype),
            sums[2:].reshape(2 * d))


class _PrenormGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, ln_scale, ln_bias, w1, b1):
        ctx.save_for_backward(x2, ln_scale, ln_bias, w1, b1)
        return _head_fwd(x2, ln_scale, ln_bias, w1, b1)

    @staticmethod
    def backward(ctx, dg):
        return prenorm_glu_bwd(*ctx.saved_tensors, dg)


def prenorm_glu(x, ln_scale, ln_bias, w1, b1):
    """g = GLU(LN(x) @ w1 + b1): the CUDA kernels on the card, the plain
    version on the CPU. Arguments as in `prenorm_glu_plain`.

    Replaces `fused_prenorm_glu` (espnet_tpu/ops/pallas_conv_glu.py).
    `prenorm_glu.launches` counts forward kernel launches.
    """
    if x.device.type == "cpu":
        return prenorm_glu_plain(x, ln_scale, ln_bias, w1, b1)
    if x.device.type != "cuda":
        raise ValueError(f"prenorm_glu: unsupported device {x.device}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    check_kernel_dims("prenorm_glu", x2, d)
    f32 = torch.float32
    check_args("prenorm_glu", {
        "x": (x2, x2.shape, x2.dtype), "w1": (w1, (d, 2 * d), x2.dtype),
        "ln_scale": (ln_scale, (d,), f32), "ln_bias": (ln_bias, (d,), f32),
        "b1": (b1, (2 * d,), f32)}, x2)
    return _PrenormGLU.apply(x2, ln_scale, ln_bias, w1, b1).reshape(x.shape)


def _tail_fwd(g2, xr2, ln_scale, ln_bias, w2, b2, q, seed):
    m, d = g2.shape
    g2, xr2, w2 = _aligned(g2, xr2, w2)
    y = torch.empty_like(g2)
    q, dscale, s0, _ = drop_args(q, None if seed is None else (seed,))
    code = kernel_library().espnet_conv_tail_fwd(
        g2.data_ptr(), xr2.data_ptr(), ln_scale.data_ptr(),
        ln_bias.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(), m, d,
        q, dscale, s0, DTYPE_CODES[g2.dtype], stream(g2))
    check_launch("postnorm_proj", code)
    postnorm_proj.launches += 1
    return y


def postnorm_proj_bwd(g2, ln_scale, ln_bias, w2, dy, q, seed):
    """Gradients of the tail kernel's forward (the CUDA backward kernels):
    (dg, dln_scale, dln_bias, dw2, db2); x_res's is dy itself.
    `postnorm_proj_bwd.launches` counts calls."""
    if g2.device.type != "cuda":
        raise ValueError(f"postnorm_proj_bwd: unsupported device "
                         f"{g2.device}")
    m, d = g2.shape
    g2, w2, dy = _aligned(g2, w2, dy.to(g2.dtype).contiguous())
    _check_rows_per_block(d, g2.dtype)
    lay = bwd_layout(m, d, d, g2.dtype)
    dev = g2.device
    dg = torch.empty_like(g2)
    a_buf = torch.empty_like(g2)
    dz_buf = torch.empty_like(g2)
    partial = _f32(lay.row_blocks, dev, 3, d)  # dLN scale, dLN bias, db2
    dw2p = _f32(lay.groups, dev, d, d)
    q, dscale, s0, _ = drop_args(q, None if seed is None else (seed,))
    code = kernel_library().espnet_conv_tail_bwd(
        g2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w2.data_ptr(), dy.data_ptr(), dg.data_ptr(), a_buf.data_ptr(),
        dz_buf.data_ptr(), partial.data_ptr(), dw2p.data_ptr(), m, d,
        lay.groups, lay.rows_per_group, q, dscale, s0,
        DTYPE_CODES[g2.dtype], stream(g2))
    check_launch("postnorm_proj_bwd", code)
    postnorm_proj_bwd.launches += 1
    sums = partial.sum(dim=0)
    return dg, sums[0], sums[1], dw2p.sum(dim=0).to(w2.dtype), sums[2]


class _PostnormProj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g2, xr2, ln_scale, ln_bias, w2, b2, q, seed):
        ctx.save_for_backward(g2, ln_scale, ln_bias, w2)
        ctx.opts = (q, seed)
        return _tail_fwd(g2, xr2, ln_scale, ln_bias, w2, b2, q, seed)

    @staticmethod
    def backward(ctx, dy):
        g2, ln_scale, ln_bias, w2 = ctx.saved_tensors
        dg, dls, dlb, dw2, db2 = postnorm_proj_bwd(g2, ln_scale, ln_bias, w2,
                                                   dy, *ctx.opts)
        return dg, dy.to(g2.dtype), dls, dlb, dw2, db2, None, None


def postnorm_proj(g, x_res, ln_scale, ln_bias, w2, b2,
                  seed: Optional[int] = None, drop_rate: float = 0.0):
    """y = x_res + drop(swish(LN(g)) @ w2 + b2): the CUDA kernels on the
    card, the plain version on the CPU. Arguments as in
    `postnorm_proj_plain`.

    Replaces `fused_postnorm_proj` (espnet_tpu/ops/pallas_conv_glu.py).
    `postnorm_proj.launches` counts forward kernel launches.
    """
    if g.device.type == "cpu":
        return postnorm_proj_plain(g, x_res, ln_scale, ln_bias, w2, b2, seed,
                                   drop_rate)
    if g.device.type != "cuda":
        raise ValueError(f"postnorm_proj: unsupported device {g.device}")
    _check_seed("postnorm_proj", drop_rate, seed)
    d = g.shape[-1]
    g2 = g.reshape(-1, d)
    xr2 = x_res.reshape(-1, d)
    check_kernel_dims("postnorm_proj", g2, d)
    f32 = torch.float32
    check_args("postnorm_proj", {
        "g": (g2, g2.shape, g2.dtype), "x_res": (xr2, g2.shape, g2.dtype),
        "w2": (w2, (d, d), g2.dtype), "ln_scale": (ln_scale, (d,), f32),
        "ln_bias": (ln_bias, (d,), f32), "b2": (b2, (d,), f32)}, g2)
    q = quantize_rate(drop_rate)
    y = _PostnormProj.apply(g2, xr2, ln_scale, ln_bias, w2, b2, q,
                            int(seed) if q else None)
    return y.reshape(g.shape)


prenorm_glu.launches = 0
prenorm_glu_bwd.launches = 0
postnorm_proj.launches = 0
postnorm_proj_bwd.launches = 0
