"""The whole conformer conv sub-block in one kernel: CUDA kernels and plain
version.

Port of `fused_conv_module` and its oracle `conv_module_reference`
(`espnet_tpu/ops/pallas_conv_module.py`):

    y = x + drop(PW2(swish(LN2(DW(mask * GLU(PW1(LN1(x))))))))

per utterance, with LayerNorm eps 1e-6, PW1 (D, 2D), a SAME depthwise conv
of odd kernel size k over time (taps (k, D), bias (D,)) and PW2 (D, D).
LN1(x) and the swish are rounded to x's dtype before their products; the
GLU output u stays float32 and the depthwise conv runs in float32 on the
taps as given (the bench model's bf16-rounded taps), as in the Pallas
kernel, which differs from the split route (`ops.conv_glu`), whose conv
runs in g's dtype. Frames past an utterance's length are computed, not
zeroed: u is zeroed there by the mask, and the output is x + drop(PW2(...))
of that, as the Pallas kernel computes it.

Dropout is the Pallas hash with one int32 seed whose tile is one utterance:
the tile id is the utterance index b and frame t, column c hashes counter
t * D + c (`ffn_common.keep_mask(B * T, D, seed, q, tile_rows=T)`), bit for
bit.

`conv_module` is the entry point: a CPU tensor goes to `conv_module_plain`
(torch autograd's gradient), a CUDA tensor to the kernels in
`csrc/conv_module.cu` through an autograd Function whose backward is a
kernel sequence too (`conv_module_bwd`); anything else raises. As in the
JAX package this route has no shape gate: the kernels take every d_model up
to 512 and every odd kernel size up to 31; past that they raise.
`conv_module.launches` and `conv_module_bwd.launches` count calls. The
parameter gradients come back in the parameters' dtypes.

The kernels' grid is Python (`bwd_layout`): a block owns `tile_rows`
frames of one utterance (32 in float32, on the CUDA cores; 64 at D <= 256
and 32 above in bf16, on the tensor cores), recomputes the head for
`head_rows` rows around them, and leaves per-tile partial sums that are
added here in a fixed order. In bf16 the kernels take the weights and
write their scratch padded to DP = D rounded up to 128 (`pad_weights`), so
the weight gradients run on the tensor-core A^T B kernel over the row
groups of `ffn_common.wgrad_split`. On the card the wrapper checks that the
C library's tile rows agree with `bwd_layout`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from espnet_tpu_torch.ops.cuda_build import check_launch, kernel_library
from espnet_tpu_torch.ops.ffn_common import (DTYPE_CODES, aligned16,
                                             check_args, drop_args, keep_mask,
                                             layer_norm, quantize_rate, stream,
                                             wgrad_groups, wgrad_split)

MAX_MODEL_DIM = 512  # the kernels' widest d_model (csrc/conv_module.cu)
MAX_KERNEL_SIZE = 31  # their longest depthwise kernel (the halo's rows)
FP32_TILE_ROWS = 32  # frames a float32 block owns (csrc `TT`)
TC_TILE_ROWS = {128: 64, 256: 64, 384: 32, 512: 32}  # bf16, by DP (`TcConv`)


class ConvLayout(NamedTuple):
    tile_rows: int     # frames a block owns
    tiles: int         # blocks, B * ceil(T / tile_rows): rows of the partials
    halo: int          # p = (k - 1) // 2 frames on each side of a tile
    head_rows: int     # rows of the head a forward block recomputes
    dp: int            # D rounded up to 128: the kernels' width
    width: int         # columns of the scratch: DP (bf16) or D (float32)
    g1: int            # row groups of dW1's partial sums ...
    r1: int            # ... of r1 frames each (the last one cut at B * T)
    g2: int            # and of dW2's
    r2: int


def padded_dim(d: int) -> int:
    """DP: d rounded up to the kernels' multiple of 128."""
    return -(-d // 128) * 128


def bwd_layout(b: int, t: int, d: int, k: int,
               dtype: torch.dtype) -> ConvLayout:
    """The kernels' grid and scratch for B utterances of T frames at width
    d and kernel size k. float32: 32-frame tiles whose head runs in 32-row
    sub-tiles, buffers D wide, the CUDA-core weight gradient's groups.
    bf16: `TC_TILE_ROWS[DP]`-frame tiles whose head covers TT + 2p rows
    rounded up to 16, buffers DP wide, `wgrad_split`'s groups."""
    dp = padded_dim(d)
    m, p = b * t, (k - 1) // 2
    if dtype == torch.bfloat16:
        tt = TC_TILE_ROWS[dp]
        g1, r1 = wgrad_split(m, dp, 2 * dp)
        g2, r2 = wgrad_split(m, dp, dp)
        return ConvLayout(tt, b * -(-t // tt), p, -(-(tt + 2 * p) // 16) * 16,
                          dp, dp, g1, r1, g2, r2)
    tt = FP32_TILE_ROWS
    g1, g2 = wgrad_groups(m, d, 2 * d), wgrad_groups(m, d, d)
    return ConvLayout(tt, b * -(-t // tt), p, -(-(tt + 2 * p) // tt) * tt,
                      dp, d, g1, -(-m // g1), g2, -(-m // g2))


def pad_weights(w1, w2):
    """w1 (D, 2D) and w2 (D, D) as the bf16 kernels take them: w1 (DP,
    2DP) with the g half from column DP, w2 (DP, DP), zeros past D; the
    tensors themselves (16-byte aligned) when D = DP."""
    d = w2.shape[0]
    dp = padded_dim(d)
    if d == dp:
        return aligned16(w1), aligned16(w2)
    w1p = w1.new_zeros(dp, 2 * dp)
    w1p[:d, :d] = w1[:, :d]
    w1p[:d, dp:dp + d] = w1[:, d:]
    w2p = w2.new_zeros(dp, dp)
    w2p[:d, :d] = w2
    return w1p, w2p


def conv_module_plain(x, pad_mask, ln1_scale, ln1_bias, w1, b1, dw, db,
                      ln2_scale, ln2_bias, w2, b2, seed: Optional[int] = None,
                      drop_rate: float = 0.0, kernel_size: int = 31):
    """Plain PyTorch version. x: (B, T, D); pad_mask: (B, T) True = valid;
    w1 (D, 2D), dw (kernel_size, D), w2 (D, D) in x's dtype; the LayerNorm
    parameters, b1 (2D,), db and b2 (D,) float32; seed: one int32 seed when
    drop_rate > 0. Returns x's shape and dtype."""
    _check_options(drop_rate, seed, kernel_size, dw)
    q = quantize_rate(drop_rate)
    dt = x.dtype
    bsz, t, d = x.shape
    xf = x.float()
    xn = layer_norm(xf, ln1_scale, ln1_bias)
    h = xn.to(dt).float() @ w1.float() + b1.float()
    u = h[..., :d] * torch.sigmoid(h[..., d:]) * pad_mask[..., None].float()
    c = torch.nn.functional.conv1d(
        u.transpose(1, 2), dw.float().t()[:, None, :],
        padding=kernel_size // 2, groups=d).transpose(1, 2) + db.float()
    cn = layer_norm(c, ln2_scale, ln2_bias)
    s = cn * torch.sigmoid(cn)
    z = s.to(dt).float() @ w2.float() + b2.float()
    if q:
        keep = keep_mask(bsz * t, d, seed, q, x.device,
                         tile_rows=t).reshape(bsz, t, d)
        z = torch.where(keep, z * (256.0 / (256 - q)), torch.zeros_like(z))
    return (xf + z).to(dt)


def _check_options(drop_rate, seed, kernel_size, dw):
    if drop_rate > 0.0 and seed is None:
        raise ValueError("conv_module: dropout needs an int32 seed")
    if kernel_size % 2 == 0 or dw.shape[0] != kernel_size:
        raise ValueError(f"conv_module: kernel_size {kernel_size} must be "
                         f"odd and match the taps' {dw.shape[0]} rows")


def check_kernel_shapes(x, kernel_size: int) -> None:
    """Raise for what the kernels do not take: a dtype other than float32
    and bfloat16, a d_model past 512 or a kernel size past 31 (queued in
    ROADMAP.md)."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"conv_module: unsupported dtype {x.dtype}")
    d = x.shape[-1]
    if not 1 <= d <= MAX_MODEL_DIM or kernel_size > MAX_KERNEL_SIZE:
        raise ValueError(f"conv_module: the kernels take D up to "
                         f"{MAX_MODEL_DIM} and kernel sizes up to "
                         f"{MAX_KERNEL_SIZE}, not D={d}, k={kernel_size}")


@functools.lru_cache(maxsize=None)
def _check_tile_rows(d: int, dtype: torch.dtype) -> None:
    """Raise unless the C library's tile rows at (d, dtype) are
    `bwd_layout`'s."""
    want = bwd_layout(1, 1, d, 1, dtype).tile_rows
    got = kernel_library().espnet_conv_module_tile_rows(d, DTYPE_CODES[dtype])
    if got != want:
        raise RuntimeError(f"conv_module: the kernels own {got} frames a "
                           f"block at D={d} {dtype}, bwd_layout {want}")


def _kernel_weights(x, params):
    """The forward's parameters with w1 and w2 as the kernels take them."""
    _check_tile_rows(x.shape[-1], x.dtype)
    if x.dtype != torch.bfloat16:
        return params
    ln1s, ln1b, w1, b1, dw, db, ln2s, ln2b, w2, b2 = params
    w1p, w2p = pad_weights(w1, w2)
    return ln1s, ln1b, w1p, b1, dw, db, ln2s, ln2b, w2p, b2


def _kernel_fwd(x, mask, params, q, seed):
    bsz, t, d = x.shape
    k = params[4].shape[0]
    y = torch.empty_like(x)
    q, dscale, s0, _ = drop_args(q, None if seed is None else (seed,))
    code = kernel_library().espnet_conv_module_fwd(
        x.data_ptr(), mask.data_ptr(),
        *(p.data_ptr() for p in _kernel_weights(x, params)),
        y.data_ptr(), bsz, t, d, k, q, dscale, s0, DTYPE_CODES[x.dtype],
        stream(x))
    check_launch("conv_module", code)
    conv_module.launches += 1
    return y


def conv_module_bwd(x, mask, params, gy, q, seed):
    """Gradients of the kernel's forward (the CUDA backward kernels):
    (dx, dln1_scale, dln1_bias, dw1, db1, ddw, ddb, dln2_scale, dln2_bias,
    dw2, db2), the weights' in their dtype. `params` are the forward's
    (ln1_scale, ln1_bias, w1, b1, dw, db, ln2_scale, ln2_bias, w2, b2);
    mask is float32 (B, T). `conv_module_bwd.launches` counts calls."""
    if x.device.type != "cuda":
        raise ValueError(f"conv_module_bwd: unsupported device {x.device}")
    bsz, t, d = x.shape
    ln1s, ln1b, w1, b1, dw, db, ln2s, ln2b, w2, _ = _kernel_weights(x,
                                                                    params)
    k = dw.shape[0]
    m = bsz * t
    gy = gy.to(x.dtype).contiguous()
    dev = x.device
    lay = bwd_layout(bsz, t, d, k, x.dtype)
    w = lay.width

    def f32(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=dev)

    def same(*shape):
        return torch.empty(*shape, dtype=x.dtype, device=dev)

    dx = torch.empty_like(x)
    u_buf, dc_buf = f32(m, w), f32(m, w)
    s_buf, dz_buf, xn_buf, dh_buf = same(m, w), same(m, w), same(m, w), \
        same(m, 2 * w)
    part_a = f32(lay.tiles, 4, d)  # dLN2 scale, dLN2 bias, ddb, db2
    part_b = f32(lay.tiles, 4, d)  # dLN1 scale, dLN1 bias, db1 (2D)
    ddwp = f32(lay.tiles, k, d)
    dw1p, dw2p = f32(lay.g1, w, 2 * w), f32(lay.g2, w, w)
    q, dscale, s0, _ = drop_args(q, None if seed is None else (seed,))
    code = kernel_library().espnet_conv_module_bwd(
        x.data_ptr(), mask.data_ptr(),
        *(p.data_ptr() for p in (ln1s, ln1b, w1, b1, dw, db, ln2s, ln2b,
                                 w2)),
        gy.data_ptr(), dx.data_ptr(),
        *(b.data_ptr() for b in (u_buf, dc_buf, s_buf, dz_buf, xn_buf,
                                 dh_buf, part_a, part_b, ddwp, dw1p, dw2p)),
        bsz, t, d, k, lay.g1, lay.r1, lay.g2, lay.r2, q, dscale, s0,
        DTYPE_CODES[x.dtype], stream(x))
    check_launch("conv_module_bwd", code)
    conv_module_bwd.launches += 1
    a, b = part_a.sum(dim=0), part_b.sum(dim=0)
    dw1, dw2 = dw1p.sum(dim=0), dw2p.sum(dim=0)
    if w != d:  # the padded columns of the bf16 design
        dw1 = torch.cat([dw1[:d, :d], dw1[:d, w:w + d]], dim=1)
        dw2 = dw2[:d, :d]
    return (dx, b[0], b[1], dw1.to(params[2].dtype), b[2:].reshape(2 * d),
            ddwp.sum(dim=0).to(dw.dtype), a[2], a[0], a[1],
            dw2.to(params[8].dtype), a[3])


class _ConvModule(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, *rest):
        params, (q, seed) = rest[:10], rest[10:]
        ctx.save_for_backward(x, mask, *params)
        ctx.opts = (q, seed)
        return _kernel_fwd(x, mask, params, q, seed)

    @staticmethod
    def backward(ctx, gy):
        x, mask, *params = ctx.saved_tensors
        grads = conv_module_bwd(x, mask, params, gy, *ctx.opts)
        return (grads[0], None) + grads[1:] + (None, None)


def conv_module(x, pad_mask, ln1_scale, ln1_bias, w1, b1, dw, db, ln2_scale,
                ln2_bias, w2, b2, seed: Optional[int] = None,
                drop_rate: float = 0.0, kernel_size: int = 31):
    """The whole conv sub-block: the CUDA kernels on the card, the plain
    version on the CPU. Arguments as in `conv_module_plain`.

    Replaces `fused_conv_module` (espnet_tpu/ops/pallas_conv_module.py).
    `conv_module.launches` counts forward kernel launches.
    """
    args = (x, pad_mask, ln1_scale, ln1_bias, w1, b1, dw, db, ln2_scale,
            ln2_bias, w2, b2)
    if x.device.type == "cpu":
        return conv_module_plain(*args, seed, drop_rate, kernel_size)
    if x.device.type != "cuda":
        raise ValueError(f"conv_module: unsupported device {x.device}")
    _check_options(drop_rate, seed, kernel_size, dw)
    check_kernel_shapes(x, kernel_size)
    bsz, t, d = x.shape
    f32, dt = torch.float32, x.dtype
    check_args("conv_module", {
        "x": (x, x.shape, dt), "pad_mask": (pad_mask, (bsz, t), torch.bool),
        "ln1_scale": (ln1_scale, (d,), f32), "ln1_bias": (ln1_bias, (d,), f32),
        "w1": (w1, (d, 2 * d), dt), "b1": (b1, (2 * d,), f32),
        "dw": (dw, (kernel_size, d), dt), "db": (db, (d,), f32),
        "ln2_scale": (ln2_scale, (d,), f32), "ln2_bias": (ln2_bias, (d,), f32),
        "w2": (w2, (d, d), dt), "b2": (b2, (d,), f32)}, x)
    q = quantize_rate(drop_rate)
    return _ConvModule.apply(x, pad_mask.to(f32), *args[2:], q,
                             int(seed) if q else None)


conv_module.launches = 0
conv_module_bwd.launches = 0
