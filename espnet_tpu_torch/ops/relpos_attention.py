"""Transformer-XL relative-position attention: CUDA kernels and plain version.

Port of `espnet_tpu/ops/pallas_relpos_attention.py` (`relpos_flash_attention`
and its oracle `relpos_attention_reference`), forward and backward:

    score[b,h,i,j] = ((q+u)·k_j + (q+v)·p[T-1-(i-j)]) / sqrt(D) + kbias[b,j]

`relpos_attention` is the entry point: a CPU tensor goes to
`relpos_attention_plain` (whose gradient is torch autograd's), a CUDA tensor
to the kernels in `csrc/relpos_attention.cu` (which never build the
(B, H, T, 2T-1) tensor) through an autograd Function: the forward kernel
also writes each query row's softmax max and sum, and the backward kernels
(`relpos_attention_bwd`: two passes and the fold of the dp slabs on the
card) give dq, dk, dv and dp; du and dv-bias are sums of the q gradients'
two parts, taken here as the JAX package does. `bwd_layout` sizes the
backward's scratch; `slab_p_row` and `fold_slabs` are the fold's index
arithmetic, which the fold kernel repeats.
Anything else raises. `kernel_takes` is the shape gate callers apply
first: the JAX module's (`dk % 8 == 0`, espnet_tpu/models/attention.py).
The kernels are built for head dims 32, 64 and 128; a smaller head dim
the gate passes is zero-padded to the next of them (the scores, and so
the result, do not change; the scale stays 1/sqrt of the real head dim),
and one past 128 raises on the card. float32 runs on the CUDA cores, bf16
on tensor cores (forward and backward); both sum in float32 and return q's
dtype. In bf16 the kernels round q+u, q+v, in the forward the unnormalised
probabilities before P·V and in the backward the probabilities and dS to
bf16 before their products, as the Pallas kernels do; the plain version
computes in float32 throughout. The key bias is clamped at
NEG = finfo(f32).min/2, as the Pallas kernel pads with NEG: a query whose
keys are all masked averages v uniformly instead of giving NaN.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from espnet_tpu_torch.ops.cuda_build import check_launch, kernel_library
from espnet_tpu_torch.ops.ffn_common import aligned16

NEG = float(np.finfo(np.float32).min) / 2

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (32, 64, 128)  # the instantiations in csrc/
_BLOCK = 64  # query rows of a block and keys of a tile (BQ, BK)
# blocks of the tensor-core pass 1 to aim at: about four waves of one block
# per SM on 132 SMs; a block sums the dp rows of per_group batch elements
_DQ_BLOCKS = 512


class BwdLayout(NamedTuple):
    blocks: int        # query blocks of 64 rows, = key tiles
    slab_rows: int     # rows of one dp slab: 64 blocks + 63
    padded: int        # Tp = 64 blocks: the side of the P and dS planes
    per_group: int     # batch elements one slab sums
    groups: int        # slabs per (head, query block)
    tensor_cores: bool  # bf16: pass 1 stores P and dS as (B, H, Tp, Tp)


def bwd_layout(b: int, h: int, t: int, dtype: torch.dtype) -> BwdLayout:
    """The backward's grid and scratch for (B, H, T) in `dtype`. float32
    (CUDA cores) keeps one dp slab per batch element; bf16 (tensor cores)
    lets a pass-1 block walk per_group elements while the grid keeps about
    `_DQ_BLOCKS` blocks."""
    nq = -(-t // _BLOCK)
    tc = dtype == torch.bfloat16
    per = max(1, min(b, b * h * nq // _DQ_BLOCKS)) if tc else 1
    return BwdLayout(nq, _BLOCK * nq + _BLOCK - 1, _BLOCK * nq, per,
                     -(-b // per), tc)


def slab_p_row(t: int, n: int) -> int:
    """The p row of slab row 0 of query block n: window row w of key tile
    kt of that block is p row T-1-(64n+63) + 64kt + w, and the tile's
    window rows 64.. carry into the next tile as its rows 0.., so slab row
    64kt + w is p row slab_p_row(t, n) + 64kt + w (rows outside [0, 2T-1)
    hold zeros)."""
    return t - 1 - (_BLOCK * n + _BLOCK - 1)


def fold_slabs(slabs: torch.Tensor, t: int) -> torch.Tensor:
    """dp (H, 2T-1, D) from slabs (groups, H, blocks, slab rows, D): the sum
    over the groups, overlap-added at each block's `slab_p_row`. The plain
    version of the fold kernel (`relpos_dp_fold_kernel`)."""
    _, h, nq, rows, d = slabs.shape
    per_block = slabs.sum(dim=0)
    dp = torch.zeros(h, 2 * t - 1, d, dtype=slabs.dtype, device=slabs.device)
    for n in range(nq):
        off = slab_p_row(t, n)
        lo, hi = max(0, -off), min(rows, 2 * t - 1 - off)
        dp[:, off + lo:off + hi] += per_block[:, n, lo:hi]
    return dp


def kernel_takes(head_dim: int) -> bool:
    """The shape gate, decided before any launch: True sends the call to the
    kernels, False to `relpos_attention_plain`."""
    return head_dim > 0 and head_dim % 8 == 0


def kernel_head_dim(head_dim: int) -> int:
    """The kernel head dim a call of this head dim runs at (zero padding
    up to it); raises past the largest."""
    for dim in KERNEL_HEAD_DIMS:
        if head_dim <= dim:
            return dim
    raise ValueError(f"the attention kernels take head dims up to "
                     f"{KERNEL_HEAD_DIMS[-1]}, not {head_dim}")


def key_bias(lengths_bias: Optional[torch.Tensor], b: int, t: int,
             device: torch.device) -> torch.Tensor:
    """Additive key bias broadcastable to (B, 1, 1, T) -> (B, T) float32,
    clamped at NEG."""
    if lengths_bias is None:
        return torch.zeros(b, t, dtype=torch.float32, device=device)
    kb = torch.broadcast_to(lengths_bias.float(), (b, 1, 1, t)).reshape(b, t)
    return kb.clamp(min=NEG)


def relpos_attention_plain(q, k, v, p, pos_bias_u, pos_bias_v,
                           lengths_bias=None):
    """Plain PyTorch version (materialises the (B, H, T, 2T-1) bd term).

    q, k, v: (B, H, T, D); p: (H, 2T-1, D) ordered positive-to-negative
    relative positions (row T-1-r holds offset r); pos_bias_u/v: (H, D);
    lengths_bias: additive key bias broadcastable to (B, 1, 1, T) or None.
    """
    b, h, t, d = q.shape
    qf = q.float()
    qu = qf + pos_bias_u.float()[None, :, None, :]
    qv = qf + pos_bias_v.float()[None, :, None, :]
    ac = qu @ k.float().transpose(-1, -2)
    bd_full = torch.einsum("bhqd,hkd->bhqk", qv, p.float())  # (B,H,T,2T-1)
    ar = torch.arange(t, device=q.device)
    idx = (t - 1) - ar[:, None] + ar[None, :]  # row T-1-(i-j)
    bd = bd_full.gather(-1, idx.expand(b, h, t, t))
    scores = (ac + bd) / math.sqrt(d)
    scores = scores + key_bias(lengths_bias, b, t, q.device)[:, None, None, :]
    w = torch.softmax(scores, dim=-1)
    return (w @ v.float()).to(q.dtype)


def _check_cuda_args(q, k, v, p, pos_bias_u, pos_bias_v):
    b, h, t, d = q.shape
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"relpos_attention: unsupported dtype {q.dtype}")
    kernel_head_dim(d)
    expect = {  # name: (tensor, shape, dtype or None for any float)
        "q": (q, (b, h, t, d), q.dtype), "k": (k, (b, h, t, d), q.dtype),
        "v": (v, (b, h, t, d), q.dtype), "p": (p, (h, 2 * t - 1, d), q.dtype),
        "pos_bias_u": (pos_bias_u, (h, d), None),
        "pos_bias_v": (pos_bias_v, (h, d), None),
    }
    for name, (x, shape, dtype) in expect.items():
        if x.device != q.device:
            raise ValueError(f"relpos_attention: {name} is on {x.device}, "
                             f"q on {q.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"relpos_attention: {name} has shape "
                             f"{tuple(x.shape)}, expected {shape}")
        if dtype is not None and x.dtype != dtype:
            raise TypeError(f"relpos_attention: {name} is {x.dtype}, "
                            f"expected {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"relpos_attention: {name} is not contiguous")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _kernel_fwd(q, k, v, p, u, vb, kb, scale: float, with_stats: bool):
    b, h, t, d = q.shape
    if q.dtype == torch.bfloat16:  # the tensor-core kernel's 16-byte copies
        q, k, v, p = (aligned16(x) for x in (q, k, v, p))
    out = torch.empty_like(q)
    stats = (torch.empty(b, h, t, 2, dtype=torch.float32, device=q.device)
             if with_stats else None)
    code = kernel_library().espnet_relpos_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        u.data_ptr(), vb.data_ptr(), kb.data_ptr(), out.data_ptr(),
        None if stats is None else stats.data_ptr(),
        b, h, t, d, scale, DTYPE_CODES[q.dtype], _stream(q))
    check_launch("relpos_attention", code)
    relpos_attention.launches += 1
    return out, stats


def _kernel_bwd(q, k, v, p, u, vb, kb, out, stats, dout, scale: float):
    """The backward kernels' float32 (dqu, dqv, dk, dv, dp) for the
    forward's saved tensors (head dim padded to a kernel's); dout in q's
    dtype. Counts one `relpos_attention_bwd.launches`."""
    b, h, t, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"relpos_attention_bwd: head dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    lay = bwd_layout(b, h, t, q.dtype)
    f32 = dict(dtype=torch.float32, device=q.device)
    dqu, dqv, dk, dv = (torch.empty(b, h, t, d, **f32) for _ in range(4))
    slabs = torch.empty(lay.groups, h, lay.blocks, lay.slab_rows, d, **f32)
    dp = torch.empty(h, 2 * t - 1, d, **f32)
    pbuf = dsbuf = None
    if lay.tensor_cores:
        q, k, v, p, dout = (aligned16(x) for x in (q, k, v, p, dout))
        pbuf = torch.empty(b, h, lay.padded, lay.padded, dtype=q.dtype,
                           device=q.device)
        dsbuf = torch.empty_like(pbuf)
    code = kernel_library().espnet_relpos_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        u.data_ptr(), vb.data_ptr(), kb.data_ptr(), dout.data_ptr(),
        stats.data_ptr(), delta.data_ptr(), dqu.data_ptr(), dqv.data_ptr(),
        slabs.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if pbuf is None else pbuf.data_ptr(),
        None if dsbuf is None else dsbuf.data_ptr(), dp.data_ptr(), b, h, t,
        d, lay.per_group, scale, DTYPE_CODES[q.dtype], _stream(q))
    check_launch("relpos_attention_bwd", code)
    relpos_attention_bwd.launches += 1
    return dqu, dqv, dk, dv, dp


def relpos_attention_bwd(q, k, v, p, u, vb, kb, out, stats, dout,
                         scale: float):
    """Gradients (dq, dk, dv, dp, du, dvb) of the kernel's forward, from the
    CUDA backward kernels (float32 on the CUDA cores, bf16 on tensor cores
    with two transient (B, H, Tp, Tp) bf16 planes); dq, dk, dv, dp in q's
    dtype, du and dvb float32. `relpos_attention_bwd.launches` counts
    calls."""
    dout = dout.to(q.dtype).contiguous()
    dqu, dqv, dk, dv, dp = _kernel_bwd(q, k, v, p, u, vb, kb, out, stats,
                                       dout, scale)
    dt = q.dtype
    return ((dqu + dqv).to(dt), dk.to(dt), dv.to(dt), dp.to(p.dtype),
            dqu.sum(dim=(0, 2)), dqv.sum(dim=(0, 2)))


class _RelposAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, p, u, vb, kb, scale):
        out, stats = _kernel_fwd(q, k, v, p, u, vb, kb, scale,
                                 with_stats=True)
        ctx.save_for_backward(q, k, v, p, u, vb, kb, out, stats)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv, dp, du, dvb = relpos_attention_bwd(*ctx.saved_tensors,
                                                       dout, ctx.scale)
        return dq, dk, dv, dp, du, dvb, None, None


def relpos_attention(q, k, v, p, pos_bias_u, pos_bias_v, lengths_bias=None):
    """Rel-pos attention: the CUDA kernel on the card, the plain version on
    the CPU. Shapes as in `relpos_attention_plain`; returns (B, H, T, D).

    Replaces `relpos_flash_attention` (espnet_tpu/ops/
    pallas_relpos_attention.py). `relpos_attention.launches` counts forward
    kernel launches.
    """
    if q.device.type == "cpu":
        return relpos_attention_plain(q, k, v, p, pos_bias_u, pos_bias_v,
                                      lengths_bias)
    if q.device.type != "cuda":
        raise ValueError(f"relpos_attention: unsupported device {q.device}")
    _check_cuda_args(q, k, v, p, pos_bias_u, pos_bias_v)
    b, h, t, d = q.shape
    kb = key_bias(lengths_bias, b, t, q.device).detach().contiguous()
    scale = 1.0 / math.sqrt(d)
    xs = (q, k, v, p, pos_bias_u.float(), pos_bias_v.float())
    pad = kernel_head_dim(d) - d
    if pad:  # zero columns add nothing to a score; autograd slices them off
        xs = tuple(F.pad(x, (0, pad)) for x in xs)
    xs = tuple(x.contiguous() for x in xs)
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        out = _RelposAttention.apply(*xs, kb, scale)
    else:
        out = _kernel_fwd(*xs, kb, scale, with_stats=False)[0]
    return out[..., :d] if pad else out


relpos_attention.launches = 0
relpos_attention_bwd.launches = 0
