"""Transformer-XL relative-position attention: CUDA kernels and plain version.

Port of `espnet_tpu/ops/pallas_relpos_attention.py` (`relpos_flash_attention`
and its oracle `relpos_attention_reference`), forward and backward:

    score[b,h,i,j] = ((q+u)·k_j + (q+v)·p[T-1-(i-j)]) / sqrt(D) + kbias[b,j]

`relpos_attention` is the entry point: a CPU tensor goes to
`relpos_attention_plain` (whose gradient is torch autograd's), a CUDA tensor
to the kernels in `csrc/relpos_attention.cu` (which never build the
(B, H, T, 2T-1) tensor) through an autograd Function: the forward kernel
also writes each query row's softmax max and sum, and the backward kernel
pair (`relpos_attention_bwd`) gives dq, dk, dv and dp; du and dv-bias are
sums of the q gradients' two parts, taken here as the JAX package does.
Anything else raises. Both compute in float32 whatever the input dtype and
return q's dtype. The key bias is clamped at NEG = finfo(f32).min/2, as the
Pallas kernel pads with NEG: a query whose keys are all masked averages v
uniformly instead of giving NaN.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from espnet_tpu_torch.ops.cuda_build import check_launch, kernel_library

NEG = float(np.finfo(np.float32).min) / 2

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_BWD_HEAD_DIMS = (32, 64)
_BLOCK = 64  # query rows of one dp slab (BQ in the kernel)


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
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"relpos_attention: unsupported dtype {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"relpos_attention: head dim {d} not in {_HEAD_DIMS}")
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


def _kernel_fwd(q, k, v, p, u, vb, kb, with_stats: bool):
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    stats = (torch.empty(b, h, t, 2, dtype=torch.float32, device=q.device)
             if with_stats else None)
    code = kernel_library().espnet_relpos_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        u.data_ptr(), vb.data_ptr(), kb.data_ptr(), out.data_ptr(),
        None if stats is None else stats.data_ptr(),
        b, h, t, d, _DTYPE_CODES[q.dtype], _stream(q))
    check_launch("relpos_attention", code)
    relpos_attention.launches += 1
    return out, stats


def relpos_attention_bwd(q, k, v, p, u, vb, kb, out, stats, dout):
    """Gradients (dq, dk, dv, dp, du, dvb) of the kernel's forward, from the
    CUDA backward kernel pair; dq, dk, dv, dp in q's dtype, du and dvb
    float32. `relpos_attention_bwd.launches` counts calls."""
    b, h, t, d = q.shape
    if d not in _BWD_HEAD_DIMS:
        raise ValueError(f"relpos_attention_bwd: head dim {d} not in "
                         f"{_BWD_HEAD_DIMS}")
    dout = dout.to(q.dtype).contiguous()
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    lib = kernel_library()
    nq = -(-t // _BLOCK)
    rows = lib.espnet_relpos_attention_slab_rows(t)
    f32 = dict(dtype=torch.float32, device=q.device)
    dqu, dqv, dk, dv = (torch.empty(b, h, t, d, **f32) for _ in range(4))
    slabs = torch.empty(b, h, nq, rows, d, **f32)
    code = lib.espnet_relpos_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        u.data_ptr(), vb.data_ptr(), kb.data_ptr(), dout.data_ptr(),
        stats.data_ptr(), delta.data_ptr(), dqu.data_ptr(), dqv.data_ptr(),
        slabs.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t, d,
        _DTYPE_CODES[q.dtype], _stream(q))
    check_launch("relpos_attention_bwd", code)
    relpos_attention_bwd.launches += 1
    # overlap-add: slab row 0 of query block n is p row T-1-(64n+63)
    per_block = slabs.sum(dim=0)  # (H, nq, rows, D)
    dp = torch.zeros(h, 2 * t - 1, d, **f32)
    for n in range(nq):
        off = t - 1 - (_BLOCK * n + _BLOCK - 1)
        lo, hi = max(0, -off), min(rows, 2 * t - 1 - off)
        dp[:, off + lo:off + hi] += per_block[:, n, lo:hi]
    dt = q.dtype
    return ((dqu + dqv).to(dt), dk.to(dt), dv.to(dt), dp.to(p.dtype),
            dqu.sum(dim=(0, 2)), dqv.sum(dim=(0, 2)))


class _RelposAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, p, u, vb, kb):
        out, stats = _kernel_fwd(q, k, v, p, u, vb, kb, with_stats=True)
        ctx.save_for_backward(q, k, v, p, u, vb, kb, out, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv, dp, du, dvb = relpos_attention_bwd(*ctx.saved_tensors,
                                                       dout)
        return dq, dk, dv, dp, du, dvb, None


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
    u = pos_bias_u.float().contiguous()
    vb = pos_bias_v.float().contiguous()
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v, p, u, vb)):
        return _RelposAttention.apply(q, k, v, p, u, vb, kb)
    return _kernel_fwd(q, k, v, p, u, vb, kb, with_stats=False)[0]


relpos_attention.launches = 0
relpos_attention_bwd.launches = 0
