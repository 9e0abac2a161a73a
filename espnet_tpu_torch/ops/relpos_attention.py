"""Transformer-XL relative-position attention: CUDA kernel and plain version.

Port of `espnet_tpu/ops/pallas_relpos_attention.py` (`relpos_flash_attention`
and its oracle `relpos_attention_reference`), forward only:

    score[b,h,i,j] = ((q+u)·k_j + (q+v)·p[T-1-(i-j)]) / sqrt(D) + kbias[b,j]

`relpos_attention` is the entry point: a CPU tensor goes to
`relpos_attention_plain`, a CUDA tensor to the kernel in
`csrc/relpos_attention.cu` (which never builds the (B, H, T, 2T-1) tensor);
anything else raises. Both compute in float32 whatever the input dtype and
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


def relpos_attention(q, k, v, p, pos_bias_u, pos_bias_v, lengths_bias=None):
    """Rel-pos attention: the CUDA kernel on the card, the plain version on
    the CPU. Shapes as in `relpos_attention_plain`; returns (B, H, T, D).

    Replaces `relpos_flash_attention` (espnet_tpu/ops/
    pallas_relpos_attention.py). `relpos_attention.launches` counts kernel
    launches.
    """
    if q.device.type == "cpu":
        return relpos_attention_plain(q, k, v, p, pos_bias_u, pos_bias_v,
                                      lengths_bias)
    if q.device.type != "cuda":
        raise ValueError(f"relpos_attention: unsupported device {q.device}")
    _check_cuda_args(q, k, v, p, pos_bias_u, pos_bias_v)
    b, h, t, d = q.shape
    kb = key_bias(lengths_bias, b, t, q.device).contiguous()
    u = pos_bias_u.float().contiguous()
    vb = pos_bias_v.float().contiguous()
    out = torch.empty_like(q)
    code = kernel_library().espnet_relpos_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        u.data_ptr(), vb.data_ptr(), kb.data_ptr(), out.data_ptr(),
        b, h, t, d, _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch("relpos_attention", code)
    relpos_attention.launches += 1
    return out


relpos_attention.launches = 0
