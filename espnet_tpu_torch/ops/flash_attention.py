"""Attention with a key-padding bias: CUDA kernel and plain version.

Port of `flash_attention` (`espnet_tpu/ops/pallas_attention.py`), whose
Pallas kernel `_flash_kernel` computes

    out = softmax(q kᵀ / sqrt(D) + key bias) v

with a blocked online softmax in float32, the (B, T) key bias sliced per
key block and never expanded to T². Only biases of shape (B, 1, 1, T)
qualify (`key_padding_only`), as in the JAX `_key_padding_bias`.

`flash_attention` is the entry point: a CPU tensor goes to
`flash_attention_plain` (whose gradient is torch autograd's), a CUDA tensor
to the kernel in `csrc/flash_attention.cu`; anything else raises.
Callers apply the head-dim gate of both attention kernels first,
`relpos_attention.kernel_takes` (the JAX module's `dk % 8 == 0`), and
head dims are padded to the kernel's as for rel-pos attention
(`relpos_attention.kernel_head_dim`). The JAX package has
no backward kernel: its custom VJP recomputes through the plain attention,
and so does the port's autograd Function, which saves q, k, v and the key
bias and differentiates `flash_attention_plain` in `backward` (the key bias
gets no gradient). Both compute in float32 whatever the input dtype and
return q's dtype. The key bias is clamped at NEG = finfo(f32).min/2: a query
whose keys are all masked averages v uniformly over the T keys, as the
plain reference `_reference_attention` does (the Pallas kernel averages over
its padded key length there instead).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from espnet_tpu_torch.ops.cuda_build import check_launch, kernel_library
from espnet_tpu_torch.ops.relpos_attention import (DTYPE_CODES, NEG,
                                                   kernel_head_dim, key_bias)


def key_padding_only(bias: Optional[torch.Tensor]) -> bool:
    """True for no bias or a bias of shape (B|1, 1, 1, T): one additive
    value per key, the same for every head and query."""
    return bias is None or (bias.ndim == 4 and bias.shape[1] == 1
                            and bias.shape[2] == 1)


def flash_attention_plain(q, k, v, bias=None):
    """Plain PyTorch version (materialises the (B, H, T, T) scores).

    q, k, v: (B, H, T, D); bias: additive, broadcastable to (B, H, T, T),
    or None; clamped at NEG.
    """
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(
        q.shape[-1])
    if bias is not None:
        scores = scores + bias.float().clamp(min=NEG)
    w = torch.softmax(scores, dim=-1)
    return (w @ v.float()).to(q.dtype)


def _check_cuda_args(q, k, v):
    b, h, t, d = q.shape
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    kernel_head_dim(d)
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {x.device}, "
                             f"q on {q.device}")
        if tuple(x.shape) != (b, h, t, d):
            raise ValueError(f"flash_attention: {name} has shape "
                             f"{tuple(x.shape)}, expected {(b, h, t, d)}")
        if x.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {x.dtype}, "
                            f"expected {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")


def _kernel_fwd(q, k, v, kb):
    b, h, t, d = q.shape
    pad = kernel_head_dim(d) - d
    if pad:  # zero columns add nothing to a score
        q, k, v = (F.pad(x, (0, pad)).contiguous() for x in (q, k, v))
    out = torch.empty_like(q)
    code = kernel_library().espnet_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kb.data_ptr(),
        out.data_ptr(), b, h, t, d + pad, 1.0 / math.sqrt(d),
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", code)
    flash_attention.launches += 1
    return out[..., :d] if pad else out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kb):
        ctx.save_for_backward(q, k, v, kb)
        return _kernel_fwd(q, k, v, kb)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kb = ctx.saved_tensors
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        with torch.enable_grad():
            out = flash_attention_plain(*leaves, kb[:, None, None, :])
            dq, dk, dv = torch.autograd.grad(out, leaves, dout)
        return dq, dk, dv, None


def flash_attention(q, k, v, bias=None):
    """Attention with a key-padding bias: the CUDA kernel on the card, the
    plain version on the CPU. q, k, v: (B, H, T, D); bias: (B|1, 1, 1, T)
    additive or None. Returns (B, H, T, D) in q's dtype.

    Replaces `flash_attention` (espnet_tpu/ops/pallas_attention.py).
    `flash_attention.launches` counts kernel launches.
    """
    if not key_padding_only(bias):
        raise ValueError("flash_attention: the bias must be a key-padding "
                         "bias of shape (B, 1, 1, T), not "
                         f"{tuple(bias.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_cuda_args(q, k, v)
    b, _, t, _ = q.shape
    kb = key_bias(bias, b, t, q.device).detach().contiguous()
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, kb)
    return _kernel_fwd(q, k, v, kb)


flash_attention.launches = 0
