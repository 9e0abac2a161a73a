"""Attention with a key-padding bias: CUDA kernel and plain version.

Port of `flash_attention` (`espnet_tpu/ops/pallas_attention.py`), whose
Pallas kernel `_flash_kernel` computes

    out = softmax(q kᵀ / sqrt(D) + key bias) v

with a blocked online softmax in float32, the (B, T) key bias sliced per
key block and never expanded to T². Only biases of shape (B, 1, 1, T)
qualify (`key_padding_only`), as in the JAX `_key_padding_bias`.

`flash_attention` is the entry point: a CPU tensor goes to
`flash_attention_plain`, a CUDA tensor to the kernel in
`csrc/flash_attention.cu`; anything else raises.
Callers apply the head-dim gate of both attention kernels first,
`relpos_attention.kernel_takes` (the JAX module's `dk % 8 == 0`), and
head dims are padded to the kernel's (`flash_head_dim`): 32, 64, 128 as
for rel-pos attention, and 192, FastSpeech2's two heads of 384, which only
this kernel has.

The forward, kernel and plain version alike, computes in float32 inside
whatever the input dtype (as `_flash_kernel` does: it casts its blocks to
float32) and returns q's dtype. The JAX package has no backward kernel: its
custom VJP recomputes through `_reference_attention`, and so does the
port's autograd Function, on both devices: it saves q, k, v and the key
bias and differentiates `reference_attention`, which keeps the input dtype
(in bf16 the scores are a bf16 product and the weights are rounded to bf16
before their product with v); the bias gets no gradient. In float32 the
two functions are one. The key bias is clamped at NEG = finfo(f32).min/2
(JAX's `_bwd` adds it unclamped: for the finite masks the models build,
finfo(f32).min or 0, the two give the same weights and gradients). A query
whose keys are all masked averages v uniformly over the T keys, as
`_reference_attention` does (the Pallas kernel averages over its padded
key length there instead).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from espnet_tpu_torch.ops.cuda_build import check_launch, kernel_library
from espnet_tpu_torch.ops.ffn_common import aligned16
from espnet_tpu_torch.ops.relpos_attention import DTYPE_CODES, NEG, key_bias

FLASH_HEAD_DIMS = (32, 64, 128, 192)  # the instantiations in csrc/


def flash_head_dim(head_dim: int) -> int:
    """The kernel head dim a call of this head dim runs at (zero padding
    up to it); raises past the largest."""
    for dim in FLASH_HEAD_DIMS:
        if head_dim <= dim:
            return dim
    raise ValueError(f"the flash kernel takes head dims up to "
                     f"{FLASH_HEAD_DIMS[-1]}, not {head_dim}")


def key_padding_only(bias: Optional[torch.Tensor]) -> bool:
    """True for no bias or a bias of shape (B|1, 1, 1, T): one additive
    value per key, the same for every head and query."""
    return bias is None or (bias.ndim == 4 and bias.shape[1] == 1
                            and bias.shape[2] == 1)


def reference_attention(q, k, v, bias, return_weights: bool = False):
    """softmax(q kᵀ / sqrt(D) + bias) v in the input dtype: the port of
    `_reference_attention` (espnet_tpu/ops/pallas_attention.py), whose
    gradient the JAX custom VJP takes. q kᵀ is a product in q's dtype,
    widened to float32 for the softmax; the weights are rounded to v's
    dtype before their product with v. q, k, v: (B, H, T, D); bias:
    additive, broadcastable to (B, H, Tq, Tk), or None. With
    `return_weights`, (output, float32 weights), as the JAX package's
    `scaled_dot_attention(..., return_weights=True)` (attention maps)."""
    scores = (q @ k.transpose(-1, -2)).float() / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.float()
    weights = torch.softmax(scores, dim=-1)
    out = weights.to(v.dtype) @ v
    return (out, weights) if return_weights else out


def _plain_forward(q, k, v, bias):
    """The forward in float32 inside (materialises the (B, H, T, T)
    scores); bias already clamped, or None."""
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(
        q.shape[-1])
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1)
    return (w @ v.float()).to(q.dtype)


class _Attention(torch.autograd.Function):
    """`forward(q, k, v, bias)` (the kernel's or `_plain_forward`) with the
    gradient of `reference_attention`; bias float32, clamped at NEG."""

    @staticmethod
    def forward(ctx, q, k, v, bias, forward):
        ctx.save_for_backward(q, k, v, bias)
        return forward(q, k, v, bias)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias = ctx.saved_tensors
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        with torch.enable_grad():
            out = reference_attention(*leaves, bias)
            dq, dk, dv = torch.autograd.grad(out, leaves, dout)
        return dq, dk, dv, None, None


def _needs_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention_plain(q, k, v, bias=None):
    """Plain PyTorch version: the forward in float32 inside (materialises
    the (B, H, T, T) scores), the gradient of `reference_attention`.

    q, k, v: (B, H, T, D); bias: additive, broadcastable to (B, H, T, T),
    or None; clamped at NEG.
    """
    if bias is not None:
        bias = bias.float().clamp(min=NEG)
    if _needs_grad(q, k, v):
        return _Attention.apply(q, k, v, bias, _plain_forward)
    return _plain_forward(q, k, v, bias)


def _check_cuda_args(q, k, v):
    b, h, t, d = q.shape
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    flash_head_dim(d)
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
    """The kernel's forward; kb: (B, 1, 1, T) float32 key bias, clamped,
    contiguous."""
    b, h, t, d = q.shape
    pad = flash_head_dim(d) - d
    if pad:  # zero columns add nothing to a score
        q, k, v = (F.pad(x, (0, pad)).contiguous() for x in (q, k, v))
    elif q.dtype == torch.bfloat16:
        q, k, v = (aligned16(x) for x in (q, k, v))
    out = torch.empty_like(q)
    code = kernel_library().espnet_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kb.data_ptr(),
        out.data_ptr(), b, h, t, d + pad, 1.0 / math.sqrt(d),
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", code)
    flash_attention.launches += 1
    return out[..., :d] if pad else out


def flash_attention(q, k, v, bias=None):
    """Attention with a key-padding bias: the CUDA kernel on the card, the
    plain version on the CPU; on both the gradient of `reference_attention`.
    q, k, v: (B, H, T, D); bias: (B|1, 1, 1, T) additive or None. Returns
    (B, H, T, D) in q's dtype.

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
    kb = key_bias(bias, b, t, q.device).detach().contiguous()[:, None, None]
    if _needs_grad(q, k, v):
        return _Attention.apply(q, k, v, kb, _kernel_fwd)
    return _kernel_fwd(q, k, v, kb)


flash_attention.launches = 0
