"""Pre-norm position-wise FFN with residual: CUDA kernel and plain version.

Port of `fused_prenorm_ffn` and its oracle `prenorm_ffn_reference`
(`espnet_tpu/ops/pallas_ffn.py`), forward only and without dropout:

    y = x + residual_scale * (act(LN(x) @ W1 + b1) @ W2 + b2)

with LayerNorm eps 1e-6 and act swish (the conformer's macaron FFN, scale
0.5) or relu. `prenorm_ffn` is the entry point: a CPU tensor goes to
`prenorm_ffn_plain`, a CUDA tensor to the kernel in `csrc/prenorm_ffn.cu`
(which keeps the (M, d_ff) hidden activation out of device memory); anything
else raises. Both round LN(x) and act(.) to x's dtype before each product,
as the Pallas kernel does, and accumulate in float32.
"""

from __future__ import annotations

import torch

from espnet_tpu_torch.ops.cuda_build import check_launch, kernel_library

LN_EPS = 1e-6
ACTIVATIONS = {"swish": 0, "relu": 1}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODEL_DIMS = (256, 512)
_FF_CHUNK = 128


def _act(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swish":
        return h * torch.sigmoid(h)
    if activation == "relu":
        return torch.relu(h)
    raise ValueError(f"unsupported activation {activation!r}")


def _check_options(drop_rate: float, activation: str) -> None:
    if drop_rate > 0.0:
        raise NotImplementedError(
            "prenorm_ffn: dropout (the Pallas kernel's hash dropout) comes "
            "with the training port")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {activation!r}")


def prenorm_ffn_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                      activation: str = "swish", residual_scale: float = 1.0,
                      drop_rate: float = 0.0):
    """Plain PyTorch version. x: (..., D); w1: (D, F); w2: (F, D) in x's
    dtype; ln_scale, ln_bias, b1, b2 float32."""
    _check_options(drop_rate, activation)
    dt = x.dtype
    xf = x.float()
    xn = torch.nn.functional.layer_norm(
        xf, (xf.shape[-1],), ln_scale.float(), ln_bias.float(), LN_EPS)
    h = xn.to(dt).float() @ w1.float() + b1.float()
    a = _act(h, activation).to(dt).float()
    z = a @ w2.float() + b2.float()
    return (xf + residual_scale * z).to(dt)


def _check_cuda_args(x2, ln_scale, ln_bias, w1, b1, w2, b2):
    m, d = x2.shape
    f = w1.shape[-1]
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"prenorm_ffn: unsupported dtype {x2.dtype}")
    if d not in _MODEL_DIMS:
        raise ValueError(f"prenorm_ffn: model dim {d} not in {_MODEL_DIMS}")
    if f % _FF_CHUNK or f == 0:
        raise ValueError(f"prenorm_ffn: d_ff {f} is not a multiple of "
                         f"{_FF_CHUNK}")
    expect = {
        "x": (x2, (m, d), x2.dtype), "w1": (w1, (d, f), x2.dtype),
        "w2": (w2, (f, d), x2.dtype), "ln_scale": (ln_scale, (d,), torch.float32),
        "ln_bias": (ln_bias, (d,), torch.float32), "b1": (b1, (f,), torch.float32),
        "b2": (b2, (d,), torch.float32),
    }
    for name, (t, shape, dtype) in expect.items():
        if t.device != x2.device:
            raise ValueError(f"prenorm_ffn: {name} is on {t.device}, "
                             f"x on {x2.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"prenorm_ffn: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"prenorm_ffn: {name} is {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"prenorm_ffn: {name} is not contiguous")


def prenorm_ffn(x, ln_scale, ln_bias, w1, b1, w2, b2,
                activation: str = "swish", residual_scale: float = 1.0,
                drop_rate: float = 0.0):
    """Pre-norm FFN: the CUDA kernel on the card, the plain version on the
    CPU. Arguments as in `prenorm_ffn_plain`; returns x's shape and dtype.

    Replaces `fused_prenorm_ffn` (espnet_tpu/ops/pallas_ffn.py).
    `prenorm_ffn.launches` counts kernel launches.
    """
    if x.device.type == "cpu":
        return prenorm_ffn_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                 activation, residual_scale, drop_rate)
    if x.device.type != "cuda":
        raise ValueError(f"prenorm_ffn: unsupported device {x.device}")
    _check_options(drop_rate, activation)
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    _check_cuda_args(x2, ln_scale, ln_bias, w1, b1, w2, b2)
    y = torch.empty_like(x2)
    code = kernel_library().espnet_prenorm_ffn_fwd(
        x2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), x2.shape[0], d, w1.shape[1], float(residual_scale),
        ACTIVATIONS[activation], _DTYPE_CODES[x2.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch("prenorm_ffn", code)
    prenorm_ffn.launches += 1
    return y.reshape(x.shape)


prenorm_ffn.launches = 0
