"""What the two FFN ops (`ops.prenorm_ffn`, `ops.ffn`) share: their kernels
come from one templated source (`csrc/ffn_kernels.cuh`), so they take the
same shapes, the same dropout arguments and the same backward grid, and
their dropout is one counter hash.

`kernel_takes` is the shape gate: the JAX package's (`_ffn_tileable`,
espnet_tpu/models/transformer.py), d_model and d_ff multiples of 128,
less its row-count condition (a TPU tiling tuning; the port runs the
kernels at any row count). Shapes it refuses go to the plain versions, as
they do in the JAX package. `check_kernel_dims` is what the kernels
themselves take within the gate, d_model up to 512: a larger d_model
passes the gate and raises on the card.
"""

from __future__ import annotations

import torch

from espnet_tpu_torch.ops.cuda_build import kernel_library

ACTIVATIONS = {"swish": 0, "relu": 1}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
DROP_TILE = 256  # the Pallas kernel's default tile_m: the mask's row tile
TILE = 128  # the JAX gate's multiple of d_model and d_ff
KERNEL_MODEL_DIMS = (128, 256, 384, 512)  # the instantiations in csrc/
_M32 = 0xFFFFFFFF
# card blocks the weight-gradient kernel aims to fill (2 waves on 132 SMs)
_WGRAD_BLOCKS = 264
_WGRAD_CHUNK = 32


def kernel_takes(d_model: int, d_ff: int) -> bool:
    """The shape gate, decided before any launch: True sends the call to the
    kernels, False to the plain version."""
    return d_model % TILE == 0 and d_ff % TILE == 0 and d_ff > 0


def check_kernel_dims(name: str, x2: torch.Tensor, d_ff: int) -> None:
    """Raise for what the kernels do not take: a dtype other than float32
    and bfloat16, or a d_model past 512 (queued in ROADMAP.md)."""
    d = x2.shape[-1]
    if x2.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {x2.dtype}")
    if d not in KERNEL_MODEL_DIMS or d_ff <= 0 or d_ff % TILE:
        raise ValueError(f"{name}: the kernels do not take D={d} (only "
                         f"{KERNEL_MODEL_DIMS}), F={d_ff} (a multiple of "
                         f"{TILE})")


def quantize_rate(drop_rate: float) -> int:
    """The 1/256-quantised drop level q of FastDropout (0.1 -> 26)."""
    return 0 if drop_rate <= 0.0 else max(1, min(255, round(drop_rate * 256)))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c modulo 2**32 for int64 `a` in [0, 2**32), without overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_mask(rows: int, cols: int, seed: int, q: int,
              device=None) -> torch.Tensor:
    """(rows, cols) bool keep mask of the Pallas kernel's hash for one int32
    seed: row g lies in the 256-row tile g // 256, whose stream id is
    fmix32(seed) ^ (tile * 0x9E3779B9); element (g, c) hashes counter
    (g % 256) * cols + c and is kept when the top byte is >= q."""
    g = torch.arange(rows, dtype=torch.int64, device=device)
    s = _fmix32(torch.tensor(int(seed) & _M32, dtype=torch.int64,
                             device=device))
    stream = s ^ _mul32(g // DROP_TILE, 0x9E3779B9)
    c = torch.arange(cols, dtype=torch.int64, device=device)
    x = ((g % DROP_TILE)[:, None] * cols + c[None, :]) & _M32
    x = (x + _mul32(stream, 0x9E3779B9)[:, None]) & _M32
    return (_fmix32(x) >> 24) >= q


def act(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swish":
        return h * torch.sigmoid(h)
    if activation == "relu":
        return torch.relu(h)
    raise ValueError(f"unsupported activation {activation!r}")


def drop_args(q: int, seeds):
    """(q, keep scale, seed0, seed1) as the kernels take them; `seeds` is
    None or one or two int32 seeds (a missing second is 0)."""
    s0, s1 = (tuple(seeds) + (0,))[:2] if seeds is not None else (0, 0)
    scale = 256.0 / (256 - q) if q else 1.0
    # int32 seeds pass as C ints (two's complement, as the kernel reads them)
    s0, s1 = (((int(s) + 2 ** 31) & _M32) - 2 ** 31 for s in (s0, s1))
    return q, scale, s0, s1


def stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def bwd_grid(m: int, d_ff: int):
    """(row blocks of the dx kernel, row groups of the weight-gradient
    kernel) of the backward pair for M rows."""
    rows = kernel_library().espnet_prenorm_ffn_bwd_rows_per_block()
    n_blocks = -(-m // rows)
    groups = max(1, min(n_blocks,
                        round(_WGRAD_BLOCKS / (d_ff // _WGRAD_CHUNK))))
    return n_blocks, groups
