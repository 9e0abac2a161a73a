"""What the two FFN ops (`ops.prenorm_ffn`, `ops.ffn`) share: their kernels
come from one templated source (`csrc/ffn_kernels.cuh`), so they take the
same shapes, the same dropout arguments and the same backward grid, and
their dropout is one counter hash. The conv ops (`ops.conv_glu`,
`ops.conv_module`) build their kernels from the same header's pieces and
share the hash, the LayerNorm, the argument checks, the bf16 row blocks
(`TC_ROWS_PER_BLOCK`) and the grids of its weight-gradient kernels
(`wgrad_groups` in float32, `wgrad_split` on the tensor cores).

`kernel_takes` is the shape gate: the JAX package's (`_ffn_tileable`,
espnet_tpu/models/transformer.py), d_model and d_ff multiples of 128,
less its row-count condition (a TPU tiling tuning; the port runs the
kernels at any row count). Shapes it refuses go to the plain versions, as
they do in the JAX package. `check_kernel_dims` is what the kernels
themselves take within the gate, d_model up to 512: a larger d_model
passes the gate and raises on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

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


LN_EPS = 1e-6  # flax's LayerNorm epsilon, the Pallas kernels' too


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last dim with eps 1e-6, in x's dtype."""
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), scale.float(),
                                          bias.float(), LN_EPS)


def check_args(name: str, expect: dict, like: torch.Tensor) -> None:
    """Raise unless every tensor of `expect` (argument name: (tensor, shape,
    dtype)) lies on `like`'s device, contiguous, with that shape and
    dtype."""
    for arg, (t, shape, dtype) in expect.items():
        if t.device != like.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, "
                             f"x on {like.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")


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


def keep_mask(rows: int, cols: int, seed: int, q: int, device=None,
              tile_rows: int = DROP_TILE) -> torch.Tensor:
    """(rows, cols) bool keep mask of the Pallas kernels' hash for one int32
    seed: row g lies in the tile g // tile_rows, whose stream id is
    fmix32(seed) ^ (tile * 0x9E3779B9); element (g, c) hashes counter
    (g % tile_rows) * cols + c and is kept when the top byte is >= q.

    The FFN kernels and the conv tail tile the flattened rows by 256 (the
    default); the whole conv module's tile is one utterance, so its mask
    over B utterances of T frames is `keep_mask(B * T, D, seed, q,
    tile_rows=T)` (the counter of frame t is t * D + c, whatever T is
    padded to)."""
    g = torch.arange(rows, dtype=torch.int64, device=device)
    s = _fmix32(torch.tensor(int(seed) & _M32, dtype=torch.int64,
                             device=device))
    stream = s ^ _mul32(g // tile_rows, 0x9E3779B9)
    c = torch.arange(cols, dtype=torch.int64, device=device)
    x = ((g % tile_rows)[:, None] * cols + c[None, :]) & _M32
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


# The backward pair's grid (csrc/ffn_kernels.cuh). float32, on the CUDA
# cores: `bwd_dx` over 32-row blocks, then `bwd_w` over 32-wide chunks of F
# and row groups. bf16, on tensor cores: the row kernel over blocks of
# TC_ROWS_PER_BLOCK[D] rows, then the A^T B kernel over 128 x 128 result
# tiles and row groups that it walks 32 rows at a time.
FP32_ROWS_PER_BLOCK = 32
TC_ROWS_PER_BLOCK = {128: 64, 256: 64, 384: 32, 512: 32}
TC_WGRAD_TILE = 128
TC_WGRAD_ROWS = 32


class BwdLayout(NamedTuple):
    row_blocks: int      # blocks of the row kernel (rows of `partial`)
    groups: int          # row groups of the weight-gradient partial sums
    rows_per_group: int  # group g sums rows [g, g + 1) * rows_per_group
    db1_parts: int       # rows of db1's partial sums
    tensor_cores: bool   # the bf16 design: a and dh go through (M, F)


def wgrad_split(m: int, k: int, n: int) -> Tuple[int, int]:
    """(groups, rows per group) of the tensor-core A^T B kernel summing m
    rows into a (k, n) result: enough groups to fill the card twice, each a
    whole number of the kernel's 32-row steps, none empty."""
    tiles = (k // TC_WGRAD_TILE) * (n // TC_WGRAD_TILE)
    want = max(1, round(_WGRAD_BLOCKS / tiles))
    rows = -(-m // want)
    rows = -(-rows // TC_WGRAD_ROWS) * TC_WGRAD_ROWS
    return -(-m // rows), rows


def bwd_layout(m: int, d: int, d_ff: int, dtype: torch.dtype) -> BwdLayout:
    """The backward pair's grid for m rows of width d (d_ff hidden units)."""
    if dtype == torch.bfloat16:
        blocks = -(-m // TC_ROWS_PER_BLOCK[d])
        groups, rows = wgrad_split(m, d, d_ff)
        return BwdLayout(blocks, groups, rows, blocks, True)
    blocks = -(-m // FP32_ROWS_PER_BLOCK)
    groups = max(1, min(blocks,
                        round(_WGRAD_BLOCKS / (d_ff // _WGRAD_CHUNK))))
    return BwdLayout(blocks, groups, -(-m // groups), groups, False)


def bwd_buffers(x2: torch.Tensor, d_ff: int, n_sums: int):
    """(layout, buffers) of the backward pair for x2 (M, D): dx; the float32
    partial sums `partial` (row blocks, n_sums, D), `dw1p` (groups, D, d_ff),
    `dw2p` (groups, d_ff, D) and `db1p` (db1_parts, d_ff); with tensor cores
    also the (M, d_ff) scratch `a` and `dh` in x2's dtype, 2·M·d_ff elements
    that live for one backward call."""
    m, d = x2.shape
    lay = bwd_layout(m, d, d_ff, x2.dtype)
    f32 = dict(dtype=torch.float32, device=x2.device)
    bufs = {"dx": torch.empty_like(x2),
            "partial": torch.empty(lay.row_blocks, n_sums, d, **f32),
            "dw1p": torch.empty(lay.groups, d, d_ff, **f32),
            "dw2p": torch.empty(lay.groups, d_ff, d, **f32),
            "db1p": torch.empty(lay.db1_parts, d_ff, **f32),
            "a": None, "dh": None}
    if lay.tensor_cores:
        bufs["a"] = torch.empty(m, d_ff, dtype=x2.dtype, device=x2.device)
        bufs["dh"] = torch.empty_like(bufs["a"])
    return lay, bufs


def ptr(t: Optional[torch.Tensor]):
    """A tensor's device address for a C entry point (None: null)."""
    return None if t is None else t.data_ptr()


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it at a 16-byte aligned address (the bf16
    tensor-core kernels copy 16-byte chunks)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# the output tile of the A^T B weight-gradient kernel (csrc/ffn_kernels.cuh)
WGRAD_TILE = 64


def wgrad_groups(m: int, k: int, n: int) -> int:
    """Row groups of the generic weight-gradient kernel (`A^T B` over M rows,
    a (K, N) result in 64 x 64 tiles): enough blocks to fill the card twice,
    at least 32 rows a group."""
    tiles = -(-k // WGRAD_TILE) * -(-n // WGRAD_TILE)
    return max(1, min(-(-m // 32), round(_WGRAD_BLOCKS / tiles)))
