"""Float32 parameters, computation in the model's dtype.

The JAX package keeps parameters in float32 and casts them to the compute
dtype (bfloat16 for the bench model) inside each flax layer; these layers
(Dense, Conv1d, LayerNorm) do the same. LayerNorm normalises in float32 with eps 1e-6 (flax's
default, not torch's 1e-5) and returns the compute dtype.

`KernelRouted` is the base of the port's models: one switch between the
CUDA kernels and their plain versions. `LSTMCell` is flax's `OptimizedLSTMCell` written out, shared by the
transducer's prediction network, the v1 RNN encoder and decoder and the
beamformer's mask estimator: per gate an input kernel without bias (`ii`,
`if`, `ig`, `io`) and a recurrent kernel with bias (`hi`, ...), gate order
i, f, g, o, sigmoid gates, tanh candidate, no forget-bias offset, carry
(c, h). Its pre-activations are formed in the compute dtype (as flax
does), the gates and the carry in float32; a cell built with float32 is
the flax cell without a `dtype`, which promotes a bfloat16 input to the
float32 of its parameters. `lstm_sequence` runs a cell over a padded
(B, T, D) batch as flax's `nn.RNN` does without `seq_lengths`: every step
of the padded length, the reversed direction starting at the padding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

LN_EPS = 1e-6


class KernelRouted(nn.Module):
    """A model whose kernel wrappers can all take their plain versions:
    `use_kernels` (True by default) routes its losses, `set_use_kernels`
    also every submodule with a `use_kernel` switch (chip_smoke.py holds
    the two routes against each other on the card)."""

    use_kernels = True

    def set_use_kernels(self, enabled: bool) -> None:
        self.use_kernels = enabled
        for module in self.modules():
            if hasattr(module, "use_kernel"):
                module.use_kernel = enabled


class Dense(nn.Linear):
    """nn.Linear whose input, weight and bias are cast to `dtype`."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__(d_in, d_out, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return nn.functional.linear(x.to(dt), self.weight.to(dt), b)


class Conv1d(nn.Conv1d):
    """flax `nn.Conv` over channel-last (N, L, C) input, computed in
    `dtype`, "SAME" padding (odd kernels: symmetric, also dilated)."""

    def __init__(self, c_in: int, c_out: int, kernel: int, groups: int = 1,
                 bias: bool = True, dtype=torch.float32, dilation: int = 1):
        super().__init__(c_in, c_out, kernel,
                         padding=(kernel - 1) * dilation // 2,
                         dilation=dilation, groups=groups, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = nn.functional.conv1d(x.to(dt).transpose(1, 2),
                                 self.weight.to(dt), b,
                                 padding=self.padding, dilation=self.dilation,
                                 groups=self.groups)
        return y.transpose(1, 2)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with eps 1e-6, computed in float32, returned in `dtype`."""

    def __init__(self, d: int, dtype=torch.float32):
        super().__init__(d, eps=LN_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = nn.functional.layer_norm(x.float(), self.normalized_shape,
                                     self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over the last axis of (..., C), in float32 with
    eps 1e-5 and momentum 0.9: in training mode it normalises with the
    batch's statistics over every other axis (padding included; the
    variance E[x^2] - E[x]^2, biased, floored at 0) and updates the running
    buffers `mean` and `var` (the JAX `batch_stats` collection) in place as
    flax does, new = 0.9 old + 0.1 batch; in eval mode it uses them.
    `torch.nn.BatchNorm1d` keeps the unbiased variance, hence this module.
    The output is in the input's dtype."""

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = tuple(range(xf.ndim - 1))
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.var.mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias  # flax's order: the scale folds into the rsqrt
        return y.to(x.dtype)


def batch_stat_buffers(model: nn.Module):
    """Every BatchNorm running buffer of `model` (the JAX `batch_stats`)."""
    return [b for m in model.modules() if isinstance(m, BatchNorm)
            for b in (m.mean, m.var)]


GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    """flax `OptimizedLSTMCell`: i = sigmoid(W_ii x + W_hi h + b_hi), f, o
    alike, g = tanh(...), c' = f c + i g, h' = o tanh(c')."""

    def __init__(self, d_in: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        for g in GATES:
            self.add_module(f"i{g}", Dense(d_in, hidden, bias=False,
                                           dtype=dtype))
            self.add_module(f"h{g}", Dense(hidden, hidden, dtype=dtype))

    def input_proj(self, x):
        """(..., d_in) -> (..., 4H): the four input kernels at once."""
        w = torch.cat([getattr(self, f"i{g}").weight for g in GATES])
        return nn.functional.linear(x.to(self.dtype), w.to(self.dtype))

    def recurrent(self):
        """(W (4H, H), bias (4H,)) of the four hidden kernels at once, in
        the compute dtype: formed once for a sequence, not once a step."""
        dt = self.dtype
        w = torch.cat([getattr(self, f"h{g}").weight for g in GATES])
        bias = torch.cat([getattr(self, f"h{g}").bias for g in GATES])
        return w.to(dt), bias.to(dt)

    def step(self, carry, x_proj, rec=None):
        """carry (c, h) float32 (B, H), x_proj (B, 4H) -> new carry; `rec`
        is `recurrent()` when the caller holds it."""
        c, h = carry
        w, bias = self.recurrent() if rec is None else rec
        pre = (nn.functional.linear(h.to(self.dtype), w, bias)
               + x_proj).float()
        i, f, g, o = pre.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_c, new_h

    def zero_carry(self, batch: int, device=None):
        z = torch.zeros(batch, self.hidden, device=device)
        return z, z


def lstm_sequence(cell: LSTMCell, x: torch.Tensor, reverse: bool = False,
                  carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Run `cell` over every step of x (B, T, D) from `carry` (zeros when
    None), last step first when `reverse`; returns (outputs (B, T, H)
    float32 in the input's time order, the final carry)."""
    b, t, _ = x.shape
    # unbind: one backward for all steps (indexing a step at a time would
    # materialise and add a full (B, T, 4H) gradient a step)
    proj = cell.input_proj(x).unbind(1)  # T x (B, 4H)
    rec = cell.recurrent()
    if carry is None:
        carry = cell.zero_carry(b, x.device)
    outs = [None] * t
    for k in (range(t - 1, -1, -1) if reverse else range(t)):
        carry = cell.step(carry, proj[k], rec)
        outs[k] = carry[1]
    if t == 0:
        return x.new_zeros(b, 0, cell.hidden, dtype=torch.float32), carry
    return torch.stack(outs, 1), carry


def same_padding(length: int, kernel: int, stride: int = 1,
                 dilation: int = 1) -> Tuple[int, int]:
    """XLA's "SAME" padding (left, right) of one axis: ceil(length/stride)
    outputs, the total max((out-1)*stride + span - length, 0) split with the
    floor half on the left (flax `nn.Conv`, `nn.avg_pool`)."""
    span = (kernel - 1) * dilation + 1
    out = -(-length // stride)
    total = max((out - 1) * stride + span - length, 0)
    return total // 2, total - total // 2


class SameConv1d(nn.Conv1d):
    """flax `nn.Conv` over channel-last (N, L, C) input with any kernel,
    stride, dilation and feature groups: "SAME" padding as XLA pads it
    (explicit, also for strides above 1, which torch's padding="same"
    refuses), or "VALID". Computed in `dtype`."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, bias: bool = True,
                 padding: str = "SAME", dtype=torch.float32):
        super().__init__(c_in, c_out, kernel, stride=stride,
                         dilation=dilation, groups=groups, bias=bias)
        self.same = padding == "SAME"
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        h = x.to(dt).transpose(1, 2)
        if self.same:
            h = nn.functional.pad(h, same_padding(
                h.shape[-1], self.kernel_size[0], self.stride[0],
                self.dilation[0]))
        b = None if self.bias is None else self.bias.to(dt)
        y = nn.functional.conv1d(h, self.weight.to(dt), b, self.stride,
                                 0, self.dilation, self.groups)
        return y.transpose(1, 2)


def conv_transpose_padding(kernel: int, stride: int) -> Tuple[int, int]:
    """lax.conv_transpose's "SAME" padding (before, after) of the
    stride-dilated input
    (`jax._src.lax.convolution._conv_transpose_padding`)."""
    pad_len = kernel + stride - 2
    before = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    return before, pad_len - before


def conv_transpose_valid_padding(kernel: int, stride: int
                                 ) -> Tuple[int, int]:
    """lax.conv_transpose's "VALID" padding (before, after) of the
    stride-dilated input: L*stride + max(kernel - stride, 0) outputs."""
    before = kernel - 1
    return before, kernel + stride - 2 + max(kernel - stride, 0) - before


class ConvTranspose1d(nn.Module):
    """flax `nn.ConvTranspose` with "SAME" (or "VALID") padding and the
    default transpose_kernel=False over (N, L, C): lax dilates the input by
    the stride, pads it by `conv_transpose_padding` (or
    `conv_transpose_valid_padding`) and correlates it with the kernel as it
    is (not flipped, in and out not swapped), giving L*stride outputs
    ("SAME"), computed by `lax_conv_transpose`. `weight` is (out, in, k),
    the layout the converter gives a flax (k, in, out) kernel; computed in
    `dtype`."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 bias: bool = True, dtype=torch.float32,
                 padding: str = "SAME"):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.compute_dtype = dtype
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        pad = (conv_transpose_padding if self.padding == "SAME"
               else conv_transpose_valid_padding)(self.kernel, self.stride)
        y = lax_conv_transpose(x, self.weight, (self.stride,), [pad], dt)
        return y if self.bias is None else y + self.bias.to(dt)


def avg_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """flax `nn.avg_pool(x, (window,), (stride,), "SAME")` over (N, L, C):
    zero padding as XLA pads, every window divided by `window`
    (count_include_pad=True, flax's default)."""
    h = nn.functional.pad(x.transpose(1, 2),
                          same_padding(x.shape[1], window, stride))
    return nn.functional.avg_pool1d(h, window, stride).transpose(1, 2)


class PReLU(nn.Module):
    """flax `nn.PReLU`: one scalar slope `negative_slope` (initialised at
    0.01, not torch's per-channel 0.25); x where x >= 0, else slope * x."""

    def __init__(self):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(0.01))

    @torch.no_grad()
    def init_random_(self, generator=None):
        self.negative_slope.fill_(0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope * x)


def lax_conv_transpose(x: torch.Tensor, w: torch.Tensor, strides,
                       padding, dtype=None) -> torch.Tensor:
    """flax's transposed conv (transpose_kernel=False), 1-D or 2-D, over
    channel-last x (N, *spatial, C) with a torch-layout kernel w
    (out, in, *k): lax dilates x by `strides`, pads it by `padding`
    ((lo, hi) per axis) and correlates it with w as it is. Here: torch's
    conv_transpose with w flipped along every spatial axis and its in and
    out swapped, then the full output cropped by k - 1 - lo and k - 1 - hi
    on each axis (zero-padded where that is negative). Computed in `dtype`
    (w's when None); returns (N, *spatial', out)."""
    nd = x.ndim - 2
    dt = dtype or w.dtype
    v = w.to(dt).transpose(0, 1).flip(tuple(range(2, 2 + nd)))
    conv_t = (nn.functional.conv_transpose1d if nd == 1
              else nn.functional.conv_transpose2d)
    y = conv_t(x.to(dt).movedim(-1, 1), v, stride=tuple(strides))
    crop = []
    for k, (lo, hi) in reversed(list(zip(w.shape[2:], padding))):
        crop += [lo - (k - 1), hi - (k - 1)]
    return nn.functional.pad(y, crop).movedim(1, -1)  # negative pad crops


def lax_conv(x: torch.Tensor, w: torch.Tensor, strides=None, padding=None,
             rhs_dilation=None, groups: int = 1,
             dtype=None) -> torch.Tensor:
    """`lax.conv_general_dilated` without input dilation over channel-last
    x (N, *spatial, C) with a torch-layout kernel w (out, in/groups, *k),
    1-D or 2-D: x padded by `padding` ((lo, hi) per axis; a negative side
    crops) and correlated with w as it is. Computed in `dtype` (w's when
    None); returns (N, *spatial', out)."""
    nd = x.ndim - 2
    dt = dtype or w.dtype
    h = x.to(dt).movedim(-1, 1)
    if padding is not None:
        flat = []
        for lo, hi in reversed(list(padding)):
            flat += [lo, hi]
        h = nn.functional.pad(h, flat)
    conv = nn.functional.conv1d if nd == 1 else nn.functional.conv2d
    y = conv(h, w.to(dt), None, tuple(strides or (1,) * nd), 0,
             tuple(rhs_dilation or (1,) * nd), groups)
    return y.movedim(1, -1)
