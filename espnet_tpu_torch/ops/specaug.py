"""SpecAugment (port of espnet_tpu/ops/specaug.py): time warp, frequency
masks and time masks on (B, T, D) features.

Each augmentation is split in two: `draw_*` takes its random parameters
from a `torch.Generator`, and the function of the JAX package's name applies
given parameters. The JAX package draws the same quantities from its key (a
uniform for the warp centre and an integer shift; integer mask widths and
uniforms for the mask starts), so a test can hand JAX's draws to the port.
The rest follows the JAX package: the linear-interpolation warp with
identity past the length and for utterances of at most 2·window+2 frames,
and the adaptive width cap that keeps the time masks from covering a short
utterance.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def draw_time_warp(generator: torch.Generator, b: int, window: int = 5):
    """(uniform (B,) for the centre, integer shift (B,) in [-w, w])."""
    u = torch.rand(b, generator=generator, device=generator.device)
    shift = torch.randint(-window, window + 1, (b,), generator=generator,
                          device=generator.device)
    return u, shift


def draw_masks(generator: torch.Generator, b: int, num_masks: int,
               width_range: Tuple[int, int]):
    """(integer widths (B, n) in [w0, w1), uniforms (B, n) for the starts)."""
    widths = torch.randint(width_range[0], width_range[1], (b, num_masks),
                           generator=generator, device=generator.device)
    u = torch.rand(b, num_masks, generator=generator,
                   device=generator.device)
    return widths, u


def time_warp(x, lengths, u, shift, window: int = 5):
    """Stretch [0, c) onto [0, c + shift) and [c, L) onto [c + shift, L),
    c = window+1 + floor(u * (max(L - window, window+2) - window - 1))."""
    b, t, _ = x.shape
    dev = x.device
    lens = (torch.full((b,), t, dtype=torch.int64, device=dev)
            if lengths is None else lengths.to(dev).long())
    u, shift = u.to(dev).float(), shift.to(dev)
    lo = torch.full((b,), window + 1, dtype=torch.int64, device=dev)
    hi = torch.maximum(lens - window, lo + 1)
    c = (lo + (u * (hi - lo).float()).long()).float()
    wp = c + shift.float()
    lens_f = lens.float()
    pos = torch.arange(t, dtype=torch.float32, device=dev)[None, :]
    left = pos * (c / wp.clamp(min=1.0))[:, None]
    right = (c[:, None] + (pos - wp[:, None])
             * ((lens_f - 1.0 - c) / (lens_f - 1.0 - wp).clamp(min=1.0))[:, None])
    src = torch.where(pos < wp[:, None], left, right)
    identity = (pos >= lens_f[:, None]) | (lens[:, None] <= 2 * window + 2)
    src = torch.where(identity, pos.expand(b, t),
                      torch.minimum(src.clamp(min=0.0), lens_f[:, None] - 1.0))
    i0 = torch.floor(src).long()
    frac = (src - i0.float()).to(x.dtype)[:, :, None]
    i1 = (i0 + 1).clamp(max=t - 1)
    d = x.shape[2]
    g0 = x.gather(1, i0[:, :, None].expand(b, t, d))
    g1 = x.gather(1, i1[:, :, None].expand(b, t, d))
    return g0 * (1 - frac) + g1 * frac


def mask_along_axis(x, lengths, axis: int, widths, u):
    """Zero `widths.shape[1]` spans per utterance along `axis` (1 = time,
    where spans stay within the length, 2 = frequency)."""
    b = x.shape[0]
    size = x.shape[axis]
    n = widths.shape[1]
    widths = widths.to(x.device).long()
    if axis == 1 and lengths is not None:
        limit = lengths.to(x.device).long()[:, None]
        widths = torch.minimum(widths, (limit // (2 * n)).clamp(min=1))
    else:
        limit = size
        widths = widths.clamp(max=max(size // (2 * n), 1))
    starts = (u.to(x.device).float()
              * (limit - widths).clamp(min=1).float()).long()
    pos = torch.arange(size, device=x.device)[None, None, :]
    masked = (pos >= starts[:, :, None]) & (pos < (starts + widths)[:, :, None])
    keep = ~masked.any(dim=1)  # (B, size)
    shape = [b, 1, 1]
    shape[axis] = size
    return x * keep.reshape(shape).to(x.dtype)


def draw_specaug(generator: torch.Generator, b: int, *,
                 apply_time_warp: bool = True, time_warp_window: int = 5,
                 num_freq_masks: int = 2,
                 freq_mask_width: Tuple[int, int] = (0, 20),
                 num_time_masks: int = 2,
                 time_mask_width: Tuple[int, int] = (0, 100)) -> Dict:
    """All random parameters of one `specaug` call."""
    params = {}
    if apply_time_warp:
        params["time_warp"] = draw_time_warp(generator, b, time_warp_window)
    if num_freq_masks:
        params["freq"] = draw_masks(generator, b, num_freq_masks,
                                    freq_mask_width)
    if num_time_masks:
        params["time"] = draw_masks(generator, b, num_time_masks,
                                    time_mask_width)
    return params


def specaug_apply(x, lengths: Optional[torch.Tensor], params: Dict,
                  time_warp_window: int = 5):
    """Time warp, then frequency masks, then time masks, as drawn."""
    if "time_warp" in params:
        x = time_warp(x, lengths, *params["time_warp"], time_warp_window)
    if "freq" in params:
        x = mask_along_axis(x, lengths, 2, *params["freq"])
    if "time" in params:
        x = mask_along_axis(x, lengths, 1, *params["time"])
    return x


def specaug(generator: torch.Generator, x, lengths=None, *,
            apply_time_warp: bool = True, time_warp_window: int = 5,
            num_freq_masks: int = 2,
            freq_mask_width: Tuple[int, int] = (0, 20),
            num_time_masks: int = 2,
            time_mask_width: Tuple[int, int] = (0, 100)):
    """SpecAugment of (B, T, D) features with parameters from `generator`;
    defaults as the JAX package's (time warp 5, 2 + 2 masks)."""
    params = draw_specaug(
        generator, x.shape[0], apply_time_warp=apply_time_warp,
        time_warp_window=time_warp_window, num_freq_masks=num_freq_masks,
        freq_mask_width=freq_mask_width, num_time_masks=num_time_masks,
        time_mask_width=time_mask_width)
    return specaug_apply(x, lengths, params, time_warp_window)
