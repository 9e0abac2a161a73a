"""Attention heat maps during training (port of espnet_tpu/train/plot.py).

`collect_attention_maps` runs one batch through the model's deterministic
forward with every `models.attention.MultiHeadAttention` capturing its
weights (the JAX package sows them from that module alone, and not from its
flash path: `MultiHeadAttention.capture`); each map is the mean over heads,
(B, Tq, Tk), under JAX's name ("decoder.layer0.src_attn.attn"). The capture
takes the plain attention path, since the kernels never form the weights,
and only while it is on. `dump_attention_plots` writes PNGs under
<out>/att_ws/ep<epoch>/ where matplotlib is installed, as the curves are
written (`train/reporter.py`), and logs a warning elsewhere.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

from espnet_tpu_torch.models.attention import MultiHeadAttention
from espnet_tpu_torch.train.steps import BATCH_KEYS

logger = logging.getLogger("espnet_tpu")


@torch.no_grad()
def collect_attention_maps(model: torch.nn.Module, batch,
                           batch_arg_names: Sequence[str] = BATCH_KEYS
                           ) -> Dict[str, np.ndarray]:
    """{name: (B, T_q, T_k) float32 maps} of one batch."""
    device = next(model.parameters()).device
    args = [torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in batch_arg_names]
    captured: Dict[str, list] = {}
    modules = [(n, m) for n, m in model.named_modules()
               if isinstance(m, MultiHeadAttention)]
    was_training = model.training
    model.eval()
    try:
        for name, m in modules:
            m.capture, m.capture_name = captured, f"{name}.attn"
        model(*args)
    finally:
        for _, m in modules:
            m.capture = None
        model.train(was_training)
    maps = {}
    for name, ws in captured.items():
        maps[name] = ws[0].float().mean(dim=1).cpu().numpy()
    return maps


def dump_attention_plots(model: torch.nn.Module, batch, out_dir, epoch: int,
                         batch_arg_names: Sequence[str] = BATCH_KEYS,
                         tb=None, max_utts: int = 2) -> int:
    """Write heat-map PNGs to <out_dir>/att_ws/ep<epoch>/; returns the
    number of images (0 without matplotlib)."""
    try:
        import matplotlib
    except ImportError:
        logger.warning("matplotlib is not installed: no attention plots in "
                       "%s", Path(out_dir) / "att_ws")
        return 0
    maps = collect_attention_maps(model, batch, batch_arg_names)
    if not maps:
        return 0
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = Path(out_dir) / "att_ws" / f"ep{epoch}"
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    keys = batch.get("keys")
    for name, arr in maps.items():
        for b in range(min(arr.shape[0], max_utts)):
            utt = keys[b] if keys is not None else f"utt{b}"
            fig, ax = plt.subplots(figsize=(5, 4))
            im = ax.imshow(arr[b], aspect="auto", origin="lower",
                           interpolation="nearest")
            fig.colorbar(im, ax=ax)
            ax.set_title(f"{name} {utt}")
            ax.set_xlabel("key frame")
            ax.set_ylabel("query frame")
            safe = name.replace(".", "_")[:80]
            fig.savefig(out / f"{safe}.{utt}.png", bbox_inches="tight")
            plt.close(fig)
            n += 1
            if tb is not None and getattr(tb, "writer", None) is not None:
                tb.writer.add_image(
                    f"attention/{name}/{utt}",
                    (arr[b][None] / max(arr[b].max(), 1e-8)).clip(0, 1),
                    epoch)
    return n
