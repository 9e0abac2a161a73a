"""Greedy (best-path) CTC decoding (port of espnet_tpu/decode/ctc_greedy.py).

Argmax per frame, on the log-probs' device -> collapse repeats -> drop
blanks. The collapse runs on the host per utterance (its output length
varies).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def framewise_argmax(log_probs: torch.Tensor) -> torch.Tensor:
    """(B, T, V) -> (B, T) best label per frame."""
    return torch.argmax(log_probs, dim=-1)


def collapse_ctc(path, blank_id: int = 0) -> List[int]:
    out: List[int] = []
    prev = -1
    for p in path:
        p = int(p)
        if p != prev and p != blank_id:
            out.append(p)
        prev = p
    return out


def ctc_greedy_decode(log_probs, lengths, blank_id: int = 0
                      ) -> List[List[int]]:
    """log_probs: (B, T, V) tensor (or array); lengths: (B,). Returns token
    id lists."""
    paths = framewise_argmax(torch.as_tensor(log_probs)).cpu().numpy()
    lengths = np.asarray(torch.as_tensor(lengths).cpu())
    return [collapse_ctc(paths[i, :lengths[i]], blank_id)
            for i in range(paths.shape[0])]
