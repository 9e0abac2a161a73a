"""CTC forced alignment: a batched Viterbi over the extended label lattice
(port of espnet_tpu/ops/ctc_align.py).

The JAX package runs the forward pass as a `lax.scan` storing each cell's
choice and backtracks with a reverse scan; here both are loops over time
of whole-batch tensor steps. The lattice is the CTC loss's
(`ops/ctc.py` `extended_labels`, `transition_mask`): states 0 and 1 at
t = 0, stay / advance / skip after, the skip where the label differs from
the one two states back. The max over the three predecessors keeps JAX's
candidate order (stay, advance, skip), so a tie picks the same
predecessor as `jnp.argmax`: the first. The backtrack is JAX's too: an
utterance enters at its last frame in the better of its two final states,
its frames past the input length read blank.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from espnet_tpu_torch.ops.ctc import extended_labels, transition_mask

NEG = -1.0e30


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (k, 0), value=NEG)[:, :x.shape[1]]


def ctc_forced_align(log_probs: torch.Tensor, labels: torch.Tensor,
                     input_lengths: torch.Tensor,
                     label_lengths: torch.Tensor,
                     blank_id: int = 0) -> torch.Tensor:
    """log_probs (B, T, V) log-softmax, labels (B, U) -> the Viterbi
    state's token id per frame (B, T) (blank_id on blank states and on
    padded frames)."""
    b, t_max, _ = log_probs.shape
    dev = log_probs.device
    labels = labels.long()
    in_lens = input_lengths.long()
    lab_lens = label_lengths.long()
    ext = extended_labels(labels, blank_id)                    # (B, S)
    s_dim = ext.shape[1]
    emit = log_probs.float().gather(
        2, ext[:, None, :].expand(b, t_max, s_dim)).transpose(0, 1)
    skip_ok = transition_mask(ext)
    s_idx = torch.arange(s_dim, device=dev)[None, :]
    valid_s = s_idx < (2 * lab_lens + 1)[:, None]
    neg = torch.full((b, s_dim), NEG, device=dev)
    delta = torch.where((s_idx <= 1) & valid_s, emit[0], neg)
    choices = []
    for t in range(1, t_max):
        stay, diag = delta, _shift(delta, 1)
        skip = torch.where(skip_ok, _shift(delta, 2), neg)
        # first maximum wins, as jnp.argmax over (stay, diag, skip)
        best, choice = stay, torch.zeros_like(delta, dtype=torch.long)
        for k, cand in ((1, diag), (2, skip)):
            better = cand > best
            best = torch.where(better, cand, best)
            choice = torch.where(better, k, choice)
        active = (t < in_lens)[:, None]
        new = torch.where(valid_s, best + emit[t], neg)
        delta = torch.where(active, new, delta)
        choices.append(torch.where(active, choice, 0))
    bi = torch.arange(b, device=dev)
    s_last = 2 * lab_lens
    s_prev = (s_last - 1).clamp(min=0)
    end_state = torch.where(delta[bi, s_last] >= delta[bi, s_prev], s_last,
                            s_prev)
    state = torch.zeros(b, dtype=torch.long, device=dev)
    states = [None] * t_max
    for t in range(t_max - 1, 0, -1):
        active = t < in_lens
        state = torch.where(t == in_lens - 1, end_state, state)
        states[t] = torch.where(active, state, 0)
        prev = state - choices[t - 1][bi, state]
        state = torch.where(active, prev, state)
    states[0] = state
    frame_ids = ext.gather(1, torch.stack(states, dim=1))
    valid_t = torch.arange(t_max, device=dev)[None, :] < in_lens[:, None]
    return torch.where(valid_t, frame_ids, blank_id)


def alignment_to_segments(frame_ids, labels, label_lengths,
                          frame_shift_s: float
                          ) -> List[List[Tuple[int, float, float]]]:
    """Per-frame ids (B, T) -> [(token_id, start_s, end_s), ...] per
    utterance: consecutive frames of one non-blank token (id 0 is blank)
    form a segment."""
    frame_ids = np.asarray(frame_ids.cpu() if isinstance(
        frame_ids, torch.Tensor) else frame_ids)
    out = []
    for row in frame_ids:
        segs, cur = [], None
        for t, tok in enumerate(row.tolist()):
            if cur is not None and tok == cur[0]:
                cur[2] = t + 1
                continue
            if cur is not None and cur[0] != 0:
                segs.append(tuple(cur))
            cur = [tok, t, t + 1]
        if cur is not None and cur[0] != 0:
            segs.append(tuple(cur))
        out.append([(tok, s * frame_shift_s, e * frame_shift_s)
                    for tok, s, e in segs])
    return out
