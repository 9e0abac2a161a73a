"""Batched CTC prefix scoring for label-synchronous beam search (port of
espnet_tpu/decode/ctc_prefix.py).

For a prefix g with forward variables r^n / r^b over time, every candidate
extension c of every hypothesis is scored at once, (B, W, K) at a time:

    phi_t      = r_t^b(g) + (c != last(g) ? r_t^n(g) : 0)      [log add]
    r_t^n(g.c) = p_t(c) * (r_{t-1}^n(g.c) + phi_{t-1})
    r_t^b(g.c) = p_t(blank) * (r_{t-1}^b(g.c) + r_{t-1}^n(g.c))
    psi(g.c)   = sum_t phi_{t-1} * p_t(c)
    psi(g.eos) = r_T^n(g) + r_T^b(g)

The JAX package runs the time recursion as one `lax.scan`; here it is a
Python loop of batched ops over the T frames, which on the card costs a few
kernel launches per frame and label step (a kernel candidate for a later
slice). Frames past an utterance's length are padded with p(blank)=1 and
p(c)=0, so they add nothing to psi.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

NEG_INF = -1.0e30


class CTCPrefixState(NamedTuple):
    r: torch.Tensor     # (B, W, T, 2) log r^n (index 0), r^b (index 1) of g
    psi: torch.Tensor   # (B, W) prefix score of g (0 for the empty prefix)
    last: torch.Tensor  # (B, W) last token of g; -1 for empty


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(exp a + exp b), floored at NEG_INF (as the JAX package's
    `_logaddexp` returns NEG_INF when both terms are at or below it)."""
    return torch.logaddexp(a, b).clamp_(min=NEG_INF)


def pad_log_probs(log_probs: torch.Tensor, lengths: torch.Tensor,
                  blank_id: int = 0) -> torch.Tensor:
    """Set frames >= length to one-hot blank in log space."""
    b, t, v = log_probs.shape
    valid = (torch.arange(t, device=log_probs.device)[None, :]
             < lengths[:, None])[:, :, None]
    blank_row = torch.full((v,), NEG_INF, device=log_probs.device)
    blank_row[blank_id] = 0.0
    return torch.where(valid, log_probs, blank_row)


def ctc_prefix_init(log_probs: torch.Tensor, lengths: torch.Tensor, beam: int,
                    blank_id: int = 0) -> Tuple[torch.Tensor, CTCPrefixState]:
    """(padded log_probs, state for W copies of the empty prefix)."""
    lp = pad_log_probs(log_probs, lengths, blank_id)
    b, t, _ = lp.shape
    r_b = torch.cumsum(lp[:, :, blank_id], dim=1)
    r_n = torch.full((b, t), NEG_INF, device=lp.device)
    r = torch.stack([r_n, r_b], dim=-1)[:, None].repeat(1, beam, 1, 1)
    return lp, CTCPrefixState(
        r=r,
        psi=torch.zeros(b, beam, device=lp.device),
        last=torch.full((b, beam), -1, dtype=torch.long, device=lp.device),
    )


def ctc_prefix_score(state: CTCPrefixState, log_probs: torch.Tensor,
                     lengths: torch.Tensor, cand_ids: torch.Tensor,
                     blank_id: int = 0):
    """Score candidate extensions.

    log_probs: (B, T, V) padded (`pad_log_probs`); cand_ids: (B, W, K).
    Returns (psi (B, W, K) prefix scores of g.c, r_new (B, W, K, T, 2)
    forward variables of g.c, psi_eos (B, W) complete-sequence score of g).
    """
    b, t, _ = log_probs.shape
    _, w, k = cand_ids.shape
    dev = log_probs.device
    emit = log_probs.gather(2, cand_ids.reshape(b, 1, w * k).expand(b, t, w * k))
    emit = emit.reshape(b, t, w, k).permute(1, 0, 2, 3).contiguous()  # (T,B,W,K)
    blank = log_probs[:, :, blank_id].t()[:, :, None, None]  # (T, B, 1, 1)

    r_g = state.r.permute(2, 0, 1, 3)  # (T, B, W, 2)
    same = (cand_ids == state.last[:, :, None])[None]  # (1, B, W, K)
    phi = torch.where(same, r_g[..., 1:2],
                      logaddexp(r_g[..., 1:2], r_g[..., 0:1]))  # (T,B,W,K)

    r_all = torch.empty(t, 2, b, w, k, device=dev)
    r_n = torch.full((b, w, k), NEG_INF, device=dev)
    r_b = torch.full((b, w, k), NEG_INF, device=dev)
    psi = torch.full((b, w, k), NEG_INF, device=dev)
    # phi_{-1}: 0 for the empty prefix (its first extension may start
    # anywhere), NEG_INF otherwise
    phi_prev = torch.where((state.last == -1)[:, :, None], 0.0,
                           NEG_INF).expand(b, w, k)
    for ti in range(t):
        e = emit[ti]
        r_n_new = torch.add(e, logaddexp(r_n, phi_prev), out=r_all[ti, 0])
        r_b = torch.add(blank[ti], logaddexp(r_b, r_n), out=r_all[ti, 1])
        psi = logaddexp(psi, phi_prev + e)
        r_n = r_n_new
        phi_prev = phi[ti]
    r_new = r_all.permute(2, 3, 4, 0, 1)  # (B, W, K, T, 2)

    # frame len-1; a length of 0 wraps to the last frame, as JAX's
    # take_along_axis does with index -1
    idx = torch.remainder(lengths - 1, t)[:, None, None, None].expand(b, w, 1, 2)
    r_end = state.r.gather(2, idx)[:, :, 0]  # (B, W, 2)
    psi_eos = logaddexp(r_end[..., 0], r_end[..., 1])
    return psi, r_new, psi_eos


def ctc_prefix_select(state: CTCPrefixState, r_new: torch.Tensor,
                      psi: torch.Tensor, cand_ids: torch.Tensor,
                      src_hyp: torch.Tensor, src_cand: torch.Tensor
                      ) -> CTCPrefixState:
    """Gather the new state of the selected (hyp, candidate) pairs."""
    bi = torch.arange(r_new.shape[0], device=r_new.device)[:, None]
    return CTCPrefixState(
        r=r_new[bi, src_hyp, src_cand],
        psi=psi[bi, src_hyp, src_cand],
        last=cand_ids[bi, src_hyp, src_cand],
    )
