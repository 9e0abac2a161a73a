"""Batched joint CTC/attention beam search (port of
espnet_tpu/decode/beam_search.py `BeamSearchConfig`, `score_candidates` and
`batched_beam_search`).

Same fixed-shape formulation as the JAX package: B utterances x W alive
hypotheses plus a pool of W finished ones, retired slots holding NEG_INF.
Each step scores every vocabulary entry with the full scorers (attention
decoder, optional extra scorers), keeps a pre-beam of K = 1.5 W candidates
(eos always among them), adds the CTC prefix-score delta, takes the best 2W,
retires those that end in eos and keeps the best W others. eos is forced at
maxlen-1; `max_steps` caps the label length. The JAX `lax.while_loop`
becomes a Python loop whose condition is read on the host once per step.

Ties are broken as `lax.top_k` breaks them (lower index first), by a stable
sort, so both frameworks keep the same hypotheses among equal scores.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from espnet_tpu_torch.decode.ctc_prefix import (CTCPrefixState,
                                                ctc_prefix_init,
                                                ctc_prefix_score,
                                                ctc_prefix_select)

NEG_INF = -1.0e30


@dataclasses.dataclass(frozen=True)
class BeamSearchConfig:
    beam_size: int = 10
    pre_beam_ratio: float = 1.5
    att_weight: float = 0.7
    ctc_weight: float = 0.3
    lm_weight: float = 0.0
    penalty: float = 0.0          # length bonus per emitted token
    maxlenratio: float = 0.0      # 0 => maxlen = encoder length
    minlenratio: float = 0.0
    blank_id: int = 0

    @property
    def pre_beam_size(self) -> int:
        return int(self.pre_beam_ratio * self.beam_size)


class BeamState(NamedTuple):
    step: int
    yseq: torch.Tensor       # (B, W, L+1) alive token seqs (incl. sos)
    ylen: torch.Tensor       # (B, W)
    score: torch.Tensor      # (B, W) alive total scores
    att_cache: Any           # decoder KV caches, leading dim B*W
    lm_cache: Any
    ctc: Optional[CTCPrefixState]
    fin_yseq: torch.Tensor   # (B, W, L+1) finished
    fin_ylen: torch.Tensor
    fin_score: torch.Tensor  # (B, W)


def _topk(x: torch.Tensor, k: int):
    """Top k along the last axis, ties to the lower index, padded with
    NEG_INF when fewer than k entries exist."""
    sc, ix = torch.sort(x, dim=-1, descending=True, stable=True)
    sc, ix = sc[..., :k], ix[..., :k]
    short = k - sc.shape[-1]
    if short > 0:
        pad = (0, short)
        sc = torch.nn.functional.pad(sc, pad, value=NEG_INF)
        ix = torch.nn.functional.pad(ix, pad, value=0)
    return sc, ix


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    raise TypeError(f"unsupported cache node {type(tree)}")


def score_candidates(cfg: BeamSearchConfig, s: BeamState, eos: int,
                     vocab_size: int, att_score_fn: Callable,
                     lm_score_fn: Optional[Callable],
                     lp_pad: Optional[torch.Tensor],
                     enc_lengths: torch.Tensor):
    """One step of candidate generation: full scorers, pre-beam top-K (eos
    kept selectable), CTC prefix deltas. Returns (cand_ids (B,W,K),
    cumulative cand_scores (B,W,K), att_cache, lm_cache, psi, r_new)."""
    b, w = s.score.shape
    # floor of 2: the eos rule below claims one slot
    k = min(max(cfg.pre_beam_size, 2), vocab_size)
    use_ctc = cfg.ctc_weight > 0.0 and lp_pad is not None
    last_tok = s.yseq.gather(2, s.ylen[..., None])[..., 0]  # (B, W)
    flat_tok = last_tok.reshape(b * w)

    logp_att, att_cache = att_score_fn(flat_tok, s.step, s.att_cache)
    weighted = cfg.att_weight * logp_att.reshape(b, w, vocab_size) + cfg.penalty
    if lm_score_fn is not None and cfg.lm_weight > 0:
        logp_lm, lm_cache = lm_score_fn(flat_tok, s.step, s.lm_cache)
        weighted = weighted + cfg.lm_weight * logp_lm.reshape(b, w, vocab_size)
    else:
        lm_cache = s.lm_cache

    _, cand_ids = _topk(weighted, k)
    has_eos = (cand_ids == eos).any(dim=-1)
    cand_ids[..., -1] = torch.where(has_eos, cand_ids[..., -1], eos)
    picked = weighted.gather(2, cand_ids)
    if use_ctc:
        psi, r_new, psi_eos = ctc_prefix_score(s.ctc, lp_pad, enc_lengths,
                                               cand_ids, cfg.blank_id)
        ctc_delta = psi - s.ctc.psi[..., None]
        eos_delta = psi_eos - s.ctc.psi
        ctc_delta = torch.where(cand_ids == eos, eos_delta[..., None],
                                ctc_delta)
        cand_scores = picked + cfg.ctc_weight * ctc_delta
    else:
        cand_scores = picked
        psi = r_new = None
    cand_scores = cand_scores + s.score[..., None]
    return cand_ids, cand_scores, att_cache, lm_cache, psi, r_new


def batched_beam_search(
    cfg: BeamSearchConfig,
    sos: int,
    eos: int,
    vocab_size: int,
    enc_lengths: torch.Tensor,          # (B,) encoder frame counts
    att_score_fn: Callable,             # (tokens (N,), pos, cache) -> (logp (N,V), cache)
    att_cache_init: Any,                # caches with leading dim N = B*W
    ctc_log_probs: Optional[torch.Tensor] = None,  # (B, T, V)
    lm_score_fn: Optional[Callable] = None,
    lm_cache_init: Any = None,
    max_steps: Optional[int] = None,    # bound L on the label length
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the search. Returns the finished pool sorted by score:
    (yseq (B, W, L) without sos, ylen (B, W) emitted tokens excluding eos,
    score (B, W))."""
    if max_steps is None:
        raise ValueError("max_steps is required")
    dev = enc_lengths.device
    b = enc_lengths.shape[0]
    w = cfg.beam_size
    k = min(max(cfg.pre_beam_size, 2), vocab_size)
    l_max = max_steps
    use_ctc = cfg.ctc_weight > 0.0 and ctc_log_probs is not None
    use_lm = lm_score_fn is not None and cfg.lm_weight > 0

    if cfg.maxlenratio == 0.0:
        maxlen = enc_lengths.clamp(max=l_max)
    else:
        maxlen = (cfg.maxlenratio * enc_lengths).long().clamp(min=1, max=l_max)
    minlen = (cfg.minlenratio * enc_lengths).long()
    max_maxlen = int(maxlen.max())

    yseq0 = torch.full((b, w, l_max + 1), eos, dtype=torch.long, device=dev)
    yseq0[:, :, 0] = sos
    score0 = torch.full((b, w), NEG_INF, device=dev)
    score0[:, 0] = 0.0
    if use_ctc:
        lp_pad, ctc_state = ctc_prefix_init(ctc_log_probs, enc_lengths, w,
                                            cfg.blank_id)
    else:
        lp_pad, ctc_state = None, None
    s = BeamState(
        step=0, yseq=yseq0, ylen=torch.zeros(b, w, dtype=torch.long, device=dev),
        score=score0, att_cache=att_cache_init, lm_cache=lm_cache_init,
        ctc=ctc_state, fin_yseq=yseq0.clone(),
        fin_ylen=torch.zeros(b, w, dtype=torch.long, device=dev),
        fin_score=torch.full((b, w), NEG_INF, device=dev),
    )
    bi = torch.arange(b, device=dev)[:, None]
    in_top_w = torch.arange(2 * w, device=dev)[None, :] < w
    positions = torch.arange(l_max + 1, device=dev)[None, None, :]

    def running(s: BeamState) -> bool:
        if s.step >= max_maxlen:
            return False
        if cfg.penalty > 0:  # an alive hyp can then still improve
            return True
        # an alive hyp only loses score; once the best alive is below the
        # worst finished and the finished pool is full, nothing improves
        best_alive = s.score.max(dim=1).values
        worst_fin = s.fin_score.min(dim=1).values
        improvable = ((best_alive + 1e-6 > worst_fin)
                      | (worst_fin <= NEG_INF / 2))
        return bool(improvable.any())

    while running(s):
        i = s.step
        cand_ids, cand_scores, att_cache, lm_cache, psi, r_new = (
            score_candidates(cfg, s, eos, vocab_size, att_score_fn,
                             lm_score_fn, lp_pad, enc_lengths))
        # forbid eos before minlen; force eos at the last step of each
        # utterance; past its maxlen an utterance is frozen
        is_eos = cand_ids == eos
        cand_scores = torch.where(is_eos & (i < minlen)[:, None, None],
                                  NEG_INF, cand_scores)
        force = (maxlen - 1 == i)[:, None, None]
        cand_scores = torch.where(force & ~is_eos, NEG_INF, cand_scores)
        cand_scores = torch.where((maxlen <= i)[:, None, None], NEG_INF,
                                  cand_scores)

        # take 2W so that eos retirements do not starve the alive beam
        top_scores, top_idx = _topk(cand_scores.reshape(b, w * k), 2 * w)
        src_hyp = top_idx // k
        src_cand = top_idx % k
        top_tok = cand_ids[bi, src_hyp, src_cand]
        top_is_eos = top_tok == eos

        # finished pool: only eos candidates ranked in the top W retire
        eos_scores = torch.where(top_is_eos & in_top_w, top_scores, NEG_INF)
        all_fin_scores = torch.cat([s.fin_score, eos_scores], dim=1)
        all_fin_yseq = torch.cat([s.fin_yseq, s.yseq[bi, src_hyp]], dim=1)
        all_fin_ylen = torch.cat([s.fin_ylen, s.ylen[bi, src_hyp]], dim=1)
        fin_top, fin_idx = _topk(all_fin_scores, w)

        # alive beam: the best W candidates that are not eos
        alive_scores = torch.where(top_is_eos, NEG_INF, top_scores)
        alive_top, alive_idx = _topk(alive_scores, w)
        a_hyp = src_hyp[bi, alive_idx]
        a_cand = src_cand[bi, alive_idx]
        a_tok = top_tok[bi, alive_idx]
        new_ylen = s.ylen[bi, a_hyp] + 1
        new_yseq = torch.where(positions == new_ylen[..., None],
                               a_tok[..., None], s.yseq[bi, a_hyp])

        # scorer caches follow their source hypothesis (flat B*W index)
        flat_src = (bi * w + a_hyp).reshape(b * w)
        att_cache = _tree_map(lambda c: c[flat_src], att_cache)
        if use_lm:
            lm_cache = _tree_map(lambda c: c[flat_src], lm_cache)
        new_ctc = (ctc_prefix_select(s.ctc, r_new, psi, cand_ids, a_hyp,
                                     a_cand) if use_ctc else None)
        s = BeamState(
            step=i + 1, yseq=new_yseq, ylen=new_ylen, score=alive_top,
            att_cache=att_cache, lm_cache=lm_cache, ctc=new_ctc,
            fin_yseq=all_fin_yseq[bi, fin_idx],
            fin_ylen=all_fin_ylen[bi, fin_idx], fin_score=fin_top,
        )
    return s.fin_yseq[:, :, 1:], s.fin_ylen, s.fin_score
