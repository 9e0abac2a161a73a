"""Block-synchronous online beam search (port of
espnet_tpu/decode/online_beam_search.py).

As the encoder output grows block by block, label-synchronous steps run
against the partial memory and stop conservatively. A step is computed
speculatively and kept only if it is safe:
* no best-beam candidate repeats a token already in its source hypothesis;
* no best-beam candidate is eos (eos on partial input is unreliable).
Otherwise the step is discarded and the block ends. On the final block the
offline search (`batched_beam_search`) runs to completion from the
committed state. The CTC prefix scorer's forward variables are extended
over newly arrived frames first (`ctc_prefix_extend`).

Between blocks the beam is the offline search's fixed-shape `BeamState`
over a T_max-frame CTC buffer; the JAX `lax.while_loop` becomes a Python
loop whose stop condition is read on the host once per step.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from espnet_tpu_torch.decode.beam_search import (NEG_INF, BeamSearchConfig,
                                                 BeamState, _topk, _tree_map,
                                                 batched_beam_search,
                                                 score_candidates)
from espnet_tpu_torch.decode.ctc_prefix import (ctc_prefix_extend,
                                                ctc_prefix_init,
                                                ctc_prefix_select,
                                                pad_log_probs)


def init_online_state(cfg: BeamSearchConfig, sos: int, eos: int, b: int,
                      t_max: int, max_steps: int, att_cache_init: Any,
                      lm_cache_init: Any = None, vocab_size: int = 0,
                      device=None) -> BeamState:
    """The beam before any audio: W copies of the empty prefix over a
    T_max-frame CTC buffer (`device`: where its tensors live)."""
    w = cfg.beam_size
    yseq0 = torch.full((b, w, max_steps + 1), eos, dtype=torch.long,
                       device=device)
    yseq0[:, :, 0] = sos
    score0 = torch.full((b, w), NEG_INF, device=device)
    score0[:, 0] = 0.0
    ctc_state = None
    if cfg.ctc_weight > 0.0:
        zeros = torch.zeros(b, t_max, vocab_size, device=device)
        _, ctc_state = ctc_prefix_init(
            zeros, torch.zeros(b, dtype=torch.long, device=device), w,
            cfg.blank_id)
    return BeamState(
        step=0, yseq=yseq0,
        ylen=torch.zeros(b, w, dtype=torch.long, device=device),
        score=score0, att_cache=att_cache_init, lm_cache=lm_cache_init,
        ctc=ctc_state, fin_yseq=yseq0.clone(),
        fin_ylen=torch.zeros(b, w, dtype=torch.long, device=device),
        fin_score=torch.full((b, w), NEG_INF, device=device))


def process_block(cfg: BeamSearchConfig, sos: int, eos: int,
                  vocab_size: int, state: BeamState,
                  ctc_log_probs: torch.Tensor, old_lengths: torch.Tensor,
                  new_lengths: torch.Tensor, att_score_fn: Callable,
                  lm_score_fn: Optional[Callable] = None,
                  is_final: bool = False, max_steps: Optional[int] = None
                  ) -> Tuple[BeamState, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Consume one encoder block. ctc_log_probs: (B, T_max, V) buffer whose
    frames below `new_lengths` are real; `old_lengths` frames were already
    extended into `state`. Returns (state, yseq, ylen, score): the finished
    pool on the final block, the alive beam (best first) otherwise."""
    b, w = state.score.shape
    l_max = max_steps
    use_ctc = cfg.ctc_weight > 0.0 and state.ctc is not None
    lp_pad = (pad_log_probs(ctc_log_probs, new_lengths, cfg.blank_id)
              if use_ctc else None)
    if use_ctc:
        state = state._replace(ctc=ctc_prefix_extend(
            state.ctc, lp_pad, old_lengths, new_lengths, cfg.blank_id))

    if is_final:
        yseq, ylen, score = batched_beam_search(
            cfg, sos, eos, vocab_size, new_lengths, att_score_fn,
            state.att_cache, ctc_log_probs=ctc_log_probs if use_ctc else None,
            lm_score_fn=lm_score_fn, lm_cache_init=state.lm_cache,
            max_steps=l_max, initial_state=state)
        return state, yseq, ylen, score

    # maxlen follows the partial encoder length
    if cfg.maxlenratio == 0.0:
        maxlen = new_lengths.clamp(max=l_max)
    else:
        maxlen = (cfg.maxlenratio * new_lengths).long().clamp(min=1,
                                                              max=l_max)
    minlen = (cfg.minlenratio * new_lengths).long()
    max_maxlen = int(maxlen.max())
    use_lm = lm_score_fn is not None and cfg.lm_weight > 0
    dev = state.score.device
    bi = torch.arange(b, device=dev)[:, None]
    positions = torch.arange(l_max + 1, device=dev)[None, None, :]
    s = state
    while s.step < max_maxlen:
        cand_ids, cand_scores, att_cache, lm_cache, psi, r_new = (
            score_candidates(cfg, s, eos, vocab_size, att_score_fn,
                             lm_score_fn, lp_pad, new_lengths))
        is_eos = cand_ids == eos
        cand_scores = torch.where(is_eos & (s.step < minlen)[:, None, None],
                                  NEG_INF, cand_scores)
        cand_scores = torch.where((maxlen <= s.step)[:, None, None], NEG_INF,
                                  cand_scores)
        k = cand_ids.shape[-1]
        top_scores, top_idx = _topk(cand_scores.reshape(b, w * k), w)
        src_hyp = top_idx // k
        src_cand = top_idx % k
        top_tok = cand_ids[bi, src_hyp, src_cand]  # (B, W)

        # the stop conditions, on the would-be beam: an eos, or a token
        # already present in its source hypothesis
        live = top_scores > NEG_INF / 2
        any_eos = ((top_tok == eos) & live).any()
        src_yseq = s.yseq[bi, src_hyp]  # (B, W, L+1)
        valid_pos = positions <= s.ylen[bi, src_hyp][..., None]
        repeated = ((src_yseq == top_tok[..., None]) & valid_pos).any(dim=-1)
        if bool(any_eos | (repeated & live).any()):
            break  # discard the step: the previous state stays

        new_ylen = s.ylen[bi, src_hyp] + 1
        new_yseq = torch.where(positions == new_ylen[..., None],
                               top_tok[..., None], src_yseq)
        flat_src = (bi * w + src_hyp).reshape(b * w)
        s = BeamState(
            step=s.step + 1, yseq=new_yseq, ylen=new_ylen, score=top_scores,
            att_cache=_tree_map(lambda c: c[flat_src], att_cache),
            lm_cache=(_tree_map(lambda c: c[flat_src], lm_cache) if use_lm
                      else lm_cache),
            ctc=(ctc_prefix_select(s.ctc, r_new, psi, cand_ids, src_hyp,
                                   src_cand) if use_ctc else s.ctc),
            fin_yseq=s.fin_yseq, fin_ylen=s.fin_ylen, fin_score=s.fin_score)
    return s, s.yseq[:, :, 1:], s.ylen, s.score
