"""Batched transducer beam searches on fixed (B, W) slabs (port of
espnet_tpu/decode/transducer_search.py).

Four searches, each the JAX package's `lax.scan` program as a Python loop
over frames (or alignment steps) with the scan body's order of operations:

* `batched_transducer_beam_search`: the mAES / expansion family: at most
  `max_expansions` label emissions a frame, the beam recombined on the
  frame's blank-terminated pool;
* `batched_transducer_alsd`: alignment-length synchronous decoding over
  i = t + u, finished hypotheses kept in their own slab;
* `batched_transducer_tsd`: time-synchronous decoding, identical label
  sequences of a frame's pool merged with log-sum-exp;
* `batched_transducer_nsc`: N-step constrained search with the one-label
  prefix merge and the `subtract` dedup of candidates.

Every hypothesis set is a (B, W) slab whose dead entries score NEG_INF, so
the slabs start with W - 1 tied NEG_INF hypotheses. `jax.lax.top_k` breaks
ties toward the lower index; `top_k` here ranks with a stable descending
sort, which keeps tied entries in index order, and so picks the same
entries (`torch.topk` promises no order among ties).

The callbacks: joint_fn(enc (N, De), dec_out (N, H)) -> logits (N, V);
dec_init(n) -> (dec_out (N, H), state) after the blank BOS; dec_step(state,
tokens (N,)) -> (dec_out, state). A state is a nested tuple of tensors with
the hypotheses on the first axis. Each search returns (tokens (B,
max_tokens), lengths (B,), scores (B,)).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

NEG_INF = -1.0e30


@dataclasses.dataclass(frozen=True)
class TransducerSearchConfig:
    beam_size: int = 5
    max_expansions: int = 3   # label emissions allowed per frame (mAES n_step)
    blank_id: int = 0
    max_tokens: int = 256     # output slab length
    score_norm: bool = True   # final scores divided by the label count


class _Beam(NamedTuple):
    yseq: torch.Tensor       # (B, W, Lmax) emitted tokens
    ylen: torch.Tensor       # (B, W)
    score: torch.Tensor      # (B, W) log prob
    dec_out: torch.Tensor    # (B, W, H) prediction-net output for the hyp
    dec_state: Any           # nested tuple of (B, W, ...) tensors


def tree_map(fn, *trees):
    """`fn` over the leaves of nested tuples of tensors."""
    if isinstance(trees[0], (tuple, list)):
        return tuple(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _beam_map(fn, *beams):
    """`fn` over every field of _Beam tuples (the state's leaves too)."""
    return _Beam(*(tree_map(fn, *fields) for fields in zip(*beams)))


def top_k(x, k: int):
    """(values, indices) of the k largest along the last axis, ties toward
    the lower index (`jax.lax.top_k`'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _select(x, idx):
    """Gather along the beam axis: x (B, W, ...), idx (B, K) -> (B, K,
    ...)."""
    bi = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[bi, idx]


def _where_rows(keep, new, old):
    """new where keep (B, W) or (B, 1) else old, broadcast over trailing
    axes."""
    return torch.where(keep.reshape(keep.shape + (1,) * (new.ndim - 2)), new,
                       old)


def _initial_slab(enc, w: int, lmax: int, dec_init):
    b = enc.shape[0]
    dec_out0, dec_state0 = dec_init(b * w)
    h = dec_out0.shape[-1]
    score = torch.where(torch.arange(w, device=enc.device) == 0, 0.0,
                        NEG_INF).float()[None].repeat(b, 1)
    return _Beam(
        yseq=torch.zeros(b, w, lmax, dtype=torch.long, device=enc.device),
        ylen=torch.zeros(b, w, dtype=torch.long, device=enc.device),
        score=score,
        dec_out=dec_out0.reshape(b, w, h),
        dec_state=tree_map(lambda x: x.reshape(b, w, *x.shape[1:]),
                           dec_state0),
    ), h


def _log_probs(joint_fn, enc_rows, dec_out, b, w):
    """log-softmax in float32 of the joint over (B*W) rows -> (B, W, V)."""
    h = dec_out.shape[-1]
    logits = joint_fn(enc_rows, dec_out.reshape(b * w, h)).reshape(b, w, -1)
    return torch.log_softmax(logits.float(), dim=-1)


def _without_blank(lp, blank_id: int):
    lab = lp.clone()
    lab[..., blank_id] = NEG_INF
    return lab


def _extend(cur: _Beam, top_sc, top_ix, v: int, lmax: int, dec_step):
    """The expansion step shared by mAES, TSD and NSC: take the top
    (parent, label) candidates, append the label, step the prediction
    network."""
    b, w = top_sc.shape
    src = torch.div(top_ix, v, rounding_mode="floor")
    tok = top_ix % v
    yseq = _select(cur.yseq, src)
    ylen = _select(cur.ylen, src)
    live = top_sc > NEG_INF / 2
    pos = torch.arange(lmax, device=yseq.device)[None, None, :]
    yseq = torch.where((pos == ylen[..., None]) & live[..., None],
                       tok[..., None], yseq)
    ylen = ylen + live.long()
    sel_state = tree_map(lambda x: _select(x, src), cur.dec_state)
    new_out, new_state = dec_step(
        tree_map(lambda x: x.reshape(b * w, *x.shape[2:]), sel_state),
        tok.reshape(b * w))
    return _Beam(yseq, ylen, top_sc, new_out.reshape(b, w, -1),
                 tree_map(lambda x: x.reshape(b, w, *x.shape[1:]), new_state))


def _gather_stages(stages, exp_idx, src_idx):
    """Stack the stage slabs (E+1 of (B, W, ...)) and gather (stage, slot)
    per (B, W) entry."""
    bi = torch.arange(exp_idx.shape[0], device=exp_idx.device)[:, None]
    return _Beam(*(tree_map(lambda *xs: torch.stack(xs)[exp_idx, bi,
                                                        src_idx], *fields)
                   for fields in zip(*stages)))


def _best(yseq, ylen, score, score_norm: bool):
    if score_norm:
        score = score / ylen.clamp(min=1)
    best = score.argmax(1)
    bi = torch.arange(yseq.shape[0], device=yseq.device)
    return yseq[bi, best], ylen[bi, best], score[bi, best]


def batched_transducer_beam_search(
    enc: torch.Tensor,            # (B, T, De) encoder output
    enc_lengths: torch.Tensor,    # (B,)
    *,
    joint_fn: Callable,
    dec_init: Callable,
    dec_step: Callable,
    config: TransducerSearchConfig = TransducerSearchConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mAES-style search: per frame up to `max_expansions` label
    expansions, the top-W blank-terminated candidates of the frame's pool
    become the next beam."""
    c = config
    b, t_max, _ = enc.shape
    w = c.beam_size
    lmax = c.max_tokens
    beam, _ = _initial_slab(enc, w, lmax, dec_init)
    enc_lengths = enc_lengths.long()
    for t in range(t_max):
        enc_rows = enc[:, t].repeat_interleave(w, 0)
        active_t = t < enc_lengths
        pool_score = torch.full((b, w * (c.max_expansions + 1)), NEG_INF,
                                device=enc.device)
        cur = beam
        stages = []
        for e in range(c.max_expansions + 1):
            stages.append(cur)
            lp = _log_probs(joint_fn, enc_rows, cur.dec_out, b, w)
            v = lp.shape[-1]
            pool_score[:, e * w:(e + 1) * w] = cur.score + lp[..., c.blank_id]
            if e == c.max_expansions:
                break  # the final expansion: everything takes blank
            cand = cur.score[..., None] + _without_blank(lp, c.blank_id)
            cand = torch.where((cur.ylen >= lmax)[..., None],
                               torch.full_like(cand, NEG_INF), cand)
            top_sc, top_ix = top_k(cand.reshape(b, w * v), w)
            cur = _extend(cur, top_sc, top_ix, v, lmax, dec_step)
        nxt_sc, nxt_ix = top_k(pool_score, w)
        new_beam = _gather_stages(
            stages, torch.div(nxt_ix, w, rounding_mode="floor"), nxt_ix % w)
        new_beam = new_beam._replace(score=nxt_sc)
        # frames past the utterance end leave the beam untouched
        keep = active_t[:, None]
        beam = _beam_map(lambda new, old: _where_rows(keep, new, old),
                         new_beam, beam)
    return _best(beam.yseq, beam.ylen, beam.score, c.score_norm)


def batched_transducer_alsd(
    enc: torch.Tensor,
    enc_lengths: torch.Tensor,
    *,
    joint_fn: Callable,
    dec_init: Callable,
    dec_step: Callable,
    config: TransducerSearchConfig = TransducerSearchConfig(),
    u_max: int = 50,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alignment-length synchronous search: each step every live
    hypothesis (at frame t = i - |y|) takes a blank (advancing in time,
    finishing at its last frame) or one of its labels; the top W of all
    W * (V + 1) candidates survive, the finished ones in their own slab."""
    c = config
    b, t_max, de = enc.shape
    w = c.beam_size
    lmax = c.max_tokens
    s, h = _initial_slab(enc, w, lmax, dec_init)
    fin_yseq = torch.zeros_like(s.yseq)
    fin_ylen = torch.zeros_like(s.ylen)
    fin_score = torch.full((b, w), NEG_INF, device=enc.device)
    enc_lengths = enc_lengths.long()
    bi = torch.arange(b, device=enc.device)[:, None]
    pos = torch.arange(lmax, device=enc.device)[None, None, :]
    for i in range(t_max + min(u_max, lmax)):
        t_h = i - s.ylen
        alive = (t_h < enc_lengths[:, None]) & (s.score > NEG_INF / 2)
        enc_th = enc[bi, t_h.clamp(0, t_max - 1)]          # (B, W, De)
        lp = _log_probs(joint_fn, enc_th.reshape(b * w, de), s.dec_out, b, w)
        v = lp.shape[-1]
        neg = torch.full_like(s.score, NEG_INF)
        # blank: advance in time; at the last frame the hypothesis finishes
        blank_sc = torch.where(alive, s.score + lp[..., c.blank_id], neg)
        is_last = t_h == (enc_lengths[:, None] - 1)
        fin_cand = torch.where(is_last, blank_sc, neg)
        blank_alive = torch.where(is_last, neg, blank_sc)
        all_yseq = torch.cat([fin_yseq, s.yseq], 1)
        all_ylen = torch.cat([fin_ylen, s.ylen], 1)
        fin_score, fin_ix = top_k(torch.cat([fin_score, fin_cand], 1), w)
        fin_yseq = all_yseq[bi, fin_ix]
        fin_ylen = all_ylen[bi, fin_ix]
        # labels: emit and stay at frame t
        lab_sc = s.score[..., None] + _without_blank(lp, c.blank_id)
        lab_sc = torch.where((alive & (s.ylen < lmax))[..., None], lab_sc,
                             torch.full_like(lab_sc, NEG_INF))
        pool = torch.cat([blank_alive[..., None], lab_sc], -1)
        top_sc, top_ix = top_k(pool.reshape(b, w * (v + 1)), w)
        src = torch.div(top_ix, v + 1, rounding_mode="floor")
        slot = top_ix % (v + 1)
        tok = (slot - 1).clamp(min=0)
        yseq = _select(s.yseq, src)
        ylen = _select(s.ylen, src)
        emit = (slot != 0) & (top_sc > NEG_INF / 2)
        yseq = torch.where((pos == ylen[..., None]) & emit[..., None],
                           tok[..., None], yseq)
        ylen = ylen + emit.long()
        sel_out = _select(s.dec_out, src)
        sel_state = tree_map(lambda x: _select(x, src), s.dec_state)
        new_out, new_state = dec_step(
            tree_map(lambda x: x.reshape(b * w, *x.shape[2:]), sel_state),
            tok.reshape(b * w))
        new_state = tree_map(lambda x: x.reshape(b, w, *x.shape[1:]),
                             new_state)
        # blank-extended hypotheses keep their prediction-net state
        s = _Beam(yseq, ylen, top_sc,
                  _where_rows(emit, new_out.reshape(b, w, h), sel_out),
                  tree_map(lambda n, o: _where_rows(emit, n, o), new_state,
                           sel_state))
    return _best(fin_yseq, fin_ylen, fin_score, c.score_norm)


def batched_transducer_tsd(
    enc: torch.Tensor,
    enc_lengths: torch.Tensor,
    *,
    joint_fn: Callable,
    dec_init: Callable,
    dec_step: Callable,
    config: TransducerSearchConfig = TransducerSearchConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Time-synchronous search: per frame up to `max_expansions` label
    expansions; the blank extensions of every level form the frame's pool,
    whose identical label sequences are merged with log-sum-exp onto their
    first occurrence before the top-W cut."""
    c = config
    b, t_max, _ = enc.shape
    w = c.beam_size
    lmax = c.max_tokens
    n_exp = c.max_expansions
    p = w * (n_exp + 1)
    beam, _ = _initial_slab(enc, w, lmax, dec_init)
    enc_lengths = enc_lengths.long()
    ar_p = torch.arange(p, device=enc.device)[None, :]
    for t in range(t_max):
        enc_rows = enc[:, t].repeat_interleave(w, 0)
        active_t = t < enc_lengths
        cur = beam
        stages = []
        pool_score = torch.full((b, p), NEG_INF, device=enc.device)
        for e in range(n_exp + 1):
            stages.append(cur)
            lp = _log_probs(joint_fn, enc_rows, cur.dec_out, b, w)
            v = lp.shape[-1]
            pool_score[:, e * w:(e + 1) * w] = cur.score + lp[..., c.blank_id]
            if e == n_exp:
                break
            cand = cur.score[..., None] + _without_blank(lp, c.blank_id)
            cand = torch.where((cur.ylen >= lmax)[..., None],
                               torch.full_like(cand, NEG_INF), cand)
            top_sc, top_ix = top_k(cand.reshape(b, w * v), w)
            cur = _extend(cur, top_sc, top_ix, v, lmax, dec_step)
        pool_yseq = torch.stack([st.yseq for st in stages], 1).reshape(
            b, p, lmax)
        pool_ylen = torch.stack([st.ylen for st in stages], 1).reshape(b, p)
        # log-sum-exp merge of identical label sequences (reference
        # :386-400), the merged mass on the first occurrence
        same = ((pool_ylen[:, :, None] == pool_ylen[:, None, :])
                & (pool_yseq[:, :, None, :] == pool_yseq[:, None, :, :])
                .all(-1))
        first = same.to(torch.uint8).argmax(-1)
        masked = torch.where(same, pool_score[:, None, :].expand(b, p, p),
                             torch.full((b, p, p), NEG_INF,
                                        device=enc.device))
        merged = torch.logsumexp(masked, dim=-1)
        pool_merged = torch.where(first == ar_p, merged,
                                  torch.full_like(merged, NEG_INF))
        nxt_sc, nxt_ix = top_k(pool_merged, w)
        new_beam = _gather_stages(
            stages, torch.div(nxt_ix, w, rounding_mode="floor"), nxt_ix % w)
        new_beam = new_beam._replace(score=nxt_sc)
        keep = active_t[:, None]
        beam = _beam_map(lambda new, old: _where_rows(keep, new, old),
                         new_beam, beam)
    return _best(beam.yseq, beam.ylen, beam.score, c.score_norm)


def _prefix_pairs(yseq, ylen, score):
    """(B, i, j) True where hypothesis i's labels are hypothesis j's but
    its last, both alive."""
    lmax = yseq.shape[-1]
    alive = score > NEG_INF / 2
    len_ok = ylen[:, None, :] == ylen[:, :, None] + 1
    pos = torch.arange(lmax, device=yseq.device)[None, None, None, :]
    agree = ((yseq[:, :, None, :] == yseq[:, None, :, :])
             | (pos >= ylen[:, :, None, None])).all(-1)
    return len_ok & agree & alive[:, :, None] & alive[:, None, :]


def _last_label(yseq, ylen):
    return yseq.gather(-1, (ylen - 1).clamp(min=0)[..., None])[..., 0]


def _prefix_merge(yseq, ylen, score, lp):
    """Prefix search for NSC (`beam_search_transducer.py:174` prefix_search,
    alpha 1): when hypothesis i is a one-label prefix of hypothesis j, fold
    score_i + lp_i[last label of j] into score_j with log-add-exp."""
    b, w, _ = yseq.shape
    pref = _prefix_pairs(yseq, ylen, score)
    last = _last_label(yseq, ylen)                         # (B, W)
    lp_last = lp.gather(2, last[:, None, :].expand(b, w, w))  # (B, i, j)
    contrib = torch.where(pref, score[:, :, None] + lp_last,
                          torch.full_like(lp_last, NEG_INF))
    folded = torch.logsumexp(contrib, dim=1)               # (B, j)
    return torch.where(folded > NEG_INF / 2,
                       torch.logaddexp(score, folded), score)


def _dedup_mask(cur: _Beam, v: int):
    """(B, W, V) True where candidate (parent p, label k) duplicates a
    hypothesis q of the set (yseq_q == yseq_p + [k]): the `subtract`
    set difference (`transducer/utils.py:114`)."""
    pair = _prefix_pairs(cur.yseq, cur.ylen, cur.score)    # (B, p, q)
    onehot = torch.nn.functional.one_hot(_last_label(cur.yseq, cur.ylen),
                                         v).float()        # (B, q, V)
    return torch.bmm(pair.float(), onehot) > 0


def batched_transducer_nsc(
    enc: torch.Tensor,
    enc_lengths: torch.Tensor,
    *,
    joint_fn: Callable,
    dec_init: Callable,
    dec_step: Callable,
    config: TransducerSearchConfig = TransducerSearchConfig(),
    prefix_alpha: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """N-step constrained search: per frame the prefix merge, then `nstep`
    (= max_expansions) rounds that pool the blank extensions and expand
    the top-W label candidates that duplicate no hypothesis of the round;
    the last round's survivors take the frame's closing blank when nstep >
    1. Only prefix_alpha 1 (the reference default), as in JAX."""
    if prefix_alpha != 1:
        raise ValueError("batched NSC supports prefix_alpha=1 only")
    c = config
    b, t_max, _ = enc.shape
    w = c.beam_size
    lmax = c.max_tokens
    nstep = c.max_expansions
    p = w * (nstep + 1)
    beam, _ = _initial_slab(enc, w, lmax, dec_init)
    enc_lengths = enc_lengths.long()
    for t in range(t_max):
        enc_rows = enc[:, t].repeat_interleave(w, 0)
        active_t = t < enc_lengths
        lp = _log_probs(joint_fn, enc_rows, beam.dec_out, b, w)
        v = lp.shape[-1]
        cur = beam._replace(score=_prefix_merge(beam.yseq, beam.ylen,
                                                beam.score, lp))
        pool_score = torch.full((b, p), NEG_INF, device=enc.device)
        stages = []
        for e in range(nstep):
            if e > 0:
                lp = _log_probs(joint_fn, enc_rows, cur.dec_out, b, w)
            stages.append(cur)
            pool_score[:, e * w:(e + 1) * w] = cur.score + lp[..., c.blank_id]
            cand = cur.score[..., None] + _without_blank(lp, c.blank_id)
            cand = torch.where(_dedup_mask(cur, v),
                               torch.full_like(cand, NEG_INF), cand)
            cand = torch.where((cur.ylen >= lmax)[..., None],
                               torch.full_like(cand, NEG_INF), cand)
            top_sc, top_ix = top_k(cand.reshape(b, w * v), w)
            cur = _extend(cur, top_sc, top_ix, v, lmax, dec_step)
        # the last round's survivors close the frame with a blank when
        # several expansions are allowed (`nsc_beam_search:695-703`)
        if nstep != 1:
            lp_f = _log_probs(joint_fn, enc_rows, cur.dec_out, b, w)
            cur = cur._replace(score=cur.score + lp_f[..., c.blank_id])
        stages.append(cur)
        pool_score[:, nstep * w:] = cur.score
        nxt_sc, nxt_ix = top_k(pool_score, w)
        new_beam = _gather_stages(
            stages, torch.div(nxt_ix, w, rounding_mode="floor"), nxt_ix % w)
        new_beam = new_beam._replace(score=nxt_sc)
        keep = active_t[:, None]
        beam = _beam_map(lambda new, old: _where_rows(keep, new, old),
                         new_beam, beam)
    return _best(beam.yseq, beam.ylen, beam.score, c.score_norm)
