"""Multi-level and look-ahead word language models for character beam search
(port of espnet_tpu/decode/extlm.py).

Behavioral spec: reference `espnet/lm/pytorch_backend/extlm.py`
(`MultiLevelLM:18`, `LookAheadWordLM:117`, `make_lexical_tree` of
`espnet/lm/lm_utils.py:274`): while a character-level search runs, a
word-level LM is consulted at word boundaries (<space>/<eos>), with either

* `MultiLevelLM`: a character LM scores the transitions inside a word
  (weighted by `subwordlm_weight`) and, when the word completes, the
  word LM's log-probability replaces the characters' accumulated one, or
* `LookAheadWordLM`: the word LM's probability mass is spread over the
  prefix tree, so every character transition carries word-level
  information, with no character LM.

The lexical tree is compiled once into dense arrays (`make_lexical_tree`,
numpy, JAX's): children (N, C), the word id of each node (N,) and each
subtree's word-id range (lo, hi]. A hypothesis's lexical state is one node
index, and a step is gathers and `torch.where` over the beam on the
search's device. The word ids must be assigned in lexicographic order, so
that each subtree covers a contiguous range (the token lists that
`build_token_list` writes for token type "word" are sorted).

Both LMs plug in as position-free step functions
`step(cache, tokens (B,)) -> (logits or log-probs (B, V), cache)` with
`cache_init(b, device)`; a softmax is applied to what they return. The
scorers' `init_cache(b, device)` and `make_score_fn()` fit
`decode/scorers.py` `Scorer` (the score function ignores `pos`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

LOGZERO = -1.0e10
ZERO = 1.0e-10


class LexicalTree(NamedTuple):
    children: np.ndarray   # (N, C) int32, -1 if absent
    word_id: np.ndarray    # (N,) int32, -1 if not a word end
    lo: np.ndarray         # (N,) int32 subtree word-id range (lo, hi]
    hi: np.ndarray


def make_lexical_tree(
    word_dict: Dict[str, int],
    subword_dict: Dict[str, int],
    word_unk: int,
) -> LexicalTree:
    """Dense-array port of `lm_utils.py:274`. Words whose ids are not in
    lexicographically-contiguous subtree ranges break the cumsum lookups —
    sort the word vocabulary before assigning ids."""
    c_size = len(subword_dict)
    children: List[Dict[int, int]] = [{}]
    word_id: List[int] = [-1]
    lo: List[int] = [0]
    hi: List[int] = [0]

    def new_node(wid):
        children.append({})
        word_id.append(-1)
        lo.append(wid - 1)
        hi.append(wid)
        return len(children) - 1

    for w, wid in sorted(word_dict.items(), key=lambda kv: kv[1]):
        if wid <= 0 or wid == word_unk:
            continue
        if any(ch not in subword_dict for ch in w):
            continue
        node = 0
        for i, ch in enumerate(w):
            cid = subword_dict[ch]
            if cid not in children[node]:
                nxt = new_node(wid)
                children[node][cid] = nxt
            else:
                nxt = children[node][cid]
                lo[nxt] = min(lo[nxt], wid - 1)
                hi[nxt] = max(hi[nxt], wid)
            if i == len(w) - 1:
                word_id[nxt] = wid
            node = nxt

    n = len(children)
    arr = np.full((n, c_size), -1, np.int32)
    for ni, succ in enumerate(children):
        for cid, nxt in succ.items():
            arr[ni, cid] = nxt
    return LexicalTree(
        children=arr,
        word_id=np.asarray(word_id, np.int32),
        lo=np.asarray(lo, np.int32),
        hi=np.asarray(hi, np.int32),
    )


def tree_where(flag: torch.Tensor, new, old):
    """`torch.where(flag, new, old)` leaf by leaf over two caches of the
    same structure (tensors with leading dim B, in lists, tuples or
    dicts), `flag` (B,) broadcast over each leaf's trailing dims."""
    if isinstance(new, torch.Tensor):
        return torch.where(flag.reshape(flag.shape + (1,) * (new.ndim - 1)),
                           new, old)
    if isinstance(new, dict):
        return {k: tree_where(flag, new[k], old[k]) for k in new}
    return type(new)(tree_where(flag, n, o) for n, o in zip(new, old))


class _DeviceTree:
    """The lexical tree's arrays as long tensors, one copy a device."""

    def __init__(self, tree: LexicalTree):
        self.tree = tree
        self._on: Dict[torch.device, LexicalTree] = {}

    def on(self, device) -> LexicalTree:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = LexicalTree(*(
                torch.from_numpy(np.asarray(a)).long().to(device)
                for a in self.tree))
        return self._on[device]


def _range_mass(cumsum, lo_ids, hi_ids):
    """cumsum[hi] - cumsum[lo], row by row: the word LM's mass of the word
    ids (lo, hi]."""
    return cumsum.gather(1, hi_ids) - cumsum.gather(1, lo_ids)


class LookAheadWordLM:
    """`extlm.py:117` as a batched scorer.

    cache = (wlm_cache, cumsum (B, Vw), node (B,), fresh (B,)).
    `make_score_fn()` returns the `(tokens, pos, cache) -> (logp, cache)`
    function of the beam search's scorer slot (pos ignored).
    """

    def __init__(
        self,
        wordlm_step: Callable,
        wordlm_cache_init: Callable,
        tree: LexicalTree,
        word_eos: int,
        word_unk: int,
        space: int,
        eos: int,
        subword_size: int,
        sos: int = None,
        oov_penalty: float = 1e-4,
    ):
        self.wordlm_step = wordlm_step
        self.wordlm_cache_init = wordlm_cache_init
        self.tree = _DeviceTree(tree)
        self.word_eos = word_eos
        self.word_unk = word_unk
        self.space = space
        self.eos = eos
        self.sos = eos if sos is None else sos
        self.c_size = subword_size
        self.oov_penalty = oov_penalty

    def init_cache(self, b: int, device=None):
        """The word LM primed with <eos>, its cumulative word
        distribution, the root node and `fresh` set."""
        wlm_cache = self.wordlm_cache_init(b, device)
        logits, wlm_cache = self.wordlm_step(
            wlm_cache, torch.full((b,), self.word_eos, dtype=torch.long,
                                  device=device))
        cumsum = torch.cumsum(torch.softmax(logits.float(), -1), -1)
        return (wlm_cache, cumsum,
                torch.zeros(b, dtype=torch.long, device=device),
                torch.ones(b, dtype=torch.bool, device=device))

    def make_score_fn(self):
        space, eos, sos = self.space, self.eos, self.sos
        unk, oov = self.word_unk, self.oov_penalty
        c_size = self.c_size

        def score(tokens, pos, cache):
            del pos
            wlm_cache, cumsum, node, fresh = cache
            tree = self.tree.on(tokens.device)
            b = tokens.shape[0]
            xi = tokens.long()
            boundary = (xi == space) | (xi == sos) | fresh

            # inter-word: feed the completed word (or unk; eos when fresh)
            node_safe = node.clamp(min=0)
            wid = tree.word_id[node_safe]
            w = torch.where(wid >= 0, wid, torch.full_like(wid, unk))
            w = torch.where(fresh, torch.full_like(w, self.word_eos), w)
            logits, wlm_cache_new = self.wordlm_step(wlm_cache, w)
            cumsum_new = torch.cumsum(torch.softmax(logits.float(), -1), -1)
            cumsum = torch.where(boundary[:, None], cumsum_new, cumsum)
            wlm_cache = tree_where(boundary, wlm_cache_new, wlm_cache)

            child = tree.children[node_safe, xi.clamp(0, c_size - 1)]
            new_node = torch.where(
                boundary, torch.zeros_like(child),
                torch.where(node >= 0, child, torch.full_like(child, -1)))

            # the look-ahead distribution over every next character: a
            # subtree of word ids (lo, hi] has mass cumsum[hi] - cumsum[lo]
            # (`extlm.py:171-199`)
            nn_safe = new_node.clamp(min=0)
            sum_prob = torch.where(
                nn_safe == 0, torch.ones_like(cumsum[:, 0]),
                _range_mass(cumsum, tree.lo[nn_safe][:, None],
                            tree.hi[nn_safe][:, None])[:, 0])
            ch_all = tree.children[nn_safe]                 # (B, C)
            ch_safe = ch_all.clamp(min=0)
            child_mass = _range_mass(cumsum, tree.lo[ch_safe],
                                     tree.hi[ch_safe])
            unk_ids = torch.full((b, 1), unk, dtype=torch.long,
                                 device=xi.device)
            unk_prob = _range_mass(cumsum, unk_ids - 1, unk_ids)[:, 0]
            denom = sum_prob.clamp(min=ZERO)
            y = torch.where(ch_all >= 0, child_mass / denom[:, None],
                            (unk_prob * oov)[:, None])      # (B, C)

            # word-end columns: <space>/<eos> carry the word probability
            wid_new = tree.word_id[nn_safe]
            wid_safe = wid_new.clamp(min=1)[:, None]
            wlm_prob = _range_mass(cumsum, wid_safe - 1,
                                   wid_safe)[:, 0] / denom
            col = torch.where(
                wid_new >= 0, wlm_prob,
                torch.where(boundary, torch.full_like(wlm_prob, ZERO),
                            unk_prob * oov))
            y[:, space] = col
            y[:, eos] = col

            log_y = torch.log(y.clamp(min=ZERO))
            # a dead subtree (sum_prob ~ 0) scores logzero, as the
            # reference; open vocabulary (node -1) scores 0
            dead = (sum_prob < ZERO) & (nn_safe > 0)
            log_y = torch.where(dead[:, None],
                                torch.full_like(log_y, LOGZERO), log_y)
            log_y = torch.where((new_node < 0)[:, None],
                                torch.zeros_like(log_y), log_y)
            return log_y, (wlm_cache, cumsum, new_node,
                           torch.zeros_like(fresh))

        return score


class MultiLevelLM:
    """`extlm.py:18` (MultiLevelLM) as a batched scorer: a character LM
    scores the transitions inside a word (scaled by `subwordlm_weight`) and
    at a word boundary the accumulated character log-prob is replaced by
    the word LM's log-prob. The <space>/<eos> columns carry
    `wordlm_logprob(word) - accumulated_char_logprob` for word-end nodes,
    `wordlm_logprob(<unk>) + log(oov_penalty)` otherwise, and logzero right
    after a boundary.

    cache = (clm_cache, wlm_cache, wlm_logprobs (B, Vw), node (B,),
             prev_log_y (B, C), clm_logprob (B,), fresh (B,)).
    The reference's `final()` (the word LM's <eos> score at the end of a
    hypothesis) is a search-level hook; here the <eos> column carries the
    same substitution score as <space>, as JAX does.
    """

    def __init__(
        self,
        wordlm_step: Callable,
        wordlm_cache_init: Callable,
        subwordlm_step: Callable,
        subwordlm_cache_init: Callable,
        tree: LexicalTree,
        word_eos: int,
        word_unk: int,
        space: int,
        eos: int,
        subword_size: int,
        subwordlm_weight: float = 0.8,
        oov_penalty: float = 1.0,
        open_vocab: bool = True,
    ):
        self.wordlm_step = wordlm_step
        self.wordlm_cache_init = wordlm_cache_init
        self.clm_step = subwordlm_step
        self.clm_cache_init = subwordlm_cache_init
        self.tree = _DeviceTree(tree)
        self.word_eos = word_eos
        self.word_unk = word_unk
        self.space = space
        self.eos = eos
        self.c_size = subword_size
        self.weight = subwordlm_weight
        self.log_oov = float(np.log(oov_penalty))
        self.open_vocab = open_vocab

    def init_cache(self, b: int, device=None):
        wlm_cache = self.wordlm_cache_init(b, device)
        logits, wlm_cache = self.wordlm_step(
            wlm_cache, torch.full((b,), self.word_eos, dtype=torch.long,
                                  device=device))
        wlm_logprobs = torch.log_softmax(logits.float(), -1)
        clm_cache = self.clm_cache_init(b, device)
        return (clm_cache, wlm_cache, wlm_logprobs,
                torch.zeros(b, dtype=torch.long, device=device),
                torch.zeros(b, self.c_size, device=device),
                torch.zeros(b, device=device),
                torch.ones(b, dtype=torch.bool, device=device))

    def make_score_fn(self):
        space, eos = self.space, self.eos
        unk = self.word_unk

        def score(tokens, pos, cache):
            del pos
            (clm_cache, wlm_cache, wlm_logprobs, node, prev_log_y,
             clm_logprob, fresh) = cache
            tree = self.tree.on(tokens.device)
            xi = tokens.long()
            boundary = (xi == space) & ~fresh

            # inter-word: feed the finished word (unk where the node is not
            # a word end); fresh rows were primed with <eos> in init_cache
            # and only reset the tree position
            node_safe = node.clamp(min=0)
            wid = torch.where(node >= 0, tree.word_id[node_safe],
                              torch.full_like(node, -1))
            w = torch.where(wid >= 0, wid, torch.full_like(wid, unk))
            z_wlm, wlm_cache_new = self.wordlm_step(wlm_cache, w)
            wlm_logprobs = torch.where(
                boundary[:, None], torch.log_softmax(z_wlm.float(), -1),
                wlm_logprobs)
            wlm_cache = tree_where(boundary, wlm_cache_new, wlm_cache)

            # the tree transition and the characters' accumulated log-prob
            child = torch.where(
                node >= 0,
                tree.children[node_safe, xi.clamp(0, self.c_size - 1)],
                torch.full_like(node, -1))
            reset = boundary | fresh
            new_node = torch.where(reset, torch.zeros_like(child), child)
            step_lp = prev_log_y.gather(1, xi[:, None])[:, 0]
            clm_logprob = torch.where(reset, torch.zeros_like(clm_logprob),
                                      clm_logprob + step_lp)
            if self.open_vocab:
                dead = torch.zeros_like(reset)
            else:
                dead = (~reset) & (child < 0)

            # the character LM steps every time (reference extlm.py:85-86)
            z_clm, clm_cache = self.clm_step(clm_cache, xi)
            log_y = torch.log_softmax(z_clm.float(), -1) * self.weight

            # the word-level substitution on the <space>/<eos> columns
            nn_safe = new_node.clamp(min=0)
            wid_new = torch.where(new_node >= 0, tree.word_id[nn_safe],
                                  torch.full_like(new_node, -1))
            sub = torch.where(
                wid_new >= 0,
                wlm_logprobs.gather(1, wid_new.clamp(min=0)[:, None])[:, 0]
                - clm_logprob,
                wlm_logprobs[:, unk] + self.log_oov)
            col = torch.where(reset, torch.full_like(sub, LOGZERO), sub)
            log_y[:, space] = col
            log_y[:, eos] = col
            log_y = torch.where(dead[:, None],
                                torch.full_like(log_y, LOGZERO), log_y)
            return log_y, (clm_cache, wlm_cache, wlm_logprobs, new_node,
                           log_y, clm_logprob, torch.zeros_like(fresh))

        return score
