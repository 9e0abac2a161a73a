"""Back-off n-gram LM: trainer, ARPA IO and a dense scorer (port of
espnet_tpu/lm/ngram.py).

`NgramModel` is host Python, copied from the JAX package so that the ARPA
file it writes is byte for byte JAX's: add-k back-off training,
`save_arpa` / `load_arpa`, `logp` (log10) and `sentence_logp`.

`DenseNgramScorer` compiles a model over an ASR token list into JAX's dense
finite-state tables, (C, V) natural-log `scores` and (C, V) `next_ctx`
transitions (numpy, equal to JAX's), `start_ctx` (the context (<s>,)) and
`eos_scores`. For the beam search (`make_score_fn`, `init_cache`) the cache
is one context id a hypothesis, on the search's device, and a step is two
gathers there: consume the token, read the row. `prefix_scorer` scores a
token after a prefix by walking the same tables on the host, the callable
that the time-synchronous search takes (`decode/timesync.py`).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

LOG10 = math.log(10.0)
SOS = "<s>"
EOS = "</s>"
UNK = "<unk>"


class NgramModel:
    """Katz-style back-off model: ngram -> (log10 prob, log10 backoff)."""

    def __init__(self, order: int,
                 tables: List[Dict[Tuple[str, ...], Tuple[float, float]]]):
        self.order = order
        self.tables = tables  # tables[k] holds (k+1)-grams

    # --- training ---------------------------------------------------------
    @classmethod
    def train(cls, sentences: Sequence[Sequence[str]], order: int = 3,
              add_k: float = 0.1) -> "NgramModel":
        """Add-k smoothed back-off estimation (interpolated-lite: backoff
        weights from leftover mass)."""
        counts = [defaultdict(int) for _ in range(order)]
        for sent in sentences:
            toks = [SOS] + list(sent) + [EOS]
            for n in range(1, order + 1):
                for i in range(len(toks) - n + 1):
                    g = tuple(toks[i:i + n])
                    if n == 1 and g == (SOS,):
                        continue  # ARPA convention: <s> has no unigram prob
                    counts[n - 1][g] += 1
        vocab = sorted({g[0] for g in counts[0]}) + [UNK, SOS]
        v = len(vocab)
        tables: List[Dict] = [dict() for _ in range(order)]
        # unigrams
        total = sum(counts[0].values())
        for w in vocab:
            c = counts[0].get((w,), 0)
            p = (c + add_k) / (total + add_k * v)
            tables[0][(w,)] = (math.log10(p), 0.0)
        # higher orders
        for n in range(2, order + 1):
            ctx_counts = defaultdict(int)
            for g, c in counts[n - 1].items():
                ctx_counts[g[:-1]] += c
            for g, c in counts[n - 1].items():
                ctx_total = ctx_counts[g[:-1]]
                n_types = sum(1 for gg in counts[n - 1] if gg[:-1] == g[:-1])
                p = c / (ctx_total + add_k * n_types) if ctx_total else 0.0
                if p > 0:
                    tables[n - 1][g] = (math.log10(p), 0.0)
            # backoff weight per context: leftover mass (uniform share)
            for ctx, ctx_total in ctx_counts.items():
                n_types = sum(1 for gg in counts[n - 1] if gg[:-1] == ctx)
                leftover = (add_k * n_types) / (ctx_total + add_k * n_types)
                if ctx in tables[n - 2]:
                    lp, _ = tables[n - 2][ctx]
                    tables[n - 2][ctx] = (lp, math.log10(max(leftover, 1e-10)))
        return cls(order, tables)

    # --- ARPA IO ----------------------------------------------------------
    def save_arpa(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write("\\data\\\n")
            for n in range(self.order):
                f.write(f"ngram {n + 1}={len(self.tables[n])}\n")
            for n in range(self.order):
                f.write(f"\n\\{n + 1}-grams:\n")
                for g, (lp, bo) in sorted(self.tables[n].items()):
                    line = f"{lp:.6f}\t{' '.join(g)}"
                    if bo != 0.0:
                        line += f"\t{bo:.6f}"
                    f.write(line + "\n")
            f.write("\n\\end\\\n")

    @classmethod
    def load_arpa(cls, path) -> "NgramModel":
        tables: List[Dict] = []
        cur = None
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line.startswith("\\") and "-grams:" in line:
                    cur = {}
                    tables.append(cur)
                    continue
                if line in ("\\data\\", "\\end\\", "") or line.startswith(
                        "ngram "):
                    continue
                if cur is None:
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    parts = line.split()
                    parts = [parts[0], " ".join(parts[1:])]
                lp = float(parts[0])
                toks = tuple(parts[1].split())
                bo = float(parts[2]) if len(parts) > 2 else 0.0
                cur[toks] = (lp, bo)
        return cls(len(tables), tables)

    # --- direct scoring (host reference path) -----------------------------
    def logp(self, context: Sequence[str], word: str) -> float:
        """log10 P(word | context) with back-off."""
        ctx = tuple(context)[-(self.order - 1):] if self.order > 1 else ()
        while True:
            g = ctx + (word,)
            n = len(g)
            if n <= self.order and g in self.tables[n - 1]:
                return self.tables[n - 1][g][0]
            if not ctx:
                return self.tables[0].get(
                    (word,), self.tables[0].get((UNK,), (-7.0, 0.0))
                )[0]
            bo = 0.0
            if ctx in self.tables[len(ctx) - 1]:
                bo = self.tables[len(ctx) - 1][ctx][1]
            return bo + self.logp(ctx[1:], word)

    def sentence_logp(self, words: Sequence[str]) -> float:
        ctx: Tuple[str, ...] = (SOS,)
        total = 0.0
        for w in list(words) + [EOS]:
            total += self.logp(ctx, w)
            ctx = (ctx + (w,))[-(self.order - 1):] if self.order > 1 else ()
        return total


class DenseNgramScorer:
    """Finite-state compilation of an NgramModel over a token list.

    scores (C, V) natural-log probs; next_ctx (C, V) int32 transitions;
    start_ctx: context id of (<s>,). Token ids follow the ASR token list
    (converter); OOV tokens score as <unk>; the ASR `sos_eos` token scores
    as </s> and restarts at (<s>,).
    """

    def __init__(self, model: NgramModel, token_list: Sequence[str],
                 sos_eos: Optional[str] = "<sos/eos>"):
        v = len(token_list)
        order = model.order
        # enumerate contexts: () plus every observed prefix of len < order
        ctxs = [()]
        seen = {(): 0}
        for n in range(1, order):
            for g in model.tables[n - 1]:
                if g not in seen:
                    seen[g] = len(ctxs)
                    ctxs.append(g)
        c_count = len(ctxs)
        scores = np.zeros((c_count, v), np.float32)
        nxt = np.zeros((c_count, v), np.int32)

        def longest_ctx(tokens: Tuple[str, ...]) -> int:
            t = tokens[-(order - 1):] if order > 1 else ()
            while t and t not in seen:
                t = t[1:]
            return seen.get(t, 0)

        for ci, ctx in enumerate(ctxs):
            for wi, w in enumerate(token_list):
                if sos_eos is not None and w == sos_eos:
                    scores[ci, wi] = model.logp(ctx, EOS) * LOG10
                    nxt[ci, wi] = longest_ctx((SOS,))
                else:
                    scores[ci, wi] = model.logp(ctx, w) * LOG10
                    nxt[ci, wi] = longest_ctx(ctx + (w,))
        self.scores = scores
        self.next_ctx = nxt
        self.start_ctx = seen.get((SOS,), 0)
        self.eos_scores = np.asarray(
            [model.logp(ctx, EOS) * LOG10 for ctx in ctxs], np.float32
        )
        self._tables: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def make_score_fn(self, device=None):
        """score_fn(tokens (N,), pos, cache) -> (natural-log scores (N, V)
        float32, cache) for the batched beam search, the tables on
        `device` (copied there once); the cache holds each hypothesis's
        context id."""
        device = torch.device(device or "cpu")
        if device not in self._tables:
            self._tables[device] = (
                torch.from_numpy(self.scores).to(device),
                torch.from_numpy(self.next_ctx).long().to(device))
        scores, nxt = self._tables[device]

        def score_fn(tokens, pos, cache):
            ctx = nxt[cache, tokens.long()]   # consume the new token
            return scores[ctx], ctx

        return score_fn

    def init_cache(self, n: int, device=None) -> torch.Tensor:
        return torch.full((n,), self.start_ctx, dtype=torch.long,
                          device=device)

    def prefix_scorer(self):
        """lm_score(prefix, token) -> the natural-log score of token id
        `token` after the token ids `prefix` (the hypothesis without
        <sos>): the row that `make_score_fn` reads after consuming the
        prefix, found by walking `next_ctx` from `start_ctx`. The walks
        are memoised by prefix for the life of the returned function (one
        utterance's search)."""
        ctx_of: Dict[Tuple[int, ...], int] = {(): self.start_ctx}

        def context_id(prefix) -> int:
            key = tuple(int(t) for t in prefix)
            known = len(key)
            while key[:known] not in ctx_of:
                known -= 1
            ctx = ctx_of[key[:known]]
            for i in range(known, len(key)):
                ctx = int(self.next_ctx[ctx, key[i]])
                ctx_of[key[:i + 1]] = ctx
            return ctx

        def lm_score(prefix, token) -> float:
            return float(self.scores[context_id(prefix), int(token)])

        lm_score.context_id = context_id
        return lm_score
