"""The CTC lattice kernels' warp walk, on the CPU.

The warp-per-utterance kernels of `csrc/ctc_lattice.cu` run only on the
card, but their bookkeeping is index arithmetic that numpy can repeat. One
warp takes one utterance; lane l holds the strip of PER = ceil(S / 32)
states from l * PER in registers (states past S hold NEG_INF emissions).
A step of alpha reads s-1 and s-2 across the strip's lower edge from lane
l-1 by `shfl.sync.up` (PER = 1: s-2 from lane l-2), and beta reads s+1
and s+2 from above by `shfl.sync.down`; a shuffle from outside the warp
returns the lane's own value, which the kernel masks to NEG_INF. Each
lane stages its strip of a frame's emissions (gamma: and alphas) in ring
slot t mod R, R = `CTC_RING`, by `cp.async` (states past S zero-filled,
read back as NEG_INF): the first R - 1 frames before the loop, then at each
step the frame R - 1 ahead into the slot that the frame before left, and
the next frame's slot read one step ahead of its use. The serial loop stops
at the utterance's length; alpha past it is the frozen state and gamma
alpha + NEG_INF - emit, written without recursion. The log-add-exp of three
takes two exps (the maximum's own term is exp(0) = 1) and one log, in base
2, and adds the emission to the maximum before the log.

This file emulates that walk in float32 and holds alphas, the last alpha
and gamma against the Pallas `ctc_alphas_pallas` / `ctc_gamma_pallas` in
interpret mode and against the port's plain versions. Tolerance as in
tests/test_torch_ctc.py: float32 log-space sums in another order, 1e-5
relative plus 1e-4 absolute. Two mutations must fail it: the s-2 (beta:
s+2) transition taken only inside a lane's strip, and a ring slot read one
frame stale. R and the strip route's largest PER are read from the
kernel source, so the emulation walks the ring and the route that the card
builds."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.ops.pallas_ctc import ctc_alphas_pallas, ctc_gamma_pallas
from espnet_tpu_torch.ops import ctc as tctc
from espnet_tpu_torch.ops import ctc_lattice as tlat


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one thread, and one for the subprocesses this file
    starts: the suite's xdist workers share the CPU, and a worker's extra
    threads oversubscribe it."""
    import os

    import torch as _torch

    n, env = _torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    _torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    _torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env

RTOL, ATOL = 1e-5, 1e-4
NEG = np.float32(tlat.NEG_INF)
LOG2E, LN2 = np.float32(np.log2(np.e)), np.float32(np.log(2.0))
W = 32  # lanes: one warp per utterance

_SOURCE = (Path(tlat.__file__).resolve().parents[1] / "csrc"
           / "ctc_lattice.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SOURCE)[1])


RING = _constant("CTC_RING")  # frame slots of a lane's ring
STRIP_MAX_PER = _constant("CTC_STRIP_MAX_PER")  # states a lane holds


def _per(s):
    """States of one lane's strip: PER = ceil(S / 32)."""
    return -(-s // W)


def _lattice(s, t, lens, label_lens, seed, v=9):
    """emit (T, B, S) float32 and skip (B, S) of seeded logits over v
    symbols for labels of length (S - 1) / 2 rounded up, cut to S states
    (S = 256 is no 2U + 1: its last state is dropped)."""
    rng = np.random.RandomState(seed)
    b = len(lens)
    u = s // 2
    logits = torch.from_numpy(rng.randn(b, t, v).astype(np.float32))
    labels = torch.from_numpy(rng.randint(1, v, (b, max(u, 1))))[:, :u]
    if u > 1:
        labels[0, 1] = labels[0, 0]  # a repeat: no skip into it
    ext = tctc.extended_labels(labels)[:, :s]
    emit = tctc._emissions(logits, ext, torch.logsumexp(logits, -1))
    skip = tctc.transition_mask(ext)
    return (emit.numpy(), skip.numpy(), np.asarray(lens, np.int64),
            np.asarray(label_lens, np.int64))


def _lae3_plus(a, b, c, e):
    """The kernels' log(e^a + e^b + e^c) + e: ms = max(a, b, c, NEG_INF),
    two exps (the max's own term is 1) and one log in base 2, ms + e formed
    before the log is added; no select for the all-NEG_INF case (the log of
    1 to 3 is lost in NEG_INF's rounding)."""
    hi, lo = np.maximum(a, b), np.minimum(a, b)
    ms = np.maximum(hi, np.maximum(c, NEG))
    mid = np.minimum(hi, c)
    x = np.exp2((lo - ms) * LOG2E)
    y = np.exp2((mid - ms) * LOG2E)
    return (np.log2((np.float32(1) + x) + y) * LN2 + (ms + e)).astype(
        np.float32)


def keep(mask):
    """The kernels' masks are added: 0 keeps a value, NEG_INF drops it."""
    return np.where(mask, 0.0, NEG).astype(np.float32)


def _strip(x, per, fill):
    """(S,) -> (32, PER): lane l's registers hold states l*PER .. +PER-1."""
    out = np.full(W * per, fill, x.dtype)
    out[:x.shape[0]] = x
    return out.reshape(W, per)


def _shfl_up(v, d):
    """`__shfl_up_sync(v, d)`: lane l gets lane l-d's value, its own below
    d (the kernel masks those lanes out)."""
    out = v.copy()
    out[d:] = v[:-d]
    return out


def _shfl_down(v, d):
    out = v.copy()
    out[:-d] = v[d:]
    return out


class _Ring:
    """Each lane's ring of R frame slots, all 32 lanes at once. A frame is
    copied into its slot f mod R, the states past S zero-filled; a read adds
    the mask (0, or NEG_INF past S)."""

    def __init__(self, srcs, valid, per, n):
        self.srcs, self.valid, self.per, self.n = srcs, valid, per, n
        self.r = RING
        self.slots = [np.full((self.r, W, per), np.nan, np.float32)
                      for _ in srcs]

    def fill(self, slot, f):
        """Frame f, clamped into [0, n) as the kernels clamp their copies,
        into `slot`."""
        f = min(max(f, 0), self.n - 1)
        for src, slots in zip(self.srcs, self.slots):
            slots[slot] = np.where(self.valid, _strip(src[f], self.per, 0.0),
                                   0.0)

    def read(self, slot):
        mask = np.where(self.valid, 0.0, NEG).astype(np.float32)
        return [slots[slot] + mask for slots in self.slots]


def _alpha_walk(emit, skip, lens, cross_strip=True, stale=0):
    """(alphas, last) as the warp kernel walks them, utterance by utterance:
    the first R - 1 frames into slots 0 .. R-2, then each step refills slot
    wr with the frame R - 1 ahead and reads the next frame's slot rd ahead
    of its use. cross_strip=False takes s-2 only inside a strip; stale=1
    reads the slot one frame behind rd (the mutations)."""
    t_max, b_max, s = emit.shape
    per = _per(s)
    r = RING
    state = np.arange(W * per).reshape(W, per)
    valid = state < s
    lane = np.arange(W)
    below1 = lane >= 1
    below2 = lane >= (1 if per >= 2 else 2)
    alphas = np.empty_like(emit)
    last = np.empty((b_max, s), np.float32)
    for b in range(b_max):
        n = int(np.clip(lens[b], 0, t_max))
        sk = _strip(skip[b], per, False) & valid
        take2 = sk.copy()
        take2[:, 0] &= below2
        if per >= 2:
            take2[:, 1] &= below1
        if not cross_strip:
            take2[:, :2] = False
        a = np.full((W, per), NEG, np.float32)
        if n > 0:
            ring = _Ring([emit[:, b]], valid, per, n)
            for f in range(r - 1):
                ring.fill(f, f)
            e, = ring.read(0)
            fetch, wr, rd = r - 1, r - 1, 1
            for t in range(n):
                ring.fill(wr, fetch)
                fetch, wr = fetch + 1, (wr + 1) % r
                en, = ring.read((rd - stale) % r)
                rd = (rd + 1) % r
                if t == 0:
                    a = np.where(state < 2, e, NEG).astype(np.float32)
                else:
                    up1 = _shfl_up(a[:, -1], 1)
                    up2 = (_shfl_up(a[:, -2], 1) if per >= 2
                           else _shfl_up(a[:, 0], 2))
                    p1 = np.concatenate([(up1 + keep(below1))[:, None],
                                         a[:, :-1]], axis=1)
                    p2 = np.concatenate([up2[:, None], up1[:, None],
                                         a[:, :-2]], axis=1)[:, :per]
                    a = _lae3_plus(a, p1, p2 + keep(take2), e)
                alphas[t, b] = a.reshape(-1)[:s]
                e = en
        alphas[n:, b] = a.reshape(-1)[:s]  # the frozen tail
        last[b] = a.reshape(-1)[:s]
    return alphas, last


def _gamma_walk(emit, skip, lens, label_lens, alphas, cross_strip=True,
                stale=0):
    """gamma as the warp kernel walks it: the tail past the length first,
    then frames n-1 down to 0 through slots f mod R (the mutations as in
    _alpha_walk; stale=1 reads the slot of the frame just read)."""
    t_max, b_max, s = emit.shape
    per = _per(s)
    r = RING
    state = np.arange(W * per).reshape(W, per)
    valid = state < s
    lane = np.arange(W)
    above1 = lane <= W - 2
    above2 = lane <= (W - 2 if per >= 2 else W - 3)
    term = tlat.terminal_states(torch.from_numpy(label_lens), s).numpy()
    gamma = np.empty_like(emit)
    for b in range(b_max):
        n = int(np.clip(lens[b], 0, t_max))
        skf = _strip(skip[b, 2:], per, False)  # s -> s+2
        take2 = skf.copy()
        take2[:, -1] &= above2
        if per >= 2:
            take2[:, -2] &= above1
        if not cross_strip:
            take2[:, max(per - 2, 0):] = False
        tb = _strip(term[b], per, NEG)  # NEG_INF past S
        # frames at or past the length: beta = NEG_INF, no recursion
        gamma[n:, b] = alphas[n:, b] + NEG - emit[n:, b]
        if n == 0:
            continue
        ring = _Ring([emit[:, b], alphas[:, b]], valid, per, n)
        fetch, wr = n - 1, (n - 1) % r
        rd = wr
        for _ in range(r - 1):
            ring.fill(wr, fetch)
            fetch, wr = fetch - 1, (wr - 1) % r
        e, al = ring.read(rd)
        rd = (rd - 1) % r
        beta = np.full((W, per), NEG, np.float32)
        for t in range(n - 1, -1, -1):
            ring.fill(wr, fetch)
            fetch, wr = fetch - 1, (wr - 1) % r
            en, aln = ring.read((rd + stale) % r)
            rd = (rd - 1) % r
            if t == n - 1:
                beta = tb + e
            else:
                dn1 = _shfl_down(beta[:, 0], 1)
                dn2 = (_shfl_down(beta[:, 1], 1) if per >= 2
                       else _shfl_down(beta[:, 0], 2))
                q1 = np.concatenate([beta[:, 1:], (dn1 + keep(above1))[
                    :, None]], axis=1)
                q2 = np.concatenate([beta[:, 2:], dn1[:, None],
                                     dn2[:, None]], axis=1)[:, -per:]
                beta = _lae3_plus(beta, q1, q2 + keep(take2), e)
            gamma[t, b] = (al + beta - e).reshape(-1)[:s]
            e, al = en, aln
    return gamma


def _plain(emit, skip, lens, label_lens):
    te, ts = torch.from_numpy(emit), torch.from_numpy(skip)
    tl = torch.from_numpy(lens)
    alphas, last = tlat.ctc_alphas_plain(te, ts, tl)
    gamma = tlat.ctc_gamma_plain(te, ts, tl, torch.from_numpy(label_lens),
                                 alphas)
    return alphas.numpy(), last.numpy(), gamma.numpy()


def _pallas(emit, skip, lens, label_lens):
    ja, jlast = ctc_alphas_pallas(jnp.asarray(emit), jnp.asarray(skip),
                                  jnp.asarray(lens), tb=8, interpret=True)
    jg = ctc_gamma_pallas(jnp.asarray(emit), jnp.asarray(skip),
                          jnp.asarray(lens), jnp.asarray(label_lens), ja,
                          tb=8, interpret=True)
    return np.asarray(ja), np.asarray(jlast), np.asarray(jg)


def _close(got, want):
    return np.allclose(got, want, rtol=RTOL, atol=ATOL)


# S: 1 (U = 0), 15, the bench's 81 and the strip route's largest, 256;
# ragged lengths with a zero-length and a one-frame utterance, and U = 0
CASES = {
    1: ([19, 13, 0, 1], [0, 0, 0, 0]),
    15: ([19, 12, 0, 1], [7, 5, 0, 1]),
    81: ([19, 17, 0, 2], [8, 6, 0, 1]),
    256: ([19, 11, 0, 1], [127, 5, 0, 3]),
}


@pytest.mark.parametrize("s", sorted(CASES))
def test_walk_matches_pallas_and_plain(s):
    lens, label_lens = CASES[s]
    assert _per(s) <= STRIP_MAX_PER  # the strip route's
    emit, skip, lens, label_lens = _lattice(s, 19, lens, label_lens, s)
    alphas, last = _alpha_walk(emit, skip, lens)
    gamma = _gamma_walk(emit, skip, lens, label_lens, alphas)
    for ref in (_pallas(emit, skip, lens, label_lens),
                _plain(emit, skip, lens, label_lens)):
        for got, want in zip((alphas, last, gamma), ref):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_walk_of_one_frame():
    """T = 1: the first frame is the last; one utterance of length 0."""
    emit, skip, lens, label_lens = _lattice(81, 1, [1, 0, 1], [3, 2, 0], 5)
    alphas, last = _alpha_walk(emit, skip, lens)
    gamma = _gamma_walk(emit, skip, lens, label_lens, alphas)
    for ref in (_pallas(emit, skip, lens, label_lens),
                _plain(emit, skip, lens, label_lens)):
        for got, want in zip((alphas, last, gamma), ref):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_skip_inside_the_strip_only_fails_the_walk():
    """The mutation check: s-2 (beta: s+2) never taken across a strip's
    edge gives finite numbers that the comparison catches."""
    emit, skip, lens, label_lens = _lattice(81, 19, *CASES[81], 81)
    pa, plast, pg = _plain(emit, skip, lens, label_lens)
    alphas, last = _alpha_walk(emit, skip, lens, cross_strip=False)
    assert np.isfinite(alphas).all()
    assert not _close(alphas, pa) and not _close(last, plast)
    gamma = _gamma_walk(emit, skip, lens, label_lens, pa, cross_strip=False)
    assert not _close(gamma, pg)


def test_stale_ring_slot_fails_the_walk():
    """The mutation check: each step reads the slot of the frame it read
    before."""
    emit, skip, lens, label_lens = _lattice(81, 19, *CASES[81], 81)
    pa, plast, pg = _plain(emit, skip, lens, label_lens)
    alphas, last = _alpha_walk(emit, skip, lens, stale=1)
    assert not _close(alphas, pa) and not _close(last, plast)
    gamma = _gamma_walk(emit, skip, lens, label_lens, pa, stale=1)
    assert not _close(gamma, pg)


@pytest.mark.parametrize("s,per,design", [
    (1, 1, "warp per utterance"), (32, 1, "warp per utterance"),
    (33, 2, "warp per utterance"), (81, 3, "warp per utterance"),
    (255, 8, "warp per utterance"), (256, 8, "warp per utterance"),
    (257, 9, "block per utterance"), (4096, 128, "block per utterance")])
def test_route_by_states(monkeypatch, s, per, design):
    """PER = ceil(S / 32) states a lane up to the strip route's 256 (U <=
    127), the block route above, as the source's dispatch switches (one
    case of each PER of the strip route, in both kernels) and as `design`
    reports it from the library's largest strip S; the ring holds 16 frames
    ahead of the one it serves."""
    monkeypatch.setattr(tlat, "strip_max_states", lambda: W * STRIP_MAX_PER)
    assert _per(s) == per and tlat.design(s) == design
    assert W * STRIP_MAX_PER == 256
    for kernel in ("alpha", "gamma"):
        cases = re.findall(rf"case (\d+): return launch_{kernel}_strip<(\d+)>",
                           _SOURCE)
        assert cases == [(str(k), str(k)) for k in range(1, STRIP_MAX_PER + 1)]
    assert RING - 1 >= 16
