"""The bf16 rel-pos forward's tile walk, on the CPU.

The tensor-core forward (`relpos_attention_fwd_tc_kernel`,
`csrc/relpos_attention.cu`) runs only on the card, but its walk is index
arithmetic and rounding that numpy can repeat: a block of 64 query rows
takes the keys in 64 x 64 tiles; per tile, ac = Qu·Kᵀ, and each of its 4
warps (16 query rows) takes an 80-row band of Qv·Pwᵀ starting at window
row 48 - 16w of the tile's 128-row p window (p row `slab_p_row(T, n)` +
64 kt + w) and reads query row r, key c at window row 63 - r + c; an
online softmax in float32 over the keys below T; out = acc / max(l, 1e-30).
In bf16 the kernel rounds Qu = q + u and Qv = q + v, and the unnormalised
probabilities before P·V (l sums them unrounded), as the Pallas
`_fwd_kernel` does. This file emulates that walk and holds it against the
Pallas forward in interpret mode and `relpos_attention_reference`; a band
moved by one row fails (`test_shifted_band_fails_the_emulation`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.ops.pallas_relpos_attention import (relpos_attention_reference,
                                                    relpos_flash_attention)
from espnet_tpu_torch.ops import relpos_attention as trel


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

BLK = 64
BAND = 80
NEG = np.float32(trel.NEG)
# float32: the same sums in another order
TOL = 1e-4


def _bf16(x):
    """x rounded to bf16 (to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _inputs(b, h, t, d, lengths, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    p = rng.randn(h, 2 * t - 1, d).astype(np.float32)
    u, vb = (0.3 * rng.randn(h, d).astype(np.float32) for _ in range(2))
    valid = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    # NEG, not -inf: the Pallas kernel clamps nothing, and with NEG every
    # implementation gives a fully masked row uniform weights
    bias = np.where(valid, 0.0, NEG).astype(np.float32)
    return q, k, v, p, u, vb, bias


def _rows(x, r0, n):
    """Rows r0 .. r0+n-1 of x, zeros outside it (the kernel's zero-fill)."""
    out = np.zeros((n,) + x.shape[1:], np.float32)
    lo, hi = max(r0, 0), min(r0 + n, x.shape[0])
    if hi > lo:
        out[lo - r0:hi - r0] = x[lo:hi]
    return out


def _emulate(q, k, v, p, u, vb, bias, bf16=False, band_shift=0):
    """The forward kernel's output and (m, l) statistics, tile by tile;
    `bf16` takes the kernel's bf16 rounding points (inputs must then hold
    bf16 values), `band_shift` moves every warp's band start."""
    rnd = _bf16 if bf16 else (lambda x: x)
    b, h, t, d = q.shape
    nq = -(-t // BLK)
    scale = np.float32(1.0 / np.sqrt(d))
    out = np.zeros((b, h, t, d), np.float32)
    stats = np.zeros((b, h, t, 2), np.float32)
    c = np.arange(BLK)[None, :]
    for bb in range(b):
        kb = np.maximum(_rows(bias[bb], 0, BLK * nq), NEG)
        for hh in range(h):
            qu = rnd(_rows(q[bb, hh], 0, BLK * nq) + rnd(u[hh]))
            qv = rnd(_rows(q[bb, hh], 0, BLK * nq) + rnd(vb[hh]))
            kk, vv = (_rows(x[bb, hh], 0, BLK * nq) for x in (k, v))
            for n in range(nq):
                i0 = BLK * n
                acc = np.zeros((BLK, d), np.float32)
                m = np.full(BLK, NEG, np.float32)
                l_ = np.zeros(BLK, np.float32)
                for kt in range(nq):
                    j0 = BLK * kt
                    cols = slice(j0, j0 + BLK)
                    pw = _rows(p[hh], trel.slab_p_row(t, n) + j0, 2 * BLK)
                    sc = qu[i0:i0 + BLK] @ kk[cols].T
                    for w in range(4):
                        wb0 = 48 - 16 * w + band_shift
                        rows = slice(i0 + 16 * w, i0 + 16 * w + 16)
                        band = qv[rows] @ pw[wb0:wb0 + BAND].T  # (16, 80)
                        rr = np.arange(16)[:, None]
                        sc[16 * w:16 * w + 16] += band[rr, 15 - rr + c]
                    s = sc * scale + kb[None, cols]
                    ok = j0 + c < t
                    m_new = np.maximum(m, np.where(ok, s, NEG).max(axis=1))
                    alpha = np.exp(m - m_new)
                    with np.errstate(over="ignore"):  # keys past T
                        pr = np.where(ok, np.exp(s - m_new[:, None]),
                                      0).astype(np.float32)
                    l_ = l_ * alpha + pr.sum(axis=1)
                    acc = acc * alpha[:, None] + rnd(pr) @ vv[cols]
                    m = m_new
                rows = min(BLK, t - i0)
                out[bb, hh, i0:i0 + rows] = (
                    acc / np.maximum(l_, 1e-30)[:, None])[:rows]
                stats[bb, hh, i0:i0 + rows] = np.stack([m, l_], 1)[:rows]
    return rnd(out), stats


def _jax(fn, q, k, v, p, u, vb, bias, dtype=jnp.float32):
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v, p)]
    args += [jnp.asarray(u), jnp.asarray(vb)]
    return np.asarray(fn(*args, jnp.asarray(bias[:, None, None, :]))
                      .astype(jnp.float32))


def _close(got, want):
    atol = TOL * (1.0 + float(np.abs(want).max()))
    return bool(np.all(np.abs(got - want) <= atol + TOL * np.abs(want)))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("t", [64, 200, 469])
def test_tile_walk_matches_pallas_and_reference(t):
    """float32, ragged keys, utterance 2 with every key masked: the
    reference takes the whole batch (a masked row averages v over the T
    keys); the Pallas kernel, which averages over its padded key length
    there, the other two. At T = 200 the Pallas kernel runs two 128-row
    blocks (`_fwd_kernel`), at 469 one of 512."""
    lengths = (t, t // 3, 0)
    args = _inputs(3, 2, t, 32, lengths, t)
    got, _ = _emulate(*args)
    assert _close(got, _jax(relpos_attention_reference, *args))
    sub = tuple(a[:2] for a in args[:3]) + args[3:6] + (args[6][:2],)
    block = 128 if t == 200 else None
    pal = _jax(lambda *a: relpos_flash_attention(*a, block=block,
                                                 interpret=True), *sub)
    assert _close(got[:2], pal)


def test_statistics_are_the_rows_softmax_max_and_sum():
    """The (m, l) the kernel writes for the backward: m the row's largest
    score over the keys below T, l = sum_j exp(s_ij - m), so that
    exp(s - m) / l sums to one over a row; a fully masked row has m = NEG
    and l = T."""
    t = 130
    q, k, v, p, u, vb, bias = _inputs(2, 2, t, 32, (t, 0), 1)
    _, stats = _emulate(q, k, v, p, u, vb, bias)
    i = np.arange(t)[:, None]
    j = np.arange(t)[None, :]
    for bb in range(2):
        for hh in range(2):
            qu, qv = q[bb, hh] + u[hh], q[bb, hh] + vb[hh]
            bd = (qv @ p[hh].T)[i, t - 1 - i + j]
            s = (qu @ k[bb, hh].T + bd) / np.sqrt(32) + bias[bb][None, :]
            m = s.max(axis=1)
            np.testing.assert_allclose(stats[bb, hh, :, 0], m, rtol=1e-5,
                                       atol=1e-4)
            l_ = np.exp(s - stats[bb, hh, :, :1]).sum(axis=1)
            np.testing.assert_allclose(stats[bb, hh, :, 1], l_, rtol=1e-4)
    assert (stats[1, :, :, 0] == NEG).all() and (stats[1, :, :, 1] == t).all()


def test_bf16_rounding_points_come_nearer_the_pallas_kernel():
    """bf16 q, k, v, p: the emulation with the kernel's rounding points
    (bf16 Qu and Qv, P rounded before P·V, l unrounded) against the Pallas
    kernel on the same bf16 inputs, beside `relpos_attention_plain` (float32
    throughout, rounded once at the end). Both outputs are bf16, so they
    differ by one bf16 ulp (2^-8 of a value) wherever the two round a sum
    taken in another order (or an exp) to different sides: relative L2
    2e-3 bounds that. The plain version differs by the rounding points
    themselves on top, and must be farther away."""
    t = 200
    q, k, v, p, u, vb, bias = _inputs(2, 2, t, 32, (t, 131), 2)
    q, k, v, p = (_bf16(x) for x in (q, k, v, p))
    pal = _jax(lambda *a: relpos_flash_attention(*a, block=128,
                                                 interpret=True),
               q, k, v, p, u, vb, bias, dtype=jnp.bfloat16)
    got, _ = _emulate(q, k, v, p, u, vb, bias, bf16=True)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, p)]
    plain = trel.relpos_attention_plain(
        *tb, torch.from_numpy(u), torch.from_numpy(vb),
        torch.from_numpy(bias[:, None, None, :])).float().numpy()
    err, plain_err = _rel_l2(got, pal), _rel_l2(plain, pal)
    assert err <= 2e-3, err
    assert err < plain_err, (err, plain_err)


def test_shifted_band_fails_the_emulation():
    """The mutation check: every warp's band started one window row later
    reads the bd term of the wrong relative position, so the walk above
    would catch it."""
    t = 200
    args = _inputs(2, 2, t, 32, (t, 77), 3)
    want = _jax(relpos_attention_reference, *args)
    assert _close(_emulate(*args)[0], want)
    assert not _close(_emulate(*args, band_shift=1)[0], want)
