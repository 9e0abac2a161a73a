"""The rel-pos backward's tile walk and dp fold, on the CPU.

The bf16 backward kernels (`csrc/relpos_attention.cu`) run only on the card,
but their bookkeeping is index arithmetic that numpy can repeat: pass 1
walks 64 x 64 tiles, reads bd from a 128-row p window through the skew
(row r, key c: window row 63-r+c), writes dS skewed into a 64 x 128 window
tile, takes dqv and the 128-row dp window from plain products with it, adds
the window's first 64 rows to the block's slab and carries the other 64 to
the next key tile; the slabs of a group of batch elements are summed, and
`fold_slabs` overlap-adds them at `slab_p_row`; pass 2 takes dk and dv from
the stored P and dS planes. This file emulates that walk in float32 with
the wrapper's own layout functions (`bwd_layout`, `slab_p_row`,
`fold_slabs`) and holds every gradient (dq, dk, dv, dp, du, dv-bias)
against `jax.vjp` of the Pallas kernel in interpret mode and of the
Pallas file's reference. Tolerance: float32 sums in another order,
|err| <= 1e-4 * (1 + max |ref|)."""

import jax
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
NEG = np.float32(trel.NEG)
TOL = 1e-4


def _inputs(b, h, t, d, lengths, seed):
    rng = np.random.RandomState(seed)
    q, k, v, dout = (rng.randn(b, h, t, d).astype(np.float32)
                     for _ in range(4))
    p = rng.randn(h, 2 * t - 1, d).astype(np.float32)
    u, vb = (0.3 * rng.randn(h, d).astype(np.float32) for _ in range(2))
    valid = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    # NEG, not -inf: the Pallas kernel clamps nothing, and with NEG every
    # implementation gives a fully masked row uniform weights
    bias = np.where(valid, 0.0, NEG).astype(np.float32)
    return q, k, v, p, u, vb, bias, dout


def _rows(x, r0, n):
    """Rows r0 .. r0+n-1 of x, zeros outside it (the kernels' zero-fill)."""
    out = np.zeros((n,) + x.shape[1:], np.float32)
    lo, hi = max(r0, 0), min(r0 + n, x.shape[0])
    if hi > lo:
        out[lo - r0:hi - r0] = x[lo:hi]
    return out


def _emulate(q, k, v, p, u, vb, bias, dout):
    """The kernels' backward of rel-pos attention, tile by tile."""
    b, h, t, d = q.shape
    lay = trel.bwd_layout(b, h, t, torch.bfloat16)
    nq, tp = lay.blocks, lay.padded
    scale = np.float32(1.0 / np.sqrt(d))
    r = np.arange(BLK)[:, None]
    c = np.arange(BLK)[None, :]
    skew = BLK - 1 - r + c  # window row of (query r, key c)
    dqu = np.zeros((b, h, t, d), np.float32)
    dqv = np.zeros_like(dqu)
    dk = np.zeros_like(dqu)
    dv = np.zeros_like(dqu)
    slabs = np.zeros((lay.groups, h, nq, lay.slab_rows, d), np.float32)
    for bb in range(b):
        kb = np.maximum(_rows(bias[bb], 0, tp), NEG)
        for hh in range(h):
            qu = _rows(q[bb, hh] + u[hh], 0, tp)
            qv = _rows(q[bb, hh] + vb[hh], 0, tp)
            kk, vv, do = (_rows(x[bb, hh], 0, tp) for x in (k, v, dout))
            # the forward's row statistics (m, l) and delta = rowsum(dO O)
            bd_full = np.einsum("id,jd->ij", qv[:t], p[hh])
            ii = np.arange(t)[:, None]
            jj = np.arange(t)[None, :]
            s = ((qu[:t] @ kk[:t].T + bd_full[ii, t - 1 - ii + jj]) * scale
                 + kb[None, :t]).astype(np.float32)
            m = s.max(axis=1)
            e = np.exp(s - m[:, None])
            l_ = e.sum(axis=1)
            o = (e / l_[:, None]) @ vv[:t]
            m, l_ = _rows(m, 0, tp), _rows(l_, 0, tp) + (np.arange(tp) >= t)
            delta = _rows((do[:t] * o).sum(axis=1), 0, tp)
            pplane = np.zeros((tp, tp), np.float32)
            dsplane = np.zeros((tp, tp), np.float32)
            # pass 1: block n of query rows i0 .. i0+63
            for n in range(nq):
                i0 = BLK * n
                rows = slice(i0, i0 + BLK)
                aqu = np.zeros((BLK, d), np.float32)
                aqv = np.zeros((BLK, d), np.float32)
                acc = np.zeros((2 * BLK, d), np.float32)  # the dp window
                slab = slabs[bb // lay.per_group, hh, n]
                for kt in range(nq):
                    j0 = BLK * kt
                    cols = slice(j0, j0 + BLK)
                    pw = _rows(p[hh], trel.slab_p_row(t, n) + j0, 2 * BLK)
                    bdw = qv[rows] @ pw.T  # (64, 128)
                    sc = (qu[rows] @ kk[cols].T + bdw[r, skew]) * scale \
                        + kb[None, cols]
                    ok = (i0 + r < t) & (j0 + c < t)
                    with np.errstate(over="ignore"):  # rows and keys past T
                        pr = np.where(ok, np.exp(sc - m[rows, None])
                                      / l_[rows, None], 0).astype(np.float32)
                    ds = pr * (do[rows] @ vv[cols].T - delta[rows, None]) \
                        * scale
                    pplane[rows, cols] = pr
                    dsplane[rows, cols] = ds
                    aqu += ds @ kk[cols]
                    dsw = np.zeros((BLK, 2 * BLK), np.float32)
                    dsw[r, skew] = ds
                    aqv += dsw @ pw
                    acc += dsw.T @ qv[rows]
                    slab[j0:j0 + BLK] += acc[:BLK]  # complete: no later tile
                    acc = np.concatenate([acc[BLK:], np.zeros_like(acc[BLK:])])
                slab[BLK * nq:] += acc[:BLK - 1]  # row 127 is never reached
                valid = min(BLK, t - i0)
                dqu[bb, hh, i0:i0 + valid] = aqu[:valid]
                dqv[bb, hh, i0:i0 + valid] = aqv[:valid]
            # pass 2: key tile j0 over the query tiles, from the planes
            for kt in range(nq):
                cols = slice(BLK * kt, BLK * kt + BLK)
                adk = np.zeros((BLK, d), np.float32)
                adv = np.zeros((BLK, d), np.float32)
                for n in range(nq):
                    rows = slice(BLK * n, BLK * n + BLK)
                    adv += pplane[rows, cols].T @ do[rows]
                    adk += dsplane[rows, cols].T @ qu[rows]
                valid = min(BLK, t - BLK * kt)
                dk[bb, hh, BLK * kt:BLK * kt + valid] = adk[:valid]
                dv[bb, hh, BLK * kt:BLK * kt + valid] = adv[:valid]
    dp = trel.fold_slabs(torch.from_numpy(slabs), t).numpy()
    return (dqu + dqv, dk, dv, dp, dqu.sum(axis=(0, 2)),
            dqv.sum(axis=(0, 2)))


def _jax_grads(fn, q, k, v, p, u, vb, bias, dout):
    args = tuple(jnp.asarray(a) for a in (q, k, v, p, u, vb))
    _, vjp = jax.vjp(lambda *a: fn(*a, jnp.asarray(bias[:, None, None, :])),
                     *args)
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _assert_close(got, want, names):
    for name, g, w in zip(names, got, want):
        atol = TOL * (1.0 + float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=TOL, atol=atol, err_msg=name)


NAMES = ("dq", "dk", "dv", "dp", "du", "dv-bias")


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 200])
def test_tile_walk_matches_pallas_and_reference(t, d):
    """Utterance 2 has every key masked (uniform weights): the reference
    takes the whole batch; the Pallas backward, whose log-sum-exp loses
    log T beside NEG on such a row, takes the other two utterances. At
    T = 200 the Pallas kernel runs its general path (two 128-row blocks:
    `_dqdp_kernel`, `_dkv_kernel` and its own slab fold)."""
    lengths = (t, max(1, t // 3), 0)
    q, k, v, p, u, vb, bias, dout = _inputs(3, 2, t, d, lengths, t + d)
    got = _emulate(q, k, v, p, u, vb, bias, dout)
    want = _jax_grads(relpos_attention_reference, q, k, v, p, u, vb, bias,
                      dout)
    _assert_close(got, want, NAMES)
    some = slice(0, 2)
    sub = tuple(a[some] for a in (q, k, v)) + (p, u, vb, bias[some],
                                                dout[some])
    got = _emulate(*sub)
    block = 128 if t > 128 else None
    pal = _jax_grads(lambda *a: relpos_flash_attention(
        *a, block=block, interpret=True), *sub)
    _assert_close(got, pal, NAMES)


@pytest.mark.parametrize("b,h,t", [(64, 4, 469), (16, 4, 469), (3, 4, 1),
                                   (1, 1, 65), (4, 4, 200)])
def test_bwd_layout_covers_every_batch_element_once(b, h, t):
    for dtype in (torch.float32, torch.bfloat16):
        lay = trel.bwd_layout(b, h, t, dtype)
        assert lay.blocks == -(-t // BLK)
        assert lay.padded == BLK * lay.blocks >= t
        assert lay.slab_rows == BLK * lay.blocks + BLK - 1
        # groups of per_group elements, the last cut at b, none empty
        starts = np.arange(lay.groups) * lay.per_group
        sizes = np.minimum(b, starts + lay.per_group) - starts
        assert (sizes > 0).all() and sizes.sum() == b
        if dtype == torch.float32:  # the CUDA-core pass: a slab per element
            assert lay.per_group == 1 and not lay.tensor_cores


def test_bwd_layout_at_the_training_shape():
    """B=64, H=4, T=469: 8 query blocks; pass 1 walks 4 batch elements per
    block, 512 blocks; the slabs come to 16 x 4 x 8 x 575 x 64 float32
    (75 MB, against 301 MB with a slab per element) and the planes to
    2 x 64 x 4 x 512^2 bf16 (268 MB)."""
    lay = trel.bwd_layout(64, 4, 469, torch.bfloat16)
    assert (lay.blocks, lay.padded, lay.slab_rows) == (8, 512, 575)
    assert (lay.per_group, lay.groups) == (4, 16)
    assert lay.blocks * 4 * lay.groups == 512


def test_slab_rows_reach_every_p_row_once_per_block():
    """Slab row w of query block n is p row slab_p_row(t, n) + w: the slab
    spans the rows of every (query, key) pair of the block, and the fold
    lands each of them at its place."""
    for t in (1, 63, 64, 65, 200, 469):
        nq = -(-t // BLK)
        rows = BLK * nq + BLK - 1
        for n in range(nq):
            off = trel.slab_p_row(t, n)
            i = np.arange(BLK * n, min(t, BLK * n + BLK))[:, None]
            j = np.arange(t)[None, :]
            w = (t - 1 - i + j) - off  # slab row of pair (i, j)
            assert w.min() >= 0 and w.max() < rows
    slabs = torch.zeros(2, 1, 2, BLK * 2 + BLK - 1, 1)
    slabs[0, 0, 1, 30] = 1.0  # block 1: p row 100-1-127+30 = 2
    slabs[1, 0, 0, BLK] = 2.0  # block 0: p row 100-1-63+64 = 100
    slabs[1, 0, 1, 0] = 4.0  # block 1: p row -28, outside dp
    dp = trel.fold_slabs(slabs, 100)
    assert float(dp[0, 2, 0]) == 1.0 and float(dp[0, 100, 0]) == 2.0
    assert float(dp.sum()) == 3.0


def test_warp_bands_and_skipped_steps_hold_every_nonzero():
    """The kernel's per-warp pieces: warp w's 16 query rows reach window
    rows 48-16w .. 127-16w only (its 80-row bd band), and in the dPw
    product warp 0 (window rows 0..31) needs query rows >= 32 and warp 3
    (rows 96..127) query rows < 32 only: the k-steps it skips hold zeros."""
    r = np.arange(BLK)[:, None]
    c = np.arange(BLK)[None, :]
    skew = BLK - 1 - r + c
    for w in range(4):
        band = skew[16 * w:16 * w + 16]
        assert band.min() >= 48 - 16 * w and band.max() < 128 - 16 * w
    dsw = np.zeros((BLK, 2 * BLK), bool)
    dsw[r, skew] = True
    assert not dsw[:32, 0:32].any() and not dsw[32:, 96:128].any()
    assert not dsw[:, 127].any()
