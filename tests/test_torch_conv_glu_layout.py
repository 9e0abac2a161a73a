"""The bf16 head and tail kernels' tile walks, on the CPU.

The tensor-core kernels of `csrc/conv_glu.cu` run only on the card, but
their bookkeeping is index arithmetic that numpy can repeat. A block owns
`rows_per_block(D, bf16)` rows (64 at D <= 256, 32 above) and reads rows
past M as zeros. The head walks its 2D output columns in chunks of 64 a
columns and the 64 gate columns that pair with them (W1[:, c0..] and
W1[:, D + c0..] side by side in one slab), runs the GLU on that chunk and,
in the backward, forms dh of the chunk, adds its unrounded values to the
block's db1 partial, writes it to dh_buf and accumulates dxn = dh W1^T by
128-wide output chunks and 32-deep sub-slabs; then the LayerNorm backward
per row and the block's partials of dLN scale and bias. The tail runs
swish(LN(g)) W2 by 128-wide output chunks, applies the hash by each row's
logical 256-row tile, and in the backward regenerates the mask for dz, sums
db2 unrounded, and runs da = dz W2^T, the swish and LayerNorm backward.
The weight gradients sum xn^T dh and a^T dz over the row groups of
`wgrad_split` (`bwd_layout`).

This file emulates those walks in float32 (where every bf16 rounding point
is the identity) with the wrapper's own layout and holds g, y and every
gradient against `jax.vjp` of the Pallas `fused_prenorm_glu` and
`fused_postnorm_proj` in interpret mode and of `prenorm_glu_reference` and
`postnorm_proj_reference`. Tolerance: float32 sums in another order,
|err| <= 1e-4 * (1 + max |ref|). Two mutations must fail it: the gate slab
taken one chunk over, and the hash keyed by the CUDA block instead of the
logical tile."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.ops.pallas_conv_glu import (fused_postnorm_proj,
                                            fused_prenorm_glu,
                                            postnorm_proj_reference,
                                            prenorm_glu_reference)
from espnet_tpu_torch.ops import conv_glu as tglu
from espnet_tpu_torch.ops.ffn_common import (DROP_TILE, keep_mask,
                                             quantize_rate)


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

TOL = 1e-4
LN_EPS = 1e-6
SEED = 20240607
DROP = 0.1
HEAD_C = 64  # a (and gate) columns of one head chunk (csrc `HEAD_C`)
SLAB_K, SLAB_N = 32, 128  # a weight slab's depth and width (csrc)
BF16 = torch.bfloat16
HEAD_NAMES = ("g", "x", "lns", "lnb", "w1", "b1")
TAIL_NAMES = ("y", "g", "x_res", "lns", "lnb", "w2", "b2")


def _inputs(m, d, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(x=f(m, d), xr=f(m, d), lns=1 + 0.2 * f(d), lnb=0.2 * f(d),
                w1=f(d, 2 * d) / np.sqrt(d), b1=0.2 * f(2 * d),
                w2=f(d, d) / np.sqrt(d), b2=0.2 * f(d), ct=f(m, d))


def _rows(a, r0, n):
    """Rows r0 .. r0+n-1 of a, zeros past its end (the kernels' zero-fill)."""
    out = np.zeros((n,) + a.shape[1:], np.float32)
    hi = min(r0 + n, a.shape[0])
    if hi > r0:
        out[:hi - r0] = a[r0:hi]
    return out


def _sig(v):
    return (1.0 / (1.0 + np.exp(-v))).astype(np.float32)


def _ln(v, scale, bias):
    """LayerNorm of each row: (out, xhat, 1/std)."""
    c = v - v.mean(axis=1, keepdims=True)
    inv = (1.0 / np.sqrt((c * c).mean(axis=1, keepdims=True) + LN_EPS))
    xh = c * inv
    return xh * scale + bias, xh, inv.astype(np.float32)


def _ln_bwd(dy, xh, inv, scale):
    """LayerNorm's input gradient (`ln_bwd_row`)."""
    dxh = dy * scale
    return (dxh - dxh.mean(axis=1, keepdims=True)
            - xh * (dxh * xh).mean(axis=1, keepdims=True)) * inv


def _slabs(a, w):
    """a @ w as the ring walks it: SLAB_K-deep slabs of w in order."""
    out = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, w.shape[0], SLAB_K):
        out += a[:, k0:k0 + SLAB_K] @ w[k0:k0 + SLAB_K]
    return out


def _emulate_head(v, gate_shift=0):
    """g and (dx, dLN scale, dLN bias, dW1, db1), block by block and chunk
    by chunk as the bf16 kernels walk; `gate_shift` takes every gate slab
    that many chunks over (a mutation)."""
    x, lns, lnb, w1, b1, dg = (v[k] for k in
                               ("x", "lns", "lnb", "w1", "b1", "ct"))
    m, d = x.shape
    bm = tglu.rows_per_block(d, BF16)
    lay = tglu.bwd_layout(m, d, 2 * d, BF16)
    g = np.zeros_like(x)
    dx = np.zeros_like(x)
    xn_buf = np.zeros_like(x)
    dh_buf = np.zeros((m, 2 * d), np.float32)
    partial = np.zeros((lay.row_blocks, 4, d), np.float32)
    for blk in range(lay.row_blocks):
        r0 = blk * bm
        own = min(bm, m - r0)
        xn, xh, inv = _ln(_rows(x, r0, bm), lns, lnb)
        xn[own:] = 0
        xn_buf[r0:r0 + own] = xn[:own]
        dgb = _rows(dg, r0, bm)
        dxn = np.zeros((bm, d), np.float32)
        for c0 in range(0, d, HEAD_C):
            ca = np.arange(c0, c0 + HEAD_C)
            cg = d + (c0 + gate_shift * HEAD_C + np.arange(HEAD_C)) % d
            ha = _slabs(xn, w1[:, ca]) + b1[ca]
            hg = _slabs(xn, w1[:, cg]) + b1[cg]
            s = _sig(hg)
            g[r0:r0 + own, ca] = (ha * s)[:own]
            du = dgb[:, ca]
            dh = np.concatenate([du * s, du * ha * s * (1 - s)], axis=1)
            partial[blk, 2, ca] = dh[:, :HEAD_C].sum(0)
            partial[blk, 3, ca] = dh[:, HEAD_C:].sum(0)
            dh_buf[r0:r0 + own, ca] = dh[:own, :HEAD_C]
            dh_buf[r0:r0 + own, cg] = dh[:own, HEAD_C:]
            # dxn by 128-wide output chunks, dh's columns in 32-deep slabs
            cols = np.concatenate([ca, cg])
            for n0 in range(0, d, SLAB_N):
                for kq in range(0, 2 * HEAD_C, SLAB_K):
                    f = cols[kq:kq + SLAB_K]
                    dxn[:, n0:n0 + SLAB_N] += (dh[:, kq:kq + SLAB_K]
                                               @ w1[n0:n0 + SLAB_N, f].T)
        dx[r0:r0 + own] = _ln_bwd(dxn, xh, inv, lns)[:own]
        partial[blk, 0] = (dxn * xh)[:own].sum(0)
        partial[blk, 1] = dxn[:own].sum(0)
    r = lay.rows_per_group
    dw1 = sum(xn_buf[i * r:(i + 1) * r].T @ dh_buf[i * r:(i + 1) * r]
              for i in range(lay.groups))
    sums = partial.sum(0)
    return g, dx, sums[0], sums[1], dw1, sums[2:].reshape(2 * d)


def _emulate_tail(v, hash_rows=DROP_TILE):
    """y and (dg, dx_res, dLN scale, dLN bias, dW2, db2), block by block as
    the bf16 kernels walk; `hash_rows` is the row tile the hash is keyed by
    (the CUDA block's rows: a mutation)."""
    g, xr, lns, lnb, w2, b2, dy = (v[k] for k in
                                   ("x", "xr", "lns", "lnb", "w2", "b2",
                                    "ct"))
    m, d = g.shape
    bm = tglu.rows_per_block(d, BF16)
    lay = tglu.bwd_layout(m, d, d, BF16)
    q = quantize_rate(DROP)
    scale = np.float32(256.0 / (256 - q))
    keep = keep_mask(m, d, SEED, q, tile_rows=hash_rows).numpy()
    y = np.zeros_like(g)
    dg = np.zeros_like(g)
    a_buf = np.zeros_like(g)
    dz_buf = np.zeros_like(g)
    partial = np.zeros((lay.row_blocks, 3, d), np.float32)
    for blk in range(lay.row_blocks):
        r0 = blk * bm
        own = min(bm, m - r0)
        gn, gh, inv = _ln(_rows(g, r0, bm), lns, lnb)
        sg = _sig(gn)
        a = gn * sg
        a[own:] = 0
        a_buf[r0:r0 + own] = a[:own]
        kp = _rows(keep.astype(np.float32), r0, bm) > 0
        dz = np.where(kp, _rows(dy, r0, bm) * scale, 0).astype(np.float32)
        dz_buf[r0:r0 + own] = dz[:own]
        partial[blk, 2] = dz.sum(0)
        da = np.zeros((bm, d), np.float32)
        for n0 in range(0, d, SLAB_N):
            cols = slice(n0, n0 + SLAB_N)
            z = _slabs(a, w2[:, cols]) + b2[cols]
            y[r0:r0 + own, cols] = (_rows(xr, r0, bm)[:, cols] + np.where(
                kp[:, cols], z * scale, 0))[:own]
            da[:, cols] = _slabs(dz, w2[cols].T)
        dgn = da * (sg * (1 + gn * (1 - sg)))
        dg[r0:r0 + own] = _ln_bwd(dgn, gh, inv, lns)[:own]
        partial[blk, 0] = (dgn * gh)[:own].sum(0)
        partial[blk, 1] = dgn[:own].sum(0)
    r = lay.rows_per_group
    dw2 = sum(a_buf[i * r:(i + 1) * r].T @ dz_buf[i * r:(i + 1) * r]
              for i in range(lay.groups))
    sums = partial.sum(0)
    return y, dg, dy, sums[0], sums[1], dw2, sums[2]


def _jax(fn, args, ct):
    """[out, d args...] of fn through jax.vjp, jitted."""
    def f(*a):
        out, vjp = jax.vjp(fn, *a)
        return (out,) + vjp(jnp.asarray(ct))

    return [np.asarray(o) for o in jax.jit(f)(*(jnp.asarray(a)
                                                 for a in args))]


def _head_ref(v, pallas):
    args = [v[k] for k in ("x", "lns", "lnb", "w1", "b1")]
    if pallas:
        return _jax(lambda *a: fused_prenorm_glu(*a, interpret=True), args,
                    v["ct"])
    return _jax(prenorm_glu_reference, args, v["ct"])


def _tail_ref(v, pallas):
    args = [v[k] for k in ("x", "xr", "lns", "lnb", "w2", "b2")]
    seed = jnp.asarray([SEED], jnp.int32)
    if pallas:
        fn = lambda *a: fused_postnorm_proj(  # noqa: E731
            *a, seed, drop_rate=DROP, interpret=True)
    else:
        fn = lambda *a: postnorm_proj_reference(  # noqa: E731
            *a, seed, drop_rate=DROP)
    return _jax(fn, args, v["ct"])


def _bad(names, got, want):
    """Names of the outputs that miss 1e-4 * (1 + max |ref|)."""
    bad = []
    for name, g, w in zip(names, got, want):
        err = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
        if not (err <= TOL * (1.0 + np.abs(w).max())).all():
            bad.append(name)
    return bad


# M = 97 (one block at 64 rows, a ragged second; one 256-row hash tile) and
# 333 (six blocks, two hash tiles, the second ragged); D = 128 and 256
CASES = [(97, 128), (333, 128), (97, 256), (333, 256)]


@pytest.mark.parametrize("m,d", CASES)
def test_head_walk_matches_reference(m, d):
    v = _inputs(m, d, m + d)
    assert _bad(HEAD_NAMES, _emulate_head(v), _head_ref(v, False)) == []


@pytest.mark.parametrize("m,d", CASES)
def test_tail_walk_matches_reference(m, d):
    v = _inputs(m, d, m + d + 1)
    assert _bad(TAIL_NAMES, _emulate_tail(v), _tail_ref(v, False)) == []


@pytest.mark.parametrize("m,d", [(97, 128), (333, 256)])
def test_walks_match_pallas(m, d):
    """The Pallas kernels in interpret mode (256-row grid steps that carry
    the parameter gradients' sums)."""
    v = _inputs(m, d, m + d)
    assert _bad(HEAD_NAMES, _emulate_head(v), _head_ref(v, True)) == []
    assert _bad(TAIL_NAMES, _emulate_tail(v), _tail_ref(v, True)) == []


def test_gate_slab_one_chunk_over_fails_the_emulation():
    """The mutation check: the gate half read one 64-column chunk over
    still gives finite, plausible numbers, and the walk above catches it."""
    v = _inputs(333, 256, 589)
    want = _head_ref(v, False)
    assert _bad(HEAD_NAMES, _emulate_head(v), want) == []
    bad = _bad(HEAD_NAMES, _emulate_head(v, gate_shift=1), want)
    assert {"g", "x", "w1", "b1"} <= set(bad), bad


def test_hash_keyed_by_the_block_fails_the_emulation():
    """The mutation check: the hash keyed by the CUDA block's rows (64)
    instead of the logical 256-row tile drops other elements."""
    v = _inputs(333, 256, 590)
    want = _tail_ref(v, False)
    assert _bad(TAIL_NAMES, _emulate_tail(v), want) == []
    bad = _bad(TAIL_NAMES, _emulate_tail(
        v, hash_rows=tglu.rows_per_block(256, BF16)), want)
    assert {"y", "g", "w2", "b2"} <= set(bad), bad


@pytest.mark.parametrize("m", [1, 64, 65, 97, 333, 641, 1496, 30016])
@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_layout_covers_every_row_once(m, d):
    """Every row lies in exactly one row block and one weight-gradient
    group; the groups are whole 32-row steps of the A^T B kernel, none
    empty; float32 keeps its 32-row blocks."""
    for n in (d, 2 * d):
        lay = tglu.bwd_layout(m, d, n, BF16)
        bm = tglu.rows_per_block(d, BF16)
        assert bm == (64 if d <= 256 else 32)
        assert (lay.row_blocks - 1) * bm < m <= lay.row_blocks * bm
        r = lay.rows_per_group
        assert r % 32 == 0 and (lay.groups - 1) * r < m <= lay.groups * r
        f32 = tglu.bwd_layout(m, d, n, torch.float32)
        assert f32.row_blocks == -(-m // 32)
        assert (f32.groups - 1) * f32.rows_per_group < m


def test_layout_at_the_training_shape():
    """M = 64 x 469 = 30016 rows at D = 256: 469 blocks of 64 rows; dW1
    (256 x 512, 8 tiles) over 33 groups of 928 rows, dW2 (256 x 256, 4
    tiles) over 63 groups of 480."""
    assert tglu.bwd_layout(30016, 256, 512, BF16) == (469, 33, 928)
    assert tglu.bwd_layout(30016, 256, 256, BF16) == (469, 63, 480)
