"""The bf16 whole-module kernels' tile walk, on the CPU.

The tensor-core kernels of `csrc/conv_module.cu` run only on the card, but
their bookkeeping is index arithmetic that numpy can repeat. A block owns
`tile_rows` frames of one utterance. The forward (and backward kernel A)
recomputes the head (LN1, PW1, GLU, mask) over the halo rows t0 - p .. of
`head_rows` rows, runs the depthwise conv on its own frames, LN2, swish and
PW2; kernel A also writes u and dc of its frames and the per-tile partials
of dLN2, ddb and db2. Kernel B stages dc of frames [t0 - p, t0 + TT + p)
and u of its own frames, takes du (the flipped taps) and the tap gradients
(each (u frame, dc frame) pair counted by the tile that owns the u frame),
recomputes the head for its own frames, the GLU and LN1 backward, and
writes xn and dh for the weight gradients, which sum over the row groups
of `wgrad_split`. The weights and scratch are padded to DP = D rounded up
to 128 (`pad_weights`).

This file emulates that walk in float32 with the wrapper's own layout
(`bwd_layout(..., torch.bfloat16)`) and holds y and all 11 gradients
against `jax.vjp` of the Pallas `fused_conv_module` in interpret mode and
of `conv_module_reference`. Tolerance: float32 sums in another order,
|err| <= 1e-4 * (1 + max |ref|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.ops.pallas_conv_module import (conv_module_reference,
                                               fused_conv_module)
from espnet_tpu_torch.ops import conv_module as tcm
from espnet_tpu_torch.ops.ffn_common import keep_mask, quantize_rate


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
NAMES = ("y", "x", "ln1s", "ln1b", "w1", "b1", "dw", "db", "ln2s", "ln2b",
         "w2", "b2")


def _inputs(b, t, d, k, lengths, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    params = [1 + 0.2 * f(d), 0.2 * f(d), f(d, 2 * d) / np.sqrt(d),
              0.2 * f(2 * d), 0.3 * f(k, d), 0.2 * f(d), 1 + 0.2 * f(d),
              0.2 * f(d), f(d, d) / np.sqrt(d), 0.2 * f(d)]
    return f(b, t, d), mask, params, f(b, t, d)


def _rows(a, r0, n):
    """Rows r0 .. r0+n-1 of a, zeros outside it (the kernels' zero-fill)."""
    out = np.zeros((n,) + a.shape[1:], np.float32)
    lo, hi = max(r0, 0), min(r0 + n, a.shape[0])
    if hi > lo:
        out[lo - r0:hi - r0] = a[lo:hi]
    return out


def _sig(v):
    return (1.0 / (1.0 + np.exp(-v))).astype(np.float32)


def _ln(v, scale, bias, d):
    """LayerNorm over the first d columns; (out, xhat, 1/std), zeros past
    d."""
    c = v[:, :d] - v[:, :d].mean(axis=1, keepdims=True)
    inv = (1.0 / np.sqrt((c * c).mean(axis=1, keepdims=True) + LN_EPS))
    xh = np.zeros_like(v)
    xh[:, :d] = c * inv
    out = np.zeros_like(v)
    out[:, :d] = xh[:, :d] * scale + bias
    return out, xh, inv.astype(np.float32)


def _ln_bwd(dy, xh, inv, scale, d):
    """LayerNorm's input gradient (`ln_bwd_row`), zeros past d."""
    dxh = dy[:, :d] * scale
    dx = np.zeros_like(dy)
    dx[:, :d] = (dxh - dxh.mean(axis=1, keepdims=True) - xh[:, :d] * (
        dxh * xh[:, :d]).mean(axis=1, keepdims=True)) * inv
    return dx


def _emulate(x, mask, params, gy, k, seed=SEED, drop=DROP, halo_shift=0):
    """y and the 11 gradients, tile by tile as the bf16 kernels walk;
    `halo_shift` moves every halo by that many rows (a mutation)."""
    b, t, d = x.shape
    lay = tcm.bwd_layout(b, t, d, k, torch.bfloat16)
    tt, p, dp, hr = lay.tile_rows, lay.halo, lay.dp, lay.head_rows
    ln1s, ln1b, w1, b1, dw, db, ln2s, ln2b, w2, b2 = params
    w1p, w2p = (a.numpy() for a in tcm.pad_weights(torch.from_numpy(w1),
                                                    torch.from_numpy(w2)))
    b1p = np.zeros(2 * dp, np.float32)
    b1p[:d], b1p[dp:dp + d] = b1[:d], b1[d:]
    dwp = np.zeros((k, dp), np.float32)
    dwp[:, :d] = dw
    pad = lambda v: np.pad(v, (0, dp - d))  # noqa: E731
    q = quantize_rate(drop)
    scale = np.float32(256.0 / (256 - q)) if q else np.float32(1.0)
    keep = (keep_mask(b * t, d, seed, q, tile_rows=t).numpy().reshape(b, t, d)
            if q else np.ones((b, t, d), bool))
    m, per = b * t, -(-t // tt)
    u_buf, dc_buf, s_buf, dz_buf, xn_buf = (
        np.zeros((m, dp), np.float32) for _ in range(5))
    dh_buf = np.zeros((m, 2 * dp), np.float32)
    part_a = np.zeros((lay.tiles, 4, d), np.float32)
    part_b = np.zeros((lay.tiles, 4, d), np.float32)
    ddwp = np.zeros((lay.tiles, k, d), np.float32)
    y = np.zeros_like(x)
    dx = np.zeros_like(x)

    def head(bb, frames, valid):
        xr = np.where(valid[:, None], x[bb, np.clip(frames, 0, t - 1)], 0)
        xn, xh, inv = _ln(np.pad(xr, ((0, 0), (0, dp - d))), ln1s, ln1b, d)
        xn[~valid] = 0
        h = xn @ w1p + b1p
        mk = np.where(valid, mask[bb, np.clip(frames, 0, t - 1)], 0)
        u = h[:, :dp] * _sig(h[:, dp:]) * mk[:, None].astype(np.float32)
        u[:, d:] = 0
        u[~valid] = 0
        return xn, xh, inv, h, mk, u

    # the forward and kernel A
    for bb in range(b):
        for n in range(per):
            tile, t0 = bb * per + n, n * tt
            own = min(tt, t - t0)
            rows = slice(bb * t + t0, bb * t + t0 + own)
            r = np.arange(hr)
            frames = t0 - p + r + halo_shift
            valid = (r < tt + 2 * p) & (frames >= 0) & (frames < t)
            u = head(bb, frames, valid)[-1]
            c = np.zeros((tt, dp), np.float32)
            for j in range(k):  # ascending taps from zero, the bias last
                c += u[j:j + tt] * dwp[j]
            c += pad(db)
            cn, xh2, inv2 = _ln(c, ln2s, ln2b, d)
            sg2 = _sig(cn)
            s = cn * sg2
            z = s @ w2p + pad(b2)
            kp = keep[bb, t0:t0 + own]
            y[bb, t0:t0 + own] = x[bb, t0:t0 + own] + np.where(
                kp, z[:own, :d] * scale, 0)
            u_buf[rows] = u[p + halo_shift:p + halo_shift + own]
            s_buf[rows] = s[:own]
            dz = np.zeros((tt, dp), np.float32)
            dz[:own, :d] = np.where(kp, gy[bb, t0:t0 + own] * scale, 0)
            dz_buf[rows] = dz[:own]
            dcn = (dz @ w2p.T) * (sg2 * (1 + cn * (1 - sg2)))
            dcn[:, d:] = 0
            dc = _ln_bwd(dcn, xh2, inv2, ln2s, d)
            dc_buf[rows] = dc[:own]
            part_a[tile] = [(dcn * xh2)[:, :d].sum(0), dcn[:, :d].sum(0),
                            dc[:, :d].sum(0), dz[:, :d].sum(0)]
    # kernel B
    for bb in range(b):
        utt = slice(bb * t, bb * t + t)
        for n in range(per):
            tile, t0 = bb * per + n, n * tt
            own = min(tt, t - t0)
            rows = slice(bb * t + t0, bb * t + t0 + own)
            dch = _rows(dc_buf[utt], t0 - p + halo_shift, tt + 2 * p)
            uo = _rows(u_buf[utt], t0, tt)
            du = np.zeros((tt, dp), np.float32)
            for j in range(k):
                win = dch[2 * p - j:2 * p - j + tt]
                du += win * dwp[j]
                ddwp[tile, j] = (uo * win).sum(0)[:d]
            frames = t0 + np.arange(tt)
            valid = frames < t
            xn, xh1, inv1, h, mk, _ = head(bb, frames, valid)
            xn_buf[rows] = xn[:own]
            dum = du * mk[:, None].astype(np.float32)
            dum[:, d:] = 0
            dum[~valid] = 0
            sg = _sig(h[:, dp:])
            dh = np.concatenate([dum * sg, dum * h[:, :dp] * sg * (1 - sg)],
                                axis=1)
            dh_buf[rows] = dh[:own]
            db1 = dh.sum(0)
            part_b[tile, 2:] = np.stack([db1[:d], db1[dp:dp + d]])
            dxn = dh @ w1p.T
            dxl = _ln_bwd(dxn[:own], xh1[:own], inv1[:own], ln1s, d)
            dx[bb, t0:t0 + own] = gy[bb, t0:t0 + own] + dxl[:, :d]
            part_b[tile, 0] = (dxn * xh1)[:own, :d].sum(0)
            part_b[tile, 1] = dxn[:own, :d].sum(0)
    # the weight gradients over the row groups
    dw1 = sum(xn_buf[g * lay.r1:(g + 1) * lay.r1].T
              @ dh_buf[g * lay.r1:(g + 1) * lay.r1] for g in range(lay.g1))
    dw2 = sum(s_buf[g * lay.r2:(g + 1) * lay.r2].T
              @ dz_buf[g * lay.r2:(g + 1) * lay.r2] for g in range(lay.g2))
    a_, b_ = part_a.sum(0), part_b.sum(0)
    return (y, dx, b_[0], b_[1],
            np.concatenate([dw1[:d, :d], dw1[:d, dp:dp + d]], axis=1),
            b_[2:].reshape(2 * d), ddwp.sum(0), a_[2], a_[0], a_[1],
            dw2[:d, :d], a_[3])


def _jax(fn, x, mask, params, gy):
    """[y, dx, d params...] of fn through jax.vjp, jitted."""
    m, ct = jnp.asarray(mask), jnp.asarray(gy)

    def f(x_, *p):
        y, vjp = jax.vjp(lambda x__, *pp: fn(x__, m, *pp), x_, *p)
        return (y,) + vjp(ct)

    out = jax.jit(f)(jnp.asarray(x), *(jnp.asarray(a) for a in params))
    return [np.asarray(o) for o in out]


def _close(got, want):
    """Names of the outputs that miss the tolerance."""
    bad = []
    for name, g, w in zip(NAMES, got, want):
        err = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
        if not (err <= TOL * (1.0 + np.abs(w).max()) + TOL * np.abs(w)).all():
            bad.append(name)
    return bad


def _reference_fns(k):
    seed = jnp.asarray([SEED], jnp.int32)
    kw = dict(drop_rate=DROP, kernel_size=k)
    ref = lambda x_, m, *p: conv_module_reference(  # noqa: E731
        x_, m, *p, seed, **kw)
    pal = lambda x_, m, *p: fused_conv_module(  # noqa: E731
        x_, m, *p, seed, interpret=True, **kw)
    return ref, pal


# T 1/31/63/64/65/200 (one tile, its edges, four tiles), k 1/3/31, D 64/128
# /144 (144 pads to DP 256), ragged lengths with 1-frame utterances
CASES = [(1, 3, 64, (1, 1)), (31, 31, 144, (31, 1, 17)),
         (63, 1, 128, (63, 1)), (64, 31, 64, (64, 1, 40)),
         (65, 3, 144, (65, 64, 1)), (200, 31, 128, (200, 1, 77))]


@pytest.mark.parametrize("t,k,d,lengths", CASES)
def test_tile_walk_matches_reference(t, k, d, lengths):
    x, mask, params, gy = _inputs(len(lengths), t, d, k, lengths, t + k + d)
    got = _emulate(x, mask, params, gy, k)
    want = _jax(_reference_fns(k)[0], x, mask, params, gy)
    assert _close(got, want) == []


@pytest.mark.parametrize("t,k,d,lengths", [CASES[1], CASES[3], CASES[5]])
def test_tile_walk_matches_pallas(t, k, d, lengths):
    """The Pallas kernel in interpret mode (one program per utterance, T
    padded to a multiple of 8)."""
    x, mask, params, gy = _inputs(len(lengths), t, d, k, lengths, t + k + d)
    got = _emulate(x, mask, params, gy, k)
    want = _jax(_reference_fns(k)[1], x, mask, params, gy)
    assert _close(got, want) == []


def test_shifted_halo_fails_the_emulation():
    """The mutation check: every halo moved down by one row (the head
    recomputed for frames t0 - p + 1 .., dc staged from t0 - p + 1) gives
    the wrong conv, so the walk above would catch it."""
    t, k, d, lengths = CASES[3]
    x, mask, params, gy = _inputs(len(lengths), t, d, k, lengths, t + k + d)
    want = _jax(_reference_fns(k)[0], x, mask, params, gy)
    assert _close(_emulate(x, mask, params, gy, k), want) == []
    bad = _close(_emulate(x, mask, params, gy, k, halo_shift=1), want)
    assert {"y", "x", "dw"} <= set(bad), bad


@pytest.mark.parametrize("b,t,d,k", [(64, 469, 256, 31), (4, 374, 256, 31),
                                     (3, 1, 64, 1), (2, 65, 144, 3),
                                     (5, 200, 512, 31), (2, 63, 384, 15)])
def test_layout_covers_every_frame_and_tap_once(b, t, d, k):
    lay = tcm.bwd_layout(b, t, d, k, torch.bfloat16)
    tt, p = lay.tile_rows, lay.halo
    dp = tcm.padded_dim(d)
    assert dp % 128 == 0 and d <= dp < d + 128
    assert (lay.dp, lay.width) == (dp, dp)
    assert tt == (64 if dp <= 256 else 32) and lay.tiles == b * -(-t // tt)
    # the head covers the tile's frames and p on each side, in m-tiles of
    # 16 rows, within the kernels' TT + 32 halo rows
    assert lay.head_rows % 16 == 0
    assert tt + 2 * p <= lay.head_rows <= tt + 32
    # every frame is owned by exactly one tile
    owners = np.zeros(t, int)
    for n in range(-(-t // tt)):
        owners[n * tt:min(t, n * tt + tt)] += 1
    assert (owners == 1).all()
    # every (u frame s, dc frame s + p - j) pair is summed into ddw[j] once:
    # by the tile owning s, whose staged dc window reaches it; and du of
    # every frame reads only staged dc rows
    pairs = np.zeros((t, k), int)
    for n in range(-(-t // tt)):
        t0 = n * tt
        for s in range(t0, min(t, t0 + tt)):
            for j in range(k):
                f = s + p - j
                assert t0 - p <= f < t0 + tt + p
                if 0 <= f < t:
                    pairs[s, j] += 1
    want = np.array([[1 if 0 <= s + p - j < t else 0 for j in range(k)]
                     for s in range(t)])
    assert (pairs == want).all()
    # the weight gradients' row groups: whole 32-row steps, none empty,
    # every row once
    m = b * t
    for g, r in ((lay.g1, lay.r1), (lay.g2, lay.r2)):
        assert r % 32 == 0 and (g - 1) * r < m <= g * r


def test_layout_at_the_training_shape():
    """B=64, T=469, D=256, k=31: 8 tiles of 64 frames an utterance (512
    blocks), a 96-row head (1.5x PW1's products, against 2.0x for the
    float32 kernels' 32-frame tiles), 33 and 63 weight-gradient groups."""
    lay = tcm.bwd_layout(64, 469, 256, 31, torch.bfloat16)
    assert (lay.tile_rows, lay.tiles, lay.head_rows) == (64, 512, 96)
    assert (lay.g1, lay.r1, lay.g2, lay.r2) == (33, 928, 63, 480)
    f32 = tcm.bwd_layout(64, 469, 256, 31, torch.float32)
    assert (f32.tile_rows, f32.tiles, f32.head_rows, f32.width) == (
        32, 960, 64, 256)


def test_pad_weights_places_the_halves():
    d, dp = 144, 256
    w1 = torch.randn(d, 2 * d)
    w2 = torch.randn(d, d)
    w1p, w2p = tcm.pad_weights(w1, w2)
    assert w1p.shape == (dp, 2 * dp) and w2p.shape == (dp, dp)
    assert torch.equal(w1p[:d, :d], w1[:, :d])
    assert torch.equal(w1p[:d, dp:dp + d], w1[:, d:])
    assert torch.equal(w2p[:d, :d], w2)
    w1p[:d, :d] = 0
    w1p[:d, dp:dp + d] = 0
    w2p[:d, :d] = 0
    assert not w1p.any() and not w2p.any()  # zeros everywhere else
    w1_, w2_ = torch.randn(256, 512), torch.randn(256, 256)
    assert tcm.pad_weights(w1_, w2_)[0] is w1_
