"""Each CUDA kernel of the port against its plain PyTorch version, on the
card only (the kernels have no CPU mode; here every test skips).

This file imports no JAX, so it also runs on the card's machine, which has
none: `python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`.
"""

import numpy as np
import pytest
import torch

from espnet_tpu_torch.ops import conv_glu as tglu
from espnet_tpu_torch.ops import conv_module as tcm
from espnet_tpu_torch.ops import ffn as tfused
from espnet_tpu_torch.ops import ffn_common
from espnet_tpu_torch.ops import flash_attention as tflash
from espnet_tpu_torch.ops import prenorm_ffn as tffn
from espnet_tpu_torch.ops import relpos_attention as trel

# (atol, rtol): float32 sums in another order; bf16 outputs round to 8 bits
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _relpos_args(device, dtype, b=3, h=4, t=200, d=64, lengths=(200, 77, 0)):
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    p = rng.randn(h, 2 * t - 1, d).astype(np.float32)
    u, vb = (0.3 * rng.randn(h, d).astype(np.float32) for _ in range(2))
    valid = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    bias = np.where(valid, 0.0, np.finfo(np.float32).min).astype(np.float32)
    args = [torch.from_numpy(a).to(device) for a in
            (q, k, v, p, u, vb, bias[:, None, None, :])]
    return [a.to(dtype) for a in args[:4]] + args[4:]


def _ffn_args(device, dtype, m=333, d=256, f=1024):
    rng = np.random.RandomState(6)
    x = rng.randn(m, d)
    lns, lnb = 1 + 0.2 * rng.randn(d), 0.2 * rng.randn(d)
    w1, b1 = rng.randn(d, f) / np.sqrt(d), 0.2 * rng.randn(f)
    w2, b2 = rng.randn(f, d) / np.sqrt(f), 0.2 * rng.randn(d)
    args = [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (x, lns, lnb, w1, b1, w2, b2)]
    for i in (0, 3, 5):  # x and the weights in the compute dtype
        args[i] = args[i].to(dtype)
    return args


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [200, 1, 64, 65])
def test_relpos_kernel_matches_plain(cuda, dtype, t):
    lengths = (t, max(1, t // 3), 0)
    args = _relpos_args(cuda, dtype, t=t, lengths=lengths)
    before = trel.relpos_attention.launches
    got = trel.relpos_attention(*args)
    torch.cuda.synchronize()
    assert trel.relpos_attention.launches == before + 1
    want = trel.relpos_attention_plain(*args)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64, 128, 96])
@pytest.mark.parametrize("t", [63, 64, 200, 374, 469])
def test_relpos_bf16_forward_on_tensor_cores_matches_plain(cuda, t, d):
    """The bf16 forward runs on tensor cores (`relpos_attention_fwd_tc_
    kernel`) at every kernel head dim (96 zero-padded to 128), query blocks
    that end past T and the serve (374) and training (469) lengths; one
    utterance has every key masked (the uniform average of v). The plain
    version computes in float32 throughout: the kernel's bf16 Qu, Qv and
    P differ from it by bf16 rounding, within the bf16 tolerance."""
    lengths = (t, max(1, t // 3), 0)
    args = _relpos_args(cuda, torch.bfloat16, t=t, d=d, lengths=lengths)
    before = trel.relpos_attention.launches
    with torch.no_grad():
        got = trel.relpos_attention(*args)
    torch.cuda.synchronize()
    assert trel.relpos_attention.launches == before + 1
    want = trel.relpos_attention_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])
    # the fully masked utterance: every row the mean of v over the T keys
    mean_v = args[2][2].float().mean(dim=1, keepdim=True).expand(-1, t, -1)
    torch.testing.assert_close(got[2].float(), mean_v, atol=2e-2, rtol=1e-2)


# the bf16 forwards run on tensor cores: every width, the serve's rows
# (1496), one row, rows past a 64-row block and the training rows, with and
# without dropout, both activations
FWD_TC_CASES = [(torch.bfloat16, d, m, drop, act)
                for d in (128, 256, 384, 512) for m in (1, 1496, 4097, 30016)
                for drop in (0.0, 0.1) for act in ("swish", "relu")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,m,drop,activation", [
    (torch.float32, 256, 333, 0.0, "swish"),
    (torch.float32, 256, 333, 0.0, "relu"),
    (torch.bfloat16, 256, 333, 0.0, "swish"),
    (torch.bfloat16, 256, 333, 0.0, "relu")] + FWD_TC_CASES)
def test_prenorm_ffn_kernel_matches_plain(cuda, dtype, d, m, drop,
                                          activation):
    args = _ffn_args(cuda, dtype, m=m, d=d)
    scale = 0.5 if activation == "swish" else 1.0
    kw = dict(activation=activation, residual_scale=scale, drop_rate=drop,
              seeds=(2024, -3))
    before = tffn.prenorm_ffn.launches
    with torch.no_grad():
        got = tffn.prenorm_ffn(*args, **kw)
    torch.cuda.synchronize()
    assert tffn.prenorm_ffn.launches == before + 1
    want = tffn.prenorm_ffn_plain(*args, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,m,drop,activation", FWD_TC_CASES)
def test_fused_ffn_forward_matches_plain(cuda, dtype, d, m, drop,
                                         activation):
    x, _, _, w1, b1, w2, b2 = _ffn_args(cuda, dtype, m=m, d=d)
    kw = dict(activation=activation, drop_rate=drop, seed=-991)
    before = tfused.fused_ffn.launches
    with torch.no_grad():
        got = tfused.fused_ffn(x, w1, b1, w2, b2, **kw)
    torch.cuda.synchronize()
    assert tfused.fused_ffn.launches == before + 1
    want = tfused.fused_ffn_plain(x, w1, b1, w2, b2, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_ffn_forward_hash_masks_match_plain(cuda, d):
    """With W2 the identity (F = D), b2 = 0 and swish, each output shows
    whether its hidden unit was kept: fused_ffn's y is 0 exactly where the
    mask drops, the pre-norm FFN's y equals x exactly where either mask
    drops. The bf16 tensor-core forwards keep the plain `keep_mask`'s
    elements, on every element whose undropped value is clear of 0."""
    m, q_rate = 4097, 0.1
    x, lns, lnb, w1, b1, _, _ = _ffn_args(cuda, torch.bfloat16, m=m, d=d, f=d)
    eye = torch.eye(d, device=cuda, dtype=torch.bfloat16)
    zero = torch.zeros(d, device=cuda)
    q = ffn_common.quantize_rate(q_rate)
    with torch.no_grad():
        y = tfused.fused_ffn(x, w1, b1, eye, zero, activation="swish",
                             drop_rate=q_rate, seed=77)
        a = tfused.fused_ffn_plain(x, w1, b1, eye, zero, activation="swish")
    keep = ffn_common.keep_mask(m, d, 77, q, cuda)
    clear = a.float().abs() > 0
    assert torch.equal((y != 0)[clear], keep[clear])
    with torch.no_grad():
        y = tffn.prenorm_ffn(x, lns, lnb, w1, b1, eye, zero,
                             activation="swish", drop_rate=q_rate,
                             seeds=(5, 6))
        a = tffn.prenorm_ffn_plain(x, lns, lnb, w1, b1, eye, zero,
                                   activation="swish") - x
    keep = (ffn_common.keep_mask(m, d, 5, q, cuda)
            & ffn_common.keep_mask(m, d, 6, q, cuda))
    # clear of x's rounding: |a| kept and scaled twice exceeds x's ulp
    clear = a.float().abs() > 2.0 ** -6 * x.float().abs()
    assert torch.equal((y != x)[clear], keep[clear])


@pytest.mark.gpu
def test_wrappers_check_their_arguments_on_card(cuda):
    args = _relpos_args(cuda, torch.float32)
    with pytest.raises(ValueError, match="not contiguous"):
        trel.relpos_attention(args[0].transpose(2, 3).contiguous()
                              .transpose(2, 3), *args[1:])
    with pytest.raises(TypeError):
        trel.relpos_attention(args[0].half(), *args[1:])
    fargs = _ffn_args(cuda, torch.float32)
    with pytest.raises(ValueError, match="shape"):
        tffn.prenorm_ffn(*fargs[:5], fargs[5][:1000], fargs[6])
    with pytest.raises(TypeError):
        tffn.prenorm_ffn(fargs[0].bfloat16(), *fargs[1:])


# backward and lattice kernels: relative L2 error of each gradient (float32:
# sums in another order; bf16: inputs and outputs round to 8 bits). A
# gradient that is exactly 0 in the plain version (q, p and the position
# biases at T=1: one key, so the softmax gradient is 0) is held to an
# absolute bound instead: the kernel's is rounding noise there, and a
# relative error against 0 means nothing.
REL_L2 = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ZERO_ATOL = 1e-5


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def _assert_grad_close(name, got, want, dtype):
    assert got.dtype == want.dtype, name
    if not want.any():
        assert float(got.abs().max()) <= ZERO_ATOL, (name, got.abs().max())
    else:
        assert _rel_l2(got, want) < REL_L2[dtype], (name, _rel_l2(got, want))


def _grads(fn, args, idx, gout):
    leaves = [a.detach().clone().requires_grad_(i in idx)
              for i, a in enumerate(args)]
    out = fn(*leaves)
    out.backward(gout)
    return out, [leaves[i].grad for i in idx]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", [(200, 64), (1, 64), (64, 64), (65, 64),
                                 (65, 32), (65, 128), (200, 128), (64, 48),
                                 (65, 96),
                                 # one key tile, its edges and the training
                                 # length, at every kernel head dim
                                 (1, 32), (64, 32), (469, 32), (1, 128),
                                 (64, 128), (469, 64), (469, 128)])
def test_relpos_backward_kernels_match_plain(cuda, dtype, t, d):
    """Head dims 48 and 96 run zero-padded to the kernels' 64 and 128. In
    bf16 the backward runs on tensor cores (the P and dS planes, the dp
    slabs summed over groups of batch elements)."""
    lengths = (t, max(1, t // 3), 0)
    args = _relpos_args(cuda, dtype, t=t, d=d, lengths=lengths)
    gout = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
        t)).to(cuda, dtype)
    before = trel.relpos_attention_bwd.launches
    got_y, got = _grads(trel.relpos_attention, args, range(6), gout)
    torch.cuda.synchronize()
    assert trel.relpos_attention_bwd.launches == before + 1
    want_y, want = _grads(trel.relpos_attention_plain, args, range(6), gout)
    assert got_y.shape == want_y.shape
    torch.testing.assert_close(got_y.float(), want_y.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    for name, g, w in zip("q k v p u vb".split(), got, want):
        _assert_grad_close(name, g, w, dtype)
    # masked keys of a partly masked utterance get exactly zero dk and dv
    assert (got[1][1, :, lengths[1]:] == 0).all()
    assert (got[2][1, :, lengths[1]:] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("t", [64, 469])
def test_relpos_bf16_backward_rows_sum_to_one(cuda, t):
    """The bf16 forward rounds q+u and q+v as the backward does, so its row
    statistics (m, l) belong to the scores the backward recomputes:
    sum_j exp(s_ij - m_i) / l_i over those scores (float32, from the
    rounded Qu and Qv) is 1 within 1e-3 on every row. The backward sees
    the same: with dout[i] the one-hot e_(i mod D), dv summed over keys is
    the sum over the rows i = d (mod D) of sum_j bf16(P_ij), 1 for each
    row within P's bf16 rounding (2^-8 of the row's sum: the Pallas
    kernels round P before P^T dO). Every row is a valid query; a fully
    masked utterance's rows are uniform. At T = 64 = D each column is one
    row."""
    d = 64
    args = _relpos_args(cuda, torch.bfloat16, t=t, d=d,
                        lengths=(t, max(1, t // 3), 0))
    q, k, v, p, u, vb, bias = args
    b, h = q.shape[:2]
    kb = trel.key_bias(bias, b, t, cuda).contiguous()
    scale = 1.0 / d ** 0.5
    xs = (q, k, v, p, u.float().contiguous(), vb.float().contiguous())
    out, stats = trel._kernel_fwd(*xs, kb, scale, with_stats=True)
    torch.cuda.synchronize()
    # the scores from the rounded Qu and Qv, as the backward forms them
    bf = torch.bfloat16
    qu = (q.float() + u.to(bf).float()[None, :, None]).to(bf).float()
    qv = (q.float() + vb.to(bf).float()[None, :, None]).to(bf).float()
    ar = torch.arange(t, device=cuda)
    idx = ((t - 1) - ar[:, None] + ar[None, :]).expand(b, h, t, t)
    bd = torch.einsum("bhqd,hkd->bhqk", qv, p.float()).gather(-1, idx)
    s = (qu @ k.float().transpose(-1, -2) + bd) * scale + kb[:, None, None]
    m, l_ = stats[..., 0], stats[..., 1]
    rowsum = torch.exp(s - m[..., None]).sum(dim=-1) / l_
    assert float((rowsum - 1).abs().max()) <= 1e-3
    rows = torch.arange(t, device=cuda)
    dout = torch.zeros(b, h, t, d, device=cuda, dtype=bf)
    dout[:, :, rows, rows % d] = 1
    _, _, _, dv, _ = trel._kernel_bwd(*xs, kb, out, stats, dout, scale)
    torch.cuda.synchronize()
    per_col = dv.double().sum(dim=2)  # (B, H, D): sum of P over rows = d
    count = torch.bincount(rows % d, minlength=d).double()
    dev = (per_col - count).abs() / count
    assert float(dev.max()) <= 2.0 ** -8 + 1e-4, float(dev.max())


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 63, 64, 65, 469])
def test_relpos_bwd_layout_matches_the_kernels(cuda, t):
    """The Python layout of the backward's slabs and the kernels' agree."""
    from espnet_tpu_torch.ops.cuda_build import kernel_library

    lay = trel.bwd_layout(3, 4, t, torch.bfloat16)
    assert lay.slab_rows == kernel_library().espnet_relpos_attention_slab_rows(t)


def _both_dtypes_then_bf16(cases, bf16_cases):
    """`cases` in float32 and bf16, then `bf16_cases` in bf16: the shapes of
    the tensor-core backward (rows of one and of several row blocks and
    weight-gradient groups, both widths of F, both activations). In float32
    a relu input within rounding of 0 may take the other branch than in the
    plain version, and at thousands of rows one such element moves the
    LayerNorm scale gradient past the float32 bound (1e-4), so the float32
    parity mode keeps its own cases."""
    return ([(dt,) + c for dt in (torch.float32, torch.bfloat16)
             for c in cases] + [(torch.bfloat16,) + c for c in bf16_cases])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,m,drop,d,f,activation", _both_dtypes_then_bf16(
    [(333, 0.0, 256, 1024, "swish"), (300, 0.1, 256, 1024, "swish"),
     (600, 0.1, 256, 1024, "swish"), (300, 0.1, 512, 1024, "swish"),
     (300, 0.1, 128, 1024, "swish"), (333, 0.1, 384, 1024, "swish")],
    [(1, 0.1, 256, 2048, "swish"), (4097, 0.1, 256, 2048, "swish"),
     (4097, 0.0, 512, 2048, "relu"), (333, 0.1, 128, 2048, "relu"),
     (1, 0.0, 384, 1024, "relu"), (4097, 0.1, 384, 2048, "swish"),
     (333, 0.1, 512, 1024, "relu"), (4097, 0.1, 128, 1024, "relu")]))
def test_prenorm_ffn_dropout_and_backward_match_plain(cuda, dtype, m, drop,
                                                      d, f, activation):
    args = _ffn_args(cuda, dtype, m=m, d=d, f=f)
    kw = dict(activation=activation, residual_scale=0.5, drop_rate=drop,
              seeds=(12345, -7))
    gout = torch.randn(m, d, generator=torch.Generator().manual_seed(m)
                       ).to(cuda, dtype)
    before = tffn.prenorm_ffn_bwd.launches
    got_y, got = _grads(lambda *a: tffn.prenorm_ffn(*a, **kw), args,
                        range(7), gout)
    torch.cuda.synchronize()
    assert tffn.prenorm_ffn_bwd.launches == before + 1
    want_y, want = _grads(lambda *a: tffn.prenorm_ffn_plain(*a, **kw), args,
                          range(7), gout)
    torch.testing.assert_close(got_y.float(), want_y.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    for name, g, w in zip("x lns lnb w1 b1 w2 b2".split(), got, want):
        _assert_grad_close(name, g, w, dtype)


def _ctc_case(device, b=5, t=50, u=7, v=11, seed=0, s=None, in_lens=None,
              lab_lens=None):
    """Seeded logits, labels (a repeat in utterance 1), lengths and the
    lattice inputs; `s` cuts the lattice to its first s states, with labels
    of s // 2 symbols (an even s drops the final blank) and the given
    lengths."""
    from espnet_tpu_torch.ops import ctc as tctc

    if s is not None:
        b, u = len(in_lens), s // 2
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(b, t, v, generator=g)
    labels = torch.randint(1, v, (b, u), generator=g)
    if u > 1:
        labels[1, 1] = labels[1, 0]  # a repeat
    if in_lens is None:
        in_lens = [t, t - 3, 2, t, 9][:b]  # utt 2: infeasible
        lab_lens = [u, u - 2, u, 0, 3][:b]  # utt 3: U = 0
    ext = tctc.extended_labels(labels)[:, :s]
    lse = torch.logsumexp(logits, -1)
    emit = tctc._emissions(logits, ext, lse)
    skip = tctc.transition_mask(ext)
    return [x.to(device) for x in (logits, labels, torch.tensor(in_lens),
                                   torch.tensor(lab_lens), emit, skip)]


@pytest.mark.gpu
def test_ctc_lattice_kernels_match_plain(cuda):
    from espnet_tpu_torch.ops import ctc_lattice as tlat

    _, _, in_lens, lab_lens, emit, skip = _ctc_case(cuda)
    alphas, last = tlat.ctc_alphas(emit, skip, in_lens)
    gamma = tlat.ctc_gamma(emit, skip, in_lens, lab_lens, alphas)
    pa, pl = tlat.ctc_alphas_plain(emit, skip, in_lens)
    pg = tlat.ctc_gamma_plain(emit, skip, in_lens, lab_lens, pa)
    torch.cuda.synchronize()
    for got, want in ((alphas, pa), (last, pl), (gamma, pg)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


# S on both sides of the warp route's largest (256) and the block route's
# 4095 (U = 2047); T = 1; ragged lengths with 0 and 1 frames; U = 0. The
# tolerance is chip_smoke.py's CTC_TOLERANCE: |alpha| reaches ~1e3 at T = 469
@pytest.mark.gpu
@pytest.mark.parametrize("s,t,in_lens,lab_lens", [
    (1, 40, [40, 17, 0, 1], [0, 0, 0, 0]),
    (15, 40, [40, 33, 0, 1], [7, 4, 0, 1]),
    (81, 469, [469, 400, 0, 1, 37, 468], [40, 35, 0, 0, 12, 39]),
    (81, 1, [1, 0, 1], [3, 0, 1]),
    (256, 300, [300, 257, 0, 1], [127, 100, 0, 2]),
    (257, 300, [300, 257, 0, 1], [128, 100, 0, 2]),
    (4095, 60, [60, 31, 0, 1], [2047, 20, 0, 0])])
def test_ctc_lattice_routes_match_plain(cuda, s, t, in_lens, lab_lens):
    from espnet_tpu_torch.ops import ctc_lattice as tlat

    _, _, in_lens, lab_lens, emit, skip = _ctc_case(
        cuda, t=t, seed=s + t, s=s, in_lens=in_lens, lab_lens=lab_lens)
    before = (tlat.ctc_alphas.launches, tlat.ctc_gamma.launches)
    alphas, last = tlat.ctc_alphas(emit, skip, in_lens)
    gamma = tlat.ctc_gamma(emit, skip, in_lens, lab_lens, alphas)
    pa, pl = tlat.ctc_alphas_plain(emit, skip, in_lens)
    pg = tlat.ctc_gamma_plain(emit, skip, in_lens, lab_lens, pa)
    torch.cuda.synchronize()
    assert (tlat.ctc_alphas.launches, tlat.ctc_gamma.launches) == (
        before[0] + 1, before[1] + 1)
    assert tlat.design(s) == ("warp per utterance" if s <= 256
                              else "block per utterance")
    for got, want in ((alphas, pa), (last, pl), (gamma, pg)):
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-5)


@pytest.mark.gpu
def test_ctc_lattice_takes_a_uint8_mask_and_int32_lengths(cuda):
    from espnet_tpu_torch.ops import ctc_lattice as tlat

    _, _, in_lens, lab_lens, emit, skip = _ctc_case(
        cuda, t=50, seed=3, s=81, in_lens=[50, 20, 0], lab_lens=[40, 9, 0])
    want = tlat.ctc_alphas(emit, skip, in_lens)
    got = tlat.ctc_alphas(emit, skip.to(torch.uint8), in_lens.int())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    with pytest.raises(ValueError, match="exceed"):
        tlat.ctc_alphas(torch.zeros(2, 1, 4097, device=cuda),
                        torch.zeros(1, 4097, dtype=torch.bool, device=cuda),
                        torch.tensor([2], device=cuda))


@pytest.mark.gpu
def test_ctc_loss_and_gradient_match_torch_ctc(cuda):
    """A second oracle: torch's own CTC (zero_infinity), float32."""
    from espnet_tpu_torch.ops import ctc as tctc

    logits, labels, in_lens, lab_lens, _, _ = _ctc_case(cuda)
    x = logits.clone().requires_grad_(True)
    loss = tctc.ctc_loss(x, labels, in_lens, lab_lens, reduction="sum")
    loss.backward()
    y = logits.clone().requires_grad_(True)
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(y, -1).transpose(0, 1), labels, in_lens, lab_lens,
        blank=0, reduction="sum", zero_infinity=True)
    ref.backward()
    torch.testing.assert_close(loss, ref, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(x.grad, y.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,m,drop,activation,d,f", _both_dtypes_then_bf16(
    [(333, 0.0, "swish", 256, 1024), (300, 0.1, "swish", 256, 1024),
     (600, 0.1, "relu", 256, 1024), (300, 0.1, "swish", 512, 1024),
     (300, 0.1, "relu", 128, 1024), (333, 0.1, "swish", 384, 1024)],
    [(1, 0.1, "swish", 256, 2048), (4097, 0.1, "relu", 256, 2048),
     (4097, 0.0, "swish", 512, 1024), (333, 0.1, "swish", 128, 2048),
     (1, 0.0, "relu", 384, 2048), (4097, 0.1, "swish", 384, 1024),
     (333, 0.0, "relu", 512, 2048), (4097, 0.0, "relu", 128, 1024)]))
def test_fused_ffn_kernels_match_plain(cuda, dtype, m, drop, activation, d,
                                       f):
    x, _, _, w1, b1, w2, b2 = _ffn_args(cuda, dtype, m=m, d=d, f=f)
    args = (x, w1, b1, w2, b2)
    kw = dict(seed=-12345, drop_rate=drop, activation=activation)
    gout = torch.randn(m, d, generator=torch.Generator().manual_seed(m)
                       ).to(cuda, dtype)
    fwd, bwd = tfused.fused_ffn.launches, tfused.fused_ffn_bwd.launches
    got_y, got = _grads(lambda *a: tfused.fused_ffn(*a, **kw), args,
                        range(5), gout)
    torch.cuda.synchronize()
    assert tfused.fused_ffn.launches == fwd + 1
    assert tfused.fused_ffn_bwd.launches == bwd + 1
    want_y, want = _grads(lambda *a: tfused.fused_ffn_plain(*a, **kw), args,
                          range(5), gout)
    torch.testing.assert_close(got_y.float(), want_y.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    for name, g, w in zip("x w1 b1 w2 b2".split(), got, want):
        _assert_grad_close(name, g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_bwd_layout_matches_the_kernels(cuda, dtype):
    """The Python layout of the backward pair (buffer shapes) and the
    kernels' row blocks agree at every D the kernels are built for."""
    from espnet_tpu_torch.ops.cuda_build import kernel_library

    lib = kernel_library()
    for d in ffn_common.KERNEL_MODEL_DIMS:
        lay = ffn_common.bwd_layout(4097, d, 1024, dtype)
        rows = lib.espnet_ffn_bwd_rows_per_block(
            d, ffn_common.DTYPE_CODES[dtype])
        assert lay.row_blocks == -(-4097 // rows), (d, rows)


def _flash_args(device, dtype, b=3, h=4, t=200, d=64, lengths=(200, 77, 0)):
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32))
               .to(device, dtype) for _ in range(3))
    valid = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    bias = np.where(valid, 0.0, np.finfo(np.float32).min).astype(np.float32)
    return q, k, v, torch.from_numpy(bias[:, None, None, :]).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", [(200, 64), (1, 64), (64, 32), (65, 128),
                                 (469, 64), (65, 48), (200, 96),
                                 # one key tile and its edges, every head
                                 # dim the kernels are built for
                                 (1, 32), (63, 32), (65, 32), (469, 32),
                                 (63, 64), (64, 64), (65, 64), (1, 128),
                                 (63, 128), (64, 128), (469, 128),
                                 (1, 192), (65, 192), (626, 192),
                                 (200, 136)])
def test_flash_kernel_and_its_gradient_match_plain(cuda, dtype, t, d):
    """Ragged keys, one utterance with every key masked (the uniform
    average of v); the backward recomputes through the plain version. Head
    dims 48, 96 and 136 run zero-padded to the kernel's 64, 128 and 192
    (192: FastSpeech2's heads)."""
    args = _flash_args(cuda, dtype, t=t, d=d,
                       lengths=(t, max(1, t // 3), 0))
    gout = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
        t)).to(cuda, dtype)
    before = tflash.flash_attention.launches
    got_y, got = _grads(tflash.flash_attention, args, range(3), gout)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    want_y, want = _grads(tflash.flash_attention_plain, args, range(3), gout)
    assert got_y.dtype == dtype and torch.isfinite(got_y.float()).all()
    assert got_y.shape == want_y.shape
    torch.testing.assert_close(got_y.float(), want_y.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    for name, g, w in zip("qkv", got, want):
        _assert_grad_close(name, g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("t,d", [(200, 64), (469, 64), (65, 32), (63, 128),
                                 (200, 96)])
def test_flash_bf16_gradient_is_the_reference_vjp(cuda, t, d):
    """In bf16 the kernel route's backward recomputes through
    `reference_attention` (a bf16 score product, bf16 weights), as the JAX
    custom VJP does: its dq, dk, dv against autograd through
    `reference_attention` itself, on the same inputs and cotangent."""
    args = _flash_args(cuda, torch.bfloat16, t=t, d=d,
                       lengths=(t, max(1, t // 3), 0))
    gout = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
        t + d)).to(cuda, torch.bfloat16)
    _, got = _grads(tflash.flash_attention, args, range(3), gout)
    _, want = _grads(lambda q, k, v, bias: tflash.reference_attention(
        q, k, v, bias.clamp(min=trel.NEG)), args, range(3), gout)
    torch.cuda.synchronize()
    for name, g, w in zip("qkv", got, want):
        assert torch.isfinite(g.float()).all(), name
        _assert_grad_close(name, g, w, torch.bfloat16)


@pytest.mark.gpu
def test_kernels_raise_for_shapes_the_gate_passes_but_they_lack(cuda):
    """Head dims past 128 (rel-pos) or 192 (flash) and d_model past 512
    pass the JAX package's gates but not the kernels: on the card they
    raise, never run plain."""
    args = _relpos_args(cuda, torch.float32, t=20, d=136, lengths=(20, 9, 0))
    assert trel.kernel_takes(136)
    with pytest.raises(ValueError, match="up to 128"):
        trel.relpos_attention(*args)
    fargs = _flash_args(cuda, torch.float32, t=20, d=200,
                        lengths=(20, 9, 0))
    assert trel.kernel_takes(200)
    with pytest.raises(ValueError, match="up to 192"):
        tflash.flash_attention(*fargs)
    x, lns, lnb, w1, b1, w2, b2 = _ffn_args(cuda, torch.float32, m=40, d=640)
    assert ffn_common.kernel_takes(640, 1024)
    with pytest.raises(ValueError, match="D=640"):
        tffn.prenorm_ffn(x, lns, lnb, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="D=640"):
        tfused.fused_ffn(x, w1, b1, w2, b2)


def _gate_model(device, d_model, heads, encoder_type="conformer"):
    from espnet_tpu_torch.models.asr import ASRConfig, ASRModel, init_random_

    cfg = ASRConfig(vocab_size=50, d_model=d_model, num_heads=heads,
                    d_ff=4 * d_model, num_encoder_layers=2,
                    num_decoder_layers=1, decoder_d_ff=4 * d_model,
                    conformer_kernel_size=15, normalize="utterance_mvn",
                    encoder_type=encoder_type, dtype=torch.bfloat16)
    model = init_random_(ASRModel(cfg), torch.Generator().manual_seed(0))
    return model.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,heads,encoder_type,kernels", [
    # d 144, dk 36: the JAX gates send every call to the plain versions
    (144, 4, "conformer", set()),
    (144, 4, "e_branchformer", set()), (144, 4, "transformer", set()),
    # dk 128: the rel-pos forward and backward kernels
    (512, 4, "conformer", {"relpos_attention", "relpos_attention_bwd",
                           "prenorm_ffn", "prenorm_ffn_bwd"}),
    # dk 96 padded to 128; the FFN kernels at D=384 and D=128
    (384, 4, "conformer", {"relpos_attention", "relpos_attention_bwd",
                           "prenorm_ffn", "prenorm_ffn_bwd"}),
    (384, 4, "transformer", {"flash_attention", "prenorm_ffn",
                             "prenorm_ffn_bwd"}),
    (384, 4, "e_branchformer", {"relpos_attention", "relpos_attention_bwd",
                                "fused_ffn", "fused_ffn_bwd"}),
    (128, 4, "e_branchformer", {"relpos_attention", "relpos_attention_bwd",
                                "fused_ffn", "fused_ffn_bwd"})])
def test_gated_shapes_serve_and_train_on_card(cuda, d_model, heads,
                                              encoder_type, kernels):
    """Other widths serve and train on the card: each kernel launches
    exactly where its shape gate sends the call, the plain versions run
    elsewhere, decided before any launch: an encode and a train step."""
    wrappers = {
        "relpos_attention": trel.relpos_attention,
        "relpos_attention_bwd": trel.relpos_attention_bwd,
        "prenorm_ffn": tffn.prenorm_ffn,
        "prenorm_ffn_bwd": tffn.prenorm_ffn_bwd,
        "fused_ffn": tfused.fused_ffn, "fused_ffn_bwd": tfused.fused_ffn_bwd,
        "flash_attention": tflash.flash_attention}
    before = {k: fn.launches for k, fn in wrappers.items()}
    model = _gate_model(cuda, d_model, heads, encoder_type)
    speech = 0.1 * torch.randn(2, 16000, generator=torch.Generator()
                               .manual_seed(1)).to(cuda)
    lens = torch.tensor([16000, 12000], device=cuda)
    with torch.no_grad():
        enc, olens = model.eval().encode(speech, lens)
    assert torch.isfinite(enc.float()).all()
    model.train()
    text = torch.randint(1, 49, (2, 6), device=cuda)
    loss, _ = model(speech, lens, text, torch.tensor([6, 4], device=cuda),
                    torch.Generator().manual_seed(2))
    loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)
    launched = {k for k, fn in wrappers.items() if fn.launches > before[k]}
    assert launched == kernels


def _glu_args(device, dtype, m, d):
    rng = np.random.RandomState(d + m)
    x, xr = rng.randn(m, d), rng.randn(m, d)
    lns, lnb = 1 + 0.2 * rng.randn(d), 0.2 * rng.randn(d)
    w1, b1 = rng.randn(d, 2 * d) / np.sqrt(d), 0.2 * rng.randn(2 * d)
    w2, b2 = rng.randn(d, d) / np.sqrt(d), 0.2 * rng.randn(d)
    t = [torch.from_numpy(a.astype(np.float32)).to(device)
         for a in (x, xr, lns, lnb, w1, b1, w2, b2)]
    for i in (0, 1, 4, 6):  # activations and weights in the compute dtype
        t[i] = t[i].to(dtype)
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,drop", [(333, 256, 0.0), (300, 256, 0.1),
                                      (300, 128, 0.1), (97, 384, 0.1),
                                      (300, 512, 0.1),
                                      # the bf16 row blocks' edges: 64 rows
                                      # at D <= 256, 32 above
                                      (1, 256, 0.1), (65, 128, 0.1),
                                      (641, 256, 0.1), (1, 512, 0.0),
                                      (65, 384, 0.1), (641, 512, 0.1)])
def test_conv_head_and_tail_kernels_match_plain(cuda, dtype, m, d, drop):
    """The split route's head (`prenorm_glu`) and tail (`postnorm_proj`,
    hash dropout over 256-row tiles), forward and backward; M = 1, 65 and
    64·10 + 1 cut the bf16 row blocks."""
    x, xr, lns, lnb, w1, b1, w2, b2 = _glu_args(cuda, dtype, m, d)
    gout = torch.randn(m, d, generator=torch.Generator().manual_seed(m)
                       ).to(cuda, dtype)
    counts = [f.launches for f in (tglu.prenorm_glu, tglu.prenorm_glu_bwd,
                                   tglu.postnorm_proj,
                                   tglu.postnorm_proj_bwd)]
    head = (x, lns, lnb, w1, b1)
    got_y, got = _grads(tglu.prenorm_glu, head, range(5), gout)
    kw = dict(seed=-4242, drop_rate=drop)
    tail = (x, xr, lns, lnb, w2, b2)
    got_t, got_tg = _grads(lambda *a: tglu.postnorm_proj(*a, **kw), tail,
                           range(6), gout)
    torch.cuda.synchronize()
    assert [f.launches for f in (tglu.prenorm_glu, tglu.prenorm_glu_bwd,
                                 tglu.postnorm_proj, tglu.postnorm_proj_bwd)
            ] == [c + 1 for c in counts]
    want_y, want = _grads(tglu.prenorm_glu_plain, head, range(5), gout)
    want_t, want_tg = _grads(lambda *a: tglu.postnorm_proj_plain(*a, **kw),
                             tail, range(6), gout)
    for g, w in ((got_y, want_y), (got_t, want_t)):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), w.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
    for name, g, w in zip("x lns lnb w1 b1".split(), got, want):
        _assert_grad_close("head " + name, g, w, dtype)
    for name, g, w in zip("g x_res lns lnb w2 b2".split(), got_tg, want_tg):
        _assert_grad_close("tail " + name, g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [256, 512])
def test_conv_tail_dropout_is_the_keep_mask_across_blocks(cuda, d):
    """bf16, M = 600 rows (blocks of 64 or 32 rows, 256-row hash tiles):
    with x_res = 0 and b2 = 0, y is 0 exactly where `keep_mask` drops and
    nonzero where it keeps; with dy = 1 the backward's regenerated mask
    gives db2 = the kept count of each column times the keep scale."""
    m, seed, rate = 600, -4242, 0.1
    _, _, lns, lnb, _, _, w2, _ = _glu_args(cuda, torch.bfloat16, m, d)
    g = torch.randn(m, d, generator=torch.Generator().manual_seed(3)
                    ).to(cuda, torch.bfloat16).requires_grad_(True)
    b2 = torch.zeros(d, device=cuda, requires_grad=True)
    xr = torch.zeros(m, d, device=cuda, dtype=torch.bfloat16)
    y = tglu.postnorm_proj(g, xr, lns, lnb, w2, b2, seed=seed,
                           drop_rate=rate)
    y.backward(torch.ones_like(y))
    q = ffn_common.quantize_rate(rate)
    keep = ffn_common.keep_mask(m, d, seed, q, cuda)
    assert 0.05 < 1 - keep.float().mean() < 0.15
    assert torch.equal(y != 0, keep)
    # float32 sums of up to 600 equal terms in another order; one kept
    # element more or less moves a column's sum by 1/540
    torch.testing.assert_close(
        b2.grad, keep.float().sum(dim=0) * (256.0 / (256 - q)), atol=0,
        rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_glu_layout_matches_the_kernels(cuda, dtype):
    """The C library's rows per block of the head's and tail's backward row
    kernels are `rows_per_block`'s at every D the kernels take."""
    from espnet_tpu_torch.ops.cuda_build import kernel_library

    lib = kernel_library()
    for d in ffn_common.KERNEL_MODEL_DIMS:
        rows = lib.espnet_conv_glu_rows_per_block(
            d, ffn_common.DTYPE_CODES[dtype])
        assert rows == tglu.rows_per_block(d, dtype), (d, rows)
        assert tglu.bwd_layout(4097, d, d, dtype).row_blocks == -(-4097
                                                                 // rows)


def _module_args(device, dtype, lengths, t, d, k):
    rng = np.random.RandomState(d + k + t)
    b = len(lengths)
    x = rng.randn(b, t, d)
    mask = torch.from_numpy(np.arange(t)[None, :]
                            < np.asarray(lengths)[:, None]).to(device)
    p = [1 + 0.2 * rng.randn(d), 0.2 * rng.randn(d),
         rng.randn(d, 2 * d) / np.sqrt(d), 0.2 * rng.randn(2 * d),
         0.3 * rng.randn(k, d), 0.2 * rng.randn(d),
         1 + 0.2 * rng.randn(d), 0.2 * rng.randn(d),
         rng.randn(d, d) / np.sqrt(d), 0.2 * rng.randn(d)]
    t_ = [torch.from_numpy(a.astype(np.float32)).to(device)
          for a in [x] + p]
    for i in (0, 3, 5, 9):  # x, w1, dw, w2 in the compute dtype
        t_[i] = t_[i].to(dtype)
    return t_[0], mask, t_[1:]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,k,t,lengths,drop", _both_dtypes_then_bf16(
    [(256, 31, 75, (75, 40, 1), 0.1), (144, 31, 70, (70, 3, 33), 0.1),
     (128, 7, 33, (33, 32, 1), 0.0), (512, 31, 64, (64, 17), 0.1),
     (384, 15, 5, (5, 1), 0.1), (64, 1, 40, (40, 39), 0.1)],
    # the tensor-core tiles' edges: 64 frames at D <= 256 (T = 63, 64, 65,
    # 129 and the training length), 32 above (T = 31, 32, 33), padded
    # widths 64 and 144, k 1 to 31
    [(256, 31, 63, (63, 1), 0.1), (256, 31, 64, (64, 33, 1), 0.1),
     (256, 31, 65, (65, 64, 2), 0.1), (256, 31, 469, (469, 300, 64, 1), 0.1),
     (64, 31, 65, (65, 1), 0.1), (144, 31, 63, (63, 62), 0.0),
     (144, 15, 129, (129, 65, 1), 0.1), (384, 31, 31, (31, 1), 0.1),
     (384, 7, 33, (33, 32), 0.1), (512, 31, 32, (32, 31, 1), 0.1),
     (512, 3, 33, (33, 1), 0.0), (128, 1, 64, (64, 63), 0.1)]))
def test_conv_module_kernels_match_plain(cuda, dtype, d, k, t, lengths,
                                         drop):
    """The whole-module route, forward and backward: ragged utterances (1
    frame and T among them), d 144 and 64 (no JAX gate on this route), k 1
    to 31, tiles of 32 frames (float32) or 64 and 32 (bf16) with T not a
    multiple of them."""
    x, mask, params = _module_args(cuda, dtype, lengths, t, d, k)
    kw = dict(seed=97, drop_rate=drop, kernel_size=k)
    args = (x, mask, *params)
    gout = torch.randn(x.shape, generator=torch.Generator().manual_seed(t)
                       ).to(cuda, dtype)
    fwd, bwd = tcm.conv_module.launches, tcm.conv_module_bwd.launches
    diff = [0] + list(range(2, 12))
    got_y, got = _grads(lambda *a: tcm.conv_module(*a, **kw), args, diff,
                        gout)
    torch.cuda.synchronize()
    assert tcm.conv_module.launches == fwd + 1
    assert tcm.conv_module_bwd.launches == bwd + 1
    want_y, want = _grads(lambda *a: tcm.conv_module_plain(*a, **kw), args,
                          diff, gout)
    assert got_y.dtype == dtype and torch.isfinite(got_y.float()).all()
    torch.testing.assert_close(got_y.float(), want_y.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    names = "x ln1s ln1b w1 b1 dw db ln2s ln2b w2 b2".split()
    for name, g, w in zip(names, got, want):
        _assert_grad_close(name, g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [256, 144])
def test_conv_module_hash_mask_matches_plain(cuda, d):
    """With W2 the identity and b2 = 0, y - x is drop(s): y equals x exactly
    where the utterance-tiled mask drops, and differs where it keeps, on
    every element whose undropped value is clear of x's rounding. The bf16
    tensor-core forward applies the hash on its fragments."""
    lengths, t, k, q_rate = (469, 300, 64, 1), 469, 31, 0.1
    x, mask, params = _module_args(cuda, torch.bfloat16, lengths, t, d, k)
    params[8] = torch.eye(d, device=cuda, dtype=torch.bfloat16)
    params[9] = torch.zeros(d, device=cuda)
    with torch.no_grad():
        y = tcm.conv_module(x, mask, *params, seed=-77, drop_rate=q_rate,
                            kernel_size=k)
        a = tcm.conv_module_plain(x, mask, *params, kernel_size=k) - x
    q = ffn_common.quantize_rate(q_rate)
    keep = ffn_common.keep_mask(len(lengths) * t, d, -77, q, cuda,
                                tile_rows=t).reshape(x.shape)
    clear = a.float().abs() > 2.0 ** -6 * x.float().abs()
    assert clear.float().mean() > 0.9
    assert torch.equal((y != x)[clear], keep[clear])
    assert torch.equal(y[~keep], x[~keep])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_module_layout_matches_the_kernels(cuda, dtype):
    """The C library's frames per block and `bwd_layout`'s agree at every
    width the kernels take (DP 128-512, D padded to them)."""
    from espnet_tpu_torch.ops.cuda_build import kernel_library

    lib = kernel_library()
    for d in (64, 128, 144, 256, 384, 512):
        lay = tcm.bwd_layout(4, 469, d, 31, dtype)
        rows = lib.espnet_conv_module_tile_rows(
            d, ffn_common.DTYPE_CODES[dtype])
        assert rows == lay.tile_rows, (d, rows)
        assert lay.tiles == 4 * -(-469 // rows)


@pytest.mark.gpu
def test_conv_kernels_raise_past_their_shapes(cuda):
    """The head and tail take D 128-512 (the split gate passes only
    multiples of 128); the whole module D up to 512 and k up to 31 (its
    route has no gate): past that they raise on the card."""
    x, xr, lns, lnb, w1, b1, w2, b2 = _glu_args(cuda, torch.float32, 40, 640)
    with pytest.raises(ValueError, match="D=640"):
        tglu.prenorm_glu(x, lns, lnb, w1, b1)
    with pytest.raises(ValueError, match="D=640"):
        tglu.postnorm_proj(x, xr, lns, lnb, w2, b2)
    for d, k in ((640, 31), (256, 33)):
        x, mask, params = _module_args(cuda, torch.float32, (9, 4), 9, d, k)
        with pytest.raises(ValueError, match="up to"):
            tcm.conv_module(x, mask, *params, kernel_size=k)


@pytest.mark.gpu
def test_asr_cli_trains_and_decodes_on_the_card(cuda, tmp_path):
    """asr_train for one epoch and asr_inference on a 4-utterance corpus,
    both on the card (their default device), through the ported kernels:
    the conformer of d_model 128 takes the rel-pos and pre-norm FFN kernels,
    and the CTC loss the lattice pair."""
    from espnet_tpu_torch.bin import asr_inference, asr_train
    from espnet_tpu_torch.data.synth import generate_corpus
    from espnet_tpu_torch.ops import ctc_lattice

    generate_corpus(tmp_path / "data", n_utts=4, seed=0)
    for fn in (trel.relpos_attention, tffn.prenorm_ffn,
               ctc_lattice.ctc_alphas):
        fn.launches = 0
    asr_train.main([
        "--data.train_dir", str(tmp_path / "data"),
        "--data.valid_dir", str(tmp_path / "data"),
        "--run.output_dir", str(tmp_path / "exp"), "--run.max_epoch", "1",
        "--data.batch_size", "4", "--model.d_model", "128",
        "--model.num_heads", "2", "--model.d_ff", "256",
        "--model.num_encoder_layers", "2", "--model.num_decoder_layers", "1",
        "--model.decoder_d_ff", "256", "--model.n_mels", "40",
        "--optim.name", "adamw", "--optim.weight_decay", "0.01"])
    for fn in (trel.relpos_attention, tffn.prenorm_ffn,
               ctc_lattice.ctc_alphas):
        assert fn.launches > 0, fn.__name__
    for name in ("ep1.params.msgpack", "valid.acc.ave.params.msgpack",
                 "checkpoint.pt", "stats/feats_stats.npz"):
        assert (tmp_path / "exp" / name).exists(), name
    hyps = asr_inference.main([
        "--exp_dir", str(tmp_path / "exp"), "--data_dir",
        str(tmp_path / "data"), "--output_dir", str(tmp_path / "dec"),
        "--beam_size", "4", "--max_steps", "8", "--batch_size", "4"])
    assert len(hyps) == 4
    assert (tmp_path / "dec" / "score_cer.txt").exists()


@pytest.mark.gpu
@pytest.mark.parametrize("options", [{}, {"fused_conv": True}])
def test_asr_variants_launch_their_kernels_on_the_card(cuda, options):
    """The asr-variants phase in small (d_model 128, 2 layers, float32):
    InterCTC launches the CTC pair twice a step; remat re-runs each block's
    forward kernels in the backward pass and gives the plain step's
    gradients, leaving the generator where the plain step does."""
    import dataclasses

    from espnet_tpu_torch.models.asr import ASRConfig, ASRModel, init_random_
    from espnet_tpu_torch.ops import conv_module, ctc_lattice, launches

    cfg = ASRConfig(vocab_size=50, d_model=128, num_heads=2, d_ff=256,
                    num_encoder_layers=2, num_decoder_layers=1,
                    decoder_d_ff=256, conformer_kernel_size=15,
                    normalize="utterance_mvn", interctc_layer_idx=(1,),
                    interctc_weight=0.3)
    state = init_random_(ASRModel(cfg, options),
                         torch.Generator().manual_seed(0)).state_dict()
    speech = 0.1 * torch.randn(2, 16000, generator=torch.Generator()
                               .manual_seed(1)).to(cuda)
    lens = torch.tensor([16000, 12000], device=cuda)
    text = torch.randint(1, 49, (2, 6), device=cuda)
    tlens = torch.tensor([6, 4], device=cuda)
    grads, states = {}, {}
    for remat in (False, True):
        model = ASRModel(dataclasses.replace(cfg, remat_encoder=remat),
                         options)
        model.load_state_dict(state)
        model = model.to(cuda).train()
        gen = torch.Generator().manual_seed(3)
        launches.reset()
        loss, stats = model(speech, lens, text, tlens, gen)
        loss.backward()
        torch.cuda.synchronize()
        assert "loss_interctc_layer1" in stats
        assert ctc_lattice.ctc_alphas.launches == 2
        assert ctc_lattice.ctc_gamma.launches == 2
        assert tffn.prenorm_ffn.launches == 2 * 2 * (2 if remat else 1)
        assert trel.relpos_attention.launches == 2 * (2 if remat else 1)
        assert trel.relpos_attention_bwd.launches == 2
        if options:
            assert conv_module.conv_module.launches == 2 * (2 if remat
                                                            else 1)
        grads[remat] = [p.grad.double() for p in model.parameters()]
        states[remat] = gen.get_state()
    total = float(torch.sqrt(sum((g ** 2).sum() for g in grads[False])))
    for a, b in zip(grads[True], grads[False]):
        assert float((a - b).norm()) <= 1e-5 * max(float(b.norm()),
                                                   1e-3 * total)
    assert torch.equal(states[True], states[False])


@pytest.mark.gpu
def test_recipe_runs_on_the_card(cuda, tmp_path):
    """bin.run, stages 1-12, a reduced conformer on a 12-utterance corpus,
    on the card (the default device), then a second call that skips every
    stage."""
    from espnet_tpu_torch.bin import run

    argv = [
        "--recipe.expdir", str(tmp_path / "exp"),
        "--recipe.datadir", str(tmp_path / "data"),
        "--recipe.train_set", "train", "--recipe.valid_set", "train",
        "--recipe.test_sets", "test", "--recipe.synth_utts", "12",
        "--recipe.asr_args",
        "--run.max_epoch 1 --data.batch_size 4 --model.d_model 128 "
        "--model.num_heads 2 --model.d_ff 256 --model.num_encoder_layers 2 "
        "--model.num_decoder_layers 1 --model.decoder_d_ff 256 "
        "--model.n_mels 40",
        "--recipe.decode_args", "--beam_size 4 --max_steps 8 --batch_size 4"]
    run.main(argv)
    exp = tmp_path / "exp"
    for n in range(1, 13):
        assert (exp / f".stage{n}.done").exists(), n
    assert (exp / "decode_test" / "score_wer.txt").exists()
    assert "# Snt" in (exp / "RESULTS.md").read_text()
    stamp = (exp / "packed_model.zip").stat().st_mtime_ns
    run.main(argv)
    assert (exp / "packed_model.zip").stat().st_mtime_ns == stamp


def _rnnt_case(device, t, u, ilens, llens, v=64, seed=0):
    """The lattice inputs of random (B, T, U+1, V) logits: blank and the
    masked label emissions, as the loss builds them."""
    from espnet_tpu_torch.ops import transducer as ttr

    b = len(ilens)
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.randn(b, t, u + 1, v).astype(np.float32))
    labels = rng.randint(1, v, (b, u))
    llens = np.asarray(llens)
    labels[np.arange(u)[None, :] >= llens[:, None]] = 0
    lp = torch.log_softmax(logits.to(device), -1)
    labels, llens = torch.from_numpy(labels).to(device), torch.from_numpy(
        llens).to(device)
    blank, lab = ttr.lattice_inputs(lp, labels, llens)
    return blank, lab, torch.tensor(ilens, device=device), llens


# the CTC pair's float32 log-space tolerance for alpha and log Z; the
# occupancies exponentiate alpha + emission + beta - log Z, sums near 8e3
# where a float32 ulp is 4.9e-4: a few ulps of the exponent, as absolute
# error on a value in [0, 1]
RNNT_TOL, RNNT_OCC_ATOL = (1e-3, 1e-5), 2e-3


@pytest.mark.gpu
@pytest.mark.parametrize("t,u,ilens,llens,v", [
    (468, 40, [468] * 8, [40] * 8, 5000),
    (468, 200, [468, 301, 17, 1, 420, 233], [200, 150, 3, 0, 199, 81], 64),
    (1, 0, [1, 1], [0, 0], 8),
    (50, 1023, [50, 1], [1023, 0], 16),
    (37, 5, [37, 1, 20], [5, 0, 3], 16)])
def test_transducer_lattice_kernels_match_plain(cuda, t, u, ilens, llens, v):
    from espnet_tpu_torch.ops import transducer_lattice as trl

    blank, lab, ilen, llen = _rnnt_case(cuda, t, u, ilens, llens, v)
    before = (trl.transducer_alphas.launches,
              trl.transducer_occupancy.launches)
    alphas, log_z = trl.transducer_alphas(blank, lab, ilen, llen)
    occ_b, occ_l = trl.transducer_occupancy(blank, lab, ilen, llen, alphas,
                                            log_z)
    pa, plz = trl.transducer_alphas_plain(blank, lab, ilen, llen)
    pob, pol = trl.transducer_occupancy_plain(blank, lab, ilen, llen, pa,
                                              plz)
    torch.cuda.synchronize()
    assert (trl.transducer_alphas.launches,
            trl.transducer_occupancy.launches) == (before[0] + 1,
                                                   before[1] + 1)
    atol, rtol = RNNT_TOL
    for got, want in ((alphas, pa), (log_z, plz)):
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    for got, want in ((occ_b, pob), (occ_l, pol)):
        torch.testing.assert_close(got, want, atol=RNNT_OCC_ATOL, rtol=0)


@pytest.mark.gpu
def test_transducer_lattice_refuses_a_wider_lattice(cuda):
    """U + 1 > 1024 raises on the card (one thread a label position),
    never runs the plain version."""
    from espnet_tpu_torch.ops import transducer_lattice as trl

    assert trl.max_labels() == 1024
    assert trl.kernel_takes(1024) and not trl.kernel_takes(1025)
    before = trl.transducer_alphas.launches
    with pytest.raises(ValueError, match="exceed"):
        trl.transducer_alphas(torch.zeros(1, 2, 1025, device=cuda),
                              torch.zeros(1, 2, 1024, device=cuda),
                              torch.tensor([2], device=cuda),
                              torch.tensor([1], device=cuda))
    assert trl.transducer_alphas.launches == before


@pytest.mark.gpu
def test_transducer_loss_routes_agree_on_card(cuda):
    """The loss and its logits gradient through the kernel pair against the
    plain versions, float32 logits."""
    from espnet_tpu_torch.ops import transducer as ttr

    rng = np.random.RandomState(4)
    b, t, u, v = 4, 120, 20, 500
    logits = torch.from_numpy(rng.randn(b, t, u + 1, v).astype(
        np.float32)).to(cuda)
    labels = torch.from_numpy(rng.randint(1, v, (b, u))).to(cuda)
    ilen = torch.tensor([120, 77, 1, 60], device=cuda)
    llen = torch.tensor([20, 11, 0, 20], device=cuda)
    labels[torch.arange(u, device=cuda)[None, :] >= llen[:, None]] = 0
    out = {}
    for use in (True, False):
        x = logits.clone().requires_grad_(True)
        nll = ttr.transducer_loss(x, labels, ilen, llen, reduction="none",
                                  use_kernels=use)
        nll.sum().backward()
        out[use] = (nll.detach(), x.grad)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[True][0], out[False][0], atol=1e-3,
                               rtol=1e-5)
    torch.testing.assert_close(out[True][1], out[False][1],
                               atol=RNNT_OCC_ATOL, rtol=0)


def _ragged_ids(rng, b, n, vocab, lengths, device):
    ids = rng.randint(1, vocab - 1, (b, n))
    lens = np.asarray(lengths)
    ids[np.arange(n)[None, :] >= lens[:, None]] = 0
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(lens).to(device))


def _kernel_vs_plain_loss(model, args):
    """(loss with kernels, loss plain, launch counts of the kernel run)."""
    from espnet_tpu_torch.ops import launches

    wrappers = launches.reset()
    model.set_use_kernels(True)
    lk = float(model(*args)[0])
    counts = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    model.set_use_kernels(False)
    lp = float(model(*args)[0])
    model.set_use_kernels(True)
    return lk, lp, counts


@pytest.mark.gpu
def test_mt_model_takes_flash_and_prenorm_ffn_on_the_card(cuda):
    """A 2-layer MT model (d_model 128, head dim 64): each encoder layer
    launches the flash kernel and the pre-norm FFN once a forward; its
    float32 loss equals the plain route's."""
    from espnet_tpu_torch.models.asr import init_random_
    from espnet_tpu_torch.models.mt import MTConfig, MTModel

    cfg = MTConfig(vocab_size=50, src_vocab_size=40, d_model=128,
                   num_heads=2, d_ff=256, num_encoder_layers=2,
                   num_decoder_layers=1, decoder_d_ff=256, dropout_rate=0.0)
    model = init_random_(MTModel(cfg), torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    rng = np.random.RandomState(7)
    args = (*_ragged_ids(rng, 3, 37, 40, [37, 20, 1], cuda),
            *_ragged_ids(rng, 3, 9, 50, [9, 4, 1], cuda))
    with torch.no_grad():
        lk, lp, counts = _kernel_vs_plain_loss(model, args)
    assert counts == {"flash_attention": 2, "prenorm_ffn": 2}
    assert abs(lk - lp) <= 1e-4 * abs(lp)


@pytest.mark.gpu
def test_st_model_takes_relpos_ffn_and_ctc_on_the_card(cuda):
    """A 2-layer ST conformer with the source-side CTC head and ASR
    decoder: the rel-pos kernel once a layer, the pre-norm FFN twice, the
    CTC pair on the source labels; its float32 loss and gradient equal the
    plain route's."""
    from espnet_tpu_torch.models.asr import init_random_
    from espnet_tpu_torch.models.st import STConfig, STModel

    cfg = STConfig(vocab_size=50, src_vocab_size=40, n_mels=40,
                   use_specaug=False, normalize="utterance_mvn",
                   d_model=128, num_heads=2, d_ff=256, num_encoder_layers=2,
                   num_decoder_layers=1, decoder_d_ff=256,
                   num_asr_decoder_layers=1, dropout_rate=0.0,
                   asr_weight=0.3, mtlalpha=0.5)
    model = init_random_(STModel(cfg), torch.Generator().manual_seed(0))
    model = model.to(cuda).train()
    rng = np.random.RandomState(8)
    lens = np.array([32000, 20000, 9000])
    speech = np.zeros((3, 32000), np.float32)
    for i, n in enumerate(lens):
        speech[i, :n] = 0.1 * rng.randn(n)
    args = (torch.from_numpy(speech).to(cuda), torch.from_numpy(lens).to(cuda),
            *_ragged_ids(rng, 3, 9, 50, [9, 4, 1], cuda),
            *_ragged_ids(rng, 3, 12, 40, [12, 6, 2], cuda))
    lk, lp, counts = _kernel_vs_plain_loss(model, args)
    assert counts == {"relpos_attention": 2, "prenorm_ffn": 4,
                      "ctc_alphas": 1}
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    grads = {}
    for use in (True, False):
        model.set_use_kernels(use)
        loss, _ = model(*args)
        grads[use] = torch.autograd.grad(loss, list(model.parameters()))
    model.set_use_kernels(True)
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(*grads.values()))
    den = sum(float((b ** 2).sum()) for b in grads[False])
    assert (num / den) ** 0.5 < 1e-3


@pytest.mark.gpu
def test_fusion_scorers_and_timesync_on_the_card(cuda):
    """The n-gram's search step and the look-ahead word LM's on the card
    give the CPU's rows; a tiny ASR model fused with the n-gram, and its
    time-synchronous search, decode on the card as on the CPU."""
    from espnet_tpu_torch.decode.asr_inference import Speech2Text
    from espnet_tpu_torch.decode.extlm import (LookAheadWordLM,
                                               make_lexical_tree)
    from espnet_tpu_torch.decode.timesync import Speech2TextTimeSync
    from espnet_tpu_torch.lm.ngram import DenseNgramScorer, NgramModel
    from espnet_tpu_torch.models.asr import ASRConfig, ASRModel, init_random_
    from espnet_tpu_torch.models.lm import RNNLM

    letters = list("abcdefg")
    tokens = ["<blank>", "<unk>", "<space>", *letters, "<sos/eos>"]
    rng = np.random.RandomState(0)
    sents = [[letters[i] for i in rng.randint(0, 7, rng.randint(1, 8))]
             for _ in range(40)]
    ngram = DenseNgramScorer(NgramModel.train(sents, 3), tokens)
    steps = rng.randint(2, len(tokens) - 1, (6, 4))
    rows = {}
    for dev in (torch.device("cpu"), cuda):
        fn, cache, out = ngram.make_score_fn(dev), ngram.init_cache(4, dev), []
        for step in steps:
            row, cache = fn(torch.from_numpy(step).to(dev), 0, cache)
            out.append(row.cpu())
        rows[dev.type] = torch.stack(out)
    assert torch.equal(rows["cpu"], rows["cuda"])
    words = ["<blank>", "<unk>", "ab", "abc", "bad", "ca", "<sos/eos>"]
    tree = make_lexical_tree({w: i for i, w in enumerate(words)},
                             {c: i for i, c in enumerate(tokens)}, 1)
    wlm = RNNLM(len(words), 32, 1, 0.0)
    init_random_(wlm, torch.Generator().manual_seed(1))
    for dev in (torch.device("cpu"), cuda):
        lm = wlm.to(dev).eval()
        la = LookAheadWordLM(lambda c, t: lm.score_step(t, 0, c),
                             lambda b, d: lm.init_cache(b, device=d), tree,
                             word_eos=6, word_unk=1, space=2,
                             eos=len(tokens) - 1, subword_size=len(tokens))
        fn, cache, out = la.make_score_fn(), la.init_cache(4, dev), []
        with torch.no_grad():
            for step in steps:
                row, cache = fn(torch.from_numpy(step).to(dev), 0, cache)
                out.append(row.cpu())
        rows[dev.type] = torch.stack(out)
    torch.testing.assert_close(rows["cuda"], rows["cpu"], atol=1e-5,
                               rtol=1e-5)
    cfg = ASRConfig(vocab_size=len(tokens), n_mels=40, use_specaug=False,
                    normalize="utterance_mvn", d_model=128, num_heads=2,
                    d_ff=256, num_encoder_layers=2, num_decoder_layers=1,
                    decoder_d_ff=256, dropout_rate=0.0)
    model = init_random_(ASRModel(cfg), torch.Generator().manual_seed(2))
    speech = (0.1 * rng.randn(2, 16000)).astype(np.float32)
    lens = np.array([16000, 9000])
    out = {}
    for dev in ("cpu", "cuda"):
        model.set_use_kernels(dev == "cuda")
        s2t = Speech2Text(model, device=dev, beam_size=3, max_steps=6,
                          ngram_scorer=ngram, ngram_weight=0.5)
        ts = Speech2TextTimeSync(model, beam_size=3, ngram_scorer=ngram,
                                 ngram_weight=0.5, device=dev)
        out[dev] = ([r.token_ids for r in s2t(speech, lens)],
                    [r.nbest[0][0] for r in ts(speech, lens, ["a", "b"])])
    assert out["cpu"] == out["cuda"]


@pytest.mark.gpu
def test_translation_clis_train_and_decode_on_the_card(cuda, tmp_path):
    """mt_train and mt_inference, st_train and st_inference for one epoch
    on toy corpora, on the card (their default device)."""
    from espnet_tpu_torch.bin import (mt_inference, mt_train, st_inference,
                                      st_train)
    from espnet_tpu_torch.data.synth import (generate_mt_corpus,
                                             generate_st_corpus)
    from espnet_tpu_torch.ops import ctc_lattice

    small = ["--run.max_epoch", "1", "--run.best_metric", "valid.loss.min",
             "--model.d_model", "128", "--model.num_heads", "2",
             "--model.d_ff", "256", "--model.num_encoder_layers", "2",
             "--model.num_decoder_layers", "1", "--model.decoder_d_ff",
             "256", "--data.batch_size", "4"]
    generate_mt_corpus(tmp_path / "mt", n_utts=8, max_words=3)
    generate_st_corpus(tmp_path / "st", n_utts=4, max_words=3)
    for fn in (tflash.flash_attention, trel.relpos_attention,
               ctc_lattice.ctc_alphas):
        fn.launches = 0
    for train, infer, data, extra in (
            (mt_train, mt_inference, "mt", []),
            (st_train, st_inference, "st", ["--model.n_mels", "40"])):
        train.main(small + extra + [
            "--data.train_dir", str(tmp_path / data), "--data.valid_dir",
            str(tmp_path / data), "--run.output_dir",
            str(tmp_path / f"{data}_exp")])
        infer.main(["--exp_dir", str(tmp_path / f"{data}_exp"), "--data_dir",
                    str(tmp_path / data), "--output_dir",
                    str(tmp_path / f"{data}_dec"), "--beam_size", "2",
                    "--max_steps", "8"])
        assert (tmp_path / f"{data}_dec" / "score_wer.txt").exists()
    for fn in (tflash.flash_attention, trel.relpos_attention,
               ctc_lattice.ctc_alphas):
        assert fn.launches > 0, fn.__name__


_SSL_SMALL = dict(hidden_size=64, num_layers=2, num_heads=2, ffn_size=128,
                  conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2),
                  num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def _waves(device, lengths, seed):
    rng = np.random.RandomState(seed)
    speech = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        speech[i, :n] = 0.1 * rng.randn(n)
    return (torch.from_numpy(speech).to(device),
            torch.tensor(lengths).to(device))


@pytest.mark.gpu
def test_ssl_frontend_conformer_takes_relpos_ffn_and_ctc_on_the_card(cuda):
    """input_type ssl with a frozen trunk into a 2-layer conformer (d 128,
    head dim 64): the rel-pos kernel once a layer, the pre-norm FFN twice,
    the CTC pair; the float32 loss equals the plain route's, and the trunk
    gets no gradient."""
    from espnet_tpu_torch.models.asr import ASRConfig, ASRModel, init_random_
    from espnet_tpu_torch.models.ssl import SSLConfig

    cfg = ASRConfig(vocab_size=40, input_type="ssl",
                    ssl=SSLConfig(**_SSL_SMALL), use_specaug=False,
                    normalize="utterance_mvn", d_model=128, num_heads=2,
                    d_ff=256, num_encoder_layers=2, num_decoder_layers=1,
                    decoder_d_ff=256, dropout_rate=0.0,
                    conformer_kernel_size=7)
    model = init_random_(ASRModel(cfg), torch.Generator().manual_seed(0))
    model = model.to(cuda).train()
    speech, lens = _waves(cuda, [32000, 20000, 9000], 10)
    text, tlen = _ragged_ids(np.random.RandomState(11), 3, 9, 40,
                             [9, 4, 1], cuda)
    args = (speech, lens, text, tlen)
    lk, lp, counts = _kernel_vs_plain_loss(model, args)
    assert counts == {"relpos_attention": 2, "prenorm_ffn": 4,
                      "ctc_alphas": 1}
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    model(*args)[0].backward()
    assert all(p.grad is None for p in model.ssl_frontend.upstream.parameters())
    assert model.ssl_frontend.layer_weights.grad is not None


@pytest.mark.gpu
def test_whisper_launches_nothing_and_its_step_matches_on_the_card(cuda):
    """Whisper's encoder and decoder run no kernel of the port; the
    decoder's cached score_step gives the teacher-forced log-probs."""
    from espnet_tpu_torch.models.asr import ASRConfig, ASRModel, init_random_
    from espnet_tpu_torch.models.ssl import WhisperConfig
    from espnet_tpu_torch.ops import launches

    wcfg = WhisperConfig(vocab_size=300, n_mels=80, d_model=128,
                         encoder_layers=2, decoder_layers=2, num_heads=2,
                         ffn_size=256)
    cfg = ASRConfig(vocab_size=300, encoder_type="whisper",
                    decoder_type="whisper", whisper=wcfg, ctc_weight=0.0,
                    normalize="none", use_specaug=False, dropout_rate=0.0)
    model = init_random_(ASRModel(cfg), torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    speech, lens = _waves(cuda, [48000, 30000], 12)
    text, tlen = _ragged_ids(np.random.RandomState(13), 2, 7, 300, [7, 7],
                             cuda)
    wrappers = launches.reset()
    with torch.no_grad():
        model(speech, lens, text, tlen)
        mem, mlen = model.encode(speech, lens)
        full = torch.log_softmax(model.decoder(text, tlen, mem, mlen), -1)
        cache = model.decoder_init_cache(2, 448, mem, mlen)
        steps = []
        for pos in range(7):
            lp, cache = model.decoder_score_step(text[:, pos], pos, mem,
                                                 mlen, cache)
            steps.append(lp)
    assert not any(fn.launches for fn in wrappers.values())
    torch.testing.assert_close(torch.stack(steps, 1), full, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.gpu
def test_hubert_takes_flash_and_prenorm_ffn_on_the_card(cuda):
    """A 2-layer HuBERT (d 128, head dim 64) over 600 frames: flash and the
    pre-norm FFN once a layer a forward, the FFN's backward once a layer;
    its float32 loss and gradient equal the plain route's."""
    from espnet_tpu_torch.models.asr import init_random_
    from espnet_tpu_torch.models.hubert import HubertConfig, HubertModel
    from espnet_tpu_torch.ops import launches

    cfg = HubertConfig(num_classes=20, d_model=128, num_heads=2, d_ff=256,
                       num_encoder_layers=2, dropout_rate=0.0)
    model = init_random_(HubertModel(cfg), torch.Generator().manual_seed(0))
    model = model.to(cuda).train()
    speech, lens = _waves(cuda, [76672, 40000, 12000], 14)
    labels = torch.from_numpy(np.random.RandomState(15).randint(
        0, 20, (3, 600))).to(cuda)
    args = (speech, lens, labels)
    lk, lp, counts = _kernel_vs_plain_loss(model, args)
    assert counts == {"flash_attention": 2, "prenorm_ffn": 2}
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    grads = {}
    for use in (True, False):
        model.set_use_kernels(use)
        wrappers = launches.reset()
        loss, _ = model(*args)
        grads[use] = torch.autograd.grad(loss, list(model.parameters()))
        if use:
            assert wrappers["prenorm_ffn_bwd"].launches == 2
    model.set_use_kernels(True)
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(*grads.values()))
    den = sum(float((b ** 2).sum()) for b in grads[False])
    assert (num / den) ** 0.5 < 1e-3


def _fastspeech2(cuda, dtype):
    """FastSpeech2 at its published width (384, 2 heads of 192, FFN 1536)
    with 1 + 1 layers, random weights."""
    from espnet_tpu_torch.configs import tts_config
    from espnet_tpu_torch.models.asr import init_random_
    from espnet_tpu_torch.models.tts.model import TTSModel

    cfg = tts_config(dtype, "fastspeech2", encoder_layers=1,
                     decoder_layers=1, max_frames=512)
    model = init_random_(TTSModel(cfg), torch.Generator().manual_seed(0))
    return cfg, model.to(cuda)


@pytest.mark.gpu
def test_fastspeech2_train_step_takes_flash_192_on_the_card(cuda):
    """One bf16 train step through make_train_step: flash at head dim 192
    and the pre-norm FFN at D=384, F=1536 once a layer, the FFN backward
    once a layer; finite, not skipped, parameters moved. The float32 loss
    with kernels equals the plain route's."""
    from espnet_tpu_torch.ops import launches
    from espnet_tpu_torch.train.optim import build_optimizer
    from espnet_tpu_torch.train.steps import TrainState, make_train_step

    cfg, model = _fastspeech2(cuda, torch.bfloat16)
    rng = np.random.RandomState(3)
    n, u = 2 * 16000, 30
    frames = n // 256 + 1
    dur = np.full((3, u), frames // u, np.int64)
    dur[:, 0] += frames - dur.sum(1)
    batch = {"text": torch.from_numpy(rng.randint(1, 15, (3, u))),
             "text_lengths": torch.tensor([u, u, u]),
             "speech": torch.from_numpy((0.1 * rng.randn(3, n)).astype(
                 np.float32)),
             "speech_lengths": torch.tensor([n, n, n]),
             "durations": torch.from_numpy(dur)}
    keys = tuple(batch)
    tx = build_optimizer("fused_adam", lr=1e-3, schedule="constant")
    step = make_train_step(model, tx, device=cuda, batch_keys=keys)
    state = TrainState.create(model, tx)
    before = state.params.clone()
    wrappers = launches.reset()
    state, stats = step(state, batch, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    assert counts == {"flash_attention": 2, "prenorm_ffn": 2,
                      "prenorm_ffn_bwd": 2}
    assert np.isfinite(float(stats["loss"])) and float(stats["skipped"]) == 0
    assert float((state.params - before).abs().max()) > 0

    _, m32 = _fastspeech2(cuda, torch.float32)
    args = tuple(batch[k].to(cuda) for k in keys)
    with torch.no_grad():
        lk, lp, counts = _kernel_vs_plain_loss(m32.eval(), args)
    assert counts == {"flash_attention": 2, "prenorm_ffn": 2}
    assert abs(lk - lp) <= 1e-4 * abs(lp)


@pytest.mark.gpu
def test_fastspeech2_synthesis_takes_flash_192_on_the_card(cuda):
    """Synthesis (the decoder over max_frames) and Griffin-Lim: flash and
    the pre-norm FFN once a layer; float32 mels with kernels within 1e-3
    of the plain route's, the same lengths."""
    from espnet_tpu_torch.ops import launches
    from espnet_tpu_torch.ops.griffin_lim import logmel_to_wav

    text = torch.from_numpy(np.random.RandomState(4).randint(1, 15, (2, 40)))
    lens = torch.tensor([40, 23])
    cfg, model = _fastspeech2(cuda, torch.float32)
    wrappers = launches.reset()
    mel, mlen = model.inference(text.to(cuda), lens.to(cuda))
    torch.cuda.synchronize()
    assert {k: fn.launches for k, fn in wrappers.items() if fn.launches} \
        == {"flash_attention": 2, "prenorm_ffn": 2}
    model.set_use_kernels(False)
    want, wlen = model.inference(text.to(cuda), lens.to(cuda))
    assert torch.equal(mlen, wlen) and mel.shape == (2, 512, 80)
    assert float((mel - want).abs().max()) <= 1e-3
    wav = logmel_to_wav(mel, cfg.fs, cfg.n_fft, cfg.hop_length, None,
                        cfg.n_mels, 4)
    assert wav.shape == (2, 511 * cfg.hop_length)
    assert torch.isfinite(wav).all()


# --- the GAN slice: VITS and JETS ------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", [(120, 96), (120, 128), (626, 128)])
def test_flash_at_vits_and_jets_shapes_matches_plain(cuda, dtype, t, d):
    """VITS's text encoder (head dim 96, padded to 128) and JETS's stacks
    (head dim 128; its decoder over 626 frames), forward and gradient."""
    args = _flash_args(cuda, dtype, b=3, h=2, t=t, d=d,
                       lengths=(t, t // 2, 1))
    gout = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
        d)).to(cuda, dtype)
    got_y, got = _grads(tflash.flash_attention, args, range(3), gout)
    want_y, want = _grads(tflash.flash_attention_plain, args, range(3), gout)
    torch.testing.assert_close(got_y.float(), want_y.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    for name, g, w in zip("qkv", got, want):
        _assert_grad_close(name, g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("u", [120, 200])
def test_ctc_pair_on_the_jets_forward_sum_lattice(cuda, u):
    """The forward-sum loss's lattice (weak blank prepended, labels 1..U:
    S = 241, a warp per utterance; S = 401, a block per utterance), and the
    loss and its gradient with kernels against plain."""
    from espnet_tpu_torch.models.tts.jets import forward_sum_loss
    from espnet_tpu_torch.ops import ctc_lattice as tlat

    g = torch.Generator().manual_seed(u)
    att = torch.log_softmax(torch.randn(3, 300, u, generator=g), -1).to(cuda)
    tlens = torch.tensor([u, u - 7, 1], device=cuda)
    flens = torch.tensor([300, 290, 3], device=cuda)
    before = (tlat.ctc_alphas.launches, tlat.ctc_gamma.launches)
    leaves = [att.clone().requires_grad_(True) for _ in range(2)]
    losses = [forward_sum_loss(x, tlens, flens, use_kernels=k)
              for x, k in zip(leaves, (True, False))]
    for loss in losses:
        loss.backward()
    torch.cuda.synchronize()
    assert (tlat.ctc_alphas.launches, tlat.ctc_gamma.launches) == (
        before[0] + 1, before[1] + 1)
    assert tlat.design(2 * u + 1) == ("warp per utterance" if u < 128
                                      else "block per utterance")
    torch.testing.assert_close(losses[0], losses[1], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(leaves[0].grad, leaves[1].grad, atol=1e-4,
                               rtol=1e-4)


def _gan_step(cuda, family):
    """One float32 GAN step of a VITS (192 channels: flash at head dim 96)
    or JETS (adim 256: flash at 128, the pre-norm FFN at D=256, F=1024) of
    one layer a stack, a small decoder and discriminator, on 2 x 1 s;
    returns (stats, launches)."""
    from espnet_tpu_torch.models.asr import init_random_
    from espnet_tpu_torch.models.tts.jets import JETSConfig, JETSGenerator
    from espnet_tpu_torch.models.tts.vits import VITSConfig, VITSGenerator
    from espnet_tpu_torch.models.tts.vocoders import (
        ParallelWaveGANDiscriminator)
    from espnet_tpu_torch.ops import launches
    from espnet_tpu_torch.tasks.jets import JETSDataConfig, jets_features
    from espnet_tpu_torch.tasks.vits import linear_spectrogram
    from espnet_tpu_torch.tasks.vocoder import VocoderOptimConfig, gan_state
    from espnet_tpu_torch.train import gan_steps

    small = dict(vocab_size=20, decoder_channels=32, segment_frames=8)
    if family == "vits":
        gen = VITSGenerator(VITSConfig(text_layers=1, posterior_layers=2,
                                       flows=1, **small))
    else:
        gen = JETSGenerator(JETSConfig(encoder_layers=1, decoder_layers=1,
                                       **small))
    disc = ParallelWaveGANDiscriminator(layers=3, channels=8)
    state = gan_state(gen, disc, VocoderOptimConfig(), 0, cuda)
    init_random_(gen, torch.Generator().manual_seed(1))
    rng = np.random.RandomState(9)
    n = 16000 - 16000 % 256
    wav = torch.from_numpy((0.1 * rng.randn(2, n)).astype(np.float32)).to(
        cuda)
    wlens = torch.tensor([n, n - 2560], device=cuda)
    text = torch.from_numpy(rng.randint(1, 19, (2, 30))).to(cuda)
    tlens = torch.tensor([30, 21], device=cuda)
    wrappers = launches.reset()
    if family == "vits":
        spec = linear_spectrogram(wav, 1024, 256)
        stats = gan_steps.make_vits_train_step(hop_length=256, upsample=256)(
            state, text, tlens, spec, wlens // 256 + 1, wav)
    else:
        feats, flens, pitch, energy = jets_features(wav, wlens,
                                                    JETSDataConfig())
        stats = gan_steps.make_jets_train_step(hop_length=256)(
            state, text, tlens, feats, flens, pitch, energy, wav)
    torch.cuda.synchronize()
    return stats, {k: fn.launches for k, fn in wrappers.items()
                   if fn.launches}


@pytest.mark.gpu
@pytest.mark.parametrize("family,want", [
    ("vits", {"flash_attention": 1}),
    ("jets", {"flash_attention": 2, "prenorm_ffn": 2, "prenorm_ffn_bwd": 2,
              "ctc_alphas": 1, "ctc_gamma": 1})])
def test_gan_tts_step_takes_its_kernels_on_the_card(cuda, family, want):
    stats, counts = _gan_step(cuda, family)
    assert counts == want
    assert all(np.isfinite(float(v)) for v in stats.values())


# --- the enhancement slice: the conformer and transformer separators -------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,lengths", [(2, 3199, (3199, 1600)),
                                         (1, 6399, (6399,))])
def test_relpos_at_the_separator_lengths_matches_plain(cuda, dtype, b, t,
                                                       lengths):
    """The conformer separator's T'=3199 (2 s chunks, forward and
    backward) and serve's 6399 (a 4 s mixture, forward)."""
    args = _relpos_args(cuda, dtype, b=b, t=t, lengths=lengths)
    if t > 4000:
        with torch.no_grad():
            got = trel.relpos_attention(*args)
            want = trel.relpos_attention_plain(*args)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        return
    gout = torch.randn(args[0].shape, generator=torch.Generator()
                       .manual_seed(t)).to(cuda, dtype)
    got_y, got = _grads(trel.relpos_attention, args, range(6), gout)
    want_y, want = _grads(trel.relpos_attention_plain, args, range(6), gout)
    torch.testing.assert_close(got_y.float(), want_y.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    for name, g, w in zip(("q", "k", "v", "p", "u", "vb"), got, want):
        _assert_grad_close(name, g, w, dtype)


def _enh_step(cuda, separator, conv_module=False):
    """A float32 forward and backward of an EnhancementModel (conv encoder
    256/20/10, one layer at d 256, F 1024, k 15) on 2 x 0.5 s, kernels and
    plain on the same parameters and dropout draws: (losses, gradients,
    the kernel route's launches). The masks are sigmoids: the default
    ReLU's gradient jumps where a mask logit lies within rounding of 0:
    on the card two of these 818,176 logits fell on the other side of 0
    in the other route (8.8e-7 against -1.7e-7), which moved every
    gradient upstream of them by ~1%, the rest agreeing to 4.4e-6."""
    from espnet_tpu_torch.models.asr import init_random_
    from espnet_tpu_torch.models.conformer import ConformerBlock
    from espnet_tpu_torch.models.enh import EnhancementModel, EnhConfig
    from espnet_tpu_torch.ops import launches

    model = EnhancementModel(EnhConfig(separator_type=separator,
                                       trans_layers=1, nonlinear="sigmoid"))
    init_random_(model, torch.Generator().manual_seed(3))
    model.to(cuda).train()
    for block in model.modules():
        if isinstance(block, ConformerBlock):
            block.fused_conv = conv_module
    rng = np.random.RandomState(4)
    mix = torch.from_numpy((0.3 * rng.randn(2, 8000)).astype(np.float32))
    ref = torch.from_numpy((0.3 * rng.randn(2, 8000, 2)).astype(np.float32))
    lens = torch.tensor([8000, 6000])
    out = []
    for route in (True, False):
        model.set_use_kernels(route)
        model.zero_grad(set_to_none=True)
        wrappers = launches.reset()
        loss, _ = model(mix.to(cuda), lens.to(cuda), ref.to(cuda),
                        generator=torch.Generator(device=cuda).manual_seed(5))
        loss.backward()
        torch.cuda.synchronize()
        out.append((loss.detach(), {n: p.grad.clone() for n, p in
                                    model.named_parameters()},
                    {k: w.launches for k, w in wrappers.items()
                     if w.launches}))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("separator,conv_module,want", [
    ("conformer", False, {"relpos_attention": 1, "relpos_attention_bwd": 1,
                          "prenorm_ffn": 2, "prenorm_ffn_bwd": 2}),
    ("conformer", True, {"relpos_attention": 1, "relpos_attention_bwd": 1,
                         "prenorm_ffn": 2, "prenorm_ffn_bwd": 2,
                         "conv_module": 1, "conv_module_bwd": 1}),
    ("transformer", False, {"flash_attention": 1, "prenorm_ffn": 1,
                            "prenorm_ffn_bwd": 1})])
def test_enh_separator_step_takes_its_kernels_on_the_card(
        cuda, separator, conv_module, want):
    """The loss to 1e-4; every gradient's error (L2) to 1e-3 of its own
    norm, but the key projection's bias: its gradient is exactly 0
    (softmax is invariant to a shift along the keys), so both routes give
    rounding noise, held to 1e-4 of the model's largest gradient entry."""
    (lk, gk, ck), (lp, gp, cp) = _enh_step(cuda, separator, conv_module)
    assert ck == want and cp == {}
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    top = max(float(w.abs().max()) for w in gp.values())
    for name, w in gp.items():
        g = gk[name]
        if name.endswith("self_attn.k_proj.bias"):
            tiny = max(float(g.abs().max()), float(w.abs().max()))
            assert tiny <= 1e-4 * top, (name, tiny, top)
            continue
        err = float((g - w).double().norm() / w.double().norm())
        assert err <= 1e-3, (name, err)
