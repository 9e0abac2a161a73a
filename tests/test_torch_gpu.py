"""Each CUDA kernel of the port against its plain PyTorch version, on the
card only (the kernels have no CPU mode; here every test skips).

This file imports no JAX, so it also runs on the card's machine, which has
none: `python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`.
"""

import numpy as np
import pytest
import torch

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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation,scale", [("swish", 0.5), ("relu", 1.0)])
def test_prenorm_ffn_kernel_matches_plain(cuda, dtype, activation, scale):
    args = _ffn_args(cuda, dtype)
    kw = dict(activation=activation, residual_scale=scale)
    before = tffn.prenorm_ffn.launches
    got = tffn.prenorm_ffn(*args, **kw)
    torch.cuda.synchronize()
    assert tffn.prenorm_ffn.launches == before + 1
    want = tffn.prenorm_ffn_plain(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


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
                                 (65, 96)])
def test_relpos_backward_kernels_match_plain(cuda, dtype, t, d):
    """Head dims 48 and 96 run zero-padded to the kernels' 64 and 128."""
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,drop,d", [(333, 0.0, 256), (300, 0.1, 256),
                                      (600, 0.1, 256), (300, 0.1, 512),
                                      (300, 0.1, 128), (333, 0.1, 384)])
def test_prenorm_ffn_dropout_and_backward_match_plain(cuda, dtype, m, drop,
                                                      d):
    args = _ffn_args(cuda, dtype, m=m, d=d)
    kw = dict(activation="swish", residual_scale=0.5, drop_rate=drop,
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


def _ctc_case(device, b=5, t=50, u=7, v=11, seed=0):
    from espnet_tpu_torch.ops import ctc as tctc

    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(b, t, v, generator=g)
    labels = torch.randint(1, v, (b, u), generator=g)
    labels[1, 1] = labels[1, 0]  # a repeat
    in_lens = torch.tensor([t, t - 3, 2, t, 9][:b])  # utt 2: infeasible
    lab_lens = torch.tensor([u, u - 2, u, 0, 3][:b])  # utt 3: U = 0
    ext = tctc.extended_labels(labels)
    lse = torch.logsumexp(logits, -1)
    emit = tctc._emissions(logits, ext, lse)
    skip = tctc.transition_mask(ext)
    return [x.to(device) for x in (logits, labels, in_lens, lab_lens, emit,
                                   skip)]


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,drop,activation,d", [
    (333, 0.0, "swish", 256), (300, 0.1, "swish", 256),
    (600, 0.1, "relu", 256), (300, 0.1, "swish", 512),
    (300, 0.1, "relu", 128), (333, 0.1, "swish", 384)])
def test_fused_ffn_kernels_match_plain(cuda, dtype, m, drop, activation, d):
    x, _, _, w1, b1, w2, b2 = _ffn_args(cuda, dtype, m=m, d=d)
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
                                 (469, 64), (65, 48), (200, 96)])
def test_flash_kernel_and_its_gradient_match_plain(cuda, dtype, t, d):
    """Ragged keys, one utterance with every key masked (the uniform
    average of v); the backward recomputes through the plain version. Head
    dims 48 and 96 run zero-padded to the kernel's 64 and 128."""
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
def test_kernels_raise_for_shapes_the_gate_passes_but_they_lack(cuda):
    """Head dims past 128 and d_model past 512 pass the JAX package's gates
    but not the kernels: on the card they raise, never run plain."""
    args = _relpos_args(cuda, torch.float32, t=20, d=136, lengths=(20, 9, 0))
    assert trel.kernel_takes(136)
    with pytest.raises(ValueError, match="up to 128"):
        trel.relpos_attention(*args)
    fargs = _flash_args(cuda, torch.float32, t=20, d=136,
                        lengths=(20, 9, 0))
    with pytest.raises(ValueError, match="up to 128"):
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
