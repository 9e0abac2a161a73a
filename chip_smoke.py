#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a CUDA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (found through CUDA_HOME, torch's CUDA_HOME or
PATH) and the repository checkout; imports espnet_tpu_torch, torch, numpy
and the standard library only (no JAX). Phases, each printing lines with
the elapsed seconds, and raising on failure (exit code other than 0):

1. device: the card's name and power limit from nvidia-smi;
2. build: nvcc compiles every espnet_tpu_torch/csrc/*.cu into one library
   (prints the ptxas register / shared-memory lines);
3. kernels: each kernel against its plain PyTorch version, timed with CUDA
   events beside the plain version, the bound (the larger of operations
   over peak and bytes over 3.35 TB/s) and, where one PyTorch call computes
   the same function, that call: the forward kernels at the serve phase's
   shapes and the bench's decode geometry (B=8, T=469 / M=3000), then all
   nine kernels at the training shapes (rel-pos forward and backward at
   B=64, H=4, T=469, D=64; the pre-norm FFN forward with dropout 0.1 and
   its backward at M=64*469, F=2048; the FFN of `fused_ffn` forward and
   backward at the E-Branchformer's M=64*469, F=1024, and recorded beside
   it at the decoder's M=64*41, F=2048; flash attention forward at the
   transformer's B=64, H=4, T=469, D=64 with
   torch.nn.functional.scaled_dot_product_attention as a yardstick; the CTC
   lattice pair at B=64, T=469, S=81, with torch.nn.functional.ctc_loss as a
   second oracle and yardstick), in float32 and bfloat16;
4. for each of the three configurations at full width and depth (random
   weights from a seed; `espnet_tpu_torch.configs`): the bench conformer,
   the `transformer` (ESPnet's AISHELL-1 transformer widths) and the
   `e_branchformer` (ESPnet's LibriSpeech-100 E-Branchformer widths), each
   with a 6-layer decoder:
   a. serve: 4 requests of 4, 6, 9 and 12 s through Speech2Text with beam
      10; the launch counters must show the exact kernel launches of the
      one encode call and nothing else, and the float32 encoder output must
      match the plain versions';
   b. train parity: one float32 forward and backward on those 4 utterances
      (dropout and SpecAug off, TF32 off) with the kernels and with their
      plain versions: same loss, same gradients;
   c. train: the bench's training run (B=64 x 15 s, 40 labels, bf16,
      dropout 0.1, SpecAug on, fused_adam with warmuplr): 1 warm-up step
      and 3 timed steps through make_train_step; finite losses, no skipped
      step, moved parameters and the exact kernel launches per step;
5. gates: conformers of d_model 144 (head dim 36: the JAX package's gates
   send every kernel call to the plain versions), 384 (head dim 96, padded
   to the attention kernels' 128; the FFN kernels at D=384) and 512 (head
   dim 128) serve and take a train step, each kernel running exactly where
   its shape gate lets it (plain versions elsewhere);
6. a `{"kernels": [...]}` JSON line (training shapes, bfloat16; launches
   from the 3 timed train steps of the configuration whose path holds the
   kernel: the conformer's, the transformer's for flash attention, the
   E-Branchformer's for `fused_ffn`);
7. last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor / fp32 cores
# float32 encoder output, kernels vs plain versions, 12 layers at full width
ENCODER_FP32_TOL = 1e-3
TOLERANCE = {  # (atol, rtol) of kernel vs plain
    "float32": (1e-4, 1e-4),
    "bfloat16": (3e-2, 1e-2),
}
# gradients, kernel vs plain, relative L2 error per tensor (float32: sums in
# another order; bf16: operands and outputs round to 8 bits)
GRAD_REL_L2 = {"float32": 1e-4, "bfloat16": 2e-2}
# CTC lattice (float32 log space, |alpha| up to ~5e3 after 469 frames; the
# card's expf/logf round differently from PyTorch's): (atol, rtol)
CTC_TOLERANCE = (1e-3, 1e-5)
# the loss and its logits gradient against torch's own float32 ctc_loss: the
# log-space sums reach ~4e3 over 469 frames, where one float32 ulp is
# 2.4e-4, and that rounding becomes the occupancies' relative error (in
# torch's computation as much as in the port's)
CTC_LOSS_RTOL, CTC_GRAD_ATOL = 1e-5, 5e-3
# the lattice's float32 vector work per state and frame: 3 exp, 1 log,
# 2 max, 3 subtractions, 3 additions (log-add-exp of three and the emission)
CTC_OPS_PER_STATE = 12
# float32 train step of the full-width model, kernels vs plain versions
TRAIN_FP32_LOSS_RTOL = 1e-5
TRAIN_FP32_GRAD_REL_L2 = 1e-3
TRAIN_GRAD_FLOOR = 1e-3
# the bench's training geometry (bench.py): B utterances of 15 s, 40 labels
TRAIN_BATCH, TRAIN_SECONDS, TRAIN_LABELS = 64, 15.0, 40
TRAIN_TIMED_STEPS = 3

_T0 = time.perf_counter()


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.2f}s] {phase}: {msg}", flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    log("device", f"{name}, {torch.cuda.device_count()} card(s); "
        f"nvidia-smi: {smi}")
    # float32 products in full float32, so the float32 checks mean it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build():
    from espnet_tpu_torch.ops.cuda_build import build_library, kernel_library

    t = time.perf_counter()
    path, output = build_library()
    kernel_library()
    for line in output.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            print("  ptxas " + line.split("ptxas info    :")[-1].strip())
    log("build", f"{path} in {time.perf_counter() - t:.1f}s")


def time_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(torch, name, dtype_name, got, want):
    atol, rtol = TOLERANCE[dtype_name]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name} {dtype_name}: kernel output not finite")
    err = (got - want).abs()
    max_err = float(err.max())
    worst = float((err - rtol * want.abs()).max())
    ok = worst <= atol
    return max_err, ok, f"max |err| {max_err:.3e} (atol {atol}, rtol {rtol})"


def relpos_case(torch, b, t, dtype, lengths, seed):
    from espnet_tpu_torch.ops.relpos_attention import NEG

    g = torch.Generator(device="cpu").manual_seed(seed)
    h, d = 4, 64
    mk = lambda *s: torch.randn(*s, generator=g).to("cuda", dtype)  # noqa: E731
    q, k, v = mk(b, h, t, d), mk(b, h, t, d), mk(b, h, t, d)
    p = mk(h, 2 * t - 1, d)
    u = (0.1 * torch.randn(h, d, generator=g)).cuda()
    vb = (0.1 * torch.randn(h, d, generator=g)).cuda()
    valid = torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
    bias = torch.where(valid, 0.0, 2 * NEG).float()[:, None, None, :].cuda()
    args = (q, k, v, p, u, vb, bias)
    esize = q.element_size()
    flops = 6.0 * b * h * t * t * d
    nbytes = (4 * b * h * t * d + h * (2 * t - 1) * d) * esize \
        + b * t * 4 + 2 * h * d * 4
    return args, flops, nbytes


def ffn_case(torch, m, dtype, seed, d=256, f=2048):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(m, d, generator=g).to("cuda", dtype)
    lns = (1 + 0.1 * torch.randn(d, generator=g)).cuda()
    lnb = (0.1 * torch.randn(d, generator=g)).cuda()
    w1 = (torch.randn(d, f, generator=g) / d ** 0.5).to("cuda", dtype)
    b1 = (0.1 * torch.randn(f, generator=g)).cuda()
    w2 = (torch.randn(f, d, generator=g) / f ** 0.5).to("cuda", dtype)
    b2 = (0.1 * torch.randn(d, generator=g)).cuda()
    esize = x.element_size()
    flops = 4.0 * m * d * f
    nbytes = (2 * m * d + 2 * d * f) * esize + (3 * d + f) * 4
    return (x, lns, lnb, w1, b1, w2, b2), flops, nbytes


def bound(flops, nbytes, peak_flops):
    """(least time in ms, what bounds it) for the work on an H100."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def report(name, label, dtype_name, how, ok, ms, plain_ms, bound_ms,
           bound_by, max_err, library_ms=None):
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    log("kernels", f"{name} {label} {dtype_name}: {how}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms{lib}, bound {bound_ms:.4f} ms ({bound_by})"
        f"{'' if ok else '  <-- OUT OF TOLERANCE'}")
    if not ok:
        raise AssertionError(f"{name} {label} {dtype_name} disagrees with "
                             f"its plain version: {how}")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_kernel(torch, name, kernel, plain, args, flops, nbytes, dtype_name,
                 label, kwargs=None, iters=20):
    kwargs = kwargs or {}
    got = kernel(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    max_err, ok, how = compare(torch, name, dtype_name, got, want)
    ms = time_ms(torch, lambda: kernel(*args, **kwargs), iters)
    plain_ms = time_ms(torch, lambda: plain(*args, **kwargs), iters)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_FLOPS[dtype_name])
    return report(name, label, dtype_name, how, ok, ms, plain_ms, bound_ms,
                  bound_by, max_err)


def check_grads(torch, name, dtype_name, label, kernel, plain, args, n_diff,
                gout, flops, nbytes, iters=10):
    """Backward of `kernel` (the CUDA backward kernels through autograd)
    against autograd through `plain`, on the same inputs and cotangent."""
    def graph(fn):
        leaves = [a.detach().clone().requires_grad_(i < n_diff)
                  for i, a in enumerate(args)]
        return fn(*leaves), leaves[:n_diff]

    out_k, in_k = graph(kernel)
    out_p, in_p = graph(plain)

    def grads(out, inputs):
        return torch.autograd.grad(out, inputs, gout, retain_graph=True)

    got, want = grads(out_k, in_k), grads(out_p, in_p)
    torch.cuda.synchronize()
    worst, max_err = 0.0, 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"{name} {label}: gradient not finite")
        gd, wd = g.double(), w.double()
        worst = max(worst, float((gd - wd).norm() / wd.norm().clamp(
            min=1e-4 * wd.numel() ** 0.5)))
        max_err = max(max_err, float((gd - wd).abs().max()))
    limit = GRAD_REL_L2[dtype_name]
    how = (f"worst relative L2 {worst:.3e} (limit {limit}), max |err| "
           f"{max_err:.3e}")
    ms = time_ms(torch, lambda: grads(out_k, in_k), iters)
    plain_ms = time_ms(torch, lambda: grads(out_p, in_p), iters)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_FLOPS[dtype_name])
    return report(name, label, dtype_name, how, worst <= limit, ms, plain_ms,
                  bound_ms, bound_by, max_err)


def flash_case(torch, b, t, dtype, lengths, seed, h=4, d=64):
    """q, k, v and a key-padding bias; the operations count the valid keys
    only (a masked key's weight is exactly 0)."""
    from espnet_tpu_torch.ops.relpos_attention import NEG

    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to("cuda", dtype)  # noqa: E731
    q, k, v = mk(b, h, t, d), mk(b, h, t, d), mk(b, h, t, d)
    valid = torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
    bias = torch.where(valid, 0.0, 2 * NEG).float()[:, None, None, :].cuda()
    flops = 4.0 * h * t * d * float(sum(lengths))
    nbytes = 4 * b * h * t * d * q.element_size() + b * t * 4
    return (q, k, v, bias), flops, nbytes, valid[:, None, None, :].cuda()


def fused_ffn_case(torch, m, dtype, seed, d=256, f=1024):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(m, d, generator=g).to("cuda", dtype)
    w1 = (torch.randn(d, f, generator=g) / d ** 0.5).to("cuda", dtype)
    b1 = (0.1 * torch.randn(f, generator=g)).cuda()
    w2 = (torch.randn(f, d, generator=g) / f ** 0.5).to("cuda", dtype)
    b2 = (0.1 * torch.randn(d, generator=g)).cuda()
    es = x.element_size()
    fwd = (4.0 * m * d * f, (2 * m * d + 2 * d * f) * es + (d + f) * 4)
    bwd = (10.0 * m * d * f, (3 * m * d + 4 * d * f) * es + (2 * f + d) * 4)
    return (x, w1, b1, w2, b2), fwd, bwd


def phase_kernels(torch, serve_b, serve_t):
    """The forward kernels against their plain versions at the serve and
    decode shapes."""
    from espnet_tpu_torch.ops.ffn import fused_ffn, fused_ffn_plain
    from espnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_plain)
    from espnet_tpu_torch.ops.prenorm_ffn import (prenorm_ffn,
                                                  prenorm_ffn_plain)
    from espnet_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_plain)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for label, b, t in (("serve", serve_b, serve_t), ("bench", 8, 469)):
            # ragged key lengths, the longest = t
            lengths = [max(1, t - (t * i) // (2 * b)) for i in range(b)]
            args, flops, nbytes = relpos_case(torch, b, t, dtype, lengths, 0)
            with torch.no_grad():
                check_kernel(torch, "relpos_attention", relpos_attention,
                             relpos_attention_plain, args, flops, nbytes, dn,
                             f"{label} B={b} H=4 T={t} D=64")
        for label, m in (("serve", serve_b * serve_t), ("bench", 3000)):
            args, flops, nbytes = ffn_case(torch, m, dtype, 1)
            for act, scale in (("swish", 0.5), ("relu", 1.0)):
                with torch.no_grad():
                    check_kernel(
                        torch, "prenorm_ffn", prenorm_ffn, prenorm_ffn_plain,
                        args, flops, nbytes, dn,
                        f"{label} M={m} D=256 F=2048 {act} s={scale}",
                        {"activation": act, "residual_scale": scale})
        # the transformer's and E-Branchformer's encoder at the serve shapes
        lengths = [max(1, serve_t - (serve_t * i) // (2 * serve_b))
                   for i in range(serve_b)]
        args, flops, nbytes, _ = flash_case(torch, serve_b, serve_t, dtype,
                                            lengths, 7)
        with torch.no_grad():
            check_kernel(torch, "flash_attention", flash_attention,
                         flash_attention_plain, args, flops, nbytes, dn,
                         f"serve B={serve_b} H=4 T={serve_t} D=64")
        m = serve_b * serve_t
        args, (flops, nbytes), _ = fused_ffn_case(torch, m, dtype, 8)
        with torch.no_grad():
            check_kernel(torch, "fused_ffn", fused_ffn, fused_ffn_plain,
                         args, flops, nbytes, dn,
                         f"serve M={m} D=256 F=1024 swish",
                         {"activation": "swish"})


def ctc_case(torch, np, b, t, u, v, seed):
    """Logits (B, T, V) float32, labels (B, U) and lengths on the card, with
    the lattice inputs the loss builds from them."""
    from espnet_tpu_torch.ops import ctc as tctc

    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.randn(b, t, v).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.randint(1, v - 1, (b, u))).cuda()
    in_lens = torch.tensor([t - (i % 7) * 9 for i in range(b)]).cuda()
    lab_lens = torch.tensor([u - (i % 5) for i in range(b)]).cuda()
    ext = tctc.extended_labels(labels)
    emit = tctc._emissions(logits, ext, torch.logsumexp(logits, -1))
    return logits, labels, in_lens, lab_lens, emit, tctc.transition_mask(ext)


def phase_train_kernels(torch, np):
    """All six kernels at the training shapes, float32 and bfloat16 (the CTC
    lattice is float32 only). Returns the bfloat16 (CTC: float32) results by
    kernel name."""
    import torch.nn.functional as F

    from espnet_tpu_torch.ops import ctc as tctc
    from espnet_tpu_torch.ops import ctc_lattice as tlat
    from espnet_tpu_torch.ops.ffn import fused_ffn, fused_ffn_plain
    from espnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_plain)
    from espnet_tpu_torch.ops.prenorm_ffn import (prenorm_ffn,
                                                  prenorm_ffn_plain)
    from espnet_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_plain)

    b, t, h, d = TRAIN_BATCH, 469, 4, 64
    m, f = b * t, 2048
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        es = 4 if dtype == torch.float32 else 2
        lengths = [t - (i % 9) * 7 for i in range(b)]
        args, flops, nbytes = relpos_case(torch, b, t, dtype, lengths, 2)
        label = f"train B={b} H={h} T={t} D={d}"
        with torch.no_grad():
            r = check_kernel(torch, "relpos_attention", relpos_attention,
                             relpos_attention_plain, args, flops, nbytes, dn,
                             label, iters=10)
        gout = torch.randn(b, h, t, d, generator=torch.Generator().manual_seed(
            3)).to("cuda", dtype)
        rb = check_grads(
            torch, "relpos_attention_bwd", dn, label, relpos_attention,
            relpos_attention_plain, args, 6, gout, 16.0 * b * h * t * t * d,
            (7 * b * h * t * d + 2 * h * (2 * t - 1) * d) * es + b * t * 4
            + b * h * t * 12)
        args, flops, nbytes = ffn_case(torch, m, dtype, 4)
        kw = {"activation": "swish", "residual_scale": 0.5,
              "drop_rate": 0.1, "seeds": (20240601, -77)}
        label = f"train M={m} D=256 F={f} swish s=0.5 dropout 0.1"
        with torch.no_grad():
            rf = check_kernel(torch, "prenorm_ffn", prenorm_ffn,
                              prenorm_ffn_plain, args, flops, nbytes, dn,
                              label, kw, iters=5)
        gout = torch.randn(m, 256, generator=torch.Generator().manual_seed(
            5)).to("cuda", dtype)
        rfb = check_grads(
            torch, "prenorm_ffn_bwd", dn, label,
            lambda *a: prenorm_ffn(*a, **kw),
            lambda *a: prenorm_ffn_plain(*a, **kw), args, 7, gout,
            10.0 * m * 256 * f, (3 * m * 256 + 4 * 256 * f) * es
            + (4 * 256 + 2 * f) * 4, iters=5)
        # fused_ffn: the E-Branchformer's macaron FFN rows, then the
        # decoder's training rows (recorded for a later routing decision)
        for role, rows, f2, act in (("e_branchformer", m, 1024, "swish"),
                                    ("decoder", b * (TRAIN_LABELS + 1), 2048,
                                     "relu")):
            args, (flops, nbytes), (bflops, bbytes) = fused_ffn_case(
                torch, rows, dtype, 9, f=f2)
            kw = {"activation": act, "drop_rate": 0.1, "seed": 314159}
            label = f"train {role} M={rows} D=256 F={f2} {act} dropout 0.1"
            with torch.no_grad():
                ff = check_kernel(torch, "fused_ffn", fused_ffn,
                                  fused_ffn_plain, args, flops, nbytes, dn,
                                  label, kw, iters=5)
            gout = torch.randn(rows, 256, generator=torch.Generator()
                               .manual_seed(10)).to("cuda", dtype)
            ffb = check_grads(
                torch, "fused_ffn_bwd", dn, label,
                lambda *a: fused_ffn(*a, **kw),
                lambda *a: fused_ffn_plain(*a, **kw), args, 5, gout, bflops,
                bbytes, iters=5)
            if role == "e_branchformer" and dtype == torch.bfloat16:
                main.update({"fused_ffn": ff, "fused_ffn_bwd": ffb})
        # flash attention: the transformer's encoder, ragged keys
        lengths = [t - (i % 9) * 7 for i in range(b)]
        args, flops, nbytes, valid = flash_case(torch, b, t, dtype, lengths,
                                                11)
        label = f"train B={b} H={h} T={t} D={d}"
        with torch.no_grad():
            fa = check_kernel(torch, "flash_attention", flash_attention,
                              flash_attention_plain, args, flops, nbytes, dn,
                              label, iters=10)
            fa["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    *args[:3], attn_mask=valid), 10)
        log("kernels", f"flash_attention {label} {dn}: library "
            f"(scaled_dot_product_attention, boolean key mask) "
            f"{fa['library_ms']:.4f} ms")
        if dtype == torch.bfloat16:
            main.update({"relpos_attention": r, "relpos_attention_bwd": rb,
                         "prenorm_ffn": rf, "prenorm_ffn_bwd": rfb,
                         "flash_attention": fa})

    # the CTC lattice pair, float32, S = 2*40+1
    u, v = TRAIN_LABELS, 5000
    logits, labels, in_lens, lab_lens, emit, skip = ctc_case(
        torch, np, b, t, u, v, 6)
    s = 2 * u + 1
    label = f"train B={b} T={t} S={s}"
    live = float(in_lens.sum()) * s  # frames past a length are frozen
    atol, rtol = CTC_TOLERANCE

    def ctc_compare(name, got, want):
        err = (got - want).abs()
        max_err = float(err[torch.isfinite(err)].max())
        ok = bool(torch.isfinite(got).all()) and float(
            (err - rtol * want.abs()).max()) <= atol
        return max_err, ok, f"max |err| {max_err:.3e} (atol {atol}, rtol {rtol})"

    alphas, last = tlat.ctc_alphas(emit, skip, in_lens)
    pa, pl = tlat.ctc_alphas_plain(emit, skip, in_lens)
    gamma = tlat.ctc_gamma(emit, skip, in_lens, lab_lens, alphas)
    pg = tlat.ctc_gamma_plain(emit, skip, in_lens, lab_lens, pa)
    torch.cuda.synchronize()
    lp = torch.log_softmax(logits, -1).transpose(0, 1).detach() \
        .requires_grad_(True)
    lib_loss = F.ctc_loss(lp, labels, in_lens, lab_lens, blank=0,
                          reduction="sum", zero_infinity=True)
    lib_fwd_ms = time_ms(torch, lambda: F.ctc_loss(
        lp, labels, in_lens, lab_lens, blank=0, reduction="sum",
        zero_infinity=True), 10)
    lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        lib_loss, lp, retain_graph=True), 10)
    ab, gb = s * b, s * b  # bytes of the (B, S) skip mask and terminal set
    a_err, a_ok, a_how = ctc_compare("ctc_alphas", alphas, pa)
    a_err2, a_ok2, _ = ctc_compare("ctc_alphas", last, pl)
    ms = time_ms(torch, lambda: tlat.ctc_alphas(emit, skip, in_lens), 10)
    plain_ms = time_ms(torch, lambda: tlat.ctc_alphas_plain(
        emit, skip, in_lens), 3)
    bound_ms, bound_by = bound(CTC_OPS_PER_STATE * live, 2 * t * b * s * 4
                               + ab + b * 8 + b * s * 4, PEAK_FLOPS["float32"])
    main["ctc_alphas"] = report(
        "ctc_alphas", label, "float32", a_how, a_ok and a_ok2, ms, plain_ms,
        bound_ms, bound_by, max(a_err, a_err2), lib_fwd_ms)
    g_err, g_ok, g_how = ctc_compare("ctc_gamma", gamma, pg)
    ms = time_ms(torch, lambda: tlat.ctc_gamma(emit, skip, in_lens, lab_lens,
                                               alphas), 10)
    plain_ms = time_ms(torch, lambda: tlat.ctc_gamma_plain(
        emit, skip, in_lens, lab_lens, alphas), 3)
    bound_ms, bound_by = bound(CTC_OPS_PER_STATE * live, 3 * t * b * s * 4
                               + gb + b * 16, PEAK_FLOPS["float32"])
    main["ctc_gamma"] = report(
        "ctc_gamma", label, "float32", g_how, g_ok, ms, plain_ms, bound_ms,
        bound_by, g_err, lib_bwd_ms)

    # torch's own CTC as a second oracle for the loss and its gradient
    x = logits.clone().requires_grad_(True)
    loss = tctc.ctc_loss(x, labels, in_lens, lab_lens, reduction="sum")
    loss.backward()
    lib_grad, = torch.autograd.grad(lib_loss, lp)
    y = logits.clone().requires_grad_(True)
    (torch.log_softmax(y, -1).transpose(0, 1) * lib_grad).sum().backward()
    loss, lib_loss = float(loss.detach()), float(lib_loss.detach())
    loss_dev = abs(loss - lib_loss) / abs(lib_loss)
    grad_dev = float((x.grad - y.grad).abs().max())
    grad_rel = float((x.grad - y.grad).norm() / y.grad.norm())
    log("kernels", f"ctc_loss {label} V={v} float32 vs "
        f"torch.nn.functional.ctc_loss: loss {loss:.4f} vs {lib_loss:.4f} "
        f"(relative {loss_dev:.2e}, limit {CTC_LOSS_RTOL}), d logits max "
        f"|dev| {grad_dev:.2e} (limit {CTC_GRAD_ATOL}), relative L2 "
        f"{grad_rel:.2e}")
    if loss_dev > CTC_LOSS_RTOL or grad_dev > CTC_GRAD_ATOL:
        raise AssertionError("the CTC loss disagrees with torch's ctc_loss")
    return main


KERNELS = {  # name: (source, the TPU kernel it replaces)
    "relpos_attention": ("espnet_tpu_torch/csrc/relpos_attention.cu",
                         "espnet_tpu/ops/pallas_relpos_attention.py:821"),
    "relpos_attention_bwd": ("espnet_tpu_torch/csrc/relpos_attention.cu",
                             "espnet_tpu/ops/pallas_relpos_attention.py:712"),
    "prenorm_ffn": ("espnet_tpu_torch/csrc/prenorm_ffn.cu",
                    "espnet_tpu/ops/pallas_ffn.py:538"),
    "prenorm_ffn_bwd": ("espnet_tpu_torch/csrc/prenorm_ffn.cu",
                        "espnet_tpu/ops/pallas_ffn.py:384"),
    "ctc_alphas": ("espnet_tpu_torch/csrc/ctc_lattice.cu",
                   "espnet_tpu/ops/pallas_ctc.py:119"),
    "ctc_gamma": ("espnet_tpu_torch/csrc/ctc_lattice.cu",
                  "espnet_tpu/ops/pallas_ctc.py:150"),
    "fused_ffn": ("espnet_tpu_torch/csrc/ffn.cu",
                  "espnet_tpu/ops/pallas_ffn.py:285"),
    "fused_ffn_bwd": ("espnet_tpu_torch/csrc/ffn.cu",
                      "espnet_tpu/ops/pallas_ffn.py:137"),
    "flash_attention": ("espnet_tpu_torch/csrc/flash_attention.cu",
                        "espnet_tpu/ops/pallas_attention.py:133"),
}
REQUEST_SECONDS = (4.0, 6.0, 9.0, 12.0)
SAMPLE_RATE = 16000


L = 12  # encoder layers of every configuration
CTC = {"ctc_alphas": 1, "ctc_gamma": 1}
CONFORMER = ({"relpos_attention": L, "prenorm_ffn": 2 * L},
             {"relpos_attention": L, "relpos_attention_bwd": L,
              "prenorm_ffn": 2 * L, "prenorm_ffn_bwd": 2 * L, **CTC})
# name (of espnet_tpu_torch.configs.ENCODERS): (launches per encode, per
# train step)
CONFIGS = {
    "conformer": CONFORMER,
    # flash attention has no backward kernel
    "transformer": ({"flash_attention": L, "prenorm_ffn": L},
                    {"flash_attention": L, "prenorm_ffn": L,
                     "prenorm_ffn_bwd": L, **CTC}),
    "e_branchformer": ({"fused_ffn": 2 * L, "relpos_attention": L},
                       {"fused_ffn": 2 * L, "fused_ffn_bwd": 2 * L,
                        "relpos_attention": L, "relpos_attention_bwd": L,
                        **CTC}),
}
# conformers at other widths: d 144 (head dim 36 and d_model 144 fail the
# JAX package's gates: plain everywhere, as there), d 384 (head dim 96,
# zero-padded to the attention kernels' 128; the FFN kernels at D=384) and
# d 512 (head dim 128); name: (overrides, per encode, per train step)
GATE_CONFIGS = {
    "gate_d144": ({"d_model": 144}, {}, dict(CTC)),
    "gate_d384": ({"d_model": 384}, *CONFORMER),
    "gate_d512": ({"d_model": 512}, *CONFORMER),
}
MAIN_PATH = {  # kernel: the configuration whose train run gives its launches
    "fused_ffn": "e_branchformer", "fused_ffn_bwd": "e_branchformer",
    "flash_attention": "transformer",
}


def requests(np):
    """One padded batch of seeded noise, one row per request."""
    rng = np.random.RandomState(0)
    lengths = np.array([int(s * SAMPLE_RATE) for s in REQUEST_SECONDS])
    speech = np.zeros((len(lengths), lengths.max()), np.float32)
    for i, n in enumerate(lengths):
        speech[i, :n] = 0.1 * rng.randn(n)
    return speech, lengths


def serve_shapes(cfg, lengths):
    """(B, T') the encoder sees for the padded batch."""
    from espnet_tpu_torch.models.subsampling import subsampled_length

    frames = int(max(lengths)) // cfg.hop_length + 1
    return len(lengths), subsampled_length(frames, cfg.subsampling_factor)


def reset_counts():
    """Set every kernel's launch count to 0; returns the wrappers by name."""
    from espnet_tpu_torch.ops import (ctc_lattice, ffn, flash_attention,
                                      prenorm_ffn, relpos_attention)

    wrappers = {
        "relpos_attention": relpos_attention.relpos_attention,
        "relpos_attention_bwd": relpos_attention.relpos_attention_bwd,
        "prenorm_ffn": prenorm_ffn.prenorm_ffn,
        "prenorm_ffn_bwd": prenorm_ffn.prenorm_ffn_bwd,
        "ctc_alphas": ctc_lattice.ctc_alphas,
        "ctc_gamma": ctc_lattice.ctc_gamma,
        "fused_ffn": ffn.fused_ffn,
        "fused_ffn_bwd": ffn.fused_ffn_bwd,
        "flash_attention": flash_attention.flash_attention,
    }
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_serve(torch, np, cfg, device="cuda", tag="serve"):
    """Serve the requests through Speech2Text; returns the launch counts of
    the served run. (device="cpu" with a small config rehearses the phase
    where there is no card: the wrappers then take their plain versions.)"""
    import dataclasses

    from espnet_tpu_torch.decode.asr_inference import Speech2Text
    from espnet_tpu_torch.models.asr import ASRModel, init_random_

    t = time.perf_counter()
    model = init_random_(ASRModel(cfg), torch.Generator().manual_seed(0))
    s2t = Speech2Text(model, device=device, beam_size=10, ctc_weight=0.3,
                      max_steps=40)
    n_params = sum(p.numel() for p in model.parameters())
    log(tag, f"model built: {n_params} parameters, compute "
        f"{cfg.dtype}, {time.perf_counter() - t:.1f}s")
    speech, lengths = requests(np)
    t = time.perf_counter()
    warm = s2t(speech, lengths, nbest=10)
    sync(torch, device)
    log(tag, f"warm-up run {time.perf_counter() - t:.2f}s")

    wrappers = reset_counts()
    t = time.perf_counter()
    results = s2t(speech, lengths, nbest=10)
    sync(torch, device)
    wall = time.perf_counter() - t
    counts = {name: fn.launches for name, fn in wrappers.items()}
    audio = float(sum(REQUEST_SECONDS))
    log(tag, f"{len(results)} requests, {audio:.0f} s of audio: wall "
        f"{wall:.3f}s, RTF {wall / audio:.5f}; launches {counts}")
    for sec, r, w in zip(REQUEST_SECONDS, results, warm):
        print(f"  request {sec:4.1f}s: {len(r.token_ids)} tokens, "
              f"score {r.score:.4f}", flush=True)
        if r.nbest != w.nbest:
            raise AssertionError("two runs of the same requests disagree")
        if not all(np.isfinite(s) for _, s in r.nbest):
            raise AssertionError("non-finite hypothesis score")
        if any(s1 < s2 for (_, s1), (_, s2) in zip(r.nbest, r.nbest[1:])):
            raise AssertionError("n-best list not sorted by score")
        if not all(0 <= i < cfg.vocab_size for i in r.token_ids):
            raise AssertionError("token id out of range")
    sp = torch.from_numpy(speech).to(device)
    ln = torch.from_numpy(lengths).to(device)
    with torch.no_grad():
        t = time.perf_counter()
        model.encode(sp, ln)
        sync(torch, device)
        enc_s = time.perf_counter() - t
    log(tag, f"encode alone {enc_s:.4f}s of the {wall:.3f}s wall; the "
        f"rest is the beam search ({s2t.max_steps} label steps at most)")

    # the same weights in float32 and in bf16: the kernel path against the
    # plain path (asserted in float32, where the two differ only in rounding)
    for dtype in (torch.float32, torch.bfloat16):
        m = ASRModel(dataclasses.replace(cfg, dtype=dtype))
        m.load_state_dict(model.state_dict())
        m = m.to(device).eval()
        with torch.no_grad():
            enc_k, olens = m.encode(sp, ln)
            m.set_use_kernels(False)
            enc_p, _ = m.encode(sp, ln)
        sync(torch, device)
        valid = (torch.arange(enc_k.shape[1], device=device)[None, :]
                 < olens[:, None])[:, :, None]
        dev = float(((enc_k.float() - enc_p.float()).abs() * valid).max())
        scale = float((enc_p.float().abs() * valid).max())
        log(tag, f"encoder output {tuple(enc_k.shape)} {dtype}: kernels "
            f"vs plain max |dev| {dev:.3e} (max |out| {scale:.3f})")
        if not torch.isfinite(enc_k).all():
            raise AssertionError("encoder output not finite")
        if dtype == torch.float32 and dev > ENCODER_FP32_TOL:
            raise AssertionError(f"float32 encoder output deviates {dev:.3e}"
                                 f" > {ENCODER_FP32_TOL} from the plain path")
    return counts


def train_batch(np, b, seconds, u, vocab, seed):
    """Seeded noise waveforms with random labels (bench.py's batch)."""
    rng = np.random.RandomState(seed)
    n = [int(sec * SAMPLE_RATE) for sec in seconds]
    speech = np.zeros((b, max(n)), np.float32)
    for i, k in enumerate(n):
        speech[i, :k] = 0.1 * rng.randn(k)
    return {"speech": speech,
            "speech_lengths": np.array(n, np.int32),
            "text": rng.randint(1, vocab - 1, (b, u)).astype(np.int32),
            "text_lengths": np.full((b,), u, np.int32)}


def phase_train_parity(torch, np, cfg, device="cuda", tag="train-parity"):
    """One float32 forward and backward of the full-width model with the
    kernels and with their plain versions (dropout and SpecAug off)."""
    import dataclasses

    from espnet_tpu_torch.models.asr import ASRModel, init_random_

    cfg = dataclasses.replace(cfg, dtype=torch.float32, dropout_rate=0.0,
                              use_specaug=False)
    model = init_random_(ASRModel(cfg), torch.Generator().manual_seed(1))
    model = model.to(device).train()
    batch = train_batch(np, len(REQUEST_SECONDS), REQUEST_SECONDS, 20,
                        cfg.vocab_size, 2)
    args = [torch.from_numpy(batch[k]).to(device) for k in
            ("speech", "speech_lengths", "text", "text_lengths")]
    names = [n for n, _ in model.named_parameters()]
    results = {}
    for use in (True, False):
        model.set_use_kernels(use)
        loss, stats = model(*args)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        results[use] = (float(loss.detach()), grads)
    model.set_use_kernels(True)
    sync(torch, device)
    (lk, gk), (lp, gp) = results[True], results[False]
    loss_dev = abs(lk - lp) / abs(lp)
    total = float(torch.sqrt(sum((b.double() ** 2).sum() for b in gp)))
    whole = float(torch.sqrt(sum(((a.double() - b.double()) ** 2).sum()
                                 for a, b in zip(gk, gp)))) / total
    # each tensor's reference norm is floored at TRAIN_GRAD_FLOOR of the
    # whole gradient's: the key projections' bias gradients are 0 exactly
    # (softmax ignores a per-query constant) and hold only rounding noise
    devs = sorted(((float((a.double() - b.double()).norm()
                          / max(float(b.double().norm()),
                                TRAIN_GRAD_FLOOR * total)), n)
                   for n, a, b in zip(names, gk, gp)), reverse=True)
    log(tag, f"float32, B={len(REQUEST_SECONDS)}: loss kernels "
        f"{lk:.6f} vs plain {lp:.6f} (relative {loss_dev:.2e}, limit "
        f"{TRAIN_FP32_LOSS_RTOL}); whole gradient relative L2 {whole:.2e} "
        f"(norm {total:.4e}); worst tensor {devs[0][0]:.2e} ({devs[0][1]}), "
        f"then {devs[1][0]:.2e} ({devs[1][1]}) over {len(devs)} tensors "
        f"(limit {TRAIN_FP32_GRAD_REL_L2})")
    if not all(np.isfinite(d) for d, _ in devs) or not np.isfinite(lk):
        raise AssertionError("non-finite loss or gradient")
    if (loss_dev > TRAIN_FP32_LOSS_RTOL or whole > TRAIN_FP32_GRAD_REL_L2
            or devs[0][0] > TRAIN_FP32_GRAD_REL_L2):
        raise AssertionError("the float32 train step with kernels deviates "
                             "from the plain versions'")


def phase_train(torch, np, cfg, device="cuda", batch_size=TRAIN_BATCH,
                seconds=TRAIN_SECONDS, labels=TRAIN_LABELS,
                steps=TRAIN_TIMED_STEPS, tag="train"):
    """The bench's training run through make_train_step: 1 warm-up step,
    then `steps` timed steps. Returns the launch counts of the timed steps.
    (device="cpu" with a small config rehearses the phase where there is no
    card: the wrappers then take their plain versions.)"""
    from espnet_tpu_torch.models.asr import ASRModel, init_random_
    from espnet_tpu_torch.train.optim import build_optimizer
    from espnet_tpu_torch.train.steps import TrainState, make_train_step

    t = time.perf_counter()
    model = init_random_(ASRModel(cfg), torch.Generator().manual_seed(0))
    tx = build_optimizer("fused_adam", lr=2e-3, schedule="warmuplr",
                         warmup_steps=25000, d_model=cfg.d_model)
    step = make_train_step(model, tx, device=device)
    state = TrainState.create(model, tx)
    batch = train_batch(np, batch_size, [seconds] * batch_size, labels,
                        cfg.vocab_size, 0)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    log(tag, f"{sum(p.numel() for p in model.parameters())} parameters, "
        f"compute {cfg.dtype}, dropout {cfg.dropout_rate}, SpecAug "
        f"{cfg.use_specaug}, B={batch_size} x {seconds} s, U={labels}; "
        f"set-up {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    state, stats = step(state, batch, gen)
    sync(torch, device)
    log(tag, f"warm-up step {time.perf_counter() - t:.2f}s, loss "
        f"{float(stats['loss']):.4f}")
    before = state.params.clone()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    wrappers = reset_counts()
    t = time.perf_counter()
    all_stats = []
    for _ in range(steps):
        state, stats = step(state, batch, gen)
        all_stats.append(stats)
    sync(torch, device)
    wall = time.perf_counter() - t
    counts = {name: fn.launches for name, fn in wrappers.items()}
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device == "cuda" else float("nan"))
    for i, st in enumerate(all_stats):
        vals = {k: float(v) for k, v in st.items()}
        print(f"  step {i + 1}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in vals.items()), flush=True)
        if not (np.isfinite(vals["loss"]) and np.isfinite(vals["grad_norm"])):
            raise AssertionError(f"train step {i + 1}: non-finite loss or "
                                 "gradient norm")
        if vals["skipped"] != 0.0:
            raise AssertionError(f"train step {i + 1} was skipped")
    moved = float((state.params - before).abs().max())
    if not moved > 0.0:
        raise AssertionError("the train steps did not move the parameters")
    step_s = wall / steps
    log(tag, f"{steps} steps: {step_s * 1e3:.1f} ms/step, "
        f"{batch_size * seconds / step_s:.1f} audio-s/s, peak memory "
        f"{peak:.2f} GiB, max parameter move {moved:.3e}; launches {counts}")
    return counts, step_s


def expected_counts(per_step: dict, steps: int) -> dict:
    want = {name: 0 for name in KERNELS}
    want.update({k: v * steps for k, v in per_step.items()})
    return want


def run_config(torch, np, name, cfg, per_encode, per_step, parity=True,
               train_batch_size=TRAIN_BATCH, train_steps=TRAIN_TIMED_STEPS):
    """Serve, (train parity,) train one configuration; checks the exact
    launches of the encode and of the timed train steps. Returns the train
    steps' launch counts."""
    serve = phase_serve(torch, np, cfg, tag=f"serve[{name}]")
    want = expected_counts(per_encode, 1)
    if serve != want:
        raise AssertionError(f"{name}: one encode launched {serve}, "
                             f"expected {want}")
    if parity:
        phase_train_parity(torch, np, cfg, tag=f"train-parity[{name}]")
    launches, _ = phase_train(torch, np, cfg, batch_size=train_batch_size,
                              steps=train_steps, tag=f"train[{name}]")
    want = expected_counts(per_step, train_steps)
    if launches != want:
        raise AssertionError(f"{name}: {train_steps} train steps launched "
                             f"{launches}, expected {want}")
    return launches


def main() -> int:
    import numpy as np
    import torch

    from espnet_tpu_torch.configs import bench_config

    name = phase_device(torch)
    phase_build()
    cfg = bench_config(torch.bfloat16)
    serve_b, serve_t = serve_shapes(cfg, requests(np)[1])
    phase_kernels(torch, serve_b, serve_t)
    results = phase_train_kernels(torch, np)
    launches = {c: run_config(torch, np, c, bench_config(torch.bfloat16, c),
                              *counts)
                for c, counts in CONFIGS.items()}
    for c, (overrides, *counts) in GATE_CONFIGS.items():
        run_config(torch, np, c, bench_config(torch.bfloat16, **overrides),
                   *counts, parity=False, train_batch_size=16, train_steps=1)
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        r = results[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[MAIN_PATH.get(kname, "conformer")][kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "ok": True, "max_err": r["max_abs_err"], "kernel_ms": r["ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    log("done", f"total {time.perf_counter() - _T0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
