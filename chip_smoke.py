#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a CUDA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (found through CUDA_HOME, torch's CUDA_HOME or
PATH) and the repository checkout; imports espnet_tpu_torch, torch, numpy
and the standard library only (no JAX). Phases, each printing one line with
its elapsed seconds, and raising on failure (exit code other than 0):

1. device: the card's name and power limit from nvidia-smi;
2. build: nvcc compiles every espnet_tpu_torch/csrc/*.cu into one library
   (prints the ptxas register / shared-memory lines);
3. kernels: each kernel against its plain PyTorch version at the shapes of
   the serve phase and of the bench's decode geometry (B=8, T=469 / M=3000),
   in float32 and bfloat16, timed with CUDA events beside the plain version
   and the bound (the larger of operations over peak and bytes over
   3.35 TB/s);
4. serve: the full-width bench conformer (random weights from a seed, depth
   as published) answers 4 requests of 4, 6, 9 and 12 s through
   Speech2Text with beam 10; the launch counters must show 12 rel-pos and
   24 FFN launches for the one encode call, and the float32 encoder output
   must match the plain versions';
5. a `{"kernels": [...]}` JSON line;
6. last line: {"ok": true, "device": {...}}.
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
    for _ in range(3):
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


def check_kernel(torch, name, kernel, plain, args, flops, nbytes, dtype_name,
                 label, kwargs=None):
    kwargs = kwargs or {}
    got = kernel(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    max_err, ok, how = compare(torch, name, dtype_name, got, want)
    ms = time_ms(torch, lambda: kernel(*args, **kwargs))
    plain_ms = time_ms(torch, lambda: plain(*args, **kwargs))
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    log("kernels", f"{name} {label} {dtype_name}: {how}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
        f"{'' if ok else '  <-- OUT OF TOLERANCE'}")
    if not ok:
        raise AssertionError(f"{name} {label} {dtype_name} disagrees with "
                             f"its plain version: {how}")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_kernels(torch, serve_b, serve_t):
    """Both kernels against their plain versions. Returns the bfloat16
    results at the serve phase's shapes, by kernel name."""
    from espnet_tpu_torch.ops.prenorm_ffn import (prenorm_ffn,
                                                  prenorm_ffn_plain)
    from espnet_tpu_torch.ops.relpos_attention import (
        relpos_attention, relpos_attention_plain)

    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for label, b, t in (("serve", serve_b, serve_t), ("bench", 8, 469)):
            # ragged key lengths, the longest = t
            lengths = [max(1, t - (t * i) // (2 * b)) for i in range(b)]
            args, flops, nbytes = relpos_case(torch, b, t, dtype, lengths, 0)
            r = check_kernel(torch, "relpos_attention", relpos_attention,
                             relpos_attention_plain, args, flops, nbytes, dn,
                             f"{label} B={b} H=4 T={t} D=64")
            if label == "serve" and dtype == torch.bfloat16:
                main["relpos_attention"] = r
        for label, m in (("serve", serve_b * serve_t), ("bench", 3000)):
            args, flops, nbytes = ffn_case(torch, m, dtype, 1)
            for act, scale in (("swish", 0.5), ("relu", 1.0)):
                r = check_kernel(
                    torch, "prenorm_ffn", prenorm_ffn, prenorm_ffn_plain,
                    args, flops, nbytes, dn,
                    f"{label} M={m} D=256 F=2048 {act} s={scale}",
                    {"activation": act, "residual_scale": scale})
                if (label == "serve" and dtype == torch.bfloat16
                        and act == "swish"):
                    main["prenorm_ffn"] = r
    return main


KERNELS = {
    "relpos_attention": {
        "source": "espnet_tpu_torch/csrc/relpos_attention.cu",
        "replaces": "espnet_tpu/ops/pallas_relpos_attention.py:821",
    },
    "prenorm_ffn": {
        "source": "espnet_tpu_torch/csrc/prenorm_ffn.cu",
        "replaces": "espnet_tpu/ops/pallas_ffn.py:538",
    },
}
REQUEST_SECONDS = (4.0, 6.0, 9.0, 12.0)
SAMPLE_RATE = 16000


def bench_config(dtype):
    """The model of bench.py (full width and depth), for inference: raw
    input, utterance MVN, conformer encoder, transformer decoder."""
    from espnet_tpu_torch.models.asr import ASRConfig

    return ASRConfig(
        vocab_size=5000, n_mels=80, d_model=256, num_heads=4, d_ff=2048,
        num_encoder_layers=12, num_decoder_layers=6, decoder_d_ff=2048,
        conformer_kernel_size=31, subsampling_factor=4, ctc_weight=0.3,
        dtype=dtype)


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
    from espnet_tpu_torch.ops.prenorm_ffn import prenorm_ffn
    from espnet_tpu_torch.ops.relpos_attention import relpos_attention

    relpos_attention.launches = 0
    prenorm_ffn.launches = 0
    return {"relpos_attention": relpos_attention, "prenorm_ffn": prenorm_ffn}


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_serve(torch, np, cfg, device="cuda"):
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
    log("serve", f"model built: {n_params} parameters, compute "
        f"{cfg.dtype}, {time.perf_counter() - t:.1f}s")
    speech, lengths = requests(np)
    t = time.perf_counter()
    warm = s2t(speech, lengths, nbest=10)
    sync(torch, device)
    log("serve", f"warm-up run {time.perf_counter() - t:.2f}s")

    wrappers = reset_counts()
    t = time.perf_counter()
    results = s2t(speech, lengths, nbest=10)
    sync(torch, device)
    wall = time.perf_counter() - t
    counts = {name: fn.launches for name, fn in wrappers.items()}
    audio = float(sum(REQUEST_SECONDS))
    log("serve", f"{len(results)} requests, {audio:.0f} s of audio: wall "
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
    log("serve", f"encode alone {enc_s:.4f}s of the {wall:.3f}s wall; the "
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
        log("serve", f"encoder output {tuple(enc_k.shape)} {dtype}: kernels "
            f"vs plain max |dev| {dev:.3e} (max |out| {scale:.3f})")
        if not torch.isfinite(enc_k).all():
            raise AssertionError("encoder output not finite")
        if dtype == torch.float32 and dev > ENCODER_FP32_TOL:
            raise AssertionError(f"float32 encoder output deviates {dev:.3e}"
                                 f" > {ENCODER_FP32_TOL} from the plain path")
    return counts


def main() -> int:
    import numpy as np
    import torch

    name = phase_device(torch)
    phase_build()
    cfg = bench_config(torch.bfloat16)
    serve_b, serve_t = serve_shapes(cfg, requests(np)[1])
    results = phase_kernels(torch, serve_b, serve_t)
    launches = phase_serve(torch, np, cfg)
    want = {"relpos_attention": cfg.num_encoder_layers,
            "prenorm_ffn": 2 * cfg.num_encoder_layers}
    if launches != want:
        raise AssertionError(f"one encode launched {launches}, expected "
                             f"{want}")
    kernels = []
    for kname, info in KERNELS.items():
        r = results[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": info["source"],
            "replaces": info["replaces"], "launches": launches[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
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
