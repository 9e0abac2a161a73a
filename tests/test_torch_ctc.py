"""The port's CTC: the lattice recursions' plain versions against the Pallas
kernels (interpret mode) and the JAX scan recursions, and the loss with its
analytic gradient against JAX `ctc_loss`, float32 on the CPU. The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.ops import ctc as jctc
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

# float32 log-space sums over <= 60 frames: |alpha| stays below ~300, so
# 1e-5 relative (plus 1e-4 absolute near 0) covers the summation order; the
# NEG_INF = -1e30 entries agree to the same relative tolerance.
LAT_RTOL, LAT_ATOL = 1e-5, 1e-4
LOSS_TOL = 1e-4


def _case(seed=0, b=5, t=40, u=6, v=9):
    """Ragged lengths; utterance 2 is infeasible (2 frames for 6 labels),
    utterance 3 has U = 0, utterance 1 has a repeated label."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, v).astype(np.float32)
    labels = rng.randint(1, v, (b, u)).astype(np.int32)
    labels[1, 1] = labels[1, 0]
    in_lens = np.array([t, t - 5, 2, t - 1, 11][:b], np.int32)
    lab_lens = np.array([u, u - 1, u, 0, 3][:b], np.int32)
    return logits, labels, in_lens, lab_lens


def _lattice_inputs(logits, labels):
    """(emit (T, B, S), skip (B, S)) as the JAX package builds them."""
    ext = jctc._extended_labels(jnp.asarray(labels), 0)
    lse = jax.scipy.special.logsumexp(jnp.asarray(logits), axis=-1)
    emit = jctc._ctc_logits_emit(jnp.asarray(logits), ext, lse)
    return np.asarray(emit), np.asarray(jctc._transition_mask(ext))


def test_extended_labels_transitions_and_min_frames_match():
    logits, labels, in_lens, lab_lens = _case()
    tl = torch.from_numpy(labels).long()
    ext = tctc.extended_labels(tl)
    np.testing.assert_array_equal(
        ext.numpy(), np.asarray(jctc._extended_labels(jnp.asarray(labels), 0)))
    np.testing.assert_array_equal(
        tctc.transition_mask(ext).numpy(),
        np.asarray(jctc._transition_mask(jnp.asarray(ext.numpy()))))
    np.testing.assert_array_equal(
        tctc.min_frames(tl, torch.from_numpy(lab_lens)).numpy(),
        np.asarray(jctc._min_frames(jnp.asarray(labels),
                                    jnp.asarray(lab_lens))))
    emit, _ = _lattice_inputs(logits, labels)
    lse = torch.logsumexp(torch.from_numpy(logits), -1)
    np.testing.assert_allclose(
        tctc._emissions(torch.from_numpy(logits), ext, lse).numpy(), emit,
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed,t", [(0, 40), (1, 7)])
def test_lattice_plain_matches_pallas_kernels(seed, t):
    logits, labels, in_lens, lab_lens = _case(seed, t=t)
    in_lens = np.minimum(in_lens, t)
    emit, skip = _lattice_inputs(logits, labels)
    ja, jlast = ctc_alphas_pallas(jnp.asarray(emit), jnp.asarray(skip),
                                  jnp.asarray(in_lens), tb=16,
                                  interpret=True)
    jg = ctc_gamma_pallas(jnp.asarray(emit), jnp.asarray(skip),
                          jnp.asarray(in_lens), jnp.asarray(lab_lens), ja,
                          tb=16, interpret=True)
    te, ts = torch.from_numpy(emit.copy()), torch.from_numpy(skip.copy())
    tl = torch.from_numpy(in_lens)
    alphas, last = tlat.ctc_alphas(te, ts, tl)
    gamma = tlat.ctc_gamma(te, ts, tl, torch.from_numpy(lab_lens), alphas)
    for got, want in ((alphas, ja), (last, jlast), (gamma, jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LAT_RTOL, atol=LAT_ATOL)


def test_lattice_plain_matches_scan_recursions():
    """The scan path of ops/ctc.py: alphas, betas (gamma = alpha + beta -
    emit) and log Z. Every length here is at least 1 (the scan seeds frame 0
    whatever the length; the kernels freeze a length-0 utterance)."""
    logits, labels, in_lens, lab_lens = _case(3)
    emit, skip = _lattice_inputs(logits, labels)
    je, js, jl = (jnp.asarray(a) for a in (emit, skip, in_lens))
    ja = jctc._forward_alphas(je, js, jl)
    jb = jctc._backward_betas(je, js, jl, jnp.asarray(lab_lens))
    te, ts = torch.from_numpy(emit.copy()), torch.from_numpy(skip.copy())
    alphas, last = tlat.ctc_alphas(te, ts, torch.from_numpy(in_lens))
    gamma = tlat.ctc_gamma(te, ts, torch.from_numpy(in_lens),
                           torch.from_numpy(lab_lens), alphas)
    np.testing.assert_allclose(alphas.numpy(), np.asarray(ja),
                               rtol=LAT_RTOL, atol=LAT_ATOL)
    np.testing.assert_allclose(gamma.numpy(), np.asarray(ja + jb - je),
                               rtol=LAT_RTOL, atol=LAT_ATOL)
    np.testing.assert_allclose(
        tctc.final_log_z(last, torch.from_numpy(lab_lens).long()).numpy(),
        np.asarray(jctc._final_log_z(ja[-1], jnp.asarray(lab_lens))),
        rtol=LAT_RTOL, atol=LAT_ATOL)


@pytest.mark.parametrize("reduction", ["mean_batch", "none", "sum", "mean"])
def test_ctc_loss_and_gradient_match_jax(reduction):
    logits, labels, in_lens, lab_lens = _case(4)
    jargs = (jnp.asarray(labels), jnp.asarray(in_lens), jnp.asarray(lab_lens))

    def jloss(x):
        out = jctc.ctc_loss(x, *jargs, reduction=reduction)
        return jnp.sum(out * jnp.arange(1, out.size + 1).reshape(out.shape))

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    out = tctc.ctc_loss(x, torch.from_numpy(labels),
                        torch.from_numpy(in_lens), torch.from_numpy(lab_lens),
                        reduction=reduction)
    weights = torch.arange(1, out.numel() + 1, dtype=torch.float32)
    tval = (out * weights.reshape(out.shape)).sum()
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    if reduction == "none":
        # zero_infinity: the infeasible utterance gives 0 and no gradient
        out = out.detach()
        assert float(out[2]) == 0.0
        assert float(x.grad[2].abs().max()) == 0.0
        assert float(out[3]) > 0.0  # U = 0 is feasible: all blanks


def test_ctc_gradient_keeps_the_logits_dtype():
    logits, labels, in_lens, lab_lens = _case(5)
    x = torch.from_numpy(logits).bfloat16().requires_grad_(True)
    tctc.ctc_loss(x, torch.from_numpy(labels), torch.from_numpy(in_lens),
                  torch.from_numpy(lab_lens)).backward()
    assert x.grad.dtype == torch.bfloat16
    assert torch.isfinite(x.grad.float()).all()


def test_lattice_wrappers_route_by_device():
    logits, labels, in_lens, _ = _case(6)
    emit, skip = _lattice_inputs(logits, labels)
    te, ts = torch.from_numpy(emit.copy()), torch.from_numpy(skip.copy())
    before = tlat.ctc_alphas.launches
    torch.testing.assert_close(tlat.ctc_alphas(te, ts, torch.from_numpy(
        in_lens))[0], tlat.ctc_alphas_plain(te, ts, torch.from_numpy(
            in_lens))[0], rtol=0, atol=0)
    assert tlat.ctc_alphas.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tlat.ctc_alphas(te.to("meta"), ts.to("meta"),
                        torch.from_numpy(in_lens).to("meta"))
