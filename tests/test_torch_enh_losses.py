"""The port's enhancement criterions (`ops/enh_losses.py`), layers
(`models/enh/layers.py`) and SE metrics (`utils/se_metrics.py`,
`utils/pesq_py.py`) against the JAX package's, float32 on the CPU.

Losses and their gradients agree to 1e-5 (absolute and relative; CI-SDR,
a float32 Toeplitz solve, to 1e-4 and its gradient to 1e-3 of its
largest entry). PIT and MixIT pick the first best permutation or
assignment in `itertools` order, as `jnp.argmin` does: checked with
constructed ties. The numpy metrics are copies and give exactly JAX's
numbers.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models.enh import layers as jlayers
from espnet_tpu.ops import enh_losses as jl
from espnet_tpu.utils import pesq_py as jpesq
from espnet_tpu.utils import se_metrics as jmetrics
from espnet_tpu_torch.convert import load_jax_params
from espnet_tpu_torch.models.enh import layers as tlayers
from espnet_tpu_torch.ops import enh_losses as tl
from espnet_tpu_torch.utils import pesq_py as tpesq
from espnet_tpu_torch.utils import se_metrics as tmetrics

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def signals(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


LENS = np.asarray([300, 211], np.int32)


@pytest.mark.parametrize("name", ["si_snr", "si_snr_clamp", "si_snr_raw",
                                  "snr", "time_mse", "ci_sdr"])
def test_time_domain_losses_and_gradients(name):
    ref, est = signals(0, (2, 300)), signals(1, (2, 300))
    est = est + 2.0 * ref
    kw = {"si_snr_clamp": dict(clamp_db=5.0),
          "si_snr_raw": dict(zero_mean=False),
          "ci_sdr": dict(filter_length=16)}.get(name, {})
    fname = name if name in ("snr", "time_mse", "ci_sdr") else "si_snr"
    jf, tf = getattr(jl, fname + "_loss"), getattr(tl, fname + "_loss")
    want, jgrad = jax.value_and_grad(
        lambda e: jnp.sum(jf(jnp.asarray(ref), e, jnp.asarray(LENS), **kw))
    )(jnp.asarray(est))
    e = _t(est, True)
    got = tf(_t(ref), e, _t(LENS), **kw).sum()
    got.backward()
    tol = 1e-4 if name == "ci_sdr" else TOL
    close(got, want, tol)
    scale = float(np.abs(jgrad).max())
    assert float((e.grad - torch.from_numpy(np.array(jgrad))).abs().max()) \
        <= (1e-3 if name == "ci_sdr" else 1e-4) * scale


@pytest.mark.parametrize("name", ["tf_mse", "spectral_l1"])
def test_tf_losses(name):
    ref, est = np.abs(signals(2, (2, 9, 5))), np.abs(signals(3, (2, 9, 5)))
    lens = np.asarray([9, 6], np.int32)
    want = getattr(jl, name + "_loss")(jnp.asarray(ref), jnp.asarray(est),
                                      jnp.asarray(lens))
    close(getattr(tl, name + "_loss")(_t(ref), _t(est), _t(lens)), want)
    close(getattr(tl, name + "_loss")(_t(ref), _t(est)),
          getattr(jl, name + "_loss")(jnp.asarray(ref), jnp.asarray(est)))


@pytest.mark.parametrize("mask_type", ["IBM", "IRM", "IAM", "PSM", "NPSM"])
def test_mask_labels(mask_type):
    mr, mi, rr, ri = (signals(s, (2, 7, 9)) for s in range(4, 8))
    want = jl.mask_label(*(jnp.asarray(a) for a in (mr, mi, rr, ri)),
                         mask_type)
    close(tl.mask_label(*(_t(a) for a in (mr, mi, rr, ri)), mask_type), want)
    with pytest.raises(ValueError):
        tl.mask_label(*(_t(a) for a in (mr, mi, rr, ri)), "XYZ")


def test_dpcl_loss_and_gradient():
    emb = signals(8, (2, 30, 4))
    labels = np.eye(2, dtype=np.float32)[
        np.random.RandomState(9).randint(0, 2, (2, 30))]
    want, jgrad = jax.value_and_grad(lambda v: jnp.sum(jl.dpcl_loss(
        v, jnp.asarray(labels))))(jnp.asarray(emb))
    v = _t(emb, True)
    got = tl.dpcl_loss(v, _t(labels)).sum()
    got.backward()
    close(got, want, 1e-4)
    close(v.grad, jgrad, 1e-4)


@pytest.mark.parametrize("n_spk", [2, 3])
def test_pit_values_permutations_and_gradients(n_spk):
    refs = signals(10, (3, n_spk, 120))
    perm = np.random.RandomState(n_spk).permutation(n_spk)
    ests = refs[:, perm] + 0.3 * signals(11, (3, n_spk, 120))

    def jfn(e):
        loss, p = jl.pit_solve(lambda r, x: jl.si_snr_loss(r, x),
                               jnp.asarray(refs), e)
        return jnp.sum(loss), p

    (want, jperm), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(ests))
    e = _t(ests, True)
    loss, tperm = tl.pit_solve(lambda r, x: tl.si_snr_loss(r, x), _t(refs),
                               e)
    loss.sum().backward()
    close(loss.sum(), want, 1e-4)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    close(e.grad, jgrad, 1e-4)


def test_pit_and_mixit_ties_keep_the_first_best():
    """Every permutation (assignment) scores the same: index 0 wins in
    both packages; a tie between later ones keeps the earlier one."""
    refs = np.ones((2, 3, 16), np.float32)
    ests = np.ones((2, 3, 16), np.float32)
    mse = lambda r, e: ((r - e) ** 2).mean(-1)
    _, jperm = jl.pit_solve(mse, jnp.asarray(refs), jnp.asarray(ests))
    _, tperm = tl.pit_solve(mse, _t(refs), _t(ests))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tperm.numpy(), [[0, 1, 2], [0, 1, 2]])
    # refs 1 and 2 equal: permutations (0,1,2) / (0,2,1) tie for the best
    refs = signals(12, (2, 3, 16))
    refs[:, 2] = refs[:, 1]
    ests = refs[:, [0, 2, 1]].copy()
    _, jperm = jl.pit_solve(mse, jnp.asarray(refs), jnp.asarray(ests))
    _, tperm = tl.pit_solve(mse, _t(refs), _t(ests))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tperm.numpy()[0], [0, 1, 2])
    # MixIT: 2 mixtures, 4 estimates, all-zero estimates tie everywhere
    mix = signals(13, (2, 2, 40))
    zero = np.zeros((2, 4, 40), np.float32)
    for ests in (zero, signals(14, (2, 4, 40))):
        jloss, jasm = jl.mixit_solve(lambda r, e: jl.snr_loss(r, e),
                                     jnp.asarray(mix), jnp.asarray(ests))
        tloss, tasm = tl.mixit_solve(lambda r, e: tl.snr_loss(r, e),
                                     _t(mix), _t(ests))
        np.testing.assert_array_equal(tasm.numpy(), np.asarray(jasm))
        close(tloss, jloss, 1e-4)
    nan = np.full((2, 4), np.nan, np.float32)
    nan[1, 2] = 0.0
    np.testing.assert_array_equal(tl.first_argmin(_t(nan)).numpy(),
                                  np.argmin(nan, 1))


# --- layers ---------------------------------------------------------------

@pytest.mark.parametrize("kernel,stride", [(20, 10), (16, 8), (4, 6),
                                           (5, 5)])
def test_conv_decoder_is_flax_valid_conv_transpose(kernel, stride):
    feat = signals(15, (2, 11, 6))
    j = jlayers.ConvDecoder(6, kernel, stride)
    params = jax.device_get(j.init(jax.random.PRNGKey(0),
                                   jnp.asarray(feat), 140))
    t = tlayers.ConvDecoder(6, kernel, stride)
    load_jax_params(t, params["params"])
    for n in (140, 90):
        close(t(_t(feat), n), j.apply(params, jnp.asarray(feat), n), 1e-5)


@pytest.mark.parametrize("kernel,stride,pads", [
    ((1, 4), (1, 2), ((0, 0), (2, 2))),     # DC-CRN's "SAME" up-conv
    ((2, 5), (1, 2), ((1, 1), (2, 3))),     # DCCRN's complex transposed conv
    ((3, 3), (1, 2), ((1, 1), (2, 2))),     # iNeuBe's up-conv
    ((3, 2), (2, 3), ((0, -1), (4, 1))),    # k < s, a crop and a zero pad
])
def test_lax_conv_transpose_is_flax_conv_transpose_2d(kernel, stride, pads):
    from espnet_tpu_torch.models.layers import lax_conv_transpose

    x = signals(18, (2, 5, 7, 3))
    w = signals(19, (*kernel, 3, 4))
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), pads, lhs_dilation=stride,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    close(lax_conv_transpose(_t(x), _t(w).permute(3, 2, 0, 1), stride,
                             pads), ref, 1e-5)


@pytest.mark.parametrize("causal,norm", [(False, "gLN"), (True, "cLN")])
def test_tcn_and_dprnn_blocks(causal, norm):
    x = signals(16, (2, 13, 8))
    j = jlayers.TemporalConvNet(8, 2, 2, 2, 4, 6, 3, norm, causal,
                                "softmax")
    params = jax.device_get(fnn.meta.unbox(jax.jit(j.init)(
        jax.random.PRNGKey(1), jnp.asarray(x))))
    t = tlayers.TemporalConvNet(8, 2, 2, 2, 4, 6, 3, norm, causal, "softmax")
    load_jax_params(t, params["params"])
    close(t(_t(x)), jax.jit(j.apply)(params, jnp.asarray(x)), 1e-5)
    seg, t_orig = tlayers.segment_sequence(_t(x), 6)
    jseg, _ = jlayers.segment_sequence(jnp.asarray(x), 6)
    close(seg, jseg)
    close(tlayers.merge_segments(seg, t_orig),
          jlayers.merge_segments(jseg, t_orig))
    jb = jlayers.DPRNNBlock(8, 5, causal_inter=causal)
    bp = jax.device_get(jax.jit(jb.init)(jax.random.PRNGKey(2), jseg))
    tb = tlayers.DPRNNBlock(8, 5, causal_inter=causal)
    load_jax_params(tb, bp["params"])
    close(tb(seg), jax.jit(jb.apply)(bp, jseg), 1e-5)


# --- SE metrics: copies, exactly JAX's numbers -----------------------------

def test_se_metrics_and_pesq_are_jaxs_exactly():
    rng = np.random.RandomState(17)
    fs = 16000
    t = np.arange(fs) / fs
    ref = np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    est = ref + 0.3 * rng.randn(fs)
    for name in ("stoi", "estoi", "pesq_approx", "pesq_py"):
        assert getattr(tmetrics, name)(ref, est, fs) == \
            getattr(jmetrics, name)(ref, est, fs)
    for name in ("si_snr", "sdr"):
        assert getattr(tmetrics, name)(ref, est) == \
            getattr(jmetrics, name)(ref, est)
    assert tpesq.pesq_score(ref, est, fs=fs) == jpesq.pesq_score(ref, est,
                                                                 fs=fs)
    short = ref[:2000]
    assert np.isnan(tmetrics.stoi(short, short, fs)) and np.isnan(
        jmetrics.stoi(short, short, fs))
