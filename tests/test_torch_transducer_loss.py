"""The port's RNN-T loss (`ops/transducer.py`) and its lattice pair
(`ops/transducer_lattice.py`) against the JAX package, float32 on the CPU.

The loss and `jax.grad` of it over variable lengths, a label length of 0 and
an input length of 1; the plain alpha and beta walks (by anti-diagonals)
against the JAX row scans; and a numpy emulation of the CUDA kernels' walk
(`csrc/transducer_lattice.cu`: one thread per label position, wave n on
node (n - u, u), two diagonals in shared memory, the next wave's emissions
loaded a wave ahead) against the plain versions, which a version with the
neighbour's diagonal shifted by one must fail.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.ops import transducer as jt
from espnet_tpu_torch.ops import transducer as tt
from espnet_tpu_torch.ops import transducer_lattice as tlat


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

ROOT = Path(__file__).resolve().parent.parent
# float32 log-space sums in the same order; the loss's gradient through the
# log-softmax
TOL = 1e-5
NEG = np.float32(-1.0e30)

CASES = {
    # name: (B, T, U, V, input lengths, label lengths)
    "ragged": (4, 9, 4, 7, (9, 6, 1, 3), (4, 0, 2, 1)),
    "full": (2, 5, 3, 5, (5, 5), (3, 3)),
    "no_labels": (2, 4, 0, 4, (4, 2), (0, 0)),
}


def _case(name, seed=0):
    b, t, u, v, ilen, llen = CASES[name]
    rng = np.random.RandomState(seed)
    logits = (2 * rng.randn(b, t, u + 1, v)).astype(np.float32)
    labels = rng.randint(1, v, (b, u)).astype(np.int32)
    llen = np.asarray(llen, np.int32)
    labels[np.arange(u)[None, :] >= llen[:, None]] = 0  # the collate's pad
    return logits, labels, np.asarray(ilen, np.int32), llen


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradient_match_jax(name):
    logits, labels, ilen, llen = _case(name)
    args = (jnp.asarray(labels), jnp.asarray(ilen), jnp.asarray(llen))

    @jax.jit
    def jax_side(x):
        nll = jt.transducer_loss(x, *args, reduction="none")
        value, grad = jax.value_and_grad(
            lambda y: jt.transducer_loss(y, *args, reduction="sum"))(x)
        return nll, value, grad, jnp.mean(nll)

    want_nll, want_sum, want_grad, want_mean = jax_side(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    nll = tt.transducer_loss(x, _t(labels), _t(ilen), _t(llen),
                             reduction="none")
    nll.sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(want_nll),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(nll.detach().sum()), float(want_sum),
                               rtol=TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=TOL, atol=TOL)
    for red, want in (("mean", want_mean), ("sum", want_sum)):
        got = tt.transducer_loss(_t(logits), _t(labels), _t(ilen), _t(llen),
                                 reduction=red)
        np.testing.assert_allclose(float(got), float(want), rtol=TOL)


def test_the_gradient_scales_with_the_cotangent_and_skips_other_classes():
    """d log_probs is -occupancy at blank and at each label, 0 elsewhere,
    times g: the analytic VJP, not autodiff through the recursion."""
    logits, labels, ilen, llen = _case("ragged", seed=3)
    lp = torch.log_softmax(_t(logits), -1).requires_grad_(True)
    nll = tt.transducer_loss_from_log_probs(lp, _t(labels), _t(ilen),
                                            _t(llen))
    g = torch.tensor([1.0, -2.0, 0.5, 3.0])
    (grad,) = torch.autograd.grad(nll, lp, g)
    want = jax.jit(lambda x, ct: jax.vjp(
        lambda y: jt.transducer_loss_from_log_probs(
            y, jnp.asarray(labels), jnp.asarray(ilen), jnp.asarray(llen)),
        x)[1](ct)[0])(jnp.asarray(lp.detach().numpy()), jnp.asarray(g.numpy()))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    used = np.zeros(logits.shape, bool)
    used[..., 0] = True
    for bi in range(labels.shape[0]):
        for ui in range(labels.shape[1]):
            used[bi, :, ui, labels[bi, ui]] = True
    assert not grad.numpy()[~used].any()


def test_plain_walks_match_the_jax_scans():
    logits, labels, ilen, llen = _case("ragged", seed=1)
    lp = jax.nn.log_softmax(jnp.asarray(logits), -1)
    _, (jblank, jlab) = jt._loss_impl(lp, jnp.asarray(labels),
                                      jnp.asarray(ilen), jnp.asarray(llen), 0)
    want_a = np.asarray(jt._alpha_scan(jblank, jlab, jnp.asarray(ilen),
                                       return_all=True)).transpose(1, 0, 2)
    want_b = np.asarray(jt._beta_scan(jblank, jlab, jnp.asarray(ilen),
                                      jnp.asarray(llen))).transpose(1, 0, 2)
    blank, lab = tt.lattice_inputs(_t(np.asarray(lp)), _t(labels), _t(llen))
    np.testing.assert_array_equal(blank.numpy(), np.asarray(jblank))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    alphas, log_z = tlat.transducer_alphas_plain(blank, lab, _t(ilen),
                                                 _t(llen))
    betas = tlat.transducer_betas_plain(blank, lab, _t(ilen), _t(llen))
    np.testing.assert_allclose(alphas.numpy(), want_a, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(betas.numpy(), want_b, rtol=TOL, atol=TOL)
    # beta at the start is log Z too
    np.testing.assert_allclose(betas[:, 0, 0].numpy(), log_z.numpy(),
                               rtol=TOL)


@pytest.mark.parametrize("ilen,llen,labels,match", [
    ((4, 0), (1, 1), [[1], [2]], "input lengths"),
    ((4, 5), (1, 1), [[1], [2]], "input lengths"),
    ((4, 3), (1, 2), [[1], [2]], "label lengths"),
    ((4, 3), (1, 1), [[1], [5]], "label ids"),
])
def test_lengths_outside_the_lattice_raise(ilen, llen, labels, match):
    """The JAX loss indexes frame -1 for an input length of 0 (the last
    frame, by wrap-around) and reads past the shapes silently; the port
    raises."""
    logits = torch.zeros(2, 4, 2, 5)
    with pytest.raises(ValueError, match=match):
        tt.transducer_loss(logits, torch.tensor(labels), torch.tensor(ilen),
                           torch.tensor(llen))


def test_wrappers_take_the_plain_versions_on_the_cpu_and_refuse_others():
    logits, labels, ilen, llen = _case("ragged")
    lp = torch.log_softmax(_t(logits), -1)
    blank, lab = tt.lattice_inputs(lp, _t(labels), _t(llen))
    before = (tlat.transducer_alphas.launches,
              tlat.transducer_occupancy.launches)
    a, lz = tlat.transducer_alphas(blank, lab, _t(ilen), _t(llen))
    ob, ol = tlat.transducer_occupancy(blank, lab, _t(ilen), _t(llen), a, lz)
    pa, plz = tlat.transducer_alphas_plain(blank, lab, _t(ilen), _t(llen))
    torch.testing.assert_close(a, pa, rtol=0, atol=0)
    assert (tlat.transducer_alphas.launches,
            tlat.transducer_occupancy.launches) == before
    assert ob.shape == blank.shape and ol.shape == lab.shape
    meta = blank.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tlat.transducer_alphas(meta, lab.to("meta"), _t(ilen), _t(llen))
    with pytest.raises(ValueError, match="unsupported device"):
        tlat.transducer_occupancy(meta, lab.to("meta"), _t(ilen), _t(llen),
                                  a.to("meta"), lz.to("meta"))


# ------------------------------------------------ the kernels' walk in numpy

def _source_constant(name):
    src = (ROOT / "espnet_tpu_torch/csrc/transducer_lattice.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _logaddexp(a, b):
    m = np.maximum(a, b)
    ms = np.maximum(m, NEG)
    # both terms below NEG_INF: log(0), replaced by NEG_INF below
    with np.errstate(over="ignore", divide="ignore"):
        out = ms + np.log(np.exp(a - ms) + np.exp(b - ms))
    return np.where(m <= NEG, NEG, out).astype(np.float32)


def _occ(x):
    return np.exp(np.clip(x, NEG, 0.0)).astype(np.float32)


def emulate_alpha_kernel(blank, lab, ilens, llens, shift=1):
    """`rnnt_alpha_kernel`, one block (utterance) after another, its U1
    threads in lock step: per wave the next wave's emissions are loaded
    first, then each active thread combines its register (alpha[t-1, u])
    with the previous diagonal's entry u - shift; the diagonals alternate
    between the two shared buffers. `shift` 1 is the kernel."""
    b_n, t_max, u1 = blank.shape
    if u1 > _source_constant("RNNT_MAX_LABELS"):
        raise ValueError("U + 1 exceeds the kernel's threads")
    u = np.arange(u1)
    alphas = np.full(blank.shape, np.nan, np.float32)
    log_z = np.full(b_n, np.nan, np.float32)
    for b in range(b_n):
        ilen, llen = int(ilens[b]), int(llens[b])
        diag = np.full((2, u1), NEG, np.float32)

        def load(t):
            eb = np.where((t >= 1) & (t - 1 < t_max),
                          blank[b, np.clip(t - 1, 0, t_max - 1), u], NEG)
            el = np.where((u >= 1) & (t >= 0) & (t < t_max),
                          lab[b, np.clip(t, 0, t_max - 1),
                              np.clip(u - 1, 0, None)] if u1 > 1 else NEG,
                          NEG)
            return eb.astype(np.float32), np.asarray(el, np.float32)

        own = np.full(u1, NEG, np.float32)
        eb, el = load(-u)
        for n in range(ilen + u1 - 1):
            prev, cur = diag[(n + 1) & 1], diag[n & 1]
            t = n - u
            nb, nl = load(t + 1)
            act = (t >= 0) & (t < ilen)
            a = np.where(t == 0, np.where(u == 0, 0.0, NEG), own + eb)
            left = np.where(u >= 1, prev[np.clip(u - shift, 0, u1 - 1)], NEG)
            v = _logaddexp(a.astype(np.float32), left + el)
            own = np.where(act, v, own)
            cur[act] = v[act]
            alphas[b, t[act], u[act]] = v[act]
            eb, el = nb, nl
        alphas[b, ilen:] = own
        log_z[b] = own[llen] + blank[b, ilen - 1, llen]
    return alphas, log_z


def emulate_occupancy_kernel(blank, lab, ilens, llens, alphas, log_z,
                             shift=1):
    """`rnnt_occupancy_kernel` in the same lock step, waves in reverse: beta
    along t in the register, beta[t, u + shift] from the next diagonal, the
    occupancies written as beta is produced, zeros past ilen."""
    b_n, t_max, u1 = blank.shape
    big_u = u1 - 1
    u = np.arange(u1)
    occ_b = np.full(blank.shape, np.nan, np.float32)
    occ_l = np.full(lab.shape, np.nan, np.float32)
    for b in range(b_n):
        ilen, llen = int(ilens[b]), int(llens[b])
        lz = log_z[b]
        diag = np.full((2, u1), NEG, np.float32)

        def load(t):
            inside = (t >= 0) & (t < ilen)
            tc = np.clip(t, 0, t_max - 1)
            eb = np.where(inside, blank[b, tc, u], NEG)
            el = (np.where(inside & (u < big_u),
                           lab[b, tc, np.clip(u, 0, big_u - 1)], NEG)
                  if big_u else np.full(u1, NEG))
            ea = np.where(inside, alphas[b, tc, u], NEG)
            return (x.astype(np.float32) for x in (eb, el, ea))

        own = np.full(u1, NEG, np.float32)
        waves = ilen + big_u
        eb, el, ea = load(waves - 1 - u)
        for n in range(waves - 1, -1, -1):
            nxt, cur = diag[(n + 1) & 1], diag[n & 1]
            t = n - u
            nb, nl, na = load(t - 1)
            act = (t >= 0) & (t < ilen)
            last = t == ilen - 1
            term = np.where(last, np.where(u == llen, eb, NEG), eb + own)
            right = np.where(u < big_u,
                             nxt[np.clip(u + shift, 0, big_u)], NEG)
            beta = _logaddexp(term.astype(np.float32), el + right)
            blank_to = np.where(last & (u == llen), 0.0, own)
            ob = _occ(ea + eb + blank_to.astype(np.float32) - lz)
            ol = _occ(ea + el + right - lz)
            occ_b[b, t[act], u[act]] = ob[act]
            lab_act = act & (u < big_u)
            occ_l[b, t[lab_act], u[lab_act]] = ol[lab_act]
            own = np.where(act, beta, own)
            cur[act] = beta[act]
            eb, el, ea = nb, nl, na
        occ_b[b, ilen:] = 0.0
        occ_l[b, ilen:] = 0.0
    return occ_b, occ_l


def _lattice(name, seed):
    logits, labels, ilen, llen = _case(name, seed)
    lp = torch.log_softmax(_t(logits), -1)
    blank, lab = tt.lattice_inputs(lp, _t(labels), _t(llen))
    return blank, lab, _t(ilen), _t(llen)


def _worst(got, want):
    if not got.size:
        return 0.0
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_walk_matches_the_plain_versions(name):
    blank, lab, ilen, llen = _lattice(name, seed=5)
    pa, plz = tlat.transducer_alphas_plain(blank, lab, ilen, llen)
    pob, pol = tlat.transducer_occupancy_plain(blank, lab, ilen, llen, pa,
                                               plz)
    args = (blank.numpy(), lab.numpy(), ilen.numpy(), llen.numpy())
    ea, elz = emulate_alpha_kernel(*args)
    eob, eol = emulate_occupancy_kernel(*args, ea, elz)
    for got in (ea, elz, eob, eol):
        assert not np.isnan(got).any(), "a node the kernels never write"
    assert _worst(ea, pa.numpy()) <= TOL
    assert _worst(elz, plz.numpy()) <= TOL
    assert _worst(eob, pob.numpy()) <= TOL
    assert _worst(eol, pol.numpy()) <= TOL


def test_a_walk_with_the_diagonal_shifted_by_one_fails():
    blank, lab, ilen, llen = _lattice("ragged", seed=6)
    pa, plz = tlat.transducer_alphas_plain(blank, lab, ilen, llen)
    pob, pol = tlat.transducer_occupancy_plain(blank, lab, ilen, llen, pa,
                                               plz)
    args = (blank.numpy(), lab.numpy(), ilen.numpy(), llen.numpy())
    ea, elz = emulate_alpha_kernel(*args, shift=0)
    assert _worst(elz, plz.numpy()) > 1e-2
    ea, elz = emulate_alpha_kernel(*args)
    eob, eol = emulate_occupancy_kernel(*args, ea, elz, shift=0)
    assert max(_worst(eob, pob.numpy()), _worst(eol, pol.numpy())) > 1e-2


def test_the_kernels_take_at_most_1024_label_positions():
    assert _source_constant("RNNT_MAX_LABELS") == 1024
    blank = np.zeros((1, 2, 1025), np.float32)
    with pytest.raises(ValueError, match="exceeds"):
        emulate_alpha_kernel(blank, np.zeros((1, 2, 1024), np.float32),
                             np.array([2]), np.array([0]))
