"""The port's enhancement model (`models/enh/`) against the JAX package's,
float32 on the CPU.

Every separator type runs inside `EnhancementModel` on the JAX model's own
parameters (flax's init, carried by `convert.load_jax_params`) and numpy
inputs from a seed, at small widths and two or fewer layers. Compared:
the separated waveforms, the loss, and every parameter's gradient leaf by
leaf. Tolerances: waveforms and losses 1e-4 (absolute and relative, 2e-4
through the deep U-Nets); gradients 2e-3 of the leaf's largest entry
plus 1e-6 of the model's largest gradient (a leaf whose true gradient is
0, as the key bias's, holds rounding noise), as the LSTM and U-Net chains
sum many products in another order. The JAX side is jitted. Dropout is
0 (DPTNet's is flax's `nn.Dropout`, whose draws no torch generator
repeats); BatchNorm (DC-CRN, DCCRN) is compared in eval mode, and in
training mode with its updated running statistics. The conformer and
transformer cases run at a T' where JAX takes its Pallas kernels in
interpret mode (the rel-pos one, which JAX routes there only on a TPU,
through `TPUNamed`), and the test counts their `pl.pallas_call`s.
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from espnet_tpu.models.enh import EnhancementModel as JModel
from espnet_tpu.models.enh import EnhConfig as JConfig
from espnet_tpu_torch.convert import (batch_stats_tree,
                                      jax_params_to_state_dict,
                                      load_jax_params, model_variables)
from espnet_tpu_torch.models.enh import EnhancementModel as TModel
from espnet_tpu_torch.models.enh import EnhConfig as TConfig

TOL = 1e-4
DEEP_TOL = 2e-4
GRAD_TOL = 2e-3
GRAD_FLOOR = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = dict(num_spk=2, enc_channels=16, enc_kernel=16, enc_stride=8,
            tcn_layers=2, tcn_stacks=1, tcn_bottleneck=8, tcn_hidden=16,
            dprnn_blocks=2, dprnn_hidden=8, dprnn_chunk=20,
            trans_d_model=16, trans_heads=2, trans_d_ff=32, trans_layers=2,
            dropout_rate=0.0, rnn_layers=2, rnn_hidden=8, n_fft=64,
            hop_length=16, dan_emb_dim=4)
STFT = dict(encoder_type="stft")

# name -> (config overrides, samples, mic channels or 0): one case of
# each separator type, with loss and gradients
CASES = {
    "tcn": (dict(separator_type="tcn"), 800, 0),
    "dprnn": (dict(separator_type="dprnn", dprnn_blocks=1), 800, 0),
    "transformer": (dict(separator_type="transformer"), 4200, 0),
    "dptnet": (dict(separator_type="dptnet", dprnn_blocks=1), 800, 0),
    "skim": (dict(separator_type="skim", skim_segment=10), 800, 0),
    "conformer": (dict(separator_type="conformer", conformer_kernel=5),
                  2200, 0),
    "rnn": (dict(separator_type="rnn", nonlinear="sigmoid", **STFT), 800,
            0),
    "dan": (dict(separator_type="dan", **STFT), 800, 0),
    "dc_crn": (dict(separator_type="dc_crn", dc_crn_channels=(2, 4, 8),
                    dc_crn_block_layers=2, **STFT), 800, 0),
    "dccrn": (dict(separator_type="dccrn", dccrn_kernel_num=(8, 16),
                   dccrn_rnn_units=16, **STFT), 800, 0),
    "dpcl_e2e": (dict(separator_type="dpcl_e2e", dpcl_kmeans_iters=3,
                      nonlinear="tanh", rnn_layers=1, **STFT), 800, 0),
    "svoice": (dict(separator_type="svoice", svoice_enc_dim=16,
                    svoice_hidden=8, svoice_layers=2, svoice_segment=10,
                    svoice_normalize=True), 400, 0),
    "fasnet": (dict(separator_type="fasnet", fasnet_enc_dim=8,
                    fasnet_feature_dim=8, fasnet_hidden_dim=8,
                    fasnet_layers=1, fasnet_segment_size=10,
                    fasnet_win_ms=4, fasnet_context_ms=8, fasnet_sr=1000),
               300, 2),
    "ineube": (dict(separator_type="ineube", ineube_hid_chans=4,
                    ineube_hid_chans_dense=4, ineube_tcn_repeats=1,
                    ineube_tcn_blocks=2, ineube_tcn_channels=8,
                    ineube_mics=2, ineube_n_chunks=1,
                    ineube_output_from="mfmcwf", n_fft=32, hop_length=8),
               320, 2),
    "beamformer": (dict(separator_type="beamformer", num_spk=1,
                        bf_hidden=8, bf_layers=1, use_wpe=True), 640, 2),
}
# JAX takes its Pallas kernels here, in interpret mode: flash at
# T' = 524 >= 512, rel-pos at T' = 274 >= 256 (with `TPUNamed`)
PALLAS = ("conformer", "transformer")


class TPUNamed:
    """`jax` as `espnet_tpu.models.attention` sees it, with the default
    backend named "tpu": JAX's rel-pos attention takes its Pallas kernel
    only there, and the kernel, which asks `jax` itself, runs in interpret
    mode on the CPU."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"
ONE = dict(trans_layers=1, dprnn_blocks=1, rnn_layers=1)
# the other encoder and the other options: forward and loss
VARIANTS = {
    "tcn_stft": (dict(separator_type="tcn", **STFT), 800, 0),
    "dprnn_stft": (dict(separator_type="dprnn", **ONE, **STFT), 800, 0),
    "transformer_stft": (dict(separator_type="transformer", **ONE,
                              **STFT), 800, 0),
    "dptnet_stft": (dict(separator_type="dptnet", **ONE, **STFT), 800, 0),
    "skim_id_stft": (dict(separator_type="skim", skim_segment=10,
                          skim_mem_type="id", nonlinear="sigmoid", **STFT),
                     800, 0),
    "conformer_stft": (dict(separator_type="conformer", conformer_kernel=5,
                            nonlinear="softmax", **ONE, **STFT), 800, 0),
    "rnn_conv": (dict(separator_type="rnn", nonlinear="tanh", **ONE), 800,
                 0),
    "dan_conv": (dict(separator_type="dan", **ONE), 800, 0),
    "dpcl_e2e_conv": (dict(separator_type="dpcl_e2e", dpcl_kmeans_iters=2,
                           nonlinear="sigmoid", **ONE), 800, 0),
    "dc_crn_mapping": (dict(separator_type="dc_crn",
                            dc_crn_channels=(2, 4), dc_crn_block_layers=2,
                            dc_crn_mode="mapping", glstm_layers=1, **STFT),
                       800, 0),
    "dccrn_c_noise": (dict(separator_type="dccrn", dccrn_kernel_num=(8, 16),
                           dccrn_rnn_units=16, dccrn_masking_mode="C",
                           dccrn_use_noise_mask=True, **STFT), 800, 0),
    "dccrn_r": (dict(separator_type="dccrn", dccrn_kernel_num=(8,),
                     dccrn_rnn_units=16, dccrn_rnn_layer=1,
                     dccrn_masking_mode="R", **STFT), 800, 0),
    "ineube_dnn2": (dict(separator_type="ineube", ineube_hid_chans=4,
                         ineube_hid_chans_dense=4, ineube_tcn_repeats=1,
                         ineube_tcn_blocks=1, ineube_tcn_channels=8,
                         ineube_output_from="dnn2", n_fft=32, hop_length=8),
                    320, 0),
    "beamformer_plain": (dict(separator_type="beamformer", num_spk=1,
                              bf_hidden=8, bf_layers=1), 640, 2),
}
DEEP = ("ineube", "ineube_dnn2", "dc_crn", "dccrn", "dccrn_c_noise",
        "dccrn_r", "svoice")


def inputs(n, mics, num_spk, seed=0):
    rng = np.random.RandomState(seed)
    shape = (2, n, mics) if mics else (2, n)
    mix = (0.3 * rng.randn(*shape)).astype(np.float32)
    lens = np.asarray([n, n - n // 5], np.int32)
    ref = (0.3 * rng.randn(2, n, num_spk)).astype(np.float32)
    return mix, lens, ref


def jax_pair(kw, mix, lens, ref):
    jm = JModel(JConfig(**kw))
    variables = jax.device_get(fnn.meta.unbox(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(mix), jnp.asarray(lens),
        jnp.asarray(ref))))
    tm = TModel(TConfig(**kw))
    load_jax_params(tm, variables)
    return jm, variables, tm


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def grads_close(model, jgrads, tol=GRAD_TOL):
    want = jax_params_to_state_dict(jax.device_get(jgrads))
    got = dict(model.named_parameters())
    assert set(want) == set(got), set(want) ^ set(got)
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        g = got[k].grad
        g = torch.zeros_like(w) if g is None else g
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= tol * scale + floor, (k, err, scale)


def _enhance_and_loss(module, mix, lens, ref):
    """flax method: (loss, (estimates, others)) in one jitted call."""
    c = module.config
    refs = ref.transpose(0, 2, 1) if ref.shape[-1] == c.num_spk else ref
    est, others = module.forward_enhance(mix, lens)
    loss, _ = module.forward_loss(est, others, mix, lens, refs)
    return loss, (est, others)


def _check_outputs(name, jm, variables, tm, mix, lens, ref, grads):
    tol = DEEP_TOL if name in DEEP else TOL
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}

    def fn(p):
        return jm.apply({"params": p, **rest}, jnp.asarray(mix),
                        jnp.asarray(lens), jnp.asarray(ref),
                        method=_enhance_and_loss)

    if grads:
        (j_loss, (j_est, j_others)), j_grads = jax.jit(jax.value_and_grad(
            fn, has_aux=True))(params)
    else:
        j_loss, (j_est, j_others) = jax.jit(fn)(params)
    est, others = tm.forward_enhance(torch.from_numpy(mix),
                                     torch.from_numpy(lens))
    assert tuple(est.shape) == tuple(j_est.shape)
    close(est, j_est, tol)
    for key in ("mask_spk1", "embedding", "dnn1", "beam", "layer1",
                "noise1"):
        if key in j_others:
            close(others[key], j_others[key], tol)
    loss, _ = tm(torch.from_numpy(mix), torch.from_numpy(lens),
                 torch.from_numpy(ref))
    close(loss, j_loss, tol)
    if grads:
        loss.backward()
        grads_close(tm, j_grads)


@pytest.mark.parametrize("name", sorted(CASES))
def test_separator_outputs_loss_and_gradients_match_jax(name, monkeypatch):
    from jax.experimental import pallas as pl

    over, n, mics = CASES[name]
    kw = dict(BASE, **over)
    mix, lens, ref = inputs(n, mics, kw["num_spk"])
    launches = []
    pallas_call = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: (
        launches.append(1), pallas_call(*a, **k))[1])
    if name == "conformer":
        from espnet_tpu.models import attention

        monkeypatch.setattr(attention, "jax", TPUNamed())
    jm, variables, tm = jax_pair(kw, mix, lens, ref)
    tm.eval()
    _check_outputs(name, jm, variables, tm, mix, lens, ref, grads=True)
    assert bool(launches) == (name in PALLAS), launches


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_separator_variants_outputs_and_loss_match_jax(name):
    over, n, mics = VARIANTS[name]
    kw = dict(BASE, **over)
    mix, lens, ref = inputs(n, mics, kw["num_spk"], seed=1)
    jm, variables, tm = jax_pair(kw, mix, lens, ref)
    tm.eval()
    _check_outputs(name, jm, variables, tm, mix, lens, ref, grads=False)


@pytest.mark.parametrize("name", ["dc_crn", "dccrn"])
def test_batchnorm_training_step_matches_flax(name):
    """Training mode: batch statistics in the forward, running statistics
    updated as flax's `batch_stats` (momentum 0.99)."""
    over, n, mics = CASES[name]
    kw = dict(BASE, **over)
    mix, lens, ref = inputs(n, mics, 2, seed=3)
    jm, variables, tm = jax_pair(kw, mix, lens, ref)
    tm.train()
    (j_loss, _), j_vars = jax.jit(lambda v, m, l, r: jm.apply(
        v, m, l, r, False, mutable=["batch_stats"]))(
        variables, jnp.asarray(mix), jnp.asarray(lens), jnp.asarray(ref))
    loss, _ = tm(torch.from_numpy(mix), torch.from_numpy(lens),
                 torch.from_numpy(ref))
    close(loss, j_loss, DEEP_TOL)
    want = jax_params_to_state_dict({"params": {},
                                     "batch_stats": j_vars["batch_stats"]})
    got = tm.state_dict()
    for k, w in want.items():
        close(got[k], w.numpy(), DEEP_TOL)
    assert batch_stats_tree(tm).keys() == variables["batch_stats"].keys()


LOSSES = ["si_snr", "snr", "time_mse", "ci_sdr", "tf_mse", "spectral_l1",
          "mask_mse_ibm", "mask_mse_irm", "mask_mse_iam", "mask_mse_psm",
          "mask_mse_npsm", "mixit"]


@pytest.mark.parametrize("loss_type", LOSSES + ["dpcl"])
def test_every_loss_type_matches_jax(loss_type):
    kw = dict(BASE, separator_type="dan" if loss_type == "dpcl" else "tcn",
              loss_type=loss_type, ci_sdr_filter_length=32, **STFT)
    mix, lens, ref = inputs(800, 0, 2, seed=7)
    jm, variables, tm = jax_pair(kw, mix, lens, ref)
    tm.eval()

    def loss_fn(p):
        return jm.apply({"params": p}, jnp.asarray(mix), jnp.asarray(lens),
                        jnp.asarray(ref))

    (j_loss, j_stats), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    loss, stats = tm(torch.from_numpy(mix), torch.from_numpy(lens),
                     torch.from_numpy(ref))
    assert set(stats) == set(j_stats)
    close(loss, j_loss, 2e-4 if loss_type == "ci_sdr" else TOL)
    loss.backward()
    grads_close(tm, j_grads, 5e-3 if loss_type == "ci_sdr" else GRAD_TOL)


def test_dan_oracle_mask_branch_matches_jax():
    from espnet_tpu.models.enh.separators import DANSeparator as JDAN
    from espnet_tpu_torch.models.enh.separators import DANSeparator as TDAN

    rng = np.random.RandomState(11)
    feat = rng.randn(2, 7, 6).astype(np.float32)
    lens = np.asarray([7, 5], np.int32)
    oracle = rng.rand(2, 7, 6, 2).astype(np.float32)
    jsep = JDAN(6, 2, 1, 8, 4)
    params = jax.device_get(jax.jit(jsep.init)(
        jax.random.PRNGKey(0), jnp.asarray(feat), jnp.asarray(lens)))
    tsep = TDAN(6, 2, 1, 8, 4)
    load_jax_params(tsep, params["params"])
    for masks in (oracle, None):
        jm, _, jo = jax.jit(jsep.apply, static_argnums=3)(
            params, jnp.asarray(feat), jnp.asarray(lens), True,
            None if masks is None else jnp.asarray(masks))
        tmk, _, to = tsep(torch.from_numpy(feat), torch.from_numpy(lens),
                          None, None if masks is None
                          else torch.from_numpy(masks))
        close(tmk, jm)
        close(to["embedding"], jo["embedding"])


def test_plugin_separator_through_the_registry():
    from espnet_tpu_torch.utils.registry import register

    @register("separator", "test_enh_identity")
    class Identity(torch.nn.Module):
        def __init__(self, input_dim, num_spk, scale=1.0):
            super().__init__()
            self.num_spk = num_spk
            self.gain = torch.nn.Parameter(torch.tensor(float(scale)))

        def forward(self, feat, lengths, generator=None):
            m = self.gain * torch.ones_like(feat)[:, None]
            return (m.expand(-1, self.num_spk, -1, -1) * feat[:, None],
                    lengths, {})

    tm = TModel(TConfig(**dict(BASE, separator_type="test_enh_identity",
                               separator_conf={"scale": 0.5})))
    mix, lens, ref = inputs(400, 0, 2)
    est, _ = tm.forward_enhance(torch.from_numpy(mix),
                                torch.from_numpy(lens))
    assert est.shape == (2, 2, 400)
    with pytest.raises(Exception):
        TModel(TConfig(**dict(BASE, separator_type="no_such_separator")))


def test_model_variables_round_trip_into_flax():
    """The port's parameters and BatchNorm statistics go out as flax
    variables that the JAX model applies to the same output."""
    over, n, mics = VARIANTS["dc_crn_mapping"]
    kw = dict(BASE, **over)
    mix, lens, ref = inputs(n, mics, 2, seed=5)
    tm = TModel(TConfig(**kw))
    torch.manual_seed(0)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.01 * torch.randn_like(p))
    tm.train()
    tm(torch.from_numpy(mix), torch.from_numpy(lens), torch.from_numpy(ref))
    tm.eval()
    jm = JModel(JConfig(**kw))
    est, _ = tm.forward_enhance(torch.from_numpy(mix),
                                torch.from_numpy(lens))
    j_est, _ = jax.jit(lambda v, m, l: jm.apply(
        v, m, l, method=JModel.forward_enhance))(
        model_variables(tm), jnp.asarray(mix), jnp.asarray(lens))
    close(est, j_est, DEEP_TOL)
