"""The slice as a whole: reduced transformer, Branchformer and E-Branchformer
ASR models (d=64, 2 heads, 2 encoder and 2 decoder layers) built in JAX,
their perturbed parameters carried into the port, then encode, the training
loss and every parameter gradient compared, float32 on the CPU with dropout
and SpecAug off. The transformer's input gives T' = 515 frames, so the JAX
encoder takes its Pallas flash kernel (interpret mode) and the port its
flash route (the plain version on the CPU). Then the shape gates: which
kernel wrapper each module calls, decided from the shapes alone."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from espnet_tpu.models.asr import ASRModel as JASRModel
from espnet_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel
from espnet_tpu_torch.models.attention import (MultiHeadAttention,
                                               RelPositionMultiHeadAttention)
from espnet_tpu_torch.models.conformer import ConvolutionModule
from espnet_tpu_torch.models.transformer import (PositionwiseFeedForward,
                                                 TransformerEncoderLayer)
from espnet_tpu_torch.ops import ffn as tffn
from espnet_tpu_torch.ops import flash_attention as tflash
from espnet_tpu_torch.ops import prenorm_ffn as tpffn
from espnet_tpu_torch.ops import relpos_attention as trel


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

# float32, 2 + 2 layers over a log-mel frontend, summed in another order
ENC_TOL = 1e-4
LOSS_TOL = 1e-4
GRAD_TOL = 5e-4
ENCODERS = ("transformer", "branchformer", "e_branchformer")
KEYS = ("speech", "speech_lengths", "text", "text_lengths")


def _configs(encoder_type):
    kw = dict(vocab_size=64, d_model=64, num_heads=2, d_ff=128,
              num_encoder_layers=2, num_decoder_layers=2, decoder_d_ff=128,
              conformer_kernel_size=7, ctc_weight=0.3, lsm_weight=0.1,
              dropout_rate=0.0, use_specaug=False,
              normalize="utterance_mvn", encoder_type=encoder_type)
    jcfg = _flagship_config(vocab=64, **{k: v for k, v in kw.items()
                                         if k != "vocab_size"})
    return jcfg, ASRConfig(**kw)


def _batch(encoder_type):
    """Transformer: 16.5 s (T' = 515 >= 512, the JAX flash gate); the
    branchformers: 0.5 s."""
    n = 264000 if encoder_type == "transformer" else 8000
    rng = np.random.RandomState(0)
    lens = np.array([n, int(n * 0.72)], np.int32)
    speech = (0.1 * rng.randn(2, n)).astype(np.float32)
    speech[np.arange(n)[None] >= lens[:, None]] = 0.0
    text = rng.randint(1, 63, (2, 5)).astype(np.int32)
    tlens = np.array([5, 3], np.int32)
    text[np.arange(5)[None] >= tlens[:, None]] = 0
    return {"speech": speech, "speech_lengths": lens, "text": text,
            "text_lengths": tlens}


@pytest.fixture(scope="module", params=ENCODERS)
def slice_setup(request):
    jcfg, tcfg = _configs(request.param)
    batch = _batch(request.param)
    jm = JASRModel(jcfg)
    jb = tuple(jnp.asarray(batch[k]) for k in KEYS)
    v = fnn.meta.unbox(jax.jit(jm.init, static_argnums=(5,))(
        jax.random.PRNGKey(0), *jb, True))
    rng = np.random.RandomState(1)  # exercise zero-initialised leaves too
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a)
        + 0.05 * rng.randn(*a.shape).astype(np.float32), v["params"])
    return jm, params, jb, tcfg, batch


def _t(a):
    return torch.from_numpy(np.array(a))


def test_encode_matches_jax(slice_setup):
    jm, params, jb, tcfg, batch = slice_setup
    je, jl = jax.jit(lambda p, s, sl: jm.apply(
        {"params": p}, s, sl, method=JASRModel.encode))(params, *jb[:2])
    tm = load_jax_params(ASRModel(tcfg), params).eval()
    with torch.no_grad():
        te, tl = tm.encode(_t(batch["speech"]), _t(batch["speech_lengths"]))
    if tcfg.encoder_type == "transformer":
        assert te.shape[1] >= 512
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=ENC_TOL,
                               rtol=ENC_TOL)


def test_loss_and_every_gradient_match_jax(slice_setup):
    jm, params, jb, tcfg, batch = slice_setup
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, *jb, True), has_aux=True))(params)
    tm = load_jax_params(ASRModel(tcfg), params).train()
    tloss, tstats = tm(*(_t(batch[k]) for k in KEYS))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    for k in ("loss_ctc", "loss_att", "acc"):
        np.testing.assert_allclose(float(tstats[k].detach()),
                                   float(jstats[k]), rtol=LOSS_TOL,
                                   atol=1e-7, err_msg=k)
    want = jax_params_to_state_dict(jgrads)
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * max(1.0, np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("encoder_type,switches", [
    ("transformer", {MultiHeadAttention: 2 + 4, PositionwiseFeedForward: 2}),
    ("e_branchformer", {RelPositionMultiHeadAttention: 2,
                        PositionwiseFeedForward: 4}),
    ("conformer", {RelPositionMultiHeadAttention: 2,
                   PositionwiseFeedForward: 4, ConvolutionModule: 2}),
])
def test_set_use_kernels_reaches_every_kernel_module(encoder_type, switches):
    """The encoder's kernel-bearing modules (and the decoder's attention,
    which takes the flash route where its shapes allow) all follow; each
    kernel route has one switch, on the module that holds its weights (an
    FFN's, whether a layer sends it to the pre-norm or the plain FFN
    kernels; the conv module's, whichever conv route its block selects),
    and no layer has one of its own."""
    model = ASRModel(_configs(encoder_type)[1])
    for enabled in (False, True):
        model.set_use_kernels(enabled)
        for cls, n in switches.items():
            mods = [m for m in model.modules() if type(m) is cls]
            assert len(mods) >= n
            assert all(m.use_kernel is enabled for m in mods)
    owners = {type(m) for m in model.modules() if hasattr(m, "use_kernel")}
    assert owners <= {MultiHeadAttention, RelPositionMultiHeadAttention,
                      PositionwiseFeedForward, ConvolutionModule}
    assert TransformerEncoderLayer not in owners


def _spy(monkeypatch, module, name, calls):
    """Replace `module.name` with a recorder that calls the original."""
    fn = getattr(module, name)

    def spy(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("encoder_type,d,heads,want", [
    ("conformer", 256, 4, {"relpos_attention", "prenorm_ffn"}),
    ("conformer", 144, 4, set()),           # d 144, dk 36: plain everywhere
    ("transformer", 256, 4, {"flash_attention", "prenorm_ffn"}),
    ("transformer", 144, 4, set()),
    ("e_branchformer", 256, 4, {"relpos_attention", "fused_ffn"}),
    ("e_branchformer", 144, 4, set()),
    # d 128 (dk 32) and d 384 (dk 96, padded to 128 on the card): kernels
    ("conformer", 128, 4, {"relpos_attention", "prenorm_ffn"}),
    ("conformer", 384, 4, {"relpos_attention", "prenorm_ffn"}),
    ("transformer", 384, 4, {"flash_attention", "prenorm_ffn"}),
    ("e_branchformer", 384, 4, {"relpos_attention", "fused_ffn"}),
    # d 192, 4 heads: dk 48 passes the attention gate, d_model 192 fails
    # the FFN gate
    ("conformer", 192, 4, {"relpos_attention"}),
    ("transformer", 192, 4, {"flash_attention"}),
    # d 144, 3 heads: dk 48 again, the FFN plain
    ("e_branchformer", 144, 3, {"relpos_attention"}),
])
def test_shape_gates_decide_the_route(monkeypatch, encoder_type, d, heads,
                                      want):
    """Which kernel wrappers an encode calls (on the CPU each then takes its
    plain version): the shapes the JAX package's gates send to its plain
    versions go to the plain versions before any wrapper is called."""
    calls = []
    for module, name in ((trel, "relpos_attention"),
                         (tpffn, "prenorm_ffn"), (tffn, "fused_ffn"),
                         (tflash, "flash_attention")):
        _spy(monkeypatch, module, name, calls)
    cfg = dataclasses.replace(_configs(encoder_type)[1], d_model=d,
                              num_heads=heads, d_ff=4 * d,
                              num_encoder_layers=1)
    with torch.no_grad():
        ASRModel(cfg).encode(torch.zeros(1, 4000) + 0.1,
                             torch.tensor([4000]))
    assert set(calls) == want


def test_relpos_gate_is_the_jax_gate(monkeypatch):
    """dk 128: a forward alone and a differentiated call both go to the
    kernel wrapper (the backward pair takes dk 128 too), as the JAX
    module's gate `dk % 8 == 0` sends both to its Pallas kernels."""
    calls = []
    _spy(monkeypatch, trel, "relpos_attention", calls)
    attn = RelPositionMultiHeadAttention(4, 512)
    x = torch.randn(1, 5, 512)
    pos = torch.randn(1, 9, 512)
    with torch.no_grad():
        attn(x, pos)
    assert calls == ["relpos_attention"]
    attn(x, pos).sum().backward()
    assert calls == ["relpos_attention"] * 2
    for dk in (8, 36, 48, 64, 96, 128, 200):
        assert trel.kernel_takes(dk) is (dk % 8 == 0)
