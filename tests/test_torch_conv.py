"""The conformer conv sub-block's kernel routes in the port: the ops of
`ops/conv_glu.py` (head and tail, the split route) and `ops/conv_module.py`
(the whole module) against the Pallas `fused_prenorm_glu`,
`fused_postnorm_proj` and `fused_conv_module` in interpret mode and their
`*_reference` oracles, outputs and every gradient, float32 on the CPU; the
hash masks bit for bit; the JAX `ConformerBlock` with each route against the
port's block; a reduced ASR model with each route against the JAX model's
plain route; and the rules that pick a route. The CUDA kernels are held
against the plain versions on the card by tests/test_torch_gpu.py."""

import dataclasses
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import espnet_tpu.models.conformer as jconformer
import espnet_tpu.models.transformer as jtransformer
import espnet_tpu.ops.pallas_conv_glu as jglu
import espnet_tpu.ops.pallas_conv_module as jcm
from __graft_entry__ import _flagship_config
from espnet_tpu.models.asr import ASRModel as JASRModel
from espnet_tpu.models.embedding import rel_position_encoding as jrelpos
from espnet_tpu.ops.masks import attention_bias as jbias
from espnet_tpu.ops.pallas_ffn import _keep_mask
from espnet_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from espnet_tpu_torch.models import conformer as tconformer
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel
from espnet_tpu_torch.models.embedding import rel_position_encoding
from espnet_tpu_torch.ops import conv_glu as tglu
from espnet_tpu_torch.ops import conv_module as tcm
from espnet_tpu_torch.ops import dropout as tdropout
from espnet_tpu_torch.ops.ffn_common import keep_mask, quantize_rate
from espnet_tpu_torch.ops.masks import attention_bias


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

# float32 on the CPU, sums of width <= 288 in another order: outputs
# relative (and absolute, for outputs near 0) 1e-5
OUT_TOL = 1e-5
# gradients: relative L2 per tensor (sums over up to 300 rows reordered)
GRAD_REL_L2 = 1e-4
SEED = 20240607
GRAD_FLOOR = 1e-3


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def _t(a):
    return torch.from_numpy(np.array(a))


def _glu_inputs(m, d, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(x=f(m, d), xr=f(m, d), lns=1 + 0.2 * f(d), lnb=0.2 * f(d),
                w1=f(d, 2 * d) / np.sqrt(d), b1=0.2 * f(2 * d),
                w2=f(d, d) / np.sqrt(d), b2=0.2 * f(d))


def _torch_grads(fn, args, ct):
    leaves = [_t(a).requires_grad_(True) for a in args]
    out = fn(*leaves)
    out.backward(_t(ct))
    return out.detach().numpy(), [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("d", [128, 256])
def test_head_plain_matches_pallas_and_reference(d):
    """M = 300 rows: two 256-row Pallas tiles, the second padded."""
    v = _glu_inputs(300, d, d)
    args = [v[k] for k in ("x", "lns", "lnb", "w1", "b1")]
    jargs = [jnp.asarray(a) for a in args]
    ct = np.random.RandomState(1).randn(300, d).astype(np.float32)
    ref = np.asarray(jglu.prenorm_glu_reference(*jargs))
    pal, pal_grads = jax.vjp(
        lambda *a: jglu.fused_prenorm_glu(*a, interpret=True), *jargs)
    pal_grads = pal_grads(jnp.asarray(ct))
    got, grads = _torch_grads(tglu.prenorm_glu_plain, args, ct)
    np.testing.assert_allclose(got, ref, rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(got, np.asarray(pal), rtol=OUT_TOL,
                               atol=OUT_TOL)
    ref_grads = jax.vjp(jglu.prenorm_glu_reference, *jargs)[1](
        jnp.asarray(ct))
    for name, g, pg, rg in zip("x lns lnb w1 b1".split(), grads, pal_grads,
                               ref_grads):
        assert _rel_l2(g, pg) <= GRAD_REL_L2, (name, _rel_l2(g, pg))
        assert _rel_l2(g, rg) <= GRAD_REL_L2, (name, _rel_l2(g, rg))


@pytest.mark.parametrize("d,drop", [(128, 0.0), (128, 0.1), (256, 0.1)])
def test_tail_plain_matches_pallas_and_reference(d, drop):
    """M = 300 rows; the dropout mask is the Pallas one (one seed, 256-row
    tiles), so outputs and gradients match with dropout on."""
    v = _glu_inputs(300, d, d + 1)
    args = [v[k] for k in ("x", "xr", "lns", "lnb", "w2", "b2")]
    jargs = [jnp.asarray(a) for a in args]
    seed = jnp.asarray([SEED], jnp.int32)
    ct = np.random.RandomState(2).randn(300, d).astype(np.float32)
    ref_fn = lambda *a: jglu.postnorm_proj_reference(  # noqa: E731
        *a, seed, drop_rate=drop)
    pal, pal_vjp = jax.vjp(lambda *a: jglu.fused_postnorm_proj(
        *a, seed, drop_rate=drop, interpret=True), *jargs)
    got, grads = _torch_grads(
        lambda *a: tglu.postnorm_proj_plain(*a, SEED, drop), args, ct)
    np.testing.assert_allclose(got, np.asarray(ref_fn(*jargs)),
                               rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(got, np.asarray(pal), rtol=OUT_TOL,
                               atol=OUT_TOL)
    ref_grads = jax.vjp(ref_fn, *jargs)[1](jnp.asarray(ct))
    for name, g, pg, rg in zip("g x_res lns lnb w2 b2".split(), grads,
                               pal_vjp(jnp.asarray(ct)), ref_grads):
        assert _rel_l2(g, pg) <= GRAD_REL_L2, (name, _rel_l2(g, pg))
        assert _rel_l2(g, rg) <= GRAD_REL_L2, (name, _rel_l2(g, rg))


def _module_inputs(b, t, d, k, lengths, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    params = [1 + 0.2 * f(d), 0.2 * f(d), f(d, 2 * d) / np.sqrt(d),
              0.2 * f(2 * d), 0.3 * f(k, d), 0.2 * f(d), 1 + 0.2 * f(d),
              0.2 * f(d), f(d, d) / np.sqrt(d), 0.2 * f(d)]
    return f(b, t, d), mask, params


@pytest.mark.parametrize("d,k", [(128, 31), (144, 31), (128, 7), (144, 7)])
def test_conv_module_plain_matches_pallas_and_reference(d, k):
    """A ragged batch (13, 5 and 1 frames) whose T = 13 is not a multiple
    of 8 (the Pallas kernel pads it to 16), dropout 0.1 with the
    utterance-tiled hash; d 144 has no gate on this route."""
    x, mask, params = _module_inputs(3, 13, d, k, (13, 5, 1), d + k)
    jp = [jnp.asarray(a) for a in params]
    seed = jnp.asarray([SEED], jnp.int32)
    kw = dict(drop_rate=0.1, kernel_size=k)
    ct = np.random.RandomState(3).randn(*x.shape).astype(np.float32)
    ref = jcm.conv_module_reference(jnp.asarray(x), jnp.asarray(mask), *jp,
                                    seed, **kw)
    pal, pal_vjp = jax.vjp(lambda x_, *p: jcm.fused_conv_module(
        x_, jnp.asarray(mask), *p, seed, interpret=True, **kw),
        jnp.asarray(x), *jp)
    got, grads = _torch_grads(lambda x_, *p: tcm.conv_module_plain(
        x_, _t(mask), *p, SEED, **kw), [x] + params, ct)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(got, np.asarray(pal), rtol=OUT_TOL,
                               atol=OUT_TOL)
    # the frames past each length are computed, not zeroed (u is masked)
    assert np.abs(got[2, 1:] - x[2, 1:]).max() > 0
    names = "x ln1s ln1b w1 b1 dw db ln2s ln2b w2 b2".split()
    for name, g, pg in zip(names, grads, pal_vjp(jnp.asarray(ct))):
        assert _rel_l2(g, pg) <= GRAD_REL_L2, (name, _rel_l2(g, pg))


@pytest.mark.parametrize("rule", ["256-row tiles", "utterance tiles"])
@pytest.mark.parametrize("seed", [SEED, -5, 0])
def test_keep_masks_match_pallas_bit_for_bit(rule, seed):
    """The FFN kernels and the conv tail hash 256-row tiles of the
    flattened rows (tile id = row tile); the whole module hashes one tile
    per utterance (tile id = b, counter t * D + c over T padded to 8)."""
    q = quantize_rate(0.1)
    if rule == "256-row tiles":
        rows, cols = 300, 128
        want = np.concatenate([np.asarray(_keep_mask(
            (256, cols), jnp.int32(seed), jnp.int32(i), q)) for i in (0, 1)])
        got = keep_mask(rows, cols, seed, q).numpy()
        np.testing.assert_array_equal(got, want[:rows])
        return
    b, t, d = 3, 13, 144
    tp = 16
    want = np.stack([np.asarray(_keep_mask(
        (tp, d), jnp.int32(seed), jnp.int32(i), q))[:t] for i in range(b)])
    got = keep_mask(b * t, d, seed, q, tile_rows=t).numpy()
    np.testing.assert_array_equal(got.reshape(b, t, d), want)
    assert 0.05 < 1 - got.mean() < 0.15


def test_conv_ops_wrapper_rules():
    v = _glu_inputs(12, 128, 4)
    x, xr = _t(v["x"]).reshape(3, 4, 128), _t(v["xr"]).reshape(3, 4, 128)
    counts = (tglu.prenorm_glu.launches, tglu.postnorm_proj.launches,
              tcm.conv_module.launches)
    g = tglu.prenorm_glu(x, *(_t(v[k]) for k in ("lns", "lnb", "w1", "b1")))
    y = tglu.postnorm_proj(g, xr, *(_t(v[k]) for k in
                                    ("lns", "lnb", "w2", "b2")))
    assert g.shape == y.shape == (3, 4, 128)
    with pytest.raises(ValueError, match="seed"):
        tglu.postnorm_proj(g, xr, *(_t(v[k]) for k in
                                    ("lns", "lnb", "w2", "b2")),
                           drop_rate=0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        tglu.prenorm_glu(*(_t(v[k]).to("meta") for k in
                           ("x", "lns", "lnb", "w1", "b1")))
    xm, mask, params = _module_inputs(2, 5, 64, 3, (5, 2), 5)
    args = [_t(xm), _t(mask)] + [_t(p) for p in params]
    assert tcm.conv_module(*args, kernel_size=3).shape == (2, 5, 64)
    with pytest.raises(ValueError, match="odd"):
        tcm.conv_module(*args, kernel_size=4)
    with pytest.raises(ValueError, match="unsupported device"):
        tcm.conv_module(*(a.to("meta") for a in args), kernel_size=3)
    # the CPU takes the plain versions: no kernel launched
    assert (tglu.prenorm_glu.launches, tglu.postnorm_proj.launches,
            tcm.conv_module.launches) == counts


# ---------------------------------------------------------------------------
# the block: JAX ConformerBlock with a route against the port's
# ---------------------------------------------------------------------------

class _NoDrop(fnn.Module):
    """FastDropout's signature, the identity (the JAX block's other
    dropouts draw from jax.random, which the port cannot reproduce)."""

    rate: float
    rng_collection: str = "dropout"

    def __call__(self, x, deterministic: bool = True):
        return x


def _inject_jax_seed(monkeypatch):
    """Only the conv route's hash dropout stays on, with seed SEED."""
    monkeypatch.setattr(jconformer, "FastDropout", _NoDrop)
    monkeypatch.setattr(jtransformer, "FastDropout", _NoDrop)
    seed = jnp.asarray([SEED], jnp.int32)
    tail, whole = jglu.fused_postnorm_proj, jcm.fused_conv_module

    def tail_seeded(*a, **kw):
        return tail(*a[:6], seed, **kw)

    def whole_seeded(*a, **kw):
        return whole(*a[:12], seed, **kw)

    monkeypatch.setattr(jglu, "fused_postnorm_proj", tail_seeded)
    monkeypatch.setattr(jcm, "fused_conv_module", whole_seeded)


def _inject_torch_seed(monkeypatch):
    monkeypatch.setattr(tdropout.FastDropout, "forward",
                        lambda self, x, generator=None: x)
    ffn = tconformer.prenorm_residual_ffn
    monkeypatch.setattr(tconformer, "prenorm_residual_ffn",
                        lambda x, n, f, s, rate, g: ffn(x, n, f, s, 0.0, g))
    monkeypatch.setattr(tconformer, "draw_seeds", lambda g, n: [SEED] * n)


BLOCK = dict(d_model=128, num_heads=2, d_ff=256, kernel_size=7)


@pytest.mark.parametrize("route", ["split", "module"])
@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_block_route_matches_jax_block(monkeypatch, route, drop):
    """B = 2 x T = 130 frames (260 rows: the JAX split gate needs 256), one
    utterance 77 frames long. The JAX block runs its Pallas kernels in
    interpret mode; the port's block its plain versions."""
    if drop:
        _inject_jax_seed(monkeypatch)
        _inject_torch_seed(monkeypatch)
    fields = ({"fused_conv_split": True} if route == "split"
              else {"fused_conv": True})
    b, t, d = 2, 130, BLOCK["d_model"]
    rng = np.random.RandomState(7)
    x = rng.randn(b, t, d).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([t, 77])[:, None]
    ct = rng.randn(b, t, d).astype(np.float32)
    jblock = jconformer.ConformerBlock(
        BLOCK["d_model"], BLOCK["num_heads"], BLOCK["d_ff"],
        BLOCK["kernel_size"], dropout_rate=drop, **fields)
    pos = jrelpos(t, d, jnp.float32)
    jmask = jnp.asarray(mask)
    bias = jbias(jmask[:, None, None, :])
    key = jax.random.PRNGKey(0)
    params = fnn.meta.unbox(jblock.init(
        {"params": key, "dropout": key}, jnp.asarray(x), pos, bias, jmask,
        True)["params"])
    prng = np.random.RandomState(8)  # exercise zero-initialised leaves
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * prng.randn(*a.shape).astype(
            np.float32), params)

    def jf(p, x_):
        return jblock.apply({"params": p}, x_, pos, bias, jmask, drop == 0.0,
                            rngs={"dropout": key})

    jout, jvjp = jax.vjp(jf, params, jnp.asarray(x))
    jgp, jgx = jvjp(jnp.asarray(ct))

    tblock = tconformer.ConformerBlock(
        BLOCK["d_model"], BLOCK["num_heads"], BLOCK["d_ff"],
        BLOCK["kernel_size"], dropout_rate=drop, **fields)
    tblock.load_state_dict(jax_params_to_state_dict(params))
    tblock.train(drop > 0.0)
    tx = _t(x).requires_grad_(True)
    tout = tblock(tx, rel_position_encoding(t, d, torch.float32),
                  attention_bias(_t(mask)[:, None, None, :]), _t(mask),
                  torch.Generator().manual_seed(0) if drop else None)
    tout.backward(_t(ct))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=OUT_TOL, atol=OUT_TOL)
    assert _rel_l2(tx.grad.numpy(), jgx) <= GRAD_REL_L2
    want = jax_params_to_state_dict(jgp)
    # each tensor's reference norm is floored at GRAD_FLOOR of the whole
    # gradient's: the key projection's bias gradient is 0 exactly (softmax
    # ignores a per-query constant) and holds only rounding noise
    total = np.sqrt(sum(float((w.double() ** 2).sum())
                        for w in want.values()))
    for name, prm in tblock.named_parameters():
        got, ref = prm.grad.double().numpy(), want[name].double().numpy()
        err = np.linalg.norm(got - ref) / max(np.linalg.norm(ref),
                                              GRAD_FLOOR * total)
        assert err <= GRAD_REL_L2, (name, err)


# ---------------------------------------------------------------------------
# the slice: a reduced ASR model with each route against JAX's plain route
# ---------------------------------------------------------------------------

KEYS = ("speech", "speech_lengths", "text", "text_lengths")
# float32, 2 + 2 layers over a log-mel frontend, summed in another order
# (the tolerances of tests/test_torch_encoders.py's slices)
ENC_TOL, LOSS_TOL, MODEL_GRAD_TOL = 1e-4, 1e-4, 5e-4


@pytest.fixture(scope="module")
def jax_slice():
    kw = dict(vocab_size=64, d_model=128, num_heads=2, d_ff=256,
              num_encoder_layers=2, num_decoder_layers=2, decoder_d_ff=128,
              conformer_kernel_size=7, ctc_weight=0.3, lsm_weight=0.1,
              dropout_rate=0.0, use_specaug=False,
              normalize="utterance_mvn", encoder_type="conformer")
    jcfg = _flagship_config(vocab=64, **{k: v for k, v in kw.items()
                                         if k != "vocab_size"})
    rng = np.random.RandomState(0)
    n = 8000
    lens = np.array([n, 5000], np.int32)
    speech = (0.1 * rng.randn(2, n)).astype(np.float32)
    speech[np.arange(n)[None] >= lens[:, None]] = 0.0
    text = rng.randint(1, 63, (2, 5)).astype(np.int32)
    tlens = np.array([5, 3], np.int32)
    text[np.arange(5)[None] >= tlens[:, None]] = 0
    batch = {"speech": speech, "speech_lengths": lens, "text": text,
             "text_lengths": tlens}
    jm = JASRModel(jcfg)
    jb = tuple(jnp.asarray(batch[k]) for k in KEYS)
    v = fnn.meta.unbox(jax.jit(jm.init, static_argnums=(5,))(
        jax.random.PRNGKey(0), *jb, True))
    prng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * prng.randn(*a.shape).astype(
            np.float32), v["params"])
    je, _ = jax.jit(lambda p, s, sl: jm.apply(
        {"params": p}, s, sl, method=JASRModel.encode))(params, *jb[:2])
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, *jb, True), has_aux=True))(params)
    return (ASRConfig(**kw), batch, params, np.asarray(je), float(jloss),
            jax_params_to_state_dict(jgrads))


@pytest.mark.parametrize("options", [{"fused_conv_split": True},
                                     {"fused_conv": True}])
def test_slice_route_matches_jax_plain_route(jax_slice, options):
    """The JAX encoder cannot select a route, so its plain route is the
    reference: the port's model with each route, on the same converted
    parameters (the routes share the plain route's parameter tree), gives
    JAX's encode, loss and every gradient."""
    tcfg, batch, params, je, jloss, jgrads = jax_slice
    tm = load_jax_params(ASRModel(tcfg, options), params)
    assert all(layer.fused_conv_split is options.get("fused_conv_split")
               and layer.fused_conv is options.get("fused_conv")
               for layer in tm.encoder.layers())
    with torch.no_grad():
        te, _ = tm.eval().encode(_t(batch["speech"]),
                                 _t(batch["speech_lengths"]))
    np.testing.assert_allclose(te.numpy(), je, atol=ENC_TOL, rtol=ENC_TOL)
    loss, _ = tm.train()(*(_t(batch[k]) for k in KEYS))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=LOSS_TOL)
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(jgrads)
    for name, g in got.items():
        w = jgrads[name].numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=MODEL_GRAD_TOL,
            atol=MODEL_GRAD_TOL * max(1.0, np.abs(w).max()), err_msg=name)


# ---------------------------------------------------------------------------
# which route, and which wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused_conv,split,env,device,d,want", [
    (None, None, "0", "cuda", 256, "plain"),       # the default, as JAX
    (None, None, "1", "cuda", 256, "split"),       # JAX's auto on its card
    (None, None, "1", "cpu", 256, "plain"),        # ... and off elsewhere
    (None, True, "0", "cpu", 256, "split"),
    (True, True, "0", "cpu", 256, "module"),       # the whole module wins
    (True, None, "1", "cuda", 256, "module"),
    (None, True, "0", "cpu", 144, "plain"),        # the split gate
    (True, None, "0", "cpu", 144, "module"),       # no gate on this route
    (False, False, "1", "cuda", 256, "plain"),
])
def test_conv_route_follows_the_jax_fields(monkeypatch, fused_conv, split,
                                           env, device, d, want):
    monkeypatch.setenv("ESPNET_TPU_CONV_SPLIT", env)
    x = types.SimpleNamespace(device=torch.device(device))
    assert tconformer.conv_route(fused_conv, split, x, d) == want


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("options,d,use_kernels,want", [
    ({"fused_conv_split": True}, 128, True, {"prenorm_glu", "postnorm_proj"}),
    ({"fused_conv_split": True}, 128, False,
     {"prenorm_glu", "postnorm_proj"}),
    ({"fused_conv_split": True}, 144, True, set()),  # the gate: plain route
    ({"fused_conv": True}, 144, True, {"conv_module"}),
    ({"fused_conv": True}, 128, False, {"conv_module"}),
    ({"fused_conv": True, "fused_conv_split": True}, 128, True,
     {"conv_module"}),
    ({}, 128, True, set()),
])
def test_routes_call_their_wrappers(monkeypatch, options, d, use_kernels,
                                    want):
    """Which conv wrappers an encode calls: the route's kernel entry points
    `want` (each then takes its plain version on the CPU), or with
    set_use_kernels(False) their plain versions alone, through the conv
    module's one switch."""
    calls = []
    for module, name in ((tglu, "prenorm_glu"), (tglu, "postnorm_proj"),
                         (tglu, "prenorm_glu_plain"),
                         (tglu, "postnorm_proj_plain"),
                         (tcm, "conv_module"), (tcm, "conv_module_plain")):
        _spy(monkeypatch, module, name, calls)
    cfg = ASRConfig(vocab_size=20, d_model=d, num_heads=4, d_ff=2 * d,
                    num_encoder_layers=1, num_decoder_layers=1,
                    decoder_d_ff=64, conformer_kernel_size=5,
                    normalize="utterance_mvn")
    model = ASRModel(cfg, options)
    model.set_use_kernels(use_kernels)
    with torch.no_grad():
        model.encode(torch.zeros(1, 4000) + 0.1, torch.tensor([4000]))
    entries = {c for c in calls if not c.endswith("_plain")}
    assert entries == (want if use_kernels else set())
    assert {c for c in calls if c.endswith("_plain")} == {
        w + "_plain" for w in want}


def test_route_configurations_are_the_bench_conformer():
    """The two named route configurations are bench.py's conformer with the
    JAX fields set, and reach the model as encoder options."""
    from espnet_tpu_torch.configs import bench_config, encoder_options

    base = bench_config(torch.bfloat16)
    for name, field in (("conformer_conv_split", "fused_conv_split"),
                        ("conformer_conv_module", "fused_conv")):
        assert bench_config(torch.bfloat16, name) == base
        assert encoder_options(name) == {field: True}
    assert encoder_options("conformer") == {}
    small = dataclasses.replace(base, num_encoder_layers=1, d_model=128,
                                num_heads=2, d_ff=256, num_decoder_layers=1,
                                vocab_size=20, dtype=torch.float32)
    layer = ASRModel(small, encoder_options("conformer_conv_module")) \
        .encoder.layers()[0]
    assert layer.fused_conv is True and layer.fused_conv_split is None
