"""The rest of the ASR model against the JAX package, on the CPU, float32,
at a reduced size (2 encoder layers, d_model 32, 2 heads): InterCTC on the
conformer and the transformer, CTC-only and attention-only models, remat
with dropout on (and a mutation that must fail it), the feats,
sliding_window and fused frontends, the stacked scan layout of the
converter, greedy CTC decoding and Speech2Text's refusals. Seeded numpy
inputs go through both packages; JAX's perturbed parameters are carried into
the port."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from __graft_entry__ import _flagship_config
from espnet_tpu.decode.asr_inference import Speech2Text as JSpeech2Text
from espnet_tpu.decode.ctc_greedy import ctc_greedy_decode as jctc_greedy
from espnet_tpu.models.asr import ASRModel as JASRModel
from espnet_tpu.train.collect_stats import collect_stats as jcollect_stats
from espnet_tpu_torch.convert import (jax_params_to_state_dict,
                                      load_jax_params, model_params)
from espnet_tpu_torch.decode.asr_inference import Speech2Text
from espnet_tpu_torch.decode.ctc_greedy import ctc_greedy_decode
from espnet_tpu_torch.models import remat
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel, init_random_
from espnet_tpu_torch.train import msgpack_io
from espnet_tpu_torch.train.collect_stats import collect_stats


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

KEYS = ("speech", "speech_lengths", "text", "text_lengths")
# float32, 2 layers: the loss and its stats, and each gradient tensor
# (relative L2, its norm floored at 1e-3 of the whole gradient's)
RTOL = 1e-5
ENC_ATOL = 1e-4
SCAN_ATOL = 1e-5
REMAT_REL_L2 = 1e-6
SMALL = dict(d_model=32, num_heads=2, d_ff=64, num_encoder_layers=2,
             num_decoder_layers=1, decoder_d_ff=64, conformer_kernel_size=5,
             n_mels=16, dropout_rate=0.0, use_specaug=False,
             normalize="utterance_mvn", lsm_weight=0.1)


def _configs(**kw):
    kw = {**SMALL, **kw}
    return _flagship_config(vocab=20, **kw), ASRConfig(vocab_size=20, **kw)


def _batch(n=8000, seed=0):
    rng = np.random.RandomState(seed)
    lens = np.array([n, int(n * 0.7)], np.int32)
    speech = (0.1 * rng.randn(2, n)).astype(np.float32)
    speech[np.arange(n)[None] >= lens[:, None]] = 0.0
    text = rng.randint(1, 19, (2, 5)).astype(np.int32)
    tlens = np.array([5, 3], np.int32)
    text[np.arange(5)[None] >= tlens[:, None]] = 0
    return {"speech": speech, "speech_lengths": lens, "text": text,
            "text_lengths": tlens}


def _jax_params(jm, batch, seed=1, extra=None):
    jb = tuple(jnp.asarray(batch[k]) for k in KEYS)
    v = fnn.meta.unbox(jm.init(jax.random.PRNGKey(0), *jb, True))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a)
        + 0.05 * rng.randn(*a.shape).astype(np.float32), v["params"])
    return params, {k: jax.tree_util.tree_map(np.asarray, x)
                    for k, x in v.items() if k != "params"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_l2(got, want, floor):
    return float(np.linalg.norm(got - want)
                 / max(float(np.linalg.norm(want)), floor))


def _loss_stats_grads(jcfg, tcfg, batch):
    """(JAX (loss, stats, grads as port names), port model after backward,
    port (loss, stats))."""
    jm = JASRModel(jcfg)
    params, _ = _jax_params(jm, batch)
    jb = tuple(jnp.asarray(batch[k]) for k in KEYS)
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, *jb, True), has_aux=True))(params)
    tm = load_jax_params(ASRModel(tcfg), params).train()
    tloss, tstats = tm(*(_t(batch[k]) for k in KEYS))
    tloss.backward()
    return ((float(jloss), {k: float(v) for k, v in jstats.items()},
             jax_params_to_state_dict(jgrads), params),
            tm, (float(tloss.detach()),
                 {k: float(v.detach()) for k, v in tstats.items()}))


def _assert_grads(tm, want):
    got = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    total = float(np.sqrt(sum((w.numpy().astype(np.float64) ** 2).sum()
                              for w in want.values())))
    for name, g in got.items():
        dev = _rel_l2(g, want[name].numpy(), 1e-3 * total)
        assert dev <= RTOL, f"{name}: relative L2 {dev:.2e}"


# ------------------------------------------------------------------ InterCTC

@pytest.mark.parametrize("encoder_type,layers", [
    ("conformer", (1,)), ("transformer", (1, 2))])
def test_interctc_loss_stats_and_gradients_match_jax(encoder_type, layers):
    """The transformer's layer 2 is its last: its InterCTC input is the
    block output before the final LayerNorm, as in JAX."""
    jcfg, tcfg = _configs(encoder_type=encoder_type,
                          interctc_layer_idx=layers, interctc_weight=0.3)
    (jloss, jstats, jgrads, _), tm, (tloss, tstats) = _loss_stats_grads(
        jcfg, tcfg, _batch())
    assert set(tstats) == set(jstats)
    assert {f"loss_interctc_layer{i}" for i in layers} < set(tstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(tstats[k], v, rtol=RTOL, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL)
    _assert_grads(tm, jgrads)


@pytest.mark.parametrize("kw", [
    dict(encoder_type="branchformer"), dict(encoder_type="e_branchformer"),
    dict(encoder_type="conformer", scan_encoder_layers=True)])
def test_interctc_refusals_match_jax(kw):
    jcfg, tcfg = _configs(interctc_layer_idx=(1,), interctc_weight=0.3,
                          **kw)
    batch = _batch()
    with pytest.raises(ValueError):
        _jax_params(JASRModel(jcfg), batch)
    with pytest.raises(ValueError):
        ASRModel(tcfg)


# ------------------------------------------------ CTC-only, attention-only

@pytest.mark.parametrize("ctc_weight", [0.0, 1.0])
def test_single_branch_models_match_jax(ctc_weight):
    """The loss and its stats (only the branch's) and the converted tree's
    leaves, exactly JAX's."""
    jcfg, tcfg = _configs(ctc_weight=ctc_weight)
    batch = _batch()
    jm = JASRModel(jcfg)
    params, _ = _jax_params(jm, batch)
    jloss, jstats = jm.apply({"params": params},
                             *(jnp.asarray(batch[k]) for k in KEYS), True)
    tm = load_jax_params(ASRModel(tcfg), params).train()
    with torch.no_grad():
        tloss, tstats = tm(*(_t(batch[k]) for k in KEYS))
    assert set(tstats) == set(jstats)
    assert ("acc" in tstats) == (ctc_weight < 1.0)
    assert ("ctc_infeasible" in tstats) == (ctc_weight > 0.0)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(tstats[k]), float(v), rtol=RTOL,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    # a fresh port model's converted tree has exactly JAX's leaves
    fresh = msgpack_io.flatten(model_params(ASRModel(tcfg)))
    want = msgpack_io.flatten(params)
    assert set(fresh) == set(want)
    assert all(fresh[k].shape == want[k].shape for k in want)
    assert (tm.decoder is None) == (ctc_weight == 1.0)
    assert (tm.ctc_head is None) == (ctc_weight == 0.0)


def test_ctc_weight_outside_unit_interval_raises():
    with pytest.raises(ValueError, match="ctc_weight"):
        ASRModel(_configs(ctc_weight=1.5)[1])


@pytest.mark.parametrize("layers", [("1",), (0,), (3,)])
def test_interctc_layers_must_be_layer_numbers(layers):
    """The CLI's "1" (no comma) is the string '1', which the JAX model
    silently ignores; the port says so."""
    with pytest.raises(ValueError, match="layer numbers"):
        ASRModel(_configs(interctc_layer_idx=layers,
                          interctc_weight=0.3)[1])


def test_speech2text_refuses_what_jax_fails_on():
    batch = _batch()
    for ctc_weight, cases in ((1.0, ((0.3, "no attention decoder"),
                                     (0.0, "no attention decoder"))),
                              (0.0, ((0.3, "needs a CTC head"),))):
        jcfg, tcfg = _configs(ctc_weight=ctc_weight)
        jm = JASRModel(jcfg)
        params, _ = _jax_params(jm, batch)
        tm = load_jax_params(ASRModel(tcfg), params)
        for s2t_weight, match in cases:
            with pytest.raises(AttributeError):
                JSpeech2Text(jm, params, beam_size=2, ctc_weight=s2t_weight,
                             max_steps=3)(batch["speech"],
                                          batch["speech_lengths"])
            with pytest.raises(ValueError, match=match):
                Speech2Text(tm, device="cpu", ctc_weight=s2t_weight)
    # an attention-only model decodes with ctc_weight 0
    tm = init_random_(ASRModel(_configs(ctc_weight=0.0)[1]),
                      torch.Generator().manual_seed(0))
    out = Speech2Text(tm, device="cpu", beam_size=2, ctc_weight=0.0,
                      max_steps=3)(batch["speech"], batch["speech_lengths"])
    assert len(out) == 2


def test_ctc_greedy_decode_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(4, 30, 7).astype(np.float32)
    logits[:, :, 0] += 1.0  # blanks between the runs
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lengths = np.array([30, 17, 1, 0], np.int32)
    want = jctc_greedy(jnp.asarray(lp), jnp.asarray(lengths))
    assert ctc_greedy_decode(torch.from_numpy(lp), lengths) == want
    assert ctc_greedy_decode(lp, torch.from_numpy(lengths)) == want
    assert any(len(w) > 1 for w in want)


# ---------------------------------------------------------------------- remat

def _train_grads(tcfg, options, state, seed):
    model = ASRModel(tcfg, options)
    model.load_state_dict(state)
    model.train()
    gen = torch.Generator().manual_seed(seed)
    batch = _batch()
    loss, _ = model(*(_t(batch[k]) for k in KEYS), generator=gen)
    loss.backward()
    return (float(loss.detach()),
            {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
            gen.get_state())


def _check_remat(encoder_type, options):
    """One training forward and backward with dropout 0.1 and SpecAug on,
    with remat and without, from the same parameters and generator state:
    the same loss and gradients, and the generator left in the same
    state."""
    kw = dict(encoder_type=encoder_type, dropout_rate=0.1, use_specaug=True)
    tcfg = _configs(**kw)[1]
    state = init_random_(ASRModel(tcfg, options),
                         torch.Generator().manual_seed(0)).state_dict()
    lp, gp, sp = _train_grads(tcfg, options, state, 5)
    lr, gr, sr = _train_grads(_configs(remat_encoder=True, **kw)[1], options,
                              state, 5)
    assert lr == lp
    total = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                              for g in gp.values())))
    for name, g in gp.items():
        dev = _rel_l2(gr[name], g, 1e-3 * total)
        assert dev <= REMAT_REL_L2, f"{name}: relative L2 {dev:.2e}"
    assert torch.equal(sr, sp), "remat moved the generator elsewhere"


@pytest.mark.parametrize("encoder_type,options", [
    ("conformer", {}), ("conformer", {"fused_conv": True}),
    ("transformer", {})])
def test_remat_gives_the_plain_step_with_dropout_on(encoder_type, options):
    _check_remat(encoder_type, options)


def test_remat_that_draws_seeds_inside_the_checkpoint_fails(monkeypatch):
    """Mutation: the checkpointed block draws from the caller's generator,
    so the recompute draws fresh seeds (other dropout masks in the backward
    pass, a generator moved twice)."""
    def naive(block, generator, *args):
        return torch.utils.checkpoint.checkpoint(block, *args, generator,
                                                 use_reentrant=False)

    monkeypatch.setattr(remat, "checkpoint_block", naive)
    with pytest.raises(AssertionError):
        _check_remat("conformer", {})


def test_remat_is_inert_for_branchformers():
    tcfg = _configs(encoder_type="e_branchformer", remat_encoder=True)[1]
    assert ASRModel(tcfg).encoder is not None


# ----------------------------------------------------------------- frontends

FRONTENDS = {
    "feats": {"input_type": "feats"},
    "sliding_window": {"input_type": "sliding_window", "hop_length": 160},
    "fused": {"input_type": "fused", "n_fft": 512, "fused_n_fft2": 1024,
              "hop_length": 160},
}


@pytest.mark.parametrize("normalize", ["global_mvn", "utterance_mvn"])
@pytest.mark.parametrize("frontend", sorted(FRONTENDS))
def test_frontend_encoder_output_matches_jax(frontend, normalize):
    jcfg, tcfg = _configs(normalize=normalize, **FRONTENDS[frontend])
    batch = _batch()
    if frontend == "feats":
        rng = np.random.RandomState(4)
        batch["speech"] = rng.randn(2, 60, 16).astype(np.float32)
        batch["speech_lengths"] = np.array([60, 41], np.int32)
    jm = JASRModel(jcfg)
    params, extra = _jax_params(jm, batch)
    variables = {"params": params}
    dim = {"feats": 16, "sliding_window": 400, "fused": 32}[frontend]
    if normalize == "global_mvn":
        rng = np.random.RandomState(5)
        mvn = {"mvn": {"mean": rng.randn(dim).astype(np.float32),
                       "inv_std": rng.rand(dim).astype(np.float32) + 0.5}}
        assert extra["mvn"]["mvn"]["mean"].shape == (dim,)
        variables["mvn"] = mvn
    je, jl = jm.apply(variables, jnp.asarray(batch["speech"]),
                      jnp.asarray(batch["speech_lengths"]),
                      method=JASRModel.encode)
    tm = load_jax_params(ASRModel(tcfg), variables).eval()
    # the encoder's input width is the frontend's
    assert tm.encoder.embed.out.in_features == 32 * (((dim - 1) // 2 - 1)
                                                     // 2)
    with torch.no_grad():
        te, tl = tm.encode(_t(batch["speech"]), _t(batch["speech_lengths"]))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=ENC_ATOL,
                               rtol=ENC_ATOL)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 4-utterance synthetic corpus, its dataset as waveforms and as
    80-dim log-mel features in a Kaldi feats.scp, and one batch of each."""
    from espnet_tpu_torch.data.dataset import ASRDataset
    from espnet_tpu_torch.data.fileio import read_2column_text, read_wav
    from espnet_tpu_torch.data.kaldi_io import write_kaldi_ark_scp
    from espnet_tpu_torch.data.sampler import build_batches
    from espnet_tpu_torch.data.synth import generate_corpus
    from espnet_tpu_torch.data.tokenizer import (TokenIDConverter,
                                                 build_token_list,
                                                 build_tokenizer)
    from espnet_tpu_torch.ops.stft import log_mel_spectrogram

    root = tmp_path_factory.mktemp("variants_corpus")
    generate_corpus(root / "wav", n_utts=4, seed=0)
    wavs = read_2column_text(root / "wav" / "wav.scp")
    mats = {}
    for key, path in wavs.items():
        wav, _ = read_wav(path)
        f, n = log_mel_spectrogram(torch.from_numpy(wav)[None],
                                   torch.tensor([len(wav)]))
        mats[key] = f[0, :int(n[0])].numpy()
    (root / "feats").mkdir()
    write_kaldi_ark_scp(mats, root / "feats" / "feats.ark",
                        root / "feats" / "feats.scp")
    (root / "feats" / "text").write_text((root / "wav" / "text").read_text())
    tok = build_tokenizer("char")
    conv = TokenIDConverter(build_token_list(
        read_2column_text(root / "wav" / "text").values(), tok))
    out = {}
    for kind, scp in (("wav", "wav_scp"), ("feats", "feats_scp")):
        ds = ASRDataset(text=root / kind / "text", tokenizer=tok,
                        converter=conv,
                        **{scp: root / kind / f"{kind}.scp"})
        batches = build_batches({"speech": ds.speech_lengths(),
                                 "text": ds.text_lengths()}, batch_size=4,
                                length_quantum=1, text_quantum=1)
        out[kind] = (ds, batches)
    return root, out


def test_collect_stats_as_jax_takes_non_raw_input_types(corpus, tmp_path):
    """Every input_type but raw counts as precomputed features in both
    packages' collect-stats: feats gives JAX's stats, and the waveforms of
    sliding_window and fused make both passes fail."""
    _, data = corpus
    ds, batches = data["feats"]
    want = jcollect_stats(ds, batches, tmp_path / "j", input_type="feats")
    got = collect_stats(ds, batches, tmp_path / "t", input_type="feats",
                        device="cpu")
    for k in ("count", "sum", "sum_square"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert got["sum"].shape == (80,)
    ds, batches = data["wav"]
    for input_type in ("sliding_window", "fused"):
        with pytest.raises(ValueError):
            jcollect_stats(ds, batches, tmp_path / "j2",
                           input_type=input_type)
        with pytest.raises(ValueError, match="precomputed features"):
            collect_stats(ds, batches, tmp_path / "t2",
                          input_type=input_type, device="cpu")


# --------------------------------------------------------------- scan layout

def test_scan_layout_converts_both_ways():
    jcfg, tcfg = _configs(scan_encoder_layers=True)
    batch = _batch()
    jm = JASRModel(jcfg)
    params, _ = _jax_params(jm, batch)
    block = params["encoder"]["block"]
    assert block["ff1"]["w1"]["kernel"].shape[0] == 2
    assert not any(k.startswith("layer") for k in params["encoder"])
    je, jl = jax.jit(lambda p, s, n: jm.apply({"params": p}, s, n,
                                              method=JASRModel.encode))(
        params, jnp.asarray(batch["speech"]),
        jnp.asarray(batch["speech_lengths"]))
    tm = load_jax_params(ASRModel(tcfg), params).eval()
    with torch.no_grad():
        te, tl = tm.encode(_t(batch["speech"]), _t(batch["speech_lengths"]))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=SCAN_ATOL,
                               rtol=SCAN_ATOL)

    def same_order(tree, like):
        if isinstance(like, dict):
            return {k: same_order(tree[k], like[k]) for k in like}
        return tree

    back = model_params(tm)
    assert msgpack_io.to_bytes(same_order(back, params)) == \
        serialization.to_bytes(params)


@pytest.mark.parametrize("encoder_type", ["transformer", "e_branchformer"])
def test_scan_flag_leaves_other_encoders_unrolled(encoder_type):
    """scan_encoder_layers reaches only the conformer in JAX: the other
    encoders keep `encoder/layer{i}`, and the port writes that tree."""
    jcfg, tcfg = _configs(encoder_type=encoder_type,
                          scan_encoder_layers=True)
    params, _ = _jax_params(JASRModel(jcfg), _batch())
    assert "block" not in params["encoder"]
    assert "layer1" in params["encoder"]
    back = model_params(load_jax_params(ASRModel(tcfg), params))
    want = msgpack_io.flatten(params)
    got = msgpack_io.flatten(back)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
