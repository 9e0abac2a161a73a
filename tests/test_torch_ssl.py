"""The port's SSL and Whisper models (`models/ssl.py`), their HF converters
(`train/hf_import.py`) and the ASR model's SSL and Whisper parts against
the JAX package's, float32 on the CPU.

Each module of `models/ssl.py` takes the JAX module's own parameters and
the same seeded numpy inputs: the conv extractor with both norms, the
trunk post-LN and stable-LN with an even `pos_conv` kernel, the S3PRL
featurizer (and that `freeze` leaves the trunk without gradients), the
wav2vec2 encoder with and without `output_layer`, the Whisper encoder, its
decoder (forward, and `score_step` against the teacher-forced logits) and
`whisper_log_mel`. The converters run on HF models that `transformers`
builds from tiny configs (wav2vec2 base-style and large-style, HuBERT,
Whisper): the port's trees equal JAX `hf_import`'s array for array. The
reduced ASR models (`input_type ssl` into a conformer, `encoder_type
wav2vec2`, Whisper's encoder and decoder; drawn by the port's initialiser
in JAX's layout and perturbed) give JAX's encoder output, loss, stats and
every gradient, and the search on them JAX's hypotheses. Then the port's
`.safetensors` reader against the `safetensors` package's files, and the
global-MVN statistics of both packages' collect-stats for Whisper and SSL
input.
"""

import dataclasses
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.decode.asr_inference import Speech2Text as JSpeech2Text
from espnet_tpu.models import asr as jasr
from espnet_tpu.models import ssl as jssl
from espnet_tpu.train import hf_import as jhf
from espnet_tpu_torch.convert import (jax_params_to_state_dict,
                                      load_jax_params, model_params,
                                      state_dict_to_jax_params)
from espnet_tpu_torch.decode.asr_inference import Speech2Text
from espnet_tpu_torch.models import asr as tasr
from espnet_tpu_torch.models import ssl as tssl
from espnet_tpu_torch.train import hf_import as thf

transformers = pytest.importorskip("transformers")

# float32 sums in another order (outputs, loss); gradients through one more
# pass, relative L2 per tensor with its norm floored at GRAD_FLOOR of the
# whole gradient's (the k_proj biases' gradients are 0 up to rounding:
# softmax ignores a per-query constant); the search's summed log-probs
OUT_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 5e-4
GRAD_FLOOR = 1e-3
SCORE_TOL = 1e-4

TINY_SSL = dict(hidden_size=16, num_layers=2, num_heads=2, ffn_size=32,
                conv_dim=(8, 8), conv_kernel=(10, 3), conv_stride=(5, 2),
                num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2)
TINY_WHISPER = dict(n_mels=8, d_model=16, encoder_layers=2,
                    decoder_layers=2, num_heads=2, ffn_size=32,
                    max_source_positions=64, max_target_positions=16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _waves(b=2, n=1600, lengths=(1600, 1200), seed=0):
    rng = np.random.RandomState(seed)
    wave = np.zeros((b, n), np.float32)
    for i, k in enumerate(lengths):
        wave[i, :k] = 0.1 * rng.randn(k)
    return wave, np.asarray(lengths, np.int32)


def _init(jmodule, *args, **kw):
    return fnn.meta.unbox(jmodule.init(jax.random.PRNGKey(0), *args,
                                       **kw))["params"]


def _load(module, params):
    module.load_state_dict(jax_params_to_state_dict(params))
    return module.eval()


def _close(got, want, tol=OUT_TOL, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=err_msg)


def _grads_match(model, jgrads):
    want = jax_params_to_state_dict(jgrads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    total = float(torch.sqrt(sum((w.double() ** 2).sum()
                                 for w in want.values())))
    for name, g in got.items():
        w = want[name].double()
        if g is None:  # a frozen trunk's: JAX's stop-gradient gives zeros
            assert float(w.abs().max()) == 0.0, name
            continue
        err = float((g.double() - w).norm()) / max(float(w.norm()),
                                                   GRAD_FLOOR * total)
        assert err <= GRAD_TOL, (name, err)


# --- modules -------------------------------------------------------------


@pytest.mark.parametrize("norm", ["group", "layer"])
def test_conv_extractor_matches_jax(norm):
    cfg = dict(TINY_SSL, feat_extract_norm=norm, conv_bias=norm == "layer")
    wave, _ = _waves()
    jm = jssl.ConvFeatureExtractor(jssl.SSLConfig(**cfg))
    params = _init(jm, jnp.asarray(wave))
    want = jm.apply({"params": params}, jnp.asarray(wave))
    m = _load(tssl.ConvFeatureExtractor(tssl.SSLConfig(**cfg)), params)
    _close(m(_t(wave)), want)


@pytest.mark.parametrize("stable", [False, True], ids=["post_ln",
                                                       "stable_ln"])
def test_trunk_matches_jax_with_an_even_pos_conv(stable):
    cfg = dict(TINY_SSL, do_stable_layer_norm=stable,
               feat_extract_norm="layer" if stable else "group")
    assert cfg["num_conv_pos_embeddings"] % 2 == 0
    wave, lens = _waves()
    jm = jssl.Wav2Vec2Model(jssl.SSLConfig(**cfg))
    params = _init(jm, jnp.asarray(wave), jnp.asarray(lens))
    states, olens = jm.apply({"params": params}, jnp.asarray(wave),
                             jnp.asarray(lens))
    m = _load(tssl.Wav2Vec2Model(tssl.SSLConfig(**cfg)), params)
    got, got_lens = m(_t(wave), _t(lens))
    assert got_lens.tolist() == np.asarray(olens).tolist()
    assert len(got) == states.shape[0] == cfg["num_layers"] + 1
    for i, s in enumerate(got):
        _close(s, states[i], err_msg=f"hidden state {i}")


def test_featurizer_matches_jax_and_freeze_leaves_no_trunk_gradient():
    wave, lens = _waves()
    jm = jssl.SSLFrontend(jssl.SSLConfig(**TINY_SSL), freeze=True)
    params = _init(jm, jnp.asarray(wave), jnp.asarray(lens))
    params["layer_weights"] = np.linspace(-1, 1, 3).astype(np.float32)
    feats, olens = jm.apply({"params": params}, jnp.asarray(wave),
                            jnp.asarray(lens))
    m = _load(tssl.SSLFrontend(tssl.SSLConfig(**TINY_SSL), freeze=True),
              params)
    got, got_lens = m(_t(wave), _t(lens))
    _close(got, feats)
    assert got_lens.tolist() == np.asarray(olens).tolist()
    (got ** 2).sum().backward()
    assert all(p.grad is None for p in m.upstream.parameters())
    assert float(m.layer_weights.grad.abs().sum()) > 0


@pytest.mark.parametrize("output_size", [16, 24],
                         ids=["no_output_layer", "output_layer"])
def test_wav2vec2_encoder_matches_jax(output_size):
    wave, lens = _waves()
    jm = jssl.Wav2Vec2ASREncoder(jssl.SSLConfig(**TINY_SSL), output_size)
    params = _init(jm, jnp.asarray(wave), jnp.asarray(lens))
    assert ("output_layer" in params) == (output_size != 16)
    out, olens = jm.apply({"params": params}, jnp.asarray(wave),
                          jnp.asarray(lens))
    m = _load(tssl.Wav2Vec2ASREncoder(tssl.SSLConfig(**TINY_SSL),
                                      output_size), params)
    got, got_lens = m(_t(wave), _t(lens))
    _close(got, out)
    assert got_lens.tolist() == np.asarray(olens).tolist()


@pytest.fixture(scope="module")
def whisper_pair():
    cfg = jssl.WhisperConfig(**TINY_WHISPER)
    rng = np.random.RandomState(1)
    b, t_mel, u = 2, 40, 6
    mel = rng.randn(b, t_mel, cfg.n_mels).astype(np.float32)
    mel_lens = np.array([40, 27], np.int32)
    tokens = rng.randint(0, 100, (b, u)).astype(np.int32)
    tok_lens = np.array([6, 4], np.int32)
    enc = jssl.WhisperEncoder(cfg)
    eparams = _init(enc, jnp.asarray(mel), jnp.asarray(mel_lens))
    memory, mlens = enc.apply({"params": eparams}, jnp.asarray(mel),
                              jnp.asarray(mel_lens))
    dec = jssl.WhisperDecoder(cfg)
    dparams = _init(dec, jnp.asarray(tokens), jnp.asarray(tok_lens), memory,
                    mlens)
    logits = dec.apply({"params": dparams}, jnp.asarray(tokens),
                       jnp.asarray(tok_lens), memory, mlens)
    return (mel, mel_lens, tokens, tok_lens, eparams, dparams,
            (memory, mlens, logits))


def test_whisper_encoder_and_decoder_match_jax(whisper_pair):
    mel, mel_lens, tokens, tok_lens, eparams, dparams, want = whisper_pair
    memory, mlens, logits = want
    tcfg = tssl.WhisperConfig(**TINY_WHISPER)
    enc = _load(tssl.WhisperEncoder(tcfg), eparams)
    got, got_lens = enc(_t(mel), _t(mel_lens))
    _close(got, memory)
    assert got_lens.tolist() == np.asarray(mlens).tolist() == [20, 14]
    dec = _load(tssl.WhisperDecoder(tcfg), dparams)
    _close(dec(_t(tokens), _t(tok_lens), _t(memory), _t(mlens)), logits)


def test_whisper_score_step_matches_teacher_forced_logits(whisper_pair):
    _, _, tokens, _, _, dparams, (memory, mlens, logits) = whisper_pair
    b, u = tokens.shape
    dec = _load(tssl.WhisperDecoder(tssl.WhisperConfig(**TINY_WHISPER)),
                dparams)
    full = torch.log_softmax(dec(_t(tokens), torch.full((b,), u),
                                 _t(memory), _t(mlens)), -1)
    cache = dec.init_cache(b, u)
    steps = []
    with torch.no_grad():
        for pos in range(u):
            lp, cache = dec.score_step(_t(tokens[:, pos]), pos, _t(memory),
                                       _t(mlens), cache)
            steps.append(lp)
    _close(torch.stack(steps, 1), full.detach(), 1e-4)
    # and JAX's own step at the last position
    jdec = jssl.WhisperDecoder(jssl.WhisperConfig(**TINY_WHISPER))
    jcache = jdec.apply({"params": dparams}, b, u,
                        method=jssl.WhisperDecoder.init_cache)
    for pos in range(u):
        jlp, jcache = jdec.apply({"params": dparams},
                                 jnp.asarray(tokens[:, pos]), pos, memory,
                                 mlens, jcache,
                                 method=jssl.WhisperDecoder.score_step)
    _close(steps[-1], jlp, 1e-4)
    with pytest.raises(ValueError, match="max_target_positions"):
        dec.score_step(_t(tokens[:, 0]), 16, _t(memory), _t(mlens),
                       dec.init_cache(b, 17))


def test_whisper_log_mel_matches_jax():
    wave, lens = _waves(n=5000, lengths=(5000, 3210), seed=3)
    feats, flens = jssl.whisper_log_mel(jnp.asarray(wave), jnp.asarray(lens),
                                        n_mels=16)
    got, got_lens = tssl.whisper_log_mel(_t(wave), _t(lens), n_mels=16)
    assert got.shape == feats.shape == (2, 31, 16)
    assert got_lens.tolist() == np.asarray(flens).tolist() == [31, 21]
    _close(got, feats, 1e-5)


# --- converters ------------------------------------------------------------


def _tiny_hf(**over):
    kw = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=64, conv_dim=(16, 16, 16),
              conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
              num_feat_extract_layers=3, num_conv_pos_embeddings=16,
              num_conv_pos_embedding_groups=4, hidden_dropout=0.0,
              attention_dropout=0.0, activation_dropout=0.0,
              feat_proj_dropout=0.0, layerdrop=0.0, vocab_size=30)
    kw.update(over)
    return kw


def _hf_model(kind):
    torch.manual_seed(11)
    if kind == "wav2vec2_base":
        cfg = transformers.Wav2Vec2Config(**_tiny_hf())
        return transformers.Wav2Vec2Model(cfg).eval(), cfg
    if kind == "wav2vec2_large":
        cfg = transformers.Wav2Vec2Config(**_tiny_hf(
            do_stable_layer_norm=True, feat_extract_norm="layer",
            conv_bias=True))
        return transformers.Wav2Vec2Model(cfg).eval(), cfg
    if kind == "hubert":
        cfg = transformers.HubertConfig(**_tiny_hf())
        return transformers.HubertModel(cfg).eval(), cfg
    cfg = transformers.WhisperConfig(
        vocab_size=64, pad_token_id=1, bos_token_id=2, eos_token_id=3,
        decoder_start_token_id=2, num_mel_bins=8, d_model=16,
        encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=2,
        decoder_attention_heads=2, encoder_ffn_dim=32, decoder_ffn_dim=32,
        max_source_positions=24, max_target_positions=20, dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0)
    return transformers.WhisperModel(cfg).eval(), cfg


def _trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)), got, want)


@pytest.mark.parametrize("kind", ["wav2vec2_base", "wav2vec2_large",
                                  "hubert", "whisper"])
def test_converted_trees_equal_jax_hf_import(kind):
    hf, hf_cfg = _hf_model(kind)
    sd = hf.state_dict()
    if kind == "whisper":
        cfg, jcfg = thf.whisper_config_from_hf(hf_cfg), \
            jhf.whisper_config_from_hf(hf_cfg)
        assert dataclasses.asdict(cfg) | {"dtype": 0} == \
            dataclasses.asdict(jcfg) | {"dtype": 0}
        _trees_equal(thf.whisper_encoder_params_from_torch(sd, cfg),
                     jhf.whisper_encoder_params_from_torch(sd, jcfg))
        _trees_equal(thf.whisper_decoder_params_from_torch(sd, cfg),
                     jhf.whisper_decoder_params_from_torch(sd, jcfg))
        return
    cfg, jcfg = thf.ssl_config_from_hf(hf_cfg), jhf.ssl_config_from_hf(hf_cfg)
    assert dataclasses.asdict(cfg) | {"dtype": 0} == \
        dataclasses.asdict(jcfg) | {"dtype": 0}
    tree = thf.wav2vec2_params_from_torch(sd, cfg)
    _trees_equal(tree, jhf.wav2vec2_params_from_torch(sd, jcfg))
    # the legacy weight_g / weight_v key set collapses to the same kernel
    legacy = {k.replace("parametrizations.weight.original0", "weight_g")
               .replace("parametrizations.weight.original1", "weight_v"): v
              for k, v in sd.items()}
    _trees_equal(thf.wav2vec2_params_from_torch(legacy, cfg), tree)
    # and the port's trunk on it gives HF's last hidden state
    wave, lens = _waves(n=2000, lengths=(2000, 2000), seed=5)
    m = _load(tssl.Wav2Vec2Model(cfg), tree)
    with torch.no_grad():
        ref = hf(_t(wave)).last_hidden_state
    _close(m(_t(wave), _t(lens))[0][-1], ref.numpy(), 2e-4)


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    from safetensors.torch import save_file

    rng = np.random.RandomState(7)
    tdt = {"F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16}[dtype]
    tensors = {"a.weight": torch.from_numpy(rng.randn(3, 5).astype(
        np.float32)).to(tdt), "b": torch.from_numpy(rng.randn(7).astype(
            np.float32)).to(tdt), "c.scalar": torch.tensor(1.5, dtype=tdt)}
    path = tmp_path / "m.safetensors"
    save_file(tensors, str(path), metadata={"format": "pt"})
    got = thf.read_safetensors(path)
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        want = t.float().numpy() if dtype == "BF16" else t.numpy()
        assert got[k].dtype == want.dtype and got[k].shape == want.shape
        np.testing.assert_array_equal(got[k], want)
    if dtype != "BF16":
        from safetensors.numpy import load_file

        back = tmp_path / "back.safetensors"
        thf.write_safetensors(back, got)
        theirs = load_file(str(back))
        for k in tensors:
            np.testing.assert_array_equal(theirs[k], got[k])


# --- the ASR model's SSL and Whisper parts --------------------------------

BASE = dict(vocab_size=12, d_model=16, num_heads=2, d_ff=32,
            num_encoder_layers=2, num_decoder_layers=1, decoder_d_ff=32,
            use_specaug=False, normalize="utterance_mvn", dropout_rate=0.0,
            conformer_kernel_size=7)
CASES = {
    "ssl_conformer": dict(input_type="ssl", encoder_type="conformer",
                          ssl=TINY_SSL, ssl_freeze=True),
    "wav2vec2": dict(encoder_type="wav2vec2", ssl=dict(
        TINY_SSL, conv_dim=[8, 8], conv_kernel=[10, 3], conv_stride=[5, 2]),
        ssl_freeze=False, d_model=24),
    "whisper": dict(encoder_type="whisper", decoder_type="whisper",
                    whisper=TINY_WHISPER, normalize="none", ctc_weight=0.0),
}


def _asr_batch():
    rng = np.random.RandomState(0)
    speech, slen = _waves(b=3, n=3200, lengths=(3200, 2400, 1700), seed=2)
    text = rng.randint(1, 11, (3, 4)).astype(np.int32)
    tlen = np.array([4, 3, 2], np.int32)
    text[np.arange(4)[None] >= tlen[:, None]] = 0
    return speech, slen, text, tlen


def _drawn(model):
    tasr.init_random_(model, torch.Generator().manual_seed(0))
    prng = np.random.RandomState(1)
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * prng.randn(*a.shape).astype(np.float32),
        state_dict_to_jax_params(model.state_dict()))


@pytest.fixture(scope="module", params=sorted(CASES))
def asr_case(request):
    cfg = {**BASE, **CASES[request.param]}
    batch = _asr_batch()
    jb = tuple(map(jnp.asarray, batch))
    jm = jasr.ASRModel(jasr.ASRConfig(**cfg))
    params = _drawn(tasr.ASRModel(tasr.ASRConfig(**cfg)))
    want = jax.eval_shape(lambda: _init(jm, *jb))
    assert jax.tree_util.tree_map(lambda a: a.shape, want) == \
        jax.tree_util.tree_map(lambda a: a.shape, params)
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, *jb), has_aux=True))(params)
    enc, elens = jm.apply({"params": params}, *jb[:2],
                          method=jasr.ASRModel.encode)
    return (request.param, cfg, jm, params,
            (jloss, jstats, jgrads, enc, elens))


def test_asr_encode_loss_and_every_gradient_match_jax(asr_case):
    name, cfg, _, params, (jloss, jstats, jgrads, enc, elens) = asr_case
    model = load_jax_params(tasr.ASRModel(tasr.ASRConfig(**cfg)), params)
    batch = [_t(a) for a in _asr_batch()]
    with torch.no_grad():
        got, got_lens = model.eval().encode(*batch[:2])
    _close(got, enc)
    assert got_lens.tolist() == np.asarray(elens).tolist()
    loss, stats = model.train()(*batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    assert set(stats) == set(jstats)
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()),
                                   float(jstats[k]), rtol=LOSS_TOL,
                                   atol=1e-7, err_msg=k)
    _grads_match(model, jgrads)
    if name == "ssl_conformer":
        assert all(p.grad is None
                   for p in model.ssl_frontend.upstream.parameters())
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        params, model_params(model))


def test_asr_search_matches_jax(asr_case):
    name, cfg, jm, params, _ = asr_case
    speech, slen, _, _ = _asr_batch()
    kw = dict(beam_size=3, max_steps=6,
              ctc_weight=0.0 if cfg.get("ctc_weight") == 0.0 else 0.3)
    jres = JSpeech2Text(jm, params, **kw)(speech, slen, nbest=3)
    model = load_jax_params(tasr.ASRModel(tasr.ASRConfig(**cfg)), params)
    got = Speech2Text(model, device="cpu", **kw)(speech, slen, nbest=3)
    for g, j in zip(got, jres):
        assert [ids for ids, _ in g.nbest] == [ids for ids, _ in j.nbest]
        for (_, gs), (_, js) in zip(g.nbest, j.nbest):
            assert abs(gs - js) <= SCORE_TOL * max(1.0, abs(js))


def test_sections_coerce_as_in_jax():
    """Dicts (a config.yaml's, lists for tuples) and dataclasses alike
    become the sections, their dtype pinned to the model's; the defaults
    stand in for a missing section; the new fields' defaults are JAX's."""
    jf = {f.name: f.default for f in dataclasses.fields(jasr.ASRConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tasr.ASRConfig)}
    # frontend_precision (the TPU's matmul precision) is the task
    # section's only
    assert set(jf) - {"frontend_precision"} == set(tf)
    assert all(tf[k] == jf[k] for k in ("ssl", "whisper", "ssl_freeze"))
    for cls, jcls in ((tssl.SSLConfig, jssl.SSLConfig),
                      (tssl.WhisperConfig, jssl.WhisperConfig)):
        a = dataclasses.asdict(cls())
        b = dataclasses.asdict(jcls())
        assert a.keys() == b.keys()
        assert all(a[k] == b[k] for k in a if k != "dtype")
    c = tasr.with_sections(tasr.ASRConfig(
        vocab_size=5, input_type="ssl", dtype=torch.bfloat16,
        ssl=json.loads(json.dumps(TINY_SSL))))
    assert c.ssl == tssl.SSLConfig(**TINY_SSL, dtype=torch.bfloat16)
    c = tasr.with_sections(tasr.ASRConfig(vocab_size=5,
                                          encoder_type="whisper"))
    assert c.whisper == tssl.WhisperConfig() and c.ssl is None
    m = tasr.ASRModel(tasr.ASRConfig(**{**BASE, **CASES["whisper"],
                                        "vocab_size": 9}))
    assert m.decoder.embed_tokens.num_embeddings == 9
    assert m.decoder_max_steps == 15 and m.ctc_head is None
    assert not hasattr(tasr.ASRModel(tasr.ASRConfig(
        **{**BASE, **CASES["wav2vec2"], "normalize": "global_mvn"})), "mvn")


# --- the CLIs: convert_hf and --run.init_param -----------------------------

HF_SSL = dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=32, conv_dim=(8, 8), conv_kernel=(10, 3),
              conv_stride=(5, 2), num_feat_extract_layers=2,
              num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2)
HF_WHISPER = dict(max_source_positions=80, max_target_positions=32)


def _hf_dir(tmp_path, kind):
    """A HF model directory: wav2vec2 (the bare model, model.safetensors),
    hubert (HubertForCTC, keys under `hubert.`, pytorch_model.bin) or
    whisper (WhisperForConditionalGeneration, keys under `model.`,
    model.safetensors)."""
    from safetensors.torch import save_file

    torch.manual_seed(13)
    d = tmp_path / kind
    d.mkdir()
    if kind == "whisper":
        _, cfg = _hf_model("whisper")
        cfg.update(HF_WHISPER)
        hf = transformers.WhisperForConditionalGeneration(cfg).eval()
    elif kind == "hubert":
        cfg = transformers.HubertConfig(**_tiny_hf(**HF_SSL))
        hf = transformers.HubertForCTC(cfg).eval()
    else:
        cfg = transformers.Wav2Vec2Config(**_tiny_hf(**HF_SSL))
        hf = transformers.Wav2Vec2Model(cfg).eval()
    sd = {k: v.contiguous() for k, v in hf.state_dict().items()}
    if kind == "hubert":
        torch.save(sd, d / "pytorch_model.bin")
    else:
        # the tied output projection shares the embedding's storage
        sd.pop("proj_out.weight", None)
        save_file(sd, str(d / "model.safetensors"))
    (d / "config.json").write_text(hf.config.to_json_string())
    return d, hf


@pytest.mark.parametrize("kind", ["wav2vec2", "hubert", "whisper"])
def test_convert_hf_cli_writes_the_jax_clis_tree(tmp_path, kind):
    import flax.serialization as fser

    from espnet_tpu.bin import convert_hf as jconvert
    from espnet_tpu_torch.bin import convert_hf as tconvert

    d, _ = _hf_dir(tmp_path, kind)
    outs = {}
    for name, cli in (("jax", jconvert), ("port", tconvert)):
        out = tmp_path / f"{name}.msgpack"
        cli.main(["--model_type", kind, "--checkpoint", str(d), "--out",
                  str(out)])
        outs[name] = (fser.msgpack_restore(out.read_bytes()),
                      json.loads((tmp_path / f"{name}.msgpack.json")
                                 .read_text()))
    _trees_equal(outs["port"][0], outs["jax"][0])
    assert outs["port"][1] == outs["jax"][1]
    assert set(outs["port"][0]) == ({"encoder", "decoder"}
                                    if kind == "whisper" else {"params"})


INIT_CASES = {
    "encoder_upstream": ("wav2vec2", "params:encoder/upstream",
                         ["--model.encoder_type", "wav2vec2"]),
    "ssl_frontend_upstream": ("hubert", "params:ssl_frontend/upstream",
                              ["--model.input_type", "ssl",
                               "--model.encoder_type", "transformer"]),
    "whisper_encoder": ("whisper", "encoder:encoder",
                        ["--model.encoder_type", "whisper",
                         "--model.decoder_type", "whisper",
                         "--model.ctc_weight", "0.0"]),
}


@pytest.mark.parametrize("case", list(INIT_CASES))
def test_init_param_transfers_the_converted_subtree(tmp_path, case):
    """convert_hf, then asr_train --run.init_param <out>:<src>:<dst> (lr
    0: the epoch's parameters are the initial ones): the subtree arrives
    whole and the trunk in the trained model reproduces the HF model."""
    from espnet_tpu_torch.bin import asr_train, convert_hf
    from espnet_tpu_torch.data.synth import generate_corpus
    from espnet_tpu_torch.train.msgpack_io import flatten, load_tree

    kind, spec, extra = INIT_CASES[case]
    d, hf = _hf_dir(tmp_path, kind)
    out = tmp_path / "hf.msgpack"
    convert_hf.main(["--model_type", kind, "--checkpoint", str(d), "--out",
                     str(out)])
    section = json.loads((tmp_path / "hf.msgpack.json").read_text())[
        "config"]
    generate_corpus(tmp_path / "data", n_utts=4, min_words=1, max_words=3)
    name = "whisper" if kind == "whisper" else "ssl"
    model_args = ["--model.d_model", "16", "--model.num_heads", "2",
                  "--model.d_ff", "32", "--model.num_encoder_layers", "1",
                  "--model.num_decoder_layers", "1",
                  "--model.decoder_d_ff", "32", "--model.dropout_rate",
                  "0.0", "--model.use_specaug", "false",
                  "--model.normalize", "utterance_mvn",
                  f"--model.{name}", json.dumps(section), *extra]
    exp = tmp_path / "exp"
    _, _, model, _, _ = asr_train.main([
        "--run.output_dir", str(exp), "--run.max_epoch", "1",
        "--run.log_interval", "1000", "--run.best_metric", "train.loss.min",
        "--run.init_param", f"{out}:{spec}", "--data.train_dir",
        str(tmp_path / "data"), "--data.batch_size", "4",
        "--optim.schedule", "constant", "--optim.lr", "0.0",
        *model_args, "--device", "cpu"])
    src, dst = spec.split(":")
    conv = flatten(load_tree(out))
    got = flatten(load_tree(exp / "ep1.params.msgpack"))
    moved = [k for k in conv if k.startswith(src + "/")]
    assert len(moved) > 10
    for k in moved:
        np.testing.assert_array_equal(
            got[dst + k[len(src):]], conv[k], err_msg=k)
    model.eval()
    with torch.no_grad():
        if kind == "whisper":
            mel = torch.from_numpy(np.random.RandomState(3).randn(
                1, 160, 8).astype(np.float32))
            ref = hf.model.encoder(mel.transpose(1, 2)).last_hidden_state
            ours = model.encoder(mel, torch.tensor([160]))[0]
        else:
            wave = torch.from_numpy(np.random.RandomState(3).randn(
                1, 1600).astype(np.float32))
            trunk = (model.encoder.upstream if kind == "wav2vec2"
                     else model.ssl_frontend.upstream)
            base = hf if kind == "wav2vec2" else hf.hubert
            ref = base(wave).last_hidden_state
            ours = trunk(wave, torch.tensor([1600]))[0][-1]
    _close(ours, ref.numpy(), 2e-4)
