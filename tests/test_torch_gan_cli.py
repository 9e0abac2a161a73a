"""The port's GAN CLIs (`bin/{vocoder_train,vits_train,vits_inference,
jets_train,jets_inference}.py`) against the JAX package's, on the CPU.

A synthetic corpus (6 utterances of one or two words, cut to 0.3 s for
VITS and JETS) and tiny models: generators of width 16, a hop of 16
samples (upsample 4 x 4), one training step an epoch. Each package trains
its own vocoder experiment; VITS and JETS experiments come from the port's
`*_train` and from the JAX task's functions (its first epoch's files
without the training); each package reads the other's. A vocoder experiment's
`generator.msgpack` synthesises the same wave from the same mel in both
packages (1e-4); VITS with `--noise_scale 0` and JETS synthesise the same
waves through both packages' inference CLIs (1e-4). The port's resume
state continues a run where it ended, and a GAN state goes to flax's
`GANTrainState` and back (`convert.gan_state_to_jax`,
`load_jax_gan_state`): the JAX step continues it.
"""

from pathlib import Path

import flax.linen as fnn
import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from espnet_tpu.bin import jets_inference as jjets_inference
from espnet_tpu.bin import vits_inference as jvits_inference
from espnet_tpu.bin import vocoder_train as jvocoder_train
from espnet_tpu.data import tokenizer as jtok
from espnet_tpu.tasks.jets import JETSTask as JJETSTask
from espnet_tpu.tasks.vits import VITSTask as JVITSTask
from espnet_tpu.tasks.vocoder import VocoderTask as JVocoderTask
from espnet_tpu.train import gan_steps as jgan
from espnet_tpu.train.checkpoint import save_pytree
from espnet_tpu_torch.bin import (jets_inference, jets_train, vits_inference,
                                  vits_train, vocoder_train)
from espnet_tpu_torch.convert import gan_state_to_jax, load_jax_gan_state
from espnet_tpu_torch.data.fileio import read_2column_text, read_wav
from espnet_tpu_torch.data.synth import generate_corpus
from espnet_tpu_torch.tasks.vocoder import VocoderTask
from espnet_tpu_torch.train.msgpack_io import load_tree, to_bytes

TOL = 1e-4
RUN = ["--run.max_epoch", "1", "--data.batch_size", "2",
       "--data.steps_per_epoch", "1"]
VOCODER = RUN + ["--data.n_fft", "128", "--data.hop_length", "16",
                 "--data.n_mels", "8", "--data.segment_size", "256",
                 "--model.channels", "16", "--model.upsample_scales",
                 "[4, 4]", "--model.resblock_kernel_sizes", "[3]",
                 "--model.discriminator_type", "pwg"]
GAN_TTS = RUN + ["--data.n_fft", "128", "--data.hop_length", "16",
                 "--data.max_seconds", "0.3", "--model.decoder_channels",
                 "16", "--model.upsample_scales", "[4, 4]",
                 "--model.resblock_kernel_sizes", "[3]",
                 "--model.segment_frames", "4", "--model.dropout_rate", "0"]
VITS = GAN_TTS + ["--model.channels", "16", "--model.text_d_ff", "32",
                  "--model.text_layers", "1", "--model.posterior_layers",
                  "2", "--model.flows", "2", "--model.flow_layers", "2"]
JETS = GAN_TTS + ["--data.n_mels", "8", "--model.adim", "16",
                  "--model.d_ff", "32", "--model.encoder_layers", "1",
                  "--model.decoder_layers", "1"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("gan_cli") / "data"
    generate_corpus(root, n_utts=6, min_words=1, max_words=2)
    return root


def _waves(d):
    return {p.name: read_wav(p)[0] for p in sorted((d / "wav").glob("*.wav"))}


def _same_waves(a, b, nonempty=True):
    wa, wb = _waves(a), _waves(b)
    assert wa.keys() == wb.keys() and len(wa) == 6
    for k in wa:
        assert wa[k].shape == wb[k].shape, k
        assert wa[k].size > 0 or not nonempty, k
        np.testing.assert_allclose(wa[k], wb[k], rtol=TOL, atol=TOL)


def _vocode_alike(exp):
    """The experiment's generator.msgpack in both packages: the same wave
    from the same mel."""
    from espnet_tpu_torch.bin.tts_inference import load_vocoder

    mel = np.random.RandomState(0).randn(2, 5, 8).astype(np.float32)
    jcfg = JVocoderTask.load_config(exp)
    jgen, _ = JVocoderTask.build_models(jcfg["model"], 8)
    params = fser.from_state_dict(
        jax.device_get(jgen.init(jax.random.PRNGKey(0),
                                 jnp.asarray(mel))["params"]),
        load_tree(exp / "generator.msgpack"))
    want = jgen.apply({"params": params}, jnp.asarray(mel))
    got = load_vocoder(exp)(torch.from_numpy(mel))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_vocoder_experiments_cross_read_and_the_port_resumes(corpus,
                                                             tmp_path):
    base = ["--data.train_dir", str(corpus)]
    jexp, texp = tmp_path / "jexp", tmp_path / "texp"
    jvocoder_train.main(base + VOCODER + ["--run.output_dir", str(jexp)])
    vocoder_train.main(base + VOCODER + ["--run.output_dir", str(texp),
                                         "--device", "cpu"])
    for exp in (jexp, texp):
        _vocode_alike(exp)
    tcfg, jcfg = (VocoderTask.load_config(e) for e in (texp, jexp))
    assert {k: v for k, v in tcfg.items() if k != "run"} == \
        {k: v for k, v in jcfg.items() if k != "run"}
    # the resume state: a second epoch continues the first
    before = torch.load(texp / "checkpoint.pt", weights_only=False)
    vocoder_train.main(base + VOCODER[2:] + [
        "--run.max_epoch", "2", "--run.output_dir", str(texp),
        "--device", "cpu"])
    after = torch.load(texp / "checkpoint.pt", weights_only=False)
    assert (before["epoch"], after["epoch"]) == (1, 2)
    assert after["state"]["step"] == before["state"]["step"] + 1
    _vocode_alike(texp)


def test_gan_state_round_trips_through_flax(corpus, tmp_path):
    """A port GANTrainState in flax's layout restores into the JAX
    GANTrainState (both optimizer states included) and back."""
    from espnet_tpu_torch.tasks.vocoder import VocoderOptimConfig, gan_state
    from espnet_tpu_torch.train.gan_steps import (GANLossWeights,
                                                  make_gan_train_step)

    cfg = VocoderTask.parse_config(VOCODER)
    gen, disc = VocoderTask.build_models(cfg["model"], 8)
    state = gan_state(gen, disc, VocoderOptimConfig(), 0, "cpu")
    rng = np.random.RandomState(1)
    mel = torch.from_numpy(rng.randn(2, 4, 8).astype(np.float32))
    wav = torch.from_numpy((rng.randn(2, 64) * 0.3).astype(np.float32))
    weights = GANLossWeights(n_fft=64, hop_length=16, n_mels=8)
    make_gan_train_step(weights)(state, mel, wav)
    jgen, jdisc = JVocoderTask.build_models(
        JVocoderTask.parse_config(VOCODER)["model"], 8)
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.adam(2e-4, b1=0.8, b2=0.99))
    template = jgan.GANTrainState.create(
        jgen.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8)))["params"], tx,
        jdisc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 1)))["params"],
        tx)
    blob = to_bytes(gan_state_to_jax(state))
    jstate = fser.from_bytes(template, blob)
    assert int(jstate.step) == 1
    np.testing.assert_array_equal(
        np.asarray(jstate.gen_opt[1][0].count), 1)
    # JAX continues the state; the port loads JAX's result and agrees
    jstep = jax.jit(jgan.make_gan_train_step(
        jgen, jdisc, tx, tx,
        jgan.GANLossWeights(n_fft=64, hop_length=16, n_mels=8)))
    jnext, _ = jstep(jstate, jnp.asarray(mel.numpy()),
                     jnp.asarray(wav.numpy()))
    load_jax_gan_state(state, fser.to_state_dict(jax.device_get(jnext)))
    assert state.step == 2
    back = gan_state_to_jax(state)
    want = fser.to_state_dict(jax.device_get(jnext))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a),
                                                np.asarray(b), rtol=1e-6,
                                                atol=1e-7),
        {k: back[k] for k in ("gen_params", "disc_params", "gen_opt",
                              "disc_opt")},
        {k: want[k] for k in ("gen_params", "disc_params", "gen_opt",
                              "disc_opt")})


def _jax_experiment(task, argv, exp):
    """What the JAX task writes before its first step (config.yaml,
    tokens.txt, and the generator's flax init as generator.msgpack), by the
    JAX task's own functions: a JAX GAN-TTS experiment without the cost of
    compiling its training step on the CPU."""
    cfg = task.parse_config(argv + ["--run.output_dir", str(exp)])
    exp.mkdir(parents=True)
    task.dump_config(cfg, exp)
    data = cfg["data"]
    texts = read_2column_text(Path(data.train_dir) / "text")
    tokenizer = jtok.build_tokenizer(data.token_type)
    conv = jtok.TokenIDConverter(jtok.build_token_list(
        list(texts.values()), tokenizer))
    conv.save(exp / "tokens.txt")
    gen, _ = task.build_models(cfg["model"], data, len(conv))
    key = jax.random.PRNGKey(3)
    if task is JVITSTask:
        feats = jnp.zeros((1, 16, data.n_fft // 2 + 1))
        extra, rngs = (), {"params": key, "posterior": key, "segment": key,
                           "dropout": key}
    else:
        feats = jnp.zeros((1, 16, data.n_mels))
        extra = (jnp.zeros((1, 16)), jnp.zeros((1, 16)))
        rngs = {"params": key, "segment": key, "dropout": key}
    params = fnn.meta.unbox(gen.init(
        rngs, jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]), feats,
        jnp.asarray([16]), *extra))["params"]
    save_pytree(exp / "generator.msgpack", params)


@pytest.mark.parametrize("family", ["vits", "jets"])
def test_gan_tts_experiments_synthesise_alike_in_both_packages(
        family, corpus, tmp_path):
    """The port's `*_train` experiment and the JAX task's: both packages'
    inference CLIs give the same waves (JETS's durations may round to 0
    frames, and then both write empty waves)."""
    jtask, ttrain, jinfer, tinfer, flags = {
        "vits": (JVITSTask, vits_train, jvits_inference, vits_inference,
                 VITS),
        "jets": (JJETSTask, jets_train, jjets_inference, jets_inference,
                 JETS)}[family]
    extra = ["--noise_scale", "0", "--max_frames", "40"] \
        if family == "vits" else []
    base = ["--data.train_dir", str(corpus)]
    jexp, texp = tmp_path / "jexp", tmp_path / "texp"
    _jax_experiment(jtask, base + flags, jexp)
    ttrain.main(base + flags + ["--run.output_dir", str(texp),
                                "--device", "cpu"])
    assert (texp / "tokens.txt").read_text() == \
        (jexp / "tokens.txt").read_text()
    assert (texp / "checkpoint.pt").exists()
    for exp in (jexp, texp):
        dec = ["--exp_dir", str(exp), "--data_dir", str(corpus)] + extra
        jinfer.main(dec + ["--output_dir", str(exp / "j")])
        tinfer.main(dec + ["--output_dir", str(exp / "t"), "--device",
                           "cpu"])
        _same_waves(exp / "t", exp / "j", nonempty=family == "vits")
