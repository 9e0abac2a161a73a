"""The port's TTS and VC CLIs and the TTS recipe against the JAX
package's, on the CPU.

A synthetic corpus (8 utterances of one or two words) and tiny models: a
Tacotron2 of width 16 with dropout and zoneout at 0 (its prenet dropout,
always on, then draws nothing, so that the two packages' decoders are
deterministic), reduction 2, one epoch. The experiment directory that
either package's `tts_train` writes synthesises the same mels (1e-4) with
both packages' `tts_inference`, gives the same durations file with both
`tts_teacher_durations`, and the same `score_mcd.txt` with both
`tts_scoring`; a FastSpeech2 trained by the port on those durations
synthesises the same mels with both. The port's `vc_train` and
`spk_embed_extract` write what the JAX models read back (same outputs).
A JAX `checkpoint.msgpack` with its BatchNorm `batch_stats` resumes in the
port's trainer; the port's running statistics, in flax's msgpack, apply in
the JAX model. `run_tts` runs its nine stages with the port's CLIs.
"""

import dataclasses
import shutil

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.bin import spk_embed_extract as jspk_extract
from espnet_tpu.bin import tts_inference as jtts_inference
from espnet_tpu.bin import tts_scoring as jtts_scoring
from espnet_tpu.bin import tts_teacher_durations as jtts_durations
from espnet_tpu.bin import tts_train as jtts_train
from espnet_tpu.models.tts import spk_embed as jspk
from espnet_tpu.models.tts import vc as jvc
from espnet_tpu.tasks.tts import TTSTask as JTTSTask
from espnet_tpu.tasks.vc import VCTask as JVCTask
from espnet_tpu_torch.bin import (run_tts, spk_embed_extract, tts_inference,
                                  tts_scoring, tts_teacher_durations,
                                  tts_train, vc_train)
from espnet_tpu_torch.convert import load_jax_params, model_variables
from espnet_tpu_torch.data.fileio import read_2column_text
from espnet_tpu_torch.data.synth import generate_corpus, generate_vc_corpus
from espnet_tpu_torch.tasks.tts import TTSTask
from espnet_tpu_torch.tasks.vc import VCTask
from espnet_tpu_torch.train.msgpack_io import load_tree, save_tree

FRONT = ("--model.n_fft 512 --model.hop_length 128 --model.n_mels 20 "
         "--model.fmin 0 --model.fmax none").split()
RUN = ("--optim.schedule constant --optim.lr 0.001 --run.max_epoch 1 "
       "--run.log_interval 1000 --data.batch_size 8").split()
TACO = dict(embed_dim=16, encoder_conv_layers=1, encoder_conv_channels=16,
            encoder_lstm_units=16, prenet_layers=1, prenet_units=8,
            decoder_lstm_units=16, decoder_lstm_layers=1, att_dim=8,
            att_conv_channels=4, att_conv_kernel=5, postnet_layers=2,
            postnet_channels=8, reduction_factor=2, max_frames=64,
            dropout_rate=0.0, zoneout_rate=0.0)
FS2 = dict(d_model=16, num_heads=2, d_ff=32, encoder_layers=1,
           decoder_layers=1, predictor_channels=8, postnet_layers=2,
           postnet_channels=8, max_frames=64, dropout_rate=0.0)


def _flags(section, values):
    out = []
    for k, v in values.items():
        out += [f"--model.{section}.{k}", str(v)]
    return out


TACO_ARGS = (["--model.tts_type", "tacotron2"] + FRONT
             + _flags("tacotron2", TACO) + RUN)
FS2_ARGS = (["--model.tts_type", "fastspeech2"] + FRONT
            + _flags("fastspeech2", FS2) + RUN)
SYNTH = ["--max_frames", "64", "--griffin_lim_iters", "2",
         "--batch_size", "8"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mels(d):
    return {p.name: np.load(p) for p in sorted((d / "wav").glob("*.npy"))}


def _same_mels(got_dir, want_dir, tol=1e-4):
    got, want = _mels(got_dir), _mels(want_dir)
    assert got.keys() == want.keys() and len(got) == 8
    for k in got:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol)


def _scores(d):
    """{uid: MCD, "mean": MCD mean} of a score_mcd.txt."""
    head, *rows = (d / "score_mcd.txt").read_text().splitlines()
    out = {r.split()[0]: float(r.split()[1]) for r in rows}
    out["mean"] = float(head.split("MCD mean")[1].split("|")[0])
    return out


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("tts_cli")
    generate_corpus(root / "data", n_utts=8, min_words=1, max_words=2)
    return root


@pytest.fixture(scope="module")
def jax_exp(ws, tmp_path_factory):
    """A Tacotron2 experiment that the JAX package's `tts_train` wrote (the
    tests that use it copy it before they write into it)."""
    exp = tmp_path_factory.mktemp("jax_taco") / "exp"
    jtts_train.main(["--run.output_dir", str(exp), "--data.train_dir",
                     str(ws / "data")] + TACO_ARGS)
    return exp


@pytest.mark.parametrize("trained_by", ["port", "jax"])
def test_tacotron2_experiment_synthesises_and_teaches_alike(
        ws, tmp_path, trained_by, request):
    """Either package's Tacotron2 experiment: the same mels from both
    `tts_inference`s, the same durations from both
    `tts_teacher_durations`, the same MCD report from both `tts_scoring`s.
    """
    if trained_by == "port":
        exp = tmp_path / "exp"
        tts_train.main(["--run.output_dir", str(exp), "--data.train_dir",
                        str(ws / "data"), "--device", "cpu"] + TACO_ARGS)
        assert (exp / "checkpoint.pt").exists()
    else:
        exp = request.getfixturevalue("jax_exp")
    assert (exp / "stats" / "feats_stats.npz").exists()
    dec = ["--exp_dir", str(exp), "--data_dir", str(ws / "data")] + SYNTH
    tts_inference.main(dec + ["--output_dir", str(tmp_path / "t"),
                              "--device", "cpu"])
    jtts_inference.main(dec + ["--output_dir", str(tmp_path / "j")])
    _same_mels(tmp_path / "t", tmp_path / "j")
    for name, score in (("t", tts_scoring), ("j", jtts_scoring)):
        score.main(["--ref_dir", str(ws / "data"), "--synth_dir",
                    str(tmp_path / "t"), "--output_dir",
                    str(tmp_path / f"score_{name}")])
    got, want = (_scores(tmp_path / f"score_{n}") for n in "tj")
    assert got.keys() == want.keys() and len(got) == 9
    for k in got:  # the DTW sums differ in the last float bits
        assert abs(got[k] - want[k]) <= 2e-3, k

    data = tmp_path / "data"
    data.mkdir()
    for f in ("wav.scp", "text"):
        (data / f).write_text((ws / "data" / f).read_text())
    teach = ["--exp_dir", str(exp), "--data_dir", str(data),
             "--batch_size", "8"]
    jtts_durations.main(teach)
    want = read_2column_text(data / "durations")
    tts_teacher_durations.main(teach + ["--device", "cpu"])
    got = read_2column_text(data / "durations")
    assert got == want and len(got) == 8
    texts = read_2column_text(data / "text")
    for k, v in got.items():
        assert len(v.split()) == len(texts[k])  # one per char token
    if trained_by == "port":
        (ws / "durations").write_text((data / "durations").read_text())


def _jax_vocoder_experiment(exp, flags):
    """A vocoder experiment as the JAX task writes it (config.yaml and the
    generator's flax init as generator.msgpack), at the TTS front's n_fft,
    hop and n_mels."""
    from espnet_tpu.tasks.vocoder import VocoderTask as JVocoderTask
    from espnet_tpu.train.checkpoint import save_pytree

    cfg = JVocoderTask.parse_config(flags + ["--run.output_dir", str(exp)])
    exp.mkdir(parents=True)
    JVocoderTask.dump_config(cfg, exp)
    gen, _ = JVocoderTask.build_models(cfg["model"], cfg["data"].n_mels)
    key = jax.random.PRNGKey(4)
    save_pytree(exp / "generator.msgpack", gen.init(
        {"params": key, "noise": key}, jnp.zeros((1, 8, 20)))["params"])


VOCODER = ["--data.n_fft", "512", "--data.hop_length", "128",
           "--data.n_mels", "20", "--model.upsample_scales", "[8, 16]"]
VOCODERS = {
    "hifigan": VOCODER + ["--model.channels", "16",
                          "--model.resblock_kernel_sizes", "[3]"],
    "parallel_wavegan": VOCODER + [
        "--model.generator_type", "parallel_wavegan",
        "--model.pwg_layers", "4", "--model.pwg_stacks", "2"]}


def _waves(d):
    from espnet_tpu_torch.data.fileio import read_wav

    return {p.name: read_wav(p)[0] for p in sorted((d / "wav").glob("*.wav"))}


def test_fastspeech2_on_teacher_durations_synthesises_alike(ws, tmp_path,
                                                            monkeypatch):
    """FastSpeech2 trained by the port on the port teacher's durations;
    both `tts_inference`s give the same mels. Through `--vocoder_dir`, a
    JAX-written HiFiGAN vocoder experiment gives the same waves in both
    packages, and so does a noise-driven Parallel WaveGAN with its noise
    injected (numpy draws from `jax.random.normal` and the port's
    `vocoders._noise`); the waves are 16-bit, so they agree to 2 LSB."""
    if not (ws / "durations").exists():
        pytest.skip("needs the port-trained teacher's durations")
    data = tmp_path / "data"
    data.mkdir()
    for f in ("wav.scp", "text"):
        (data / f).write_text((ws / "data" / f).read_text())
    (data / "durations").write_text((ws / "durations").read_text())
    exp = tmp_path / "exp"
    tts_train.main(["--run.output_dir", str(exp), "--data.train_dir",
                    str(data), "--device", "cpu"] + FS2_ARGS)
    dec = ["--exp_dir", str(exp), "--data_dir", str(data)] + SYNTH
    tts_inference.main(dec + ["--output_dir", str(tmp_path / "t"),
                              "--device", "cpu"])
    jtts_inference.main(dec + ["--output_dir", str(tmp_path / "j")])
    _same_mels(tmp_path / "t", tmp_path / "j")
    from espnet_tpu_torch.models.tts import vocoders as tvoc

    def draws(shape):
        return np.random.RandomState(0).randn(*shape).astype(np.float32)

    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(
                            draws(tuple(shape)), dtype))
    monkeypatch.setattr(tvoc, "_noise", lambda shape, like, noise, gen:
                        torch.from_numpy(draws(tuple(shape))).to(like))
    for name, flags in VOCODERS.items():
        voc = tmp_path / name
        _jax_vocoder_experiment(voc, flags)
        out = {k: tmp_path / f"{name}_{k}" for k in "tj"}
        tts_inference.main(dec + ["--output_dir", str(out["t"]),
                                  "--vocoder_dir", str(voc), "--device",
                                  "cpu"])
        jtts_inference.main(dec + ["--output_dir", str(out["j"]),
                                   "--vocoder_dir", str(voc)])
        got, want = _waves(out["t"]), _waves(out["j"])
        assert got.keys() == want.keys() and len(got) == 8
        for k in got:
            assert got[k].shape == want[k].shape, (name, k)
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=2.0 / 32767, err_msg=name)
        _same_mels(out["t"], out["j"])


def test_jax_checkpoint_with_batch_stats_resumes_and_flax_reads_the_port(
        ws, tmp_path, jax_exp):
    """The JAX trainer's `checkpoint.msgpack` holds the BatchNorm running
    statistics in `extra_vars["batch_stats"]`: the port's resume loads
    them with the parameters and trains on; the port's statistics, written
    with its msgpack codec, restore in flax, and the JAX model in eval mode
    (which reads them) gives the port's loss."""
    from espnet_tpu_torch.train.checkpoint import load_jax_state
    from espnet_tpu_torch.train.optim import build_optimizer
    from espnet_tpu_torch.train.steps import TrainState

    exp = tmp_path / "exp"
    shutil.copytree(jax_exp, exp)
    argv = ["--run.output_dir", str(exp), "--data.train_dir",
            str(ws / "data")] + TACO_ARGS
    blob = load_tree(exp / "checkpoint.msgpack")
    jstats = blob["extra_vars"]["batch_stats"]
    cfg = TTSTask.load_config(exp)
    n_tok = len((exp / "tokens.txt").read_text().split("\n")) - 1
    model = TTSTask.build_model(cfg["model"], n_tok)
    opt = build_optimizer("adam", 1e-3, "constant", 0, 256)
    state = TrainState.create(model, opt)
    load_jax_state(exp / "checkpoint.msgpack", state, model)
    norm = model.tts.postnet.norm0
    np.testing.assert_allclose(
        norm.mean.numpy(), jstats["tts"]["postnet"]["norm0"]["mean"])
    np.testing.assert_allclose(
        model.tts.encoder.norm0.var.numpy(),
        jstats["tts"]["encoder"]["norm0"]["var"])
    assert float((norm.var - 1.0).abs().max()) > 1e-3  # trained, not init
    # ...and never reach synthesis: the params files hold none, so both
    # packages' tts_inference run the initial ones (ROADMAP.md queue 3;
    # the two CLIs' mels are equal in the first test of this file)
    from espnet_tpu_torch.bin.tts_inference import load_tts_experiment

    served = load_tts_experiment(exp)[0].tts.postnet.norm0
    assert float(served.mean.abs().max()) == 0.0
    assert float((served.var - 1.0).abs().max()) == 0.0

    tts_train.main(argv[:-4] + ["--run.max_epoch", "2",
                                "--run.log_interval", "1000",
                                "--data.batch_size", "8", "--device", "cpu"])
    assert (exp / "ep2.params.msgpack").exists()
    assert (exp / "checkpoint.pt").exists()

    # the port's variables in flax: the JAX model's eval loss is the port's
    blob = torch.load(exp / "checkpoint.pt", weights_only=True)
    with torch.no_grad():
        for k, v in blob["batch_stats"].items():
            model.get_buffer(k).copy_(v)
    load_jax_params(model, {"params": load_tree(exp / "ep2.params.msgpack"),
                            "mvn": {"mvn": {
                                "mean": model.mvn.mean.numpy(),
                                "inv_std": model.mvn.inv_std.numpy()}}})
    save_tree(tmp_path / "vars.msgpack", model_variables(model))
    restored = fser.msgpack_restore(
        (tmp_path / "vars.msgpack").read_bytes())
    assert set(restored) == {"params", "batch_stats"}
    jm = JTTSTask.build_model(JTTSTask.load_config(exp)["model"], n_tok)
    rng = np.random.RandomState(0)
    text = rng.randint(1, n_tok, (2, 7)).astype(np.int32)
    tl = np.array([7, 5], np.int32)
    speech = (0.2 * rng.randn(2, 3000)).astype(np.float32)
    sl = np.array([3000, 2200], np.int32)
    mvn = {"mvn": {"mean": model.mvn.mean.numpy(),
                   "inv_std": model.mvn.inv_std.numpy()}}
    jloss, _ = jm.apply({**restored, "mvn": mvn},
                        *map(jnp.asarray, (text, tl, speech, sl)),
                        deterministic=True,
                        rngs={"dropout": jax.random.PRNGKey(0)})
    model.eval()
    with torch.no_grad():
        loss, _ = model(*(torch.from_numpy(a).long() if a.dtype == np.int32
                          else torch.from_numpy(a)
                          for a in (text, tl, speech, sl)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)


def test_vc_train_and_spk_embed_extract_write_what_jax_reads(tmp_path):
    """The port's `vc_train` experiment (config.yaml, params) builds and
    loads in the JAX package and converts alike; the port's
    `spk_embed_extract` writes an extractor that the JAX module applies to
    the dumped embeddings, and the spk_embed.scp / spk2emb.scp layout."""
    generate_vc_corpus(tmp_path / "vc", n_utts=4)
    vc_args = ["--run.output_dir", str(tmp_path / "exp"),
               "--run.best_metric", "train.loss.min",
               "--data.train_dir", str(tmp_path / "vc"),
               "--data.batch_size", "2",
               "--model.n_fft", "256", "--model.hop_length", "128",
               "--model.n_mels", "16", "--model.fmin", "0",
               "--model.fmax", "none"] + _flags("tacotron2", TACO) + RUN[:6]
    vc_train.main(vc_args + ["--device", "cpu"])
    exp = tmp_path / "exp"
    params = load_tree(exp / "train.loss.best.params.msgpack")
    tm = VCTask.build_model(VCTask.load_config(exp)["model"])
    load_jax_params(tm, params)
    jm = JVCTask.build_model(JVCTask.load_config(exp)["model"])
    rng = np.random.RandomState(1)
    src = (0.2 * rng.randn(2, 2000)).astype(np.float32)
    sl = np.array([2000, 1500], np.int32)
    # the running statistics of the init, as the port's model keeps them
    stats = model_variables(tm)["batch_stats"]
    want, wl = jm.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(src),
                        jnp.asarray(sl), 32, method=jvc.VCModel.inference,
                        rngs={"dropout": jax.random.PRNGKey(0)})
    got, gl = tm.inference(torch.from_numpy(src),
                           torch.from_numpy(sl).long(), 32)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)

    generate_corpus(tmp_path / "spk", n_utts=6, min_words=1, max_words=2,
                    n_spk=2)
    out = tmp_path / "spk_exp"
    spk_embed_extract.main([
        "--train_dir", str(tmp_path / "spk"), "--dump_dirs",
        str(tmp_path / "spk"), "--output_dir", str(out), "--epochs", "2",
        "--channels", "8", "--embed_dim", "6", "--n_mels", "20",
        "--device", "cpu"])
    assert (out / "spk2id").read_text().count("\n") == 2
    variables = fser.msgpack_restore((out / "extractor.msgpack").read_bytes())
    stats = np.load(out / "feat_stats.npz")
    scp = read_2column_text(tmp_path / "spk" / "spk_embed.scp")
    assert len(scp) == 6
    assert len(read_2column_text(tmp_path / "spk" / "spk2emb.scp")) == 2
    feats = jspk_extract._load_feats(tmp_path / "spk", 20, 800)
    je = jspk.SpeakerEmbeddingExtractor(n_spk=2, embed_dim=6, channels=8)
    for utt, path in scp.items():
        f = (feats[utt] - stats["mean"]) / stats["std"]
        want = je.apply(variables, jnp.asarray(f[None]),
                        jnp.asarray([f.shape[0]], np.int32))
        np.testing.assert_allclose(np.load(path), np.asarray(want)[0],
                                   rtol=1e-4, atol=1e-4)


def test_run_tts_runs_its_stages_with_the_port_clis(tmp_path):
    """Stages 1-9 at a reduced size on a synthetic corpus (two speakers,
    the x-vector stage on), resumable from the stage markers."""
    generate_corpus(tmp_path / "data" / "train", n_utts=8, min_words=1,
                    max_words=2, n_spk=2)
    generate_corpus(tmp_path / "data" / "test", n_utts=2, min_words=1,
                    max_words=2, n_spk=2, seed=5)
    tts = " ".join(TACO_ARGS[2:])
    run_tts.main([
        "--recipe.expdir", str(tmp_path / "exp"),
        "--recipe.datadir", str(tmp_path / "data"),
        "--recipe.local_data", "",
        "--recipe.use_xvector", "true",
        "--recipe.xvector_args", "--epochs 1 --channels 8 --embed_dim 4",
        "--recipe.tts_args", tts,
        "--recipe.synth_args", "--max_frames 32 --griffin_lim_iters 2",
        "--device", "cpu"])
    exp = tmp_path / "exp"
    for n in range(1, 10):
        assert (exp / f".stage{n}.done").exists(), n
    assert (exp / "spk_embed" / "extractor.msgpack").exists()
    assert (exp / "tts" / "checkpoint.pt").exists()
    assert len(list((exp / "synth_test" / "wav").glob("*.wav"))) == 2
    assert "MCD mean" in (exp / "score_test" / "score_mcd.txt").read_text()
    assert (exp / "RESULTS.md").exists()


def test_tts_global_mvn_statistics_are_the_jax_tasks(ws, tmp_path):
    """Both TTS tasks collect the MVN moments of the log-mel at the
    frontend's default band (fmin 0, no fmax) while the model's features
    use fmin 80 and fmax 7600 (ROADMAP.md queue 3): the port's moments
    are the JAX task's, and not those of the features they normalise."""
    from espnet_tpu.data.dataset import ASRDataset as JASRDataset
    from espnet_tpu.data.sampler import build_batches as jbuild_batches
    from espnet_tpu.data.tokenizer import (TokenIDConverter as JConv,
                                           build_tokenizer as jtok)
    from espnet_tpu.train.collect_stats import collect_stats as jcollect
    from espnet_tpu_torch.data.dataset import ASRDataset
    from espnet_tpu_torch.data.sampler import build_batches
    from espnet_tpu_torch.data.tokenizer import (TokenIDConverter,
                                                 build_tokenizer)
    from espnet_tpu_torch.models.tts.model import TTSModel
    from espnet_tpu_torch.train.collect_stats import collect_stats

    d = ws / "data"
    toks = ["<blank>", "<unk>"] + [chr(c) for c in range(97, 123)] + [
        "<space>", "<sos/eos>"]
    kw = dict(wav_scp=d / "wav.scp", text=d / "text")
    ds = ASRDataset(**kw, tokenizer=build_tokenizer("char"),
                    converter=TokenIDConverter(toks))
    jds = JASRDataset(**kw, tokenizer=jtok("char"), converter=JConv(toks))
    shapes = {"speech": ds.speech_lengths(), "text": ds.text_lengths()}
    args = dict(batch_size=4, length_quantum=8192, text_quantum=8)
    got = collect_stats(ds, build_batches(shapes, **args), tmp_path / "t",
                        n_fft=1024, hop_length=256, n_mels=80, device="cpu")
    want = jcollect(jds, jbuild_batches(shapes, **args), tmp_path / "j",
                    n_fft=1024, hop_length=256, n_mels=80)
    for k in ("count", "sum", "sum_square"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-3)
    model = TTSModel(TTSTask.task_config(dataclasses.replace(
        TTSTask.sections["model"](), normalize="none"), len(toks)))
    total = 0.0
    for b in build_batches(shapes, **args):
        from espnet_tpu_torch.data.dataset import collate

        batch = collate(ds, b)
        feats, lens = model.extract_feats(
            torch.from_numpy(batch["speech"]),
            torch.from_numpy(batch["speech_lengths"]).long())
        total = total + feats.double().sum((0, 1)).numpy()
    assert np.abs(total - got["sum"]).max() > 1.0  # another band
