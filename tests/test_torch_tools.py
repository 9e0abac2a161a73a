"""The rest of the ASR tooling against the JAX package's, on the CPU:

* cross-package resume: a reduced JAX model (conformer d 32, one encoder and
  one decoder layer, global MVN, dropout and SpecAug off) takes two JAX
  train steps with optax Adam and is saved by the JAX `CheckpointManager`;
  the port resumes its `checkpoint.msgpack` (the trainer's path) bit for
  bit, and one more step in each package gives the same parameters and Adam
  moments (float32, relative L2 1e-5 per tensor over the elements whose
  gradient is not 0 but for rounding);
* `train/plot.py`: the attention maps of one batch (names, shapes, values
  within 1e-5) and the PNG files `dump_attention_plots` writes (JAX's
  names);
* `bin.average_checkpoints` (the port's equals `average_nbest`; the JAX
  CLI, which sums in float32, within 1e-6), `bin.aggregate_stats_dirs`,
  `bin.split_scps`, `bin.tokenize_text` with `data/text_norm.py`'s
  cleaners, and `bin.prep_an4` on the AN4 corpus in egs_work: the same
  files as the JAX CLIs write.
"""

from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models.asr import ASRConfig as JASRConfig
from espnet_tpu.models.asr import ASRModel as JASRModel
from espnet_tpu.train import checkpoint as jckpt
from espnet_tpu.train.optim import build_optimizer as jbuild_optimizer
from espnet_tpu.train.plot import collect_attention_maps as jcollect
from espnet_tpu.train.steps import TrainState as JTrainState
from espnet_tpu.train.steps import make_train_step as jmake_train_step
from espnet_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from espnet_tpu_torch.data.synth import generate_corpus
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel
from espnet_tpu_torch.train.checkpoint import CheckpointManager
from espnet_tpu_torch.train.msgpack_io import flatten, load_tree, save_tree
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.train.plot import (collect_attention_maps,
                                         dump_attention_plots)
from espnet_tpu_torch.train.steps import TrainState, make_train_step


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

REPO = Path(__file__).resolve().parents[1]
AN4 = REPO / "egs_work" / "an4" / "downloads" / "an4"
RESUME_REL_L2 = 1e-5
# an element whose Adam second moment is below this share of the largest
# (square roots) has a gradient of 0 but for rounding (the key projections'
# biases, pos_proj columns of unseen relative positions): Adam scales that
# noise up to the rate, so after the next step such elements are left out
ZERO_GRAD_SHARE = 1e-6
MAP_TOL = 1e-5
KEYS = ("speech", "speech_lengths", "text", "text_lengths")


def _kw(**over):
    kw = dict(vocab_size=12, n_mels=16, use_specaug=False,
              normalize="global_mvn", encoder_type="conformer", d_model=32,
              num_heads=2, d_ff=64, num_encoder_layers=1,
              num_decoder_layers=1, decoder_d_ff=64, conformer_kernel_size=5,
              dropout_rate=0.0, ctc_weight=0.3)
    kw.update(over)
    return kw


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    lens = np.array([8000, 6000, 7000], np.int32)
    speech = (0.2 * rng.randn(3, 8000)).astype(np.float32)
    speech[np.arange(8000)[None] >= lens[:, None]] = 0.0
    text = rng.randint(1, 11, (3, 4)).astype(np.int32)
    tlens = np.array([4, 3, 2], np.int32)
    text[np.arange(4)[None] >= tlens[:, None]] = 0
    return {"speech": speech, "speech_lengths": lens, "text": text,
            "text_lengths": tlens}


@pytest.fixture(scope="module")
def jax_model():
    """The reduced JAX model and its variables (params and the MVN
    collection, identity statistics)."""
    jm = JASRModel(JASRConfig(**_kw()))
    b = _batch()
    v = fnn.meta.unbox(jax.jit(jm.init, static_argnums=(5,))(
        jax.random.PRNGKey(0), *(b[k] for k in KEYS), True))
    return jm, v


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def test_resume_a_jax_checkpoint(tmp_path, jax_model):
    jm, v = jax_model
    rng = np.random.RandomState(5)
    mvn = {"mvn": {"mean": rng.randn(16).astype(np.float32),
                   "inv_std": (1 + rng.rand(16)).astype(np.float32)}}
    opt = dict(lr=2e-3, schedule="warmuplr", warmup_steps=3, d_model=32)
    jtx = jbuild_optimizer("adam", **opt)
    jstep = jmake_train_step(jm, jtx, donate=False)
    jstate = JTrainState.create(v["params"], jtx, {"mvn": mvn})
    key = jax.random.PRNGKey(1)
    for seed in (0, 1):
        jstate, _ = jstep(jstate, {k: jnp.asarray(x) for k, x in
                                   _batch(seed).items()}, key)
    jckpt.CheckpointManager(tmp_path).save_state(jstate, 2, {"epochs": {}})
    jnext, _ = jstep(jstate, {k: jnp.asarray(x) for k, x in
                              _batch(2).items()}, key)

    model = ASRModel(ASRConfig(**_kw()))
    tx = build_optimizer("adam", **opt)
    step = make_train_step(model, tx, device="cpu")
    state = TrainState.create(model, tx)
    ckpt = CheckpointManager(tmp_path)
    assert ckpt.has_checkpoint()
    state, epoch, _, gen = ckpt.load_state(state, model)
    assert (epoch, gen, state.step) == (2, None, 2)
    assert int(state.opt_state["count"]) == 2
    # the loaded state is JAX's, bit for bit, in the port's flat order
    jadam = jstate.opt_state[1][0]
    off = 0
    loaded = [jax_params_to_state_dict(jax.device_get(t)) for t in
              (jstate.params, jadam.mu, jadam.nu)]
    for n, p in model.named_parameters():
        for flat, want in zip((state.params, state.opt_state["mu"],
                               state.opt_state["nu"]), loaded):
            assert torch.equal(flat[off:off + p.numel()],
                               want[n].reshape(-1)), n
        off += p.numel()
    np.testing.assert_array_equal(model.mvn.mean.numpy(),
                                  mvn["mvn"]["mean"])
    state, stats = step(state, _batch(2), torch.Generator().manual_seed(0))
    assert float(stats["skipped"]) == 0.0

    names = [n for n, _ in model.named_parameters()]
    views = {"params": dict(zip(names, model.parameters()))}
    for name in ("mu", "nu"):
        views[name], off = {}, 0
        for n, p in model.named_parameters():
            views[name][n] = state.opt_state[name][off:off + p.numel()] \
                .view_as(p)
            off += p.numel()
    adam = jnext.opt_state[1][0]
    nu = jax_params_to_state_dict(jax.device_get(adam.nu))
    floor = ZERO_GRAD_SHARE * np.sqrt(max(float(t.max()) for t in nu.values()))
    signal = {n: np.sqrt(t.numpy()) >= floor for n, t in nu.items()}
    assert not all(m.all() for m in signal.values())
    for name, jtree in (("params", jnext.params), ("mu", adam.mu),
                        ("nu", adam.nu)):
        want = jax_params_to_state_dict(jax.device_get(jtree))
        assert set(want) == set(views[name])
        for n, t in views[name].items():
            m = signal[n]
            err = _rel_l2(t.detach().numpy()[m], want[n].numpy()[m])
            assert err < RESUME_REL_L2, (name, n, err)
    assert int(state.opt_state["count"]) == int(adam.count) == 3


def test_attention_maps_match_jax(tmp_path, jax_model):
    jm, v = jax_model
    tm = load_jax_params(ASRModel(ASRConfig(**_kw())), v)
    batch = dict(_batch(), keys=["a", "b", "c"])
    want = jcollect(jm, v, batch, KEYS)
    got = collect_attention_maps(tm, batch)
    assert sorted(got) == sorted(want) and got
    for name, arr in want.items():
        assert got[name].shape == arr.shape
        np.testing.assert_allclose(got[name], arr, atol=MAP_TOL)
    assert all(m.capture is None for m in tm.modules()
               if hasattr(m, "capture"))
    n = dump_attention_plots(tm, batch, tmp_path, 1)
    names = sorted(p.name for p in (tmp_path / "att_ws" / "ep1")
                   .glob("*.png"))
    # the JAX dump's file names: each map's first two utterances
    assert n == len(names) > 0
    assert names == sorted(f"{k.replace('.', '_')[:80]}.{u}.png"
                           for k in want for u in ("a", "b"))


def _run_both(name, argv_t, argv_j):
    import importlib

    importlib.import_module(f"espnet_tpu_torch.bin.{name}").main(argv_t)
    importlib.import_module(f"espnet_tpu.bin.{name}").main(argv_j)


def test_average_checkpoints(tmp_path):
    rng = np.random.RandomState(0)
    ckpt = CheckpointManager(tmp_path / "exp")
    for e in (1, 2, 3):
        save_tree(ckpt.params_path(e), {
            "enc": {"w": rng.randn(5, 3).astype(np.float32),
                    "b": rng.randn(3).astype(np.float32)},
            "n": np.asarray(e, np.int32)})
    inputs = [str(ckpt.params_path(e)) for e in (1, 2, 3)]
    _run_both("average_checkpoints",
              ["--inputs", *inputs, "--output", str(tmp_path / "t.msgpack")],
              ["--inputs", *inputs, "--output", str(tmp_path / "j.msgpack")])
    got = flatten(load_tree(tmp_path / "t.msgpack"))
    ref = flatten(ckpt.average_nbest([1, 2, 3], "valid.acc"))
    jax_out = flatten(load_tree(tmp_path / "j.msgpack"))
    assert sorted(got) == sorted(ref) == sorted(jax_out)
    for k in got:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])
        np.testing.assert_allclose(got[k], jax_out[k], rtol=1e-6)
    assert int(got["n"]) == 1


def test_aggregate_stats_dirs(tmp_path):
    rng = np.random.RandomState(1)
    dirs = []
    for i in range(3):
        d = tmp_path / f"stats.{i}"
        d.mkdir()
        x = rng.randn(10 + i, 4)
        np.savez(d / "feats_stats.npz", count=np.asarray(len(x)),
                 sum=x.sum(0), sum_square=(x * x).sum(0))
        dirs.append(str(d))
    _run_both("aggregate_stats_dirs",
              ["--input_dirs", *dirs, "--output_dir", str(tmp_path / "t")],
              ["--input_dirs", *dirs, "--output_dir", str(tmp_path / "j")])
    with np.load(tmp_path / "t" / "feats_stats.npz") as t, \
            np.load(tmp_path / "j" / "feats_stats.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            np.testing.assert_array_equal(t[k], j[k])


def test_split_scps(tmp_path):
    generate_corpus(tmp_path / "data", n_utts=7, seed=0)
    scps = [str(tmp_path / "data" / f) for f in ("wav.scp", "text")]
    _run_both("split_scps",
              ["--scps", *scps, "--num_splits", "3", "--output_dir",
               str(tmp_path / "t")],
              ["--scps", *scps, "--num_splits", "3", "--output_dir",
               str(tmp_path / "j")])
    files = sorted(p.relative_to(tmp_path / "t")
                   for p in (tmp_path / "t").rglob("*") if p.is_file())
    assert len(files) == 7
    for f in files:
        assert (tmp_path / "t" / f).read_text() == \
            (tmp_path / "j" / f).read_text()


TEXT = ("utt1 Hello, world! Mr. Smith's 1,234.5 dollars -- don't stop.\n"
        "utt2 ＡＢＣ１２３ full-width (test) l'eau \"quoted\" U.S. e.g. end.\n"
        "utt3 plain text\n")


@pytest.mark.parametrize("args", [
    ["--token_type", "char"],
    ["--token_type", "word", "--field", "2-"],
    ["--token_type", "word", "--field", "2-", "--cleaner", "moses"],
    ["--token_type", "char", "--cleaner", "nkf"],
    ["--token_type", "word", "--cleaner", "moses", "--lang", "fr"],
], ids=["char", "word_field", "moses", "nkf", "moses_fr"])
def test_tokenize_text(tmp_path, args):
    src = tmp_path / "text"
    src.write_text(TEXT, encoding="utf-8")
    _run_both("tokenize_text",
              ["--input", str(src), "--output", str(tmp_path / "t")] + args,
              ["--input", str(src), "--output", str(tmp_path / "j")] + args)
    got = (tmp_path / "t").read_text(encoding="utf-8")
    assert got == (tmp_path / "j").read_text(encoding="utf-8")
    assert len(got.splitlines()) == 3


def test_text_norm_matches_jax():
    from espnet_tpu.data import text_norm as jnorm
    from espnet_tpu_torch.data import text_norm as tnorm

    for line in TEXT.splitlines():
        for lang in ("en", "fr"):
            toks = tnorm.moses_tokenize(line, lang)
            assert toks == jnorm.moses_tokenize(line, lang)
            assert tnorm.moses_detokenize(toks, lang) == \
                jnorm.moses_detokenize(toks, lang)
        assert tnorm.normalize_charset(line, False) == \
            jnorm.normalize_charset(line, False)


def test_prep_an4(tmp_path):
    _run_both("prep_an4",
              ["--an4_root", str(AN4), "--output_dir", str(tmp_path / "t")],
              ["--an4_root", str(AN4), "--output_dir", str(tmp_path / "j")])
    from espnet_tpu_torch.data.fileio import read_2column_text, read_wav

    for name, n in (("train", 5), ("test", 2), ("train_dev", 2),
                    ("train_nodev", 3)):
        for f in ("wav.scp", "text", "utt2spk", "spk2utt"):
            got = (tmp_path / "t" / name / f).read_text()
            assert got == (tmp_path / "j" / name / f).read_text()
        assert len(read_2column_text(tmp_path / "t" / name / "text")) == n
    wav, sr = read_wav(next(iter(read_2column_text(
        tmp_path / "t" / "test" / "wav.scp").values())))
    assert sr == 16000 and 0.0 < abs(wav).max() <= 1.0
