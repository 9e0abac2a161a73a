"""The slice as a whole: the port's `asr_train` and `asr_inference` against
the JAX package's, on the CPU.

A synthesised corpus (12 training and 4 validation utterances) and the
reduced settings of tests/test_recipe.py (a conformer of d_model 32, one
encoder and one decoder layer, 24 mels, global MVN, SpecAug off, dropout 0,
`sgd` with a constant rate, 2 epochs, 2 micro-batches a step). Both
packages' `ASRTask.main` start from the same JAX initial parameters
(`--run.init_param`); `sgd` keeps the comparison linear in the gradients
(Adam is held by tests/test_torch_optim.py). Then each package's
`asr_inference` decodes both experiment directories.
"""

import importlib.util
import json
import shutil

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from espnet_tpu.bin import asr_inference as jinference
from espnet_tpu.data.dataset import EpochIterator as JEpochIterator
from espnet_tpu.data.sampler import build_batches as jbuild_batches
from espnet_tpu.data.synth import generate_corpus as jgenerate_corpus
from espnet_tpu.data.tokenizer import TokenIDConverter
from espnet_tpu.tasks.asr import ASRTask as JASRTask
from espnet_tpu.train.checkpoint import save_pytree
from espnet_tpu.utils.config import dataclass_to_dict as jdataclass_to_dict
from espnet_tpu_torch.bin import asr_inference as tinference
from espnet_tpu_torch.bin import asr_train as ttrain
from espnet_tpu_torch.data.dataset import EpochIterator as TEpochIterator
from espnet_tpu_torch.data.sampler import build_batches as tbuild_batches
from espnet_tpu_torch.data.synth import generate_corpus
from espnet_tpu_torch.tasks.asr import ASRTask as TASRTask
from espnet_tpu_torch.train.msgpack_io import flatten, load_tree


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

STAT_RTOL = 1e-4       # epoch means of loss and acc
PARAM_REL_L2 = 1e-4    # averaged parameters, per leaf
# encoder/embed/conv0/bias starts at 0 and holds only the steps' updates,
# each a sum over every frame and channel of the first conv's output
# gradient; float32 rounding of those sums, compounded over the six steps,
# moves it by 1.53e-4 of its norm (the other leaves: 8.2e-5 at most)
PARAM_REL_L2_CONV0_BIAS = 3e-4
# a leaf whose reference update over the run is below this share of the
# whole tree's has a gradient of 0 and holds rounding noise only (the key
# projections' biases: softmax ignores a per-query constant); it is left out
ZERO_GRAD_SHARE = 1e-6
SCORE_TOL = 1e-3
FEATS_RTOL = 1e-4

ARGS = (
    "--run.max_epoch 2 --run.log_interval 1 --run.accum_grad 2 "
    "--data.batch_size 4 "
    "--model.n_mels 24 --model.use_specaug false "
    "--model.normalize global_mvn --model.encoder_type conformer "
    "--model.d_model 32 --model.num_heads 2 --model.d_ff 64 "
    "--model.num_encoder_layers 1 --model.num_decoder_layers 1 "
    "--model.decoder_d_ff 64 --model.dropout_rate 0.0 "
    "--model.conformer_kernel_size 7 "
    "--optim.name sgd --optim.schedule constant --optim.lr 0.003"
).split()
DECODE = ["--beam_size", "2", "--max_steps", "24", "--nbest", "2",
          "--batch_size", "4"]


def _argv(ws, out, *extra):
    return ARGS + ["--data.train_dir", str(ws / "train"),
                   "--data.valid_dir", str(ws / "valid"),
                   "--run.output_dir", str(ws / out), *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ws = tmp_path_factory.mktemp("cli")
    generate_corpus(ws / "train", n_utts=12, seed=0)
    generate_corpus(ws / "valid", n_utts=4, seed=1)
    # the JAX initial parameters: the token list and the stats come first
    JASRTask.main(_argv(ws, "jexp", "--run.stats_only", "true"))
    cfg = JASRTask.load_config(ws / "jexp")
    vocab = len(TokenIDConverter.from_file(ws / "jexp" / "tokens.txt"))
    jm = JASRTask.build_model(cfg["model"], vocab)
    init = fnn.meta.unbox(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16000)), jnp.array([16000]),
        jnp.ones((1, 3), jnp.int32), jnp.array([3]), True))
    save_pytree(ws / "init.msgpack", init["params"])
    init_param = ["--run.init_param", str(ws / "init.msgpack")]
    jrun = JASRTask.main(_argv(ws, "jexp", *init_param))
    trun = ttrain.main(_argv(ws, "texp", *init_param, "--device", "cpu"))
    return ws, jrun[1].reporter, trun[1].reporter


def test_corpus_writer_is_the_jax_one(tmp_path):
    generate_corpus(tmp_path / "t", n_utts=2, seed=3)
    jgenerate_corpus(tmp_path / "j", n_utts=2, seed=3)
    assert (tmp_path / "t" / "text").read_text() == \
        (tmp_path / "j" / "text").read_text()
    for name in ("utt0000.wav", "utt0001.wav"):
        assert (tmp_path / "t" / "wav" / name).read_bytes() == \
            (tmp_path / "j" / "wav" / name).read_bytes()


def test_batches_and_token_ids_match_jax(runs):
    ws = runs[0]
    out = {}
    for task, build_batches, iterator, exp in (
            (JASRTask, jbuild_batches, JEpochIterator, "jexp"),
            (TASRTask, tbuild_batches, TEpochIterator, "texp")):
        cfg = task.load_config(ws / exp)
        data = cfg["data"]
        tok = task.build_tokenizer(data, ws / exp)
        conv = task.build_token_list(data, ws / exp, tok)
        ds = task.build_dataset(data, ws / "train", tok, conv)
        batches = build_batches(
            {"speech": ds.speech_lengths(), "text": ds.text_lengths()},
            batch_size=data.batch_size, length_quantum=data.length_quantum,
            text_quantum=data.text_quantum)
        it = iterator(ds, batches, seed=cfg["run"].seed, num_shards=1,
                      shard_index=0)
        out[exp] = [b for e in (1, 2) for b in it.epoch(e)]
    assert len(out["jexp"]) == len(out["texp"]) == 6
    for jb, tb in zip(out["jexp"], out["texp"]):
        assert jb["keys"] == tb["keys"]
        assert set(jb) == set(tb)
        for k in jb:
            if k != "keys":
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_collect_stats_match_jax(runs):
    ws = runs[0]
    j = np.load(ws / "jexp" / "stats" / "feats_stats.npz")
    t = np.load(ws / "texp" / "stats" / "feats_stats.npz")
    for k in ("count", "sum", "sum_square"):
        np.testing.assert_allclose(t[k], j[k], rtol=FEATS_RTOL, err_msg=k)
    for name in ("speech_shape", "text_shape"):
        assert (ws / "texp" / "stats" / name).read_text() == \
            (ws / "jexp" / "stats" / name).read_text()


def test_epoch_stats_match_jax(runs):
    _, jrep, trep = runs
    for epoch in (1, 2):
        for phase in ("train", "valid"):
            for key in ("loss", "acc"):
                want = jrep.epochs[epoch][phase][key]
                got = trep.epochs[epoch][phase][key]
                np.testing.assert_allclose(
                    got, want, rtol=STAT_RTOL,
                    err_msg=f"epoch {epoch} {phase} {key}")
    assert trep.epochs[2]["train"]["skipped"] == 0.0


def test_averaged_params_and_token_list_match_jax(runs):
    ws = runs[0]
    names = ("config.yaml", "tokens.txt", "ep1.params.msgpack",
             "ep2.params.msgpack", "valid.acc.best.params.msgpack",
             "valid.acc.ave.params.msgpack", "checkpoint.meta.json")
    for name in names:
        assert (ws / "texp" / name).exists(), name
    assert (ws / "texp" / "checkpoint.pt").exists()
    assert (ws / "texp" / "tokens.txt").read_text() == \
        (ws / "jexp" / "tokens.txt").read_text()
    want = flatten(load_tree(ws / "jexp" / "valid.acc.ave.params.msgpack"))
    got = flatten(load_tree(ws / "texp" / "valid.acc.ave.params.msgpack"))
    init = flatten(load_tree(ws / "init.msgpack"))
    assert set(got) == set(want) == set(init)
    moved = {k: np.linalg.norm(w - init[k]) for k, w in want.items()}
    whole = np.sqrt(sum(m ** 2 for m in moved.values()))
    zero = {k for k, m in moved.items() if m < ZERO_GRAD_SHARE * whole}
    assert zero and all(k.endswith("k_proj/bias") for k in zero), zero
    for k, w in want.items():
        assert got[k].dtype == w.dtype == np.float32, k
        if k in zero:
            continue
        limit = (PARAM_REL_L2_CONV0_BIAS if k == "encoder/embed/conv0/bias"
                 else PARAM_REL_L2)
        dev = np.linalg.norm(got[k] - w) / np.linalg.norm(w)
        assert dev < limit, (k, dev)


def test_each_package_reads_the_others_config(runs):
    ws = runs[0]

    def sections(task, exp):
        cfg = task.load_config(ws / exp)
        out = {s: jdataclass_to_dict(v) for s, v in cfg.items()}
        out["run"].pop("output_dir")
        return out

    assert sections(JASRTask, "texp") == sections(JASRTask, "jexp")
    assert sections(TASRTask, "jexp") == sections(TASRTask, "texp")


def _nbest(path):
    rows = [json.loads(line) for line in open(path / "nbest.jsonl")]
    return {r["key"]: r for r in rows}


@pytest.mark.parametrize("exp", ["texp", "jexp"],
                         ids=["port_directory", "jax_directory"])
def test_both_inference_clis_decode_either_directory(runs, exp):
    ws = runs[0]
    base = ["--exp_dir", str(ws / exp), "--data_dir", str(ws / "valid")]
    jinference.main(base + ["--output_dir", str(ws / exp / "jdec")]
                    + DECODE)
    tinference.main(base + ["--output_dir", str(ws / exp / "tdec")]
                    + DECODE + ["--device", "cpu"])
    for name in ("text", "nbest.jsonl", "rtf.txt", "score_wer.txt",
                 "score_cer.txt"):
        assert (ws / exp / "tdec" / name).exists(), name
    want, got = _nbest(ws / exp / "jdec"), _nbest(ws / exp / "tdec")
    assert set(got) == set(want) and len(got) == 4
    for key, w in want.items():
        g = got[key]
        if g["nbest"][0]["ids"] == w["nbest"][0]["ids"]:
            assert abs(g["score"] - w["score"]) < SCORE_TOL, key
            assert g["text"] == w["text"], key
            continue
        # a near-tie: each package's best must be the other's runner-up,
        # within the score tolerance
        runner = {tuple(h["ids"]): h["score"] for h in g["nbest"]}
        best = tuple(w["nbest"][0]["ids"])
        assert best in runner, key
        assert abs(runner[best] - w["score"]) < SCORE_TOL, key
        assert abs(g["score"] - w["score"]) < SCORE_TOL, key
    assert (ws / exp / "tdec" / "text").read_text().count("\n") == 4


def test_resume_runs_only_the_epochs_left(runs, tmp_path):
    ws = runs[0]
    shutil.copytree(ws / "texp", tmp_path / "texp")
    out = ttrain.main(_argv(ws, "unused") + [
        "--run.output_dir", str(tmp_path / "texp"), "--run.max_epoch", "3",
        "--device", "cpu"])
    trainer = out[1]
    assert sorted(trainer.epoch_seconds) == [3]
    assert sorted(trainer.reporter.epochs) == [1, 2, 3]
    assert trainer.reporter.epochs[2] == runs[2].epochs[2]
    assert (tmp_path / "texp" / "ep3.params.msgpack").exists()


def test_profile_steps_write_a_trace(runs, tmp_path):
    ws = runs[0]
    out = ttrain.main(_argv(ws, "unused") + [
        "--run.output_dir", str(tmp_path / "p"), "--run.max_epoch", "1",
        "--run.profile_steps", "1", "--device", "cpu"])
    trace = json.loads((tmp_path / "p" / "profile" / "trace.json")
                       .read_text())
    assert trace["traceEvents"]
    assert sorted(out[1].epoch_seconds) == [1]


def test_jax_resume_state_is_refused(runs, tmp_path):
    """(Named for its first check: the port once refused this state.) A
    directory that holds only the JAX package's resume state: the port's
    trainer resumes it (parameters, sgd's momentum trace and the count, in
    the port's flat order) and runs epoch 3 alone."""
    ws = runs[0]
    (tmp_path / "jexp").mkdir()
    for name in ("config.yaml", "tokens.txt", "checkpoint.msgpack",
                 "checkpoint.meta.json"):
        shutil.copy(ws / "jexp" / name, tmp_path / "jexp" / name)
    shutil.copytree(ws / "jexp" / "stats", tmp_path / "jexp" / "stats")
    _, trainer, model, _, _ = ttrain.main(_argv(ws, "unused") + [
        "--run.output_dir", str(tmp_path / "jexp"), "--run.max_epoch", "3",
        "--device", "cpu"])
    assert sorted(trainer.epoch_seconds) == [3]
    assert sorted(trainer.reporter.epochs) == [1, 2, 3]
    assert (tmp_path / "jexp" / "ep3.params.msgpack").exists()
    assert (tmp_path / "jexp" / "checkpoint.pt").exists()
    # epochs 1 and 2 are JAX's record; epoch 3 went on from JAX's state
    # (a fresh start would begin near epoch 1's loss)
    ep = trainer.reporter.epochs
    for e in (1, 2):
        assert ep[e]["train"]["loss"] == runs[1].epochs[e]["train"]["loss"]
    for phase in ("train", "valid"):
        assert ep[3][phase]["loss"] < ep[2][phase]["loss"]


@pytest.fixture(scope="module")
def plain_decode(runs, tmp_path_factory):
    """The port's decode of the port's directory, without any LM."""
    ws = runs[0]
    out = tmp_path_factory.mktemp("plain_decode")
    texts = tinference.main(["--exp_dir", str(ws / "texp"), "--data_dir",
                             str(ws / "valid"), "--output_dir", str(out),
                             "--device", "cpu"] + DECODE)
    return texts, _nbest(out)


@pytest.mark.parametrize("extra", [
    ["--search", "timesync"],
    ["--word_lm_exp_dir", "wlm"],
    ["--ngram_file", "x.arpa"],
    ["--ngram_weight", "0.3"],
    ["--search", "timesync", "--ngram_file", "{arpa}", "--ngram_weight",
     "0.3"],
], ids=["timesync", "word_lm_exp_dir", "ngram_file", "ngram_weight",
        "timesync_ngram"])
def test_fusion_and_timesync_flags_parse_and_decode(runs, plain_decode,
                                                    extra, tmp_path):
    """The n-gram, word-LM and time-synchronous flags decode. A word LM
    directory or an n-gram file without its weight, or a weight without
    its file, is never read (the paths here do not exist), as in JAX: the
    decode is the plain one. `--search timesync` writes each utterance's
    n-best, best first, its text the tokenizer's rendering of the best;
    with a weighted n-gram (`bin.ngram_train` on the training text) its
    scores move (tests/test_torch_timesync.py holds both against JAX's
    search)."""
    from espnet_tpu_torch.bin import ngram_train
    from espnet_tpu_torch.tasks.asr import ASRTask

    ws = runs[0]
    base = ["--exp_dir", str(ws / "texp"), "--data_dir", str(ws / "valid"),
            "--device", "cpu"] + DECODE
    arpa = tmp_path / "3gram.arpa"
    if "{arpa}" in extra:
        ngram_train.main(["--data_dir", str(ws / "train"), "--exp_dir",
                          str(ws / "texp"), "--output", str(arpa)])
    extra = [a.format(arpa=arpa) for a in extra]
    got = tinference.main(base + ["--output_dir", str(tmp_path / "t")]
                          + extra)
    assert len(got) == 4 and (tmp_path / "t" / "score_wer.txt").exists()
    have = _nbest(tmp_path / "t")
    if "--search" not in extra:
        assert (got, have) == plain_decode
        return
    cfg = ASRTask.load_config(ws / "texp")
    tok = ASRTask.build_tokenizer(cfg["data"], ws / "texp")
    conv = ASRTask.build_token_list(cfg["data"], ws / "texp", tok)
    for key, row in have.items():
        scores = [h["score"] for h in row["nbest"]]
        assert scores == sorted(scores, reverse=True) and len(scores) == 2
        assert row["text"] == got[key] == tok.tokens2text(
            conv.ids2tokens(row["nbest"][0]["ids"]))
    if "--ngram_file" in extra:
        tinference.main(base + ["--output_dir", str(tmp_path / "p"),
                                "--search", "timesync"])
        assert _nbest(tmp_path / "p") != have


@pytest.mark.parametrize("extra", [
    ["--lm_exp_dir", "lm", "--lm_weight", "0.3"],
    ["--lm_weight", "0.3"],
], ids=["lm_exp_dir", "lm_weight"])
def test_neural_lm_inference_flags_pass_the_check(runs, extra):
    """The neural LM's flags parse (a missing LM directory then fails where
    it is read; tests/test_torch_multi_cli.py decodes with one)."""
    ws = runs[0]
    argv = ["--exp_dir", str(ws / "texp"), "--data_dir", str(ws / "valid"),
            "--output_dir", str(ws / "unused"), "--device", "cpu"] + extra
    args = tinference.get_parser().parse_args(argv)
    assert args.lm_weight == 0.3


def _feats_dirs(ws, tmp_path):
    """The corpus's 24-mel log-mel features in Kaldi feats.scp dirs."""
    from espnet_tpu_torch.data.fileio import read_2column_text, read_wav
    from espnet_tpu_torch.data.kaldi_io import write_kaldi_ark_scp
    from espnet_tpu_torch.ops.stft import log_mel_spectrogram

    for split in ("train", "valid"):
        mats = {}
        for key, path in read_2column_text(ws / split / "wav.scp").items():
            wav, _ = read_wav(path)
            f, n = log_mel_spectrogram(torch.from_numpy(wav)[None],
                                       torch.tensor([len(wav)]), n_mels=24)
            mats[key] = f[0, :int(n[0])].numpy()
        d = tmp_path / split
        write_kaldi_ark_scp(mats, d / "feats.ark", d / "feats.scp")
        shutil.copy(ws / split / "text", d / "text")
    return ["--data.train_dir", str(tmp_path / "train"), "--data.valid_dir",
            str(tmp_path / "valid"), "--data.input_type", "feats",
            "--model.input_type", "feats"]


@pytest.mark.parametrize("extra", [
    ["--model.interctc_layer_idx", "1,", "--model.interctc_weight", "0.3"],
    ["--model.ctc_weight", "1.0"],
    ["--model.remat_encoder", "true"],
    "feats",
    ["--run.plot_attention", "true"],
    ["--model.encoder_type", "contextual_block_conformer",
     "--model.block_size", "8", "--model.stream_hop_size", "4",
     "--model.look_ahead", "2"],
], ids=["interctc", "ctc_weight_1", "remat", "feats", "plot_attention",
        "contextual_block_conformer"])
def test_ported_model_options_train(runs, tmp_path, extra):
    """Model options the port once refused train one epoch through the CLI
    and write the JAX tree of their model."""
    ws = runs[0]
    if extra == "feats":
        extra = _feats_dirs(ws, tmp_path)
    out = tmp_path / "x"
    argv = _argv(ws, "unused") + ["--run.output_dir", str(out),
                                  "--run.max_epoch", "1", "--device",
                                  "cpu"] + extra
    _, trainer, model, _, _ = ttrain.main(argv)
    losses = [st["loss"] for _, st in trainer.step_log]
    assert losses and all(np.isfinite(v) for v in losses)
    leaves = set(flatten(load_tree(out / "ep1.params.msgpack")))
    assert any(k.startswith("decoder/") for k in leaves) == (
        model.decoder is not None)
    stats = trainer.reporter.epochs[1]["train"]
    assert ("loss_interctc_layer1" in stats) == ("interctc" in str(argv))
    plots = list((out / "att_ws" / "ep1").glob("*.png"))
    assert bool(plots) == ("plot_attention" in str(argv)
                           and importlib.util.find_spec("matplotlib")
                           is not None)


def test_entry_points_raise_without_a_card(runs, tmp_path, monkeypatch):
    ws = runs[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(_argv(ws, "unused") + ["--run.output_dir",
                                           str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinference.main(["--exp_dir", str(ws / "texp"), "--data_dir",
                         str(ws / "valid"), "--output_dir",
                         str(tmp_path / "d")])
