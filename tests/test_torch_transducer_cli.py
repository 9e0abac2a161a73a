"""The transducer slice end to end: the port's `asr_transducer_train` and
`asr_transducer_inference` against the JAX package's, on the CPU, in both
directions.

A synthesised corpus (12 training and 3 test utterances) and the reduced
settings of tests/test_transducer_cli.py (a transformer of d_model 32, one
encoder layer, a 32-wide LSTM and joint, 24 mels, SpecAug off, dropout 0),
with global MVN: both packages collect the stats, and both models ignore
them (the JAX quirk the port keeps). Each package trains one experiment
directory; then each package's inference CLI decodes both directories,
greedy (beam 1) and mAES (beam 3), and the texts must be equal.
"""

import json

import numpy as np
import pytest

from espnet_tpu.bin import asr_transducer_inference as jinference
from espnet_tpu.bin import asr_transducer_train as jtrain
from espnet_tpu_torch.bin import asr_transducer_inference as tinference
from espnet_tpu_torch.bin import asr_transducer_train as ttrain
from espnet_tpu_torch.data.fileio import read_2column_text
from espnet_tpu_torch.data.synth import generate_corpus


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

# the searches' scores: the same float32 joint on encoder outputs that
# differ by rounding (the JAX model jits the whole decode)
SCORE_TOL = 1e-3

ARGS = (
    "--run.max_epoch 1 --run.log_interval 1000 "
    "--run.best_metric valid.loss.min --data.batch_size 6 "
    "--model.n_mels 24 --model.use_specaug false "
    "--model.normalize global_mvn --model.encoder_type transformer "
    "--model.d_model 32 --model.num_heads 2 --model.d_ff 64 "
    "--model.num_encoder_layers 1 --model.decoder_embed_dim 32 "
    "--model.decoder_hidden 32 --model.joint_dim 32 "
    "--model.dropout_rate 0.0 --optim.schedule constant --optim.lr 0.002"
).split()


def _argv(ws, out):
    return ARGS + ["--data.train_dir", str(ws / "train"),
                   "--data.valid_dir", str(ws / "train"),
                   "--run.output_dir", str(ws / out)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ws = tmp_path_factory.mktemp("rnnt_cli")
    generate_corpus(ws / "train", n_utts=12, min_words=2, max_words=3)
    generate_corpus(ws / "test", n_utts=3, min_words=2, max_words=3, seed=7)
    jtrain.main(_argv(ws, "exp_jax"))
    ttrain.main(_argv(ws, "exp_port") + ["--device", "cpu"])
    return ws


def test_both_packages_write_the_same_experiment_files(runs):
    for exp in ("exp_jax", "exp_port"):
        d = runs / exp
        for name in ("config.yaml", "tokens.txt", "stats/feats_stats.npz",
                     "valid.loss.ave.params.msgpack"):
            assert (d / name).exists(), (exp, name)
    assert (runs / "exp_jax" / "checkpoint.msgpack").exists()
    assert (runs / "exp_port" / "checkpoint.pt").exists()


def _decode(package, ws, exp, beam):
    out = ws / f"decode_{exp}_{package}_b{beam}"
    argv = ["--exp_dir", str(ws / exp), "--data_dir", str(ws / "test"),
            "--output_dir", str(out), "--beam_size", str(beam),
            "--max_tokens", "24", "--batch_size", "3"]
    if package == "port":
        tinference.main(argv + ["--device", "cpu"])
    else:
        jinference.main(argv)
    rows = {}
    for line in (out / "nbest.jsonl").read_text().splitlines():
        row = json.loads(line)
        rows[row["key"]] = row["score"]
    assert (out / "score_wer.txt").exists()
    return read_2column_text(out / "text"), rows


@pytest.mark.parametrize("exp", ["exp_jax", "exp_port"])
@pytest.mark.parametrize("beam", [1, 3])
def test_each_experiment_decodes_the_same_in_both_packages(runs, exp, beam):
    """A JAX-trained experiment decodes in the port, a port-trained one in
    JAX, greedy and mAES, to the same texts and scores."""
    text_j, scores_j = _decode("jax", runs, exp, beam)
    text_t, scores_t = _decode("port", runs, exp, beam)
    assert len(text_t) == 3
    assert text_t == text_j
    for key, s in scores_j.items():
        np.testing.assert_allclose(scores_t[key], s, atol=SCORE_TOL,
                                   rtol=SCORE_TOL)
