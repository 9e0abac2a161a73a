"""The port's enhancement CLIs (`bin/enh_{train,inference,scoring}.py`,
`bin/run_enh.py`, `recipe_enh.py`) against the JAX package's, on the CPU.

On a synthetic two-speaker corpus (`data/synth.py`
`generate_mixture_corpus`, the same numpy code in both packages), an
experiment trained by either package is separated by both packages'
`enh_inference`: the same wavs (int16, within 3 LSB) and the same mean
SI-SNR (within 1e-3 dB); both packages' `enh_scoring` give the same score
files. A JAX `checkpoint.msgpack` resumes in the port's trainer, and the
port's epoch params go back into JAX's `enh_inference`. The chunk
iterator draws JAX's windows. `run_enh` runs its seven stages and skips
the done ones on a second run.
"""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from espnet_tpu.bin import enh_inference as jinf
from espnet_tpu.bin import enh_scoring as jscore
from espnet_tpu.bin import enh_train as jtrain
from espnet_tpu.data.dataset import ChunkIterator as JChunk
from espnet_tpu.data.dataset import EnhDataset as JEnhDataset
from espnet_tpu_torch.bin import enh_inference as tinf
from espnet_tpu_torch.bin import enh_scoring as tscore
from espnet_tpu_torch.bin import enh_train as ttrain
from espnet_tpu_torch.bin import run_enh
from espnet_tpu_torch.data.dataset import ChunkIterator as TChunk
from espnet_tpu_torch.data.dataset import EnhDataset as TEnhDataset
from espnet_tpu_torch.data.fileio import read_wav
from espnet_tpu_torch.data.synth import generate_mixture_corpus

TINY = ["--model.enc_channels", "16", "--model.enc_kernel", "16",
        "--model.enc_stride", "8", "--model.separator_type", "tcn",
        "--model.tcn_layers", "2", "--model.tcn_stacks", "1",
        "--model.tcn_bottleneck", "8", "--model.tcn_hidden", "16",
        "--model.dropout_rate", "0.0", "--optim.schedule", "constant",
        "--optim.lr", "0.001", "--run.log_interval", "1000",
        "--run.best_metric", "valid.loss.min", "--data.batch_size", "4"]
WAV_LSB = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one thread, and one for the subprocesses `run_enh`
    starts: the suite's xdist workers share the CPU, and a worker's extra
    threads oversubscribe it."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("enh_cli")
    generate_mixture_corpus(root / "train", n_utts=6, seed=0)
    generate_mixture_corpus(root / "test", n_utts=3, seed=5)
    return root


def train_argv(ws, out, epochs=1):
    return ["--run.output_dir", str(out), "--data.train_dir",
            str(ws / "train"), "--data.valid_dir", str(ws / "train"),
            "--run.max_epoch", str(epochs)] + TINY


def separate_with_both(ws, exp, tmp, params=None):
    extra = ["--params", str(params)] if params else []
    argv = ["--exp_dir", str(exp), "--data_dir", str(ws / "test"),
            "--batch_size", "2"] + extra
    tinf.main(argv + ["--output_dir", str(tmp / "sep_port"),
                      "--device", "cpu"])
    jinf.main(argv + ["--output_dir", str(tmp / "sep_jax")])
    for spk in ("spk1.scp", "spk2.scp"):
        port = (tmp / "sep_port" / spk).read_text().split("\n")
        jax_ = (tmp / "sep_jax" / spk).read_text().split("\n")
        assert [ln.split()[0] for ln in port if ln] == \
            [ln.split()[0] for ln in jax_ if ln]
        for lp, lj in zip(port, jax_):
            if not lp:
                continue
            a, _ = read_wav(lp.split()[1])
            b, _ = read_wav(lj.split()[1])
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= WAV_LSB / 32767 + 1e-7
    si_port = float((tmp / "sep_port" / "si_snr.txt").read_text())
    si_jax = float((tmp / "sep_jax" / "si_snr.txt").read_text())
    assert abs(si_port - si_jax) <= 1e-3
    return tmp / "sep_port", tmp / "sep_jax"


def score_with_both(ws, sep, tmp):
    argv = []
    for i in (1, 2):
        argv += ["--ref_scp", str(ws / "test" / f"spk{i}.scp")]
    for i in (1, 2):
        argv += ["--inf_scp", str(sep / f"spk{i}.scp")]
    tscore.main(argv + ["--output_dir", str(tmp / "score_port")])
    jscore.main(argv + ["--output_dir", str(tmp / "score_jax")])
    for name in ("RESULTS", "STOI", "ESTOI", "SI_SNR", "SDR", "PESQ_PY"):
        assert (tmp / "score_port" / name).read_text() == \
            (tmp / "score_jax" / name).read_text()


def test_port_experiment_separates_and_scores_alike_in_both(ws, tmp_path):
    exp = tmp_path / "exp"
    ttrain.main(train_argv(ws, exp) + ["--device", "cpu"])
    assert (exp / "config.yaml").exists()
    assert list(exp.glob("ep1.params.msgpack"))
    sep_port, _ = separate_with_both(ws, exp, tmp_path)
    score_with_both(ws, sep_port, tmp_path)


def test_jax_experiment_separates_alike_and_resumes_in_the_port(ws,
                                                                 tmp_path):
    exp = tmp_path / "exp"
    jtrain.main(train_argv(ws, exp))
    assert (exp / "checkpoint.msgpack").exists()
    separate_with_both(ws, exp, tmp_path / "a")
    # the JAX resume state goes on in the port's trainer; its epoch 2
    # params go back into JAX's enh_inference
    ttrain.main(train_argv(ws, exp, epochs=2) + ["--device", "cpu"])
    assert (exp / "ep2.params.msgpack").exists()
    assert (exp / "checkpoint.pt").exists()
    separate_with_both(ws, exp, tmp_path / "b",
                       params=exp / "ep2.params.msgpack")


def test_chunk_iterator_draws_jaxs_windows(ws):
    kw = dict(chunk_length=4000, batch_size=3, chunk_shift_ratio=0.5,
              seed=7, fields=("speech_mix", "speech_ref"))
    jds, tds = JEnhDataset(ws / "train"), TEnhDataset(ws / "train")
    jit, tit = JChunk(jds, jds.keys(), **kw), TChunk(tds, tds.keys(), **kw)
    for epoch in (0, 1):
        jb, tb = list(jit.epoch(epoch)), list(tit.epoch(epoch))
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            assert a["keys"] == b["keys"]
            for k in ("speech_mix", "speech_ref", "speech_mix_lengths"):
                np.testing.assert_array_equal(a[k], b[k])


def test_run_enh_stages_and_resume(tmp_path):
    from espnet_tpu_torch.recipe_enh import RecipeEnh, RecipeEnhConfig

    exp, data = tmp_path / "exp" / "enh1", tmp_path / "data"
    enh_args = " ".join(TINY[:-4] + ["--run.max_epoch", "1",
                                     "--data.batch_size", "4"])
    cfg = RecipeEnhConfig(expdir=str(exp), datadir=str(data), synth_utts=6,
                          enh_args=enh_args, stop_stage=4)
    run_enh.main(["--device", "cpu"] + [
        arg for k, v in (("expdir", exp), ("datadir", data),
                         ("synth_utts", "6"), ("stop_stage", "4"))
        for arg in (f"--recipe.{k}", str(v))])
    assert [n for n in range(1, 8) if (exp / f".stage{n}.done").exists()] \
        == [1, 2, 3, 4]
    # a done stage is skipped: its output, replaced, stays as it is
    (exp / "stats" / "data_stats.json").write_text("{}")
    # stages 5-7 run the port's CLIs as subprocesses
    RecipeEnh(RecipeEnhConfig(**{**cfg.__dict__, "stop_stage": 7}),
              device="cpu").run()
    assert (exp / "stats" / "data_stats.json").read_text() == "{}"
    results = (exp / "RESULTS.md").read_text()
    for metric in ("STOI", "ESTOI", "SI_SNR", "SDR", "PESQ_PY"):
        assert metric in results
    assert (exp / "enhanced_test" / "spk2.scp").exists()
    assert all((exp / f".stage{n}.done").exists() for n in range(1, 8))
