"""JAX-trained experiments read by the port, on the CPU.

* `egs_work/synth_hard/exp/asr`: a 6 x 128 conformer (kernel 15, FFN 512,
  a 2-layer decoder, CTC 0.3, global MVN, char tokens) trained by the JAX
  package for 30 epochs. The port's `Speech2Text` and JAX's decode the same
  4 test utterances from `valid.acc.ave.params.msgpack` with the recipe's
  decode_args (beam 5, CTC weight 0.3, 60 label steps: the arguments that
  wrote `exp/decode_test`): the same token ids, scores within 1e-4, and the
  port's text is `exp/decode_test/text`'s for those utterances.
* The same directory's resume state `checkpoint.msgpack` (epoch 30) loads
  into the port's train state: its parameters are `ep30.params.msgpack`'s,
  and the step and the count are read back.
* `egs_work/an4/exp/asr/ep300.params.msgpack`, a 4 x 64 transformer: the
  two AN4 test utterances (a data dir written by the port's `prep_an4` from
  `egs_work/an4/downloads/an4`) decoded by both packages with the JAX CLI's
  defaults (beam 10, CTC weight 0.3), the same tolerances.
"""

from pathlib import Path

import flax.serialization as fser
import numpy as np
import pytest
import torch

from espnet_tpu.decode.asr_inference import Speech2Text as JSpeech2Text
from espnet_tpu.tasks.asr import ASRTask as JASRTask
from espnet_tpu.train.collect_stats import load_stats as jload_stats
from espnet_tpu.train.collect_stats import mvn_variables as jmvn_variables
from espnet_tpu_torch.bin.asr_inference import load_experiment
from espnet_tpu_torch.bin.prep_an4 import main as prep_an4
from espnet_tpu_torch.convert import jax_params_to_state_dict
from espnet_tpu_torch.data.fileio import read_2column_text
from espnet_tpu_torch.decode.asr_inference import Speech2Text
from espnet_tpu_torch.tasks.asr import ASRTask
from espnet_tpu_torch.train.checkpoint import CheckpointManager
from espnet_tpu_torch.train.msgpack_io import load_tree
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.train.steps import TrainState


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
SYNTH = Path("egs_work/synth_hard")
AN4 = Path("egs_work/an4")
SCORE_TOL = 1e-4
SYNTH_DECODE = dict(beam_size=5, ctc_weight=0.3, max_steps=60)
AN4_DECODE = dict(beam_size=10, ctc_weight=0.3, max_steps=0)


@pytest.fixture(autouse=True)
def repo_root(monkeypatch):
    """The experiments name their files relative to the repository."""
    monkeypatch.chdir(REPO)


def _padded(ds, keys):
    waves = [np.asarray(ds[k]["speech"], np.float32) for k in keys]
    speech = np.zeros((len(waves), max(len(w) for w in waves)), np.float32)
    for i, w in enumerate(waves):
        speech[i, :len(w)] = w
    return speech, np.array([len(w) for w in waves], np.int32)


def _decode_both(exp, params, data_dir, keys, decode):
    """(JAX results, port results) of one padded batch of `keys`."""
    cfg = JASRTask.load_config(exp)
    data = cfg["data"]
    tok = JASRTask.build_tokenizer(data, exp)
    conv = JASRTask.build_token_list(data, exp, tok)
    jm = JASRTask.build_model(cfg["model"], len(conv))
    jparams = fser.msgpack_restore((exp / params).read_bytes())
    extra = {"mvn": jmvn_variables(jload_stats(exp / "stats" /
                                               "feats_stats.npz"))}
    model, _, ds, ttok, tconv = load_experiment(exp, data_dir,
                                                exp / params)
    speech, lens = _padded(ds, keys)
    want = JSpeech2Text(jm, jparams, extra, tok, conv, **decode)(
        speech, lens, keys=keys)
    got = Speech2Text(model, device="cpu", tokenizer=ttok, converter=tconv,
                      **decode)(speech, lens, keys=keys)
    for w, g in zip(want, got):
        assert g.key == w.key
        assert g.token_ids == [int(t) for t in w.token_ids]
        assert abs(g.score - float(w.score)) <= SCORE_TOL
        assert g.text == w.text
    return want, got


def test_synth_hard_decode_matches_jax_and_its_decode():
    exp = SYNTH / "exp" / "asr"
    ref = read_2column_text(SYNTH / "exp" / "decode_test" / "text")
    keys = sorted(ref)[:4]
    _, got = _decode_both(exp, "valid.acc.ave.params.msgpack",
                          SYNTH / "data" / "test", keys, SYNTH_DECODE)
    assert [g.text for g in got] == [ref[k] for k in keys]


def test_synth_hard_resume_state_loads():
    exp = SYNTH / "exp" / "asr"
    cfg = ASRTask.load_config(exp)
    data, optim = cfg["data"], cfg["optim"]
    tok = ASRTask.build_tokenizer(data, exp)
    model = ASRTask.build_model(cfg["model"], len(
        ASRTask.build_token_list(data, exp, tok)))
    tx = build_optimizer(optim.name, lr=optim.lr, schedule=optim.schedule,
                         warmup_steps=optim.warmup_steps, d_model=128)
    state = TrainState.create(model, tx)
    state, epoch, reporter, gen = CheckpointManager(exp).load_state(
        state, model)
    assert (epoch, state.step, int(state.opt_state["count"])) == (
        30, 1410, 1410)
    assert gen is None and sorted(map(int, reporter["epochs"])) == list(
        range(1, 31))
    want = jax_params_to_state_dict(load_tree(exp / "ep30.params.msgpack"))
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name
    assert float(state.opt_state["nu"].min()) >= 0.0
    assert float(state.opt_state["nu"].max()) > 0.0


def test_an4_decode_matches_jax(tmp_path):
    prep_an4(["--an4_root", str(AN4 / "downloads" / "an4"), "--output_dir",
              str(tmp_path / "data")])
    keys = sorted(read_2column_text(tmp_path / "data" / "test" / "wav.scp"))
    assert len(keys) == 2
    _decode_both(AN4 / "exp" / "asr", "ep300.params.msgpack",
                 tmp_path / "data" / "test", keys, AN4_DECODE)
