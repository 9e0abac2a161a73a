"""This slice's command-line entry points on the CPU, on tiny synthetic
corpora (8 training and 3 test utterances of 2-3 words; 6 mixtures; 6
two-stream utterances) with reduced models (d_model 32, one layer a
stack, dropout and SpecAug off):

* `asr_maskctc_train` then `asr_inference_maskctc`; and an experiment
  directory written by the JAX package (its config, token list and
  initial parameters) decoded by both packages' inference CLIs to the same
  texts;
* `asr_mulenc_train` then `asr_mulenc_inference`;
* `asr_mix_train` then `asr_mix_inference` (a line a speaker branch, the
  best permutation's WER);
* `lm_train` then `lm_calc_perplexity`, whose perplexity both packages
  compute alike from the port's directory and from one trained by the JAX
  package's `lm_train`;
* `asr_inference` on 4 of the JAX-trained `egs_work/synth_hard` conformer's
  test utterances with a JAX-trained LM (`--lm_exp_dir`, `--lm_weight
  0.3`): it reads the LM, fuses it (its scores move from those without an
  LM) and scores the texts.
"""

import json
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.bin import asr_inference_maskctc as jmaskctc_inference
from espnet_tpu.bin import lm_calc_perplexity as jppl
from espnet_tpu.bin import lm_train as jlm_train
from espnet_tpu.tasks.maskctc import MaskCTCTask as JMaskCTCTask
from espnet_tpu.train.checkpoint import save_pytree
from espnet_tpu_torch.bin import (asr_inference, asr_inference_maskctc,
                                  asr_maskctc_train, asr_mix_inference,
                                  asr_mix_train, asr_mulenc_inference,
                                  asr_mulenc_train, lm_calc_perplexity,
                                  lm_train)
from espnet_tpu_torch.data.fileio import read_2column_text
from espnet_tpu_torch.data.synth import (generate_asr_mix_corpus,
                                         generate_corpus,
                                         generate_mulenc_corpus)

REPO = Path(__file__).resolve().parents[1]
SYNTH = REPO / "egs_work/synth_hard"
# float32 perplexities of the same LM, two frameworks
PPL_RTOL = 1e-5

RUN = ("--run.max_epoch 1 --run.log_interval 1000 "
       "--run.best_metric valid.loss.min --data.batch_size 4 "
       "--optim.schedule constant --optim.lr 0.002").split()
SMALL = ("--model.n_mels 16 --model.use_specaug false "
         "--model.d_model 32 --model.num_heads 2 --model.d_ff 64 "
         "--model.num_decoder_layers 1 --model.decoder_d_ff 64 "
         "--model.dropout_rate 0.0").split()
MASKCTC = SMALL + ("--model.normalize utterance_mvn "
                   "--model.encoder_type transformer "
                   "--model.num_encoder_layers 1").split()
MULENC = SMALL + "--model.num_encoder_layers 1".split()
MIX = SMALL + ("--model.num_shared_layers 1 --model.num_branch_layers 1 "
               "--model.conformer_kernel_size 7").split()
LM = ("--data.batch_size 4 --model.d_model 32 --model.num_heads 2 "
      "--model.d_ff 64 --model.num_layers 1 --model.dropout_rate 0.0 "
      "--run.max_epoch 1 --run.log_interval 1000 "
      "--optim.schedule constant").split()
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("multi_cli")
    generate_corpus(ws / "train", n_utts=8, min_words=2, max_words=3)
    generate_corpus(ws / "test", n_utts=3, min_words=2, max_words=3, seed=7)
    generate_mulenc_corpus(ws / "mulenc", n_utts=6, max_words=3)
    generate_asr_mix_corpus(ws / "mix", n_utts=6, max_words=3)
    return ws


def _data(train, valid=None):
    return ["--data.train_dir", str(train),
            "--data.valid_dir", str(valid or train)]


def _infer(ws, exp, data, out):
    return ["--exp_dir", str(ws / exp), "--data_dir", str(ws / data),
            "--output_dir", str(ws / out)]


@pytest.fixture(scope="module")
def maskctc_exp(ws):
    asr_maskctc_train.main(RUN + MASKCTC + _data(ws / "train") + [
        "--run.output_dir", str(ws / "maskctc")] + CPU)
    return ws / "maskctc"


def test_maskctc_train_and_decode(ws, maskctc_exp):
    for name in ("config.yaml", "tokens.txt", "checkpoint.pt",
                 "valid.loss.ave.params.msgpack"):
        assert (maskctc_exp / name).exists(), name
    asr_inference_maskctc.main(_infer(ws, "maskctc", "test", "mdec") + [
        "--maskctc_n_iterations", "3", "--batch_size", "3"] + CPU)
    out = ws / "mdec"
    assert set(read_2column_text(out / "text")) == set(
        read_2column_text(ws / "test" / "text"))
    rows = [json.loads(x) for x in
            (out / "nbest.jsonl").read_text().splitlines()]
    assert len(rows) == 3
    assert (out / "score_wer.txt").exists() and (out / "rtf.txt").exists()


def test_jax_written_maskctc_experiment_decodes_alike(ws, maskctc_exp):
    """The JAX package writes the directory (config.yaml, tokens.txt, the
    initial parameters as ep1.params.msgpack, global-MVN config); both
    inference CLIs decode it to the same texts."""
    exp = ws / "maskctc_jax"
    exp.mkdir()
    cfg = JMaskCTCTask.parse_config(
        [a.replace("utterance_mvn", "global_mvn") for a in MASKCTC]
        + _data(ws / "train") + ["--run.output_dir", str(exp)])
    JMaskCTCTask.dump_config(cfg, exp)
    (exp / "tokens.txt").write_text(
        (maskctc_exp / "tokens.txt").read_text())
    n_tokens = len((exp / "tokens.txt").read_text().splitlines())
    model = JMaskCTCTask.build_model(cfg["model"], n_tokens)
    params = fnn.meta.unbox(jax.jit(model.init, static_argnums=(5,))(
        jax.random.PRNGKey(3), jnp.zeros((1, 4000)), jnp.array([4000]),
        jnp.ones((1, 3), jnp.int32), jnp.array([3]), True))["params"]
    save_pytree(exp / "ep1.params.msgpack", params)
    extra = ["--maskctc_threshold_probability", "0.999",
             "--batch_size", "3"]
    jmaskctc_inference.main(_infer(ws, "maskctc_jax", "test", "jdec_jax")
                            + extra)
    asr_inference_maskctc.main(
        _infer(ws, "maskctc_jax", "test", "jdec_port") + extra + CPU)
    want = read_2column_text(ws / "jdec_jax" / "text")
    assert len(want) == 3 and any(want.values())
    assert read_2column_text(ws / "jdec_port" / "text") == want


def test_mulenc_train_and_decode(ws):
    asr_mulenc_train.main(RUN + MULENC + _data(ws / "mulenc") + [
        "--run.output_dir", str(ws / "mulenc_exp")] + CPU)
    assert (ws / "mulenc_exp" / "valid.loss.ave.params.msgpack").exists()
    asr_mulenc_inference.main(_infer(ws, "mulenc_exp", "mulenc", "medec")
                              + ["--beam_size", "2", "--max_steps", "6"]
                              + CPU)
    hyps = read_2column_text(ws / "medec" / "text")
    assert set(hyps) == set(read_2column_text(ws / "mulenc" / "text"))
    assert (ws / "medec" / "score_wer.txt").exists()


def test_mix_train_and_decode(ws):
    asr_mix_train.main(RUN + MIX + _data(ws / "mix") + [
        "--run.output_dir", str(ws / "mix_exp")] + CPU)
    assert (ws / "mix_exp" / "valid.loss.ave.params.msgpack").exists()
    asr_mix_inference.main(_infer(ws, "mix_exp", "mix", "mixdec") + CPU)
    lines = (ws / "mixdec" / "text").read_text().splitlines()
    keys = read_2column_text(ws / "mix" / "wav.scp")
    assert sorted(ln.split()[0] for ln in lines) == sorted(
        f"{k}_spk{s}" for k in keys for s in (1, 2))
    assert (ws / "mixdec" / "score_wer.txt").read_text().startswith("WER ")


def _ppl_both(ws, exp, tag):
    argv = ["--exp_dir", str(exp), "--data_dir", str(ws / "test"),
            "--output_dir", str(ws / f"ppl_{tag}")]
    return jppl.main(argv), lm_calc_perplexity.main(argv + CPU)


@pytest.mark.parametrize("trainer", ["port", "jax"])
def test_lm_train_and_perplexity_in_both_packages(ws, maskctc_exp, trainer):
    exp = ws / f"lm_{trainer}"
    argv = LM + _data(ws / "train", ws / "test") + [
        "--run.output_dir", str(exp),
        "--data.token_list", str(maskctc_exp / "tokens.txt")]
    if trainer == "port":
        lm_train.main(argv + CPU)
    else:
        jlm_train.main(argv)
    assert (exp / "valid.loss.ave.params.msgpack").exists()
    want, got = _ppl_both(ws, exp, trainer)
    assert np.isfinite(got) and got > 1.0
    np.testing.assert_allclose(got, want, rtol=PPL_RTOL)


def test_asr_inference_fuses_a_jax_trained_lm(ws, monkeypatch):
    monkeypatch.chdir(REPO)  # the experiment names its files so
    data = ws / "synth4"
    data.mkdir()
    wavs = read_2column_text(SYNTH / "data/test/wav.scp")
    texts = read_2column_text(SYNTH / "data/test/text")
    keys = sorted(wavs)[:4]
    (data / "wav.scp").write_text("".join(f"{k} {REPO / wavs[k]}\n"
                                          for k in keys))
    (data / "text").write_text("".join(f"{k} {texts[k]}\n" for k in keys))
    lm_data = ws / "synth_lm"
    lm_data.mkdir()
    (lm_data / "text").write_text(
        (SYNTH / "data/test/text").read_text())
    jlm_train.main(LM + _data(lm_data) + [
        "--run.output_dir", str(ws / "synth_jax_lm"),
        "--data.token_list", str(SYNTH / "exp/tokens/tokens.txt")])
    base = ["--exp_dir", str(SYNTH / "exp/asr"), "--data_dir", str(data),
            "--params", str(SYNTH / "exp/asr/valid.acc.ave.params.msgpack"),
            "--beam_size", "3", "--max_steps", "30", "--batch_size", "4",
            "--nbest", "3"] + CPU
    scores = {}
    for tag, extra in (("plain", []),
                       ("lm", ["--lm_exp_dir", str(ws / "synth_jax_lm"),
                               "--lm_weight", "0.3"])):
        out = ws / f"synth_dec_{tag}"
        asr_inference.main(base + ["--output_dir", str(out)] + extra)
        assert set(read_2column_text(out / "text")) == set(keys)
        assert (out / "score_wer.txt").exists()
        scores[tag] = {r["key"]: r["score"] for r in map(
            json.loads, (out / "nbest.jsonl").read_text().splitlines())}
    assert all(scores["lm"][k] != scores["plain"][k] for k in keys)
