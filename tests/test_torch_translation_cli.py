"""The MT, ST and SLU CLIs of the port against the JAX package's, on the
CPU.

Toy corpora of `data/synth.py` (MT: 24 sentence pairs, the translation the
source's words reversed; ST: 8 synthesised utterances with their
transcripts as `src_text`; SLU: 8 utterances whose transcripts start with
an intent word, "play" or "stop") and tiny models (one encoder and one
decoder layer of d_model 16, dropout 0, a constant learning rate, one
epoch; SLU three at a higher rate, on word tokens). Each MT and ST experiment directory, trained by either package's
`*_train`, decodes to the same text with both packages' `*_inference`;
the port's SLU experiment decodes to the same text and the same
`intent_acc.txt` with both `slu_inference`s. Each decode runs as one batch,
so that the JAX search compiles once.
"""

import pytest
import torch

from espnet_tpu.bin import mt_inference as jmt_inference
from espnet_tpu.bin import mt_train as jmt_train
from espnet_tpu.bin import slu_inference as jslu_inference
from espnet_tpu.bin import st_inference as jst_inference
from espnet_tpu.bin import st_train as jst_train
from espnet_tpu_torch.bin import mt_inference, mt_train, slu_inference
from espnet_tpu_torch.bin import slu_train, st_inference, st_train
from espnet_tpu_torch.bin.slu_inference import intent_accuracy
from espnet_tpu_torch.data.fileio import read_2column_text, write_2column_text
from espnet_tpu_torch.data.synth import (generate_corpus, generate_mt_corpus,
                                         generate_st_corpus)

COMMON = ("--run.max_epoch 1 --run.log_interval 1000 "
          "--model.d_model 16 --model.num_heads 2 --model.d_ff 32 "
          "--model.num_encoder_layers 1 --model.num_decoder_layers 1 "
          "--model.decoder_d_ff 32 --model.dropout_rate 0.0 "
          "--optim.schedule constant --optim.lr 0.005").split()
SPEECH = ("--model.n_mels 16 --model.use_specaug false "
          "--model.normalize utterance_mvn "
          "--model.encoder_type transformer").split()
FAMILIES = {
    # (port train, JAX train, port inference, JAX inference, corpus
    # writer, train flags, decode flags)
    "mt": (mt_train, jmt_train, mt_inference, jmt_inference,
           lambda d: generate_mt_corpus(d, n_utts=24, max_words=3),
           COMMON + ["--data.batch_size", "8", "--run.best_metric",
                     "valid.loss.min"],
           ["--beam_size", "2", "--max_steps", "12", "--batch_size", "24"]),
    "st": (st_train, jst_train, st_inference, jst_inference,
           lambda d: generate_st_corpus(d, n_utts=8, max_words=3),
           COMMON + SPEECH + [
               "--data.batch_size", "4", "--run.best_metric",
               "valid.loss.min", "--model.num_asr_decoder_layers", "1",
               "--model.asr_weight", "0.3", "--model.mtlalpha", "0.5"],
           ["--beam_size", "2", "--max_steps", "16", "--batch_size", "8"]),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trained_by", ["port", "jax"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_experiment_of_either_package_decodes_to_the_same_text(
        tmp_path, family, trained_by):
    ttrain, jtrain, tinfer, jinfer, write, flags, decode = FAMILIES[family]
    write(tmp_path / "data")
    argv = flags + ["--data.train_dir", str(tmp_path / "data"),
                    "--data.valid_dir", str(tmp_path / "data"),
                    "--run.output_dir", str(tmp_path / "exp")]
    if trained_by == "port":
        ttrain.main(argv + ["--device", "cpu"])
    else:
        jtrain.main(argv)
    assert (tmp_path / "exp" / "src_tokens.txt").exists()
    dec = ["--exp_dir", str(tmp_path / "exp"), "--data_dir",
           str(tmp_path / "data")] + decode
    tinfer.main(dec + ["--output_dir", str(tmp_path / "tdec"),
                       "--device", "cpu"])
    jinfer.main(dec + ["--output_dir", str(tmp_path / "jdec")])
    got = read_2column_text(tmp_path / "tdec" / "text")
    want = read_2column_text(tmp_path / "jdec" / "text")
    assert got == want and any(got.values())
    assert (tmp_path / "tdec" / "score_wer.txt").read_text() == \
        (tmp_path / "jdec" / "score_wer.txt").read_text()


def test_slu_intent_accuracy_matches_jax(tmp_path):
    generate_corpus(tmp_path / "data", n_utts=8, min_words=2, max_words=2)
    texts = read_2column_text(tmp_path / "data" / "text")
    write_2column_text(tmp_path / "data" / "text", {
        k: f"{'play' if i % 2 else 'stop'} {v}"
        for i, (k, v) in enumerate(texts.items())})
    slu_train.main(COMMON + SPEECH + [
        "--run.best_metric", "train.loss.min", "--data.token_type", "word",
        "--data.batch_size", "4", "--data.train_dir",
        str(tmp_path / "data"), "--run.output_dir", str(tmp_path / "exp"),
        "--optim.lr", "0.05", "--run.max_epoch", "3", "--device", "cpu"])
    dec = ["--exp_dir", str(tmp_path / "exp"), "--data_dir",
           str(tmp_path / "data"), "--beam_size", "2", "--max_steps", "8",
           "--batch_size", "8"]
    slu_inference.main(dec + ["--output_dir", str(tmp_path / "tdec"),
                              "--device", "cpu"])
    jslu_inference.main(dec + ["--output_dir", str(tmp_path / "jdec")])
    hyps = read_2column_text(tmp_path / "tdec" / "text")
    assert hyps == read_2column_text(tmp_path / "jdec" / "text")
    assert any(hyps.values())
    acc = (tmp_path / "tdec" / "intent_acc.txt").read_text()
    assert acc == (tmp_path / "jdec" / "intent_acc.txt").read_text()
    refs = read_2column_text(tmp_path / "data" / "text")
    assert acc == f"{intent_accuracy(refs, hyps)[0]:.4f}\n"
    assert intent_accuracy({"a": "play x", "b": "stop y", "c": ""},
                           {"a": "play z", "b": "play y", "c": ""}) == (
        2 / 3, 2, 3)
