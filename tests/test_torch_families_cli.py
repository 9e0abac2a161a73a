"""The slice's encoders, decoders and frontends through the port's command
lines, on the CPU: `bin.asr_train` takes one epoch of each family on a
4-utterance synthetic corpus (a 2-channel copy of it for the multichannel
frontend) and `bin.asr_inference` decodes the 2 validation utterances
from the experiment it wrote. Each case names the flags a user gives."""

import numpy as np
import pytest
import torch

from espnet_tpu_torch.bin import asr_inference as tinference
from espnet_tpu_torch.bin import asr_train as ttrain
from espnet_tpu_torch.data.fileio import (read_2column_text, read_wav,
                                          write_2column_text, write_wav)
from espnet_tpu_torch.data.synth import generate_corpus
from espnet_tpu_torch.models.subsampling import Conv2dSubsampling
from espnet_tpu_torch.utils import registry

ARGS = (
    "--run.max_epoch 1 --run.log_interval 1 --data.batch_size 2 "
    "--model.n_mels 16 --model.use_specaug false "
    "--model.normalize utterance_mvn --model.d_model 32 "
    "--model.num_heads 2 --model.d_ff 64 --model.num_encoder_layers 1 "
    "--model.num_decoder_layers 1 --model.decoder_d_ff 64 "
    "--model.dropout_rate 0.0 --model.conformer_kernel_size 5 "
    "--optim.name sgd --optim.schedule constant --optim.lr 0.003"
).split()
CASES = {
    "longformer_s4": ["--model.encoder_type", "longformer",
                      "--model.attention_window", "4",
                      "--model.decoder_type", "s4"],
    "vgg_blstm_rnn": ["--model.encoder_type", "vgg_blstm",
                      "--model.decoder_type", "rnn"],
    "vgg_lstm_rnn_coverage": ["--model.encoder_type", "vgg_lstm",
                              "--model.decoder_type", "rnn",
                              "--model.rnn_att_type", "coverage"],
    "sinc": ["--model.input_type", "sinc", "--model.sinc_out_dim", "16"],
    "multichannel_wpe": ["--model.num_channels", "2", "--model.use_wpe",
                         "true", "--data.multichannel", "true",
                         "--model.frontend_hidden", "8",
                         "--model.frontend_layers", "1"],
    "plugin_encoder": ["--model.encoder_type", "test_cli_subsampling",
                       "--model.encoder_conf", "{n_feats: 16, d_model: 32}"],
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The LSTM loops are thousands of tiny ops: one intra-op thread keeps
    them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@registry.register("encoder", "test_cli_subsampling")
class _PluginEncoder(torch.nn.Module):
    def __init__(self, n_feats: int, d_model: int):
        super().__init__()
        self.embed = Conv2dSubsampling(d_model, n_feats, 4)

    def forward(self, feats, lengths, generator=None):
        return self.embed(feats, lengths)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Mono train/valid dirs and 2-channel copies (the second channel the
    first delayed by 3 samples at half the level)."""
    ws = tmp_path_factory.mktemp("families")
    for split, n, seed in (("train", 4, 0), ("valid", 2, 1)):
        generate_corpus(ws / split, n_utts=n, min_words=1, max_words=2,
                        seed=seed)
        scp = {}
        for key, path in read_2column_text(ws / split / "wav.scp").items():
            wav, fs = read_wav(path)
            out = ws / f"{split}_2ch" / "wav" / f"{key}.wav"
            write_wav(out, np.stack([wav, 0.5 * np.roll(wav, 3)], 1), fs)
            scp[key] = str(out)
        write_2column_text(ws / f"{split}_2ch" / "wav.scp", scp)
        write_2column_text(ws / f"{split}_2ch" / "text",
                           read_2column_text(ws / split / "text"))
    return ws


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_trains_and_decodes_through_the_clis(corpus, case):
    suffix = "_2ch" if case.startswith("multichannel") else ""
    exp = corpus / f"exp_{case}"
    ttrain.main(ARGS + CASES[case] + [
        "--data.train_dir", str(corpus / f"train{suffix}"),
        "--data.valid_dir", str(corpus / f"valid{suffix}"),
        "--run.output_dir", str(exp), "--device", "cpu"])
    assert sorted(p.name for p in exp.glob("ep1.params.msgpack"))
    out = corpus / f"decode_{case}"
    hyps = tinference.main([
        "--exp_dir", str(exp), "--data_dir", str(corpus / f"valid{suffix}"),
        "--output_dir", str(out), "--beam_size", "2", "--max_steps", "4",
        "--batch_size", "2", "--device", "cpu"])
    assert len(hyps) == 2 and (out / "score_wer.txt").exists()
