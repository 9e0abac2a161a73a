"""The SSL and Whisper options through the port's `asr_train` and
`asr_inference`, on the CPU.

Each case trains a tiny model for one epoch on a synthesised corpus (8
training and 4 validation utterances) with one of the options that select
an SSL or Whisper part: the `ssl` section given as a YAML flow map on the
command line with `input_type ssl` (frozen trunk into a conformer), the
same trunk fine-tuned into a transformer, the wav2vec2 encoder (with the
default global MVN, which it does not use), the `whisper` section with
Whisper's encoder and decoder, Whisper's encoder under a transformer
decoder with global MVN, and Whisper's decoder behind a transformer
encoder; then decodes the validation set from the experiment directory,
whose config.yaml carries the sections. A frozen trunk leaves the epoch's
parameters at their initial values; a fine-tuned one moves them.

Global MVN: the JAX `asr_train` collects its statistics for the Whisper
encoder from the ASR's log-mel at its n_fft and hop, and its collect-stats
pass fails on `input_type ssl` (it takes the raw waveforms as features);
the port collects Whisper's own log-mel and refuses SSL input with the
remedy named (ROADMAP.md queue 3).
"""

import numpy as np
import pytest
import torch

from espnet_tpu.data.sampler import build_batches as jbuild_batches
from espnet_tpu.tasks.asr import ASRTask as JASRTask
from espnet_tpu.train.collect_stats import collect_stats as jcollect_stats
from espnet_tpu_torch.bin import asr_inference, asr_train
from espnet_tpu_torch.data.dataset import collate
from espnet_tpu_torch.data.fileio import (read_2column_text,
                                         write_2column_text, write_wav)
from espnet_tpu_torch.data.sampler import build_batches as tbuild_batches
from espnet_tpu_torch.data.synth import generate_corpus
from espnet_tpu_torch.models.asr import init_random_
from espnet_tpu_torch.models.ssl import whisper_log_mel
from espnet_tpu_torch.ops.stft import log_mel_spectrogram
from espnet_tpu_torch.tasks.asr import ASRTask
from espnet_tpu_torch.train.msgpack_io import flatten, load_tree

COMMON = (
    "--run.max_epoch 1 --run.log_interval 1000 "
    "--run.best_metric valid.loss.min --data.batch_size 4 "
    "--model.n_mels 8 --model.use_specaug false "
    "--model.normalize utterance_mvn --model.d_model 16 "
    "--model.num_heads 2 --model.d_ff 32 --model.num_encoder_layers 1 "
    "--model.num_decoder_layers 1 --model.decoder_d_ff 32 "
    "--model.dropout_rate 0.0 --model.conformer_kernel_size 7 "
    "--optim.schedule constant --optim.lr 0.001"
).split()
SSL = ("{hidden_size: 16, num_layers: 1, num_heads: 2, ffn_size: 32, "
       "conv_dim: [8, 8], conv_kernel: [10, 3], conv_stride: [5, 2], "
       "num_conv_pos_embeddings: 8, num_conv_pos_embedding_groups: 2}")
WHISPER = ("{n_mels: 8, d_model: 16, encoder_layers: 1, decoder_layers: 1, "
           "num_heads: 2, ffn_size: 32, max_source_positions: 1500, "
           "max_target_positions: 64}")
CASES = {
    "ssl_section": ["--model.input_type", "ssl", "--model.ssl", SSL],
    "ssl_finetune": ["--model.input_type", "ssl", "--model.ssl", SSL,
                     "--model.ssl_freeze", "false",
                     "--model.encoder_type", "transformer"],
    "wav2vec2": ["--model.encoder_type", "wav2vec2", "--model.ssl", SSL,
                 "--model.ssl_freeze", "false",
                 "--model.normalize", "global_mvn"],
    "whisper_section": ["--model.encoder_type", "whisper",
                        "--model.decoder_type", "whisper",
                        "--model.whisper", WHISPER,
                        "--model.normalize", "none",
                        "--model.ctc_weight", "0.0"],
    "whisper_encoder": ["--model.encoder_type", "whisper",
                        "--model.whisper", WHISPER,
                        "--model.normalize", "global_mvn"],
    "whisper_decoder": ["--model.encoder_type", "transformer",
                        "--model.decoder_type", "whisper",
                        "--model.whisper", WHISPER],
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    ws = tmp_path_factory.mktemp("ssl_cli")
    generate_corpus(ws / "train", n_utts=8, min_words=1, max_words=3,
                    seed=0)
    generate_corpus(ws / "valid", n_utts=4, min_words=1, max_words=3,
                    seed=1)
    return ws


def _train(ws, out, extra):
    return asr_train.main(COMMON + [
        "--data.train_dir", str(ws / "train"),
        "--data.valid_dir", str(ws / "valid"),
        "--run.output_dir", str(out), *extra, "--device", "cpu"])


def _moments(feats, lens):
    valid = np.arange(feats.shape[1])[None, :] < lens[:, None]
    f = feats * valid[:, :, None]
    return f.sum((0, 1)), (f * f).sum((0, 1)), valid.sum()


@pytest.mark.parametrize("case", list(CASES))
def test_ssl_and_whisper_options_train_and_decode(corpus, tmp_path, case):
    exp = tmp_path / "exp"
    _, trainer, model, _, converter = _train(corpus, exp, CASES[case])
    mc = model.config
    assert len(trainer.epoch_seconds) == 1
    # the experiment's config.yaml rebuilds the same sections
    again = ASRTask.build_model(ASRTask.load_config(exp)["model"],
                                len(converter))
    assert (again.config.ssl, again.config.whisper) == (mc.ssl, mc.whisper)
    params = flatten(load_tree(exp / "ep1.params.msgpack"))
    if case.startswith("ssl"):
        init = ASRTask.build_model(ASRTask.load_config(exp)["model"],
                                   len(converter))
        init_random_(init, torch.Generator().manual_seed(0))
        start = {k: v.numpy() for k, v in init.state_dict().items()}
        w = "ssl_frontend/upstream/layer0/attention/q_proj/kernel"
        moved = float(np.abs(params[w] - start[
            "ssl_frontend.upstream.layer0.attention.q_proj.weight"].T).max())
        assert (moved == 0.0) == mc.ssl_freeze, moved
        assert "ssl_frontend/layer_weights" in params
    if case == "wav2vec2":
        assert not hasattr(model, "mvn")
        assert "encoder/output_layer/kernel" not in params  # 16 -> 16
        assert (exp / "stats" / "feats_stats.npz").exists()
    if case == "whisper_encoder":
        stats = np.load(exp / "stats" / "feats_stats.npz")
        assert stats["sum"].shape == (8,)
        assert model.mvn.mean.shape == (8,)
    out = tmp_path / "dec"
    asr_inference.main([
        "--exp_dir", str(exp), "--data_dir", str(corpus / "valid"),
        "--output_dir", str(out), "--beam_size", "2", "--max_steps", "8",
        "--batch_size", "4", "--ctc_weight",
        "0.0" if mc.ctc_weight == 0.0 else "0.3", "--device", "cpu"])
    assert set(read_2column_text(out / "text")) == set(
        read_2column_text(corpus / "valid" / "text"))


def test_global_mvn_statistics_for_whisper_and_ssl_input(corpus, tmp_path):
    """Whisper's encoder: JAX's statistics are the moments of the ASR's
    log-mel (n_fft 512, hop 128), the port's those of Whisper's log-mel.
    SSL input: the JAX pass takes the waveforms as (B, N) features and
    fails on them (on two short utterances: a broadcast error; a real
    batch would first form a (B, N, N) array); the port refuses before
    collecting, naming the remedy."""
    whisper = ["--model.encoder_type", "whisper", "--model.whisper",
               WHISPER, "--model.normalize", "global_mvn",
               "--run.stats_only", "true"]
    data = ["--data.train_dir", str(corpus / "train")]
    JASRTask.main(COMMON + data + whisper + [
        "--run.output_dir", str(tmp_path / "jexp")])
    asr_train.main(COMMON + data + whisper + [
        "--run.output_dir", str(tmp_path / "texp"), "--device", "cpu"])
    # the moments over the pass's own padded batches (the STFT's last
    # frames see the batch's padding)
    cfg = ASRTask.load_config(tmp_path / "texp")
    tok = ASRTask.build_tokenizer(cfg["data"], tmp_path / "texp")
    conv = ASRTask.build_token_list(cfg["data"], tmp_path / "texp", tok)
    ds = ASRTask.build_dataset(cfg["data"], corpus / "train", tok, conv)
    batches = [collate(ds, b) for b in tbuild_batches(
        {"speech": ds.speech_lengths(), "text": ds.text_lengths()},
        batch_size=4, length_quantum=cfg["data"].length_quantum,
        text_quantum=cfg["data"].text_quantum)]
    for exp, feats_fn in (("jexp", lambda x, n: log_mel_spectrogram(
            x, n, n_mels=8)), ("texp", lambda x, n: whisper_log_mel(
                x, n, n_mels=8))):
        s, sq, count = 0.0, 0.0, 0
        for b in batches:
            f, fl = feats_fn(torch.from_numpy(b["speech"]),
                             torch.from_numpy(b["speech_lengths"]))
            m = _moments(f.numpy().astype(np.float64), fl.numpy())
            s, sq, count = s + m[0], sq + m[1], count + m[2]
        stats = np.load(tmp_path / exp / "stats" / "feats_stats.npz")
        assert float(stats["count"]) == count, exp
        np.testing.assert_allclose(stats["sum"], s, rtol=1e-4, err_msg=exp)
        np.testing.assert_allclose(stats["sum_square"], sq, rtol=1e-4,
                                   err_msg=exp)

    ssl = ["--model.input_type", "ssl", "--model.ssl", SSL,
           "--model.normalize", "global_mvn"]
    with pytest.raises(ValueError, match="collect-stats cannot"):
        asr_train.main(COMMON + data + ssl + [
            "--run.output_dir", str(tmp_path / "tssl"), "--device", "cpu"])
    short = tmp_path / "short"
    (short / "wav").mkdir(parents=True)
    rng = np.random.RandomState(2)
    for i, n in enumerate((400, 320)):
        write_wav(short / "wav" / f"u{i}.wav",
                  (0.1 * rng.randn(n)).astype(np.float32), 16000)
    write_2column_text(short / "wav.scp", {
        f"u{i}": str(short / "wav" / f"u{i}.wav") for i in range(2)})
    write_2column_text(short / "text", {"u0": "ab", "u1": "ba"})
    cfg = JASRTask.parse_config(COMMON + ssl + [
        "--data.train_dir", str(tmp_path / "short")])
    texts = list(read_2column_text(tmp_path / "short" / "text").values())
    tok = JASRTask.build_tokenizer(cfg["data"], tmp_path)
    conv = JASRTask.build_token_list(cfg["data"], tmp_path, tok, texts)
    ds = JASRTask.build_dataset(cfg["data"], tmp_path / "short", tok, conv)
    batches = jbuild_batches({"speech": ds.speech_lengths(),
                              "text": ds.text_lengths()}, batch_size=2,
                             length_quantum=1)
    with pytest.raises(ValueError, match="broadcast"):
        jcollect_stats(ds, batches, tmp_path / "jssl", n_mels=8,
                       input_type="ssl")
