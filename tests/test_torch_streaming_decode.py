"""Both streaming engines of the port (`host`: decode/streaming_inference.py,
`device`: decode/streaming_device.py) on the CPU, on the reduced model of
tests/test_streaming_device.py (contextual-block conformer, d 16, 2 layers,
block 8 / hop 4 / look-ahead 2, n_fft 256, 12 mels, vocab 8) with JAX's
initial parameters: greedy equals offline CTC greedy exactly at chunks of
1600, 2048 and 4000 samples; beam equals the offline beam search; the short
path; an engine decodes utterance after utterance; the device engine's
state tensors sit on its device; one utterance against the greedy ids of
JAX's `Speech2TextStreaming`; the two end-of-utterance faults of the JAX
engines, repaired; and `bin.asr_inference_streaming` in both engines on an
experiment directory that the port's trainer wrote."""

import json

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from espnet_tpu.decode.streaming_inference import \
    Speech2TextStreaming as JStreaming
from espnet_tpu.models.asr import ASRConfig as JASRConfig
from espnet_tpu.models.asr import ASRModel as JASRModel
from espnet_tpu_torch.bin import asr_inference_streaming as tstream_cli
from espnet_tpu_torch.bin import asr_train as ttrain
from espnet_tpu_torch.convert import load_jax_params
from espnet_tpu_torch.data.synth import generate_corpus
from espnet_tpu_torch.decode.beam_search import batched_beam_search
from espnet_tpu_torch.decode.ctc_greedy import collapse_ctc
from espnet_tpu_torch.decode.streaming_device import \
    DeviceStreamingRecognizer
from espnet_tpu_torch.decode.streaming_inference import (Speech2TextStreaming,
                                                         beam_config)
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel


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

ENGINES = {"host": Speech2TextStreaming, "device": DeviceStreamingRecognizer}
N = 12000  # 0.75 s: 23 subsampled frames, 4 blocks
BEAM = dict(beam_size=4, ctc_weight=0.5, max_steps=16, t_max=64)


def _kw(**over):
    kw = dict(vocab_size=8, input_type="raw", fs=16000, n_fft=256,
              hop_length=128, n_mels=12, use_specaug=False, normalize="none",
              encoder_type="contextual_block_conformer", d_model=16,
              num_heads=2, d_ff=32, num_encoder_layers=2,
              num_decoder_layers=1, decoder_d_ff=32, conformer_kernel_size=7,
              block_size=8, stream_hop_size=4, look_ahead=2,
              dropout_rate=0.0, ctc_weight=0.5)
    kw.update(over)
    return kw


def _models(**over):
    """(JAX model, its variables, the port's model with those weights)."""
    jm = JASRModel(JASRConfig(**_kw(**over)))
    v = fnn.meta.unbox(jax.jit(jm.init, static_argnums=(5,))(
        jax.random.PRNGKey(0), np.zeros((1, N), np.float32),
        np.array([N], np.int32), np.array([[1, 2]], np.int32),
        np.array([2], np.int32), True))
    tm = load_jax_params(ASRModel(ASRConfig(**_kw(**over))),
                         {"params": v["params"]})
    return jm, v, tm.eval()


@pytest.fixture(scope="module")
def models():
    return _models()


def _wave(n=N, seed=0):
    return (0.3 * np.random.RandomState(seed).randn(n)).astype(np.float32)


def _stream(engine, wave, chunk):
    out = None
    for i in range(0, len(wave), chunk):
        out = engine(wave[i:i + chunk], is_final=i + chunk >= len(wave))
    assert out["is_final"]
    return out["token_ids"]


@torch.no_grad()
def _offline(model, wave, search="greedy"):
    n = len(wave)
    enc, lens = model.encode(torch.from_numpy(wave[None]),
                             torch.tensor([n]))
    lp = model.ctc_log_probs(enc)
    if search == "greedy":
        return collapse_ctc(lp[0, :int(lens[0])].argmax(-1).tolist())
    c = model.config
    w = BEAM["beam_size"]
    mem, mem_lens = enc.repeat_interleave(w, 0), lens.repeat_interleave(w)

    def att(tokens, pos, cache):
        return model.decoder_score_step(tokens, pos, mem, mem_lens, cache)

    yseq, ylen, _ = batched_beam_search(
        beam_config(w, BEAM["ctc_weight"], 0.0, c.blank_id), c.sos_id,
        c.eos_id, c.vocab_size, lens, att,
        model.decoder_init_cache(w, BEAM["max_steps"] + 1),
        ctc_log_probs=lp, max_steps=BEAM["max_steps"])
    return yseq[0, 0, :int(ylen[0, 0])].tolist()


@pytest.mark.parametrize("chunk", [1600, 2048, 4000])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_greedy_equals_offline(models, engine, chunk):
    _, _, tm = models
    wave = _wave()
    rec = ENGINES[engine](tm, device="cpu")
    assert _stream(rec, wave, chunk) == _offline(tm, wave)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_beam_equals_offline(models, engine):
    _, _, tm = models
    wave = _wave()
    rec = ENGINES[engine](tm, search="beam", device="cpu", **BEAM)
    assert _stream(rec, wave, 1600) == _offline(tm, wave, "beam")


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_short_utterance_takes_the_offline_path(engine):
    _, _, tm = _models(block_size=40, stream_hop_size=16, look_ahead=16)
    wave = _wave(4000, seed=1)  # 0.25 s: far below one block
    rec = ENGINES[engine](tm, device="cpu")
    rec(wave[:1600])
    out = rec(wave[1600:], is_final=True)
    assert out["token_ids"] == _offline(tm, wave)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engine_is_reusable_across_utterances(models, engine):
    _, _, tm = models
    waves = [_wave(seed=2), _wave(N + 3000, seed=3)]
    rec = ENGINES[engine](tm, device="cpu")
    for wave in waves + waves:
        assert _stream(rec, wave, 1600) == _offline(tm, wave)


def test_device_state_on_the_engines_device(models):
    _, _, tm = models
    rec = DeviceStreamingRecognizer(tm, search="beam", device="cpu", **BEAM)
    wave = _wave(16000)
    for i in range(0, len(wave), 2048):
        rec(wave[i:i + 2048])
    state = dict(_tensors(rec._dev))
    assert {"stail", "ftail", "xbuf", "ctx", "prev_addin", "enc_buf",
            "lp_buf", "beam.yseq", "beam.ctc.r"} <= set(state)
    assert all(t.device == rec.device for t in state.values())
    assert rec._next_block > 0  # blocks ran before is_final


def _tensors(tree, prefix=""):
    """(name, tensor) of every tensor in a state tree (dicts, lists and
    named tuples)."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{prefix}.{k}" if prefix else k)
    elif hasattr(tree, "_asdict"):
        yield from _tensors(tree._asdict(), prefix)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{prefix}.{i}")


def test_engines_match_jax_streaming(models):
    """12800 samples: T' = 24 frames, so the last block is full and its
    frames arrive with the final chunk; the JAX engines' two faults at the
    end of an utterance (test_end_of_utterance_faults_repaired) cannot show
    there, and JAX's host engine, the offline decode and both of the
    port's engines agree."""
    jm, v, tm = models
    wave = _wave(12800, seed=4)
    jrec = JStreaming(jm, v["params"])
    want = None
    for i in range(0, len(wave), 3200):
        want = jrec(wave[i:i + 3200], is_final=i + 3200 >= len(wave))
    assert want["token_ids"] == _offline(tm, wave)
    for engine in ENGINES.values():
        assert _stream(engine(tm, device="cpu"), wave,
                       3200) == want["token_ids"]


@pytest.mark.parametrize("n", [12000, 13000], ids=["padded", "ends"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_end_of_utterance_faults_repaired(models, engine, n):
    """Where the JAX engines depart from the offline encoder: 12000 samples
    end inside the last block, whose pad slots JAX gives positional
    encodings (`last_block_pad`); at 13000 the last block's frames are all
    stable before the final chunk, and the JAX host engine runs it early
    and never emits the frames after its hop (`block_is_safe`). The
    port's engines give the offline result at both."""
    _, _, tm = models
    wave = _wave(n, seed=3)
    assert _stream(ENGINES[engine](tm, device="cpu"), wave,
                   1600) == _offline(tm, wave)


ARGS = (
    "--run.max_epoch 1 --run.log_interval 1 --data.batch_size 4 "
    "--model.n_mels 24 --model.use_specaug false "
    "--model.normalize global_mvn "
    "--model.encoder_type contextual_block_conformer "
    "--model.block_size 8 --model.stream_hop_size 4 --model.look_ahead 2 "
    "--model.d_model 32 --model.num_heads 2 --model.d_ff 64 "
    "--model.num_encoder_layers 1 --model.num_decoder_layers 1 "
    "--model.decoder_d_ff 64 --model.dropout_rate 0.0 "
    "--model.conformer_kernel_size 7 "
    "--optim.name sgd --optim.schedule constant --optim.lr 0.003"
).split()


def test_cli_both_engines(tmp_path):
    generate_corpus(tmp_path / "train", n_utts=8, seed=0)
    generate_corpus(tmp_path / "test", n_utts=3, seed=1)
    exp = tmp_path / "exp"
    ttrain.main(ARGS + ["--data.train_dir", str(tmp_path / "train"),
                        "--data.valid_dir", str(tmp_path / "test"),
                        "--run.output_dir", str(exp), "--device", "cpu"])
    texts = {}
    for engine in ENGINES:
        out = tmp_path / f"decode_{engine}"
        tstream_cli.main([
            "--exp_dir", str(exp), "--data_dir", str(tmp_path / "test"),
            "--output_dir", str(out), "--engine", engine, "--search", "beam",
            "--beam_size", "2", "--max_steps", "16", "--device", "cpu"])
        texts[engine] = (out / "text").read_text()
        rows = [json.loads(ln) for ln in
                (out / "nbest.jsonl").read_text().splitlines()]
        assert len(rows) == 3 and (out / "score_wer.txt").exists()
    assert texts["host"] == texts["device"]
