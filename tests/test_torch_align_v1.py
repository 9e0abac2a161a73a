"""CTC forced alignment, the v1 streaming recognisers and the plugin
sections of the port against the JAX package, on the CPU:
`ctc_forced_align` and `alignment_to_segments` on seeded lattices whose
log-probs are quantised so that predecessors tie (the same frame ids,
exactly); the port's `bin.asr_align` against the JAX CLI on the AN4 test
utterances with the trained AN4 transformer (identical `segments`
files); `WindowStreamingASR` and `SegmentStreamingASR` on a tiny
VGG-LSTM model with the same parameters in both packages (the window's n-best equal to JAX's,
one window equal to the offline decode; the segment recogniser's
endpoints and hypotheses equal to JAX's); and a torch encoder and decoder
registered by name, built through `encoder_conf` and `decoder_conf`."""

import dataclasses
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.bin import asr_align as jalign_cli
from espnet_tpu.decode import streaming_v1 as jsv1
from espnet_tpu.decode.asr_inference import Speech2Text as JSpeech2Text
from espnet_tpu.models.asr import ASRConfig as JASRConfig
from espnet_tpu.models.asr import ASRModel as JASRModel
from espnet_tpu.ops import ctc_align as jca
from espnet_tpu_torch.bin import asr_align as talign_cli
from espnet_tpu_torch.bin.prep_an4 import main as prep_an4
from espnet_tpu_torch.convert import load_jax_params
from espnet_tpu_torch.decode import streaming_v1 as tsv1
from espnet_tpu_torch.decode.asr_inference import Speech2Text
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel
from espnet_tpu_torch.models.subsampling import Conv2dSubsampling
from espnet_tpu_torch.models.transformer import TransformerDecoder
from espnet_tpu_torch.ops import ctc_align as tca
from espnet_tpu_torch.tasks.asr import ASRModelSection, ASRTask
from espnet_tpu_torch.utils import registry

REPO = Path(__file__).resolve().parents[1]
AN4 = Path("egs_work/an4")
SCORE_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The beam searches and the Viterbi are loops of tiny ops: one
    intra-op thread keeps them from contending with the other test
    workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forced_align_with_ties_matches_jax(seed):
    rng = np.random.RandomState(seed)
    b, t, v = 3, 14, 5
    # log-probs on a coarse grid: many equal predecessor scores
    lp = np.log(np.round(rng.dirichlet(np.ones(v), (b, t)) * 4 + 1) / 9)
    lp = lp.astype(np.float32)
    labels = rng.randint(1, v, (b, 4)).astype(np.int32)
    labels[0, 1] = labels[0, 0]  # a repeat: the skip is refused there
    in_lens = np.array([14, 9, 1], np.int32)
    lab_lens = np.array([4, 3, 0], np.int32)
    want = np.asarray(jca.ctc_forced_align(*map(
        jnp.asarray, (lp, labels, in_lens, lab_lens))))
    got = tca.ctc_forced_align(*map(_t, (lp, labels, in_lens, lab_lens)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (tca.alignment_to_segments(got, labels, lab_lens, 0.04)
            == jca.alignment_to_segments(want, labels, lab_lens, 0.04))


@pytest.fixture
def repo_root(monkeypatch):
    """The AN4 experiment names its files relative to the repository."""
    monkeypatch.chdir(REPO)


def test_asr_align_cli_matches_jax(repo_root, tmp_path):
    prep_an4(["--an4_root", str(AN4 / "downloads" / "an4"), "--output_dir",
              str(tmp_path / "data")])
    common = ["--exp_dir", str(AN4 / "exp" / "asr"), "--data_dir",
              str(tmp_path / "data" / "test"), "--params",
              str(AN4 / "exp" / "asr" / "ep300.params.msgpack"),
              "--batch_size", "2"]
    jalign_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    talign_cli.main(common + ["--output_dir", str(tmp_path / "port"),
                              "--device", "cpu"])
    want = (tmp_path / "jax" / "segments").read_text()
    assert len(want.splitlines()) > 10
    assert (tmp_path / "port" / "segments").read_text() == want


# ------------------------------------------------------ v1 streaming

V1 = dict(vocab_size=12, n_mels=16, use_specaug=False, d_model=16,
          num_encoder_layers=1, encoder_type="vgg_lstm",
          decoder_type="rnn", num_decoder_layers=1, dropout_rate=0.0,
          normalize="none", ctc_weight=0.3)
CHUNK = 2048
BEAM = dict(beam_size=3, ctc_weight=0.3, max_steps=5)


def _v1_audio():
    """Noise, near-silence, noise, near-silence: 0.5 s each, the last 1 s."""
    rng = np.random.RandomState(7)
    parts = [0.3 * rng.randn(8192), 1e-4 * rng.randn(8192),
             0.3 * rng.randn(8192), 1e-4 * rng.randn(16384)]
    return np.concatenate(parts).astype(np.float32)


@pytest.fixture(scope="module")
def v1_models():
    """A tiny VGG-LSTM model whose CTC head reads blank on one side of a
    least-squares separator of its chunked encoder outputs on the noise and
    the near-silence (so that segments start and end)."""
    cfg = ASRConfig(**V1)
    jm = JASRModel(JASRConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(cfg)
                                 if f.name != "dtype"}))
    n = 4096
    v = fnn.meta.unbox(jax.jit(jm.init, static_argnums=(5,))(
        jax.random.PRNGKey(0), jnp.zeros((1, n)), jnp.array([n]),
        jnp.ones((1, 3), jnp.int32), jnp.array([3]), True))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(
            np.float32), v["params"])
    tm = load_jax_params(ASRModel(cfg), params).eval()
    wave = _v1_audio()
    chunks = tsv1._ChunkEncoder(Speech2Text(tm, device="cpu", **BEAM))
    enc = np.concatenate([chunks.encode_chunk(wave[i:i + CHUNK])[0]
                          for i in range(0, len(wave), CHUNK)])
    frame = np.arange(len(enc)) * 512  # 4 encoder frames a chunk
    noise = ((frame < 8192) | ((frame >= 16384) & (frame < 24576)))
    sep = np.linalg.lstsq(np.c_[enc, np.ones(len(enc))],
                          np.where(noise, 1.0, -1.0), rcond=None)[0]
    kernel = np.zeros_like(params["ctc_head"]["kernel"])
    bias = np.zeros_like(params["ctc_head"]["bias"])
    kernel[:, 0] = -40.0 * sep[:-1]  # blank on the near-silence side
    bias[0] = -40.0 * sep[-1]
    kernel[:, 1:] = 0.1 * rng.randn(*kernel[:, 1:].shape)
    params["ctc_head"] = {"kernel": kernel, "bias": bias}
    return jm, params, load_jax_params(ASRModel(cfg), params).eval(), wave


def test_window_recogniser_matches_jax_and_offline(v1_models):
    jm, params, tm, wave = v1_models
    jwin = jsv1.WindowStreamingASR(JSpeech2Text(jm, params, **BEAM))
    twin = tsv1.WindowStreamingASR(Speech2Text(tm, device="cpu", **BEAM))
    for i in range(0, len(wave), 3 * CHUNK):
        jwin.accept_input(wave[i:i + 3 * CHUNK])
        twin.accept_input(wave[i:i + 3 * CHUNK])
    want, got = jwin.decode_with_attention_offline(), \
        twin.decode_with_attention_offline()
    assert [ids for ids, _ in got] == [[int(x) for x in ids]
                                       for ids, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=SCORE_TOL)
    # one window holding everything is the offline decode
    one = tsv1.WindowStreamingASR(Speech2Text(tm, device="cpu", **BEAM))
    one.accept_input(wave)
    offline = Speech2Text(tm, device="cpu", **BEAM)(
        wave[None], np.array([len(wave)]), nbest=3)[0].nbest
    assert one.decode_with_attention_offline() == offline


def test_segment_recogniser_endpoints_match_jax(v1_models):
    jm, params, tm, wave = v1_models
    jseg = jsv1.SegmentStreamingASR(JSpeech2Text(jm, params, **BEAM))
    tseg = tsv1.SegmentStreamingASR(Speech2Text(tm, device="cpu", **BEAM))
    fired = 0
    for i in range(0, len(wave), CHUNK):
        want = jseg.accept_input(wave[i:i + CHUNK])
        got = tseg.accept_input(wave[i:i + CHUNK])
        assert (got is None) == (want is None), f"chunk {i // CHUNK}"
        if got is not None:
            fired += 1
            assert [ids for ids, _ in got] == [[int(x) for x in ids]
                                               for ids, _ in want]
            np.testing.assert_allclose([s for _, s in got],
                                       [s for _, s in want], atol=SCORE_TOL)
    assert fired == 2  # one endpoint after each stretch of noise


# ------------------------------------------------------------- plugins

@registry.register("encoder", "test_subsampled_linear")
class _PluginEncoder(torch.nn.Module):
    """Conv2d subsampling and nothing more: (feats, lengths, generator) ->
    (out, out_lengths), the built-in encoders' signature."""

    def __init__(self, n_feats: int, d_model: int):
        super().__init__()
        self.embed = Conv2dSubsampling(d_model, n_feats, 4)

    def forward(self, feats, lengths, generator=None):
        return self.embed(feats, lengths)


registry.register("decoder", "test_transformer_decoder")(TransformerDecoder)


def test_plugins_build_through_the_conf_sections():
    section = ASRModelSection(
        n_mels=16, d_model=16, use_specaug=False, normalize="none",
        dropout_rate=0.0,
        encoder_type="test_subsampled_linear",
        encoder_conf="{n_feats: 16, d_model: 16}",
        decoder_type="test_transformer_decoder",
        decoder_conf={"vocab_size": 10, "d_model": 16, "num_heads": 2,
                      "d_ff": 32, "num_layers": 1})
    model = ASRTask.build_model(section, 10)
    assert isinstance(model.encoder, _PluginEncoder)
    assert isinstance(model.decoder, TransformerDecoder)
    rng = np.random.RandomState(0)
    speech = _t(0.1 * rng.randn(2, 4000).astype(np.float32))
    lens = torch.tensor([4000, 3000])
    loss, stats = model.train()(speech, lens, torch.tensor([[1, 2], [3, 0]]),
                                torch.tensor([2, 1]))
    loss.backward()
    assert torch.isfinite(loss) and set(stats) >= {"loss_ctc", "loss_att"}
    out = Speech2Text(model.eval(), device="cpu", beam_size=2,
                      max_steps=3)(speech.numpy(), lens.numpy())
    assert len(out) == 2
    with pytest.raises(ValueError, match="registered plugins"):
        ASRModel(dataclasses.replace(model.config, encoder_type="nope"))
