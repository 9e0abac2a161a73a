"""Frontend ops and positional tables of the PyTorch port against the JAX
package, float32 on the CPU, same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models import embedding as jemb
from espnet_tpu.ops import masks as jmasks
from espnet_tpu.ops import normalize as jnorm
from espnet_tpu.ops import stft as jstft
from espnet_tpu_torch.models import embedding as temb
from espnet_tpu_torch.ops import masks as tmasks
from espnet_tpu_torch.ops import normalize as tnorm
from espnet_tpu_torch.ops import stft as tstft


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

# float32 products of 512-sample frames: a few ulp of the spectrum's range
STFT_ATOL, STFT_RTOL = 2e-3, 1e-4
LOGMEL_ATOL = 1e-3  # natural-log energies of O(10)
TIGHT = 1e-6


def _j(x):
    return np.asarray(x)


def test_masks_match():
    lengths = np.array([0, 3, 7, 5], np.int32)
    np.testing.assert_array_equal(
        _j(jmasks.make_valid_mask(jnp.asarray(lengths), 7)),
        tmasks.make_valid_mask(torch.from_numpy(lengths), 7).numpy())
    np.testing.assert_array_equal(
        _j(jmasks.make_pad_mask(jnp.asarray(lengths), 7)),
        tmasks.make_pad_mask(torch.from_numpy(lengths), 7).numpy())
    np.testing.assert_array_equal(_j(jmasks.subsequent_mask(5)),
                                  tmasks.subsequent_mask(5).numpy())
    mask = np.random.RandomState(0).rand(2, 1, 3, 4) > 0.5
    jb = _j(jmasks.attention_bias(jnp.asarray(mask)))
    tb = tmasks.attention_bias(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(jb, tb)
    # finite, not -inf: a fully masked softmax row stays finite
    assert np.isfinite(tb).all() and tb.min() == np.finfo(np.float32).min


@pytest.mark.parametrize("n_fft,hop,win", [(512, 128, None), (400, 160, 300)])
def test_stft_matches(n_fft, hop, win):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3000).astype(np.float32)
    fj = _j(jstft.frame_signal(jnp.asarray(x), n_fft, hop))
    ft = tstft.frame_signal(torch.from_numpy(x), n_fft, hop).numpy()
    np.testing.assert_array_equal(fj, ft)
    rj, ij = jstft.stft(jnp.asarray(x), n_fft, hop, win)
    rt, it = tstft.stft(torch.from_numpy(x), n_fft, hop, win)
    np.testing.assert_allclose(rt.numpy(), _j(rj), atol=STFT_ATOL, rtol=STFT_RTOL)
    np.testing.assert_allclose(it.numpy(), _j(ij), atol=STFT_ATOL, rtol=STFT_RTOL)


@pytest.mark.parametrize("kw", [dict(), dict(fs=8000, n_fft=256, n_mels=40),
                                dict(htk=True, fmin=20.0, fmax=7000.0)])
def test_mel_filterbank_matches(kw):
    np.testing.assert_allclose(tstft.mel_filterbank(**kw),
                               jstft.mel_filterbank(**kw), rtol=0, atol=0)


def test_windows_and_lengths_match():
    np.testing.assert_array_equal(tstft.hann_window(400),
                                  jstft.hann_window(400))
    ilens = np.array([16000, 4001, 127], np.int32)
    np.testing.assert_array_equal(
        _j(jstft.stft_frames_lengths(jnp.asarray(ilens), 512, 128)),
        tstft.stft_frames_lengths(torch.from_numpy(ilens), 512, 128).numpy())


def test_log_mel_spectrogram_matches():
    rng = np.random.RandomState(2)
    lens = np.array([8000, 5300, 2100], np.int32)
    x = (0.1 * rng.randn(3, 8000)).astype(np.float32)
    x[np.arange(8000)[None] >= lens[:, None]] = 0.0
    fj, lj = jstft.log_mel_spectrogram(jnp.asarray(x), jnp.asarray(lens))
    ft, lt = tstft.log_mel_spectrogram(torch.from_numpy(x),
                                       torch.from_numpy(lens))
    np.testing.assert_array_equal(_j(lj), lt.numpy())
    np.testing.assert_allclose(ft.numpy(), _j(fj), atol=LOGMEL_ATOL, rtol=0)
    p = rng.rand(2, 5, 257).astype(np.float32)
    np.testing.assert_allclose(tstft.log_mel(torch.from_numpy(p)).numpy(),
                               _j(jstft.log_mel(jnp.asarray(p))),
                               atol=LOGMEL_ATOL, rtol=0)


@pytest.mark.parametrize("norm_vars", [False, True])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_utterance_mvn_matches(norm_vars, with_lengths):
    rng = np.random.RandomState(3)
    x = rng.randn(3, 11, 5).astype(np.float32) * 2 + 1
    lens = np.array([11, 6, 1], np.int32)
    jl = jnp.asarray(lens) if with_lengths else None
    tl = torch.from_numpy(lens) if with_lengths else None
    j = _j(jnorm.utterance_mvn(jnp.asarray(x), jl, norm_vars=norm_vars))
    t = tnorm.utterance_mvn(torch.from_numpy(x), tl, norm_vars=norm_vars)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t,d", [(1, 4), (17, 64), (469, 256)])
def test_positional_tables_match(t, d):
    np.testing.assert_array_equal(temb.rel_positional_table(t, d),
                                  jemb.rel_positional_table(t, d))
    np.testing.assert_array_equal(temb.sinusoidal_table(t, d),
                                  jemb.sinusoidal_table(t, d))
    pj = _j(jemb.rel_position_encoding(t, d))
    pt = temb.rel_position_encoding(t, d).numpy()
    assert pt.shape == (1, 2 * t - 1, d)
    np.testing.assert_array_equal(pt, pj)
    # row T-1-r holds relative offset r: offset 0 is sin(0)=0, cos(0)=1
    np.testing.assert_array_equal(pt[0, t - 1, 0::2], 0.0)
    np.testing.assert_array_equal(pt[0, t - 1, 1::2], 1.0)


def test_add_positional_encoding_matches():
    x = np.random.RandomState(4).randn(2, 9, 16).astype(np.float32)
    j = _j(jemb.add_positional_encoding(jnp.asarray(x)))
    t = temb.add_positional_encoding(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(t, j, atol=TIGHT, rtol=TIGHT)
