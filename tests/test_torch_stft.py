"""The port's STFT / mel ops and host audio against the JAX package's, on
the CPU.

Same numpy signals through `tacotron2_tpu.ops.stft` / `data.audio` and
`tacotron2_tpu_torch.ops.stft` / `data.audio`. Both sides are f32 DFT
products over the window's support, summed in another order: spectra of
unit-variance noise (bins up to ~60) agree to atol 1e-4, waveforms to
1e-5; normalised mels (range ±4) to 1e-4. The host mel is numpy on both
sides (float64 FFT) and agrees to 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tacotron2_tpu.config import Config
from tacotron2_tpu.data import audio as jaudio
from tacotron2_tpu.ops import stft as jst
from tacotron2_tpu_torch.config import Config as TorchConfig
from tacotron2_tpu_torch.data import audio as taudio
from tacotron2_tpu_torch.ops import stft as tst

# (n_fft, hop, win): a full-width window, the production shape restricted
# to the 800-sample support, and a support whose offset is not a hop multiple
SHAPES = [(512, 128, 512), (2048, 200, 800), (256, 64, 100)]


def _signal(n, seed=0, batch=2):
    return np.random.default_rng(seed).normal(size=(batch, n)).astype(
        np.float32)


@pytest.mark.parametrize("n_fft,hop,win", SHAPES)
def test_stft_matches_jax(n_fft, hop, win):
    y = _signal(hop * 21 + 37)
    re_j, im_j = jst.stft(jnp.asarray(y), n_fft, hop, win)
    re_t, im_t = tst.stft(torch.as_tensor(y), n_fft, hop, win)
    assert re_t.shape == re_j.shape
    np.testing.assert_allclose(re_t, np.asarray(re_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(im_t, np.asarray(im_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        tst.stft_mag(torch.as_tensor(y), n_fft, hop, win),
        np.asarray(jst.stft_mag(jnp.asarray(y), n_fft, hop, win)),
        rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_fft,hop,win", SHAPES)
def test_istft_matches_jax(n_fft, hop, win):
    y = _signal(hop * 21 + 37, seed=1)
    re, im = (np.array(x) for x in jst.stft(jnp.asarray(y), n_fft, hop,
                                             win))
    want = np.asarray(jst.istft(jnp.asarray(re), jnp.asarray(im), n_fft, hop,
                                win))
    got = tst.istft(torch.as_tensor(re), torch.as_tensor(im), n_fft, hop, win)
    assert got.shape == want.shape == (2, hop * 21)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the round trip restores the signal inside the centre-trimmed span
    np.testing.assert_allclose(got, y[:, :hop * 21], rtol=0, atol=1e-4)


def test_mel_spectrogram_and_inverse_basis_match_jax():
    cfg_j, cfg_t = Config().audio, TorchConfig().audio
    y = 0.3 * _signal(16000, seed=2, batch=1)[0]
    mj = np.asarray(jst.mel_spectrogram(jnp.asarray(y), cfg_j))
    mt = tst.mel_spectrogram(torch.as_tensor(y), cfg_t)
    assert mt.shape == mj.shape == (81, cfg_t.num_mels)
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-4)
    mag = np.abs(np.random.default_rng(3).normal(
        size=(5, cfg_t.num_mels))).astype(np.float32)
    np.testing.assert_allclose(
        tst.mel_to_linear(torch.as_tensor(mag), cfg_t),
        np.asarray(jst.mel_to_linear(jnp.asarray(mag), cfg_j)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tst.config_mel_basis(cfg_t),
                                  jst.config_mel_basis(cfg_j))


@pytest.mark.parametrize("sym,clip", [(True, True), (False, True),
                                      (True, False)])
def test_db_normalisation_matches_jax(sym, clip):
    kw = dict(symmetric_mels=sym, allow_clipping_in_normalization=clip)
    cfg_j = dataclasses.replace(Config().audio, **kw)
    cfg_t = dataclasses.replace(TorchConfig().audio, **kw)
    S = np.linspace(-120, 10, 57).astype(np.float32)
    n_j = np.array(jst.normalize_db(jnp.asarray(S), cfg_j))
    n_t = tst.normalize_db(torch.as_tensor(S), cfg_t)
    np.testing.assert_allclose(n_t, n_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tst.denormalize_db(torch.as_tensor(n_j), cfg_t),
                               np.asarray(jst.denormalize_db(
                                   jnp.asarray(n_j), cfg_j)),
                               rtol=0, atol=1e-4)
    amp = np.abs(S) / 50
    np.testing.assert_allclose(
        tst.amp_to_db(torch.as_tensor(amp), -100.0),
        np.asarray(jst.amp_to_db(jnp.asarray(amp), -100.0)), rtol=0,
        atol=1e-4)


def test_host_audio_matches_jax(tmp_path):
    cfg_j, cfg_t = Config().audio, TorchConfig().audio
    wav = (0.3 * _signal(12345, seed=4, batch=1)[0]).astype(np.float32)
    np.testing.assert_allclose(taudio.mel_spectrogram(wav, cfg_t),
                               jaudio.mel_spectrogram(wav, cfg_j),
                               rtol=0, atol=1e-5)
    pre_t = taudio.preemphasis(wav, 0.97)
    np.testing.assert_array_equal(pre_t, jaudio.preemphasis(wav, 0.97))
    np.testing.assert_array_equal(taudio.inv_preemphasis(pre_t, 0.97),
                                  jaudio.inv_preemphasis(pre_t, 0.97))
    assert taudio.preemphasis(wav, 0.97, False) is wav
    # the same int16 file as the JAX package's writer
    taudio.save_wav(wav, str(tmp_path / "t.wav"), 16000)
    jaudio.save_wav(wav, str(tmp_path / "j.wav"), 16000)
    sr_t, pcm_t = wavfile.read(str(tmp_path / "t.wav"))
    sr_j, pcm_j = wavfile.read(str(tmp_path / "j.wav"))
    assert sr_t == sr_j == 16000 and pcm_t.dtype == np.int16
    np.testing.assert_array_equal(pcm_t, pcm_j)
    taudio.save_wav(np.zeros(0, np.float32), str(tmp_path / "e.wav"), 16000)
    assert wavfile.read(str(tmp_path / "e.wav"))[1].shape == (1,)
