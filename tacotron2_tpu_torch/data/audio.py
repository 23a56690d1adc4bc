"""Host-side (numpy) audio: wav reading and writing, preemphasis, the
voice-activity split, the mel spectrogram.

The part of tacotron2_tpu/data/audio.py that synthesis, its quality checks
and the discriminators' preprocessing use: `load_wav` (:23, scipy's wav
reader and `resample_poly`), `save_wav` (:45), `preemphasis` /
`inv_preemphasis` (:61,68), `split_silence` (:104, librosa.effects.split's
behaviour), `_stft_np` and `mel_spectrogram` (:143,211). The filterbank
and the dB normalisation follow `ops/stft.py`'s numpy bases, so host and
device features agree.
"""

from __future__ import annotations

import wave

import numpy as np
from scipy import signal

from ..config import AudioConfig
from ..ops import stft as _stft


def load_wav(path: str, sr: int) -> np.ndarray:
    """A wav as float32 in [-1, 1], channels averaged, resampled to `sr`
    (librosa.core.load; reference audio.py:9-10)."""
    from scipy.io import wavfile
    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    if file_sr != sr:
        g = np.gcd(int(file_sr), int(sr))
        wav = signal.resample_poly(wav, sr // g,
                                   file_sr // g).astype(np.float32)
    return wav


def save_wav(wav: np.ndarray, path: str, sr: int) -> None:
    """Peak-normalise to int16 and write a mono wav (reference
    audio.py:12-15), with the standard library's writer."""
    wav = np.asarray(wav, np.float32)
    if wav.size == 0:  # degenerate synthesis (a stop at step 0)
        wav = np.zeros(1, np.float32)
    pcm = (wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))).astype(
        "<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def preemphasis(wav: np.ndarray, k: float,
                preemphasize: bool = True) -> np.ndarray:
    """y[n] = x[n] - k·x[n-1]."""
    if preemphasize:
        return signal.lfilter([1, -k], [1], wav).astype(np.float32)
    return wav


def inv_preemphasis(wav: np.ndarray, k: float,
                    inv_preemphasize: bool = True) -> np.ndarray:
    """y[n] = x[n] + k·y[n-1]."""
    if inv_preemphasize:
        return signal.lfilter([1], [1, -k], wav).astype(np.float32)
    return wav


def split_silence(wav: np.ndarray, top_db: float = 20.0,
                  frame_length: int = 2048, hop_length: int = 512
                  ) -> np.ndarray:
    """Non-silent intervals [[start, end), ...] in samples: frame RMS
    (centred, zero-padded frames) in dB of the loudest frame, runs above
    -top_db (librosa.effects.split; the discriminators' voice-activity
    split, spk_disc/data_preprocess.py:118,175)."""
    wav = np.asarray(wav)
    if len(wav) == 0:
        return np.zeros((0, 2), np.int64)
    padded = np.pad(wav, (frame_length // 2, frame_length // 2))
    num = 1 + (len(padded) - frame_length) // hop_length
    idx = (np.arange(num)[:, None] * hop_length
           + np.arange(frame_length)[None, :])
    rms = np.sqrt(np.mean(padded[idx] ** 2, axis=1))
    ref = np.max(rms)
    if ref <= 0:
        return np.zeros((0, 2), np.int64)
    nonsilent = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref) > -top_db
    edges = np.diff(nonsilent.astype(np.int8), prepend=0, append=0)
    starts = np.flatnonzero(edges == 1) * hop_length
    ends = np.flatnonzero(edges == -1) * hop_length
    return np.stack([np.minimum(starts, len(wav)),
                     np.minimum(ends, len(wav))], axis=1).astype(np.int64)


def _stft_np(y: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Centred STFT -> complex [frames, bins]."""
    n_fft, hop = cfg.n_fft, cfg.effective_hop
    pad = n_fft // 2
    y = np.pad(y, (pad, pad))
    num = 1 + (len(y) - n_fft) // hop
    idx = np.arange(num)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = y[idx] * _stft.padded_window(cfg.win_size, n_fft)
    return np.fft.rfft(frames, n=n_fft, axis=-1)


def _amp_to_db(x: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    min_level = np.exp(cfg.min_level_db / 20 * np.log(10))
    return 20 * np.log10(np.maximum(min_level, x))


def _normalize(S: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    m = cfg.max_abs_value
    scaled = (S - cfg.min_level_db) / (-cfg.min_level_db)
    if cfg.symmetric_mels:
        out, lo, hi = 2 * m * scaled - m, -m, m
    else:
        out, lo, hi = m * scaled, 0.0, m
    if cfg.allow_clipping_in_normalization:
        out = np.clip(out, lo, hi)
    else:
        assert S.max() <= 0 and S.min() - cfg.min_level_db >= 0
    return out


def mel_spectrogram(wav: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """[T] waveform -> [frames, num_mels] normalised mel spectrogram
    (reference melspectrogram, audio.py:70-77, frames first)."""
    mag = np.abs(_stft_np(wav, cfg)) ** cfg.magnitude_power
    mel = mag @ _stft.config_mel_basis(cfg).T
    S = _amp_to_db(mel, cfg) - cfg.ref_level_db
    out = _normalize(S, cfg) if cfg.signal_normalization else S
    return out.astype(np.float32)
