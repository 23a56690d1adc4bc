"""Host-side (numpy) audio: preemphasis, wav writing, the mel spectrogram.

The part of tacotron2_tpu/data/audio.py that synthesis and its quality
checks use: `preemphasis` / `inv_preemphasis` (:61,68), `save_wav` (:45),
`_stft_np` and `mel_spectrogram` (:143,211). The filterbank and the dB
normalisation follow `ops/stft.py`'s numpy bases, so host and device
features agree.
"""

from __future__ import annotations

import wave

import numpy as np
from scipy import signal

from ..config import AudioConfig
from ..ops import stft as _stft


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
