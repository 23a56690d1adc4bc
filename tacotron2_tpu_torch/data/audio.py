"""Host-side (numpy) audio: wav reading and writing, preemphasis,
silence trimming, the voice-activity split, the spectrograms and their
Griffin-Lim inversion.

The port's copy of tacotron2_tpu/data/audio.py: `load_wav` (:23, scipy's
wav reader and `resample_poly`), `save_wav` / `save_wavenet_wav` (:45,
:54), `preemphasis` / `inv_preemphasis` (:61,68), `trim_silence` (:78,
librosa.effects.trim's behaviour), `split_silence` (:104,
librosa.effects.split's), `start_and_end_indices` (:132), `_stft_np` /
`_istft_np` (:143,154), the dB conversions and the normalisation
(:172-201), `linear_spectrogram` and `mel_spectrogram` (:204,211),
`_griffin_lim_np`, `inv_linear_spectrogram` and `inv_mel_spectrogram`
(:226-259) and `pad_lr` (:262). Numpy and scipy only. The filterbank and
the dB normalisation follow `ops/stft.py`'s numpy bases, so host and
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


def save_wavenet_wav(wav: np.ndarray, path: str, sr: int) -> None:
    save_wav(wav, path, sr)


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


def trim_silence(wav: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Trim leading and trailing silence below `trim_top_db` of the
    loudest frame (librosa.effects.trim; reference audio.py:46-52): frame
    RMS (centred, zero-padded frames) in dB, kept from the first to the
    last frame above it."""
    frame, hop = cfg.trim_fft_size, cfg.trim_hop_size
    if len(wav) == 0:
        return wav
    padded = np.pad(wav, (frame // 2, frame // 2))
    num = 1 + (len(padded) - frame) // hop
    idx = np.arange(num)[:, None] * hop + np.arange(frame)[None, :]
    rms = np.sqrt(np.mean(padded[idx] ** 2, axis=1))
    ref = np.max(rms)
    if ref <= 0:
        return wav
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
    nonsilent = np.flatnonzero(db > -cfg.trim_top_db)
    if len(nonsilent) == 0:
        return wav[:0]
    start = int(nonsilent[0]) * hop
    end = min(len(wav), (int(nonsilent[-1]) + 1) * hop)
    return wav[start:end]


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


def start_and_end_indices(quantized: np.ndarray, silence_threshold: int = 2):
    """First and last sample outside mulaw silence (reference
    audio.py:33-44)."""
    nonsilent = np.flatnonzero(
        np.abs(quantized.astype(np.int64) - 127) > silence_threshold)
    if len(nonsilent) == 0:
        return 0, len(quantized)
    return int(nonsilent[0]), int(nonsilent[-1])


def _stft_np(y: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Centred STFT -> complex [frames, bins]."""
    n_fft, hop = cfg.n_fft, cfg.effective_hop
    pad = n_fft // 2
    y = np.pad(y, (pad, pad))
    num = 1 + (len(y) - n_fft) // hop
    idx = np.arange(num)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = y[idx] * _stft.padded_window(cfg.win_size, n_fft)
    return np.fft.rfft(frames, n=n_fft, axis=-1)


def _istft_np(spec: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Complex [frames, bins] -> waveform (overlap-add, window-square
    normalised, centre padding removed)."""
    n_fft, hop = cfg.n_fft, cfg.effective_hop
    window = _stft.padded_window(cfg.win_size, n_fft)
    frames = np.fft.irfft(spec, n=n_fft, axis=-1) * window
    num = frames.shape[0]
    total = n_fft + hop * (num - 1)
    y = np.zeros(total, dtype=np.float64)
    wss = np.zeros(total, dtype=np.float64)
    win_sq = window.astype(np.float64) ** 2
    for i in range(num):
        y[i * hop: i * hop + n_fft] += frames[i]
        wss[i * hop: i * hop + n_fft] += win_sq
    y /= np.where(wss > 1e-10, wss, 1.0)
    pad = n_fft // 2
    return y[pad: total - pad].astype(np.float32)


def _amp_to_db(x: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    min_level = np.exp(cfg.min_level_db / 20 * np.log(10))
    return 20 * np.log10(np.maximum(min_level, x))


def _db_to_amp(x: np.ndarray) -> np.ndarray:
    return np.power(10.0, x * 0.05)


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


def _denormalize(D: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    m = cfg.max_abs_value
    if cfg.allow_clipping_in_normalization:
        D = np.clip(D, -m if cfg.symmetric_mels else 0.0, m)
    if cfg.symmetric_mels:
        return (D + m) * -cfg.min_level_db / (2 * m) + cfg.min_level_db
    return D * -cfg.min_level_db / m + cfg.min_level_db


def linear_spectrogram(wav: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """[T] waveform -> [frames, num_freq] normalised linear spectrogram."""
    S = _amp_to_db(np.abs(_stft_np(wav, cfg)) ** cfg.magnitude_power,
                   cfg) - cfg.ref_level_db
    out = _normalize(S, cfg) if cfg.signal_normalization else S
    return out.astype(np.float32)


def mel_spectrogram(wav: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """[T] waveform -> [frames, num_mels] normalised mel spectrogram
    (reference melspectrogram, audio.py:70-77, frames first)."""
    mag = np.abs(_stft_np(wav, cfg)) ** cfg.magnitude_power
    mel = mag @ _stft.config_mel_basis(cfg).T
    S = _amp_to_db(mel, cfg) - cfg.ref_level_db
    out = _normalize(S, cfg) if cfg.signal_normalization else S
    return out.astype(np.float32)


def _griffin_lim_np(S: np.ndarray, cfg: AudioConfig,
                    rng: np.random.Generator | None = None,
                    init_angles: np.ndarray | None = None) -> np.ndarray:
    """Griffin-Lim in numpy (reference _griffin_lim, audio.py:151-161):
    `init_angles` (uniform [0, 1) phases / 2π) overrides the draw from
    `rng` (default_rng(0) when neither is given)."""
    if init_angles is None:
        rng = rng or np.random.default_rng(0)
        init_angles = rng.random(S.shape)
    angles = np.exp(2j * np.pi * init_angles)
    S_complex = np.abs(S).astype(np.complex128)
    y = _istft_np(S_complex * angles, cfg)
    for _ in range(cfg.griffin_lim_iters):
        angles = np.exp(1j * np.angle(_stft_np(y, cfg)))
        y = _istft_np(S_complex * angles, cfg)
    return y


def inv_linear_spectrogram(linear: np.ndarray,
                           cfg: AudioConfig) -> np.ndarray:
    """Normalised linear [frames, bins] -> waveform (audio.py:79-94)."""
    D = _denormalize(linear, cfg) if cfg.signal_normalization else linear
    S = _db_to_amp(D + cfg.ref_level_db) ** (1 / cfg.magnitude_power)
    return inv_preemphasis(_griffin_lim_np(S ** cfg.power, cfg),
                           cfg.preemphasis, cfg.preemphasize)


def inv_mel_spectrogram(mel: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Normalised mel [frames, mels] -> waveform (audio.py:97-112)."""
    D = _denormalize(mel, cfg) if cfg.signal_normalization else mel
    S = _db_to_amp(D + cfg.ref_level_db) ** (1 / cfg.magnitude_power)
    lin = np.maximum(1e-10, S @ _stft.config_inv_mel_basis(cfg).T)
    return inv_preemphasis(_griffin_lim_np(lin ** cfg.power, cfg),
                           cfg.preemphasis, cfg.preemphasize)


def pad_lr(x: np.ndarray, cfg: AudioConfig):
    """(left, right) padding to a whole number of hops, on the right or
    split over both sides (reference librosa_pad_lr, audio.py:210-219):
    the hop alignment WaveNet training depends on."""
    fshift = cfg.effective_hop
    pad = (x.shape[0] // fshift + 1) * fshift - x.shape[0]
    if cfg.wavenet_pad_sides == 1:
        return 0, pad
    return pad // 2, pad // 2 + pad % 2
