"""STFT / mel-spectrogram ops (PyTorch), with the numpy filterbanks.

Port of tacotron2_tpu/ops/stft.py: librosa semantics (centre padding with
zeros, periodic Hann window padded to n_fft, Slaney-normalised mel
filterbank) without librosa. Spectrograms are batch-first
`[..., frames, bins]`.

The STFT and iSTFT are real DFT products against cos/sin bases restricted
to the window's support (`stft`, :183-200): the padded window is zero
outside it, so the product over the 800 support samples of a 2048-point
frame is exact. These are plain products outside any kernel; the
Griffin-Lim kernel (`csrc/griffin_lim.cu`) does the same products itself.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import AudioConfig

# ----------------------------------------------------------------- windows


def hann_window(win_size: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (scipy get_window('hann', n, fftbins=True))."""
    n = np.arange(win_size)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)).astype(dtype)


def padded_window(win_size: int, n_fft: int, dtype=np.float32) -> np.ndarray:
    """Hann window centred in an n_fft buffer (librosa util.pad_center)."""
    w = hann_window(win_size, dtype)
    lpad = (n_fft - win_size) // 2
    return np.pad(w, (lpad, n_fft - win_size - lpad))


def support(n_fft: int, win_size: int) -> Tuple[int, np.ndarray]:
    """(lpad, window over its support): the samples of each frame that the
    padded window does not zero."""
    if win_size < n_fft:
        return (n_fft - win_size) // 2, hann_window(win_size)
    return 0, padded_window(win_size, n_fft)


# ------------------------------------------------------------- DFT matrices


@functools.lru_cache(maxsize=4)
def _dft_bases(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin bases [n_fft, K] with K = n_fft//2+1 for the forward rDFT."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _idft_bases(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse bases [K, n_fft]: x = re @ Ci - im @ Si (hermitian weights)."""
    K = n_fft // 2 + 1
    k = np.arange(K)
    n = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(k, n) / n_fft
    w = np.full((K, 1), 2.0, dtype=np.float64)
    w[0, 0] = 1.0
    if n_fft % 2 == 0:
        w[-1, 0] = 1.0
    ci = (w * np.cos(ang) / n_fft).astype(np.float32)
    si = (w * np.sin(ang) / n_fft).astype(np.float32)
    return ci, si


_device_bases: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def _bases(n_fft: int, win_size: int, device) -> Tuple[torch.Tensor, ...]:
    """(cos, sin) [ext, K] forward and (ci, si) [K, ext] inverse bases over
    the window support, and the window [ext], on `device` (cached)."""
    key = (n_fft, win_size, str(device))
    if key not in _device_bases:
        lpad, window = support(n_fft, win_size)
        ext = window.shape[0]
        cos_b, sin_b = _dft_bases(n_fft)
        ci, si = _idft_bases(n_fft)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        _device_bases[key] = (
            t(cos_b[lpad:lpad + ext]), t(sin_b[lpad:lpad + ext]),
            t(ci[:, lpad:lpad + ext]), t(si[:, lpad:lpad + ext]), t(window))
    return _device_bases[key]


# ----------------------------------------------------------------- mel basis


def _hz_to_mel(freqs: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False)."""
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freqs = np.asanyarray(freqs, dtype=np.float64)
    return np.where(freqs >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freqs, 1e-10)
                                         / min_log_hz) / logstep,
                    freqs / f_sp)


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mels = np.asanyarray(mels, dtype=np.float64)
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    f_sp * mels)


@functools.lru_cache(maxsize=8)
def mel_basis(sample_rate: int, n_fft: int, num_mels: int, fmin: float,
              fmax: float) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank [num_mels, n_fft//2+1]
    (librosa.filters.mel)."""
    assert fmax <= sample_rate // 2, "fmax above Nyquist"
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   num_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2: num_mels + 2] - mel_f[:num_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def inv_mel_basis(sample_rate: int, n_fft: int, num_mels: int, fmin: float,
                  fmax: float) -> np.ndarray:
    """Pseudo-inverse of the mel basis [n_fft//2+1, num_mels]."""
    return np.linalg.pinv(mel_basis(sample_rate, n_fft, num_mels, fmin,
                                    fmax)).astype(np.float32)


def config_mel_basis(cfg: AudioConfig) -> np.ndarray:
    return mel_basis(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin,
                     cfg.fmax)


def config_inv_mel_basis(cfg: AudioConfig) -> np.ndarray:
    return inv_mel_basis(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin,
                         cfg.fmax)


# ----------------------------------------------------------------- framing


def frame_signal(y: torch.Tensor, n_fft: int, hop: int,
                 win_size: int | None = None) -> torch.Tensor:
    """Centre-pad with zeros and cut into overlapping frames:
    [..., T] -> [..., frames, extent]; with `win_size` < n_fft only the
    window support [lpad, lpad + win_size) of each frame (extent =
    win_size), which is exact for the windowed product."""
    pad = n_fft // 2
    if win_size is None or win_size >= n_fft:
        extent, lpad = n_fft, 0
    else:
        extent, lpad = win_size, (n_fft - win_size) // 2
    y = torch.nn.functional.pad(y, (pad, pad))
    num = 1 + (y.shape[-1] - n_fft) // hop
    y = y[..., lpad:lpad + (num - 1) * hop + extent]
    return y.unfold(-1, extent, hop)


def stft(y: torch.Tensor, n_fft: int, hop: int, win_size: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real STFT as a DFT product. y [..., T] -> (re, im) [..., frames, K];
    the sign convention of np.fft.rfft."""
    cos_b, sin_b, _, _, window = _bases(n_fft, win_size, y.device)
    frames = frame_signal(y, n_fft, hop, win_size) * window
    return frames @ cos_b, -(frames @ sin_b)


def stft_mag(y: torch.Tensor, n_fft: int, hop: int,
             win_size: int) -> torch.Tensor:
    """|STFT| [..., frames, K]."""
    re, im = stft(y, n_fft, hop, win_size)
    return torch.sqrt(re * re + im * im)


@functools.lru_cache(maxsize=16)
def wss_inverse(n_fft: int, hop: int, win_size: int, num: int) -> np.ndarray:
    """1 / window-sum-square over the `num`-frame signal of n_fft + hop·
    (num-1) samples (1 where it is ~0), float32."""
    win_sq = padded_window(win_size, n_fft).astype(np.float64) ** 2
    total = n_fft + hop * (num - 1)
    wss = np.zeros(total, np.float64)
    for i in range(num):
        wss[i * hop: i * hop + n_fft] += win_sq
    return (1.0 / np.where(wss > 1e-10, wss, 1.0)).astype(np.float32)


def overlap_add(frames: torch.Tensor, n_fft: int, hop: int,
                lpad: int) -> torch.Tensor:
    """Frames [N, num, ext] whose sample j sits at lpad + j of an n_fft
    frame -> their sum [N, n_fft + hop·(num-1)], frame i at i·hop."""
    N, num, ext = frames.shape
    total = n_fft + hop * (num - 1)
    k = -(-(lpad % hop + ext) // hop)
    off_planes, off_rem = divmod(lpad, hop)
    flat = torch.nn.functional.pad(frames,
                                   (off_rem, k * hop - off_rem - ext))
    planes = flat.reshape(N, num, k, hop)
    rows = max(num + off_planes + k - 1, -(-total // hop))
    acc = frames.new_zeros(N, rows, hop)
    for s in range(k):
        acc[:, off_planes + s: off_planes + s + num] += planes[:, :, s]
    return acc.reshape(N, rows * hop)[:, :total]


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int,
          win_size: int) -> torch.Tensor:
    """Inverse STFT: windowed overlap-add with the window-sum-square
    normalisation and librosa's centre trim. (re, im) [..., frames, K] ->
    [..., hop·(frames-1)]."""
    _, _, ci, si, window = _bases(n_fft, win_size, re.device)
    lpad, _ = support(n_fft, win_size)
    frames = (re @ ci - im @ si) * window
    num = frames.shape[-2]
    batch_shape = frames.shape[:-2]
    y = overlap_add(frames.reshape(-1, num, frames.shape[-1]), n_fft, hop,
                    lpad)
    y = y * torch.from_numpy(wss_inverse(n_fft, hop, win_size, num)).to(
        y.device)
    pad = n_fft // 2
    y = y[:, pad: y.shape[-1] - pad]
    return y.reshape(*batch_shape, y.shape[-1])


# ------------------------------------------ TF-semantics STFT (GL_on_GPU)
#
# The reference's in-graph Griffin-Lim (audio.py:163-176) frames with
# tf.signal: win_size frames with no centring, hann(win_size), the rfft
# zero-padded to n_fft, and on the inverse a raw hann-windowed overlap-add
# (no window-sum-square normalisation). JAX ops/stft.py:267-329; plain
# products on the caller's device, as JAX computes them in XLA outside any
# Pallas kernel.


def frame_uncentered(y: torch.Tensor, frame_len: int,
                     hop: int) -> torch.Tensor:
    """[..., T] -> [..., frames, frame_len], no padding (TF framing)."""
    num = 1 + (y.shape[-1] - frame_len) // hop
    return y[..., :(num - 1) * hop + frame_len].unfold(-1, frame_len, hop)


def _tf_bases(n_fft: int, win_size: int, device) -> Tuple[torch.Tensor, ...]:
    """`_bases` of the TF framing: the first win_size samples of each
    n_fft frame, hann(win_size) (cached)."""
    key = ("tf", n_fft, win_size, str(device))
    if key not in _device_bases:
        cos_b, sin_b = _dft_bases(n_fft)
        ci, si = _idft_bases(n_fft)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        _device_bases[key] = (
            t(cos_b[:win_size]), t(sin_b[:win_size]), t(ci[:, :win_size]),
            t(si[:, :win_size]), t(hann_window(win_size)))
    return _device_bases[key]


def stft_tf(y: torch.Tensor, n_fft: int, hop: int, win_size: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tf.signal.stft: uncentred hann(win) frames, the rfft at n_fft."""
    cos_b, sin_b, _, _, window = _tf_bases(n_fft, win_size, y.device)
    frames = frame_uncentered(y, win_size, hop) * window
    return frames @ cos_b, -(frames @ sin_b)


def istft_tf(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int,
             win_size: int) -> torch.Tensor:
    """tf.signal.inverse_stft with its default hann window: the irfft at
    n_fft cut to win_size, windowed, raw overlap-add. [..., frames, K] ->
    [..., hop·(frames-1) + win_size]."""
    _, _, ci, si, window = _tf_bases(n_fft, win_size, re.device)
    frames = (re @ ci - im @ si) * window
    num = frames.shape[-2]
    y = overlap_add(frames.reshape(-1, num, win_size), win_size, hop, 0)
    return y.reshape(*frames.shape[:-2], y.shape[-1])


# ----------------------------------------------------------- dB / normalise


def amp_to_db(x: torch.Tensor, min_level_db: float) -> torch.Tensor:
    """20·log10(max(min_level, x)), min_level = 10^(min_level_db/20)."""
    min_level = float(np.exp(min_level_db / 20.0 * np.log(10.0)).astype(
        np.float32))
    return 20.0 * torch.log10(torch.clamp(x, min=min_level))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize_db(S: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """dB spectrogram -> the model's range."""
    m = cfg.max_abs_value
    scaled = (S - cfg.min_level_db) / (-cfg.min_level_db)
    if cfg.symmetric_mels:
        out, lo, hi = 2.0 * m * scaled - m, -m, m
    else:
        out, lo, hi = m * scaled, 0.0, m
    if cfg.allow_clipping_in_normalization:
        out = torch.clamp(out, lo, hi)
    return out


def denormalize_db(D: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """The model's range -> dB."""
    m = cfg.max_abs_value
    if cfg.allow_clipping_in_normalization:
        D = torch.clamp(D, -m if cfg.symmetric_mels else 0.0, m)
    if cfg.symmetric_mels:
        return (D + m) * -cfg.min_level_db / (2.0 * m) + cfg.min_level_db
    return D * -cfg.min_level_db / m + cfg.min_level_db


# ----------------------------------------------------------- spectrograms


def mel_spectrogram(y: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """Waveform [..., T] -> normalised mel spectrogram [..., frames, mels]."""
    mag = stft_mag(y, cfg.n_fft, cfg.effective_hop, cfg.win_size) \
        ** cfg.magnitude_power
    mel = mag @ torch.from_numpy(config_mel_basis(cfg)).to(y.device).T
    S = amp_to_db(mel, cfg.min_level_db) - cfg.ref_level_db
    return normalize_db(S, cfg) if cfg.signal_normalization else S


def mel_to_linear(mel_mag: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """Magnitude mel [..., frames, mels] -> linear [..., frames, bins]
    through the pseudo-inverse basis."""
    inv = torch.from_numpy(config_inv_mel_basis(cfg)).to(mel_mag.device)
    return torch.clamp(mel_mag @ inv.T, min=1e-10)
