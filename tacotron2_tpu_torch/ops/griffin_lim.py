"""Griffin-Lim phase reconstruction and the spectrogram inversions.

Port of tacotron2_tpu/ops/griffin_lim.py: `griffin_lim` (:28),
`inv_linear_spectrogram` (:148) and `inv_mel_spectrogram` (:167), with
their dispatch (:137). Spectrograms are `[..., frames, bins]` magnitudes
already raised to `power`.

Unlike the JAX package, where the Pallas kernel is opt-in on the TPU, a
CUDA tensor always goes through the Griffin-Lim kernel
(`ops/griffin_lim_kernel.py`) and a CPU tensor through its plain version.
A `torch.Generator` takes the place of the JAX `key`: with one, phases
start uniform in [0, 2π) (the numpy path's random init, audio.py:155);
without, at zero. Either start is handed to the kernel as (re0, im0).
"""

from __future__ import annotations

import math

import torch

from ..config import AudioConfig
from . import griffin_lim_kernel as glk
from . import stft as _stft


def griffin_lim(S: torch.Tensor, n_fft: int, hop: int, win_size: int,
                iters: int = 60, generator: torch.Generator | None = None,
                compute_dtype: str | None = None) -> torch.Tensor:
    """Magnitude [..., frames, bins] -> waveform [..., hop·(frames-1)]."""
    if compute_dtype not in (None, "float32"):
        raise NotImplementedError(
            f"gl_compute_dtype={compute_dtype!r}: the port's Griffin-Lim "
            "runs in float32 only")
    S = S.float()
    if generator is not None:
        phase = torch.rand(S.shape, generator=generator, device=S.device) \
            * (2 * math.pi)
        re0, im0 = S * torch.cos(phase), S * torch.sin(phase)
    else:
        re0, im0 = S, torch.zeros_like(S)
    lead = S.shape[:-2]
    flat = lambda x: x.reshape(-1, *S.shape[-2:])
    y = glk.fused_griffin_lim(flat(S), flat(re0), flat(im0), n_fft, hop,
                              win_size, iters)
    return y.reshape(*lead, y.shape[-1])


def _magnitude(spec: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    D = _stft.denormalize_db(spec, cfg) if cfg.signal_normalization else spec
    return _stft.db_to_amp(D + cfg.ref_level_db) ** (1.0 / cfg.magnitude_power)


def inv_linear_spectrogram(linear: torch.Tensor, cfg: AudioConfig,
                           generator: torch.Generator | None = None
                           ) -> torch.Tensor:
    """Normalised linear spectrogram [..., frames, bins] -> waveform
    (before inverse preemphasis, which the host applies)."""
    S = _magnitude(linear.float(), cfg)
    return griffin_lim(S ** cfg.power, cfg.n_fft, cfg.effective_hop,
                       cfg.win_size, cfg.griffin_lim_iters, generator,
                       cfg.gl_compute_dtype)


def inv_mel_spectrogram(mel: torch.Tensor, cfg: AudioConfig,
                        generator: torch.Generator | None = None
                        ) -> torch.Tensor:
    """Normalised mel spectrogram [..., frames, mels] -> waveform:
    denormalise, dB -> amplitude, mel -> linear through the pseudo-inverse,
    Griffin-Lim (before inverse preemphasis)."""
    lin = _stft.mel_to_linear(_magnitude(mel.float(), cfg), cfg)
    return griffin_lim(lin ** cfg.power, cfg.n_fft, cfg.effective_hop,
                       cfg.win_size, cfg.griffin_lim_iters, generator,
                       cfg.gl_compute_dtype)
