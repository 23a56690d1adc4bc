"""WaveNet output heads: draw a sample from a predicted distribution.

The port's counterparts of tacotron2_tpu/models/wavenet/distributions.py
(`sample_from_gaussian` :110, `sample_from_discretized_mix_logistic` :65)
and of the in-kernel heads of the TPU sampler (`_HeadPlan.emit` and
`_inverse_cdf_onehot`, ops/wavenet_kernel.py:133-180):

- Gaussian (out_channels 2): clip(mean + exp(max(log_s, min)) · z, -1, 1);
- mixture of logistics (out_channels 3·nr, scalar input): a mixture picked
  by inverse CDF over the softmaxed logits, then a logistic sample from it;
- categorical (mulaw-quantize): an inverse-CDF class pick.

Every function takes its random numbers from the caller, so the plain
sampler and the CUDA kernel see the same ones. Uniforms are made as the
TPU kernel's `_uniform_from_bits` makes them (:46-53): 24 random bits,
scaled by 2^-24 and offset by 2^-25, so never 0 and never 1.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...config import Config
from ...ops.mulaw import is_scalar_input


def head_kind(cfg: Config) -> Tuple[str, int]:
    """The sampler head the config names and its noise planes, as
    `_HeadPlan.__init__` decides them (ops/wavenet_kernel.py:77-95)."""
    wn = cfg.wavenet
    if is_scalar_input(wn.input_type):
        if wn.out_channels == 2:
            return "gaussian", 1
        if wn.out_channels % 3 == 0:
            return "mol", 2
        raise ValueError(f"scalar input wants out_channels 2 or 3·nr, got "
                         f"{wn.out_channels}")
    if wn.input_type != "mulaw-quantize" or \
            wn.out_channels != wn.quantize_channels:
        raise ValueError(f"input_type {wn.input_type!r} with out_channels "
                         f"{wn.out_channels} has no sampler head")
    return "categorical", 1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Integers in [0, 2^24) → uniforms in (0, 1)."""
    return bits.to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


def draw_noise(cfg: Config, B: int, T: int, generator: torch.Generator,
               device) -> torch.Tensor:
    """The sampler's random numbers [planes, B, T]: standard normals for
    the Gaussian head, 24-bit uniforms for the others."""
    kind, planes = head_kind(cfg)
    if kind == "gaussian":
        return torch.randn(1, B, T, generator=generator, device=device)
    bits = torch.randint(0, 1 << 24, (planes, B, T), generator=generator,
                         device=device)
    return uniform_from_bits(bits)


def gaussian_sample(y_hat, z, log_scale_min: float):
    """y_hat [B, 2] (mean, log_scale), z [B] -> clipped sample [B]."""
    log_s = torch.clamp(y_hat[:, 1], min=log_scale_min)
    return torch.clamp(y_hat[:, 0] + torch.exp(log_s) * z, -1.0, 1.0)


def inverse_cdf_onehot(logits, u):
    """[B, Q] logits + [B] uniforms → one-hot [B, Q] of the class whose
    cumulative softmax mass first exceeds u·total. The last class is the
    fallback for u·total rounding up to the total, so every draw is
    exactly one-hot."""
    Q = logits.shape[-1]
    e = torch.exp(logits - logits.max(-1, keepdim=True).values)
    cum = torch.cumsum(e, -1)
    last = torch.arange(Q, device=logits.device) == Q - 1
    pick = ((u[:, None] * cum[:, -1:] < cum) | last).to(torch.float32)
    return pick - torch.nn.functional.pad(pick[:, :-1], (1, 0))


def inverse_cdf_pick(logits, u):
    """The picked class index [B] (long) of `inverse_cdf_onehot`."""
    return inverse_cdf_onehot(logits, u).argmax(-1)


def mol_sample(y_hat, u_pick, u_logistic, log_scale_min: float):
    """y_hat [B, 3·nr] (logits, means, log_scales), two uniforms [B] ->
    clipped sample [B]: the mixture by inverse CDF, then a logistic draw
    with u clipped to [1e-5, 1-1e-5] (mixture.py:99-101)."""
    nr = y_hat.shape[-1] // 3
    k = inverse_cdf_pick(y_hat[:, :nr], u_pick)[:, None]
    mean = torch.gather(y_hat[:, nr:2 * nr], 1, k)[:, 0]
    log_s = torch.clamp(torch.gather(y_hat[:, 2 * nr:], 1, k)[:, 0],
                        min=log_scale_min)
    u = torch.clamp(u_logistic, 1e-5, 1.0 - 1e-5)
    return torch.clamp(mean + torch.exp(log_s) * (torch.log(u)
                                                  - torch.log(1.0 - u)),
                       -1.0, 1.0)


def sample_from_discretized_mix_logistic(y, temp, u,
                                         log_scale_min: float = -7.0):
    """Gumbel-max mixture pick and logistic sample (mixture.py:79-110),
    with the caller's uniforms: y [B, T, 3·nr], temp [B, T, nr] and u
    [B, T], both in [1e-5, 1-1e-5] -> [B, T] in [-1, 1]."""
    nr = y.shape[-1] // 3
    k = torch.argmax(y[..., :nr] - torch.log(-torch.log(temp)), -1,
                     keepdim=True)
    mean = torch.gather(y[..., nr:2 * nr], -1, k)[..., 0]
    log_s = torch.clamp(torch.gather(y[..., 2 * nr:], -1, k)[..., 0],
                        min=log_scale_min)
    x = mean + torch.exp(log_s) * (torch.log(u) - torch.log(1 - u))
    return torch.clamp(x, -1.0, 1.0)
