"""WaveNet output heads: the training losses, and a draw from a predicted
distribution.

The losses, in f32 and differentiable, are the port of
tacotron2_tpu/models/wavenet/distributions.py's `log_sum_exp` (:19),
`discretized_mix_logistic_loss` (:26), `gaussian_mle_loss` (:88, with
`use_cdf`), `masked_cross_entropy_loss` (:118) and
`masked_distribution_loss` (:131); [B, T, C] layout. In a data-parallel
step (`parallel.dist.activate`) the masked means divide by the global
batch's count: each rank's loss is its share of the global batch's.

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

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ...config import Config
from ...ops.mulaw import is_scalar_input
from ...parallel import dist


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


# ------------------------------------------------------------------ losses


def log_sum_exp(x):
    """Stable log-sum-exp over the last axis (mixture.py:5-10)."""
    m = x.max(-1).values
    return m + torch.log(torch.exp(x - m[..., None]).sum(-1))


def discretized_mix_logistic_loss(y_hat, y, num_classes: int = 65536,
                                  log_scale_min: float = -32.23619130191664,
                                  reduce: bool = True):
    """MoL negative log-likelihood (mixture.py:18-77): y_hat [B, T, 3·nr]
    (logits, means, log scales), y [B, T, 1] in [-1, 1]."""
    nr = y_hat.shape[-1] // 3
    logit_probs = y_hat[..., :nr]
    means = y_hat[..., nr:2 * nr]
    log_scales = torch.clamp(y_hat[..., 2 * nr:3 * nr], min=log_scale_min)
    y = y.expand(*y.shape[:-1], nr)
    centered = y - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + 1.0 / (num_classes - 1))
    min_in = inv_stdv * (centered - 1.0 / (num_classes - 1))
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    log_probs = torch.where(
        y < -0.999, log_cdf_plus,
        torch.where(y > 0.999, log_one_minus_cdf_min,
                    torch.where(cdf_delta > 1e-5,
                                torch.log(torch.clamp(cdf_delta, min=1e-12)),
                                log_pdf_mid
                                - math.log((num_classes - 1) / 2))))
    log_probs = log_probs + torch.log_softmax(logit_probs, -1)
    nll = -log_sum_exp(log_probs)
    return nll.sum() if reduce else nll[..., None]


def gaussian_mle_loss(y_hat, y, log_scale_min_gauss=-16.11809565095832,
                      num_classes: int = 65536, use_cdf: bool = False,
                      reduce: bool = True):
    """Gaussian negative log-likelihood (gaussian.py:5-37): y_hat [B, T, 2]
    (mean, log scale), y [B, T, 1]; with `use_cdf` the mass of the
    quantisation bin."""
    mean = y_hat[..., 0]
    log_scale = torch.clamp(y_hat[..., 1], min=log_scale_min_gauss)
    y = y[..., 0]
    if use_cdf:
        scale = torch.exp(log_scale)
        half_bin = 1.0 / (num_classes - 1)

        def cdf(v):
            return 0.5 * (1.0 + torch.erf((v - mean)
                                          / (scale * math.sqrt(2.0))))
        log_prob = torch.log(torch.clamp(cdf(y + half_bin) - cdf(y - half_bin),
                                         min=1e-12))
    else:
        log_prob = -0.5 * (math.log(2.0 * math.pi) + 2.0 * log_scale
                           + (y - mean) ** 2 * torch.exp(-2.0 * log_scale))
    return -log_prob.sum() if reduce else -log_prob[..., None]


def _length_mask(T: int, lengths, device):
    return (torch.arange(T, device=device)[None, :]
            < torch.as_tensor(lengths, device=device)[:, None]).float()


def masked_cross_entropy_loss(outputs, targets, lengths):
    """Softmax cross entropy of the mulaw-quantize head (modules.py:
    781-798): outputs [B, T, Q] logits, targets [B, T] class ids; the mean
    over the nonzero masked terms."""
    mask = _length_mask(outputs.shape[1], lengths, outputs.device)
    losses = -torch.gather(torch.log_softmax(outputs, -1), -1,
                           targets.long()[..., None])[..., 0]
    masked = losses * mask
    return masked.sum() / torch.clamp(
        dist.global_count((masked != 0).float().sum()), min=1.0)


def masked_distribution_loss(loss_fn, y_hat, y, lengths):
    """Sequence-masked mean of a per-sample NLL (modules.py:800-836);
    loss_fn(y_hat, y) -> [B, T, 1]."""
    per = loss_fn(y_hat, y)
    mask = _length_mask(y.shape[1], lengths, y_hat.device)[..., None]
    mask = mask.expand_as(per)
    return (per * mask).sum() / torch.clamp(dist.global_count(mask.sum()),
                                            min=1.0)
