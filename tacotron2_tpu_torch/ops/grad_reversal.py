"""Gradient reversal: identity forward, the gradient negated and scaled
backward.

Counterpart of tacotron2_tpu/ops/grad_reversal.py (the reference's
FlipGradientBuilder, tacotron/models/modules.py:668-684): the adversarial
style heads (`adv_emb_disc`) and nat-GAN's emotion and speaker heads see
their input through it, so that what trains them to classify trains the
encoder before them to hide the class.
"""

from __future__ import annotations

import torch


class _FlipGradient(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.scale * g, None


def flip_gradient(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """x, whose gradient comes back as -scale · g."""
    return _FlipGradient.apply(x, scale)
