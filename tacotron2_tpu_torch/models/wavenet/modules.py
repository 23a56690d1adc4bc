"""WaveNet building blocks for synthesis (PyTorch).

Counterparts of tacotron2_tpu/models/wavenet/modules.py: weight norm
(`weight_normed`, :28), the pointwise conv's effective kernel (Conv1x1,
:80) and the SubPixel conditioning upsampler (`SubPixelUpsample` :180,
`UpsampleNetwork` :286). The dilated causal conv, gate and residual/skip
1×1s run inside the sampler (`models/wavenet/sampler.py`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def weight_normed(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """W = g · v / ‖v‖ per output channel (the last axis), in numpy."""
    v = np.asarray(v, np.float32)
    axes = tuple(range(v.ndim - 1))
    norm = np.sqrt(np.sum(v ** 2, axis=axes, keepdims=True) + 1e-12)
    return (v * (np.asarray(g, np.float32) / norm)).astype(np.float32)


def effective_kernel(p) -> np.ndarray:
    """Plain (`kernel`) or weight-normed (`v`, `g`) flax params -> kernel."""
    if "kernel" in p:
        return np.asarray(p["kernel"], np.float32)
    return weight_normed(p["v"], p["g"])


def conv1x1_params(p):
    """Flax Conv1x1 subtree -> (kernel [in, out], bias [out] or None)."""
    if "Dense_0" in p:
        p = p["Dense_0"]
    b = p.get("bias")
    return effective_kernel(p), (None if b is None else
                                 np.asarray(b, np.float32))


class SubPixelUpsample(nn.Module):
    """3×3 SAME conv over the [freq, time] mel image with `scale` output
    channels, then the time-axis periodic shuffle (t, k) -> t·scale + k."""

    def __init__(self, scale: int, freq_kernel: int = 3, time_kernel: int = 3):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(scale, 1, freq_kernel, time_kernel),
            requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(scale), requires_grad=False)
        self.scale = scale

    def forward(self, img):
        # img [B, 1, F, T] -> [B, 1, F, T*scale]
        kf, kt = self.weight.shape[2:]
        y = F.conv2d(F.pad(img, ((kt - 1) // 2, kt // 2,
                                 (kf - 1) // 2, kf // 2)),
                     self.weight, self.bias)            # [B, scale, F, T]
        B, S, Fq, T = y.shape
        return y.permute(0, 2, 3, 1).reshape(B, 1, Fq, T * S)


class UpsampleNetwork(nn.Module):
    """Mel [B, T_mel, M] -> [B, T_mel·prod(scales), M] (SubPixel + ReLU per
    layer; reference wavenet.py:162-205)."""

    def __init__(self, scales: Sequence[int], freq_kernel: int = 3,
                 activation: str = "Relu", leaky_alpha: float = 0.4):
        super().__init__()
        self.layers = nn.ModuleList(SubPixelUpsample(s, freq_kernel)
                                    for s in scales)
        self.activation, self.leaky_alpha = activation, leaky_alpha

    def forward(self, c):
        img = c.float().transpose(1, 2)[:, None]        # [B, 1, M, T]
        for layer in self.layers:
            img = layer(img)
            if self.activation == "Relu":
                img = F.relu(img)
            elif self.activation == "LeakyRelu":
                img = F.leaky_relu(img, self.leaky_alpha)
        return img[:, 0].transpose(1, 2)                 # [B, T_up, M]
