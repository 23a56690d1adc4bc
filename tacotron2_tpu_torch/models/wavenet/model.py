"""WaveNet vocoder (PyTorch): conditioning upsample and the teacher-forced
eval forward.

Counterpart of tacotron2_tpu/models/wavenet/model.py: `WaveNet.upsample`
(:85), `body` (:166) and `__call__` (:205) with train=False — first 1×1
conv, L gated residual blocks (dilated causal conv, 1×1 conditioning, tanh·σ
gate, skip and residual 1×1s with √0.5 scalings), skip sum, and the f32
relu/1×1/relu/1×1 head. The JAX package runs this forward without a Pallas
kernel (its fused stack is training-only, model.py:102-118), so it is
plain PyTorch here, in f32. `wavenet.compute_dtype="bfloat16"` (the
training stack's mixed precision) is not applied: where bf16 rounds
inside flax's stack depends on XLA's fusions, so no op-by-op bf16 stack
reproduces it; tests/test_torch_wavenet.py holds the f32 forward within
bf16's error of flax's bf16 output. The autoregressive sample loop is
`models/wavenet/sampler.py` (plain) / the CUDA sampler kernel.
Weights come from `convert.py`. On a CUDA device the convolutions run with
cuDNN's TF32 off (`_f32_convs`), so f32 means f32 as in the JAX package.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...config import Config
from ...ops.mulaw import is_scalar_input
from .modules import UpsampleNetwork


def _p(*shape):
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


@contextlib.contextmanager
def _f32_convs():
    """cuDNN's TF32 off for the block, restored after (CPU tensors do not
    read it)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class ResidualBlock(nn.Module):
    """Weights of one gated residual block (flax ResidualConv1DGLU)."""

    def __init__(self, R: int, G: int, S: int, C: int, kw: int, dilation: int):
        super().__init__()
        self.dilation, self.kw = dilation, kw
        self.conv_w, self.conv_b = _p(G, R, kw), _p(G)   # torch conv layout
        self.cin_w, self.cin_b = _p(C, G), _p(G)
        self.skip_w, self.skip_b = _p(G // 2, S), _p(S)
        self.out_w, self.out_b = _p(G // 2, R), _p(R)


class WaveNet(nn.Module):
    """Upsample network and conv stack; weights come from `convert.py`."""

    def __init__(self, cfg: Config):
        super().__init__()
        wn = cfg.wavenet
        assert wn.cin_channels > 0 and wn.upsample_type == "SubPixel", \
            "the port covers the SubPixel-conditioned vocoder"
        assert wn.gin_channels <= 0, "global conditioning is not ported"
        self.cfg = cfg
        self.upsample_network = UpsampleNetwork(
            tuple(wn.upsample_scales), wn.freq_axis_kernel_size,
            wn.upsample_activation, wn.leaky_alpha)
        R, G, S = wn.residual_channels, wn.gate_channels, wn.skip_out_channels
        n_in = 1 if is_scalar_input(wn.input_type) else wn.quantize_channels
        self.first_w, self.first_b = _p(n_in, R), _p(R)
        self.blocks = nn.ModuleList(
            ResidualBlock(R, G, S, wn.cin_channels, wn.kernel_size, d)
            for d in wn.dilations)
        self.final1_w, self.final1_b = _p(S, S), _p(S)
        self.final2_w, self.final2_b = _p(S, wn.out_channels), \
            _p(wn.out_channels)

    @torch.no_grad()
    def upsample(self, c):
        """Mel [B, T_mel, M] -> sample-rate features [B, T_mel·hop, M]."""
        with _f32_convs():
            return self.upsample_network(c)

    @torch.no_grad()
    def body(self, x, c_up):
        """Teacher-forced conv stack: x [B, T, in], c_up [B, T, cin] ->
        y_hat [B, T, out_channels] f32."""
        wn = self.cfg.wavenet
        half = float(np.sqrt(np.float32(0.5)))
        x = x @ self.first_w + self.first_b
        skips = None
        for blk in self.blocks:
            residual = x
            pad = (blk.kw - 1) * blk.dilation
            with _f32_convs():
                y = F.conv1d(F.pad(x.transpose(1, 2), (pad, 0)), blk.conv_w,
                             blk.conv_b, dilation=blk.dilation).transpose(1, 2)
            a, b = y.chunk(2, -1)
            ca, cb = (c_up @ blk.cin_w + blk.cin_b).chunk(2, -1)
            h = torch.tanh(a + ca) * torch.sigmoid(b + cb)
            s = h @ blk.skip_w + blk.skip_b
            o = h @ blk.out_w + blk.out_b
            x = (o + residual) * half if wn.residual_legacy else o + residual
            if skips is None:
                skips = s
            else:
                skips = skips + s
                if wn.legacy:
                    skips = skips * half
        y = torch.relu(skips)
        y = torch.relu(y @ self.final1_w + self.final1_b)
        return y @ self.final2_w + self.final2_b

    @torch.no_grad()
    def forward(self, x, c):
        """Teacher-forced forward (train=False): x [B, T, 1] waveform or
        [B, T, Q] one-hot, c [B, T_mel, cin] mels -> (y_hat [B, T, out],
        c_up [B, T, cin])."""
        c_up = self.upsample(c)
        if c_up.shape[1] != x.shape[1]:
            raise ValueError(f"upsampled conditioning {tuple(c_up.shape)} "
                             f"does not match the input {tuple(x.shape)}")
        return self.body(x.float(), c_up), c_up
