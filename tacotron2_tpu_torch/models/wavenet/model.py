"""WaveNet vocoder (PyTorch): conditioning upsample, the teacher-forced
forward for synthesis and for training, the loss and the data-dependent
init.

Counterpart of tacotron2_tpu/models/wavenet/model.py: `WaveNet.upsample`
(:85), `body` (:166) in both modes, `__call__` (:205), the fused-stack
gate `_use_fused_stack` (:102-118) and `_fused_stack` (:120-164) on one
device, `compute_wavenet_loss` (:222) and `data_dependent_init` (:250).
Parameters keep flax's names and layouts (`modules.py`); `convert.py`
bridges them.

Two forwards:

- `forward(x, c, g)`: the teacher-forced eval forward that synthesis uses
  (`WaveNetSynthesizer.synthesize_debug`), without gradients and in f32
  whatever `wavenet.compute_dtype` says: where bf16 rounds inside flax's
  stack depends on XLA's fusions, so no op-by-op bf16 stack reproduces
  it; tests/test_torch_wavenet.py holds it within bf16's error of flax's
  bf16 output.
- `train_forward(x, c, g, train=..., seed=...)`: what `WaveNetTrainer`
  runs, with gradients and the compute dtype. In bf16 the input and the
  conditioning are rounded, the first 1×1 conv computes in bf16, and then
  either the fused stack takes them as f32 (model.py:136, :173-179) or
  the layer loop computes each op in bf16 as flax's modules do; the skip
  sum goes to f32 for the head, which stays f32 (:198-201). Dropout (train
  mode) draws its keep mask from `seed` through the stack kernel's hash
  (`ops/wavenet_train_kernel.keep_bits`) on both routes, so the fused
  stack and the layer loop drop the same elements.

The fused stack runs when the JAX gate is open: training,
`use_fused_train_stack`, local conditioning and no speaker input
(:111-113), a supported config, and, for "the backend is a TPU", tensors
on a CUDA device. There it launches kernels 5a and 5b in the compute
dtype: bf16 weights, or at the default f32 compute (the `paper` preset's
too) f32 weights, with bf16 saved activations either way, as the JAX
model calls `fused_stack_apply` (model.py:164), at any width
`stack_supported` admits and after any upsample type; the multi-device
branch is not ported. The globally conditioned, the unconditioned and the
kernel_size != 3 models take the layer loop, as in JAX. On a CUDA device
the convolutions run with cuDNN's TF32 off (`_f32_convs`), so f32 means
f32 as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ...config import Config
from ...ops import wavenet_train_kernel as wtk
from ...ops.mulaw import is_mulaw_quantize, is_scalar_input
from . import distributions as D
from .modules import (Conv1x1, ResidualConv1DGLU, UpsampleNetwork,
                      _WeightNormed, no_round, rounding)


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


class WaveNet(nn.Module):
    """Upsample network, first 1×1 conv, the gated residual blocks and the
    relu/1×1/relu/1×1 head, with flax's module names.

    As in the JAX model (:69-81), the upsample network exists when
    cin_channels > 0, each block's `gin_conv` when gin_channels > 0, and
    the speaker table `gc_embedding` [n_speakers, gin_channels] when
    `use_speaker_embedding` too. flax makes the last two only where the
    init's batch carries `g`: `global_conditioning=False` builds the model
    such an init makes without it (no speaker input at all)."""

    def __init__(self, cfg: Config, global_conditioning: bool = True):
        super().__init__()
        wn = cfg.wavenet
        self.cfg = cfg
        wnorm = wn.weight_normalization
        R, G, S = wn.residual_channels, wn.gate_channels, wn.skip_out_channels
        gin = wn.gin_channels if global_conditioning else -1
        n_in = 1 if is_scalar_input(wn.input_type) else wn.quantize_channels
        self.upsample_network = (UpsampleNetwork(
            wn.upsample_type, tuple(wn.upsample_scales),
            wn.freq_axis_kernel_size, wn.cin_channels,
            wn.upsample_activation, wn.leaky_alpha)
            if wn.cin_channels > 0 else None)
        self.gc_embedding = (
            nn.Parameter(torch.zeros(wn.n_speakers, gin))
            if gin > 0 and wn.use_speaker_embedding else None)
        self.input_convolution = Conv1x1(n_in, R, True, wnorm)
        self.residual_blocks = nn.ModuleList(
            ResidualConv1DGLU(R, G, wn.kernel_size, S, d, wn.cin_channels,
                              wn.use_bias, wn.residual_legacy, wnorm, gin)
            for d in wn.dilations)
        self.final_convolution_1 = Conv1x1(S, S, True, wnorm)
        self.final_convolution_2 = Conv1x1(S, wn.out_channels, True, wnorm)

    @property
    def global_conditioning(self) -> bool:
        return self.residual_blocks[0].gin_conv is not None

    def upsample(self, c):
        """Mel [B, T_mel, M] -> sample-rate features [B, T_mel·hop, M]. A
        model without local conditioning has no upsample network: the JAX
        model fails there with an AttributeError, the port with this
        ValueError."""
        if self.upsample_network is None:
            raise ValueError(
                "wavenet.cin_channels="
                f"{self.cfg.wavenet.cin_channels}: an unconditioned WaveNet "
                "has no upsample network, so it cannot vocode mels")
        with _f32_convs():
            return self.upsample_network(c)

    def embed_global(self, g):
        """Speaker ids [B] -> the table's rows [B, gin], or the raw [B, gin]
        features where there is no table (JAX :89-96); None without
        global conditioning."""
        if g is None or not self.global_conditioning:
            return None
        g = torch.as_tensor(g, device=self.input_convolution.bias.device)
        if self.gc_embedding is not None:
            return self.gc_embedding[g.reshape(-1).long()]
        return g.float()

    # ------------------------------------------------------------- helpers

    def use_fused_stack(self, train: bool, x, c, g) -> bool:
        """The JAX gate (model.py:102-118) on one device: training,
        `use_fused_train_stack`, local conditioning and no global one, a
        supported config, a CUDA tensor."""
        wn = self.cfg.wavenet
        return bool(train and wn.use_fused_train_stack and c is not None
                    and g is None and wtk.stack_supported(self.cfg)
                    and x.is_cuda)

    def _layer_loop(self, x, c, g, rnd, seed: Optional[int]):
        wn = self.cfg.wavenet
        B, T, R = x.shape
        keep = 1.0 - wn.dropout
        half = rnd(torch.tensor(np.sqrt(0.5), dtype=torch.float32,
                                device=x.device))
        res_rnd = rnd
        skips = None
        for l, blk in enumerate(self.residual_blocks):
            kept = None
            if seed is not None and wn.dropout > 0:
                kept = wtk.keep_bits(wtk.layer_key(seed, l), 0, T * B, R,
                                     keep, x.device)
                kept = kept.reshape(T, B, R).transpose(0, 1)
            x, h = blk(x, c, g, kept=kept, keep=keep, rnd=rnd,
                       res_rnd=res_rnd)
            if wn.residual_legacy:
                res_rnd = no_round      # the block output is f32 from here
            if skips is None:
                skips = h
            else:
                skips = rnd(skips + h)
                if wn.legacy:
                    skips = rnd(skips * half)
        return skips

    def _body(self, x, c, g_vec, *, rnd, train: bool, seed: Optional[int]):
        x = rnd(x.float())
        c = None if c is None else rnd(c.float())
        g = None
        if g_vec is not None:
            g = rnd(g_vec.float()[:, None, :].expand(
                x.shape[0], x.shape[1], g_vec.shape[-1]))
        x = self.input_convolution(x, rnd)
        if self.use_fused_stack(train, x, c, g):
            sp = wtk.extract_stack_params(self.residual_blocks, self.cfg)
            skips = wtk.fused_stack_apply(self.cfg, sp, x, c, seed)
        else:
            skips = self._layer_loop(x, c, g, rnd, seed if train else None)
        y = torch.relu(skips.float())
        y = torch.relu(self.final_convolution_1(y))
        return self.final_convolution_2(y)

    def body(self, x, c_up, g_vec=None, *, train: bool = False,
             seed: Optional[int] = None):
        """Conv stack: x [B, T, in], c_up [B, T, cin] or None, g_vec [B,
        gin] or None -> y_hat [B, T, out_channels] f32, in the compute
        dtype; `seed` draws the dropout masks in train mode."""
        if train and seed is None:
            raise ValueError("train mode draws its dropout from a seed")
        with _f32_convs():
            return self._body(x, c_up, g_vec, rnd=rounding(
                self.cfg.wavenet.compute_dtype), train=train, seed=seed)

    def _upsampled(self, x, c):
        """The upsampled conditioning, or None where the JAX model takes
        none (no mels given, or cin_channels <= 0: :155-159)."""
        if c is None or self.upsample_network is None:
            return None
        c_up = self.upsample(c)
        if c_up.shape[1] != x.shape[1]:
            raise ValueError(f"upsampled conditioning {tuple(c_up.shape)} "
                             f"does not match the input {tuple(x.shape)}")
        return c_up

    def train_forward(self, x, c, g=None, *, train: bool,
                      seed: Optional[int] = None):
        """The training forward (model.__call__): x [B, T, 1] waveform or
        [B, T, Q] one-hot, c [B, T_mel, cin] mels, g [B] speaker ids or
        [B, gin] features -> (y_hat, c_up)."""
        c_up = self._upsampled(x, c)
        return self.body(x, c_up, self.embed_global(g), train=train,
                         seed=seed), c_up

    @torch.no_grad()
    def forward(self, x, c, g=None):
        """Teacher-forced eval forward for synthesis, in f32: x [B, T, 1]
        or [B, T, Q], c [B, T_mel, cin], g as `train_forward`'s -> (y_hat
        [B, T, out], c_up)."""
        c_up = self._upsampled(x, c)
        with _f32_convs():
            y = self._body(x, c_up, self.embed_global(g), rnd=no_round,
                           train=False, seed=None)
        return y, c_up


def compute_wavenet_loss(y_hat, y_target, lengths,
                         cfg: Config) -> Dict[str, torch.Tensor]:
    """Next-sample loss (wavenet.py:476-519): y_hat[:, :-1] against
    y[:, 1:], masked by lengths - 1; f32."""
    wn = cfg.wavenet
    y_hat = y_hat[:, :-1].float()
    lengths = torch.as_tensor(lengths, device=y_hat.device) - 1
    if is_mulaw_quantize(wn.input_type):
        loss = D.masked_cross_entropy_loss(y_hat, y_target[:, 1:].long(),
                                           lengths)
        return {"loss": loss}
    y = y_target[:, 1:].float()
    if y.dim() == 2:
        y = y[..., None]
    if wn.out_channels == 2:
        def fn(yh, yy):
            return D.gaussian_mle_loss(
                yh, yy, log_scale_min_gauss=wn.log_scale_min_gauss,
                num_classes=wn.quantize_channels, use_cdf=wn.cdf_loss,
                reduce=False)
    else:
        def fn(yh, yy):
            return D.discretized_mix_logistic_loss(
                yh, yy, num_classes=wn.quantize_channels,
                log_scale_min=wn.log_scale_min, reduce=False)
    return {"loss": D.masked_distribution_loss(fn, y_hat, y, lengths)}


@torch.no_grad()
def data_dependent_init(model: WaveNet, x, c, g=None, *,
                        init_scale: float = 1.0) -> WaveNet:
    """Salimans-Kingma data-dependent init of the weight-normed convs, in
    place (reference WeightNorm._data_dep_init, modules.py:110-126): for
    each one IN EXECUTION ORDER, the per-channel mean m and variance v of
    its output on this batch (eval mode), then g <- g · init_scale /
    sqrt(v + 1e-10) and bias <- -m · that scale. Sequential, one forward a
    conv, so each sees the ones before it initialised."""
    convs = [m for m in model.modules()
             if isinstance(m, _WeightNormed) and m.is_weight_normed]

    def run(targets):
        for m in convs:
            m.capture = m in targets
        model.train_forward(x, c, g, train=False)

    run(convs)
    for target in sorted(convs, key=lambda m: m.call_seq):
        run([target])
        out = target.wn_out.float()
        flat = out.reshape(-1, out.shape[-1])
        mean = flat.mean(0)
        var = flat.var(0, unbiased=False)
        scale = init_scale / torch.sqrt(var + 1e-10)
        target.g.mul_(scale)
        if target.bias is not None:
            target.bias.copy_(-mean * scale)
    for m in convs:
        m.capture, m.wn_out = False, None
    return model
