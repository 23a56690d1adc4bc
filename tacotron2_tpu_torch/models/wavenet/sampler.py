"""Autoregressive WaveNet sampling, eager (PyTorch).

Counterpart of tacotron2_tpu/models/wavenet/sampler.py: `extract_sampler_
params` (:72) flattens the flax WaveNet tree into matmul-ready tensors and
`incremental_sample` (:110) runs the sample loop with one ring buffer of
width (kw-1)·d + 1 per layer, at any kernel_size. Per sample and layer:
the dilated conv over the kw ring taps, the 1×1 local conditioning
projection (none without local conditioning) and the global one's where
a speaker vector `g_vec` is given, the tanh·σ gate, the
skip and residual 1×1s with √0.5 scaling; then the ReLU head and a draw
from the config's output head (`distributions.py`): Gaussian, mixture of
logistics, or categorical (mulaw-quantize, whose input is the one-hot of
the previous class and starts at class 127). The random numbers come from
the caller as noise planes [planes, B, T], so this loop and the CUDA
sampler kernel (its plain version's contract, `ops/wavenet_kernel.py`) see
the same ones.

`cache_dtype` / `weight_dtype` = torch.bfloat16 put the rounding where the
TPU kernel puts it (ops/wavenet_kernel.py:248-285): the ring holds x in
the cache dtype; the taps, x, the conditioning c_t and the gate output h
enter the layer products rounded to the weight dtype, against weights
rounded to it, with f32 sums; biases, the residual and skip sums and the
head stay f32 (the categorical first conv gathers a rounded row).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...config import Config
from .distributions import (gaussian_sample, head_kind, inverse_cdf_pick,
                            mol_sample)
from .modules import conv1x1_params, effective_kernel

class LayerParams(NamedTuple):
    conv_w: torch.Tensor     # [kw·R, G] taps oldest -> newest
    conv_b: torch.Tensor     # [G]
    cin_w: Optional[torch.Tensor]   # [cin, G]; None without local cond.
    cin_b: Optional[torch.Tensor]   # [G]
    skip_w: torch.Tensor     # [G/2, S]
    skip_b: torch.Tensor     # [S]
    out_w: torch.Tensor      # [G/2, R]
    out_b: torch.Tensor      # [R]
    gin_w: Optional[torch.Tensor] = None   # [gin, G]; None without global
    gin_b: Optional[torch.Tensor] = None   # [G]


class SamplerParams(NamedTuple):
    first_w: torch.Tensor    # [1, R] scalar input, [Q, R] categorical
    first_b: torch.Tensor    # [R]
    layers: Tuple[LayerParams, ...]
    final1_w: torch.Tensor   # [S, S]
    final1_b: torch.Tensor   # [S]
    final2_w: torch.Tensor   # [S, out]
    final2_b: torch.Tensor   # [out]


def extract_sampler_params(params, cfg: Config, device="cuda"
                           ) -> SamplerParams:
    """Flax WaveNet param tree (numpy leaves) -> SamplerParams (f32).

    CausalConv1D kernels are [kw, R, G] (tap j multiplies x_{t-(kw-1-j)d}),
    so flattening in j order lists the taps oldest -> newest. Weight norm is
    materialised; missing biases become zeros. The first conv is [in, R]:
    [1, R] for scalar input, [Q, R] for the one-hot categorical input. The
    cin_conv and gin_conv weights are None where the tree has no such conv
    (JAX :90-94).
    """
    head_kind(cfg)                       # raises for a config without one
    wn = cfg.wavenet
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    zero = lambda n: np.zeros((n,), np.float32)
    opt = lambda b, n: t(zero(n) if b is None else b)

    def dense(p, name):
        if name not in p:
            return None, None
        w, b = conv1x1_params(p[name])
        return t(w), opt(b, w.shape[1])

    layers = []
    for i in range(wn.layers):
        p = params[f"residual_block_{i}"]
        cc = p["causal_conv"]
        if "Conv_0" in cc:
            ck, cb = np.asarray(cc["Conv_0"]["kernel"]), cc["Conv_0"].get(
                "bias")
        else:
            ck, cb = effective_kernel(cc), cc.get("bias")
        kw, R, G = ck.shape
        cin_w, cin_b = dense(p, "cin_conv")
        gin_w, gin_b = dense(p, "gin_conv")
        skip_w, skip_b = dense(p, "skip_conv")
        out_w, out_b = dense(p, "out_conv")
        layers.append(LayerParams(
            t(ck.reshape(kw * R, G)), opt(cb, G), cin_w, cin_b,
            skip_w, skip_b, out_w, out_b, gin_w, gin_b))
    (fw, fb), (f1w, f1b), (f2w, f2b) = (
        conv1x1_params(params[k]) for k in (
            "input_convolution", "final_convolution_1",
            "final_convolution_2"))
    return SamplerParams(t(fw), opt(fb, fw.shape[1]), tuple(layers),
                         t(f1w), opt(f1b, f1w.shape[1]),
                         t(f2w), opt(f2b, f2w.shape[1]))


def _rounder(dtype):
    """v -> v rounded to `dtype` and back to f32 (identity for f32)."""
    if dtype in (None, torch.float32):
        return lambda v: v
    return lambda v: v.to(dtype).to(torch.float32)


def first_input(cfg: Config, B: int, device) -> torch.Tensor:
    """The first step's input: 0 for scalar input, the one-hot of class 127
    (the mulaw zero point) for the categorical head (sampler.py:134-137)."""
    wn = cfg.wavenet
    if head_kind(cfg)[0] != "categorical":
        return torch.zeros(B, 1, device=device)
    x0 = torch.zeros(B, wn.quantize_channels, device=device)
    if wn.quantize_channels > 127:
        x0[:, 127] = 1.0
    return x0


def incremental_sample(sp: SamplerParams, cfg: Config, c_up, noise,
                       initial_input: Optional[torch.Tensor] = None,
                       test_inputs: Optional[torch.Tensor] = None, *,
                       g_vec: Optional[torch.Tensor] = None,
                       cache_dtype=torch.float32, weight_dtype=torch.float32,
                       return_y_hat: bool = False):
    """Generate samples. c_up [B, T, cin] upsampled conditioning ([B, T,
    0] for a model without local conditioning); noise [planes, B, T] (or
    [B, T] for one plane): standard normals for the Gaussian head, (0, 1)
    uniforms for the mixture (pick, logistic) and categorical (pick)
    heads. g_vec [B, gin]: the global conditioning, where the layers have
    gin weights (JAX :174-178). test_inputs [B, T, in] overrides each
    step's fed-back input (teacher forcing, sampler.py:216-218). Returns
    samples [B, T] f32 (the class index for the categorical head), and
    y_hat [B, T, out] with return_y_hat."""
    wn = cfg.wavenet
    kind, planes = head_kind(cfg)
    B, T, _ = c_up.shape
    if noise.dim() == 2:
        noise = noise[None]
    if tuple(noise.shape) != (planes, B, T):
        raise ValueError(f"the {kind} head takes noise [{planes}, {B}, {T}],"
                         f" got {tuple(noise.shape)}")
    R, kw = wn.residual_channels, wn.kernel_size
    dils = wn.dilations
    widths = [(kw - 1) * d + 1 for d in dils]
    scale = float(np.sqrt(np.float32(0.5)))
    dev = c_up.device
    rw = _rounder(weight_dtype)
    rwo = lambda w: None if w is None else rw(w)
    layers = [lp._replace(conv_w=rw(lp.conv_w), cin_w=rwo(lp.cin_w),
                          gin_w=rwo(lp.gin_w), skip_w=rw(lp.skip_w),
                          out_w=rw(lp.out_w))
              for lp in sp.layers]
    first_w = rw(sp.first_w) if kind == "categorical" else sp.first_w
    rings = [torch.zeros(B, w, R, device=dev, dtype=cache_dtype)
             for w in widths]
    x_in = (first_input(cfg, B, dev) if initial_input is None
            else initial_input.float())
    c_up, noise = c_up.float(), noise.float()
    # the speaker's gate terms are the same at every step
    g_terms = [None if lp.gin_w is None or g_vec is None
               else rw(g_vec.float().to(dev)) @ lp.gin_w + lp.gin_b
               for lp in layers]
    out = torch.empty(B, T, device=dev)
    y_hats = []
    for t in range(T):
        x = x_in @ first_w + sp.first_b
        ct = rw(c_up[:, t])
        skips = None
        for lp, gt, ring, d, w in zip(layers, g_terms, rings, dils, widths):
            ring[:, t % w] = x.to(cache_dtype)
            # tap j reads x_{t-(kw-1-j)d}; the newest is x itself
            taps = torch.cat(
                [rw(ring[:, (t - (kw - 1 - j) * d) % w].float())
                 for j in range(kw - 1)] + [rw(x)], dim=-1)
            g = taps @ lp.conv_w + lp.conv_b
            if lp.cin_w is not None:
                g = g + ct @ lp.cin_w + lp.cin_b
            if gt is not None:
                g = g + gt
            a, b = g.chunk(2, dim=-1)
            h = rw(torch.tanh(a) * torch.sigmoid(b))
            s = h @ lp.skip_w + lp.skip_b
            o = h @ lp.out_w + lp.out_b
            x = (x + o) * scale if wn.residual_legacy else x + o
            if skips is None:
                skips = s
            elif wn.legacy:
                skips = (skips + s) * scale
            else:
                skips = skips + s
        y = torch.relu(skips)
        y = torch.relu(y @ sp.final1_w + sp.final1_b)
        y_hat = y @ sp.final2_w + sp.final2_b
        if return_y_hat:
            y_hats.append(y_hat)
        if kind == "gaussian":
            sample = gaussian_sample(y_hat, noise[0, :, t],
                                     wn.log_scale_min_gauss)
            x_in = sample[:, None]
        elif kind == "mol":
            sample = mol_sample(y_hat, noise[0, :, t], noise[1, :, t],
                                wn.log_scale_min)
            x_in = sample[:, None]
        else:
            idx = inverse_cdf_pick(y_hat, noise[0, :, t])
            sample = idx.to(torch.float32)
            x_in = torch.nn.functional.one_hot(
                idx, wn.quantize_channels).to(torch.float32)
        out[:, t] = sample
        if test_inputs is not None:
            x_in = test_inputs[:, t].float()
    if return_y_hat:
        return out, torch.stack(y_hats, 1)
    return out
