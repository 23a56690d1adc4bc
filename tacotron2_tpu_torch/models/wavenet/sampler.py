"""Autoregressive WaveNet sampling, eager (PyTorch).

Counterpart of tacotron2_tpu/models/wavenet/sampler.py: `extract_sampler_
params` (:72) flattens the flax WaveNet tree into matmul-ready tensors and
`incremental_sample` (:110) runs the sample loop with one ring buffer of
width (kw-1)·d + 1 per layer. Per sample and layer: the kw=3 dilated conv
over the ring taps, the 1×1 conditioning projection, the tanh·σ gate, the
skip and residual 1×1s with √0.5 scaling; then the ReLU head and the
Gaussian draw (distributions.py:110):

    sample = clip(mean + exp(max(log_s, log_scale_min_gauss)) · z, -1, 1)

fed back as the next input. The standard normals `z [B, T]` come from the
caller, so this loop and the CUDA sampler kernel (its plain version's
contract, `ops/wavenet_kernel.py`) see the same random numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...config import Config
from .modules import conv1x1_params, effective_kernel


class LayerParams(NamedTuple):
    conv_w: torch.Tensor     # [kw·R, G] taps oldest -> newest
    conv_b: torch.Tensor     # [G]
    cin_w: torch.Tensor      # [cin, G]
    cin_b: torch.Tensor      # [G]
    skip_w: torch.Tensor     # [G/2, S]
    skip_b: torch.Tensor     # [S]
    out_w: torch.Tensor      # [G/2, R]
    out_b: torch.Tensor      # [R]


class SamplerParams(NamedTuple):
    first_w: torch.Tensor    # [1, R] (scalar input)
    first_b: torch.Tensor    # [R]
    layers: Tuple[LayerParams, ...]
    final1_w: torch.Tensor   # [S, S]
    final1_b: torch.Tensor   # [S]
    final2_w: torch.Tensor   # [S, out]
    final2_b: torch.Tensor   # [out]


def _check_family(cfg: Config):
    wn = cfg.wavenet
    assert wn.input_type in ("raw", "mulaw") and wn.out_channels == 2, \
        "the port covers the Gaussian head on scalar input"
    assert wn.kernel_size == 3 and wn.gin_channels <= 0 and \
        wn.cin_channels > 0, "kw=3, local conditioning only"


def extract_sampler_params(params, cfg: Config, device="cuda"
                           ) -> SamplerParams:
    """Flax WaveNet param tree (numpy leaves) -> SamplerParams (f32).

    CausalConv1D kernels are [kw, R, G] (tap j multiplies x_{t-(kw-1-j)d}),
    so flattening in j order lists the taps oldest -> newest. Weight norm is
    materialised; missing biases become zeros.
    """
    _check_family(cfg)
    wn = cfg.wavenet
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    zero = lambda n: np.zeros((n,), np.float32)
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
        cin_w, cin_b = conv1x1_params(p["cin_conv"])
        skip_w, skip_b = conv1x1_params(p["skip_conv"])
        out_w, out_b = conv1x1_params(p["out_conv"])
        layers.append(LayerParams(
            t(ck.reshape(kw * R, G)), t(zero(G) if cb is None else cb),
            t(cin_w), t(zero(G) if cin_b is None else cin_b),
            t(skip_w), t(zero(skip_w.shape[1]) if skip_b is None else skip_b),
            t(out_w), t(zero(R) if out_b is None else out_b)))
    (fw, fb), (f1w, f1b), (f2w, f2b) = (
        conv1x1_params(params[k]) for k in (
            "input_convolution", "final_convolution_1",
            "final_convolution_2"))
    opt = lambda b, n: t(zero(n) if b is None else b)
    return SamplerParams(t(fw), opt(fb, fw.shape[1]), tuple(layers),
                         t(f1w), opt(f1b, f1w.shape[1]),
                         t(f2w), opt(f2b, f2w.shape[1]))


def gaussian_sample(y_hat, z, log_scale_min: float):
    """y_hat [B, 2] (mean, log_scale), z [B] -> clipped sample [B]."""
    log_s = torch.clamp(y_hat[:, 1], min=log_scale_min)
    return torch.clamp(y_hat[:, 0] + torch.exp(log_s) * z, -1.0, 1.0)


def incremental_sample(sp: SamplerParams, cfg: Config, c_up, z,
                       initial_input: Optional[torch.Tensor] = None):
    """Generate samples. c_up [B, T, cin] upsampled conditioning, z [B, T]
    standard normals. Returns samples [B, T] f32."""
    _check_family(cfg)
    wn = cfg.wavenet
    B, T, _ = c_up.shape
    R = wn.residual_channels
    dils = wn.dilations
    widths = [(wn.kernel_size - 1) * d + 1 for d in dils]
    scale = float(np.sqrt(np.float32(0.5)))
    dev = c_up.device
    rings = [torch.zeros(B, w, R, device=dev) for w in widths]
    x_in = (torch.zeros(B, 1, device=dev) if initial_input is None
            else initial_input.float())
    c_up, z = c_up.float(), z.float()
    out = torch.empty(B, T, device=dev)
    for t in range(T):
        x = x_in @ sp.first_w + sp.first_b
        skips = None
        for lp, ring, d, w in zip(sp.layers, rings, dils, widths):
            ring[:, t % w] = x
            taps = torch.cat([ring[:, (t - 2 * d) % w], ring[:, (t - d) % w],
                              x], dim=-1)
            g = taps @ lp.conv_w + lp.conv_b + c_up[:, t] @ lp.cin_w + lp.cin_b
            a, b = g.chunk(2, dim=-1)
            h = torch.tanh(a) * torch.sigmoid(b)
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
        sample = gaussian_sample(y_hat, z[:, t], wn.log_scale_min_gauss)
        out[:, t] = sample
        x_in = sample[:, None]
    return out
