"""The whole WaveNet sample loop as one CUDA kernel (Gaussian head).

Port of tacotron2_tpu/ops/wavenet_kernel.py: `build_sampler_kernel` (:180)
and its HBM-delay variant (:337), which compute the same samples, become
`csrc/sampler.cu`; `fused_incremental_sample` (:678) becomes `sample`.
CUDA tensors launch the kernel; CPU tensors take its plain version,
`models/wavenet/sampler.py:incremental_sample`. The kernel takes its
weights stacked and split per CTA, which `pack_weights` builds once per set
of weights (at load time, not per call). The kernel's design and bound are
in the note at the top of `csrc/sampler.cu`.

The standard normals `z [B, T]` are drawn by the caller, so kernel and
plain version see the same numbers (the TPU kernel's in-kernel PRNG bits
cannot be matched anyway, wavenet_kernel.py:107-114). The MoL and
categorical heads are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..models.wavenet.sampler import SamplerParams, incremental_sample

# kernel launches made by `sample`
launches = 0

_argtypes_set = False
# CTAs per row: `CS` in csrc/sampler.cu (checked at launch)
CLUSTER_SIZE = 8


def _per_rank(w, cs: int):
    """[..., cs·n] -> [cs, ..., n]: column block c goes to CTA c."""
    w = w.reshape(*w.shape[:-1], cs, w.shape[-1] // cs)
    return w.movedim(-2, 0)


def stack_weights(sp: SamplerParams, cfg: Config, cs: int = 1):
    """SamplerParams -> the kernel's stacked operands, split over the `cs`
    CTAs of a cluster:
    czw [cs, L, 3R+C, 2·gc]: taps ++ cin rows, the (a | b) gate columns of
      CTA c's gc = G/(2·cs) units; czb [cs, L, 2·gc] = conv_b + cin_b;
    sow [cs, L, G/2, S/cs + R/cs]: CTA c's skip ++ out columns; sob alike;
    and the head with its 2 output columns padded to 4."""
    czw = torch.stack([torch.cat([lp.conv_w, lp.cin_w], 0)
                       for lp in sp.layers])
    czb = torch.stack([lp.conv_b + lp.cin_b for lp in sp.layers])
    L, K, G = czw.shape
    czw = _per_rank(czw.reshape(L, K, 2, G // 2), cs).reshape(
        cs, L, K, G // cs).contiguous()
    czb = _per_rank(czb.reshape(L, 2, G // 2), cs).reshape(
        cs, L, G // cs).contiguous()
    sow = torch.cat([_per_rank(torch.stack([lp.skip_w for lp in sp.layers]),
                               cs),
                     _per_rank(torch.stack([lp.out_w for lp in sp.layers]),
                               cs)], -1).contiguous()
    sob = torch.cat([_per_rank(torch.stack([lp.skip_b for lp in sp.layers]),
                               cs),
                     _per_rank(torch.stack([lp.out_b for lp in sp.layers]),
                               cs)], -1).contiguous()
    pad = 4 - sp.final2_w.shape[1]
    f2w = torch.nn.functional.pad(sp.final2_w, (0, pad)).contiguous()
    f2b = torch.nn.functional.pad(sp.final2_b, (0, pad)).contiguous()
    return czw, czb, sow, sob, f2w, f2b


def ring_layout(cfg: Config):
    """Per-layer dilations and ring row offsets (2d+1 rows per layer)."""
    dil = np.asarray(cfg.wavenet.dilations, np.int32)
    widths = (cfg.wavenet.kernel_size - 1) * dil + 1
    offs = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int32)
    return dil, offs, int(widths.sum())


class KernelWeights(NamedTuple):
    """The sampler kernel's operands for a cluster of `cs` CTAs (built once
    by `pack_weights`; see `stack_weights` for the layout)."""

    czw: torch.Tensor
    czb: torch.Tensor
    sow: torch.Tensor
    sob: torch.Tensor
    f2w: torch.Tensor
    f2b: torch.Tensor
    first_w: torch.Tensor
    first_b: torch.Tensor
    final1_w: torch.Tensor
    final1_b: torch.Tensor
    dil: torch.Tensor      # [L] int32 dilations
    offs: torch.Tensor     # [L] int32 ring row offsets
    rows: int              # ring rows per CTA copy
    cs: int


def pack_weights(sp: SamplerParams, cfg: Config,
                 cs: int = CLUSTER_SIZE) -> KernelWeights:
    """SamplerParams -> the kernel's operands (Gaussian head only)."""
    if sp.final2_w.shape[1] != 2:
        raise ValueError("the sampler kernel implements the Gaussian head")
    dev = sp.first_w.device
    dil, offs, rows = ring_layout(cfg)
    c = lambda x: x.contiguous()
    return KernelWeights(
        *stack_weights(sp, cfg, cs), first_w=c(sp.first_w),
        first_b=c(sp.first_b), final1_w=c(sp.final1_w),
        final1_b=c(sp.final1_b), dil=torch.as_tensor(dil, device=dev),
        offs=torch.as_tensor(offs, device=dev), rows=rows, cs=cs)


def sample_plain(sp: SamplerParams, cfg: Config, c_up, z):
    """The kernel's plain PyTorch version (same contract as `sample`)."""
    return incremental_sample(sp, cfg, c_up, z)


def sample(sp: SamplerParams, cfg: Config, c_up, z, *,
           kernel_weights: KernelWeights | None = None):
    """c_up [B, T, cin] f32, z [B, T] standard normals -> samples [B, T].
    CPU tensors take the plain version with `sp`; CUDA tensors launch the
    kernel with `kernel_weights` (`pack_weights(sp, cfg)`) or raise."""
    if c_up.device.type == "cpu":
        return sample_plain(sp, cfg, c_up, z)
    if kernel_weights is None:
        raise ValueError("the sampler kernel takes kernel_weights="
                         "pack_weights(sp, cfg), built once per set of "
                         "weights")
    return _sample_cuda(kernel_weights, cfg, c_up, z)


def _lib():
    from ..native import build
    global _argtypes_set
    lib = build.load("sampler")
    if not _argtypes_set:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.taco_sampler_launch.argtypes = [vp] * 16 + [ci] * 10 + \
            [ctypes.c_float, vp]
        lib.taco_sampler_launch.restype = ci
        lib.taco_sampler_cluster_size.argtypes = []
        lib.taco_sampler_cluster_size.restype = ci
        _argtypes_set = True
    return lib


def _sample_cuda(kw: KernelWeights, cfg: Config, c_up, z):
    global launches
    wn = cfg.wavenet
    B, T, C = c_up.shape
    dev = c_up.device
    R, G, S = wn.residual_channels, wn.gate_channels, wn.skip_out_channels
    L = wn.layers
    if c_up.dtype != torch.float32 or z.shape != (B, T) or z.device != dev:
        raise ValueError("c_up must be f32 [B, T, C] and z [B, T] on its "
                         "device")
    if kw.czw.device != dev or kw.czw.dtype != torch.float32:
        raise ValueError(f"sampler weights must be f32 on {dev}")
    if kw.czw.shape[1] != L:
        raise ValueError(f"kernel_weights hold {kw.czw.shape[1]} layers, "
                         f"the config {L}")
    lib = _lib()
    cs = lib.taco_sampler_cluster_size()
    if kw.cs != cs:
        raise ValueError(f"kernel_weights are laid out for {kw.cs} CTAs, "
                         f"the kernel runs {cs}")
    if C != wn.cin_channels or G % (8 * cs) or S % (4 * cs) or \
            R % (4 * cs) or (S + R) // cs % 4:
        raise ValueError("widths outside the sampler kernel's envelope")
    ring = torch.zeros(B, cs, kw.rows, R, device=dev)   # a copy per CTA
    out = torch.empty(B, T, device=dev)
    c_up = c_up.contiguous()
    z = z.to(torch.float32).contiguous()
    # the operands made here outlive the kernel: see _decode_cuda in
    # ops/tacotron_decoder_kernel.py
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    rc = lib.taco_sampler_launch(
        ptr(c_up), ptr(z), ptr(kw.czw), ptr(kw.czb), ptr(kw.sow),
        ptr(kw.sob), ptr(kw.first_w), ptr(kw.first_b), ptr(kw.final1_w),
        ptr(kw.final1_b), ptr(kw.f2w), ptr(kw.f2b), ptr(kw.dil),
        ptr(kw.offs), ptr(ring), ptr(out),
        B, T, L, R, G, S, C, kw.rows, int(bool(wn.legacy)),
        int(bool(wn.residual_legacy)), float(wn.log_scale_min_gauss),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    from ..native.build import check
    check(rc, "taco_sampler_launch")
    launches += 1
    return out
