"""The whole WaveNet sample loop as one CUDA kernel, every output head.

Port of tacotron2_tpu/ops/wavenet_kernel.py: `build_sampler_kernel` (:180)
and its HBM-delay variant (:337), which compute the same samples, become
`csrc/sampler.cu`; `fused_incremental_sample` (:678) becomes `sample`.
Gaussian, mixture-of-logistics and categorical heads (`_HeadPlan`, :56),
each with an f32 or bf16 delay cache and f32 or bf16 layer weights
(`cache_dtype` / `weight_dtype`, as the TPU kernel takes them). CUDA
tensors launch the kernel; CPU tensors take its plain version,
`models/wavenet/sampler.py:incremental_sample`. The kernel takes its
weights stacked and split per CTA, which `pack_weights` builds once per set
of weights and dtypes (at load time, not per call). The kernel's design
and bound are in the note at the top of `csrc/sampler.cu`. The TPU
kernel's `sampler_hbm_delay_threshold` and `sampler_window` place its
delay lines in VMEM or HBM without changing the samples; they have no
counterpart here.

The random numbers, noise planes [planes, B, T] (standard normals for the
Gaussian head, (0, 1) uniforms for the others: `distributions.draw_noise`),
are drawn by the caller, so kernel and plain version see the same numbers
(the TPU kernel's in-kernel PRNG bits cannot be matched anyway,
wavenet_kernel.py:107-114).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..models.wavenet.distributions import head_kind
from ..models.wavenet.sampler import SamplerParams, incremental_sample

# kernel launches made by `sample`
launches = 0

_argtypes_set = False
# CTAs per row: `CS` in csrc/sampler.cu (checked at launch)
CLUSTER_SIZE = 8
# the kernel's `Head` codes
HEADS = {"gaussian": 0, "mol": 1, "categorical": 2}
DTYPES = (torch.float32, torch.bfloat16)
# dynamic shared memory a CTA may use on the H100
MAX_SMEM = 232448
_INT_ORDER = ("B", "T", "L", "R", "G", "S", "C", "ring_rows", "legacy",
              "residual_legacy", "head", "n_out", "NO", "first_idx",
              "weight_bf16", "cache_bf16")


def _per_rank(w, cs: int):
    """[..., cs·n] -> [cs, ..., n]: column block c goes to CTA c."""
    w = w.reshape(*w.shape[:-1], cs, w.shape[-1] // cs)
    return w.movedim(-2, 0)


def stack_weights(sp: SamplerParams, cfg: Config, cs: int = 1,
                  weight_dtype=torch.float32):
    """SamplerParams -> the kernel's stacked operands, split over the `cs`
    CTAs of a cluster:
    czw [cs, L, 3R+C, 2·gc]: taps ++ cin rows, the (a | b) gate columns of
      CTA c's gc = G/(2·cs) units; czb [cs, L, 2·gc] = conv_b + cin_b;
    sow [cs, L, G/2, S/cs + R/cs]: CTA c's skip ++ out columns; sob alike;
    and the head with its output columns zero-padded to a multiple of 4.
    czw and sow are in `weight_dtype`, the rest f32."""
    czw = torch.stack([torch.cat([lp.conv_w, lp.cin_w], 0)
                       for lp in sp.layers])
    czb = torch.stack([lp.conv_b + lp.cin_b for lp in sp.layers])
    L, K, G = czw.shape
    czw = _per_rank(czw.reshape(L, K, 2, G // 2), cs).reshape(
        cs, L, K, G // cs).to(weight_dtype).contiguous()
    czb = _per_rank(czb.reshape(L, 2, G // 2), cs).reshape(
        cs, L, G // cs).contiguous()
    sow = torch.cat([_per_rank(torch.stack([lp.skip_w for lp in sp.layers]),
                               cs),
                     _per_rank(torch.stack([lp.out_w for lp in sp.layers]),
                               cs)], -1).to(weight_dtype).contiguous()
    sob = torch.cat([_per_rank(torch.stack([lp.skip_b for lp in sp.layers]),
                               cs),
                     _per_rank(torch.stack([lp.out_b for lp in sp.layers]),
                               cs)], -1).contiguous()
    pad = -sp.final2_w.shape[1] % 4
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
    """The sampler kernel's operands for a cluster of `cs` CTAs, one head
    and one pair of dtypes (built once by `pack_weights`; see
    `stack_weights` for the layout)."""

    czw: torch.Tensor
    czb: torch.Tensor
    sow: torch.Tensor
    sob: torch.Tensor
    f2w: torch.Tensor
    f2b: torch.Tensor
    first_w: torch.Tensor  # [1, R] or [Q, R] (rounded to the weight dtype)
    first_b: torch.Tensor
    final1_w: torch.Tensor
    final1_b: torch.Tensor
    dil: torch.Tensor      # [L] int32 dilations
    offs: torch.Tensor     # [L] int32 ring row offsets
    rows: int              # ring rows per CTA copy
    cs: int
    head: str              # "gaussian", "mol" or "categorical"
    n_out: int             # the head's output channels
    cache_dtype: torch.dtype
    weight_dtype: torch.dtype


def _check_dtypes(cache_dtype, weight_dtype):
    for name, dt in (("cache_dtype", cache_dtype),
                     ("weight_dtype", weight_dtype)):
        if dt not in DTYPES:
            raise ValueError(f"the sampler kernel takes {name} float32 or "
                             f"bfloat16, not {dt}")


def pack_weights(sp: SamplerParams, cfg: Config, cs: int = CLUSTER_SIZE, *,
                 cache_dtype=torch.float32,
                 weight_dtype=torch.float32) -> KernelWeights:
    """SamplerParams -> the kernel's operands for the config's head."""
    _check_dtypes(cache_dtype, weight_dtype)
    kind, _ = head_kind(cfg)
    wn = cfg.wavenet
    n_out = sp.final2_w.shape[1]
    n_in = wn.quantize_channels if kind == "categorical" else 1
    if n_out != wn.out_channels or sp.first_w.shape[0] != n_in:
        raise ValueError(f"sampler weights with {sp.first_w.shape[0]} inputs "
                         f"and {n_out} outputs do not make the config's "
                         f"{kind} head")
    dev = sp.first_w.device
    dil, offs, rows = ring_layout(cfg)
    first_w = sp.first_w
    if kind == "categorical":        # the gathered row enters in that dtype
        first_w = first_w.to(weight_dtype).to(torch.float32)
    c = lambda x: x.contiguous()
    return KernelWeights(
        *stack_weights(sp, cfg, cs, weight_dtype), first_w=c(first_w),
        first_b=c(sp.first_b), final1_w=c(sp.final1_w),
        final1_b=c(sp.final1_b), dil=torch.as_tensor(dil, device=dev),
        offs=torch.as_tensor(offs, device=dev), rows=rows, cs=cs, head=kind,
        n_out=n_out, cache_dtype=cache_dtype, weight_dtype=weight_dtype)


def _dtypes(kernel_weights, cache_dtype, weight_dtype):
    kw = kernel_weights
    f32 = torch.float32
    cd = cache_dtype or (kw.cache_dtype if kw is not None else f32)
    wd = weight_dtype or (kw.weight_dtype if kw is not None else f32)
    _check_dtypes(cd, wd)
    return cd, wd


def sample_plain(sp: SamplerParams, cfg: Config, c_up, noise, *,
                 cache_dtype=torch.float32, weight_dtype=torch.float32):
    """The kernel's plain PyTorch version (same contract as `sample`)."""
    return incremental_sample(sp, cfg, c_up, noise, cache_dtype=cache_dtype,
                              weight_dtype=weight_dtype)


def sample(sp: SamplerParams, cfg: Config, c_up, noise, *,
           kernel_weights: KernelWeights | None = None, cache_dtype=None,
           weight_dtype=None):
    """c_up [B, T, cin] f32, noise [planes, B, T] (or [B, T] for one
    plane; `distributions.draw_noise`) -> samples [B, T] (the class index
    for the categorical head). The dtypes default to those of
    `kernel_weights`, else f32. CPU tensors take the plain version with
    `sp`; CUDA tensors launch the kernel with `kernel_weights`
    (`pack_weights(sp, cfg, ...)` for the same head and dtypes) or raise."""
    cd, wd = _dtypes(kernel_weights, cache_dtype, weight_dtype)
    if c_up.device.type == "cpu":
        return sample_plain(sp, cfg, c_up, noise, cache_dtype=cd,
                            weight_dtype=wd)
    if kernel_weights is None:
        raise ValueError("the sampler kernel takes kernel_weights="
                         "pack_weights(sp, cfg), built once per set of "
                         "weights")
    if (kernel_weights.cache_dtype, kernel_weights.weight_dtype) != (cd, wd):
        raise ValueError(f"kernel_weights are packed for cache "
                         f"{kernel_weights.cache_dtype} and weights "
                         f"{kernel_weights.weight_dtype}, the call asks "
                         f"{cd} / {wd}")
    return _sample_cuda(kernel_weights, cfg, c_up, noise)


def _lib():
    from ..native import build
    global _argtypes_set
    lib = build.load("sampler")
    if not _argtypes_set:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.taco_sampler_launch.argtypes = [vp, ci, vp, ci, ctypes.c_float,
                                            vp]
        lib.taco_sampler_launch.restype = ci
        lib.taco_sampler_smem_bytes.argtypes = [ci] * 6
        lib.taco_sampler_smem_bytes.restype = ctypes.c_size_t
        for fn in ("cluster_size", "n_ptr", "n_int"):
            getattr(lib, f"taco_sampler_{fn}").argtypes = []
            getattr(lib, f"taco_sampler_{fn}").restype = ci
        _argtypes_set = True
    return lib


def _sample_cuda(kw: KernelWeights, cfg: Config, c_up, noise):
    global launches
    wn = cfg.wavenet
    kind, planes = head_kind(cfg)
    B, T, C = c_up.shape
    dev = c_up.device
    R, G, S = wn.residual_channels, wn.gate_channels, wn.skip_out_channels
    L = wn.layers
    if noise.dim() == 2:
        noise = noise[None]
    if c_up.dtype != torch.float32 or noise.shape != (planes, B, T) or \
            noise.device != dev:
        raise ValueError(f"c_up must be f32 [B, T, C] and noise "
                         f"[{planes}, B, T] on its device")
    if kw.czw.device != dev or kw.czw.dtype != kw.weight_dtype:
        raise ValueError(f"sampler weights must be {kw.weight_dtype} on "
                         f"{dev}")
    if kw.head != kind or kw.n_out != wn.out_channels:
        raise ValueError(f"kernel_weights hold a {kw.head} head with "
                         f"{kw.n_out} outputs, the config a {kind} head "
                         f"with {wn.out_channels}")
    if kw.czw.shape[1] != L:
        raise ValueError(f"kernel_weights hold {kw.czw.shape[1]} layers, "
                         f"the config {L}")
    if wn.kernel_size != 3 or wn.gin_channels > 0:
        raise ValueError("the sampler kernel takes kernel_size 3 and no "
                         "global conditioning")
    lib = _lib()
    cs = lib.taco_sampler_cluster_size()
    if kw.cs != cs:
        raise ValueError(f"kernel_weights are laid out for {kw.cs} CTAs, "
                         f"the kernel runs {cs}")
    if C != wn.cin_channels or G % (8 * cs) or S % (4 * cs) or \
            R % (4 * cs) or (S + R) // cs % 4:
        raise ValueError("widths outside the sampler kernel's envelope")
    NO = kw.f2w.shape[1]
    smem = lib.taco_sampler_smem_bytes(L, R, G, S, C, NO)
    if smem > MAX_SMEM:
        raise ValueError(f"the sampler kernel needs {smem} bytes of shared "
                         f"memory a CTA, more than {MAX_SMEM}")
    ring = torch.zeros(B, cs, kw.rows, R, device=dev,
                       dtype=kw.cache_dtype)      # a copy per CTA
    out = torch.empty(B, T, device=dev)
    c_up = c_up.contiguous()
    noise = noise.to(torch.float32).contiguous()
    ints = dict(B=B, T=T, L=L, R=R, G=G, S=S, C=C, ring_rows=kw.rows,
                legacy=int(bool(wn.legacy)),
                residual_legacy=int(bool(wn.residual_legacy)),
                head=HEADS[kind], n_out=kw.n_out, NO=NO,
                # the one-hot start, class 127 (models/wavenet/sampler.py)
                first_idx=127 if wn.quantize_channels > 127 else -1,
                weight_bf16=int(kw.weight_dtype == torch.bfloat16),
                cache_bf16=int(kw.cache_dtype == torch.bfloat16))
    lsm = wn.log_scale_min_gauss if kind == "gaussian" else wn.log_scale_min
    ptrs = [c_up, noise, kw.czw, kw.czb, kw.sow, kw.sob, kw.first_w,
            kw.first_b, kw.final1_w, kw.final1_b, kw.f2w, kw.f2b, kw.dil,
            kw.offs, ring, out]
    assert len(ptrs) == lib.taco_sampler_n_ptr()
    assert len(_INT_ORDER) == lib.taco_sampler_n_int()
    # the operands made here outlive the kernel: see `launch` in
    # ops/tacotron_decoder_kernel.py
    rc = lib.taco_sampler_launch(
        (ctypes.c_void_p * len(ptrs))(*[x.data_ptr() for x in ptrs]),
        len(ptrs),
        (ctypes.c_int * len(_INT_ORDER))(*[ints[k] for k in _INT_ORDER]),
        len(_INT_ORDER), float(lsm),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    from ..native.build import check
    check(rc, "taco_sampler_launch")
    launches += 1
    return out


# ------------------------------------------------ checks against the plain


def teacher_forced_replay(sp: SamplerParams, cfg: Config, c_up, noise,
                          samples, *, cache_dtype=torch.float32,
                          weight_dtype=torch.float32):
    """Replay a run's own trajectory `samples` [B, T] through the plain
    version (tests/test_pallas_kernels.py:142's oracle): each step's input
    is the run's previous sample (its one-hot for the categorical head), so
    the plain version sees what the run saw. Returns (the plain version's
    draws [B, T], its y_hat [B, T, out])."""
    wn = cfg.wavenet
    if head_kind(cfg)[0] == "categorical":
        tf = torch.nn.functional.one_hot(samples.long(),
                                         wn.quantize_channels).float()
    else:
        tf = samples.float()[..., None]
    return incremental_sample(sp, cfg, c_up, noise, test_inputs=tf,
                              cache_dtype=cache_dtype,
                              weight_dtype=weight_dtype, return_y_hat=True)


def pick_ties(logits, u, rel: float = 1e-5):
    """[..., n] logits and [...] uniforms -> bool [...]: u·total lies within
    `rel`·total of a boundary of the cumulative softmax mass, where sums in
    another order may fairly pick the neighbouring class."""
    e = torch.exp(logits - logits.max(-1, keepdim=True).values)
    cum = torch.cumsum(e, -1)
    tot = cum[..., -1]
    return (cum - (u * tot)[..., None]).abs().min(-1).values <= rel * tot

