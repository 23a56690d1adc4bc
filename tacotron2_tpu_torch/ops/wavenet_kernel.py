"""The whole WaveNet sample loop as one CUDA kernel, every output head.

Port of tacotron2_tpu/ops/wavenet_kernel.py: `build_sampler_kernel` (:180)
and its HBM-delay variant (:337), which compute the same samples, become
`csrc/sampler.cu`; `fused_incremental_sample` (:678) becomes `sample`,
`sharded_incremental_sample` (:629) `sharded_sample` (rows over a
data-parallel group).
Gaussian, mixture-of-logistics and categorical heads (`_HeadPlan`, :56),
each with an f32 or bf16 delay cache and f32 or bf16 layer weights
(`cache_dtype` / `weight_dtype`, as the TPU kernel takes them). CUDA
tensors launch the kernel; CPU tensors take its plain version,
`models/wavenet/sampler.py:incremental_sample`. One cluster of the kernel
runs 8 rows of the batch (`row_plan`). It takes each CTA's columns of each
layer as one slice of mma A-fragment tiles and biases (`stack_weights`,
`slice_layout`), which `pack_weights` builds once per set of weights and
dtypes (at load time, not per call). The kernel's design and bound are in
the note at the top of `csrc/sampler.cu`. The TPU
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
# CTAs a cluster by weight dtype and batch rows a cluster: `CS`, `CS_F32`
# and `RB` in csrc/sampler.cu (checked at launch)
CLUSTER_SIZES = {torch.bfloat16: 8, torch.float32: 16}
ROWS_PER_CLUSTER = 8
# the kernel's `Head` codes
HEADS = {"gaussian": 0, "mol": 1, "categorical": 2}
DTYPES = (torch.float32, torch.bfloat16)
_INT_ORDER = ("B", "T", "L", "R", "G", "S", "C", "ring_rows", "legacy",
              "residual_legacy", "head", "n_out", "NO", "first_idx",
              "weight_bf16", "cache_bf16", "slice_bytes")
# bytes of one A-fragment tile: 32 lanes x 16 bytes
TILE = 512


class RowPlan(NamedTuple):
    clusters: int    # ceil(B / ROWS_PER_CLUSTER)
    rows: int        # clusters · ROWS_PER_CLUSTER: the ring's rows
    padded: int      # rows that run on zero inputs and are never written


def row_plan(B: int) -> RowPlan:
    """Batch row b runs as row b % 8 of cluster b // 8; the last cluster's
    missing rows take zero conditioning and noise."""
    clusters = -(-B // ROWS_PER_CLUSTER)
    rows = clusters * ROWS_PER_CLUSTER
    return RowPlan(clusters, rows, rows - B)


class SliceLayout(NamedTuple):
    """A CTA's share of a layer: gc gate units, sc skip and rc residual
    columns; c16 the conditioning width padded to 16; ks the depth of one
    mma step (16 for bf16 weights, 8 for f32 as TF32); the m-tiles of the
    gate products (mtg, 8 units each: their a columns in rows 0-7, b in
    8-15) and their k-tiles over the x_t rows (ktx, depth R) and over the
    x_{t-2d}, x_{t-d} and c_t rows (kto, depth 2R + c16); the skip|out
    product's (mts, kts)."""

    gc: int
    sc: int
    rc: int
    c16: int
    ks: int
    mtg: int
    ktx: int
    kto: int
    mts: int
    kts: int

    @property
    def tiles_x(self) -> int:
        return TILE * self.mtg * self.ktx

    @property
    def tiles_o(self) -> int:
        return TILE * self.mtg * self.kto

    @property
    def tiles_s(self) -> int:
        return TILE * self.mts * self.kts

    @property
    def bytes(self) -> int:
        return (self.tiles_x + self.tiles_o + self.tiles_s
                + 64 * (self.mtg + self.mts))


def cluster_size(weight_dtype) -> int:
    return CLUSTER_SIZES[weight_dtype]


def slice_layout(cfg: Config, cs: int | None = None,
                 weight_dtype=torch.float32) -> SliceLayout:
    cs = cs or cluster_size(weight_dtype)
    wn = cfg.wavenet
    R, G, S, C = (wn.residual_channels, wn.gate_channels,
                  wn.skip_out_channels, wn.cin_channels)
    # what the packing itself needs (whole k-tiles, an even split over the
    # CTAs); the kernel's envelope is `taco_sampler_supported`
    if R % 16 or (G // 2) % 16 or G % (2 * cs) or S % cs or R % cs:
        raise ValueError(f"the sampler kernel's tiles do not divide R {R}, "
                         f"G {G}, S {S} over {cs} CTAs")
    gc, sc, rc = G // 2 // cs, S // cs, R // cs
    c16 = -(-C // 16) * 16
    ks = 16 if weight_dtype == torch.bfloat16 else 8
    return SliceLayout(gc, sc, rc, c16, ks, -(-gc // 8), R // ks,
                       (2 * R + c16) // ks, -(-(sc + rc) // 16), G // 2 // ks)


def frag_index(ks: int) -> np.ndarray:
    """[32, 16·ks/32]: the flat index m·ks + k of each value that lane (g,
    t) = (lane // 4, lane % 4) holds of a 16 × ks A operand of mma.sync
    m16n8k{ks}, in register order (bf16 pairs for ks 16, TF32 for 8)."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    if ks == 16:
        mk = [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1),
              (g, 2 * t + 8), (g, 2 * t + 9), (g + 8, 2 * t + 8),
              (g + 8, 2 * t + 9)]
    else:
        mk = [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]
    return np.stack([m * ks + k for m, k in mk], 1)


def _tiles(w, ks: int) -> torch.Tensor:
    """w [..., 16·MT, ks·KT] -> bytes [..., MT·KT·512]: tiles (mt, kt) in
    that order, each its 32 lanes' fragments."""
    *lead, mp, kp = w.shape
    mt, kt = mp // 16, kp // ks
    x = w.reshape(*lead, mt, 16, kt, ks).movedim(-3, -2).reshape(
        *lead, mt, kt, 16 * ks)
    x = x[..., torch.as_tensor(frag_index(ks).reshape(-1))]
    return x.contiguous().view(torch.uint8).reshape(*lead, -1)


def _pad_to(w, dim: int, n: int):
    pad = [0, 0] * (w.dim() - 1 - dim % w.dim()) + [0, n - w.shape[dim]]
    return torch.nn.functional.pad(w, pad)


def stack_weights(sp: SamplerParams, cfg: Config, cs: int | None = None,
                  weight_dtype=torch.float32):
    """SamplerParams -> (slices, f2w, f2b); the gin weights are left out,
    as the TPU kernel's `_stack_weights` leaves them (JAX
    ops/wavenet_kernel.py:591-626). slices: bytes [cs, L, bytes of
    `slice_layout`], CTA c's operands of layer l, in `weight_dtype`: the
    gate product's A tiles over the x_t rows, then over the x_{t-2d},
    x_{t-d} and c_t rows (zero-padded to c16), m-tile mt holding units
    c·gc + 8mt .. + 7 (a columns in rows 0-7, b in 8-15, zero past gc); the
    skip|out product's (skip columns c·sc .., out columns c·rc .., depth
    G/2); then their biases in f32 (conv_b + cin_b in the gate rows' order;
    skip_b | out_b). The head's output columns are zero-padded to a
    multiple of 4."""
    wn = cfg.wavenet
    R, G = wn.residual_channels, wn.gate_channels
    cs = cs or cluster_size(weight_dtype)
    lay = slice_layout(cfg, cs, weight_dtype)
    st = lambda name: torch.stack([getattr(lp, name) for lp in sp.layers])
    conv = st("conv_w")                                    # [L, 3R, G]
    if sp.layers[0].cin_w is None:     # no local conditioning: zero rows
        cin_w = conv.new_zeros(conv.shape[0], max(wn.cin_channels, 0), G)
        cin_b = conv.new_zeros(conv.shape[0], G)
    else:
        cin_w, cin_b = st("cin_w"), st("cin_b")
    old = _pad_to(torch.cat([conv[:, :2 * R], cin_w], 1), 1,
                  2 * R + lay.c16).transpose(1, 2)         # [L, G, 2R + c16]
    xw = conv[:, 2 * R:].transpose(1, 2)                   # [L, G, R]
    czb = st("conv_b") + cin_b
    # gate rows: per CTA c and m-tile mt, units 8mt .. 8mt + 7 of c's gc
    # (a columns, then their b columns); units past gc are zero rows
    i = torch.arange(8)
    unit = torch.arange(lay.mtg)[:, None] * 8 + i                 # [mtg, 8]
    cols = torch.arange(cs)[:, None, None] * lay.gc + unit        # [cs, mtg, 8]
    cols = torch.cat([cols, G // 2 + cols], -1).reshape(cs, -1)   # [cs, 16 mtg]
    live = (unit < lay.gc).repeat(1, 2).reshape(-1).to(conv)      # [16 mtg]
    cols = cols.clamp(max=G - 1)
    gate = lambda w: w[:, cols] * live[:, None]            # [L, cs, 16 mtg, K]
    bg = czb[:, cols] * live
    c = torch.arange(cs)[:, None]
    scols = torch.arange(lay.sc)[None, :] + c * lay.sc
    rcols = torch.arange(lay.rc)[None, :] + c * lay.rc
    ws = torch.cat([st("skip_w").transpose(1, 2)[:, scols],
                    st("out_w").transpose(1, 2)[:, rcols]], 2)
    ws = _pad_to(ws, 2, 16 * lay.mts)                     # [L, cs, ., G/2]
    bs = _pad_to(torch.cat([st("skip_b")[:, scols], st("out_b")[:, rcols]],
                           2), 2, 16 * lay.mts)
    f32 = lambda x: x.to(torch.float32).contiguous().view(torch.uint8)
    wd = lambda x: x.to(weight_dtype)
    slices = torch.cat([_tiles(wd(gate(xw)), lay.ks),
                        _tiles(wd(gate(old)), lay.ks),
                        _tiles(wd(ws), lay.ks), f32(bg), f32(bs)],
                       -1).transpose(0, 1).contiguous()
    assert slices.shape[-1] == lay.bytes
    pad = -sp.final2_w.shape[1] % 4
    f2w = torch.nn.functional.pad(sp.final2_w, (0, pad)).contiguous()
    f2b = torch.nn.functional.pad(sp.final2_b, (0, pad)).contiguous()
    return slices, f2w, f2b


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

    slices: torch.Tensor   # bytes [cs, L, slice]
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


def pack_weights(sp: SamplerParams, cfg: Config, cs: int | None = None, *,
                 cache_dtype=torch.float32,
                 weight_dtype=torch.float32) -> KernelWeights:
    """SamplerParams -> the kernel's operands for the config's head, split
    over `cs` CTAs (by default the kernel's cluster for the weight dtype)."""
    _check_dtypes(cache_dtype, weight_dtype)
    cs = cs or cluster_size(weight_dtype)
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


def sampler_supported(cfg: Config, weight_dtype=torch.float32) -> bool:
    """Whether the kernel takes the config's WaveNet with `weight_dtype`
    weights: kernel_size 3, `slice_layout`'s tiles, and csrc/sampler.cu's
    `taco_sampler_supported` (the one statement of its envelope; it builds
    the kernel, so only the last check needs nvcc). A model with global
    conditioning is taken, without its speaker: the JAX synthesizer's gate
    does not look at gin_channels, its kernel drops the gin weights and
    its scan is called without g_vec (synth/wavenet_synth.py:37-48)."""
    wn = cfg.wavenet
    if wn.kernel_size != 3:
        return False
    try:
        slice_layout(cfg, weight_dtype=weight_dtype)
    except ValueError:
        return False
    kind, _ = head_kind(cfg)
    n_out = wn.out_channels
    return bool(_lib().taco_sampler_supported(
        wn.layers, wn.residual_channels, wn.gate_channels,
        wn.skip_out_channels, wn.cin_channels, n_out + -n_out % 4, n_out,
        HEADS[kind], int(weight_dtype == torch.bfloat16)))


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def takes_kernel(cfg: Config, device, weight_dtype=torch.float32) -> bool:
    """The synthesizers' route, chosen by the widths: the kernel on a CUDA
    device where `sampler_supported`, else `sample_plain` (on the card
    too), as the JAX synthesizer takes its scan where its kernel is not
    eligible (tacotron2_tpu/synth/wavenet_synth.py:37-42). Not a fallback:
    a launch of a kernel that takes the widths still raises if it fails."""
    return _on_card(device) and sampler_supported(cfg, weight_dtype)


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
        lib.taco_sampler_layout.argtypes = [ci] * 7 + [vp]
        lib.taco_sampler_layout.restype = None
        lib.taco_sampler_supported.argtypes = [ci] * 9
        lib.taco_sampler_supported.restype = ci
        for fn in ("rows_per_cluster", "n_ptr", "n_int"):
            getattr(lib, f"taco_sampler_{fn}").argtypes = []
            getattr(lib, f"taco_sampler_{fn}").restype = ci
        lib.taco_sampler_cluster_size.argtypes = [ci]
        lib.taco_sampler_cluster_size.restype = ci
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
    if kw.slices.device != dev:
        raise ValueError(f"sampler weights must be on {dev}")
    if kw.head != kind or kw.n_out != wn.out_channels:
        raise ValueError(f"kernel_weights hold a {kw.head} head with "
                         f"{kw.n_out} outputs, the config a {kind} head "
                         f"with {wn.out_channels}")
    if kw.slices.shape[1] != L:
        raise ValueError(f"kernel_weights hold {kw.slices.shape[1]} layers, "
                         f"the config {L}")
    if wn.kernel_size != 3:
        raise ValueError("the sampler kernel takes kernel_size 3")
    lib = _lib()
    wbf = int(kw.weight_dtype == torch.bfloat16)
    cs = lib.taco_sampler_cluster_size(wbf)
    if kw.cs != cs:
        raise ValueError(f"kernel_weights are laid out for {kw.cs} CTAs, "
                         f"the kernel runs {cs}")
    if lib.taco_sampler_rows_per_cluster() != ROWS_PER_CLUSTER:
        raise ValueError("the kernel runs another number of rows a cluster")
    NO = kw.f2w.shape[1]
    if C != wn.cin_channels:
        raise ValueError(f"c_up has {C} channels, the config {wn.cin_channels}")
    if not lib.taco_sampler_supported(L, R, G, S, C, NO, kw.n_out,
                                      HEADS[kind], wbf):
        raise ValueError(f"the sampler kernel does not take R {R}, G {G}, "
                         f"S {S}, C {C}, {kw.n_out} outputs with "
                         f"{kw.weight_dtype} weights")
    lay = (ctypes.c_int * 3)()
    lib.taco_sampler_layout(L, R, G, S, C, NO, wbf, lay)
    if lay[0] != kw.slices.shape[2]:
        raise ValueError(f"kernel_weights hold {kw.slices.shape[2]}-byte "
                         f"slices, the kernel takes {lay[0]}")
    plan = row_plan(B)
    ring = torch.zeros(plan.rows, kw.rows, R, device=dev,
                       dtype=kw.cache_dtype)
    out = torch.empty(B, T, device=dev)
    c_up = c_up.contiguous()
    noise = noise.to(torch.float32).contiguous()
    ints = dict(B=B, T=T, L=L, R=R, G=G, S=S, C=C, ring_rows=kw.rows,
                legacy=int(bool(wn.legacy)),
                residual_legacy=int(bool(wn.residual_legacy)),
                head=HEADS[kind], n_out=kw.n_out, NO=NO,
                # the one-hot start, class 127 (models/wavenet/sampler.py)
                first_idx=127 if wn.quantize_channels > 127 else -1,
                weight_bf16=wbf,
                cache_bf16=int(kw.cache_dtype == torch.bfloat16),
                slice_bytes=lay[0])
    lsm = wn.log_scale_min_gauss if kind == "gaussian" else wn.log_scale_min
    ptrs = [c_up, noise, kw.slices, kw.first_w, kw.first_b, kw.final1_w,
            kw.final1_b, kw.f2w, kw.f2b, kw.dil, kw.offs, ring, out]
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


# seed step between the ranks' noise streams (JAX wavenet_kernel.py:671)
SHARD_SEED_STRIDE = 9973


def sharded_sample(sp: SamplerParams, cfg: Config, c_up, seed: int, dp, *,
                   kernel_weights: KernelWeights | None = None,
                   cache_dtype=None, weight_dtype=None):
    """Sampling over a data-parallel group (JAX `sharded_incremental_sample`,
    wavenet_kernel.py:629-680): c_up [B, T, cin], the global batch, alike
    on every rank; rank r samples its B/world rows [r·B/n, (r+1)·B/n) with
    the noise drawn from a generator seeded seed + r·9973 on its device
    (`distributions.draw_noise`), through the kernel on a CUDA tensor (its
    plain version on the CPU, as `sample`). The ranks' rows are gathered in
    order: returns the samples [B, T] on every rank. B must divide by the
    world size. No collective runs inside the sample loop."""
    from ..models.wavenet.distributions import draw_noise
    from ..parallel import dist
    B, T, _ = c_up.shape
    assert B % dp.world == 0, f"batch {B} not divisible by {dp.world} ranks"
    c_local = dist.shard_batch(c_up, dp).contiguous()
    gen = torch.Generator(device=c_local.device)
    gen.manual_seed(seed + dp.rank * SHARD_SEED_STRIDE)
    noise = draw_noise(cfg, B // dp.world, T, gen, c_local.device)
    out = sample(sp, cfg, c_local, noise, kernel_weights=kernel_weights,
                 cache_dtype=cache_dtype, weight_dtype=weight_dtype)
    return dist.all_gather_rows(out, dp)


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

