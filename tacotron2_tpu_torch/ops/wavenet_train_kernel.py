"""The WaveNet training stack as CUDA kernels: the gated residual layers'
forward (kernel 5a) and backward (kernel 5b).

Port of tacotron2_tpu/ops/wavenet_train_kernel.py: `StackParams` (:55),
`extract_stack_params` (:72, differentiable through weight norm),
`_skip_scales` (:112), `stack_supported` (:474), `make_fused_stack`'s
custom VJP (:483-556) as the `FusedStack` autograd function, and
`fused_stack_apply` (:559). The kernels, `_build_stack_fwd` (:133) and
`_build_stack_bwd` (:261), are `csrc/wavenet_train.cu` (its note has the
design); `stack_fwd_plain` and `stack_bwd_plain` are their plain PyTorch
versions, which CPU tensors take. CUDA tensors launch the kernels or
raise. Each wrapper counts its calls (`fwd_launches`, `bwd_launches`),
one a pass over the whole stack, and the kernel launches inside them
(`fwd_kernel_launches`: a pre-pass and one a layer; `bwd_kernel_launches`:
BWD_LAYER_LAUNCHES a layer). With f32 weights the wrappers hand the
kernels each weight as its TF32 hi and lo planes (`split_tf32`), split
once a call; `mainloop_product` and `wgrad_product` run the kernels'
mainloop alone, for tests.

Layout: activations are [N = T·B, channels] with row = t·B + b, so a
dilation shift of d samples is a shift of d·B rows. T need not be a
multiple of any tile (the JAX function pads T to its time tile; the port
has none).

Rounding. With `wavenet.compute_dtype="bfloat16"` the weights are bf16
and every product takes bf16 operands with f32 sums, rounded where the
TPU kernel rounds: the dropped-out block input of the taps (:192), the
conditioning (:172), h before the skip and out products (:208), and in
the backward c_res·dres, the scaled skip gradient and dy before their
products (:345-363) and the dropped-out input (:400). With f32 compute
(the config's default) nothing is rounded but the saved activations (x,
tanh a, σ b), which are bf16 unless `acts_dtype_name="float32"`, as in
the JAX model. The kernels take both weight types and both activation
types at every width `stack_supported` admits.

Widths. The kernels run R, Ch = G/2 and S in column passes of 128 and
every product in 16-deep steps, so the CUDA wrappers zero-pad the
operands to those multiples (`pad_plan`, `pad_params`; each gate half on
its own, so Ch stays the split point) and slice the results back; the
default and r5 widths (R 128, G 256, S 128, cin 80) need no padding. A
padded plan keeps the true R as `hash_width`: the dropout hash counts
channels by it (trap: hashing by the padded R would draw other masks).
Zero columns stay zero through every layer (tanh 0 = 0, so h is 0 there
whatever σ 0 is), so the padded stack computes the same function.

Saved activations are [L, 3, N, max(R, Ch)]: x, tanh a, σ b of every
layer, each zero-padded to the wider of R and Ch. (The JAX kernel stores
them in R-wide slots and so raises when G != 2R, which `stack_supported`
admits; the port computes the layer loop's function there.)

Dropout. The TPU kernel draws from its on-core PRNG per (tile, layer),
which nothing off the TPU reproduces. The port's mask is a counter-based
hash of (seed, layer, row, channel) (`keep_bits`), evaluated by the
kernels and the plain versions alike (int64 tensor ops here, uint32 in
CUDA), so both draw bit-identical masks whatever the tile; the backward
regenerates it instead of storing it. A kept element is scaled by
1/keep, as in the TPU kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..config import Config

# calls of the CUDA forward and backward (each runs every layer)
fwd_launches = 0
bwd_launches = 0
# the kernel launches inside them (a diagnostic: the forward launches a
# pre-pass and one a layer, the backward BWD_LAYER_LAUNCHES a layer)
fwd_kernel_launches = 0
bwd_kernel_launches = 0
BWD_LAYER_LAUNCHES = 4
_argtypes_set = False

M32 = 0xFFFFFFFF
# the weight-gradient launch's row splits: a multiple of its stage depth
WGRAD_ROW_STEP = 64


class StackParams(NamedTuple):
    """Materialized (post weight-norm) stack weights, layer-stacked: L
    layers, C residual, G gate (2·Ch), S skip, Ci conditioning channels."""

    conv_w: torch.Tensor   # [L*3*C, G]  rows (l, tap k, c)
    conv_b: torch.Tensor   # [L, G]
    cin_w: torch.Tensor    # [L*Ci, G]
    cin_b: torch.Tensor    # [L, G]
    skip_w: torch.Tensor   # [L*Ch, S]
    skip_b: torch.Tensor   # [L, S]
    out_w: torch.Tensor    # [L*Ch, C]
    out_b: torch.Tensor    # [L, C]


def extract_stack_params(blocks: Sequence, cfg: Config) -> StackParams:
    """The port's `ResidualConv1DGLU` blocks -> StackParams, differentiable
    (weight norm applied; missing biases are zeros)."""
    def wb(conv):
        w = conv.weight()
        b = conv.bias if conv.bias is not None else w.new_zeros(w.shape[-1])
        return w, b

    parts = {f: [] for f in StackParams._fields}
    for blk in blocks:
        for name, conv in (("conv", blk.causal_conv), ("cin", blk.cin_conv),
                           ("skip", blk.skip_conv), ("out", blk.out_conv)):
            w, b = wb(conv)
            parts[f"{name}_w"].append(w.reshape(-1, w.shape[-1]))
            parts[f"{name}_b"].append(b)
    return StackParams(**{f: (torch.cat(v, 0) if f.endswith("_w")
                              else torch.stack(v)) for f, v in parts.items()})


def _skip_scales(cfg: Config):
    """Each layer's multiplier of its skip term in the final sum: with the
    legacy √0.5 after every later layer, c^(L-1) for layer 0 and c^(L-l)
    for layer l >= 1."""
    L = len(cfg.wavenet.dilations)
    if not cfg.wavenet.legacy:
        return [1.0] * L
    c = float(np.sqrt(0.5))
    return [c ** (L - 1)] + [c ** (L - l) for l in range(1, L)]


def stack_supported(cfg: Config) -> bool:
    wn = cfg.wavenet
    return (wn.kernel_size == 3 and wn.cin_channels > 0
            and wn.gin_channels <= 0
            and wn.gate_channels == 2 * (wn.gate_channels // 2)
            and len(wn.dilations) >= 2)


@dataclass(frozen=True)
class StackPlan:
    """The stack's constants for one config and batch."""

    B: int
    C: int
    G: int
    S: int
    Ci: int
    dil: Tuple[int, ...]
    scales: Tuple[float, ...]
    c_res: float
    drop: float
    weight_bf16: bool
    acts_dtype: torch.dtype
    supported: bool = True
    # the residual width the dropout hash counts channels by; 0: C (a
    # padded plan keeps the true R here)
    hash_width: int = 0

    @property
    def L(self) -> int:
        return len(self.dil)

    @property
    def Ch(self) -> int:
        return self.G // 2

    @property
    def hash_C(self) -> int:
        return self.hash_width or self.C

    @property
    def AW(self) -> int:
        """Width of a saved-activation slot."""
        return max(self.C, self.Ch)

    @property
    def keep(self) -> float:
        return 1.0 - self.drop


def make_plan(cfg: Config, B: int, acts_dtype_name: str = "bfloat16"
              ) -> StackPlan:
    wn = cfg.wavenet
    return StackPlan(
        B=B, C=wn.residual_channels, G=wn.gate_channels,
        S=wn.skip_out_channels, Ci=wn.cin_channels,
        dil=tuple(int(d) for d in wn.dilations),
        scales=tuple(_skip_scales(cfg)),
        c_res=float(np.sqrt(0.5)) if wn.residual_legacy else 1.0,
        drop=float(wn.dropout), weight_bf16=wn.compute_dtype == "bfloat16",
        acts_dtype=(torch.float32 if acts_dtype_name == "float32"
                    else torch.bfloat16),
        supported=stack_supported(cfg))


# ----------------------------------------------------------------- padding


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_plan(plan: StackPlan) -> StackPlan:
    """The kernels' widths: R, Ch and S up to multiples of 128 (their
    column passes), cin up to 16 (a product step); the true R stays the
    hash width."""
    return dataclasses.replace(
        plan, C=_up(plan.C, 128), G=2 * _up(plan.Ch, 128),
        S=_up(plan.S, 128), Ci=_up(plan.Ci, 16), hash_width=plan.hash_C)


def _widths(plan: StackPlan):
    return plan.C, plan.Ch, plan.S, plan.Ci


def pad_cols(x, n: int):
    """x [..., m] zero-padded to [..., n] (x itself when m == n)."""
    m = x.shape[-1]
    return x if m == n else torch.nn.functional.pad(x, (0, n - m))


def _gate_pad(t, Ch: int, Chp: int):
    """[..., 2·Ch] -> [..., 2·Chp]: each gate half padded on its own."""
    return torch.cat([pad_cols(t[..., :Ch], Chp), pad_cols(t[..., Ch:], Chp)],
                     -1)


def _gate_unpad(t, Ch: int, Chp: int):
    return torch.cat([t[..., :Ch], t[..., Chp:Chp + Ch]], -1)


def _rows_pad(t, n: int):
    """[L, m, k] -> [L, n, k] with zero rows."""
    m = t.shape[1]
    return t if m == n else torch.nn.functional.pad(t, (0, 0, 0, n - m))


def pad_params(plan: StackPlan, pp: StackPlan, sp: StackParams
               ) -> StackParams:
    """`sp` at the padded plan's widths: zero rows and columns."""
    if _widths(plan) == _widths(pp):
        return sp
    L, (C, Ch, S, Ci), (Cp, Chp, Sp, Cip) = plan.L, _widths(plan), \
        _widths(pp)
    gate = lambda t: _gate_pad(t, Ch, Chp)
    conv = _rows_pad(gate(sp.conv_w.reshape(L * 3, C, 2 * Ch)), Cp)
    cin = _rows_pad(gate(sp.cin_w.reshape(L, Ci, 2 * Ch)), Cip)
    skip = _rows_pad(pad_cols(sp.skip_w.reshape(L, Ch, S), Sp), Chp)
    out = _rows_pad(pad_cols(sp.out_w.reshape(L, Ch, C), Cp), Chp)
    return StackParams(
        conv_w=conv.reshape(L * 3 * Cp, 2 * Chp), conv_b=gate(sp.conv_b),
        cin_w=cin.reshape(L * Cip, 2 * Chp), cin_b=gate(sp.cin_b),
        skip_w=skip.reshape(L * Chp, Sp), skip_b=pad_cols(sp.skip_b, Sp),
        out_w=out.reshape(L * Chp, Cp), out_b=pad_cols(sp.out_b, Cp))


def unpad_params(plan: StackPlan, pp: StackPlan, d: StackParams
                 ) -> StackParams:
    """Padded-width gradients -> the plan's widths."""
    if _widths(plan) == _widths(pp):
        return d
    L, (C, Ch, S, Ci), (Cp, Chp, Sp, Cip) = plan.L, _widths(plan), \
        _widths(pp)
    gate = lambda t: _gate_unpad(t, Ch, Chp)
    c = lambda t: t.contiguous()
    return StackParams(
        conv_w=c(gate(d.conv_w.reshape(L * 3, Cp, -1)[:, :C]).reshape(
            L * 3 * C, 2 * Ch)),
        conv_b=c(gate(d.conv_b)),
        cin_w=c(gate(d.cin_w.reshape(L, Cip, -1)[:, :Ci]).reshape(
            L * Ci, 2 * Ch)),
        cin_b=c(gate(d.cin_b)),
        skip_w=c(d.skip_w.reshape(L, Chp, Sp)[:, :Ch, :S].reshape(
            L * Ch, S)),
        skip_b=c(d.skip_b[:, :S]),
        out_w=c(d.out_w.reshape(L, Chp, Cp)[:, :Ch, :C].reshape(L * Ch, C)),
        out_b=c(d.out_b[:, :C]))


def pad_acts(pp: StackPlan, acts):
    """Saved activations [L, 3, N, AW] -> [L, 3, N, pp.AW], contiguous."""
    return pad_cols(acts, pp.AW).contiguous()


def unpad_acts(plan: StackPlan, pp: StackPlan, acts):
    """Saved activations at the padded widths -> [L, 3, N, plan.AW]: the
    padded σ b columns (σ 0 = 1/2) zeroed, as the plain version pads."""
    if pp.AW == plan.AW:
        return acts
    acts = acts[..., :plan.AW].contiguous()
    acts[:, 2, :, plan.Ch:] = 0
    return acts


# ------------------------------------------------------------------ dropout


def _fmix32(h):
    """murmur3's finalizer on uint32 values (python ints or int64 tensors
    holding them); products kept below 2^63 by 16-bit halves."""
    def mul(x, c):
        return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & M32
    h = h ^ (h >> 16)
    h = mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def layer_key(seed: int, layer: int) -> int:
    """The dropout key of one layer of one draw."""
    return _fmix32(_fmix32((layer + 0x632BE5AB) & M32) ^ (seed & M32))


def keep_threshold(keep: float) -> int:
    """An element is kept when the top 24 bits of its hash are below
    this: floor(keep · 2^24)."""
    return int(keep * (1 << 24))


def keep_bits(key: int, row0: int, rows: int, C: int, keep: float,
              device="cpu") -> torch.Tensor:
    """Keep mask [rows, C] (bool) of rows row0 .. row0 + rows - 1."""
    r = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)
    k = (r[:, None] * C + torch.arange(C, dtype=torch.int64,
                                       device=device)) & M32
    v = _fmix32(k ^ key)
    v = _fmix32((v + key) & M32)
    return (v >> 8) < keep_threshold(keep)


def stack_keep(plan: StackPlan, seed: int, layer: int, N: int, device
               ) -> torch.Tensor:
    """Keep mask [N, C] of one layer, hashed over `plan.hash_C` channels
    (the columns past it, a padded plan's, are never kept)."""
    kept = keep_bits(layer_key(seed, layer), 0, N, plan.hash_C, plan.keep,
                     device)
    return pad_cols(kept, plan.C)


def dropout_multiplier(plan: StackPlan, seed: int, layer: int, N: int,
                       device) -> torch.Tensor:
    """[N, C] f32: 1/keep where kept, else 0."""
    kept = stack_keep(plan, seed, layer, N, device)
    return kept.to(torch.float32) * float(np.float32(1.0 / plan.keep))


# ------------------------------------------------------------------- plain


def _rounder(plan: StackPlan):
    if plan.weight_bf16:
        return lambda t: t.to(torch.bfloat16).to(torch.float32)
    return lambda t: t


def _shift_down(x, s: int):
    """out[r] = x[r - s], zero for r < s (the causal left pad)."""
    if s == 0:
        return x
    s = min(s, x.shape[0])
    return torch.cat([x.new_zeros(s, x.shape[1]), x[:x.shape[0] - s]], 0)


def _shift_up(x, s: int):
    """out[r] = x[r + s], zero past the last row."""
    if s == 0:
        return x
    s = min(s, x.shape[0])
    return torch.cat([x[s:], x.new_zeros(s, x.shape[1])], 0)


def _layer(sp: StackParams, plan: StackPlan, l: int, rnd):
    """Layer l's weights, in the compute dtype's values (f32 tensors)."""
    C, Ci, Ch = plan.C, plan.Ci, plan.Ch
    return dict(
        conv=[rnd(sp.conv_w[(3 * l + k) * C:(3 * l + k + 1) * C])
              for k in range(3)],
        cin=rnd(sp.cin_w[l * Ci:(l + 1) * Ci]),
        skip=rnd(sp.skip_w[l * Ch:(l + 1) * Ch]),
        out=rnd(sp.out_w[l * Ch:(l + 1) * Ch]))


def stack_fwd_plain(plan: StackPlan, sp: StackParams, x0, c2, seed: int):
    """Kernel 5a's plain version: x0 [N, C], c2 [N, Ci] f32 -> (skip sum
    [N, S] f32, saved activations [L, 3, N, AW] in plan.acts_dtype: x,
    tanh a, σ b of every layer, zero-padded to AW = max(C, Ch))."""
    rnd = _rounder(plan)
    N, B, Ch = x0.shape[0], plan.B, plan.Ch
    cm = rnd(c2)
    x = x0
    skip = None
    acts = []
    for l, d in enumerate(plan.dil):
        w = _layer(sp, plan, l, rnd)
        if plan.drop > 0:
            kept = stack_keep(plan, seed, l, N, x.device)
            xd = torch.where(kept, x * float(np.float32(1.0 / plan.keep)),
                             x.new_zeros(()))
        else:
            xd = x
        xdw = rnd(xd)
        y = sp.conv_b[l] + sp.cin_b[l]
        for k in range(3):
            y = y + _shift_down(xdw, (2 - k) * d * B) @ w["conv"][k]
        y = y + cm @ w["cin"]
        ta, sb = torch.tanh(y[:, :Ch]), torch.sigmoid(y[:, Ch:])
        acts.append(torch.stack([pad_cols(v, plan.AW) for v in (x, ta, sb)])
                    .to(plan.acts_dtype))
        h = rnd(ta * sb)
        s = plan.scales[l] * (h @ w["skip"] + sp.skip_b[l])
        skip = s if skip is None else skip + s
        x = plan.c_res * (h @ w["out"] + sp.out_b[l] + x)
    return skip, torch.stack(acts)


def stack_bwd_plain(plan: StackPlan, sp: StackParams, acts, c2, dskip,
                    seed: int):
    """Kernel 5b's plain version: the saved activations, c2 and dskip [N,
    S] -> (StackParams of f32 weight gradients, dx0 [N, C], dc2 [N, Ci])."""
    rnd = _rounder(plan)
    N, B, Ch, L = c2.shape[0], plan.B, plan.Ch, plan.L
    cm = rnd(c2)
    dres = torch.zeros(N, plan.C, device=c2.device)
    dc = torch.zeros_like(c2)
    g = {f: [None] * L for f in StackParams._fields}
    for l in reversed(range(L)):
        d = plan.dil[l]
        w = _layer(sp, plan, l, rnd)
        x, ta, sb = (a.to(torch.float32) for a in acts[l])
        x, ta, sb = x[:, :plan.C], ta[:, :Ch], sb[:, :Ch]
        hw = rnd(ta * sb)
        gr = plan.c_res * dres
        gk = plan.scales[l] * dskip
        grw, gkw = rnd(gr), rnd(gk)
        g["out_w"][l], g["out_b"][l] = hw.t() @ grw, gr.sum(0)
        g["skip_w"][l], g["skip_b"][l] = hw.t() @ gkw, gk.sum(0)
        dh = grw @ w["out"].t() + gkw @ w["skip"].t()
        da = dh * sb * (1.0 - ta * ta)
        db = dh * ta * sb * (1.0 - sb)
        dysum = torch.cat([da.sum(0), db.sum(0)])
        g["conv_b"][l], g["cin_b"][l] = dysum, dysum.clone()
        dyw = rnd(torch.cat([da, db], 1))
        g["cin_w"][l] = cm.t() @ dyw
        dc = dc + dyw @ w["cin"].t()
        mult = (dropout_multiplier(plan, seed, l, N, c2.device)
                if plan.drop > 0 else None)
        xdw = rnd(x * mult if mult is not None else x)
        dxd = torch.zeros_like(dres)
        dconv = []
        for k in range(3):
            dy_k = _shift_up(dyw, (2 - k) * d * B)
            dconv.append(xdw.t() @ dy_k)
            dxd = dxd + dy_k @ w["conv"][k].t()
        g["conv_w"][l] = torch.cat(dconv, 0)
        if mult is not None:
            dxd = dxd * mult
        dres = gr + dxd
    d_sp = StackParams(**{f: torch.cat(v, 0) if f.endswith("_w")
                          else torch.stack(v) for f, v in g.items()})
    return d_sp, dres, dc


# -------------------------------------------------------------------- CUDA


def _lib():
    from ..native import build
    global _argtypes_set
    lib = build.load("wavenet_train")
    if not _argtypes_set:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        cu, cf = ctypes.c_uint32, ctypes.c_float
        # widths: R (the hash's), then the padded R, Ch, S, cin
        wid = [ci] * 5
        lib.wn_fwd.argtypes = ([vp] * 16 + [ci] * 3 + [vp] * 3 + wid
                               + [cu, cf, ci, cf, ci, ci, vp,
                                  ctypes.POINTER(ci)])
        lib.wn_bwd_layer.argtypes = ([vp] * 22 + [ci] * 5 + wid
                                     + [cu, cu, cf, ci, cf, cf]
                                     + [ci] * 5 + [vp, ctypes.POINTER(ci)])
        lib.wn_mm_test.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.wn_wgrad_test.argtypes = [vp, vp, vp, vp] + [ci] * 7 + [vp]
        for fn in (lib.wn_fwd, lib.wn_bwd_layer, lib.wn_mm_test,
                   lib.wn_wgrad_test):
            fn.restype = ci
        _argtypes_set = True
    return lib


def _check_cuda(plan: StackPlan, *tensors, widths=(), weights=None):
    """Raise on what the kernels do not take: a config `stack_supported`
    refuses, weights of more than one type, or operands that are not
    contiguous f32 [N, width] tensors of one N = T·B on one device. Runs
    before any library loads."""
    if not plan.supported:
        raise ValueError("stack_supported refuses this config (kernel_size "
                         "3, cin > 0, no global conditioning, an even gate "
                         "width and at least 2 layers)")
    if weights is not None:
        types = {w.dtype for w in weights}
        if len(types) != 1 or not next(iter(types)).is_floating_point:
            raise ValueError("the stack's weights must share one floating "
                             f"type, got {sorted(map(str, types))}")
    dev, N = tensors[0].device, tensors[0].shape[0]
    for t, w in zip(tensors, widths):
        if t.device != dev or not t.is_contiguous() or \
                t.dtype != torch.float32:
            raise ValueError("the stack kernels take contiguous f32 tensors "
                             f"on one device, got {t.dtype} on {t.device}")
        if tuple(t.shape) != (N, w):
            raise ValueError(f"the stack kernels take [N, {w}] operands, "
                             f"got {tuple(t.shape)} with N = {N}")
    if weights is not None and any(w.device != dev for w in weights):
        raise ValueError("the stack's weights lie on another device")
    if N % plan.B:
        raise ValueError(f"N = {N} rows is not T·B for B = {plan.B}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _keep_args(plan: StackPlan):
    keep = plan.keep
    return (keep_threshold(keep), float(np.float32(1.0 / keep)),
            int(plan.drop > 0))


def _types(plan: StackPlan):
    """(weight dtype, its flag, the activation flag) for the C ABI."""
    wd = torch.bfloat16 if plan.weight_bf16 else torch.float32
    return wd, int(not plan.weight_bf16), int(plan.acts_dtype ==
                                              torch.float32)


def split_tf32(w):
    """(hi, lo) with w ≈ hi + lo, each a TF32 value: the kernels'
    `taco::split_tf32` (cvt.rna twice, ties away from zero) on f32 tensors.
    The f32 kernels take their weights' planes from here, once a call."""
    def rna(x):
        b = x.contiguous().view(torch.int32)
        return ((b + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(w)
    return hi, rna(w - hi)


def _width_args(plan: StackPlan, pp: StackPlan):
    return (plan.C, pp.C, pp.Ch, pp.S, pp.Ci)


def stack_fwd_cuda(plan: StackPlan, sp: StackParams, x0, c2, seed: int):
    """Kernel 5a: the same contract as `stack_fwd_plain`, on CUDA tensors;
    a pre-pass and one kernel launch a layer."""
    from ..native.build import check
    global fwd_launches, fwd_kernel_launches
    _check_cuda(plan, x0, c2, widths=(plan.C, plan.Ci), weights=sp)
    lib, dev, L, N = _lib(), x0.device, plan.L, x0.shape[0]
    pp = pad_plan(plan)
    spp = pad_params(plan, pp, sp)
    wd, w_f32, a_f32 = _types(plan)
    C, G, S, Ci, Ch = pp.C, pp.G, pp.S, pp.Ci, pp.Ch
    x_in = pad_cols(x0, C).contiguous()
    cb = pad_cols(c2, Ci).to(wd).contiguous()
    conv = spp.conv_w.reshape(L, 3 * C, G)
    w1t = torch.cat([conv, spp.cin_w.reshape(L, Ci, G)], 1).to(wd) \
        .transpose(1, 2).contiguous()
    w2t = torch.cat([spp.skip_w.reshape(L, Ch, S),
                     spp.out_w.reshape(L, Ch, C)], 2).to(wd) \
        .transpose(1, 2).contiguous()
    los = (None, None)
    if not plan.weight_bf16:    # the f32 products take TF32 hi, lo planes
        (w1t, w1_lo), (w2t, w2_lo) = split_tf32(w1t), split_tf32(w2t)
        los = (w1_lo, w2_lo)
    b1 = (spp.conv_b + spp.cin_b).float().contiguous()
    skip_b = spp.skip_b.float().contiguous()
    out_b = spp.out_b.float().contiguous()
    skip = torch.empty(N, S, device=dev)
    acts = torch.empty(L, 3, N, pp.AW, dtype=plan.acts_dtype, device=dev)
    h = torch.empty(N, Ch, dtype=wd, device=dev)
    xds = [torch.empty(N, C, dtype=wd, device=dev) for _ in range(2)]
    xs = [torch.empty(N, C, device=dev) for _ in range(2)]
    keep24, inv_keep, drop = _keep_args(plan)
    dil = np.asarray(plan.dil, np.int32)
    keys = np.asarray([layer_key(seed, l) for l in range(L)], np.uint32)
    scales = np.asarray(plan.scales, np.float32)
    arr = lambda v: v.ctypes.data_as(ctypes.c_void_p)
    n = ctypes.c_int(0)
    check(lib.wn_fwd(
        _ptr(x_in), _ptr(cb), _ptr(w1t), _ptr(los[0]), _ptr(w2t),
        _ptr(los[1]), _ptr(b1), _ptr(skip_b), _ptr(out_b), _ptr(acts),
        _ptr(skip), _ptr(h), _ptr(xds[0]), _ptr(xds[1]), _ptr(xs[0]),
        _ptr(xs[1]), N, plan.B, L, arr(dil), arr(keys), arr(scales),
        *_width_args(plan, pp), keep24, inv_keep, drop, plan.c_res, w_f32,
        a_f32, _stream(dev), ctypes.byref(n)), "wn_fwd")
    fwd_kernel_launches += n.value
    fwd_launches += 1
    if S != plan.S:
        skip = skip[:, :plan.S].contiguous()
    return skip, unpad_acts(plan, pp, acts)


def wgrad_tiles(pp: StackPlan) -> int:
    """128 × 128 output tiles of a layer's five weight gradients at the
    padded widths: three taps [C, G], cin [Ci, G], out | skip [Ch, C + S]."""
    C, G, S, Ci, Ch = pp.C, pp.G, pp.S, pp.Ci, pp.Ch
    return (3 * (C // 128) + _up(Ci, 128) // 128) * (G // 128) + \
        (Ch // 128) * ((C + S) // 128)


def wgrad_splits(pp: StackPlan, N: int, sms: int) -> Tuple[int, int]:
    """(rows a split, splits) of the weight-gradient launch: about one CTA
    (an output tile over a row split) per SM, each split a multiple of
    WGRAD_ROW_STEP rows."""
    want = max(1, min(-(-N // WGRAD_ROW_STEP), sms // wgrad_tiles(pp)))
    rows = _up(-(-N // want), WGRAD_ROW_STEP)
    return rows, -(-N // rows)


def stack_bwd_cuda(plan: StackPlan, sp: StackParams, acts, c2, dskip,
                   seed: int):
    """Kernel 5b: the same contract as `stack_bwd_plain`, on CUDA
    tensors; BWD_LAYER_LAUNCHES kernel launches a layer."""
    from ..native.build import check
    global bwd_launches, bwd_kernel_launches
    _check_cuda(plan, c2, dskip, widths=(plan.Ci, plan.S), weights=sp)
    want = (plan.L, 3, c2.shape[0], plan.AW)
    if acts.dtype != plan.acts_dtype or not acts.is_contiguous() or \
            tuple(acts.shape) != want or acts.device != c2.device:
        raise ValueError(f"the saved activations must be contiguous "
                         f"{plan.acts_dtype} {list(want)} on {c2.device}, "
                         f"got {acts.dtype} {tuple(acts.shape)}")
    lib, dev, L, N = _lib(), c2.device, plan.L, c2.shape[0]
    pp = pad_plan(plan)
    spp = pad_params(plan, pp, sp)
    wd, w_f32, a_f32 = _types(plan)
    C, G, S, Ci, Ch = pp.C, pp.G, pp.S, pp.Ci, pp.Ch
    acts = pad_acts(pp, acts)
    dskip = pad_cols(dskip, S)
    cb = pad_cols(c2, Ci).to(wd).contiguous()
    wos = torch.cat([spp.out_w.reshape(L, Ch, C),
                     spp.skip_w.reshape(L, Ch, S)], 2).to(wd).contiguous()
    wcin = spp.cin_w.reshape(L, Ci, G).to(wd).contiguous()
    wconv = spp.conv_w.reshape(L, 3, C, G).to(wd).contiguous()
    los = (None, None, None)
    if not plan.weight_bf16:    # the f32 products take TF32 hi, lo planes
        (wos, wos_lo), (wcin, wcin_lo), (wconv, wconv_lo) = (
            split_tf32(t) for t in (wos, wcin, wconv))
        los = (wos_lo, wcin_lo, wconv_lo)
    # the top layer has no residual gradient: go's residual half stays 0
    go = torch.zeros(N, C + S, dtype=wd, device=dev)
    dy = torch.empty(N, G, dtype=wd, device=dev)
    xd = torch.empty(N, C, dtype=wd, device=dev)
    h = torch.empty(N, Ch, dtype=wd, device=dev)
    dc = torch.empty(N, Ci, device=dev)
    bpart = torch.empty(-(-N // 128), G + C + S, device=dev)
    sums = torch.empty(L, G + C + S, device=dev)
    rows_per, splits = wgrad_splits(
        pp, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    wpart = torch.empty(splits * wgrad_tiles(pp) * 16384, device=dev)
    d_conv = torch.empty(L, 3, C, G, device=dev)
    d_cin = torch.empty(L, Ci, G, device=dev)
    d_os = torch.empty(L, Ch, C + S, device=dev)
    bufs = (torch.empty(N, C, device=dev), torch.empty(N, C, device=dev))
    keep24, inv_keep, drop = _keep_args(plan)
    wid = _width_args(plan, pp)
    st = _stream(dev)
    n = ctypes.c_int(0)
    dres = None
    for l in reversed(range(L)):
        out = bufs[l % 2]
        check(lib.wn_bwd_layer(
            _ptr(dres), _ptr(dskip), _ptr(acts[l]), _ptr(cb), _ptr(wos),
            _ptr(wcin), _ptr(wconv), *(_ptr(t) for t in los), _ptr(go), _ptr(dy), _ptr(xd), _ptr(h),
            _ptr(dc), _ptr(bpart), _ptr(wpart), _ptr(out), _ptr(d_conv[l]),
            _ptr(d_cin[l]), _ptr(d_os[l]), _ptr(sums[l]), N, plan.B,
            plan.dil[l], l, L, *wid, layer_key(seed, l), keep24, inv_keep,
            drop, plan.scales[l], plan.c_res, int(l < L - 1), rows_per,
            splits, w_f32, a_f32, st, ctypes.byref(n)), "wn_bwd_layer")
        bwd_kernel_launches += n.value
        dres = out
    bwd_launches += 1
    dysum = sums[:, :G]
    d_sp = StackParams(
        conv_w=d_conv.reshape(L * 3 * C, G), conv_b=dysum.clone(),
        cin_w=d_cin.reshape(L * Ci, G), cin_b=dysum.clone(),
        skip_w=d_os[:, :, C:].reshape(L * Ch, S),
        skip_b=sums[:, G + C:].clone(),
        out_w=d_os[:, :, :C].reshape(L * Ch, C),
        out_b=sums[:, G:G + C].clone())
    d_sp = unpad_params(plan, pp, d_sp)
    if C != plan.C:
        dres = dres[:, :plan.C].contiguous()
    if Ci != plan.Ci:
        dc = dc[:, :plan.Ci].contiguous()
    return d_sp, dres, dc


def mainloop_product(a, b):
    """The kernels' shared mainloop alone, on CUDA tensors: a [M, K] ·
    b [Nc, K]ᵀ in f32 (bf16 operands on wgmma, f32 ones as 3xTF32), for
    tests. Nc a multiple of 128; K a multiple of 64 (bf16) or 32 (f32)."""
    from ..native.build import check
    M, K = a.shape
    out = torch.empty(M, b.shape[0], device=a.device)
    b_lo = None
    if a.dtype == torch.float32:
        b, b_lo = split_tf32(b)
    check(_lib().wn_mm_test(_ptr(a), _ptr(b), _ptr(b_lo), _ptr(out), M,
                            b.shape[0], K,
                            int(a.dtype == torch.float32),
                            _stream(a.device)), "wn_mm_test")
    return out


def wgrad_product(p, q, qoff: int, splits: int):
    """The weight-gradient launch and its reduction alone, on CUDA
    tensors: Σ_r p[r]ᵀ · q[r + qoff] (q rows past the end read 0) in
    `splits` row splits, for tests. q's width a multiple of 128."""
    from ..native.build import check
    rows, K1 = p.shape
    K2 = q.shape[1]
    rows_per = _up(-(-rows // splits), WGRAD_ROW_STEP)
    splits = -(-rows // rows_per)
    out = torch.empty(K1, K2, device=p.device)
    part = torch.empty(splits * (_up(K1, 128) // 128) * (K2 // 128) * 16384,
                       device=p.device)
    check(_lib().wn_wgrad_test(_ptr(p), _ptr(q), _ptr(out), _ptr(part), rows,
                               K1, K2, qoff, rows_per, splits,
                               int(p.dtype == torch.float32),
                               _stream(p.device)), "wn_wgrad_test")
    return out


def stack_fwd(plan: StackPlan, sp: StackParams, x0, c2, seed: int):
    """CPU tensors take the plain version, CUDA tensors the kernel."""
    if x0.device.type == "cpu":
        return stack_fwd_plain(plan, sp, x0, c2, seed)
    return stack_fwd_cuda(plan, sp, x0, c2, seed)


def stack_bwd(plan: StackPlan, sp: StackParams, acts, c2, dskip, seed: int):
    if c2.device.type == "cpu":
        return stack_bwd_plain(plan, sp, acts, c2, dskip, seed)
    return stack_bwd_cuda(plan, sp, acts, c2, dskip, seed)


class FusedStack(torch.autograd.Function):
    """skip = stack(x0, c2) with the backward of kernel 5b: gradients of
    the eight StackParams tensors, x0 and c2 (the seed and plan get
    none). The saved activations are the forward's; the dropout mask is
    drawn again from the seed."""

    @staticmethod
    def forward(ctx, plan, seed, x0, c2, *weights):
        sp = StackParams(*(w.detach() for w in weights))
        skip, acts = stack_fwd(plan, sp, x0.detach(), c2.detach(), seed)
        ctx.plan, ctx.seed = plan, seed
        ctx.save_for_backward(c2, acts, *weights)
        return skip

    @staticmethod
    def backward(ctx, dskip):
        c2, acts, *weights = ctx.saved_tensors
        d_sp, dx0, dc2 = stack_bwd(ctx.plan, StackParams(*weights), acts,
                                   c2, dskip.contiguous(), ctx.seed)
        return (None, None, dx0, dc2, *d_sp)


def fused_stack_apply(cfg: Config, sp: StackParams, x0, c_up, seed: int, *,
                      acts_dtype_name: str = "bfloat16"):
    """[B, T, C] interface: to the kernels' [T·B, *] layout and back;
    returns the skip sum [B, T, S] f32."""
    B, T, C = x0.shape
    plan = make_plan(cfg, B, acts_dtype_name)
    x2 = x0.float().transpose(0, 1).reshape(T * B, C).contiguous()
    c2 = c_up.float().transpose(0, 1).reshape(T * B, -1).contiguous()
    skip = FusedStack.apply(plan, int(seed), x2, c2, *sp)
    return skip.reshape(T, B, -1).transpose(0, 1)
