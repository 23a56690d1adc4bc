"""WaveNet building blocks (PyTorch), batch-time-channel layout.

Counterparts of tacotron2_tpu/models/wavenet/modules.py: weight norm
(`weight_normed`, :28; the numpy one reads flax trees for the sampler and
the bridge, `weight_norm` is the differentiable one), `CausalConv1D`
(:39) and `Conv1x1` (:82), plain or weight-normed, `ResidualConv1DGLU`
(:110) with its local and global conditioning 1×1s, and the conditioning
upsamplers with their checkerboard-free nn_init kernels
(`_nn_init_kernel_2d` :167; `SubPixelUpsample` :180, `ResizeUpsample`
:209, `ConvTranspose1DUpsample` :232, `ConvTranspose2DUpsample` :260 and
the NearestNeighbor repeat in `UpsampleNetwork` :286). Parameters keep
the flax layouts and leaf names (`kernel`, or `v` and `g`, and `bias`),
so the bridge is a rename; the upsamplers' Conv_0 kernels are held in
torch's conv2d layout (`_Up`).

Each conv takes `rnd`, the compute dtype's rounding: identity in f32; in
bf16 (`wavenet.compute_dtype`) the input, the kernel and the bias are
rounded and so is each output, as flax's `dtype=bfloat16` modules compute
(bf16 operands, a bf16 result). Rounded values stay f32 tensors, so every
op also runs where bf16 kernels do not; `round_bf16`'s backward rounds
the gradient too, as the bf16 values' gradients are bf16 in JAX.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Rounding = Callable[[torch.Tensor], torch.Tensor]
_calls = itertools.count()


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


def weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """W = g · v / ‖v‖ per output channel (the last axis), differentiable."""
    axes = tuple(range(v.dim() - 1))
    norm = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True) + 1e-12)
    return v * (g / norm)


class _RoundBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (kept f32); the gradient is rounded alike."""
    return _RoundBf16.apply(x)


def no_round(x: torch.Tensor) -> torch.Tensor:
    return x


def rounding(compute_dtype: str) -> Rounding:
    return round_bf16 if compute_dtype == "bfloat16" else no_round


class _WeightNormed(nn.Module):
    """A kernel of shape [..., in, out] held plain (`kernel`) or as
    weight norm's `v` and `g`, and an optional `bias`. With `capture` set,
    `wn_out` keeps the last output and `call_seq` when it was made (the
    data-dependent init reads both)."""

    def __init__(self, shape: Tuple[int, ...], use_bias: bool,
                 weight_norm: bool):
        super().__init__()
        self.is_weight_normed = weight_norm
        if weight_norm:
            self.v = nn.Parameter(torch.zeros(shape))
            self.g = nn.Parameter(torch.zeros(shape[-1]))
        else:
            self.kernel = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(shape[-1])) if use_bias else None
        self.capture = False
        self.wn_out = None
        self.call_seq = -1

    def weight(self) -> torch.Tensor:
        if self.is_weight_normed:
            return weight_norm(self.v, self.g)
        return self.kernel

    def _finish(self, y, rnd: Rounding):
        if self.bias is not None:
            y = rnd(y + rnd(self.bias))
        if self.capture:
            self.wn_out, self.call_seq = y.detach(), next(_calls)
        return y


class Conv1x1(_WeightNormed):
    """Pointwise conv: x [..., in] @ kernel [in, out] (+ bias)."""

    def __init__(self, in_c: int, out_c: int, use_bias: bool = True,
                 weight_norm: bool = False):
        super().__init__((in_c, out_c), use_bias, weight_norm)

    def forward(self, x, rnd: Rounding = no_round):
        return self._finish(rnd(rnd(x) @ rnd(self.weight())), rnd)


class CausalConv1D(_WeightNormed):
    """Dilated causal conv over [B, T, C]: left pad (kw-1)·dilation, VALID;
    the kernel is flax's [kw, in, out]."""

    def __init__(self, in_c: int, out_c: int, kernel_size: int,
                 dilation: int = 1, use_bias: bool = True,
                 weight_norm: bool = False):
        super().__init__((kernel_size, in_c, out_c), use_bias, weight_norm)
        self.kernel_size, self.dilation = kernel_size, dilation

    def forward(self, x, rnd: Rounding = no_round):
        pad = (self.kernel_size - 1) * self.dilation
        k = rnd(self.weight()).permute(2, 1, 0)          # [out, in, kw]
        y = F.conv1d(F.pad(rnd(x).transpose(1, 2), (pad, 0)), k,
                     dilation=self.dilation).transpose(1, 2)
        return self._finish(rnd(y), rnd)


class ResidualConv1DGLU(nn.Module):
    """Gated residual block (reference modules.py:392-521): returns
    (residual out [B, T, R], skip [B, T, S]). The local conditioning's
    1×1 `cin_conv` exists when cin_channels > 0, the global one's
    `gin_conv` when gin_channels > 0 (JAX :139-148, which makes each where
    its input is given)."""

    def __init__(self, residual_channels: int, gate_channels: int,
                 kernel_size: int, skip_out_channels: int, dilation: int,
                 cin_channels: int, use_bias: bool = True,
                 residual_legacy: bool = True, weight_norm: bool = False,
                 gin_channels: int = -1):
        super().__init__()
        R, G = residual_channels, gate_channels
        self.residual_legacy = residual_legacy
        self.causal_conv = CausalConv1D(R, G, kernel_size, dilation,
                                        use_bias, weight_norm)
        self.cin_conv = (Conv1x1(cin_channels, G, use_bias, weight_norm)
                         if cin_channels > 0 else None)
        self.gin_conv = (Conv1x1(gin_channels, G, use_bias, weight_norm)
                         if gin_channels > 0 else None)
        self.skip_conv = Conv1x1(G // 2, skip_out_channels, use_bias,
                                 weight_norm)
        self.out_conv = Conv1x1(G // 2, R, use_bias, weight_norm)

    def forward(self, x, c, g=None, *, kept: Optional[torch.Tensor] = None,
                keep: float = 1.0, rnd: Rounding = no_round,
                res_rnd: Rounding = no_round):
        """c [B, T, cin] and g [B, T, gin] (the speaker vector broadcast
        over time) enter through their 1×1s where given, as in JAX.
        `kept` [B, T, R] (bool) is the block input's dropout keep mask in
        train mode: kept elements are x / keep, the rest 0. `res_rnd`
        rounds the residual sum: flax adds in bf16 while the block input
        is bf16 (the first block's, and every block's without the legacy
        scaling)."""
        residual = x
        if kept is not None:
            x = torch.where(kept, rnd(x / keep), x.new_zeros(()))
        y = self.causal_conv(x, rnd)
        a, b = y.chunk(2, -1)
        for conv, v in ((self.cin_conv, c), (self.gin_conv, g)):
            if conv is not None and v is not None:
                va, vb = conv(v, rnd).chunk(2, -1)
                a, b = rnd(a + va), rnd(b + vb)
        h = rnd(rnd(torch.tanh(a)) * rnd(torch.sigmoid(b)))
        s = self.skip_conv(h, rnd)
        o = self.out_conv(h, rnd)
        if self.residual_legacy:
            # flax multiplies by numpy's float64 √0.5, which promotes the
            # sum to f32: the block output is not rounded
            return res_rnd(o + residual) * float(np.sqrt(0.5)), s
        return res_rnd(o + residual), s


# ------------------------------------------------------------------ upsample
# Every upsampler maps mel features [B, T_mel, M] -> [B, T_mel·prod(scales),
# M]; the 2-D ones work on the image view [B, 1, M (freq), T].


def _nn_init_kernel_2d(kernel_size: Tuple[int, int], time_overlap: int,
                       scaler: float, in_c: int, out_c: int) -> np.ndarray:
    """Checkerboard-free init (reference SubPixel/Resize _init_kernel),
    flax's [kh, kw, in, out]."""
    kh, kw = kernel_size
    k = np.zeros((kh, kw), dtype=np.float32)
    i = kh // 2
    js = [kw // 2 - 1, kw // 2] if kw % 2 == 0 else [kw // 2]
    for j in js:
        k[i, j] = 1.0 / max(time_overlap, 1.0) if kw % 2 == 0 else 1.0
    k = k * scaler
    return np.tile(k[:, :, None, None], (1, 1, in_c, out_c))


def _same_pads(k: int) -> Tuple[int, int]:
    """flax's SAME padding of a stride-1 conv: (k-1)//2 before, k//2
    after."""
    return (k - 1) // 2, k // 2


def _transpose_pads(k: int, s: int) -> Tuple[int, int]:
    """lax.conv_transpose's SAME padding of the stride-s dilated input
    (jax `_conv_transpose_padding`)."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


class _Up(nn.Module):
    """An upsample layer's kernel and bias. `leaves` names them as
    (flax path under the layer, attribute); a Conv_0 kernel is held in
    torch's conv2d layout [out, in, kh, kw] (`to_flax` / `from_flax`
    convert), a ConvTranspose_0 kernel in flax's own (`_TransposeUp`)."""

    conv = "Conv_0"

    def __init__(self, kernel_shape: Tuple[int, ...], out_c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(kernel_shape))
        self.bias = nn.Parameter(torch.zeros(out_c))

    @property
    def leaves(self):
        return ((f"{self.conv}/kernel", "weight"),
                (f"{self.conv}/bias", "bias"))

    def to_flax(self, a: np.ndarray) -> np.ndarray:
        return a.transpose(2, 3, 1, 0)

    def from_flax(self, a: np.ndarray) -> np.ndarray:
        return a.transpose(3, 2, 0, 1)

    def flax_kernel(self) -> np.ndarray:
        return self.to_flax(self.weight.detach().cpu().numpy())

    def set_flax_kernel(self, k: np.ndarray) -> None:
        with torch.no_grad():
            self.weight.copy_(torch.from_numpy(np.ascontiguousarray(
                self.from_flax(np.asarray(k, np.float32)))))
            self.bias.zero_()


class SubPixelUpsample(_Up):
    """3×3 SAME conv over the [freq, time] mel image with `scale` output
    channels, then the time-axis periodic shuffle (t, k) -> t·scale + k.
    `weight` is torch's [scale, 1, kh, kw]."""

    def __init__(self, scale: int, freq_kernel: int = 3, time_kernel: int = 3):
        super().__init__((scale, 1, freq_kernel, time_kernel), scale)
        self.scale = scale

    def nn_init(self, pow_scaler: float) -> None:
        """The reference's nn_init kernel (bias zero)."""
        _, _, kf, kt = self.weight.shape
        self.set_flax_kernel(_nn_init_kernel_2d(
            (kf, kt), kt // self.scale, pow_scaler, 1, self.scale))

    def forward(self, img):
        # img [B, 1, F, T] -> [B, 1, F, T*scale]
        kf, kt = self.weight.shape[2:]
        y = F.conv2d(F.pad(img, _same_pads(kt) + _same_pads(kf)),
                     self.weight, self.bias)            # [B, scale, F, T]
        B, S, Fq, T = y.shape
        return y.permute(0, 2, 3, 1).reshape(B, 1, Fq, T * S)


class ResizeUpsample(_Up):
    """Nearest-neighbour repeat of each time step `scale` times, then a
    (freq_kernel, scale) SAME conv to one channel (reference
    ResizeConvolution; JAX modules.py:209). The even time kernel pads one
    step more after than before, as flax does."""

    def __init__(self, scale: int, freq_kernel: int = 3):
        super().__init__((1, 1, freq_kernel, scale), 1)
        self.scale = scale

    def nn_init(self, pow_scaler: float) -> None:
        kf, kt = self.weight.shape[2:]
        self.set_flax_kernel(_nn_init_kernel_2d(
            (kf, kt), kt // self.scale, pow_scaler, 1, 1))

    def forward(self, img):
        kf, kt = self.weight.shape[2:]
        y = torch.repeat_interleave(img, self.scale, dim=3)
        return F.conv2d(F.pad(y, _same_pads(kt) + _same_pads(kf)),
                        self.weight, self.bias)


class _TransposeUp(_Up):
    """A flax ConvTranspose layer: its kernel in flax's layout."""

    conv = "ConvTranspose_0"

    def to_flax(self, a: np.ndarray) -> np.ndarray:
        return a

    def from_flax(self, a: np.ndarray) -> np.ndarray:
        return a


def _conv_transpose(x, kernel, strides, conv):
    """flax `ConvTranspose(padding="SAME")` (transpose_kernel=False: the
    kernel is correlated with the stride-dilated input, unflipped, under
    `_transpose_pads`) through torch's transposed conv, which correlates
    the flipped kernel with the input dilated and padded k-1 on each side:
    the kernel goes in flipped, and the output is cropped (or widened) to
    flax's padding."""
    nd = len(strides)
    ks = kernel.shape[:nd]
    w = kernel.permute(nd, nd + 1, *range(nd)).flip(list(range(2, 2 + nd)))
    y = conv(x, w, stride=tuple(strides))
    pads = []
    for k, s in reversed(list(zip(ks, strides))):
        a, b = _transpose_pads(k, s)
        pads += [a - (k - 1), b - (k - 1)]
    return F.pad(y, pads)


class ConvTranspose1DUpsample(_TransposeUp):
    """A channel-preserving stride-`scale` transposed conv over [B, T, M]
    (reference ConvTranspose1D; JAX modules.py:232). `weight` is flax's
    [scale, in, out]."""

    def __init__(self, scale: int, channels: int):
        super().__init__((scale, channels, channels), channels)
        self.scale = scale

    def nn_init(self, pow_scaler: float) -> None:
        kw, cin, cout = self.weight.shape
        k = np.tile(np.eye(cin, cout, dtype=np.float32)[None], (kw, 1, 1))
        if kw % 2 == 0:
            k = k / max(float(kw // self.scale), 1.0)
        self.set_flax_kernel(k * pow_scaler)

    def forward(self, x):
        y = _conv_transpose(x.transpose(1, 2), self.weight, (self.scale,),
                            F.conv_transpose1d)
        return y.transpose(1, 2) + self.bias


class ConvTranspose2DUpsample(_TransposeUp):
    """A one-channel transposed conv over the mel image, stride (1, scale),
    kernel (freq_kernel, scale) (reference ConvTranspose2D; JAX
    modules.py:260). `weight` is flax's [kh, kw, 1, 1]."""

    def __init__(self, scale: int, freq_kernel: int = 3):
        super().__init__((freq_kernel, scale, 1, 1), 1)
        self.scale = scale

    def nn_init(self, pow_scaler: float) -> None:
        kh, kw = self.weight.shape[:2]
        k = np.zeros((kh, kw), np.float32)
        k[kh // 2, :] = 1.0 / max(kw // self.scale, 1.0) if kw % 2 == 0 \
            else 1.0
        self.set_flax_kernel(k[:, :, None, None] * pow_scaler)

    def forward(self, img):
        y = _conv_transpose(img, self.weight, (1, self.scale),
                            F.conv_transpose2d)
        return y + self.bias[:, None, None]


class UpsampleNetwork(nn.Module):
    """Mel [B, T_mel, M] -> [B, T_mel·prod(scales), M] (reference
    wavenet.py:162-205; JAX modules.py:286): one layer a scale of
    `upsample_type`, each followed by the activation (Relu, LeakyRelu,
    else none); NearestNeighbor repeats each frame hop times and has no
    layers. An unknown type raises ValueError, as the JAX network does."""

    def __init__(self, upsample_type: str, scales: Sequence[int],
                 freq_kernel: int = 3, cin_channels: int = 80,
                 activation: str = "Relu", leaky_alpha: float = 0.4):
        super().__init__()
        layer = {
            "SubPixel": lambda s: SubPixelUpsample(s, freq_kernel),
            "Resize": lambda s: ResizeUpsample(s, freq_kernel),
            "1D": lambda s: ConvTranspose1DUpsample(s, cin_channels),
            "2D": lambda s: ConvTranspose2DUpsample(s, freq_kernel),
            "NearestNeighbor": None}
        if upsample_type not in layer:
            raise ValueError(f"wavenet.upsample_type={upsample_type!r}: one "
                             f"of {tuple(layer)}")
        self.upsample_type, self.scales = upsample_type, tuple(scales)
        make = layer[upsample_type]
        self.layers = nn.ModuleList(
            [] if make is None else [make(s) for s in self.scales])
        self.activation, self.leaky_alpha = activation, leaky_alpha

    def _act(self, x):
        if self.activation == "Relu":
            return F.relu(x)
        if self.activation == "LeakyRelu":
            return F.leaky_relu(x, self.leaky_alpha)
        return x

    def forward(self, c):
        c = c.float()
        if self.upsample_type == "NearestNeighbor":
            return torch.repeat_interleave(c, int(np.prod(self.scales)),
                                           dim=1)
        if self.upsample_type == "1D":
            for layer in self.layers:
                c = self._act(layer(c))
            return c
        img = c.transpose(1, 2)[:, None]                # [B, 1, M, T]
        for layer in self.layers:
            img = self._act(layer(img))
        return img[:, 0].transpose(1, 2)                 # [B, T_up, M]
