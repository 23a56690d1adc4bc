"""Griffin-Lim, all iterations for a batch, as one CUDA kernel call.

Port of tacotron2_tpu/ops/griffin_lim_kernel.py (`build_griffin_lim_kernel`
:108, `fused_griffin_lim` :191). `fused_griffin_lim` takes the target
magnitude `S [B, F, K]` and the initial estimate (re0, im0), so the
zero-phase start and the random-phase start both run through it. CUDA
tensors launch `csrc/griffin_lim.cu` (its design and bound are in the note
at its top); CPU tensors take the plain version, `griffin_lim_plain`, the
same iterations as DFT products through `ops/stft.py`.

The kernel has two routes, chosen by shape alone (`route`): a power-of-two
n_fft (every preset) takes per-frame real FFTs in shared memory, whose
operands are the window over its support and one twiddle table made in
float64 and rounded to f32 once (`fft_operands`; the passes: `fft_plan`);
any other n_fft takes the dense DFT products, whose operands are the
window-folded synthesis and analysis bases over the support
(`kernel_bases`). Both are built once per (n_fft, hop, win, device); the
overlap-add normalisation `g` (`overlap_add_norm`) is made for each call's
frame count.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import stft as _stft

# kernel calls made by `fused_griffin_lim` (one per batch reconstruction),
# in all and by route
launches = 0
launches_fft = 0
launches_dft = 0
# the largest n_fft of the FFT route (its two buffers, 16·n_fft bytes of
# shared memory a CTA)
FFT_MAX = 16384

_argtypes_set = False


def griffin_lim_plain(S, re0, im0, n_fft: int, hop: int, win_size: int,
                      iters: int):
    """The kernel's plain version: y = iSTFT(re0, im0), then `iters` times
    est = STFT(y), y = iSTFT(S·est/max(|est|, 1e-8)). [B, F, K] ->
    [B, hop·(F-1)]."""
    y = _stft.istft(re0, im0, n_fft, hop, win_size)
    for _ in range(iters):
        er, ei = _stft.stft(y, n_fft, hop, win_size)
        mag = torch.clamp(torch.sqrt(er * er + ei * ei), min=1e-8)
        y = _stft.istft(S * er / mag, S * ei / mag, n_fft, hop, win_size)
    return y


class KernelBases(NamedTuple):
    bsyn: torch.Tensor  # [2K, W] [window·ci ; -window·si] over the support
    bana: torch.Tensor  # [W, 2K] [window·cos | -window·sin]
    lpad: int


_bases: Dict[tuple, KernelBases] = {}


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def kernel_bases(n_fft: int, hop: int, win_size: int,
                 device) -> KernelBases:
    key = (n_fft, hop, win_size, str(device))
    if key not in _bases:
        lpad, window = _stft.support(n_fft, win_size)
        W = window.shape[0]
        cos_b, sin_b = _stft._dft_bases(n_fft)
        ci, si = _stft._idft_bases(n_fft)
        bsyn = np.concatenate([ci[:, lpad:lpad + W] * window,
                               -si[:, lpad:lpad + W] * window], 0)
        bana = np.concatenate([cos_b[lpad:lpad + W] * window[:, None],
                               -sin_b[lpad:lpad + W] * window[:, None]], 1)
        _bases[key] = KernelBases(_to(bsyn, device), _to(bana, device), lpad)
    return _bases[key]


def route(n_fft: int) -> str:
    """"fft" for a power-of-two n_fft up to FFT_MAX, else "dft"."""
    return "fft" if 4 <= n_fft <= FFT_MAX and n_fft & (n_fft - 1) == 0 \
        else "dft"


def fft_plan(n_fft: int) -> list:
    """The radices of the kernel's Stockham passes over M = n_fft/2
    points, in order: 4 while 4 divides what is left, then one 2."""
    n, plan = n_fft // 2, []
    while n > 1:
        r = 4 if n % 4 == 0 else 2
        plan.append(r)
        n //= r
    return plan


def fft_twiddles(n_fft: int) -> np.ndarray:
    """[n_fft, 2] f32: e^{-2πi t/n_fft} (cos, -sin), made in float64 and
    rounded once."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], 1).astype(np.float32)


class FftOperands(NamedTuple):
    win: torch.Tensor  # [W] the window over its support
    tw: torch.Tensor   # [n_fft, 2] fft_twiddles
    lpad: int


_fft_ops: Dict[tuple, FftOperands] = {}


def fft_operands(n_fft: int, win_size: int, device) -> FftOperands:
    key = (n_fft, win_size, str(device))
    if key not in _fft_ops:
        lpad, window = _stft.support(n_fft, win_size)
        _fft_ops[key] = FftOperands(_to(window, device),
                                    _to(fft_twiddles(n_fft), device), lpad)
    return _fft_ops[key]


def overlap_add_norm(n_fft: int, hop: int, win_size: int, F: int,
                     device) -> torch.Tensor:
    """g [n_fft + hop·(F-1)]: 1/window-sum-square inside the centre-trimmed
    span, 0 outside it."""
    g = _stft.wss_inverse(n_fft, hop, win_size, F).copy()
    pad = n_fft // 2
    g[:pad] = 0.0
    g[len(g) - pad:] = 0.0
    return _to(g, device)


def _lib():
    from ..native import build
    global _argtypes_set
    lib = build.load("griffin_lim")
    if not _argtypes_set:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in ("taco_griffin_lim_launch", "taco_griffin_lim_fft_launch"):
            getattr(lib, fn).argtypes = [vp] * 8 + [ci] * 8 + [vp]
            getattr(lib, fn).restype = ci
        _argtypes_set = True
    return lib


def fused_griffin_lim(S, re0, im0, n_fft: int, hop: int, win_size: int,
                      iters: int = 60):
    """S, re0, im0 [B, F, K] f32 -> waveform [B, hop·(F-1)]. CPU tensors
    take `griffin_lim_plain`; CUDA tensors launch the kernel or raise."""
    if S.device.type == "cpu":
        return griffin_lim_plain(S, re0, im0, n_fft, hop, win_size, iters)
    return _griffin_lim_cuda(S, re0, im0, n_fft, hop, win_size, iters)


def _griffin_lim_cuda(S, re0, im0, n_fft, hop, win_size, iters):
    global launches, launches_fft, launches_dft
    if S.dim() != 3:
        raise ValueError(f"S must be [B, F, K], got {tuple(S.shape)}")
    B, F, K = S.shape
    if K != n_fft // 2 + 1 or F < 1:
        raise ValueError(f"S [B, F, K] needs K = n_fft//2+1 = "
                         f"{n_fft // 2 + 1}, got {tuple(S.shape)}")
    for name, x in (("S", S), ("re0", re0), ("im0", im0)):
        if x.dtype != torch.float32 or x.device != S.device \
                or tuple(x.shape) != (B, F, K):
            raise ValueError(f"{name} must be f32 {(B, F, K)} on "
                             f"{S.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    dev = S.device
    g = overlap_add_norm(n_fft, hop, win_size, F, dev)
    total = n_fft + hop * (F - 1)
    S = S.contiguous()
    reim0 = torch.cat([re0, im0], -1).contiguous()
    kind = route(n_fft)
    if kind == "fft":
        ops = fft_operands(n_fft, win_size, dev)
        W, fn = ops.win.shape[0], "taco_griffin_lim_fft_launch"
        a, b = ops.win, ops.tw
    else:
        ops = kernel_bases(n_fft, hop, win_size, dev)
        W, fn = ops.bana.shape[0], "taco_griffin_lim_launch"
        a, b = ops.bsyn, ops.bana
    frames = torch.empty(B, F, W, device=dev)
    est = torch.empty(B, F, 2 * K, device=dev)
    y = torch.empty(B, total, device=dev)
    lib = _lib()
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    rc = getattr(lib, fn)(
        ptr(reim0), ptr(S), ptr(a), ptr(b), ptr(g), ptr(frames), ptr(est),
        ptr(y), B, F, K, W, hop, ops.lpad, n_fft, int(iters),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    from ..native.build import check
    check(rc, fn)
    launches += 1
    if kind == "fft":
        launches_fft += 1
    else:
        launches_dft += 1
    pad = n_fft // 2
    return y[:, pad: pad + hop * (F - 1)]
