"""ctypes bindings for the port's native data-IO runtime
(`csrc/tacodata.cc`).

Counterpart of tacotron2_tpu/native/__init__.py:31-197: GIL-free parallel
`.npy` loading for the feeders, a μ-law codec and PCM16 WAV IO. The library
is built with the host C++ compiler at first use into the git-ignored
`_build/` (`build.build_host`, keyed by a hash of the source and flags).
Every entry point keeps the JAX module's numpy path, which a machine
without a C++ compiler takes (`available()` says which is active); where a
compiler exists and the build fails, the failure is raised with the
compiler's output.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from . import build

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if build.cxx_path() is None:
        from ..utils import log
        log("native data-IO runtime: no host C++ compiler, numpy path")
        return None
    lib = ctypes.CDLL(build.build_host("tacodata"))
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.taco_npy_size.restype = i64
    lib.taco_npy_size.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64),
                                  ctypes.POINTER(i32)]
    lib.taco_npy_read_f32.restype = i64
    lib.taco_npy_read_f32.argtypes = [ctypes.c_char_p, f32p, i64]
    lib.taco_npy_read_batch_f32.restype = None
    lib.taco_npy_read_batch_f32.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), i32, ctypes.POINTER(f32p),
        ctypes.POINTER(i64), ctypes.POINTER(i64), i32]
    for fn in ("taco_mulaw", "taco_inv_mulaw"):
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = [f32p, f32p, i64, ctypes.c_float]
    lib.taco_mulaw_quantize.restype = None
    lib.taco_mulaw_quantize.argtypes = [f32p, ctypes.POINTER(i32), i64,
                                        ctypes.c_float]
    lib.taco_wav_write_pcm16.restype = i32
    lib.taco_wav_write_pcm16.argtypes = [ctypes.c_char_p, f32p, i64, i32,
                                         i32]
    lib.taco_wav_read_pcm16.restype = i64
    lib.taco_wav_read_pcm16.argtypes = [ctypes.c_char_p, f32p, i64,
                                        ctypes.POINTER(i32)]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the library is loaded (built on demand)."""
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _probe(lib, path: str):
    shape = (ctypes.c_int64 * 8)()
    ndim = ctypes.c_int32()
    n = lib.taco_npy_size(path.encode(), shape, ctypes.byref(ndim))
    if n < 0:
        raise IOError(f"native npy probe failed: {path}")
    return n, tuple(shape[i] for i in range(ndim.value))


def read_npy_f32(path: str) -> np.ndarray:
    """np.load(path).astype(float32) through the native parser."""
    lib = _load()
    if lib is None:
        return np.load(path).astype(np.float32)
    n, shape = _probe(lib, path)
    out = np.empty(n, np.float32)
    if lib.taco_npy_read_f32(path.encode(), _f32p(out), n) != n:
        raise IOError(f"native npy read failed: {path}")
    return out.reshape(shape)


def read_npy_batch_f32(paths: Sequence[str],
                       num_threads: int = 8) -> List[np.ndarray]:
    """Many .npy files loaded by parallel native threads (no GIL)."""
    lib = _load()
    if lib is None:
        return [np.load(p).astype(np.float32) for p in paths]
    n = len(paths)
    if n == 0:
        return []
    metas = [_probe(lib, p) for p in paths]
    bufs = [np.empty(m[0], np.float32) for m in metas]
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_outs = (ctypes.POINTER(ctypes.c_float) * n)(*[_f32p(b) for b in bufs])
    c_caps = (ctypes.c_int64 * n)(*[m[0] for m in metas])
    c_sizes = (ctypes.c_int64 * n)()
    lib.taco_npy_read_batch_f32(c_paths, n, c_outs, c_caps, c_sizes,
                                num_threads)
    out = []
    for i, (b, m) in enumerate(zip(bufs, metas)):
        if c_sizes[i] != m[0]:
            raise IOError(f"native batch read failed: {paths[i]}")
        out.append(b.reshape(m[1]))
    return out


def _apply_f32(fn, x: np.ndarray, mu: float) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    y = np.empty_like(x)
    fn(_f32p(x), _f32p(y), x.size, mu)
    return y


def mulaw(x: np.ndarray, mu: float = 255.0) -> np.ndarray:
    lib = _load()
    if lib is None:
        from ..ops.mulaw import mulaw as np_mulaw
        return np.asarray(np_mulaw(np.asarray(x, np.float32), mu))
    return _apply_f32(lib.taco_mulaw, x, mu)


def inv_mulaw(y: np.ndarray, mu: float = 255.0) -> np.ndarray:
    lib = _load()
    if lib is None:
        from ..ops.mulaw import inv_mulaw as np_inv
        return np.asarray(np_inv(np.asarray(y, np.float32), mu))
    return _apply_f32(lib.taco_inv_mulaw, y, mu)


def mulaw_quantize(x: np.ndarray, mu: float = 255.0) -> np.ndarray:
    lib = _load()
    if lib is None:
        from ..ops.mulaw import mulaw_quantize as np_q
        return np.asarray(np_q(np.asarray(x, np.float32), mu)).astype(
            np.int32)
    x = np.ascontiguousarray(x, np.float32)
    y = np.empty(x.shape, np.int32)
    lib.taco_mulaw_quantize(
        _f32p(x), y.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), x.size,
        mu)
    return y


def write_wav_pcm16(path: str, wav: np.ndarray, sr: int,
                    normalize: bool = True) -> None:
    lib = _load()
    if lib is None:
        from ..data.audio import save_wav
        save_wav(wav, path, sr)
        return
    wav = np.ascontiguousarray(wav, np.float32)
    if lib.taco_wav_write_pcm16(path.encode(), _f32p(wav), wav.size, sr,
                                1 if normalize else 0) != 0:
        raise IOError(f"native wav write failed: {path}")


def read_wav_pcm16(path: str):
    """(float32 wav in [-1, 1], sample rate)."""
    lib = _load()
    if lib is None:
        from scipy.io import wavfile
        sr, data = wavfile.read(path)
        return data.astype(np.float32) / 32768.0, sr
    sr = ctypes.c_int32()
    n = lib.taco_wav_read_pcm16(path.encode(), None, 0, ctypes.byref(sr))
    if n < 0:
        raise IOError(f"native wav read failed: {path}")
    out = np.empty(n, np.float32)
    if lib.taco_wav_read_pcm16(path.encode(), _f32p(out), n,
                               ctypes.byref(sr)) != n:
        raise IOError(f"native wav read failed: {path}")
    return out, sr.value
