"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The host C++ runtime (`csrc/<name>.cc`, the data-IO library) builds alike
with the host compiler (`build_host`), with the JAX package's
native/Makefile flags; as those take -march=native, its hash also covers
the host CPU.

No PyTorch headers, no `torch.utils.cpp_extension`, no ninja: a build takes
seconds. The output lands in `tacotron2_tpu_torch/_build/` (git-ignored),
keyed by a hash of the sources and flags, so an unchanged kernel is built
once per checkout. `build(names)` starts one nvcc per source at once and
waits for all of them. Nothing here runs at import time; the CPU tests
never call it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared", "-pthread"]

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    """nvcc on PATH, else under $CUDA_HOME, else the toolkit's usual home."""
    homes = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    cands = [shutil.which("nvcc")] + [os.path.join(h, "bin", "nvcc")
                                      for h in homes if h]
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def cxx_path() -> str | None:
    """The host C++ compiler ($CXX, else g++ or c++ on PATH), or None."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    return None


def _host_cpu() -> str:
    """The machine and its CPU's model and feature flags, which
    -march=native compiles for: a checkout that moves to another CPU
    rebuilds the host library rather than loading one that may use
    instructions that CPU lacks."""
    info = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    info.append(line.strip())
                if line.strip() == "" and len(info) > 1:
                    break       # the first processor's entry
    except OSError:
        info.append(platform.processor())
    return "\n".join(info)


def _lib_path(name: str, host: bool = False) -> str:
    flags = CXX_FLAGS if host else NVCC_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    if host:
        h.update(_host_cpu().encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.{'cc' if host else 'cu'}" or (
                not host and fn.endswith(".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_host(name: str) -> str:
    """Compile `csrc/<name>.cc` with the host C++ compiler unless it is
    built already; returns the library's path. Raises with the compiler's
    output where it fails, or where there is no compiler."""
    path = _lib_path(name, host=True)
    if os.path.exists(path):
        return path
    cxx = cxx_path()
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    p = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp,
                        os.path.join(CSRC, f"{name}.cc")],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    build_logs[name] = p.stdout
    if p.returncode != 0:
        raise RuntimeError(f"host build of {name}.cc failed (rc "
                           f"{p.returncode}):\n{p.stdout}")
    os.replace(tmp, path)
    return path


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, all nvcc
    processes at once. Returns {name: library path}; raises with nvcc's
    output if any build fails."""
    names = list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n in names:
        if os.path.exists(paths[n]):
            continue
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (p, tmp) in procs.items():
        out, _ = p.communicate()
        build_logs[n] = out
        if p.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (rc {p.returncode})\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(build([name])[name])
    return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
