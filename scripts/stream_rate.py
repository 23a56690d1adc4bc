"""How fast one SM of a 16-CTA cluster draws a weight stream from L2, by
the way it asks: the decode kernels' question (csrc/decoder_rows.cu and
decoder_bwd.cu stream each step's weight tiles through a ring of 32 KB
chunks in shared memory). Each of 16 CTAs streams its own 2.25 MB slice
(the serve decode's share of the bf16 LSTM weights at CS 16, ~36 MB in
all, so the slices stay in the 50 MB L2 after the first pass) REPS times,
every byte read by the 16 compute warps, with a ring of SLOTS chunks:

  tma       one cp.async.bulk of 32 KB a chunk (the kernels' way);
  tma4      four cp.async.bulk of 8 KB a chunk from four producer lanes;
  cpasync   the producer warp's 32 lanes, cp.async.cg of 16 bytes each;
  hybrid    half of each chunk by cp.async.bulk, half by cp.async.cg;
  ldg       no ring: each compute thread loads its 16-byte pieces with
            eight loads in flight.

Each mode runs twice: as 16 independent CTAs, which the card spreads over
its GPCs, and as one cluster of 16 CTAs, which it places in one GPC, as
the decode kernels' clusters are. Prints the card, its power limit and one
JSON line a mode and launch with the µs a pass and the GB/s an SM. Needs
one CUDA device and nvcc:

    python scripts/stream_rate.py
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTAS, SLICE, REPS, SLOTS = 16, 2326528, 20, 3
MODES = ("tma", "tma4", "cpasync", "hybrid", "ldg")

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
constexpr int NW = 16, NT = NW * 32, NTP = NT + 32, CHUNK = 32768;
constexpr int SLOTS = %(slots)d;
__device__ __forceinline__ uint32_t su(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void wait(uint64_t* b, uint32_t ph) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64"
                 " p, [%%1], %%2;\n selp.u32 %%0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(su(b)), "r"(ph) : "memory");
}
__device__ __forceinline__ void bulk(void* dst, const void* src, int n,
                                     uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%%0], [%%1], %%2, [%%3];" ::"r"(su(dst)), "l"(src), "r"(n),
      "r"(su(bar)) : "memory");
}
__device__ __forceinline__ void expect(uint64_t* bar, int n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%%0], %%1;"
               ::"r"(su(bar)), "r"(n) : "memory");
}
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%%0];" ::"r"(su(bar))
               : "memory");
}
__device__ __forceinline__ void cpasync(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%%0], [%%1], 16;" ::"r"(su(dst)),
               "l"(src) : "memory");
}
// mode 0 tma, 1 tma4, 2 cpasync, 3 hybrid, 4 ldg
__device__ __forceinline__ void body(const unsigned char* src,
                                     long long slice, int reps, int mode,
                                     float* sink) {
  extern __shared__ __align__(128) unsigned char sm[];
  uint64_t* full = (uint64_t*)sm;
  uint64_t* empty = full + 8;
  unsigned char* slots = sm + 128;
  const unsigned char* mine = src + (size_t)blockIdx.x * slice;
  const int nch = (int)(slice / CHUNK), tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long total = (long long)reps * nch;
  float acc = 0.f;
  if (mode == 4) {
    if (warp < NW) {
      const int n16 = (int)(slice / 16);
      for (int r = 0; r < reps; ++r)
        for (int i = tid; i < n16; i += 8 * NT) {
          uint4 v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            v[u] = i + u * NT < n16
                       ? __ldcg((const uint4*)mine + i + u * NT)
                       : make_uint4(0, 0, 0, 0);
#pragma unroll
          for (int u = 0; u < 8; ++u) acc += __uint_as_float(v[u].x & 1u);
        }
    }
    if (acc == 12345.f) sink[0] = acc;
    return;
  }
  if (tid == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%%0], %%1;" ::"r"(
          su(full + s)), "r"(mode == 2 || mode == 3 ? 33 : 1));
      asm volatile("mbarrier.init.shared::cta.b64 [%%0], %%1;" ::"r"(
          su(empty + s)), "r"(NW));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == NW) {  // the producer
    for (long long q = 0; q < total; ++q) {
      const int s = (int)(q %% SLOTS);
      if (q >= SLOTS) wait(empty + s, (uint32_t)((q / SLOTS - 1) & 1));
      const unsigned char* g = mine + (size_t)(q %% nch) * CHUNK;
      unsigned char* d = slots + (size_t)s * CHUNK;
      if (mode == 0) {
        if (lane == 0) {
          expect(full + s, CHUNK);
          bulk(d, g, CHUNK, full + s);
        }
      } else if (mode == 1) {
        if (lane == 0) expect(full + s, CHUNK);
        __syncwarp();
        if (lane < 4) bulk(d + lane * 8192, g + lane * 8192, 8192, full + s);
      } else {
        // cp.async.cg by the warp: all of it (2) or its second half (3)
        const int off = mode == 3 ? CHUNK / 2 : 0;
        if (mode == 3 && lane == 0) {
          expect(full + s, CHUNK / 2);
          bulk(d, g, CHUNK / 2, full + s);
        }
        for (int i = off + lane * 16; i < CHUNK; i += 512)
          cpasync(d + i, g + i);
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%%0];"
                     ::"r"(su(full + s)) : "memory");
        if (lane == 0 && mode == 2) arrive(full + s);
      }
      __syncwarp();
    }
    return;
  }
  for (long long q = 0; q < total; ++q) {
    const int s = (int)(q %% SLOTS);
    wait(full + s, (uint32_t)((q / SLOTS) & 1));
    const uint4* p = (const uint4*)(slots + (size_t)s * CHUNK) + warp * 128;
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = p[u * 32 + lane];
    __syncwarp();
    if (lane == 0) arrive(empty + s);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc += __uint_as_float(v[u].x & 1u);
  }
  if (acc == 12345.f) sink[0] = acc;
}
__global__ void __launch_bounds__(NTP, 1)
    spread(const unsigned char* src, long long slice, int reps, int mode,
           float* sink) {
  body(src, slice, reps, mode, sink);
}
__global__ void __cluster_dims__(16, 1, 1) __launch_bounds__(NTP, 1)
    cluster16(const unsigned char* src, long long slice, int reps, int mode,
              float* sink) {
  body(src, slice, reps, mode, sink);
}
extern "C" int launch(const void* src, long long slice, int reps, int mode,
                      void* sink, int ctas, int cluster, void* stream) {
  const int smem = 128 + SLOTS * CHUNK;
  void (*k)(const unsigned char*, long long, int, int, float*) =
      cluster ? cluster16 : spread;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && cluster)
    e = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  k<<<ctas, NTP, smem, (cudaStream_t)stream>>>(
      (const unsigned char*)src, slice, reps, mode, (float*)sink);
  return (int)cudaGetLastError();
}
"""


def main():
    sys.path.insert(0, REPO)
    import torch

    from tacotron2_tpu_torch.native import build
    tmp = tempfile.mkdtemp()
    cu, so = os.path.join(tmp, "stream.cu"), os.path.join(tmp, "stream.so")
    with open(cu, "w") as f:
        f.write(SRC % {"slots": SLOTS})
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.launch.argtypes = [vp, cl, ci, ci, vp, ci, ci, vp]
    lib.launch.restype = ci
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src = torch.randint(0, 255, (CTAS * SLICE,), dtype=torch.uint8,
                        device="cuda")
    sink = torch.zeros(1, device="cuda")
    st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for cluster, mode in [(c, m) for c in (0, 1) for m in range(len(MODES))]:
        name = MODES[mode]
        run = lambda reps: lib.launch(ctypes.c_void_p(src.data_ptr()), SLICE,
                                      reps, mode,
                                      ctypes.c_void_p(sink.data_ptr()), CTAS,
                                      cluster, st)
        assert run(2) == 0, name
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        assert run(REPS) == 0
        e1.record()
        torch.cuda.synchronize()
        us = 1e3 * e0.elapsed_time(e1) / REPS
        print(json.dumps({"mode": name, "cluster": bool(cluster),
                          "slots": SLOTS, "ctas": CTAS,
                          "bytes_a_cta_a_pass": SLICE, "us_a_pass": us,
                          "gb_s_an_sm": SLICE / us / 1e3}), flush=True)


if __name__ == "__main__":
    main()
