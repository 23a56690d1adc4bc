// Shared device helpers for the port's CUDA kernels (decoder.cu and the
// sampler's head in sampler.cu; the 3xTF32 split of griffin_lim.cu,
// wavenet_train.cu and sampler.cu; the weight stream of decoder_bwd.cu and
// decoder_rows.cu).
//
// The decoder is a latency-bound loop of matrix-vector products: each
// batch row walks every decode step inside one cluster, with its state in
// shared memory and the weights read from global memory (they stay
// resident in the 50 MB L2 across steps). `matvec` spreads the
// output columns over the CTA in 16-byte vectors and splits the reduction
// dimension over the remaining threads, then sums the splits through
// shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace taco {

template <typename W>
struct Pack;

// 16 bytes of weights: `Raw` is what one load brings in, `cvt` widens it
// to V floats.
template <>
struct Pack<float> {
  static constexpr int V = 4;
  using Raw = float4;
  __device__ __forceinline__ static Raw ld(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static void cvt(const Raw& q, float* v) {
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  using Raw = uint4;
  __device__ __forceinline__ static Raw ld(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void cvt(const Raw& q, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// v rounded to bf16 (to nearest even) and back to f32.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The product loop issues DEPTH weight loads per thread before it
// consumes the first, which is what hides the latency of L2 in these
// one-row-at-a-time products; DEPTH trades registers for bytes in flight.

// out[n] = bias[n] + sum_k x[k] * w[k * ld + n] for n < N (ld 0: N).
// w: [K, ld] row-major in global memory, N % V == 0, N / V <= blockDim.x,
// rows aligned to P's load. x, out, part: shared memory; part holds
// blockDim.x * V floats; out must not alias x. Every thread of the block
// must call it; it ends with __syncthreads().
template <int DEPTH, typename W, typename P = Pack<W>>
__device__ void matvec(const W* __restrict__ w, const float* __restrict__ bias,
                       const float* x, int K, int N, float* out,
                       float* part, int ld = 0) {
  constexpr int V = P::V;
  const size_t st = ld ? ld : N;
  const int groups = N / V;
  const int splits = blockDim.x / groups;
  const int g = threadIdx.x % groups;
  const int s = threadIdx.x / groups;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (s < splits) {
    const W* col = w + g * V;
    int k = s;
    for (; k + (DEPTH - 1) * splits < K; k += DEPTH * splits) {
      typename P::Raw raw[DEPTH];
#pragma unroll
      for (int j = 0; j < DEPTH; ++j)
        raw[j] = P::ld(col + (k + j * splits) * st);
#pragma unroll
      for (int j = 0; j < DEPTH; ++j) {
        float wv[V];
        P::cvt(raw[j], wv);
        const float xk = x[k + j * splits];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(xk, wv[i], acc[i]);
      }
    }
    if (k < K) {  // fewer than DEPTH rows left: one predicated batch, so
                  // their loads are in flight together too
      typename P::Raw raw[DEPTH];
#pragma unroll
      for (int j = 0; j < DEPTH; ++j) {
        const int kj = k + j * splits;
        raw[j] = kj < K ? P::ld(col + kj * st) : typename P::Raw{};
      }
#pragma unroll
      for (int j = 0; j < DEPTH; ++j) {
        const int kj = k + j * splits;
        if (kj < K) {
          float wv[V];
          P::cvt(raw[j], wv);
          const float xk = x[kj];
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(xk, wv[i], acc[i]);
        }
      }
    }
  }
  // Narrow products split the reduction many ways; when a warp holds
  // several splits of each column group, add them with shuffles first so
  // that one partial per warp, not per split, goes through shared memory.
  int nparts = splits;
  if (groups < 32 && 32 % groups == 0) {  // then every thread is in a split
#pragma unroll
    for (int i = 0; i < V; ++i)
      for (int off = groups; off < 32; off <<= 1)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    const int lane = threadIdx.x & 31;
    if (lane < groups) {
#pragma unroll
      for (int i = 0; i < V; ++i)
        part[(threadIdx.x >> 5) * N + g * V + i] = acc[i];
    }
    nparts = blockDim.x >> 5;
  } else if (s < splits) {
#pragma unroll
    for (int i = 0; i < V; ++i) part[s * N + g * V + i] = acc[i];
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float sum = bias ? bias[n] : 0.f;
    for (int j = 0; j < nparts; ++j) sum += part[j * N + n];
    out[n] = sum;
  }
  __syncthreads();
}

// Split x into two TF32 values with x ≈ hi + lo (hi keeps 10 mantissa
// bits, lo the next 11): the products hi·hi + hi·lo + lo·hi on tensor
// cores ("3xTF32"; lo·lo, ~2^-22 of the product, is dropped).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// d += a · b for one 16×8×8 TF32 tile, f32 accumulation (mma.sync; the
// fragment layouts are those of the PTX ISA for m16n8k8 .tf32).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a · b in f32 from split operands: the three TF32 products go into a
// zeroed fragment that f32 adds (round to nearest) add to d; summed in the
// tensor cores, whose accumulation truncates, long sums drift.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(part, al, bh);
  mma_tf32(part, ah, bl);
  mma_tf32(part, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += part[e];
}

// ------------------------------------------------------ weight streams
//
// The cluster kernels that share each weight tile between 8 rows
// (decoder_bwd.cu, decoder_rows.cu) take their weights as a stream of mma
// A-fragment tiles (512 bytes a 16-row tile, 16 bytes a lane; a product's
// m-tiles in groups of kStreamWarps, one a warp; kStreamKC k-tiles a warp
// in each kChunk-byte chunk), and multiply them by the 8 rows in k-steps
// (`Step`).
constexpr int kStreamWarps = 16;
constexpr int kStreamKC = 4;
constexpr int kTile = 512;
constexpr int kChunk = kStreamWarps * kStreamKC * kTile;

// (not volatile: no side effects, so independent k-steps may interleave)
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32_1688(float* d, const uint32_t* a,
                                              const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step of a warp: `load` takes the lane's A fragment (16 × KS) and
// brings B = rows n of G (pitch gp), columns k0 .. k0 + KS, into registers;
// `run` gives their product in d, from zero.
template <typename W>
struct Step;

template <>
struct Step<__nv_bfloat16> {
  static constexpr int KS = 16;
  struct Frag {
    uint32_t a[4], b[2];
  };
  __device__ __forceinline__ static void load(Frag& f, const uint4& v,
                                              const __nv_bfloat16* G, int gp,
                                              int k0, int g, int t) {
    f.a[0] = v.x;
    f.a[1] = v.y;
    f.a[2] = v.z;
    f.a[3] = v.w;
    const __nv_bfloat16* p = G + g * gp + k0 + 2 * t;
    f.b[0] = *reinterpret_cast<const uint32_t*>(p);
    f.b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
  }
  __device__ __forceinline__ static void run(float* d, const Frag& f) {
    d[0] = d[1] = d[2] = d[3] = 0.f;
    mma_bf16_16816(d, f.a, f.b);
  }
};

template <>
struct Step<float> {
  static constexpr int KS = 8;
  struct Frag {
    uint4 a;
    float b[2];
  };
  __device__ __forceinline__ static void load(Frag& f, const uint4& v,
                                              const float* G, int gp, int k0,
                                              int g, int t) {
    f.a = v;
    const float* p = G + g * gp + k0 + t;
    f.b[0] = p[0];
    f.b[1] = p[4];
  }
  // three TF32 products, each from zero, added in f32: (lo·hi + hi·lo) +
  // hi·hi
  __device__ __forceinline__ static void run(float* d, const Frag& f) {
    uint32_t bh[2], bl[2], ah[4], al[4];
    split_tf32(f.b[0], bh[0], bl[0]);
    split_tf32(f.b[1], bh[1], bl[1]);
    split_tf32(__uint_as_float(f.a.x), ah[0], al[0]);
    split_tf32(__uint_as_float(f.a.y), ah[1], al[1]);
    split_tf32(__uint_as_float(f.a.z), ah[2], al[2]);
    split_tf32(__uint_as_float(f.a.w), ah[3], al[3]);
    float p1[4] = {0.f, 0.f, 0.f, 0.f}, p2[4] = {0.f, 0.f, 0.f, 0.f};
    d[0] = d[1] = d[2] = d[3] = 0.f;
    mma_tf32_1688(p1, al, bh);
    mma_tf32_1688(p2, ah, bl);
    mma_tf32_1688(d, ah, bh);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += p1[e] + p2[e];
  }
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions; `red` is 32 floats of shared memory. Every thread
// gets the result. blockDim.x must be a multiple of 32.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : -INFINITY;
    v = warp_max(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

// Index of the largest value, the smallest index among equals (argmax
// semantics of torch/jnp). `red` is 32 floats, `ired` 32 ints.
__device__ int block_argmax(float v, int idx, float* red, int* ired) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
  if (lane == 0) {
    red[warp] = v;
    ired[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    const bool ok = lane < (int)(blockDim.x >> 5);
    v = ok ? red[lane] : -INFINITY;
    idx = ok ? ired[lane] : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
      if (ov > v || (ov == v && oi < idx)) {
        v = ov;
        idx = oi;
      }
    }
    if (lane == 0) ired[0] = idx;
  }
  __syncthreads();
  const int r = ired[0];
  __syncthreads();
  return r;
}

}  // namespace taco
