// WaveNet training stack: the gated residual layers' forward (kernel 5a)
// and backward (kernel 5b) for Hopper (sm_90a).
//
// Replaces tacotron2_tpu/ops/wavenet_train_kernel.py: `_build_stack_fwd`
// (:133, pallas_call :252) and `_build_stack_bwd` (:261, pallas_call
// :465). Activations live as [N = T·B, channels] with row = t·B + b, so a
// dilation shift of d samples is a shift of d·B rows and each tap of the
// dilated conv is a row-shifted product.
//
// What bounds it on this card. At the r5 shapes (N 128,000, R 128, G 256,
// S 128, cin 80, 20 layers) the forward is ~776 GFLOP of bf16 products
// (0.78 ms at 989 TFLOP/s) against ~2 GB of bytes (0.6 ms at 3.35 TB/s),
// the backward twice the products: both are bound by operations.
//
// Design (a first, simple kernel; wgmma and TMA are later work):
// - The TPU version splits the stack in two halves and carries halos of
//   each layer's input across sequential time tiles, only to fit VMEM.
//   Here every layer is its own launch over independent 128-row tiles: the
//   launch boundary makes a layer's output whole before the next reads
//   its taps, and every tap row is read from global memory (rows before
//   t = 0 read zeros, the causal pad; no halo carries). N need not be a
//   multiple of the tile: the last tile masks its rows.
// - Products take bf16 operands with f32 sums (mma.sync m16n8k16), as the
//   MXU's preferred_element_type=f32. Operands are rounded to bf16 where
//   the TPU kernel rounds them: the dropped-out input of the taps, the
//   conditioning, h = tanh·σ before the skip and out products; in the
//   backward c_res·dres, the scaled skip gradient, the gate gradient dy
//   and the dropped-out input before their products.
// - Dropout is a counter-based hash of (seed, layer, row, channel)
//   (`keep_bit`), the same function as the plain version in
//   ops/wavenet_train_kernel.py, regenerated in the backward, never
//   stored. Its bits do not depend on the tile.
// - The forward saves x (before dropout), tanh a and σ b in bf16, one
//   [3, N, R] block a layer; the backward recomputes h from them.
// - The backward runs per layer (top down): `bwd_gate` (dh, the gate
//   gradients dy, the conditioning gradient and the bias sums), `bwd_dx`
//   (the tap transposes dxd[t] = Σ_k dy[t + (2-k)d]·W_kᵀ, dropout, the
//   residual path) and `wgrad` for every weight gradient: Σ over rows of
//   Pᵀ·Q, the conv's in the reindexed form dW_k = Σ_t xd[t]·dy[t+(2-k)d].
//   All reductions over rows are per-CTA partials summed in a fixed order
//   by a second launch: no float atomics, so a rerun is bit-exact.
// - No software barrier across CTAs; no library call.

#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int C = 128;    // residual channels
constexpr int G = 256;    // gate channels
constexpr int CH = 128;   // gated channels (G / 2)
constexpr int SK = 128;   // skip channels
constexpr int CI = 80;    // conditioning channels
constexpr int TM = 128;   // rows per tile
constexpr int LDA = 136;  // shared row stride (bf16) of a 128-deep operand
constexpr int LDW = 264;  // of a 256-deep operand
constexpr int THREADS = 512;
constexpr int PW = G + C + SK;  // bias-sum partials a tile: dy | dres | dsk

constexpr int FWD_SMEM = (TM * LDA + G * LDA) * 2;
constexpr int GATE_SMEM = (TM * LDW + CH * LDW) * 2 + 2 * 256 * 4;
constexpr int DX_SMEM = (TM * LDW + C * LDW) * 2;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Dropout keep bit of (layer key, row, channel): the plain version's
// `keep_bits` (ops/wavenet_train_kernel.py) bit for bit.
__device__ __forceinline__ bool keep_bit(uint32_t key, long long row, int c,
                                         uint32_t keep24) {
  const uint32_t k = (uint32_t)((unsigned long long)row * C + c);
  uint32_t v = fmix32(k ^ key);
  v = fmix32(v + key);
  return (v >> 8) < keep24;
}

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 rows from m0, 16 deep from k0) of a row-major [rows][ld]
// bf16 tile in shared memory.
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* A, int ld,
                                       int m0, int k0, int grp, int tig) {
  const bf16* p = A + (m0 + grp) * ld + k0 + 2 * tig;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment (8 columns from n0, 16 deep from k0) of Bᵀ stored [n][ld].
__device__ __forceinline__ void frag_b(uint32_t* b, const bf16* Bt, int ld,
                                       int n0, int k0, int grp, int tig) {
  const bf16* p = Bt + (n0 + grp) * ld + k0 + 2 * tig;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint2 pack4(float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 r;
  r.x = *reinterpret_cast<uint32_t*>(&lo);
  r.y = *reinterpret_cast<uint32_t*>(&hi);
  return r;
}

// ----------------------------------------------------------------- forward

struct FwdArgs {
  const float* x_in;    // [N, C] block input (f32)
  float* x_out;         // [N, C] block output, or null (the last layer)
  const bf16* cb;       // [N, CI] conditioning, bf16
  bf16* acts;           // [3, N, C]: x, tanh a, sigmoid b
  float* skip;          // [N, SK] running skip sum
  const bf16* w1t;      // [G, 3C + CI]: taps 0..2 and cin, transposed
  const float* b1;      // [G] conv bias + cin bias
  const bf16* w2t;      // [SK + C, CH]: skip | out, transposed
  const float* skip_b;  // [SK]
  const float* out_b;   // [C]
  long long N;
  int B, d;
  uint32_t key, keep24;
  float inv_keep, scale, c_res;
  int drop, first;
};

__global__ void __launch_bounds__(THREADS, 1) fwd_layer_kernel(FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [TM][LDA]
  bf16* Bs = As + TM * LDA;                  // [G][LDA]
  const long long r0 = (long long)blockIdx.x * TM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wr = warp >> 3, wc = warp & 7;
  constexpr int KT = 3 * C + CI;
  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  for (int q = 0; q < 4; ++q) {
    const int K = q < 3 ? C : CI;
    if (q < 3) {  // tap q: rows t - (2-q)d, dropped out, rounded to bf16
      const long long shift = (long long)(2 - q) * a.d * a.B;
      for (int u = threadIdx.x; u < TM * C / 4; u += THREADS) {
        const int i = u / (C / 4), c4 = (u % (C / 4)) * 4;
        const long long row = r0 + i, src = row - shift;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (row < a.N && src >= 0) {
          const float4 x =
              *reinterpret_cast<const float4*>(a.x_in + src * C + c4);
          v[0] = x.x;
          v[1] = x.y;
          v[2] = x.z;
          v[3] = x.w;
          if (q == 2)  // the saved x, before dropout
            *reinterpret_cast<uint2*>(a.acts + row * C + c4) =
                pack4(v[0], v[1], v[2], v[3]);
          if (a.drop) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[e] = keep_bit(a.key, src, c4 + e, a.keep24)
                         ? v[e] * a.inv_keep : 0.f;
          }
        }
        *reinterpret_cast<uint2*>(As + i * LDA + c4) =
            pack4(v[0], v[1], v[2], v[3]);
      }
    } else {  // the conditioning of the tile's own rows
      for (int u = threadIdx.x; u < TM * CI / 8; u += THREADS) {
        const int i = u / (CI / 8), c8 = (u % (CI / 8)) * 8;
        const long long row = r0 + i;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row < a.N)
          v = *reinterpret_cast<const uint4*>(a.cb + row * CI + c8);
        *reinterpret_cast<uint4*>(As + i * LDA + c8) = v;
      }
    }
    for (int u = threadIdx.x; u < G * (K / 8); u += THREADS) {
      const int g = u / (K / 8), k8 = (u % (K / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + g * LDA + k8) =
          *reinterpret_cast<const uint4*>(a.w1t + (size_t)g * KT + q * C +
                                          k8);
    }
    __syncthreads();
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        frag_a(af[m], As, LDA, 64 * wr + 16 * m, k0, grp, tig);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // j 0, 1: the tanh half's columns; 2, 3: the matching sigmoid
        // columns, so each thread holds a and b of the same channels
        const int n0 = (j < 2 ? 0 : CH) + 16 * wc + 8 * (j & 1);
        uint32_t bfr[2];
        frag_b(bfr, Bs, LDA, n0, k0, grp, tig);
#pragma unroll
        for (int m = 0; m < 4; ++m) mma16816(acc[m][j], af[m], bfr);
      }
    }
    __syncthreads();
  }

  // gate: tanh a, sigmoid b saved; h = tanh a · sigmoid b, bf16, into As
  bf16* acts_t = a.acts + a.N * C;
  bf16* acts_s = a.acts + 2 * a.N * C;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int rl = 64 * wr + 16 * m + grp + 8 * h2;
        const int col = 16 * wc + 8 * j + 2 * tig;
        const long long row = r0 + rl;
        const float t0 = tanhf(acc[m][j][2 * h2] + a.b1[col]);
        const float t1 = tanhf(acc[m][j][2 * h2 + 1] + a.b1[col + 1]);
        const float s0 = taco::sigmoidf(acc[m][j + 2][2 * h2] + a.b1[CH + col]);
        const float s1 =
            taco::sigmoidf(acc[m][j + 2][2 * h2 + 1] + a.b1[CH + col + 1]);
        if (row < a.N) {
          *reinterpret_cast<__nv_bfloat162*>(acts_t + row * C + col) =
              __floats2bfloat162_rn(t0, t1);
          *reinterpret_cast<__nv_bfloat162*>(acts_s + row * C + col) =
              __floats2bfloat162_rn(s0, s1);
        }
        *reinterpret_cast<__nv_bfloat162*>(As + rl * LDA + col) =
            __floats2bfloat162_rn(t0 * s0, t1 * s1);
      }
  for (int u = threadIdx.x; u < (SK + C) * (CH / 8); u += THREADS) {
    const int n = u / (CH / 8), k8 = (u % (CH / 8)) * 8;
    *reinterpret_cast<uint4*>(Bs + n * LDA + k8) =
        *reinterpret_cast<const uint4*>(a.w2t + n * CH + k8);
  }
  __syncthreads();

  // [skip | out] = h · [W_skip | W_out]
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  for (int k0 = 0; k0 < CH; k0 += 16) {
    uint32_t af[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      frag_a(af[m], As, LDA, 64 * wr + 16 * m, k0, grp, tig);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bfr[2];
      frag_b(bfr, Bs, LDA, 32 * wc + 8 * j, k0, grp, tig);
#pragma unroll
      for (int m = 0; m < 4; ++m) mma16816(acc[m][j], af[m], bfr);
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const long long row = r0 + 64 * wr + 16 * m + grp + 8 * h2;
        const int col = 32 * wc + 8 * j + 2 * tig;
        if (row >= a.N) continue;
        const float v0 = acc[m][j][2 * h2], v1 = acc[m][j][2 * h2 + 1];
        if (col < SK) {
          float2* sp = reinterpret_cast<float2*>(a.skip + row * SK + col);
          float2 s = a.first ? make_float2(0.f, 0.f) : *sp;
          s.x = s.x + a.scale * (v0 + a.skip_b[col]);
          s.y = s.y + a.scale * (v1 + a.skip_b[col + 1]);
          *sp = s;
        } else if (a.x_out) {
          const int cc = col - SK;
          const float2 x =
              *reinterpret_cast<const float2*>(a.x_in + row * C + cc);
          *reinterpret_cast<float2*>(a.x_out + row * C + cc) = make_float2(
              a.c_res * (v0 + a.out_b[cc] + x.x),
              a.c_res * (v1 + a.out_b[cc + 1] + x.y));
        }
      }
}

// ---------------------------------------------------------------- backward

struct GateArgs {
  const float* dres;   // [N, C] gradient of the block output, or null (0)
  const float* dskip;  // [N, SK]
  const bf16* acts;    // [3, N, C] of this layer
  const bf16* wos;     // [CH, C + SK]: out | skip, as stored
  const bf16* wcin;    // [CI, G]
  bf16* go;            // [N, C + SK]: bf16(c_res·dres) | bf16(scale·dskip)
  bf16* dy;            // [N, G]: bf16(da) | bf16(db)
  bf16* xd;            // [N, C]: bf16(x · dropout multiplier)
  bf16* h;             // [N, CH]: bf16(tanh a · sigmoid b)
  float* dc;           // [N, CI] conditioning gradient, summed over layers
  float* part;         // [tiles, PW] per-tile column sums
  long long N;
  uint32_t key, keep24;
  float inv_keep, scale, c_res;
  int drop, acc_dc;
};

__global__ void __launch_bounds__(THREADS, 1) bwd_gate_kernel(GateArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [TM][LDW]: go, then dy
  bf16* Bs = As + TM * LDW;                  // [CH][LDW]: wos, then wcin
  float* red = reinterpret_cast<float*>(Bs + CH * LDW);  // [2][256]
  const long long r0 = (long long)blockIdx.x * TM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wr = warp >> 3, wc = warp & 7;
  float* part = a.part + (size_t)blockIdx.x * PW;

  {  // the product's left operand [c_res·dres | scale·dskip] and its sums
    const int j = threadIdx.x & 255, half = threadIdx.x >> 8;
    float sum = 0.f;
    for (int i = 64 * half; i < 64 * half + 64; ++i) {
      const long long row = r0 + i;
      float v = 0.f;
      if (row < a.N)
        v = j < C ? (a.dres ? a.c_res * a.dres[row * C + j] : 0.f)
                  : a.scale * a.dskip[row * SK + j - C];
      const bf16 bv = __float2bfloat16(v);
      As[i * LDW + j] = bv;
      if (row < a.N) a.go[row * (C + SK) + j] = bv;
      sum += v;
    }
    red[half * 256 + j] = sum;
  }
  for (int u = threadIdx.x; u < CH * ((C + SK) / 8); u += THREADS) {
    const int n = u / ((C + SK) / 8), k8 = (u % ((C + SK) / 8)) * 8;
    *reinterpret_cast<uint4*>(Bs + n * LDW + k8) =
        *reinterpret_cast<const uint4*>(a.wos + n * (C + SK) + k8);
  }
  const bf16* ax = a.acts;
  const bf16* at = a.acts + a.N * C;
  const bf16* as = a.acts + 2 * a.N * C;
  for (int u = threadIdx.x; u < TM * C / 8; u += THREADS) {
    const int i = u / (C / 8), c8 = (u % (C / 8)) * 8;
    const long long row = r0 + i;
    if (row >= a.N) continue;
    const uint4 qx = *reinterpret_cast<const uint4*>(ax + row * C + c8);
    const uint4 qt = *reinterpret_cast<const uint4*>(at + row * C + c8);
    const uint4 qs = *reinterpret_cast<const uint4*>(as + row * C + c8);
    const bf16* px = reinterpret_cast<const bf16*>(&qx);
    const bf16* pt = reinterpret_cast<const bf16*>(&qt);
    const bf16* ps = reinterpret_cast<const bf16*>(&qs);
    float xv[8], hv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      xv[e] = bf(px[e]);
      if (a.drop)
        xv[e] = xv[e] * (keep_bit(a.key, row, c8 + e, a.keep24) ? a.inv_keep
                                                                : 0.f);
      hv[e] = bf(pt[e]) * bf(ps[e]);
    }
    uint4 ox, oh;
    uint2 t = pack4(xv[0], xv[1], xv[2], xv[3]);
    ox.x = t.x;
    ox.y = t.y;
    t = pack4(xv[4], xv[5], xv[6], xv[7]);
    ox.z = t.x;
    ox.w = t.y;
    t = pack4(hv[0], hv[1], hv[2], hv[3]);
    oh.x = t.x;
    oh.y = t.y;
    t = pack4(hv[4], hv[5], hv[6], hv[7]);
    oh.z = t.x;
    oh.w = t.y;
    *reinterpret_cast<uint4*>(a.xd + row * C + c8) = ox;
    *reinterpret_cast<uint4*>(a.h + row * CH + c8) = oh;
  }
  __syncthreads();
  if (threadIdx.x < 256)
    part[G + threadIdx.x] = red[threadIdx.x] + red[256 + threadIdx.x];

  // dh = bf16(c_res·dres)·W_outᵀ + bf16(scale·dskip)·W_skipᵀ
  float acc[4][2][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  for (int k0 = 0; k0 < C + SK; k0 += 16) {
    uint32_t af[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      frag_a(af[m], As, LDW, 64 * wr + 16 * m, k0, grp, tig);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t bfr[2];
      frag_b(bfr, Bs, LDW, 16 * wc + 8 * j, k0, grp, tig);
#pragma unroll
      for (int m = 0; m < 4; ++m) mma16816(acc[m][j], af[m], bfr);
    }
  }

  // gate gradients: acc becomes da, db the sigmoid half's
  float db[4][2][4];
  float sa[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, sbs[2][2] = {{0.f, 0.f},
                                                        {0.f, 0.f}};
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const long long row = r0 + 64 * wr + 16 * m + grp + 8 * h2;
        const int col = 16 * wc + 8 * j + 2 * tig;
        float2 tv = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
        if (row < a.N) {
          tv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(at + row * C + col));
          sv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(as + row * C + col));
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ta = e ? tv.y : tv.x, sb = e ? sv.y : sv.x;
          const float dh = acc[m][j][2 * h2 + e];
          const float da = dh * sb * (1.f - ta * ta);
          const float dbv = dh * ta * sb * (1.f - sb);
          acc[m][j][2 * h2 + e] = da;
          db[m][j][2 * h2 + e] = dbv;
          sa[j][e] += da;
          sbs[j][e] += dbv;
        }
      }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sa[j][e] += __shfl_xor_sync(0xffffffffu, sa[j][e], o);
        sbs[j][e] += __shfl_xor_sync(0xffffffffu, sbs[j][e], o);
      }
  __syncthreads();  // every warp is done with As, Bs and red
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 16 * wc + 8 * j + 2 * tig + e;
        red[wr * 256 + col] = sa[j][e];
        red[wr * 256 + CH + col] = sbs[j][e];
      }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int rl = 64 * wr + 16 * m + grp + 8 * h2;
        const long long row = r0 + rl;
        const int col = 16 * wc + 8 * j + 2 * tig;
        const __nv_bfloat162 va =
            __floats2bfloat162_rn(acc[m][j][2 * h2], acc[m][j][2 * h2 + 1]);
        const __nv_bfloat162 vb =
            __floats2bfloat162_rn(db[m][j][2 * h2], db[m][j][2 * h2 + 1]);
        *reinterpret_cast<__nv_bfloat162*>(As + rl * LDW + col) = va;
        *reinterpret_cast<__nv_bfloat162*>(As + rl * LDW + CH + col) = vb;
        if (row < a.N) {
          *reinterpret_cast<__nv_bfloat162*>(a.dy + row * G + col) = va;
          *reinterpret_cast<__nv_bfloat162*>(a.dy + row * G + CH + col) = vb;
        }
      }
  for (int u = threadIdx.x; u < CI * (G / 8); u += THREADS) {
    const int n = u / (G / 8), k8 = (u % (G / 8)) * 8;
    *reinterpret_cast<uint4*>(Bs + n * LDW + k8) =
        *reinterpret_cast<const uint4*>(a.wcin + n * G + k8);
  }
  __syncthreads();
  if (threadIdx.x < 256)
    part[threadIdx.x] = red[threadIdx.x] + red[256 + threadIdx.x];

  // dc += bf16(dy)·W_cinᵀ: warp w takes rows 16·(w/2), half the columns
  constexpr int NT2 = CI / 16;
  float acc2[NT2][4];
#pragma unroll
  for (int q = 0; q < NT2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[q][e] = 0.f;
  const int mt = warp >> 1, nb = (warp & 1) * NT2;
  for (int k0 = 0; k0 < G; k0 += 16) {
    uint32_t af[4];
    frag_a(af, As, LDW, 16 * mt, k0, grp, tig);
#pragma unroll
    for (int q = 0; q < NT2; ++q) {
      uint32_t bfr[2];
      frag_b(bfr, Bs, LDW, 8 * (nb + q), k0, grp, tig);
      mma16816(acc2[q], af, bfr);
    }
  }
#pragma unroll
  for (int q = 0; q < NT2; ++q)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const long long row = r0 + 16 * mt + grp + 8 * h2;
      const int col = 8 * (nb + q) + 2 * tig;
      if (row >= a.N) continue;
      float2* p = reinterpret_cast<float2*>(a.dc + row * CI + col);
      float2 v = a.acc_dc ? *p : make_float2(0.f, 0.f);
      v.x += acc2[q][2 * h2];
      v.y += acc2[q][2 * h2 + 1];
      *p = v;
    }
}

struct DxArgs {
  const bf16* dy;      // [N, G]
  const bf16* wconv;   // [3, C, G]: the taps' weights, as stored
  const float* dres;   // [N, C] or null (0)
  float* dres_out;     // [N, C]: gradient of the block input
  long long N;
  int B, d;
  uint32_t key, keep24;
  float inv_keep, c_res;
  int drop;
};

__global__ void __launch_bounds__(THREADS, 1) bwd_dx_kernel(DxArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [TM][LDW]
  bf16* Bs = As + TM * LDW;                  // [C][LDW]
  const long long r0 = (long long)blockIdx.x * TM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wr = warp >> 3, wc = warp & 7;
  float acc[4][2][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  for (int k = 0; k < 3; ++k) {
    const long long off = (long long)(2 - k) * a.d * a.B;
    for (int u = threadIdx.x; u < TM * (G / 8); u += THREADS) {
      const int i = u / (G / 8), g8 = (u % (G / 8)) * 8;
      const long long row = r0 + i, src = row + off;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < a.N && src < a.N)
        v = *reinterpret_cast<const uint4*>(a.dy + src * G + g8);
      *reinterpret_cast<uint4*>(As + i * LDW + g8) = v;
    }
    for (int u = threadIdx.x; u < C * (G / 8); u += THREADS) {
      const int n = u / (G / 8), g8 = (u % (G / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + n * LDW + g8) =
          *reinterpret_cast<const uint4*>(a.wconv + ((size_t)k * C + n) * G +
                                          g8);
    }
    __syncthreads();
    for (int k0 = 0; k0 < G; k0 += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        frag_a(af[m], As, LDW, 64 * wr + 16 * m, k0, grp, tig);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bfr[2];
        frag_b(bfr, Bs, LDW, 16 * wc + 8 * j, k0, grp, tig);
#pragma unroll
        for (int m = 0; m < 4; ++m) mma16816(acc[m][j], af[m], bfr);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const long long row = r0 + 64 * wr + 16 * m + grp + 8 * h2;
        const int col = 16 * wc + 8 * j + 2 * tig;
        if (row >= a.N) continue;
        float v[2] = {acc[m][j][2 * h2], acc[m][j][2 * h2 + 1]};
        float2 r = make_float2(0.f, 0.f);
        if (a.dres) {
          r = *reinterpret_cast<const float2*>(a.dres + row * C + col);
          r.x = a.c_res * r.x;
          r.y = a.c_res * r.y;
        }
        if (a.drop) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = v[e] * (keep_bit(a.key, row, col + e, a.keep24)
                               ? a.inv_keep : 0.f);
        }
        *reinterpret_cast<float2*>(a.dres_out + row * C + col) =
            make_float2(r.x + v[0], r.y + v[1]);
      }
}

// part[s, i, j] = Σ_{r in split s} P[r, i]·Q[r + qoff, j] (Q rows past N
// read 0), i < K1 <= 128, j in the block's 128 columns; 256 threads.
constexpr int WK_RK = 32;   // rows a step
constexpr int WK_LD = 40;   // shared stride (bf16): conflict-free fragments

__global__ void __launch_bounds__(256) wgrad_kernel(
    const bf16* __restrict__ P, int ldp, int K1, const bf16* __restrict__ Q,
    int ldq, long long qoff, long long N, long long rows_per, float* part,
    int K2) {
  __shared__ __align__(16) bf16 Ps[128 * WK_LD];  // [i][r]
  __shared__ __align__(16) bf16 Qs[128 * WK_LD];  // [j][r]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wi = warp >> 2, wj = warp & 3;
  const int j0 = blockIdx.x * 128;
  const long long rb0 = (long long)blockIdx.y * rows_per;
  const long long rend = rb0 + rows_per < N ? rb0 + rows_per : N;
  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  for (long long rb = rb0; rb < rend; rb += WK_RK) {
    for (int u = threadIdx.x; u < (WK_RK / 2) * 64; u += 256) {
      const int rp = u >> 6, cp = 2 * (u & 63);
      const long long r = rb + 2 * rp;
      uint32_t p0 = 0, p1 = 0, q0 = 0, q1 = 0;
      if (cp < K1) {
        if (r < rend) p0 = ld32(P + r * ldp + cp);
        if (r + 1 < rend) p1 = ld32(P + (r + 1) * ldp + cp);
      }
      if (r < rend && r + qoff < N) q0 = ld32(Q + (r + qoff) * ldq + j0 + cp);
      if (r + 1 < rend && r + 1 + qoff < N)
        q1 = ld32(Q + (r + 1 + qoff) * ldq + j0 + cp);
      *reinterpret_cast<uint32_t*>(Ps + cp * WK_LD + 2 * rp) =
          __byte_perm(p0, p1, 0x5410);
      *reinterpret_cast<uint32_t*>(Ps + (cp + 1) * WK_LD + 2 * rp) =
          __byte_perm(p0, p1, 0x7632);
      *reinterpret_cast<uint32_t*>(Qs + cp * WK_LD + 2 * rp) =
          __byte_perm(q0, q1, 0x5410);
      *reinterpret_cast<uint32_t*>(Qs + (cp + 1) * WK_LD + 2 * rp) =
          __byte_perm(q0, q1, 0x7632);
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < WK_RK; k0 += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        frag_a(af[m], Ps, WK_LD, 64 * wi + 16 * m, k0, grp, tig);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t bfr[2];
        frag_b(bfr, Qs, WK_LD, 32 * wj + 8 * n, k0, grp, tig);
#pragma unroll
        for (int m = 0; m < 4; ++m) mma16816(acc[m][n], af[m], bfr);
      }
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * 128 * K2;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int i = 64 * wi + 16 * m + grp + 8 * h2;
        const int j = j0 + 32 * wj + 8 * n + 2 * tig;
        if (i < K1)
          *reinterpret_cast<float2*>(out + (size_t)i * K2 + j) =
              make_float2(acc[m][n][2 * h2], acc[m][n][2 * h2 + 1]);
      }
}

// out[i, j] = Σ_s part[s, i, j], s in order.
__global__ void split_sum_kernel(const float* __restrict__ part, int splits,
                                 int K1, int K2, float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= K1 * K2) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * 128 * K2 + idx];
  out[idx] = s;
}

// out[j] = Σ_s part[s, j] over `rows` rows of width W: one block a column,
// a fixed tree.
__global__ void colsum_kernel(const float* __restrict__ part, int rows, int W,
                              float* __restrict__ out) {
  __shared__ float red[32];
  const int j = blockIdx.x;
  float s = 0.f;
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    s += part[(size_t)r * W + j];
  s = taco::block_sum(s, red);
  if (threadIdx.x == 0) out[j] = s;
}

int set_smem() {
  static int done = 0;
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FWD_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bwd_gate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             GATE_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bwd_dx_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DX_SMEM);
  if (e != cudaSuccess) return (int)e;
  done = 1;
  return 0;
}

unsigned tiles(long long N) { return (unsigned)((N + TM - 1) / TM); }

}  // namespace

extern "C" {

// One layer of the forward; `first` starts the skip sum, x_out may be
// null (the last layer's block output is not needed).
int wn_fwd_layer(const void* x_in, void* x_out, const void* cb, void* acts,
                 void* skip, const void* w1t, const void* b1, const void* w2t,
                 const void* skip_b, const void* out_b, long long N, int B,
                 int d, uint32_t key, uint32_t keep24, float inv_keep,
                 int drop, float scale, float c_res, int first,
                 void* stream) {
  int rc = set_smem();
  if (rc) return rc;
  FwdArgs a{(const float*)x_in, (float*)x_out, (const bf16*)cb,
            (bf16*)acts, (float*)skip, (const bf16*)w1t, (const float*)b1,
            (const bf16*)w2t, (const float*)skip_b, (const float*)out_b,
            N, B, d, key, keep24, inv_keep, scale, c_res, drop, first};
  fwd_layer_kernel<<<tiles(N), THREADS, FWD_SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The gate part of one layer's backward, then the tile sums reduced into
// sums[PW] (dy | c_res·dres | scale·dskip).
int wn_bwd_gate(const void* dres, const void* dskip, const void* acts,
                const void* wos, const void* wcin, void* go, void* dy,
                void* xd, void* h, void* dc, void* part, void* sums,
                long long N, uint32_t key, uint32_t keep24, float inv_keep,
                int drop, float scale, float c_res, int acc_dc,
                void* stream) {
  int rc = set_smem();
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  GateArgs a{(const float*)dres, (const float*)dskip, (const bf16*)acts,
             (const bf16*)wos, (const bf16*)wcin, (bf16*)go, (bf16*)dy,
             (bf16*)xd, (bf16*)h, (float*)dc, (float*)part, N, key,
             keep24, inv_keep, scale, c_res, drop, acc_dc};
  bwd_gate_kernel<<<tiles(N), THREADS, GATE_SMEM, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  colsum_kernel<<<PW, 256, 0, st>>>((const float*)part, (int)tiles(N), PW,
                                    (float*)sums);
  return (int)cudaGetLastError();
}

int wn_bwd_dx(const void* dy, const void* wconv, const void* dres,
              void* dres_out, long long N, int B, int d, uint32_t key,
              uint32_t keep24, float inv_keep, int drop, float c_res,
              void* stream) {
  int rc = set_smem();
  if (rc) return rc;
  DxArgs a{(const bf16*)dy, (const bf16*)wconv, (const float*)dres,
           (float*)dres_out, N, B, d, key, keep24, inv_keep, c_res, drop};
  bwd_dx_kernel<<<tiles(N), THREADS, DX_SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// out[K1, K2] = Σ_r P[r, :K1]ᵀ·Q[r + qoff, :K2]; `part` holds
// ceil(N / rows_per) · 128 · K2 floats; K2 % 128 == 0, K1 <= 128.
int wn_wgrad(const void* P, int ldp, int K1, const void* Q, int ldq, int K2,
             long long qoff, long long N, long long rows_per, void* part,
             void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int splits = (int)((N + rows_per - 1) / rows_per);
  wgrad_kernel<<<dim3(K2 / 128, splits), 256, 0, st>>>(
      (const bf16*)P, ldp, K1, (const bf16*)Q, ldq, qoff, N, rows_per,
      (float*)part, K2);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  split_sum_kernel<<<(K1 * K2 + 255) / 256, 256, 0, st>>>(
      (const float*)part, splits, K1, K2, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
