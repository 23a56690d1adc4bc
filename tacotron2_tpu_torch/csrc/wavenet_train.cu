// WaveNet training stack: the gated residual layers' forward (kernel 5a)
// and backward (kernel 5b) for Hopper (sm_90a).
//
// Replaces tacotron2_tpu/ops/wavenet_train_kernel.py: `_build_stack_fwd`
// (:133, pallas_call :252) and `_build_stack_bwd` (:261, pallas_call
// :465), over their whole envelope: weights bf16 or f32 (W), saved
// activations bf16 or f32 (A), every width `stack_supported` admits.
// Activations live as [N = T·B, channels] with row = t·B + b, so a
// dilation shift of d samples is a shift of d·B rows and each tap of the
// dilated conv is a row-shifted product.
//
// What bounds it on this card. At the r5 shapes (N 128,000, R 128, G 256,
// S 128, cin 80, 20 layers) the forward is ~776 GFLOP of products
// (0.78 ms at bf16's 989 TFLOP/s; 4.7 ms as 3xTF32 at 495 / 3 TFLOP/s)
// against ~2 GB of bytes (0.6 ms at 3.35 TB/s), the backward twice the
// products: both are bound by operations.
//
// Design (a first, simple kernel; wgmma and TMA are later work):
// - The TPU version splits the stack in two halves and carries halos of
//   each layer's input across sequential time tiles, only to fit VMEM.
//   Here every layer is its own launch over independent 128-row tiles: the
//   launch boundary makes a layer's output whole before the next reads
//   its taps, and every tap row is read from global memory (rows before
//   t = 0 read zeros, the causal pad; no halo carries). N need not be a
//   multiple of the tile: the last tile masks its rows.
// - Widths at run time. Every product is a loop of chunks staged through
//   shared memory: 128 rows of the left operand and 128 or 256 columns of
//   the weights, each chunk 512 bytes deep a row (256 bf16 or 128 f32
//   values), so shared memory does not grow with R, G, S or cin and no
//   admitted width is refused for its size. Output columns go in passes of
//   128 (R, Ch = G/2, S) and depths in 16-value steps; the wrapper
//   zero-pads R, Ch, S to multiples of 128 and cin to 16 (each gate half on
//   its own, so Ch stays the split point) and slices the results back. The
//   default widths need no padding and run the same product steps in the
//   same order as the first, fixed-width version of this file: the same
//   bits.
// - bf16 products take bf16 operands with f32 sums (mma.sync m16n8k16), as
//   the MXU's preferred_element_type=f32. Operands are rounded to bf16
//   where the TPU kernel rounds them: the dropped-out input of the taps,
//   the conditioning, h = tanh·σ before the skip and out products; in the
//   backward c_res·dres, the scaled skip gradient, the gate gradient dy
//   and the dropped-out input before their products.
// - f32 products compute the f32 function, not TF32: each operand splits
//   into two TF32 values (hi + lo, ~2^-22 of it) and each 8-deep step runs
//   hi·hi + hi·lo + lo·hi on the tensor cores (mma.sync m16n8k8, "3xTF32",
//   the helpers of common.cuh) into a zeroed fragment that an f32 add
//   (round to nearest) adds to the running sum, as griffin_lim.cu does:
//   the tensor cores' own accumulation truncates. It was taken over the
//   FP32 cores because three TF32 products (~165 TFLOP/s dense) still
//   outrun the FP32 cores' 67 TFLOP/s, and the shared memory chunks and
//   warp tiles stay those of the bf16 route. A single TF32 product keeps
//   ~3 digits, too few against the f32 plain version.
// - Dropout is a counter-based hash of (seed, layer, row, channel)
//   (`keep_bit`), the same function as the plain version in
//   ops/wavenet_train_kernel.py, regenerated in the backward, never
//   stored. It counts channels by the true R, never the padded one, so
//   padding does not move the masks; its bits do not depend on the tile.
// - The forward saves x (before dropout), tanh a and σ b in A, one
//   [3, N, max(R, Ch)] block a layer; the backward recomputes h from them.
//   A left operand that the tile makes itself (h in the forward; the
//   scaled output gradients and dy in the backward) stays in shared
//   memory when it is one chunk deep (h at Ch <= 128; go and dy at the
//   default widths in bf16), else it goes through global memory (the
//   tile's own rows, read back after a barrier), so its size is not bound
//   by shared memory either.
// - The backward runs per layer (top down): `bwd_gate` (dh, the gate
//   gradients dy, the conditioning gradient and the bias sums), `bwd_dx`
//   (the tap transposes dxd[t] = Σ_k dy[t + (2-k)d]·W_kᵀ, dropout, the
//   residual path) and `wgrad` for every weight gradient: Σ over rows of
//   Pᵀ·Q, the conv's in the reindexed form dW_k = Σ_t xd[t]·dy[t+(2-k)d].
//   All reductions over rows are per-CTA partials summed in a fixed order
//   by a second launch: no float atomics, so a rerun is bit-exact.
// - No software barrier across CTAs; no library call.

#include <type_traits>

#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int TM = 128;       // rows per tile
constexpr int THREADS = 512;  // 16 warps: 2 row halves × 8 column groups
constexpr int ROWB = 528;     // bytes of a staged row: a 512-byte chunk + 16

constexpr int FWD_SMEM = (TM + 256) * ROWB;
constexpr int GATE_SMEM = (TM + 128) * ROWB + 2 * 256 * 4;
constexpr int DX_SMEM = (TM + 128) * ROWB;

// The widths a launch runs at: R the true residual width (the dropout
// hash's), then the padded R, Ch, S and cin.
struct Widths {
  int R, Rp, Chp, Sp, Cip;
};

// The default (r5) widths. Each kernel has an instantiation with them as
// compile-time constants (FIX), whose index arithmetic folds as in a
// fixed-width kernel: with runtime widths the forward spills (ptxas) and
// runs slower there (PERF.md §6, PR 12).
__host__ __device__ constexpr Widths default_widths() {
  return Widths{128, 128, 128, 128, 80};
}

bool is_default(const Widths& w) {
  constexpr Widths d = default_widths();
  return w.R == d.R && w.Rp == d.Rp && w.Chp == d.Chp && w.Sp == d.Sp &&
         w.Cip == d.Cip;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Dropout keep bit of (layer key, row, channel c < R): the plain version's
// `keep_bits` (ops/wavenet_train_kernel.py) bit for bit.
__device__ __forceinline__ bool keep_bit(uint32_t key, long long row, int c,
                                         uint32_t keep24, int R) {
  const uint32_t k = (uint32_t)((unsigned long long)row * R + c);
  uint32_t v = fmix32(k ^ key);
  v = fmix32(v + key);
  return (v >> 8) < keep24;
}

// The multiplier of channel c of a row: 1/keep if kept, else 0; the
// padded channels (c >= R, zero) are never kept.
__device__ __forceinline__ float keep_mult(uint32_t key, long long row, int c,
                                           uint32_t keep24, int R,
                                           float inv_keep) {
  return c < R && keep_bit(key, row, c, keep24, R) ? inv_keep : 0.f;
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

// One product step of a warp in operand type W. A tiles are row-major
// [rows][LD] in shared memory, B tiles stored transposed [n][LD]; a step
// is KS deep, a staged chunk KC (512 bytes a row).
template <typename W>
struct Mma;

template <>
struct Mma<bf16> {
  static constexpr int KS = 16, KC = 256, LD = ROWB / 2;
  struct FA {
    uint32_t r[4];
  };
  struct FB {
    uint32_t r[2];
  };
  __device__ __forceinline__ static void a(FA& f, const bf16* A, int m0,
                                           int k0, int grp, int tig) {
    const bf16* p = A + (m0 + grp) * LD + k0 + 2 * tig;
    f.r[0] = ld32(p);
    f.r[1] = ld32(p + 8 * LD);
    f.r[2] = ld32(p + 8);
    f.r[3] = ld32(p + 8 * LD + 8);
  }
  __device__ __forceinline__ static void b(FB& f, const bf16* Bt, int n0,
                                           int k0, int grp, int tig) {
    const bf16* p = Bt + (n0 + grp) * LD + k0 + 2 * tig;
    f.r[0] = ld32(p);
    f.r[1] = ld32(p + 8);
  }
  __device__ __forceinline__ static void mma(float* d, const FA& a,
                                             const FB& b) {
    mma16816(d, a.r, b.r);
  }
};

template <>
struct Mma<float> {
  static constexpr int KS = 8, KC = 128, LD = ROWB / 4;
  struct FA {
    uint32_t hi[4], lo[4];
  };
  struct FB {
    uint32_t hi[2], lo[2];
  };
  __device__ __forceinline__ static void a(FA& f, const float* A, int m0,
                                           int k0, int grp, int tig) {
    const float* p = A + (m0 + grp) * LD + k0 + tig;
    taco::split_tf32(p[0], f.hi[0], f.lo[0]);
    taco::split_tf32(p[8 * LD], f.hi[1], f.lo[1]);
    taco::split_tf32(p[4], f.hi[2], f.lo[2]);
    taco::split_tf32(p[8 * LD + 4], f.hi[3], f.lo[3]);
  }
  __device__ __forceinline__ static void b(FB& f, const float* Bt, int n0,
                                           int k0, int grp, int tig) {
    const float* p = Bt + (n0 + grp) * LD + k0 + tig;
    taco::split_tf32(p[0], f.hi[0], f.lo[0]);
    taco::split_tf32(p[4], f.hi[1], f.lo[1]);
  }
  __device__ __forceinline__ static void mma(float* d, const FA& a,
                                             const FB& b) {
    taco::mma_3xtf32(d, a.hi, a.lo, b.hi, b.lo);
  }
};

// acc[m][j] += As[m0 + 16m .., 0 : kc) · Bs[ncol(j) .., 0 : kc)ᵀ: the
// warp's 64 rows against its NJ 8-column tiles, one staged chunk. (Fully
// unrolled over a chunk, the f32 forward spilled more and ran slower.)
template <typename W, int NJ, typename NCol>
__device__ __forceinline__ void warp_mma(float (&acc)[4][NJ][4], const W* As,
                                         const W* Bs, int m0, NCol ncol,
                                         int kc, int grp, int tig) {
  using M = Mma<W>;
  for (int k0 = 0; k0 < kc; k0 += M::KS) {
    typename M::FB fb[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) M::b(fb[j], Bs, ncol(j), k0, grp, tig);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      typename M::FA fa;
      M::a(fa, As, m0 + 16 * m, k0, grp, tig);
#pragma unroll
      for (int j = 0; j < NJ; ++j) M::mma(acc[m][j], fa, fb[j]);
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[4][NJ][4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
}

// dst[i][0 : kc) = src[row_of(i)][col0 : col0 + kc) for i < nrows, zeros
// where row_of(i) < 0; 16 bytes a copy (kc a multiple of 16 values).
template <typename W, typename RowOf>
__device__ __forceinline__ void stage(W* dst, int nrows, int kc, const W* src,
                                      long long lds, long long col0,
                                      RowOf row_of) {
  constexpr int V = 16 / sizeof(W);
  const int per = kc / V;
  for (int u = threadIdx.x; u < nrows * per; u += THREADS) {
    const int i = u / per, k = (u - i * per) * V;
    const long long r = row_of(i);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r >= 0) v = *reinterpret_cast<const uint4*>(src + r * lds + col0 + k);
    *reinterpret_cast<uint4*>(dst + i * Mma<W>::LD + k) = v;
  }
}

__device__ __forceinline__ uint2 pack4(float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 r;
  r.x = *reinterpret_cast<uint32_t*>(&lo);
  r.y = *reinterpret_cast<uint32_t*>(&hi);
  return r;
}

// loads and stores of 1, 2 or 4 values in bf16 (rounded to nearest) or f32
__device__ __forceinline__ void put1(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void put1(float* p, float v) { *p = v; }
__device__ __forceinline__ void put2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put4(bf16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = pack4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void put4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float2 get2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 get2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void get4(const bf16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void get4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void get8(const bf16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&q);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
}
__device__ __forceinline__ void get8(const float* p, float* v) {
  get4(p, v);
  get4(p + 4, v + 4);
}
__device__ __forceinline__ void put8(bf16* p, const float* v) {
  const uint2 lo = pack4(v[0], v[1], v[2], v[3]);
  const uint2 hi = pack4(v[4], v[5], v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = make_uint4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void put8(float* p, const float* v) {
  put4(p, v);
  put4(p + 4, v + 4);
}

// ----------------------------------------------------------------- forward

template <typename W, typename A>
struct FwdArgs {
  const float* x_in;    // [N, Rp] block input (f32)
  float* x_out;         // [N, Rp] block output, or null (the last layer)
  const W* cb;          // [N, Cip] conditioning
  A* acts;              // [3, N, AW]: x, tanh a, sigmoid b
  float* skip;          // [N, Sp] running skip sum
  W* h;                 // [N, Chp] scratch: tanh a · sigmoid b
  const W* w1t;         // [Gp, 3Rp + Cip]: taps 0..2 and cin, transposed
  const float* b1;      // [Gp] conv bias + cin bias
  const W* w2t;         // [Sp + Rp, Chp]: skip | out, transposed
  const float* skip_b;  // [Sp]
  const float* out_b;   // [Rp]
  long long N;
  int B, d;
  Widths w;
  uint32_t key, keep24;
  float inv_keep, scale, c_res;
  int drop, first;
};

template <typename W, typename A, bool FIX>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_layer_kernel(FwdArgs<W, A> a) {
  using M = Mma<W>;
  extern __shared__ __align__(16) unsigned char smem[];
  W* As = reinterpret_cast<W*>(smem);  // [TM][LD]
  W* Bs = As + TM * M::LD;             // [256][LD]
  const long long r0 = (long long)blockIdx.x * TM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wr = warp >> 3, wc = warp & 7;
  const Widths w = FIX ? default_widths() : a.w;
  const int R = w.R, Rp = w.Rp, Chp = w.Chp, Sp = w.Sp, Cip = w.Cip;
  const int AW = Rp > Chp ? Rp : Chp;
  const long long KT = 3 * Rp + Cip, N = a.N;
  A* acts_t = a.acts + N * AW;
  A* acts_s = a.acts + 2 * N * AW;
  auto own_row = [r0, N](int i) { return r0 + i < N ? r0 + i : -1LL; };
  // one gate pass (Ch <= 128): h stays in As for the second product
  const bool h_res = Chp == 128;
  float acc[4][4][4];

  // y = Σ_q tap_q · W_q + c · W_cin, 128 gated channels a pass: the tanh
  // columns c0.., the matching sigmoid columns Chp + c0..
  for (int c0 = 0; c0 < Chp; c0 += 128) {
    zero(acc);
    for (int q = 0; q < 4; ++q) {
      const int K = q < 3 ? Rp : Cip;
      const long long shift = q < 3 ? (long long)(2 - q) * a.d * a.B : 0;
      for (int k0 = 0; k0 < K; k0 += M::KC) {
        const int kc = K - k0 < M::KC ? K - k0 : M::KC;
        if (q < 3) {  // tap q: rows t - (2-q)d, dropped out, in W
          const int per = kc / 4;
          for (int u = threadIdx.x; u < TM * per; u += THREADS) {
            const int i = u / per, cc = k0 + (u - i * per) * 4;
            const long long row = r0 + i, src = row - shift;
            float v[4] = {0.f, 0.f, 0.f, 0.f};
            if (row < a.N && src >= 0) {
              get4(a.x_in + src * Rp + cc, v);
              if (q == 2 && c0 == 0)  // the saved x, before dropout
                put4(a.acts + row * AW + cc, v);
              if (a.drop) {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  v[e] = cc + e < R && keep_bit(a.key, src, cc + e, a.keep24,
                                                R)
                             ? v[e] * a.inv_keep
                             : 0.f;
              }
            }
            put4(As + i * M::LD + cc - k0, v);
          }
        } else {  // the conditioning of the tile's own rows
          stage(As, TM, kc, a.cb, Cip, k0, own_row);
        }
        stage(Bs, 256, kc, a.w1t, KT, (long long)q * Rp + k0,
              [c0, Chp](int n) {
                return (long long)(n < 128 ? c0 + n : Chp + c0 + n - 128);
              });
        __syncthreads();
        // j 0, 1: the tanh half's columns; 2, 3: the matching sigmoid
        // columns, so each thread holds a and b of the same channels
        warp_mma(acc, As, Bs, 64 * wr, [wc](int j) {
          return (j < 2 ? 0 : 128) + 16 * wc + 8 * (j & 1);
        }, kc, grp, tig);
        __syncthreads();
      }
    }

    // gate: tanh a, sigmoid b saved; h = tanh a · sigmoid b, in W
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const long long row = r0 + 64 * wr + 16 * m + grp + 8 * h2;
          const int col = c0 + 16 * wc + 8 * j + 2 * tig;
          const float t0 = tanhf(acc[m][j][2 * h2] + a.b1[col]);
          const float t1 = tanhf(acc[m][j][2 * h2 + 1] + a.b1[col + 1]);
          const float s0 =
              taco::sigmoidf(acc[m][j + 2][2 * h2] + a.b1[Chp + col]);
          const float s1 =
              taco::sigmoidf(acc[m][j + 2][2 * h2 + 1] + a.b1[Chp + col + 1]);
          if (h_res)
            put2(As + (row - r0) * M::LD + col, t0 * s0, t1 * s1);
          if (row < N) {
            put2(acts_t + row * AW + col, t0, t1);
            put2(acts_s + row * AW + col, s0, s1);
            if (!h_res) put2(a.h + row * Chp + col, t0 * s0, t1 * s1);
          }
        }
  }
  __syncthreads();  // the tile's h rows are written

  // [skip | out] = h · [W_skip | W_out], 256 columns a pass
  const int NO = Sp + Rp;
  for (int n0 = 0; n0 < NO; n0 += 256) {
    zero(acc);
    const bool live = n0 + 32 * wc < NO;
    const int nrows = NO - n0 < 256 ? NO - n0 : 256;
    for (int k0 = 0; k0 < Chp; k0 += M::KC) {
      const int kc = Chp - k0 < M::KC ? Chp - k0 : M::KC;
      if (!h_res) stage(As, TM, kc, (const W*)a.h, Chp, k0, own_row);
      stage(Bs, nrows, kc, a.w2t, Chp, k0,
            [n0](int n) { return (long long)(n0 + n); });
      __syncthreads();
      if (live)
        warp_mma(acc, As, Bs, 64 * wr,
                 [wc](int j) { return 32 * wc + 8 * j; }, kc, grp, tig);
      __syncthreads();
    }
    if (!live) continue;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const long long row = r0 + 64 * wr + 16 * m + grp + 8 * h2;
          const int col = n0 + 32 * wc + 8 * j + 2 * tig;
          if (row >= a.N) continue;
          const float v0 = acc[m][j][2 * h2], v1 = acc[m][j][2 * h2 + 1];
          if (col < Sp) {
            float2* sp = reinterpret_cast<float2*>(a.skip + row * Sp + col);
            float2 s = a.first ? make_float2(0.f, 0.f) : *sp;
            s.x = s.x + a.scale * (v0 + a.skip_b[col]);
            s.y = s.y + a.scale * (v1 + a.skip_b[col + 1]);
            *sp = s;
          } else if (a.x_out) {
            const int cc = col - Sp;
            const float2 x =
                *reinterpret_cast<const float2*>(a.x_in + row * Rp + cc);
            *reinterpret_cast<float2*>(a.x_out + row * Rp + cc) = make_float2(
                a.c_res * (v0 + a.out_b[cc] + x.x),
                a.c_res * (v1 + a.out_b[cc + 1] + x.y));
          }
        }
  }
}

// ---------------------------------------------------------------- backward

template <typename W, typename A>
struct GateArgs {
  const float* dres;   // [N, Rp] gradient of the block output, or null (0)
  const float* dskip;  // [N, Sp]
  const A* acts;       // [3, N, AW] of this layer
  const W* wos;        // [Chp, Rp + Sp]: out | skip, as stored
  const W* wcin;       // [Cip, Gp]
  W* go;               // [N, Rp + Sp]: W(c_res·dres) | W(scale·dskip)
  W* dy;               // [N, Gp]: W(da) | W(db)
  W* xd;               // [N, Rp]: W(x · dropout multiplier)
  W* h;                // [N, Chp]: W(tanh a · sigmoid b)
  float* dc;           // [N, Cip] conditioning gradient, summed over layers
  float* part;         // [tiles, Gp + Rp + Sp] per-tile column sums
  long long N;
  Widths w;
  uint32_t key, keep24;
  float inv_keep, scale, c_res;
  int drop, acc_dc;
};

template <typename W, typename A, bool FIX>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_gate_kernel(GateArgs<W, A> a) {
  using M = Mma<W>;
  extern __shared__ __align__(16) unsigned char smem[];
  W* As = reinterpret_cast<W*>(smem);                   // [TM][LD]
  W* Bs = As + TM * M::LD;                              // [128][LD]
  float* red = reinterpret_cast<float*>(Bs + 128 * M::LD);  // [2][256]
  const long long r0 = (long long)blockIdx.x * TM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wr = warp >> 3, wc = warp & 7;
  const Widths w = FIX ? default_widths() : a.w;
  const int R = w.R, Rp = w.Rp, Chp = w.Chp, Sp = w.Sp, Cip = w.Cip;
  const int AW = Rp > Chp ? Rp : Chp, NG = Rp + Sp, Gp = 2 * Chp;
  float* part = a.part + (size_t)blockIdx.x * (Gp + NG);
  const long long N = a.N;
  const A* ax = a.acts;
  const A* at = a.acts + N * AW;
  const A* as = a.acts + 2 * N * AW;
  auto own_row = [r0, N](int i) { return r0 + i < N ? r0 + i : -1LL; };
  // a left operand one chunk deep stays in As: go (R + S) for dh, dy (G,
  // then one dh pass) for dc
  const bool go_res = NG <= M::KC, dy_res = Gp <= M::KC;

  // the products' left operand [c_res·dres | scale·dskip] and its column
  // sums, 256 columns a pass, each as two 64-row halves
  {
    const int jj = threadIdx.x & 255, half = threadIdx.x >> 8;
    for (int j0 = 0; j0 < NG; j0 += 256) {
      const int j = j0 + jj;
      float sum = 0.f;
      if (j < NG) {
        for (int i = 64 * half; i < 64 * half + 64; ++i) {
          const long long row = r0 + i;
          float v = 0.f;
          if (row < N) {
            v = j < Rp ? (a.dres ? a.c_res * a.dres[row * Rp + j] : 0.f)
                       : a.scale * a.dskip[row * Sp + j - Rp];
            put1(a.go + row * NG + j, v);
          }
          if (go_res) put1(As + i * M::LD + j, v);
          sum += v;
        }
      }
      red[half * 256 + jj] = sum;
      __syncthreads();
      if (threadIdx.x < 256 && j0 + (int)threadIdx.x < NG)
        part[Gp + j0 + threadIdx.x] = red[threadIdx.x] + red[256 + threadIdx.x];
      __syncthreads();
    }
  }
  // xd = x · dropout multiplier and h = tanh a · sigmoid b, in W, 8
  // channels a unit
  for (int u = threadIdx.x; u < TM * (AW / 8); u += THREADS) {
    const int i = u / (AW / 8), c8 = (u % (AW / 8)) * 8;
    const long long row = r0 + i;
    if (row >= N) continue;
    if (c8 < Rp) {
      float xv[8];
      get8(ax + row * AW + c8, xv);
      if (a.drop) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          xv[e] = xv[e] * keep_mult(a.key, row, c8 + e, a.keep24, R,
                                    a.inv_keep);
      }
      put8(a.xd + row * Rp + c8, xv);
    }
    if (c8 < Chp) {
      float tv[8], sv[8], hv[8];
      get8(at + row * AW + c8, tv);
      get8(as + row * AW + c8, sv);
#pragma unroll
      for (int e = 0; e < 8; ++e) hv[e] = tv[e] * sv[e];
      put8(a.h + row * Chp + c8, hv);
    }
  }
  __syncthreads();  // the tile's go rows are written

  // dh = W(c_res·dres)·W_outᵀ + W(scale·dskip)·W_skipᵀ, 128 gated
  // channels a pass; then the gate gradients da, db into dy
  for (int c0 = 0; c0 < Chp; c0 += 128) {
    float acc[4][2][4];
    zero(acc);
    for (int k0 = 0; k0 < NG; k0 += M::KC) {
      const int kc = NG - k0 < M::KC ? NG - k0 : M::KC;
      if (!go_res) stage(As, TM, kc, (const W*)a.go, NG, k0, own_row);
      stage(Bs, 128, kc, a.wos, NG, k0,
            [c0](int n) { return (long long)(c0 + n); });
      __syncthreads();
      warp_mma(acc, As, Bs, 64 * wr, [wc](int j) { return 16 * wc + 8 * j; },
               kc, grp, tig);
      __syncthreads();
    }
    float db[4][2][4];
    float sa[2][2] = {{0.f, 0.f}, {0.f, 0.f}},
          sbs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const long long row = r0 + 64 * wr + 16 * m + grp + 8 * h2;
          const int col = c0 + 16 * wc + 8 * j + 2 * tig;
          float2 tv = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
          if (row < a.N) {
            tv = get2(at + row * AW + col);
            sv = get2(as + row * AW + col);
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
    if (grp == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 16 * wc + 8 * j + 2 * tig + e;
          red[wr * 256 + col] = sa[j][e];
          red[wr * 256 + 128 + col] = sbs[j][e];
        }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const long long row = r0 + 64 * wr + 16 * m + grp + 8 * h2;
          const int col = c0 + 16 * wc + 8 * j + 2 * tig;
          if (dy_res) {
            W* p = As + (row - r0) * M::LD + col;
            put2(p, acc[m][j][2 * h2], acc[m][j][2 * h2 + 1]);
            put2(p + Chp, db[m][j][2 * h2], db[m][j][2 * h2 + 1]);
          }
          if (row < N) {
            put2(a.dy + row * Gp + col, acc[m][j][2 * h2],
                 acc[m][j][2 * h2 + 1]);
            put2(a.dy + row * Gp + Chp + col, db[m][j][2 * h2],
                 db[m][j][2 * h2 + 1]);
          }
        }
    __syncthreads();
    if (threadIdx.x < 256) {
      const int t = threadIdx.x;
      part[t < 128 ? c0 + t : Chp + c0 + t - 128] = red[t] + red[256 + t];
    }
    __syncthreads();
  }

  // dc += W(dy)·W_cinᵀ, 128 conditioning channels a pass
  for (int n0 = 0; n0 < Cip; n0 += 128) {
    float acc[4][2][4];
    zero(acc);
    const bool live = n0 + 16 * wc < Cip;
    const int nrows = Cip - n0 < 128 ? Cip - n0 : 128;
    for (int k0 = 0; k0 < Gp; k0 += M::KC) {
      const int kc = Gp - k0 < M::KC ? Gp - k0 : M::KC;
      if (!dy_res) stage(As, TM, kc, (const W*)a.dy, Gp, k0, own_row);
      stage(Bs, nrows, kc, a.wcin, Gp, k0,
            [n0](int n) { return (long long)(n0 + n); });
      __syncthreads();
      if (live)
        warp_mma(acc, As, Bs, 64 * wr,
                 [wc](int j) { return 16 * wc + 8 * j; }, kc, grp, tig);
      __syncthreads();
    }
    if (!live) continue;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const long long row = r0 + 64 * wr + 16 * m + grp + 8 * h2;
          const int col = n0 + 16 * wc + 8 * j + 2 * tig;
          if (row >= a.N) continue;
          float2* p = reinterpret_cast<float2*>(a.dc + row * Cip + col);
          float2 v = a.acc_dc ? *p : make_float2(0.f, 0.f);
          v.x += acc[m][j][2 * h2];
          v.y += acc[m][j][2 * h2 + 1];
          *p = v;
        }
  }
}

template <typename W>
struct DxArgs {
  const W* dy;         // [N, Gp]
  const W* wconv;      // [3, Rp, Gp]: the taps' weights, as stored
  const float* dres;   // [N, Rp] or null (0)
  float* dres_out;     // [N, Rp]: gradient of the block input
  long long N;
  int B, d;
  Widths w;  // R, Rp, Chp read
  uint32_t key, keep24;
  float inv_keep, c_res;
  int drop;
};

template <typename W, bool FIX>
__global__ void __launch_bounds__(THREADS, 1) bwd_dx_kernel(DxArgs<W> a) {
  using M = Mma<W>;
  extern __shared__ __align__(16) unsigned char smem[];
  W* As = reinterpret_cast<W*>(smem);  // [TM][LD]
  W* Bs = As + TM * M::LD;             // [128][LD]
  const long long r0 = (long long)blockIdx.x * TM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wr = warp >> 3, wc = warp & 7;
  const Widths w = FIX ? default_widths() : a.w;
  const int R = w.R, Rp = w.Rp, Gp = 2 * w.Chp;
  const long long N = a.N, step = (long long)a.d * a.B;
  for (int c0 = 0; c0 < Rp; c0 += 128) {
    float acc[4][2][4];
    zero(acc);
    for (int k = 0; k < 3; ++k) {
      const long long off = (2 - k) * step;
      for (int k0 = 0; k0 < Gp; k0 += M::KC) {
        const int kc = Gp - k0 < M::KC ? Gp - k0 : M::KC;
        stage(As, TM, kc, a.dy, Gp, k0, [r0, N, off](int i) {
          const long long row = r0 + i, src = row + off;
          return row < N && src < N ? src : -1LL;
        });
        stage(Bs, 128, kc, a.wconv, Gp, k0, [k, Rp, c0](int n) {
          return (long long)k * Rp + c0 + n;
        });
        __syncthreads();
        warp_mma(acc, As, Bs, 64 * wr,
                 [wc](int j) { return 16 * wc + 8 * j; }, kc, grp, tig);
        __syncthreads();
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const long long row = r0 + 64 * wr + 16 * m + grp + 8 * h2;
          const int col = c0 + 16 * wc + 8 * j + 2 * tig;
          if (row >= a.N) continue;
          float v[2] = {acc[m][j][2 * h2], acc[m][j][2 * h2 + 1]};
          float2 r = make_float2(0.f, 0.f);
          if (a.dres) {
            r = *reinterpret_cast<const float2*>(a.dres + row * Rp + col);
            r.x = a.c_res * r.x;
            r.y = a.c_res * r.y;
          }
          if (a.drop) {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[e] = v[e] * keep_mult(a.key, row, col + e, a.keep24, R,
                                      a.inv_keep);
          }
          *reinterpret_cast<float2*>(a.dres_out + row * Rp + col) =
              make_float2(r.x + v[0], r.y + v[1]);
        }
  }
}

// part[s, i, j] = Σ_{r in split s} P[r, i]·Q[r + qoff, j] (Q rows past N
// read 0) for the block's 128 rows i (< K1) and 128 columns j; 256
// threads. bf16 stages 32 rows a step transposed ([i][r], [j][r]: the
// m16n8k16 fragments pair values along r); f32 stages them as they lie
// ([r][i], [r][j]: a TF32 fragment holds one value, read down a column).
constexpr int WK_RK = 32;   // rows a step
constexpr int WK_LD = 40;   // bf16 shared stride: conflict-free fragments
constexpr int WK_LDF = 136; // f32 shared stride: conflict-free fragments
constexpr int WK_SMEM = 2 * WK_RK * WK_LDF * 4;
static_assert(2 * 128 * WK_LD * 2 <= WK_SMEM, "bf16 tiles fit");

template <typename W>
__global__ void __launch_bounds__(256) wgrad_kernel(
    const W* __restrict__ P, int ldp, int K1, const W* __restrict__ Q,
    int ldq, long long qoff, long long N, long long rows_per, float* part,
    int K2) {
  __shared__ __align__(16) unsigned char sm[WK_SMEM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wi = warp >> 2, wj = warp & 3;
  const int j0 = blockIdx.x * 128, i0 = blockIdx.z * 128;
  const long long rb0 = (long long)blockIdx.y * rows_per;
  const long long rend = rb0 + rows_per < N ? rb0 + rows_per : N;
  float acc[4][4][4];
  zero(acc);
  for (long long rb = rb0; rb < rend; rb += WK_RK) {
    if constexpr (std::is_same<W, bf16>::value) {
      bf16* Ps = reinterpret_cast<bf16*>(sm);  // [i][r]
      bf16* Qs = Ps + 128 * WK_LD;             // [j][r]
      for (int u = threadIdx.x; u < (WK_RK / 2) * 64; u += 256) {
        const int rp = u >> 6, cp = 2 * (u & 63);
        const long long r = rb + 2 * rp;
        uint32_t p0 = 0, p1 = 0, q0 = 0, q1 = 0;
        if (i0 + cp < K1) {
          if (r < rend) p0 = ld32(P + r * ldp + i0 + cp);
          if (r + 1 < rend) p1 = ld32(P + (r + 1) * ldp + i0 + cp);
        }
        if (r < rend && r + qoff < N)
          q0 = ld32(Q + (r + qoff) * ldq + j0 + cp);
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
        for (int m = 0; m < 4; ++m) {
          const bf16* p = Ps + (64 * wi + 16 * m + grp) * WK_LD + k0 + 2 * tig;
          af[m][0] = ld32(p);
          af[m][1] = ld32(p + 8 * WK_LD);
          af[m][2] = ld32(p + 8);
          af[m][3] = ld32(p + 8 * WK_LD + 8);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const bf16* p = Qs + (32 * wj + 8 * n + grp) * WK_LD + k0 + 2 * tig;
          const uint32_t bfr[2] = {ld32(p), ld32(p + 8)};
#pragma unroll
          for (int m = 0; m < 4; ++m) mma16816(acc[m][n], af[m], bfr);
        }
      }
    } else {
      float* Ps = reinterpret_cast<float*>(sm);  // [r][i]
      float* Qs = Ps + WK_RK * WK_LDF;           // [r][j]
      for (int u = threadIdx.x; u < WK_RK * 32; u += 256) {
        const int rr = u >> 5, c4 = (u & 31) * 4;
        const long long r = rb + rr;
        float4 p = make_float4(0.f, 0.f, 0.f, 0.f), q = p;
        if (r < rend && i0 + c4 < K1)
          p = *reinterpret_cast<const float4*>(P + r * ldp + i0 + c4);
        if (r < rend && r + qoff < N)
          q = *reinterpret_cast<const float4*>(Q + (r + qoff) * ldq + j0 +
                                               c4);
        *reinterpret_cast<float4*>(Ps + rr * WK_LDF + c4) = p;
        *reinterpret_cast<float4*>(Qs + rr * WK_LDF + c4) = q;
      }
      __syncthreads();
#pragma unroll
      for (int k0 = 0; k0 < WK_RK; k0 += 8) {
        const float* p0 = Ps + (k0 + tig) * WK_LDF;
        const float* p1 = p0 + 4 * WK_LDF;
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int j = 32 * wj + 8 * n + grp;
          taco::split_tf32(Qs[(k0 + tig) * WK_LDF + j], bh[n][0], bl[n][0]);
          taco::split_tf32(Qs[(k0 + tig + 4) * WK_LDF + j], bh[n][1],
                           bl[n][1]);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i = 64 * wi + 16 * m + grp;
          uint32_t ah[4], al[4];
          taco::split_tf32(p0[i], ah[0], al[0]);
          taco::split_tf32(p0[i + 8], ah[1], al[1]);
          taco::split_tf32(p1[i], ah[2], al[2]);
          taco::split_tf32(p1[i + 8], ah[3], al[3]);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            taco::mma_3xtf32(acc[m][n], ah, al, bh[n], bl[n]);
        }
      }
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * K1 * K2;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int i = i0 + 64 * wi + 16 * m + grp + 8 * h2;
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
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * K1 * K2 + idx];
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

unsigned tiles(long long N) { return (unsigned)((N + TM - 1) / TM); }

// Each instantiation takes its dynamic shared memory once.
template <typename K>
int smem_once(K kernel, int bytes, bool& done) {
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

template <typename W, typename A, bool FIX>
int fwd_launch(const FwdArgs<W, A>& a, cudaStream_t st) {
  static bool done = false;
  int rc = smem_once(fwd_layer_kernel<W, A, FIX>, FWD_SMEM, done);
  if (rc) return rc;
  fwd_layer_kernel<W, A, FIX><<<tiles(a.N), THREADS, FWD_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename W, typename A, bool FIX>
int gate_launch(const GateArgs<W, A>& a, void* sums, cudaStream_t st) {
  static bool done = false;
  int rc = smem_once(bwd_gate_kernel<W, A, FIX>, GATE_SMEM, done);
  if (rc) return rc;
  bwd_gate_kernel<W, A, FIX><<<tiles(a.N), THREADS, GATE_SMEM, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int PW = 2 * a.w.Chp + a.w.Rp + a.w.Sp;
  colsum_kernel<<<PW, 256, 0, st>>>(a.part, (int)tiles(a.N), PW,
                                    (float*)sums);
  return (int)cudaGetLastError();
}

template <typename W, bool FIX>
int dx_launch(const DxArgs<W>& a, cudaStream_t st) {
  static bool done = false;
  int rc = smem_once(bwd_dx_kernel<W, FIX>, DX_SMEM, done);
  if (rc) return rc;
  bwd_dx_kernel<W, FIX><<<tiles(a.N), THREADS, DX_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

// (the transposed taps read R and Ch only)
template <typename W>
int dx_typed(const DxArgs<W>& a, cudaStream_t st) {
  constexpr Widths d = default_widths();
  const bool fix = a.w.R == d.R && a.w.Rp == d.Rp && a.w.Chp == d.Chp;
  return fix ? dx_launch<W, true>(a, st) : dx_launch<W, false>(a, st);
}

// The launch's pointers as the C interface passes them.
struct FwdPtrs {
  const void *x_in;
  void *x_out;
  const void* cb;
  void *acts, *skip, *h;
  const void *w1t, *b1, *w2t, *skip_b, *out_b;
};

template <typename W, typename A>
int fwd_typed(const FwdPtrs& p, long long N, int B, int d, Widths w,
              uint32_t key, uint32_t keep24, float inv_keep, int drop,
              float scale, float c_res, int first, cudaStream_t st) {
  FwdArgs<W, A> a{(const float*)p.x_in, (float*)p.x_out, (const W*)p.cb,
                  (A*)p.acts, (float*)p.skip, (W*)p.h, (const W*)p.w1t,
                  (const float*)p.b1, (const W*)p.w2t,
                  (const float*)p.skip_b, (const float*)p.out_b, N, B, d, w,
                  key, keep24, inv_keep, scale, c_res, drop, first};
  return is_default(w) ? fwd_launch<W, A, true>(a, st)
                       : fwd_launch<W, A, false>(a, st);
}

struct GatePtrs {
  const void *dres, *dskip, *acts, *wos, *wcin;
  void *go, *dy, *xd, *h, *dc, *part, *sums;
};

template <typename W, typename A>
int gate_typed(const GatePtrs& p, long long N, Widths w, uint32_t key,
               uint32_t keep24, float inv_keep, int drop, float scale,
               float c_res, int acc_dc, cudaStream_t st) {
  GateArgs<W, A> a{(const float*)p.dres, (const float*)p.dskip,
                   (const A*)p.acts, (const W*)p.wos, (const W*)p.wcin,
                   (W*)p.go, (W*)p.dy, (W*)p.xd, (W*)p.h, (float*)p.dc,
                   (float*)p.part, N, w, key, keep24, inv_keep, scale,
                   c_res, drop, acc_dc};
  return is_default(w) ? gate_launch<W, A, true>(a, p.sums, st)
                       : gate_launch<W, A, false>(a, p.sums, st);
}

template <typename W>
int wgrad_typed(const void* P, int ldp, int K1, const void* Q, int ldq,
                int K2, long long qoff, long long N, long long rows_per,
                void* part, void* out, cudaStream_t st) {
  const int splits = (int)((N + rows_per - 1) / rows_per);
  wgrad_kernel<W><<<dim3(K2 / 128, splits, (K1 + 127) / 128), 256, 0, st>>>(
      (const W*)P, ldp, K1, (const W*)Q, ldq, qoff, N, rows_per,
      (float*)part, K2);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  split_sum_kernel<<<(K1 * K2 + 255) / 256, 256, 0, st>>>(
      (const float*)part, splits, K1, K2, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One layer of the forward; `first` starts the skip sum, x_out may be
// null (the last layer's block output is not needed). Widths: R (the
// hash's), then the padded R, Ch, S, cin (R, Ch, S multiples of 128, cin
// of 16). w_f32 / a_f32: f32 weights / saved activations, else bf16.
int wn_fwd_layer(const void* x_in, void* x_out, const void* cb, void* acts,
                 void* skip, void* h, const void* w1t, const void* b1,
                 const void* w2t, const void* skip_b, const void* out_b,
                 long long N, int B, int d, int R, int Rp, int Chp, int Sp,
                 int Cip, uint32_t key, uint32_t keep24, float inv_keep,
                 int drop, float scale, float c_res, int first, int w_f32,
                 int a_f32, void* stream) {
  const FwdPtrs p{x_in, x_out, cb, acts, skip, h, w1t, b1, w2t, skip_b,
                  out_b};
  const Widths w{R, Rp, Chp, Sp, Cip};
  cudaStream_t st = (cudaStream_t)stream;
#define WN_FWD(W_, A_)                                                   \
  fwd_typed<W_, A_>(p, N, B, d, w, key, keep24, inv_keep, drop, scale, \
                    c_res, first, st)
  if (w_f32) return a_f32 ? WN_FWD(float, float) : WN_FWD(float, bf16);
  return a_f32 ? WN_FWD(bf16, float) : WN_FWD(bf16, bf16);
#undef WN_FWD
}

// The gate part of one layer's backward, then the tile sums reduced into
// sums[Gp + Rp + Sp] (dy | c_res·dres | scale·dskip).
int wn_bwd_gate(const void* dres, const void* dskip, const void* acts,
                const void* wos, const void* wcin, void* go, void* dy,
                void* xd, void* h, void* dc, void* part, void* sums,
                long long N, int R, int Rp, int Chp, int Sp, int Cip,
                uint32_t key, uint32_t keep24, float inv_keep, int drop,
                float scale, float c_res, int acc_dc, int w_f32, int a_f32,
                void* stream) {
  const GatePtrs p{dres, dskip, acts, wos, wcin, go, dy, xd, h, dc, part,
                   sums};
  const Widths w{R, Rp, Chp, Sp, Cip};
  cudaStream_t st = (cudaStream_t)stream;
#define WN_GATE(W_, A_)                                                   \
  gate_typed<W_, A_>(p, N, w, key, keep24, inv_keep, drop, scale, c_res, \
                     acc_dc, st)
  if (w_f32) return a_f32 ? WN_GATE(float, float) : WN_GATE(float, bf16);
  return a_f32 ? WN_GATE(bf16, float) : WN_GATE(bf16, bf16);
#undef WN_GATE
}

int wn_bwd_dx(const void* dy, const void* wconv, const void* dres,
              void* dres_out, long long N, int B, int d, int R, int Rp,
              int Chp, uint32_t key, uint32_t keep24, float inv_keep,
              int drop, float c_res, int w_f32, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Widths w{R, Rp, Chp, 0, 0};
  if (w_f32) {
    DxArgs<float> a{(const float*)dy, (const float*)wconv, (const float*)dres,
                    (float*)dres_out, N, B, d, w, key, keep24, inv_keep,
                    c_res, drop};
    return dx_typed(a, st);
  }
  DxArgs<bf16> a{(const bf16*)dy, (const bf16*)wconv, (const float*)dres,
                 (float*)dres_out, N, B, d, w, key, keep24, inv_keep, c_res,
                 drop};
  return dx_typed(a, st);
}

// out[K1, K2] = Σ_r P[r, :K1]ᵀ·Q[r + qoff, :K2]; `part` holds
// ceil(N / rows_per) · K1 · K2 floats; K2 % 128 == 0, K1 % 16 == 0.
int wn_wgrad(const void* P, int ldp, int K1, const void* Q, int ldq, int K2,
             long long qoff, long long N, long long rows_per, void* part,
             void* out, int w_f32, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (w_f32)
    return wgrad_typed<float>(P, ldp, K1, Q, ldq, K2, qoff, N, rows_per,
                              part, out, st);
  return wgrad_typed<bf16>(P, ldp, K1, Q, ldq, K2, qoff, N, rows_per, part,
                           out, st);
}

}  // extern "C"
