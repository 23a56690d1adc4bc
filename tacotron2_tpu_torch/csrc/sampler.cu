// Whole WaveNet sample loop, every output head, one thread-block cluster per
// batch row.
//
// Replaces the TPU kernel tacotron2_tpu/ops/wavenet_kernel.py
// `build_sampler_kernel` (pallas_call at :313) and its HBM-delay variant
// `build_sampler_kernel_hbm` (:566), which give bit-identical results, with
// the three heads of `_HeadPlan` (:56) and its f32 or bf16 delay cache and
// weights. Per sample and layer: the kw=3 dilated conv over the taps
// (x_{t-2d}, x_{t-d}, x_t) and the 1x1 conditioning projection of c_up[t]
// as ONE matvec against the stacked weight czw [3R + C, G] (the TPU
// kernel's fusion), tanh·σ gate, and h @ [skip | out] as one matvec, with
// √0.5 residual/skip scaling; then the ReLU head y_hat = f2(relu(f1(relu(
// skips)))) and the draw from it (`_HeadPlan.emit`, :151-177), fed back as
// the next input:
//
// - Gaussian (out 2): clip(mean + exp(max(log_s, min)) · z, -1, 1);
// - mixture of logistics (out 3·nr): the mixture whose cumulative softmax
//   mass first exceeds u0·total (the last one if none does), then
//   clip(mean_k + exp(max(log_s_k, min)) · (log u1 - log(1 - u1)), -1, 1)
//   with u1 clipped to [1e-5, 1-1e-5];
// - categorical (mulaw-quantize, out Q): the class picked the same way; the
//   sample is the class index and the next input its one-hot, so the first
//   conv is the row gather first_w[idx] + first_b (exact for a one-hot; the
//   start is class 127).
//
// The random numbers (standard normals, or uniforms in (0, 1)) come from the
// caller as planes [planes, B, T]. The TPU kernel's sampler_hbm_delay_
// threshold and sampler_window place its delay lines in VMEM or HBM and do
// not change the samples; there is no counterpart here and the wrapper
// ignores them.
//
// bf16 variant (the TPU serving configuration, synth/pipeline.py:124-140):
// `cache_bf16` keeps the delay rings in bf16; WT = __nv_bfloat16 keeps the
// layer weights czw and sow in bf16 and rounds the products' inputs (the
// taps, x, c_t and h) to bf16, which are then widened to f32 for FMA with
// f32 sums: the function the TPU computes on its MXU (bf16 × bf16 products
// are exact in f32). Biases, residual and skip sums and the head stay f32.
// bf16 weights load 8 bytes (4 columns) at a time (taco::PackBf16x4), so
// the products split as the f32 ones do.
//
// Design. A cluster of CS=8 CTAs (`__cluster_dims__`, co-scheduled by the
// hardware) loops over all T samples of one row with a static trip count.
// In every layer CTA `rank` computes the gate pairs (a, b) of its G/(2·CS)
// units, then its S/CS skip and R/CS residual columns; the wrapper lays
// those weight columns out contiguously per rank. The new h and the new
// residual x are exchanged through distributed shared memory with one
// cluster.sync() each; skip sums stay with their owner until the layer loop
// ends, then one exchange gives every CTA all of them. Every CTA then runs
// the head on the same data in the same order, so all compute the same
// y_hat bit for bit; warp 0 of each draws from it (the softmax and the
// cumulative sum in a fixed order: a max, then 32 lanes summing consecutive
// runs of exp(l - max) and a shuffle scan over the lanes), so every CTA
// picks the same class, and rank 0 writes the sample. Each CTA keeps its own
// copy of the delay rings in global memory (2d+1 rows of R values per
// layer: 2.1 MB in f32, 1.05 MB in bf16 at the default 20 layers), so no
// CTA reads global memory another one wrote. The older taps of every layer
// and c_up[t] are fetched once at the start of each sample. The
// conditioning projection is computed per sample inside the layer's matvec,
// so no [B, T, L·G] tensor exists. The layer weights (~12 MB in f32, ~6 MB
// in bf16 at the default width) and the head stay resident in L2. No CTA
// waits on anything but its own __syncthreads() and its cluster's hardware
// barrier, and every CTA of a cluster passes the same barriers: the head
// kind and dtypes are launch arguments, the same for every thread, and no
// branch around a barrier depends on data.
//
// Bound: the serial chain of 20 layers per sample makes the kernel
// latency-bound — per layer one L2 read of 1/CS of the layer's weights and
// two cluster barriers — far above its bytes or operations bound (the
// operations of a sample, ~2·(L·((3R + C)·G + G/2·(S + R)) + S·S + S·out),
// at the f32 rate for f32 weights or the bf16 tensor-core rate for bf16
// weights; bytes: the weights once, c_up and the noise read, the samples
// written). For 512 samples of 8 rows at the default width that is 0.3727,
// 0.3731 and 0.3766 ms (Gaussian, MoL, categorical) with f32 weights and
// 0.0272, 0.0276 and 0.0311 ms with bf16 weights, all set by operations,
// against ~52-54 ms measured on an H100 (PERF.md). bf16 weights halve the
// bytes each sample streams from L2 but leave the chain of barriers: the
// bf16 kernel takes about the f32 kernel's time. The categorical head's f2
// (S × 256 floats, 128 KB) is read by every CTA of a cluster each sample.
// Sharing weight tiles between the rows of a batch is the next step.
//
// Shared memory per CTA (floats, default width): per-layer input rows
// L·(3R + C) + x R + h G/2 + own gate and output columns 2·gc + sc + rc +
// skips S + head 2S + out (padded to 4) + 4 + matvec partials 512·4
// ≈ 12.4k floats ≈ 50 KB (56 KB with the categorical head's 256 outputs).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;
constexpr int CS = 8;     // CTAs per row (one cluster)
constexpr int DEPTH = 8;  // weight loads in flight a thread

enum Head { GAUSSIAN = 0, MOL = 1, CATEGORICAL = 2 };

// Operand order of taco_sampler_launch's pointer and int arrays.
enum Ptr {
  P_C_UP,      // f32 [B, T, C]
  P_NOISE,     // f32 [planes, B, T]
  P_CZW,       // WT [CS, L, 3R + C, 2·gc]  (a | b) columns of own units
  P_CZB,       // f32 [CS, L, 2·gc]
  P_SOW,       // WT [CS, L, G/2, sc + rc]  (skip | out) own columns
  P_SOB,       // f32 [CS, L, sc + rc]
  P_FIRST_W,   // f32 [1, R] scalar input, [Q, R] categorical
  P_FIRST_B,   // f32 [R]
  P_F1_W,      // f32 [S, S]
  P_F1_B,      // f32 [S]
  P_F2_W,      // f32 [S, NO] out columns zero-padded to NO
  P_F2_B,      // f32 [NO]
  P_DIL,       // int [L]
  P_RING_OFF,  // int [L] row offset of each layer's ring
  P_RING,      // f32 or bf16 [B, CS, ring_rows, R], zero on entry
  P_OUT,       // f32 [B, T]
  N_PTR
};
enum Int {
  I_B, I_T, I_L, I_R, I_G, I_S, I_C, I_RING_ROWS, I_LEGACY,
  I_RESIDUAL_LEGACY, I_HEAD, I_N_OUT, I_NO, I_FIRST_IDX, I_WEIGHT_BF16,
  I_CACHE_BF16, N_INT
};

// u1's clip bounds, the f32 values of the reference's 1e-5 and 1 - 1e-5
constexpr float U_LO = (float)1e-5;
constexpr float U_HI = (float)(1.0 - 1e-5);

struct SmpArgs {
  const float* c_up;
  const float* noise;
  const void* czw;
  const float* czb;
  const void* sow;
  const float* sob;
  const float* first_w;
  const float* first_b;
  const float* f1_w;
  const float* f1_b;
  const float* f2_w;
  const float* f2_b;
  const int* dil;
  const int* ring_off;
  void* ring;
  float* out;
  int B, T, L, R, G, S, C, ring_rows, legacy, residual_legacy;
  int head, n_out, NO, first_idx, cache_bf16;
  float log_scale_min;
};

// the weight loads of the layer products
template <typename W>
struct WPack {
  using type = taco::Pack<float>;
};
template <>
struct WPack<__nv_bfloat16> {
  using type = taco::PackBf16x4;
};

// v as the product input of weight type W: unchanged for f32, rounded to
// the nearest bf16 (ties to even, as torch's and XLA's casts) for bf16.
template <typename W>
__device__ __forceinline__ float to_w(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_w<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float ring_ld(const void* ring, size_t i, int bf) {
  return bf ? __bfloat162float(((const __nv_bfloat16*)ring)[i])
            : ((const float*)ring)[i];
}

__device__ __forceinline__ void ring_st(void* ring, size_t i, float v,
                                        int bf) {
  if (bf)
    ((__nv_bfloat16*)ring)[i] = __float2bfloat16(v);
  else
    ((float*)ring)[i] = v;
}

// Inverse-CDF pick over n logits, by the 32 lanes of one warp, all of which
// get the result: the first index whose cumulative exp(l - max) exceeds
// u·total, else n - 1. The order of every sum is fixed by n alone.
__device__ int warp_inverse_cdf(const float* logits, int n, float u) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int i = lane; i < n; i += 32) m = fmaxf(m, logits[i]);
  m = taco::warp_max(m);
  const int per = (n + 31) / 32;
  const int lo = min(n, lane * per), hi = min(n, lo + per);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) run += expf(logits[i] - m);
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const float tot = __shfl_sync(0xffffffffu, incl, 31);
  float cum = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) cum = 0.f;
  const float target = u * tot;
  int found = n;
  for (int i = lo; i < hi; ++i) {
    cum += expf(logits[i] - m);
    if (target < cum) {
      found = i;
      break;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    found = min(found, __shfl_xor_sync(0xffffffffu, found, o));
  return found < n ? found : n - 1;
}

template <typename WT>
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(NT, 1)
    sampler_kernel(const SmpArgs a) {
  using WP = typename WPack<WT>::type;
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CS, tid = threadIdx.x;
  const int R = a.R, G = a.G, S = a.S, C = a.C, T = a.T, L = a.L;
  const int KIN = 3 * R + C;
  const int gc = G / 2 / CS, sc = S / CS, rc = R / CS;
  const int cbf = a.cache_bf16;
  float* in = sm;  // [L, KIN]
  float* x = in + L * KIN;
  float* h = x + R;
  float* zg = h + G / 2;
  float* so = zg + 2 * gc;
  float* skips = so + sc + rc;
  float* y1 = skips + S;
  float* y2 = y1 + S;
  float* yh = y2 + S;
  float* drawn = yh + a.NO;  // [sample, class index as float, -, -]
  float* part = drawn + 4;

  const float scale = sqrtf(0.5f);
  const size_t ring0 = (size_t)(b * CS + rank) * a.ring_rows * R;
  const float* cb = a.c_up + (size_t)b * T * C;
  const WT* czw = (const WT*)a.czw + (size_t)rank * L * KIN * 2 * gc;
  const float* czb = a.czb + (size_t)rank * L * 2 * gc;
  const WT* sow = (const WT*)a.sow + (size_t)rank * L * (G / 2) * (sc + rc);
  const float* sob = a.sob + (size_t)rank * L * (sc + rc);
  const size_t plane = (size_t)a.B * T;
  const float* noise = a.noise + (size_t)b * T;
  float prev = 0.f;        // last sample (scalar input)
  int prev_idx = a.first_idx;  // last class (categorical; < 0: no input)
  cluster.sync();  // every CTA started before any remote write

  for (int t = 0; t < T; ++t) {
    // older taps of every layer and this sample's conditioning, all at once
    for (int i = tid; i < L * 2 * R; i += NT) {
      const int l = i / (2 * R), j = i % (2 * R);
      const int d = a.dil[l], w = 2 * d + 1;
      const int back = j < R ? 2 * d : d;
      const int slot = ((t - back) % w + w) % w;
      in[l * KIN + j] = to_w<WT>(
          ring_ld(a.ring, ring0 + (size_t)(a.ring_off[l] + slot) * R + j % R,
                  cbf));
    }
    for (int i = tid; i < L * C; i += NT)
      in[(i / C) * KIN + 3 * R + i % C] = to_w<WT>(cb[(size_t)t * C + i % C]);
    if (a.head == CATEGORICAL) {
      for (int i = tid; i < R; i += NT)
        x[i] = (prev_idx >= 0 ? a.first_w[(size_t)prev_idx * R + i] : 0.f) +
               a.first_b[i];
    } else {
      for (int i = tid; i < R; i += NT)
        x[i] = prev * a.first_w[i] + a.first_b[i];
    }
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      float* row = in + l * KIN;
      const int w = 2 * a.dil[l] + 1;
      const size_t slot = ring0 + (size_t)(a.ring_off[l] + t % w) * R;
      for (int i = tid; i < R; i += NT) {
        row[2 * R + i] = to_w<WT>(x[i]);
        ring_st(a.ring, slot + i, x[i], cbf);
      }
      __syncthreads();
      // own gate units: columns [a (gc) | b (gc)]
      taco::matvec<DEPTH, WT, WP>(czw + (size_t)l * KIN * 2 * gc,
                          czb + (size_t)l * 2 * gc, row, KIN, 2 * gc, zg,
                          part);
      for (int i = tid; i < CS * gc; i += NT) {
        const int u = i % gc;
        const float hv =
            to_w<WT>(tanhf(zg[u]) * taco::sigmoidf(zg[gc + u]));
        cluster.map_shared_rank(h, i / gc)[rank * gc + u] = hv;
      }
      cluster.sync();  // h complete everywhere
      // own output columns: [skip (sc) | out (rc)]
      taco::matvec<DEPTH, WT, WP>(sow + (size_t)l * (G / 2) * (sc + rc),
                          sob + (size_t)l * (sc + rc), h, G / 2, sc + rc, so,
                          part);
      for (int i = tid; i < sc; i += NT) {
        float& sk = skips[rank * sc + i];
        sk = l == 0 ? so[i] : (a.legacy ? (sk + so[i]) * scale : sk + so[i]);
      }
      for (int i = tid; i < rc; i += NT) {  // new residual slice, in place
        const float xv = x[rank * rc + i] + so[sc + i];
        so[sc + i] = a.residual_legacy ? xv * scale : xv;
      }
      __syncthreads();
      for (int i = tid; i < CS * rc; i += NT)
        cluster.map_shared_rank(x, i / rc)[rank * rc + i % rc] =
            so[sc + i % rc];
      cluster.sync();  // new residual x complete everywhere
    }
    for (int i = tid; i < CS * sc; i += NT)
      cluster.map_shared_rank(skips, i / sc)[rank * sc + i % sc] =
          skips[rank * sc + i % sc];
    cluster.sync();  // all skip sums everywhere
    for (int i = tid; i < S; i += NT) y1[i] = fmaxf(skips[i], 0.f);
    __syncthreads();
    taco::matvec<DEPTH>(a.f1_w, a.f1_b, y1, S, S, y2, part);
    for (int i = tid; i < S; i += NT) y2[i] = fmaxf(y2[i], 0.f);
    __syncthreads();
    taco::matvec<DEPTH>(a.f2_w, a.f2_b, y2, S, a.NO, yh, part);
    // the draw, by warp 0 of every CTA on identical y_hat
    if (tid < 32) {
      const float u0 = noise[t];
      float smp;
      int k = 0;
      if (a.head == GAUSSIAN) {
        const float log_s = fmaxf(yh[1], a.log_scale_min);
        smp = fminf(fmaxf(yh[0] + expf(log_s) * u0, -1.f), 1.f);
      } else if (a.head == MOL) {
        const int nr = a.n_out / 3;
        k = warp_inverse_cdf(yh, nr, u0);
        const float log_s = fmaxf(yh[2 * nr + k], a.log_scale_min);
        const float u1 = fminf(fmaxf(noise[plane + t], U_LO), U_HI);
        smp = fminf(fmaxf(yh[nr + k] + expf(log_s) *
                                           (logf(u1) - logf(1.f - u1)),
                          -1.f),
                    1.f);
      } else {
        k = warp_inverse_cdf(yh, a.n_out, u0);
        smp = (float)k;
      }
      if (tid == 0) {
        drawn[0] = smp;
        drawn[1] = (float)k;
      }
    }
    __syncthreads();
    prev = drawn[0];
    prev_idx = (int)drawn[1];
    if (rank == 0 && tid == 0) a.out[(size_t)b * T + t] = prev;
  }
  cluster.sync();  // no CTA leaves while another may still address it
}

}  // namespace

extern "C" int taco_sampler_cluster_size() { return CS; }
extern "C" int taco_sampler_n_ptr() { return N_PTR; }
extern "C" int taco_sampler_n_int() { return N_INT; }

extern "C" size_t taco_sampler_smem_bytes(int L, int R, int G, int S, int C,
                                          int NO) {
  const int gc = G / 2 / CS, sc = S / CS, rc = R / CS;
  const size_t floats = (size_t)L * (3 * R + C) + R + G / 2 + 2 * gc + sc +
                        rc + 3 * S + NO + 4 + NT * 4;
  return floats * sizeof(float);
}

template <typename WT>
static int launch(const SmpArgs& a, cudaStream_t stream) {
  const size_t smem = taco_sampler_smem_bytes(a.L, a.R, a.G, a.S, a.C, a.NO);
  cudaError_t err = cudaFuncSetAttribute(
      sampler_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sampler_kernel<WT><<<a.B * CS, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ptrs: N_PTR device pointers in `Ptr` order; ints: N_INT values in `Int`
// order. Returns a CUDA error code, or 0.
extern "C" int taco_sampler_launch(const void* const* ptrs, int n_ptr,
                                   const int* ints, int n_int,
                                   float log_scale_min, void* stream) {
  if (n_ptr != N_PTR || n_int != N_INT) return (int)cudaErrorInvalidValue;
  SmpArgs a;
  a.c_up = (const float*)ptrs[P_C_UP];
  a.noise = (const float*)ptrs[P_NOISE];
  a.czw = ptrs[P_CZW];
  a.czb = (const float*)ptrs[P_CZB];
  a.sow = ptrs[P_SOW];
  a.sob = (const float*)ptrs[P_SOB];
  a.first_w = (const float*)ptrs[P_FIRST_W];
  a.first_b = (const float*)ptrs[P_FIRST_B];
  a.f1_w = (const float*)ptrs[P_F1_W];
  a.f1_b = (const float*)ptrs[P_F1_B];
  a.f2_w = (const float*)ptrs[P_F2_W];
  a.f2_b = (const float*)ptrs[P_F2_B];
  a.dil = (const int*)ptrs[P_DIL];
  a.ring_off = (const int*)ptrs[P_RING_OFF];
  a.ring = (void*)ptrs[P_RING];
  a.out = (float*)ptrs[P_OUT];
  a.B = ints[I_B];
  a.T = ints[I_T];
  a.L = ints[I_L];
  a.R = ints[I_R];
  a.G = ints[I_G];
  a.S = ints[I_S];
  a.C = ints[I_C];
  a.ring_rows = ints[I_RING_ROWS];
  a.legacy = ints[I_LEGACY];
  a.residual_legacy = ints[I_RESIDUAL_LEGACY];
  a.head = ints[I_HEAD];
  a.n_out = ints[I_N_OUT];
  a.NO = ints[I_NO];
  a.first_idx = ints[I_FIRST_IDX];
  a.cache_bf16 = ints[I_CACHE_BF16];
  a.log_scale_min = log_scale_min;
  const int weight_bf16 = ints[I_WEIGHT_BF16];
  if (a.head < GAUSSIAN || a.head > CATEGORICAL || a.NO % 4 ||
      a.n_out > a.NO || a.n_out < 2 || (a.head == MOL && a.n_out % 3))
    return (int)cudaErrorInvalidValue;
  return weight_bf16 ? launch<__nv_bfloat16>(a, (cudaStream_t)stream)
                     : launch<float>(a, (cudaStream_t)stream);
}
