// Whole WaveNet sample loop (Gaussian head), one thread-block cluster per
// batch row.
//
// Replaces the TPU kernel tacotron2_tpu/ops/wavenet_kernel.py
// `build_sampler_kernel` (pallas_call at :313) and its HBM-delay variant
// `build_sampler_kernel_hbm` (:566), which give bit-identical results, for
// the Gaussian head of `_HeadPlan` (:56). Per sample and layer: the kw=3
// dilated conv over the taps (x_{t-2d}, x_{t-d}, x_t) and the 1x1
// conditioning projection of c_up[t] as ONE matvec against the stacked
// weight czw [3R + C, G] (the TPU kernel's fusion), tanh·σ gate, and h @
// [skip | out] as one matvec, with √0.5 residual/skip scaling; then the
// ReLU head and sample = clip(mean + exp(max(log_s, log_scale_min)) · z,
// -1, 1) (wavenet_kernel.py:151-158), fed back as the next input. The
// standard normals z come from the caller.
//
// Design. A cluster of CS=8 CTAs (`__cluster_dims__`, co-scheduled by the
// hardware) loops over all T samples of one row with a static trip count.
// In every layer CTA `rank` computes the gate pairs (a, b) of its G/(2·CS)
// units, then its S/CS skip and R/CS residual columns; the wrapper lays
// those weight columns out contiguously per rank. The new h and the new residual x are exchanged
// through distributed shared memory with one cluster.sync() each; skip
// sums stay with their owner until the layer loop ends, then one exchange
// gives every CTA all of them. Every CTA then runs the small head on the
// same data in the same order and so draws the same sample; rank 0 writes
// it out. Each CTA keeps its own copy of the delay rings in global memory
// (2d+1 rows of R floats per layer, 2.1 MB at the default 20 layers), so no
// CTA reads global memory another one wrote. The older taps of every layer
// and c_up[t] are fetched once at the start of each sample. The
// conditioning projection is computed per sample inside the layer's matvec,
// so no [B, T, L·G] tensor exists. Weights are f32 (~12 MB at the default
// width) and stay resident in L2. No CTA waits on anything but its own
// __syncthreads() and its cluster's hardware barrier, and every CTA of a
// cluster passes the same barriers (no data-dependent control flow).
//
// Bound: the serial chain of 20 layers per sample makes the kernel
// latency-bound — per layer one L2 read of 1/CS of the layer's weights and
// two cluster barriers — far above its bytes or operations bound. Sharing
// weight tiles between the rows of a batch is the next step.
//
// Shared memory per CTA (floats, default width): per-layer input rows
// L·(3R + C) + x R + h G/2 + own gate and output columns 2·32 + skips S +
// head 2S + 4 + matvec partials 512·4 ≈ 12.1k floats ≈ 48 KB.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;
constexpr int CS = 8;     // CTAs per row (one cluster)
constexpr int DEPTH = 8;  // weight loads in flight a thread

struct SmpArgs {
  const float* c_up;   // [B, T, C]
  const float* z;      // [B, T]
  const float* czw;    // [CS, L, 3R + C, 2·gc]  (a | b) columns of own units
  const float* czb;    // [CS, L, 2·gc]
  const float* sow;    // [CS, L, G/2, sc + rc]  (skip | out) own columns
  const float* sob;    // [CS, L, sc + rc]
  const float* first_w;  // [R]
  const float* first_b;  // [R]
  const float* f1_w;   // [S, S]
  const float* f1_b;   // [S]
  const float* f2_w;   // [S, 4] (mean, log_scale, 0, 0)
  const float* f2_b;   // [4]
  const int* dil;      // [L]
  const int* ring_off;  // [L] row offset of each layer's ring
  float* ring;         // [B, CS, ring_rows, R], zero on entry
  float* out;          // [B, T]
  int T, L, R, G, S, C, ring_rows, legacy, residual_legacy;
  float log_scale_min;
};

__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(NT, 1)
    sampler_kernel(const SmpArgs a) {
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CS, tid = threadIdx.x;
  const int R = a.R, G = a.G, S = a.S, C = a.C, T = a.T, L = a.L;
  const int KIN = 3 * R + C;
  const int gc = G / 2 / CS, sc = S / CS, rc = R / CS;
  float* in = sm;  // [L, KIN]
  float* x = in + L * KIN;
  float* h = x + R;
  float* zg = h + G / 2;
  float* so = zg + 2 * gc;
  float* skips = so + sc + rc;
  float* y1 = skips + S;
  float* y2 = y1 + S;
  float* yh = y2 + S;
  float* part = yh + 4;

  const float scale = sqrtf(0.5f);
  float* ring = a.ring + (size_t)(b * CS + rank) * a.ring_rows * R;
  const float* cb = a.c_up + (size_t)b * T * C;
  const float* czw = a.czw + (size_t)rank * L * KIN * 2 * gc;
  const float* czb = a.czb + (size_t)rank * L * 2 * gc;
  const float* sow = a.sow + (size_t)rank * L * (G / 2) * (sc + rc);
  const float* sob = a.sob + (size_t)rank * L * (sc + rc);
  float prev = 0.f;
  cluster.sync();  // every CTA started before any remote write

  for (int t = 0; t < T; ++t) {
    // older taps of every layer and this sample's conditioning, all at once
    for (int i = tid; i < L * 2 * R; i += NT) {
      const int l = i / (2 * R), j = i % (2 * R);
      const int d = a.dil[l], w = 2 * d + 1;
      const int back = j < R ? 2 * d : d;
      const int slot = ((t - back) % w + w) % w;
      in[l * KIN + j] = ring[(size_t)(a.ring_off[l] + slot) * R + j % R];
    }
    for (int i = tid; i < L * C; i += NT)
      in[(i / C) * KIN + 3 * R + i % C] = cb[(size_t)t * C + i % C];
    for (int i = tid; i < R; i += NT) x[i] = prev * a.first_w[i] + a.first_b[i];
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      float* row = in + l * KIN;
      const int w = 2 * a.dil[l] + 1;
      float* slot = ring + (size_t)(a.ring_off[l] + t % w) * R;
      for (int i = tid; i < R; i += NT) {
        row[2 * R + i] = x[i];
        slot[i] = x[i];
      }
      __syncthreads();
      // own gate units: columns [a (gc) | b (gc)]
      taco::matvec<DEPTH>(czw + (size_t)l * KIN * 2 * gc,
                          czb + (size_t)l * 2 * gc, row, KIN, 2 * gc, zg,
                          part);
      for (int i = tid; i < CS * gc; i += NT) {
        const int u = i % gc;
        const float hv = tanhf(zg[u]) * taco::sigmoidf(zg[gc + u]);
        cluster.map_shared_rank(h, i / gc)[rank * gc + u] = hv;
      }
      cluster.sync();  // h complete everywhere
      // own output columns: [skip (sc) | out (rc)]
      taco::matvec<DEPTH>(sow + (size_t)l * (G / 2) * (sc + rc),
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
    taco::matvec<DEPTH>(a.f2_w, a.f2_b, y2, S, 4, yh, part);
    const float log_s = fmaxf(yh[1], a.log_scale_min);
    prev = fminf(fmaxf(yh[0] + expf(log_s) * a.z[(size_t)b * T + t], -1.f),
                 1.f);
    if (rank == 0 && tid == 0) a.out[(size_t)b * T + t] = prev;
  }
  cluster.sync();  // no CTA leaves while another may still address it
}

}  // namespace

extern "C" int taco_sampler_cluster_size() { return CS; }

extern "C" size_t taco_sampler_smem_bytes(int L, int R, int G, int S, int C) {
  const int gc = G / 2 / CS, sc = S / CS, rc = R / CS;
  const size_t floats = (size_t)L * (3 * R + C) + R + G / 2 + 2 * gc + sc +
                        rc + 3 * S + 4 + NT * 4;
  return floats * sizeof(float);
}

extern "C" int taco_sampler_launch(
    const void* c_up, const void* z, const void* czw, const void* czb,
    const void* sow, const void* sob, const void* first_w,
    const void* first_b, const void* f1_w, const void* f1_b,
    const void* f2_w, const void* f2_b, const void* dil, const void* ring_off,
    void* ring, void* out, int B, int T, int L, int R, int G, int S, int C,
    int ring_rows, int legacy, int residual_legacy, float log_scale_min,
    void* stream) {
  SmpArgs a;
  a.c_up = (const float*)c_up;
  a.z = (const float*)z;
  a.czw = (const float*)czw;
  a.czb = (const float*)czb;
  a.sow = (const float*)sow;
  a.sob = (const float*)sob;
  a.first_w = (const float*)first_w;
  a.first_b = (const float*)first_b;
  a.f1_w = (const float*)f1_w;
  a.f1_b = (const float*)f1_b;
  a.f2_w = (const float*)f2_w;
  a.f2_b = (const float*)f2_b;
  a.dil = (const int*)dil;
  a.ring_off = (const int*)ring_off;
  a.ring = (float*)ring;
  a.out = (float*)out;
  a.T = T;
  a.L = L;
  a.R = R;
  a.G = G;
  a.S = S;
  a.C = C;
  a.ring_rows = ring_rows;
  a.legacy = legacy;
  a.residual_legacy = residual_legacy;
  a.log_scale_min = log_scale_min;
  const size_t smem = taco_sampler_smem_bytes(L, R, G, S, C);
  cudaError_t err = cudaFuncSetAttribute(
      sampler_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sampler_kernel<<<B * CS, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
