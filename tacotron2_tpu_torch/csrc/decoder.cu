// Whole autoregressive Tacotron decode, one thread-block cluster per row.
//
// Replaces the TPU kernel tacotron2_tpu/ops/tacotron_decoder_kernel.py
// `build_decoder_kernel` (pallas_call at :1105). Semantics are those of
// Decoder.autoregressive with the stop sigmoid on, as the plain version
// `tacotron2_tpu_torch/models/tacotron/decoder.py:autoregressive` states
// them: per step, prenet 2×FC with the caller's dropout multipliers, zoneout
// LSTM1 on [prenet | ctx | h1], LSTM2 on [h1 | h2], location-sensitive
// attention (31-tap location conv folded with its projection into wp [K, A],
// its constant part folded into the keys by the wrapper), window constraint,
// masked softmax, cumulative weights, context, and the fused frame + stop
// projection. With early_stop_block=K a row leaves the loop at the first
// K-step boundary after its stop fired; the wrapper pre-fills the output
// with frames 0 / stop 1.0, which is what skipped steps read as.
//
// Design. A cluster of CS=8 CTAs (`__cluster_dims__`, co-scheduled by the
// hardware) runs all steps of one row in a loop with a static trip count.
// CTA `rank` owns U/CS units of each LSTM — the 4 gate columns of those
// units, re-laid contiguously by the wrapper — and M/CS columns of the
// context; after each of those products it writes its slice into every
// CTA's shared memory (distributed shared memory) and the cluster meets at
// cluster.sync(). The prenet, the attention energies, softmax and the
// projection are small and computed by every CTA on identical data, in the
// same order; rank 0 alone writes the output and decides the early stop,
// and broadcasts that flag before the step's last cluster.sync(), so every
// CTA of a cluster leaves the loop at the same step. No CTA waits on
// anything but its own __syncthreads() and its cluster's hardware barrier.
// The bf16 weights (~36 MB at the default width) are read from global
// memory every step and stay resident in the 50 MB L2; activations and sums
// are f32.
//
// Bound: the kernel is latency-bound on the L2 reads of each step's LSTM
// weights (per row, each CTA streams 1/CS of them) and on the cluster
// barriers between the products, far above its bytes or operations bound;
// sharing each weight tile between the rows of a batch (wgmma on a tile of
// rows) is the next step.
//
// Shared memory per CTA (floats, default width, T = padded input length):
// xprev mels + prenet 2P + [hpre P | ctx M | h1 U | h2 U | ctx2 M] + own c1,
// c2, new h slice 3·U/CS + gates 4U/CS + new ctx slice M/CS + matvec
// partials 512·8 + q A + cum, align 2T + proj FOp + wp K·A + 32
// ≈ 13.5k + 2T floats ≈ 55 KB + 8T bytes, under the 227 KB a CTA may use.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;
constexpr int CS = 8;                      // CTAs per row (one cluster)
constexpr int DEPTH = 16;                  // weight loads in flight a thread
constexpr float NEG_INF = -4294967295.0f;  // -(2^32) + 1, attention.py:214

struct DecArgs {
  const float* keys;    // [B, T, A] keys + folded attention bias
  const float* memory;  // [B, T, M]
  const float* mask;    // [B, T] 1/0
  const float* drop;    // [B, steps, 2, P] prenet dropout multipliers
  const __nv_bfloat16* pre_w0;  // [mels, P]
  const float* pre_b0;          // [P]
  const __nv_bfloat16* pre_w1;  // [P, P]
  const float* pre_b1;          // [P]
  const __nv_bfloat16* l1_w;    // [CS, P + M + U, 4U/CS] per-rank gate cols
  const float* l1_b;            // [CS, 4U/CS] (forget bias folded)
  const __nv_bfloat16* l2_w;    // [CS, 2U, 4U/CS]
  const float* l2_b;            // [CS, 4U/CS]
  const __nv_bfloat16* wq;      // [U, A]
  const float* wp;              // [KW, A] location taps x projection
  const float* v_a;             // [A]
  const __nv_bfloat16* proj_w;  // [U + M, FOp] rows [h2 | ctx]
  const float* proj_b;          // [FOp]
  float* out;                   // [B, steps, FO]
  int T, steps, mels, P, U, M, A, KW, r, FOp;
  int early_stop_block, constraint, win_back, win_fwd, stop_at_any;
  float zoneout;
};

// Zoneout LSTM update of this rank's Uc units: gates z = [i | j | f | o]
// (Uc each), own cell state c, the full previous h; the new h slice goes to
// hnew. Then every CTA of the cluster receives it at h[rank*Uc ...].
__device__ void lstm_update_and_share(cg::cluster_group& cluster, int rank,
                                      const float* z, float* c, float* h,
                                      float* hnew, int Uc, float zo) {
  for (int u = threadIdx.x; u < Uc; u += NT) {
    const float nc = taco::sigmoidf(z[2 * Uc + u]) * c[u] +
                     taco::sigmoidf(z[u]) * tanhf(z[Uc + u]);
    const float nh = taco::sigmoidf(z[3 * Uc + u]) * tanhf(nc);
    c[u] = (1.f - zo) * nc + zo * c[u];
    hnew[u] = (1.f - zo) * nh + zo * h[rank * Uc + u];
  }
  cluster.sync();  // every CTA is done reading the previous h
  for (int i = threadIdx.x; i < CS * Uc; i += NT) {
    float* dst = cluster.map_shared_rank(h, i / Uc);
    dst[rank * Uc + i % Uc] = hnew[i % Uc];
  }
  cluster.sync();  // the new h is complete everywhere
}

__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(NT, 1)
    decoder_kernel(const DecArgs a) {
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CS, tid = threadIdx.x;
  const int T = a.T, P = a.P, U = a.U, M = a.M, A = a.A, mels = a.mels;
  const int Uc = U / CS, Mc = M / CS;
  const int FO = a.r * mels + a.r;
  const int K1 = P + M + U;

  float* xprev = sm;
  float* hp0 = xprev + mels;
  float* vec = hp0 + P;  // [hpre | ctx | h1 | h2 | ctx2]
  float* hpre = vec;
  float* ctx = hpre + P;
  float* h1 = ctx + M;
  float* h2 = h1 + U;
  float* ctx2 = h2 + U;
  float* c1 = ctx2 + M;
  float* c2 = c1 + Uc;
  float* hnew = c2 + Uc;
  float* z = hnew + Uc;
  float* cnew = z + 4 * Uc;
  float* part = cnew + Mc;
  float* q = part + NT * 8;
  float* cum = q + A;
  float* al = cum + T;
  float* proj = al + T;
  float* wp = proj + a.FOp;
  float* red = wp + a.KW * A;
  __shared__ int ired[32];
  __shared__ int s_pmax, s_fired;

  const float* keys = a.keys + (size_t)b * T * A;
  const float* mem = a.memory + (size_t)b * T * M;
  const float* mask = a.mask + (size_t)b * T;
  const float* drop = a.drop + (size_t)b * a.steps * 2 * P;
  float* out = a.out + (size_t)b * a.steps * FO;
  const __nv_bfloat16* l1_w = a.l1_w + (size_t)rank * K1 * 4 * Uc;
  const __nv_bfloat16* l2_w = a.l2_w + (size_t)rank * 2 * U * 4 * Uc;
  const float* l1_b = a.l1_b + rank * 4 * Uc;
  const float* l2_b = a.l2_b + rank * 4 * Uc;

  const int n_state = (int)(hnew - sm);
  for (int i = tid; i < n_state; i += NT) sm[i] = 0.f;
  for (int i = tid; i < T; i += NT) cum[i] = 0.f;
  for (int i = tid; i < a.KW * A; i += NT) wp[i] = a.wp[i];
  if (tid == 0) {
    s_pmax = 0;
    s_fired = 0;
  }
  cluster.sync();  // all CTAs initialised before any remote write

  const int K = a.early_stop_block;
  const int pad = (a.KW - 1) / 2;
  const float zo = a.zoneout;
  const int lane = tid & 31, warp = tid >> 5;

  for (int t = 0; t < a.steps; ++t) {
    // s_fired is rank 0's flag, broadcast before the last cluster.sync()
    if (K > 0 && t > 0 && t % K == 0 && s_fired) break;

    // ---- prenet: 2x (FC + ReLU + dropout multiplier), on every CTA
    taco::matvec<DEPTH>(a.pre_w0, a.pre_b0, xprev, mels, P, hp0, part);
    for (int i = tid; i < P; i += NT)
      hp0[i] = fmaxf(hp0[i], 0.f) * drop[(size_t)(2 * t) * P + i];
    __syncthreads();
    taco::matvec<DEPTH>(a.pre_w1, a.pre_b1, hp0, P, P, hpre, part);
    for (int i = tid; i < P; i += NT)
      hpre[i] = fmaxf(hpre[i], 0.f) * drop[(size_t)(2 * t + 1) * P + i];
    __syncthreads();

    // ---- zoneout LSTM1 on [hpre | ctx | h1], LSTM2 on [h1 | h2]; this
    // rank's gate columns, then the new h slices are shared
    taco::matvec<DEPTH>(l1_w, l1_b, vec, K1, 4 * Uc, z, part);
    lstm_update_and_share(cluster, rank, z, c1, h1, hnew, Uc, zo);
    taco::matvec<DEPTH>(l2_w, l2_b, h1, 2 * U, 4 * Uc, z, part);
    lstm_update_and_share(cluster, rank, z, c2, h2, hnew, Uc, zo);

    // ---- location-sensitive energies, one warp per input position
    taco::matvec<DEPTH>(a.wq, (const float*)nullptr, h2, U, A, q, part);
    const int pmax = s_pmax;
    for (int tt = warp; tt < T; tt += NT / 32) {
      float acc = 0.f;
      for (int aa = lane; aa < A; aa += 32) {
        float loc = 0.f;
        for (int k = 0; k < a.KW; ++k) {
          const int s = tt + k - pad;
          if (s >= 0 && s < T) loc = fmaf(cum[s], wp[k * A + aa], loc);
        }
        acc = fmaf(a.v_a[aa], tanhf(keys[(size_t)tt * A + aa] + q[aa] + loc),
                   acc);
      }
      acc = taco::warp_sum(acc);
      if (lane == 0) {
        const bool forbidden =
            a.constraint && (tt < pmax - a.win_back || tt >= pmax + a.win_fwd);
        al[tt] = (forbidden || mask[tt] <= 0.f) ? NEG_INF : acc;
      }
    }
    __syncthreads();

    // ---- masked softmax, cumulative weights, window position
    float m = -INFINITY;
    for (int i = tid; i < T; i += NT) m = fmaxf(m, al[i]);
    m = taco::block_max(m, red);
    float s = 0.f;
    for (int i = tid; i < T; i += NT) {
      const float e = expf(al[i] - m) * mask[i];
      al[i] = e;
      s += e;
    }
    s = taco::block_sum(s, red);
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    for (int i = tid; i < T; i += NT) {
      const float v = al[i] / s;
      al[i] = v;
      cum[i] += v;
      if (v > best) {
        best = v;
        best_i = i;
      }
    }
    const int amax = taco::block_argmax(best, best_i, red, ired);
    if (tid == 0 && a.constraint) s_pmax = amax;

    // ---- this rank's context columns, shared with the cluster. Nobody
    // reads ctx between the last LSTM exchange and here, so the writes
    // need no barrier before them.
    for (int mm = tid; mm < Mc; mm += NT) {
      const int col = rank * Mc + mm;
      float acc = 0.f;
#pragma unroll 8
      for (int tt = 0; tt < T; ++tt)
        acc = fmaf(al[tt], mem[(size_t)tt * M + col], acc);
      cnew[mm] = acc;
    }
    __syncthreads();
    for (int i = tid; i < CS * Mc; i += NT) {
      const int dst_rank = i / Mc, col = rank * Mc + i % Mc;
      cluster.map_shared_rank(ctx, dst_rank)[col] = cnew[i % Mc];
      cluster.map_shared_rank(ctx2, dst_rank)[col] = cnew[i % Mc];
    }
    cluster.sync();

    // ---- fused frame + stop projection on [h2 | ctx], on every CTA
    taco::matvec<DEPTH>(a.proj_w, a.proj_b, h2, U + M, a.FOp, proj, part);
    const int nf = a.r * mels;
    if (rank == 0) {
      for (int i = tid; i < nf; i += NT) out[(size_t)t * FO + i] = proj[i];
      for (int i = tid; i < a.r; i += NT)
        out[(size_t)t * FO + nf + i] = taco::sigmoidf(proj[nf + i]);
    }
    for (int i = tid; i < mels; i += NT) xprev[i] = proj[(a.r - 1) * mels + i];
    if (rank == 0 && tid == 0 && K > 0) {
      float lo = 1.f, hi = 0.f;
      for (int i = 0; i < a.r; ++i) {
        const float sp = taco::sigmoidf(proj[nf + i]);
        lo = fminf(lo, sp);
        hi = fmaxf(hi, sp);
      }
      if ((a.stop_at_any ? hi : lo) > 0.5f)
        for (int r2 = 0; r2 < CS; ++r2)
          *cluster.map_shared_rank(&s_fired, r2) = 1;
    }
    cluster.sync();
  }
  cluster.sync();  // no CTA leaves while another may still address it
}

}  // namespace

extern "C" int taco_decoder_cluster_size() { return CS; }

extern "C" size_t taco_decoder_smem_bytes(int T, int mels, int P, int U,
                                          int M, int A, int KW, int FOp) {
  const int Uc = U / CS, Mc = M / CS;
  const size_t floats = (size_t)mels + 2 * P + 2 * M + 2 * U + 3 * Uc +
                        4 * Uc + Mc + NT * 8 + A + 2 * T + FOp + KW * A + 32;
  return floats * sizeof(float);
}

extern "C" int taco_decoder_launch(
    const void* keys, const void* memory, const void* mask, const void* drop,
    const void* pre_w0, const void* pre_b0, const void* pre_w1,
    const void* pre_b1, const void* l1_w, const void* l1_b, const void* l2_w,
    const void* l2_b, const void* wq, const void* wp, const void* v_a,
    const void* proj_w, const void* proj_b, void* out, int B, int T,
    int steps, int mels, int P, int U, int M, int A, int KW, int r, int FOp,
    int early_stop_block, int constraint, int win_back, int win_fwd,
    int stop_at_any, float zoneout, void* stream) {
  DecArgs a;
  a.keys = (const float*)keys;
  a.memory = (const float*)memory;
  a.mask = (const float*)mask;
  a.drop = (const float*)drop;
  a.pre_w0 = (const __nv_bfloat16*)pre_w0;
  a.pre_b0 = (const float*)pre_b0;
  a.pre_w1 = (const __nv_bfloat16*)pre_w1;
  a.pre_b1 = (const float*)pre_b1;
  a.l1_w = (const __nv_bfloat16*)l1_w;
  a.l1_b = (const float*)l1_b;
  a.l2_w = (const __nv_bfloat16*)l2_w;
  a.l2_b = (const float*)l2_b;
  a.wq = (const __nv_bfloat16*)wq;
  a.wp = (const float*)wp;
  a.v_a = (const float*)v_a;
  a.proj_w = (const __nv_bfloat16*)proj_w;
  a.proj_b = (const float*)proj_b;
  a.out = (float*)out;
  a.T = T;
  a.steps = steps;
  a.mels = mels;
  a.P = P;
  a.U = U;
  a.M = M;
  a.A = A;
  a.KW = KW;
  a.r = r;
  a.FOp = FOp;
  a.early_stop_block = early_stop_block;
  a.constraint = constraint;
  a.win_back = win_back;
  a.win_fwd = win_fwd;
  a.stop_at_any = stop_at_any;
  a.zoneout = zoneout;
  const size_t smem = taco_decoder_smem_bytes(T, mels, P, U, M, A, KW, FOp);
  cudaError_t err = cudaFuncSetAttribute(
      decoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decoder_kernel<<<B * CS, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
