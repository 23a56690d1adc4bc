// Tacotron teacher-forced decode, backward: the reverse-time (BPTT) chain of
// the train forward, one thread-block cluster per row.
//
// Replaces tacotron2_tpu/ops/tacotron_train_kernel.py `build_train_bwd`
// (pallas_call at :622). The wrapper is tacotron2_tpu_torch/ops/
// tacotron_train_kernel.py:teacher_forced_bwd, the plain version
// models/tacotron/decoder.py:teacher_forced_bwd_plain, whose docstring
// states the function. From the train forward's residuals (csrc/decoder.cu
// in train mode: gates z1, z2, cells c1, c2, prenet outputs h0d, hpre, the
// query q, the alignments and the cumulative alignments before each step,
// all f32) and the gradients of the frames | stop logits (dout) and of the
// alignments, it walks the steps from the last to the first and writes the
// per-step activation gradients dz1, dz2 (gates), da0, da1 (prenet
// pre-activations), dproj (with the scheduled-sampling feedback), dctx and
// dq, and per row the sums over the steps of the gradients of the keys
// (with the folded attention bias), of the folded location taps wp [K, A]
// and of v_a. The weight gradients are products outside the kernel
// (`weight_grads`, as JAX leaves them to XLA). Activations enter each
// product as they entered the forward's (with bf16 weights the cumulative
// weights and the memory rounded to bf16; with f32 weights nothing is
// rounded); gradients are f32 and are not rounded. The kernel is a
// template on the weight type W (`__nv_bfloat16` or `float`, one type for
// every matmul weight); the transposed products load 16 bytes a lane (8
// bf16 or 4 f32 weights).
//
// Carried from step t to t-1: the gradients of h1, c1, h2, c2 (each CTA
// its own units), of the context (its own columns), of the cumulative
// alignments (every CTA the whole [T]) and of the step's input frame,
// which goes into step t-1's projection gradient where coins[t] is 0.
//
// Design. The forward's cluster split of the weights is kept (the same
// `pack_weights` operands, ~36 MB in bf16 at the default width, read from
// L2 every step; ~73 MB in f32, part of which every step reads from HBM
// again): CTA `rank` of CS=8 owns the 4 gate columns of U/CS units of
// each LSTM. So it forms the gate gradients dz of its own units locally,
// and the transposed products dx = Wᵀ·dz — which sum over all 4U gate
// columns, spread over the cluster — each CTA forms as a partial over its
// own columns (one warp a weight row: the rows of its slice are
// contiguous). The cluster then reduces the partials over distributed
// shared memory as a reduce-scatter: each CTA adds, in rank order 0..CS-1,
// the partials of the units (and context columns) it owns; only the
// prenet's input gradient, which every CTA needs, is all-reduced. The
// projection's transpose is split by output rows the same way (own units,
// own context columns). The attention backward splits the input positions:
// CTA `rank` recomputes the energies' tanh for its T/CS positions (from the
// saved query and cumulative alignments: nothing [S, B, T, A]-sized is
// stored), and keeps the sums over the steps of the keys', taps' and v_a's
// gradients for them in shared memory; the partials of the dalign · memory
// product, of dq and of the location conv's transpose (a [T] vector) are
// all-reduced. Four cluster.sync() a step order every exchange; a CTA
// writes a partial buffer again only after a barrier that every reader of
// it has passed. Every sum goes in a fixed order, so the results are
// deterministic. No CTA waits on anything outside its own cluster.
//
// Bound: like the forward, latency-bound on the per-step L2 reads of the
// LSTM weights (each CTA streams its 1/CS once a step, one pass each of
// W1ᵀ and W2ᵀ, as many bytes as the forward) and on the four barriers;
// its bytes and operations bound is far below that.
//
// Shared memory per CTA (floats; Tc = ceil(T/CS), Uc = U/CS, Mc = M/CS):
// FOp + 5T (align, cum, dalign, denergy, dcum) + 3A (q, v_a, dq) + 2·K·A
// (taps, their gradient) + 4·Tc·A (own keys, their gradient, two scratch)
// + Tc·K + A + 2T + A (partials) + Uc + 3·Mc + 6·Uc + 4·Uc + 2U + (P+M+U)
// + 4P + mels + 32 ≈ 23k floats (~91 KB) at the default width and T = 96.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;
constexpr int CS = 8;     // CTAs per row: the forward's split
constexpr int ROWS = 8;   // weight rows a warp has in flight in rowdot

enum Ptr {
  P_KEYS, P_MEMORY, P_WP, P_V_A, P_PRE_W0, P_PRE_W1, P_L1_W, P_L2_W, P_WQ,
  P_PROJ_W, P_ALIGN, P_CUM, P_Q, P_Z1, P_Z2, P_C1, P_C2, P_H0D, P_HPRE,
  P_DROP, P_ZMASK, P_COINS, P_DOUT, P_DALIGN, P_DZ1, P_DZ2, P_DA0, P_DA1,
  P_DPROJ, P_DCTX, P_DQ, P_DKEYS, P_DWP, P_DVA, N_PTR
};
enum Int {
  I_B, I_T, I_S, I_MELS, I_P, I_U, I_M, I_A, I_KW, I_R, I_FOP, I_F32_WEIGHTS,
  N_INT
};

// The matmul weights (`const void*`) are of the kernel's weight type W,
// __nv_bfloat16 or float (f32_weights), one type for all of them.
struct BwdArgs {
  const float* keys;    // [B, T, A] keys + folded attention bias
  const float* memory;  // [B, T, M] rounded to bf16 with bf16 weights
  const float* wp;      // [KW, A] folded location taps (rounded likewise)
  const float* v_a;     // [A]
  const void* pre_w0;   // [mels, P]
  const void* pre_w1;   // [P, P]
  const void* l1_w;     // [CS, P + M + U, 4U/CS] per-rank gate cols
  const void* l2_w;     // [CS, 2U, 4U/CS]
  const void* wq;       // [U, A]
  const void* proj_w;   // [U + M, FOp] rows [h2 | ctx]
  // residuals [B, S, ·]
  const float *align, *cum, *q, *z1, *z2, *c1, *c2, *h0d, *hpre;
  const float* drop;     // [B, S, 2, P] prenet dropout multipliers
  const uint8_t* zmask;  // [B, S, 4, U] zoneout masks (c1, h1, c2, h2)
  const int* coins;      // [S]
  const float* dout;     // [B, S, FO] gradient of frames | stop logits
  const float* dalign;   // [B, S, T] gradient of the alignments
  // outputs
  float *dz1, *dz2;      // [B, S, 4U] natural (i, j, f, o) x U order
  float *da0, *da1;      // [B, S, P]
  float* dproj;          // [B, S, FO]
  float* dctx;           // [B, S, M]
  float* dq;             // [B, S, A]
  float* dkeys;          // [B, T, A]
  float* dwp;            // [B, CS, KW, A] per-CTA partial sums
  float* dva;            // [B, CS, A]
  int B, T, S, mels, P, U, M, A, KW, r, FOp;
};

// out[k] = (accumulate ? out[k] : 0) + sum_n w[k * N + n] * x[n], k < K:
// w [K, N] of type W row-major in global memory (N % 8 == 0, rows 16-byte
// aligned), x and out in shared memory. One warp a row, ROWS rows in
// flight a warp, lanes over V-column chunks (one 16-byte load: 8 bf16 or
// 4 f32); fixed summation order. Every thread of the block calls it; it
// ends with __syncthreads(). Out of line: its six inlined copies crowded
// the kernel's 128 registers into spills (native/time_bwd_variants.py
// times the variants).
template <typename W>
__device__ __noinline__ void rowdot(const void* wv_, const float* x, int K,
                                    int N, float* out, bool accumulate) {
  using Pk = taco::Pack<W>;
  constexpr int V = Pk::V;
  const W* __restrict__ w = static_cast<const W*>(wv_);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, nc = N / V;
  for (int k0 = warp * ROWS; k0 < K; k0 += nw * ROWS) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    for (int c = lane; c < nc; c += 32) {
      typename Pk::Raw raw[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        raw[r] = k0 + r < K ? Pk::ld(w + (size_t)(k0 + r) * N + c * V)
                            : typename Pk::Raw{};
      float xv[V];
#pragma unroll
      for (int i = 0; i < V; ++i) xv[i] = x[c * V + i];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float wv[V];
        Pk::cvt(raw[r], wv);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[r] = fmaf(wv[i], xv[i], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = taco::warp_sum(acc[r]);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (k0 + r < K) out[k0 + r] = (accumulate ? out[k0 + r] : 0.f) + acc[r];
  }
  __syncthreads();
}

// Backward of one train-mode zoneout LSTM for this rank's Uc units (the
// plain version's _lstm_bwd): gates zr [4U] (natural order), previous cell
// cp [U] (null at the first step), masks m ([c | h] of all U units), the
// gradients dh (own units) and dc (own units, updated to the previous
// cell's). Writes dz (own, [i | j | f | o] x Uc) to shared memory and to
// dz_out [4U], and dhz, the part of dh that zoned out.
__device__ void lstm_bwd(int rank, int Uc, const float* zr, const float* cp,
                         const uint8_t* m, const float* dh, float* dc,
                         float* dz, float* dhz, float* dz_out) {
  const int U = Uc * CS;
  for (int u = threadIdx.x; u < Uc; u += NT) {
    const int unit = rank * Uc + u;
    const float si = taco::sigmoidf(zr[unit]), tj = tanhf(zr[U + unit]);
    const float sf = taco::sigmoidf(zr[2 * U + unit]);
    const float so = taco::sigmoidf(zr[3 * U + unit]);
    const float c_prev = cp ? cp[unit] : 0.f;
    const float tnc = tanhf(sf * c_prev + si * tj);
    const float mc = m[unit] ? 1.f : 0.f, mh = m[U + unit] ? 1.f : 0.f;
    const float dnh = dh[u] * mh;
    const float dnc = dc[u] * mc + dnh * so * (1.f - tnc * tnc);
    const float g[4] = {dnc * tj * si * (1.f - si), dnc * si * (1.f - tj * tj),
                        dnc * c_prev * sf * (1.f - sf),
                        dnh * tnc * so * (1.f - so)};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dz[k * Uc + u] = g[k];
      dz_out[k * U + unit] = g[k];
    }
    dhz[u] = dh[u] * (1.f - mh);
    dc[u] = dc[u] * (1.f - mc) + dnc * sf;
  }
  __syncthreads();
}

// sum over the cluster's CTAs, in rank order, of buf[i] in each CTA's
// shared memory
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float* buf, int i) {
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < CS; ++r) s += cluster.map_shared_rank(buf, r)[i];
  return s;
}

template <typename W>
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(NT, 1)
    decoder_bwd_kernel(const BwdArgs a) {
  constexpr bool kBf16 = std::is_same<W, __nv_bfloat16>::value;
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CS, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = NT / 32;
  const int T = a.T, S = a.S, P = a.P, U = a.U, M = a.M, A = a.A, KW = a.KW;
  const int mels = a.mels, FOp = a.FOp;
  const int FO = a.r * mels + a.r, fb0 = (a.r - 1) * mels;
  const int Uc = U / CS, Mc = M / CS, K1 = P + M + U;
  const int Tc = (T + CS - 1) / CS, tp0 = rank * Tc;
  const int nT = max(0, min(Tc, T - tp0));  // this CTA's input positions
  const int pad = (KW - 1) / 2;

  float* dproj = sm;
  float* align = dproj + FOp;
  float* cum = align + T;      // rounded as the location features take it
  float* dal = cum + T;
  float* den = dal + T;
  float* dcum = den + T;       // gradient of the cumulative alignments
  float* q = dcum + T;
  float* va = q + A;
  float* dq = va + A;
  float* wp = dq + A;
  float* dwp = wp + KW * A;    // own positions' sum over steps
  float* keys = dwp + KW * A;  // own positions
  float* dkeys = keys + Tc * A;
  float* de = dkeys + Tc * A;
  float* ed = de + Tc * A;
  float* g = ed + Tc * A;      // [Tc, KW] de · taps
  float* dva = g + Tc * KW;
  float* part_t = dva + A;     // partials read by the whole cluster
  float* part_cum = part_t + T;
  float* part_q = part_cum + T;
  float* dh2 = part_q + A;     // own units: dh2_out, then the LSTM2 total
  float* dctx = dh2 + Uc;      // own columns, this step
  float* dctx_c = dctx + Mc;   // own columns, carried from step t+1
  float* dh1c = dctx_c + Mc;   // carried: dh1, dc1, dh2, dc2 (own units)
  float* dc1c = dh1c + Uc;
  float* dh2c = dc1c + Uc;
  float* dc2c = dh2c + Uc;
  float* dhz = dc2c + Uc;
  float* dh1 = dhz + Uc;
  float* dz = dh1 + Uc;        // own gate columns
  float* part2 = dz + 4 * Uc;  // [2U]
  float* part1 = part2 + 2 * U;  // [P + M + U]
  float* dhpre = part1 + K1;
  float* da1 = dhpre + P;
  float* dh0d = da1 + P;
  float* da0 = dh0d + P;
  float* dx = da0 + P;         // gradient of the step's input frame
  float* red = dx + mels;

  const float* mem = a.memory + (size_t)b * T * M;
  const W* l1_w = static_cast<const W*>(a.l1_w) + (size_t)rank * K1 * 4 * Uc;
  const W* l2_w = static_cast<const W*>(a.l2_w) + (size_t)rank * 2 * U * 4 * Uc;

  for (int i = tid; i < KW * A; i += NT) {
    wp[i] = a.wp[i];
    dwp[i] = 0.f;
  }
  for (int i = tid; i < A; i += NT) {
    va[i] = a.v_a[i];
    dva[i] = 0.f;
  }
  for (int i = tid; i < nT * A; i += NT) {
    keys[i] = a.keys[((size_t)b * T + tp0) * A + i];
    dkeys[i] = 0.f;
  }
  for (int i = tid; i < T; i += NT) dcum[i] = 0.f;
  for (int i = tid; i < Uc; i += NT)
    dh1c[i] = dc1c[i] = dh2c[i] = dc2c[i] = 0.f;
  for (int i = tid; i < Mc; i += NT) dctx_c[i] = 0.f;
  for (int i = tid; i < mels; i += NT) dx[i] = 0.f;
  cluster.sync();  // all CTAs initialised before any remote access

  for (int t = S - 1; t >= 0; --t) {
    const size_t row = (size_t)b * S + t;

    // ---- the projection's gradient, with the feedback into its last
    // frame; this step's residual vectors
    for (int i = tid; i < FOp; i += NT) {
      float v = i < FO ? a.dout[row * FO + i] : 0.f;
      if (i >= fb0 && i < fb0 + mels) v += dx[i - fb0];
      dproj[i] = v;
      if (rank == 0 && i < FO) a.dproj[row * FO + i] = v;
    }
    for (int i = tid; i < T; i += NT) {
      align[i] = a.align[row * T + i];
      const float c = a.cum[row * T + i];
      cum[i] = kBf16 ? taco::round_bf16(c) : c;
    }
    for (int i = tid; i < A; i += NT) q[i] = a.q[row * A + i];
    __syncthreads();

    // ---- the projection's transpose for own units and context columns
    const W* proj_w = static_cast<const W*>(a.proj_w);
    rowdot<W>(proj_w + (size_t)rank * Uc * FOp, dproj, Uc, FOp, dh2, false);
    rowdot<W>(proj_w + (size_t)(U + rank * Mc) * FOp, dproj, Mc, FOp, dctx,
              false);
    for (int i = tid; i < Mc; i += NT) {
      dctx[i] += dctx_c[i];
      a.dctx[row * M + rank * Mc + i] = dctx[i];
    }
    __syncthreads();

    // ---- dalign = memory · dctx, this CTA's columns; all-reduced
    for (int tt = warp; tt < T; tt += nw) {
      float acc = 0.f;
      for (int m = lane; m < Mc; m += 32)
        acc = fmaf(dctx[m], mem[(size_t)tt * M + rank * Mc + m], acc);
      acc = taco::warp_sum(acc);
      if (lane == 0) part_t[tt] = acc;
    }
    cluster.sync();  // S1: the dalign partials are complete
    for (int i = tid; i < T; i += NT)
      dal[i] = cluster_sum(cluster, part_t, i) + a.dalign[row * T + i] +
               dcum[i];
    __syncthreads();

    // ---- softmax backward (masked positions have align 0: no gradient)
    float dot = 0.f;
    for (int i = tid; i < T; i += NT) dot = fmaf(dal[i], align[i], dot);
    dot = taco::block_sum(dot, red);
    for (int i = tid; i < T; i += NT) den[i] = align[i] * (dal[i] - dot);
    __syncthreads();

    // ---- own positions: the energies' tanh again, its gradient
    for (int idx = tid; idx < nT * A; idx += NT) {
      const int i = idx / A, aa = idx % A, tt = tp0 + i;
      float loc = 0.f;
      for (int k = 0; k < KW; ++k) {
        const int si = tt + k - pad;
        if (si >= 0 && si < T) loc = fmaf(cum[si], wp[k * A + aa], loc);
      }
      const float e = tanhf(keys[idx] + q[aa] + loc);
      const float d = den[tt] * va[aa] * (1.f - e * e);
      de[idx] = d;
      ed[idx] = e * den[tt];
      dkeys[idx] += d;
    }
    __syncthreads();
    // dq and dv_a over own positions; the taps' gradient; de · taps
    for (int aa = tid; aa < A; aa += NT) {
      float sq = 0.f, sv = 0.f;
      for (int i = 0; i < nT; ++i) {
        sq += de[i * A + aa];
        sv += ed[i * A + aa];
      }
      part_q[aa] = sq;
      dva[aa] += sv;
    }
    for (int idx = tid; idx < KW * A; idx += NT) {
      const int k = idx / A, aa = idx % A;
      float acc = 0.f;
      for (int i = 0; i < nT; ++i) {
        const int si = tp0 + i + k - pad;
        if (si >= 0 && si < T) acc = fmaf(cum[si], de[i * A + aa], acc);
      }
      dwp[idx] += acc;
    }
    for (int p = warp; p < nT * KW; p += nw) {
      const int i = p / KW, k = p % KW;
      float acc = 0.f;
      for (int aa = lane; aa < A; aa += 32)
        acc = fmaf(de[i * A + aa], wp[k * A + aa], acc);
      acc = taco::warp_sum(acc);
      if (lane == 0) g[p] = acc;
    }
    __syncthreads();
    // the location conv's transpose: position s takes g[i, s - tt_i + pad]
    for (int s = tid; s < T; s += NT) {
      float acc = 0.f;
      for (int i = 0; i < nT; ++i) {
        const int k = s - (tp0 + i) + pad;
        if (k >= 0 && k < KW) acc += g[i * KW + k];
      }
      part_cum[s] = acc;
    }
    cluster.sync();  // S2: dq and dcum partials are complete
    for (int i = tid; i < A; i += NT) {
      dq[i] = cluster_sum(cluster, part_q, i);
      if (rank == 0) a.dq[row * A + i] = dq[i];
    }
    for (int i = tid; i < T; i += NT) dcum[i] += cluster_sum(cluster, part_cum, i);
    __syncthreads();

    // ---- LSTM2: dh = projection + attention query + carried
    rowdot<W>(static_cast<const W*>(a.wq) + (size_t)rank * Uc * A, dq, Uc, A,
              dh2, true);
    for (int i = tid; i < Uc; i += NT) dh2[i] += dh2c[i];
    __syncthreads();
    const uint8_t* zm = a.zmask + row * 4 * U;
    lstm_bwd(rank, Uc, a.z2 + row * 4 * U, t ? a.c2 + (row - 1) * U : nullptr,
             zm + 2 * U, dh2, dc2c, dz, dhz, a.dz2 + row * 4 * U);
    rowdot<W>(l2_w, dz, 2 * U, 4 * Uc, part2, false);
    cluster.sync();  // S3: the W2ᵀ·dz2 partials are complete
    for (int u = tid; u < Uc; u += NT) {
      const int unit = rank * Uc + u;
      dh2c[u] = dhz[u] + cluster_sum(cluster, part2, U + unit);
      dh1[u] = cluster_sum(cluster, part2, unit) + dh1c[u];
    }
    __syncthreads();

    // ---- LSTM1
    lstm_bwd(rank, Uc, a.z1 + row * 4 * U, t ? a.c1 + (row - 1) * U : nullptr,
             zm, dh1, dc1c, dz, dhz, a.dz1 + row * 4 * U);
    rowdot<W>(l1_w, dz, K1, 4 * Uc, part1, false);
    cluster.sync();  // S4: the W1ᵀ·dz1 partials are complete
    for (int i = tid; i < P; i += NT) dhpre[i] = cluster_sum(cluster, part1, i);
    for (int i = tid; i < Mc; i += NT)
      dctx_c[i] = cluster_sum(cluster, part1, P + rank * Mc + i);
    for (int u = tid; u < Uc; u += NT)
      dh1c[u] = dhz[u] + cluster_sum(cluster, part1, P + M + rank * Uc + u);
    __syncthreads();

    // ---- prenet (every CTA): relu and dropout through the saved outputs'
    // sign and the multipliers; the input frame's gradient feeds step t-1
    const float* drop = a.drop + row * 2 * P;
    for (int i = tid; i < P; i += NT) {
      da1[i] = a.hpre[row * P + i] > 0.f ? dhpre[i] * drop[P + i] : 0.f;
      if (rank == 0) a.da1[row * P + i] = da1[i];
    }
    __syncthreads();
    rowdot<W>(a.pre_w1, da1, P, P, dh0d, false);
    for (int i = tid; i < P; i += NT) {
      da0[i] = a.h0d[row * P + i] > 0.f ? dh0d[i] * drop[i] : 0.f;
      if (rank == 0) a.da0[row * P + i] = da0[i];
    }
    __syncthreads();
    if (a.coins[t]) {
      for (int i = tid; i < mels; i += NT) dx[i] = 0.f;
      __syncthreads();
    } else {
      rowdot<W>(a.pre_w0, da0, mels, P, dx, false);
    }
  }

  // ---- the sums over the steps
  for (int i = tid; i < nT * A; i += NT)
    a.dkeys[((size_t)b * T + tp0) * A + i] = dkeys[i];
  float* dwp_out = a.dwp + ((size_t)b * CS + rank) * KW * A;
  for (int i = tid; i < KW * A; i += NT) dwp_out[i] = dwp[i];
  for (int i = tid; i < A; i += NT)
    a.dva[((size_t)b * CS + rank) * A + i] = dva[i];
  cluster.sync();  // no CTA leaves while another may still read it
}

}  // namespace

extern "C" int taco_decoder_bwd_cluster_size() { return CS; }
extern "C" int taco_decoder_bwd_n_ptr() { return N_PTR; }
extern "C" int taco_decoder_bwd_n_int() { return N_INT; }

extern "C" size_t taco_decoder_bwd_smem_bytes(int T, int mels, int P, int U,
                                              int M, int A, int KW, int FOp,
                                              int r) {
  (void)r;
  const int Uc = U / CS, Mc = M / CS, Tc = (T + CS - 1) / CS;
  const size_t floats = (size_t)FOp + 5 * T + 3 * A + 2 * KW * A +
                        4 * Tc * A + Tc * KW + A + 2 * T + A + Uc + 2 * Mc +
                        4 * Uc + 2 * Uc + 4 * Uc + 2 * U + (P + M + U) +
                        4 * P + mels + 32;
  return floats * sizeof(float);
}

// ptrs: N_PTR device pointers in `Ptr` order; ints: N_INT values in `Int`
// order. Returns a CUDA error code, or 0.
extern "C" int taco_decoder_bwd_launch(const void* const* ptrs, int n_ptr,
                                       const int* ints, int n_int,
                                       void* stream) {
  if (n_ptr != N_PTR || n_int != N_INT) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < N_PTR; ++i)
    if (!ptrs[i]) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.keys = (const float*)ptrs[P_KEYS];
  a.memory = (const float*)ptrs[P_MEMORY];
  a.wp = (const float*)ptrs[P_WP];
  a.v_a = (const float*)ptrs[P_V_A];
  a.pre_w0 = ptrs[P_PRE_W0];
  a.pre_w1 = ptrs[P_PRE_W1];
  a.l1_w = ptrs[P_L1_W];
  a.l2_w = ptrs[P_L2_W];
  a.wq = ptrs[P_WQ];
  a.proj_w = ptrs[P_PROJ_W];
  a.align = (const float*)ptrs[P_ALIGN];
  a.cum = (const float*)ptrs[P_CUM];
  a.q = (const float*)ptrs[P_Q];
  a.z1 = (const float*)ptrs[P_Z1];
  a.z2 = (const float*)ptrs[P_Z2];
  a.c1 = (const float*)ptrs[P_C1];
  a.c2 = (const float*)ptrs[P_C2];
  a.h0d = (const float*)ptrs[P_H0D];
  a.hpre = (const float*)ptrs[P_HPRE];
  a.drop = (const float*)ptrs[P_DROP];
  a.zmask = (const uint8_t*)ptrs[P_ZMASK];
  a.coins = (const int*)ptrs[P_COINS];
  a.dout = (const float*)ptrs[P_DOUT];
  a.dalign = (const float*)ptrs[P_DALIGN];
  a.dz1 = (float*)ptrs[P_DZ1];
  a.dz2 = (float*)ptrs[P_DZ2];
  a.da0 = (float*)ptrs[P_DA0];
  a.da1 = (float*)ptrs[P_DA1];
  a.dproj = (float*)ptrs[P_DPROJ];
  a.dctx = (float*)ptrs[P_DCTX];
  a.dq = (float*)ptrs[P_DQ];
  a.dkeys = (float*)ptrs[P_DKEYS];
  a.dwp = (float*)ptrs[P_DWP];
  a.dva = (float*)ptrs[P_DVA];
  a.B = ints[I_B];
  a.T = ints[I_T];
  a.S = ints[I_S];
  a.mels = ints[I_MELS];
  a.P = ints[I_P];
  a.U = ints[I_U];
  a.M = ints[I_M];
  a.A = ints[I_A];
  a.KW = ints[I_KW];
  a.r = ints[I_R];
  a.FOp = ints[I_FOP];
  if (a.S < 1 || a.U % CS || a.M % CS || (4 * a.U / CS) % 8 || a.P % 8 ||
      a.A % 8 || a.FOp % 8 || a.FOp < a.r * a.mels + a.r)
    return (int)cudaErrorInvalidValue;
  const size_t smem = taco_decoder_bwd_smem_bytes(
      a.T, a.mels, a.P, a.U, a.M, a.A, a.KW, a.FOp, a.r);
  void (*kernel)(const BwdArgs) = ints[I_F32_WEIGHTS]
                                      ? decoder_bwd_kernel<float>
                                      : decoder_bwd_kernel<__nv_bfloat16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B * CS, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
