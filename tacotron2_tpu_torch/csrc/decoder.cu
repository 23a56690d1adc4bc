// Tacotron decode under emt_attn: a block of autoregressive steps from
// explicit state, one thread-block cluster per row.
//
// Replaces, of tacotron2_tpu/ops/tacotron_decoder_kernel.py,
// `build_decoder_block_kernel` (K steps from carried state, pallas_call at
// :700) with its in-kernel emt_attn scorers (:508-553, below). Every other
// decode is csrc/decoder_rows.cu, one cluster for 8 rows: the
// autoregressive decode without emt_attn (`build_decoder_kernel`, :1105,
// and the block kernel without the scorers) and the teacher-forced decode
// (tacotron2_tpu/ops/tacotron_train_kernel.py `build_train_fwd`, :325);
// this source keeps the emt mode alone. Semantics are those of
// Decoder.autoregressive with the stop sigmoid on, as the plain version
// `tacotron2_tpu_torch/models/tacotron/decoder.py:decode_block` states
// them: per step, prenet 2×FC with the caller's dropout multipliers, zoneout
// LSTM1 on [prenet | ctx | ctx_emt | h1], LSTM2 on [h1 | h2], the emt
// attention, location-sensitive attention (the location conv folded with
// its projection into wp [K, A], its constant part folded into the keys by
// the wrapper), window constraint, masked softmax, cumulative weights,
// context, and the fused frame + stop projection.
//
// One launch runs `nsteps` steps (global steps t0 .. t0+nsteps-1 of arrays
// laid out for s_total steps) from the state (xprev, c1, h1, c2, h2, ctx,
// ctx_emt, cum, pmax) in global memory and writes the state after them,
// the frames and stop probabilities, optionally the alignments, and the
// row's sticky stop flag (set once all r stop probabilities of a step
// exceed 0.5, or any with stop_at_any). The TPU kernels' early stop — skip
// the rest once every row of the batch has fired at a block boundary — is
// a chain of launches on one stream: each launch counts its fired rows
// into a fresh slot; given fired_in, a launch first reads the previous
// launch's count and returns at once if all rows have fired (counting them
// forward), and the wrapper has pre-filled the outputs with what a skipped
// step reads as (frames 0, stop 1.0, alignments 0). Stream order makes the
// previous launch's flags visible; no launch waits on another CTA outside
// its own cluster. State in and out may alias: every read of it precedes
// the first cluster.sync(), every write follows the last.
//
// Weights and rounding. The kernel is a template on the weight type W of
// every matmul weight (`__nv_bfloat16` or `float`, one type for all,
// `tacotron.fused_decoder_dtype`). With bf16 weights every activation is
// rounded to bf16 where it enters a product — the matvec inputs, the
// cumulative weights of the location features, the alignment of the
// context, the emt alignment — as the TPU kernels do
// (`x.astype(weight_dtype)`); the wrapper rounds the memory, the location
// taps, the emt keys and memory once, and as the block kernel does the
// keys and v_a. Each such value is rounded once, where it is made, into a
// copy in shared memory that the products read (`put`), not once per
// column group inside the product loop. Sums and the carried state stay
// f32. With f32 weights nothing is rounded and the products run on the
// FP32 cores (no tensor cores, no TF32: JAX's f32 kernel is the scan's
// function up to op order). `smoothing` (runtime) normalises the masked
// sigmoids of the energies in place of the softmax, as the TPU kernel does
// (:598-600); the argmax, the cumulative sum and the context are shared.
//
// The emt attention. The Tacotron_emt_attn variant attends, besides the
// text, over the emotion reference's sequence: Te positions of V values
// (the emt memory, Te = ceil(T_ref / 64), 16 at a 1,000-frame reference).
// LSTM1 takes [hpre | ctx | ctx_emt | h1] (E more rows of its gate
// columns) and its bias as a per-row operand (`l1_brow`, [B, CS, 4U/CS]:
// the wrapper folds ref_spk's addend in where it is fed). After LSTM2 each
// CTA computes the next ctx_emt from h2 (the plain version is
// models/tacotron/decoder.py:_step, `emt_context`): qe = h2 · W2e ([U,
// A2]); per position t and score row h, e_h[t] = score[h] · tanh(ekeys[t]
// + qe), every constant of the keys folded in by the wrapper; a softmax
// over t per row; the row's context, the weighted sum of the emt memory
// rows. `simple` has one score row (v) and its context is ctx_emt (E =
// V); `multihead` has H rows, row h the normed v in head h's columns and 0
// elsewhere (one tanh for all heads, as the TPU kernel does), and its H
// contexts [H·V] go through the attn_emt_out Dense [H·V, E] + b. The emt
// keys, memory and score rows are loaded into shared memory once a
// launch. Every CTA computes the scorer on identical data, as it does the
// location attention, so no barrier or exchange is added; that reads W2e
// (512 KB bf16 for simple at the default width) and attn_emt_out (256 KB)
// in every CTA every step, ~25% more than the LSTM weights each CTA reads.
// Splitting both by columns over the 8 ranks, their slices riding the
// existing DSMEM exchanges, is the next step.
//
// Design. A cluster of CS=8 CTAs (`__cluster_dims__`, co-scheduled by the
// hardware) runs the steps of one row in a loop with a static trip count.
// CTA `rank` owns U/CS units of each LSTM — the 4 gate columns of those
// units, re-laid contiguously by the wrapper — and M/CS columns of the
// context; after each of those products it writes its slice into every
// CTA's shared memory (distributed shared memory) and the cluster meets at
// cluster.sync(). The prenet, the attention energies, softmax and the
// projection are small and computed by every CTA on identical data, in the
// same order; rank 0 alone writes the outputs and the state it shares with
// the cluster. No CTA waits on anything but its own __syncthreads() and its
// cluster's hardware barrier. The bf16 weights (~36 MB at the default
// width) are read from global memory every step and stay resident in the
// 50 MB L2; activations and sums are f32. The f32 weights (~73 MB) do not
// fit it: every step reads the part the L2 does not hold from HBM again.
// The attention works at any input length T that fits shared memory (one
// warp per input position).
//
// Bound: the kernel is latency-bound on the L2 reads of each step's LSTM
// weights (per row, each CTA streams 1/CS of them) and on the cluster
// barriers between the products, far above its bytes or operations bound;
// csrc/decoder_rows.cu's design (one cluster for 8 rows, each weight tile
// read once for all of them on the tensor cores) is the next step here.
//
// Shared memory per CTA (floats, default width, T = input length):
// xprev mels + prenet 2P + [hpre P | ctx M | ctx_emt E | h1 U | h2 U | ctx2
// M] + own c1, c2, new h slice 3·U/CS + gates 4U/CS + new ctx slice M/CS +
// matvec partials 512·8 + q A + cum, align 2T + proj FOp + wp K·A + 32,
// and the rounded copies of the head, cum and align (mels + 2P + 2M + E +
// 2U + 2T; the f32 kernel reserves them too) + the emt operands E +
// Te·(A2 + V) + NH·(A2 + Te + V) + A2 floats (≈ 43 KB at Te = 16, A2 = V =
// 256): ≈ 112 KB + 16T bytes, under the 227 KB a CTA may use.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;
constexpr int CS = 8;                      // CTAs per row (one cluster)
constexpr int DEPTH = 16;                  // weight loads in flight a thread
constexpr int MAXH = 8;                    // emt score rows (heads) at most
constexpr float NEG_INF = -4294967295.0f;  // -(2^32) + 1, attention.py:214

// Pointer and integer operands, in the order the C entry point takes them.
enum Ptr {
  P_KEYS, P_MEMORY, P_MASK, P_DROP,
  P_PRE_W0, P_PRE_B0, P_PRE_W1, P_PRE_B1, P_L1_W, P_L2_W, P_L2_B,
  P_WQ, P_WP, P_V_A, P_PROJ_W, P_PROJ_B,
  P_STATE_IN, P_CUM_IN, P_PMAX_IN, P_STATE_OUT, P_CUM_OUT, P_PMAX_OUT,
  P_FIRED_IN, P_FIRED_OUT, P_OUT, P_ALIGN,
  P_EKEYS, P_ESCORE, P_EMEM, P_L1_BROW, P_W2E, P_EOUT_W, P_EOUT_B, N_PTR
};
enum Int {
  I_B, I_T, I_T0, I_NSTEPS, I_STOTAL, I_MELS, I_P, I_U, I_M, I_A, I_KW, I_R,
  I_FOP, I_CONSTRAINT, I_WIN_BACK, I_WIN_FWD, I_STOP_AT_ANY,
  I_E, I_TE, I_A2, I_EV, I_NH, I_F32_WEIGHTS, I_SMOOTHING, I_TANH_BF16, N_INT
};

// The matmul weights (`const void*`) are of the kernel's weight type W:
// __nv_bfloat16 or float (f32_weights), one type for all of them.
struct DecArgs {
  const float* keys;    // [B, T, A] keys + folded attention bias
  const float* memory;  // [B, T, M]
  const float* mask;    // [B, T] 1/0
  const float* drop;    // [B, s_total, 2, P] prenet dropout multipliers
  const void* pre_w0;           // [mels, P]
  const float* pre_b0;          // [P]
  const void* pre_w1;           // [P, P]
  const float* pre_b1;          // [P]
  const void* l1_w;             // [CS, P + M + E + U, 4U/CS] per-rank gate
                                // columns, rows [prenet | ctx | ctx_emt | h1]
  const void* l2_w;             // [CS, 2U, 4U/CS]
  const float* l2_b;            // [CS, 4U/CS]
  const void* wq;               // [U, A]
  const float* wp;              // [KW, A] location taps x projection
  const float* v_a;             // [A]
  const void* proj_w;           // [U + M, FOp] rows [h2 | ctx]
  const float* proj_b;          // [FOp]
  // state in / out: each row's vector [xprev | hp0 | hpre | ctx | ctx_emt
  // | h1 | h2 | ctx2 | (c1, c2 of rank 0) | ... | (c1, c2 of rank CS-1)],
  // laid out as
  // the head of the CTA's shared memory (`taco_decoder_state_floats`), so
  // one loop copies it; cum [B, T]; pmax [B]
  const float* state_in;
  const float* cum_in;
  const int* pmax_in;
  float* state_out;
  float* cum_out;
  int* pmax_out;
  const int* fired_in;  // [B + 1] sticky stop flags before this launch and
                        // their count at [B], or null
  int* fired_out;       // [B + 1] after it (the count starts at 0), or null
  float* out;           // [B, s_total, FO] frames | stop probabilities
  float* align;         // [B, s_total, T] alignments, or null
  // the emt attention: keys with their constants folded [B, Te, A2], score
  // rows [NH, A2], emt memory [B, Te, EV], the per-row LSTM1 bias [B, CS,
  // 4U/CS] (forget bias folded), the query weight [U, A2], and for
  // multihead the output Dense [NH·EV, E], [E] (else null)
  const float* ekeys;
  const float* escore;
  const float* emem;
  const float* l1_brow;
  const void* w2e;
  const void* eout_w;
  const float* eout_b;
  int T, t0, nsteps, s_total, mels, P, U, M, A, KW, r, FOp;
  int B, constraint, win_back, win_fwd, stop_at_any;
  int E, Te, A2, EV, NH;
  int smoothing;  // normalised sigmoids in place of the softmax
  int tanh_bf16;  // round the energies' tanh where it meets v_a
  float zoneout;
};

// With bf16 weights every activation is rounded to bf16 where it enters a
// product (see the note); with f32 weights nothing is.
template <typename W>
__host__ __device__ constexpr bool rounds() {
  return std::is_same<W, __nv_bfloat16>::value;
}

// p[i] = v, and with bf16 weights its rounded copy pr[i] = bf16(v): each
// value that enters a product is rounded once, where it is made, and the
// products read the copy (with f32 weights pr is p and nothing is copied).
template <typename W>
__device__ __forceinline__ void put(float* p, float* pr, int i, float v) {
  p[i] = v;
  if constexpr (rounds<W>()) pr[i] = taco::round_bf16(v);
}

// This rank's product on x in shared memory (a rounded copy with bf16
// weights).
template <typename W>
__device__ __forceinline__ void mv(const void* w, const float* bias,
                                   const float* x, int K, int N, float* out,
                                   float* part) {
  taco::matvec<DEPTH, W>(static_cast<const W*>(w), bias, x, K, N, out, part);
}

// Zoneout LSTM update (the EMA mix) of this rank's Uc units: gates z =
// [i | j | f | o] (Uc each), own cell state c, the full previous h; the new
// h slice goes to hnew. Then every CTA of the cluster receives the new h at
// h[rank*Uc ...] and its rounded copy at hr (see `put`).
template <typename W>
__device__ void lstm_update_and_share(cg::cluster_group& cluster, int rank,
                                      const float* z, float* c, float* h,
                                      float* hr, float* hnew, int Uc,
                                      float zo) {
  for (int u = threadIdx.x; u < Uc; u += NT) {
    const float nc = taco::sigmoidf(z[2 * Uc + u]) * c[u] +
                     taco::sigmoidf(z[u]) * tanhf(z[Uc + u]);
    const float nh = taco::sigmoidf(z[3 * Uc + u]) * tanhf(nc);
    c[u] = (1.f - zo) * nc + zo * c[u];
    hnew[u] = (1.f - zo) * nh + zo * h[rank * Uc + u];
  }
  cluster.sync();  // every CTA is done reading the previous h
  for (int i = threadIdx.x; i < CS * Uc; i += NT)
    put<W>(cluster.map_shared_rank(h, i / Uc),
           cluster.map_shared_rank(hr, i / Uc), rank * Uc + i % Uc,
           hnew[i % Uc]);
  cluster.sync();  // the new h is complete everywhere
}

// The emt attention of one step (emt_attn mode, see the note): qe = h2 ·
// W2e (h2r: h2's rounded copy), the NH score rows' energies over the Te
// positions, a softmax per row, the contexts over the emt memory, and for
// multihead the output Dense; the next ctx_emt lands in `cte`, its rounded
// copy in `cter`. Every thread of the CTA calls it.
template <typename W>
__device__ void emt_attention(const DecArgs& a, const float* h2r,
                              const float* ekeys, const float* escore,
                              const float* emem, float* qe, float* een,
                              float* ctxmh, float* cte, float* cter,
                              float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Te = a.Te, A2 = a.A2, NH = a.NH, EV = a.EV;
  mv<W>(a.w2e, nullptr, h2r, a.U, A2, qe, part);
  // one warp per position: one tanh per column, NH dot products
  for (int tt = warp; tt < Te; tt += NT / 32) {
    float acc[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) acc[h] = 0.f;
    for (int aa = lane; aa < A2; aa += 32) {
      const float th = tanhf(ekeys[tt * A2 + aa] + qe[aa]);
#pragma unroll
      for (int h = 0; h < MAXH; ++h)
        if (h < NH) acc[h] = fmaf(escore[h * A2 + aa], th, acc[h]);
    }
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < NH) {  // NH is uniform: the whole warp shuffles
        const float v = taco::warp_sum(acc[h]);
        if (lane == 0) een[h * Te + tt] = v;
      }
    }
  }
  __syncthreads();
  // softmax over the positions, one warp per score row; the weights only
  // enter the contexts' product, so they are kept rounded (see `put`)
  for (int h = warp; h < NH; h += NT / 32) {
    float* e = een + h * Te;
    float m = -INFINITY;
    for (int i = lane; i < Te; i += 32) m = fmaxf(m, e[i]);
    m = taco::warp_max(m);
    float sum = 0.f;
    for (int i = lane; i < Te; i += 32) {
      const float x = expf(e[i] - m);
      e[i] = x;
      sum += x;
    }
    sum = taco::warp_sum(sum);
    for (int i = lane; i < Te; i += 32) put<W>(e, e, i, e[i] / sum);
  }
  __syncthreads();
  // each row's context over the emt memory (multihead's joined contexts
  // only enter the output Dense: kept rounded)
  for (int i = threadIdx.x; i < NH * EV; i += NT) {
    const float* al = een + (i / EV) * Te;
    const int v = i % EV;
    float acc = 0.f;
    for (int tt = 0; tt < Te; ++tt)
      acc = fmaf(al[tt], emem[tt * EV + v], acc);
    if (a.eout_w)
      put<W>(ctxmh, ctxmh, i, acc);
    else
      put<W>(cte, cter, i, acc);
  }
  __syncthreads();
  if (a.eout_w) {
    mv<W>(a.eout_w, a.eout_b, ctxmh, NH * EV, a.E, cte, part);
    // LSTM1 reads the copy at the next step, past this step's barriers
    for (int i = threadIdx.x; i < a.E; i += NT) put<W>(cte, cter, i, cte[i]);
  }
}

template <typename W>
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(NT, 1)
    decoder_kernel(const DecArgs a) {
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CS, tid = threadIdx.x;
  const int T = a.T, P = a.P, U = a.U, M = a.M, A = a.A, mels = a.mels;
  const int Uc = U / CS, Mc = M / CS;
  const int FO = a.r * mels + a.r;
  const int E = a.E;  // ctx_emt width
  const int K1 = P + M + E + U;
  __shared__ int ired[32];
  __shared__ int s_pmax, s_fired;

  // ---- early stop: every row fired in an earlier launch -> nothing to do.
  // fired_in[B] counts the rows fired after the previous launch; every CTA
  // of the cluster reads it and they leave together, before any
  // cluster-wide access.
  if (a.fired_in && a.fired_in[a.B] == a.B) {
    if (rank == 0 && tid == 0 && a.fired_out) {
      a.fired_out[b] = 1;
      atomicAdd(a.fired_out + a.B, 1);
    }
    return;
  }

  float* xprev = sm;
  float* hp0 = xprev + mels;
  float* vec = hp0 + P;  // [hpre | ctx | ctx_emt | h1 | h2 | ctx2]
  float* hpre = vec;
  float* ctx = hpre + P;
  float* cte = ctx + M;
  float* h1 = cte + E;
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
  // the emt attention: keys, memory, score rows, qe, energies, head
  // contexts
  float* ekeys = red + 32;
  float* emem = ekeys + a.Te * a.A2;
  float* escore = emem + a.Te * a.EV;
  float* qe = escore + a.NH * a.A2;
  float* een = qe + a.A2;
  float* ctxmh = een + a.NH * a.Te;
  // with bf16 weights the rounded copies of what enters a product (see
  // `put`): of the head xprev .. ctx2 at the same offsets (R), of cum and
  // of the alignments; with f32 weights the copies are the values
  const int n_head = (int)(c1 - sm);  // xprev .. ctx2
  float* const smr = rounds<W>() ? ctxmh + a.NH * a.EV : sm;
  float* const cumr = rounds<W>() ? smr + n_head : cum;
  float* const alr = rounds<W>() ? cumr + T : al;
  const auto R = [&](float* p) { return smr + (p - sm); };

  const float* keys = a.keys + (size_t)b * T * A;
  const float* mem = a.memory + (size_t)b * T * M;
  const float* mask = a.mask + (size_t)b * T;
  const float* drop = a.drop + (size_t)b * a.s_total * 2 * P;
  float* out = a.out + (size_t)b * a.s_total * FO;
  const W* l1_w = static_cast<const W*>(a.l1_w) + (size_t)rank * K1 * 4 * Uc;
  const W* l2_w = static_cast<const W*>(a.l2_w) + (size_t)rank * 2 * U * 4 * Uc;
  const float* l1_b = a.l1_brow + ((size_t)b * CS + rank) * 4 * Uc;
  const float* l2_b = a.l2_b + rank * 4 * Uc;

  // ---- load the carried state: every CTA its full copy, c its own units
  const float* st_in = a.state_in + (size_t)b * (n_head + 2 * U);
  for (int i = tid; i < n_head; i += NT) put<W>(sm, smr, i, st_in[i]);
  for (int i = tid; i < 2 * Uc; i += NT)
    c1[i] = st_in[n_head + rank * 2 * Uc + i];  // c1 | c2 of this rank
  for (int i = tid; i < T; i += NT)
    put<W>(cum, cumr, i, a.cum_in[(size_t)b * T + i]);
  for (int i = tid; i < a.KW * A; i += NT) wp[i] = a.wp[i];
  {
    const int nk = a.Te * a.A2, nm = a.Te * a.EV;
    for (int i = tid; i < nk; i += NT) ekeys[i] = a.ekeys[(size_t)b * nk + i];
    for (int i = tid; i < nm; i += NT) emem[i] = a.emem[(size_t)b * nm + i];
    for (int i = tid; i < a.NH * a.A2; i += NT) escore[i] = a.escore[i];
  }
  if (tid == 0) {
    s_pmax = a.pmax_in[b];
    s_fired = a.fired_in ? a.fired_in[b] : 0;
  }
  cluster.sync();  // all CTAs loaded before any remote write

  const int pad = (a.KW - 1) / 2;
  const float zo = a.zoneout;
  const int lane = tid & 31, warp = tid >> 5;

  for (int s = 0; s < a.nsteps; ++s) {
    const int t = a.t0 + s;  // global step: drop, out and align index

    // ---- prenet: 2x (FC + ReLU + dropout multiplier), on every CTA
    mv<W>(a.pre_w0, a.pre_b0, R(xprev), mels, P, hp0, part);
    for (int i = tid; i < P; i += NT)
      put<W>(hp0, R(hp0), i,
             fmaxf(hp0[i], 0.f) * drop[(size_t)(2 * t) * P + i]);
    __syncthreads();
    mv<W>(a.pre_w1, a.pre_b1, R(hp0), P, P, hpre, part);
    for (int i = tid; i < P; i += NT)
      put<W>(hpre, R(hpre), i,
             fmaxf(hpre[i], 0.f) * drop[(size_t)(2 * t + 1) * P + i]);
    __syncthreads();

    // ---- zoneout LSTM1 on [hpre | ctx | h1], LSTM2 on [h1 | h2]; this
    // rank's gate columns, then the new h slices are shared
    mv<W>(l1_w, l1_b, R(vec), K1, 4 * Uc, z, part);
    lstm_update_and_share<W>(cluster, rank, z, c1, h1, R(h1), hnew, Uc, zo);
    mv<W>(l2_w, l2_b, R(h1), 2 * U, 4 * Uc, z, part);
    lstm_update_and_share<W>(cluster, rank, z, c2, h2, R(h2), hnew, Uc, zo);

    // ---- emt attention: the next step's ctx_emt, on every CTA. LSTM1's
    // reads of ctx_emt ended before the first exchange above.
    emt_attention<W>(a, R(h2), ekeys, escore, emem, qe, een, ctxmh, cte,
                     R(cte), part);

    // ---- location-sensitive energies, one warp per input position
    mv<W>(a.wq, nullptr, R(h2), U, A, q, part);
    const int pmax = s_pmax;
    for (int tt = warp; tt < T; tt += NT / 32) {
      float acc = 0.f;
      for (int aa = lane; aa < A; aa += 32) {
        float loc = 0.f;
        for (int k = 0; k < a.KW; ++k) {
          const int si = tt + k - pad;
          if (si >= 0 && si < T) loc = fmaf(cumr[si], wp[k * A + aa], loc);
        }
        float e = tanhf(keys[(size_t)tt * A + aa] + q[aa] + loc);
        if (a.tanh_bf16) e = taco::round_bf16(e);
        acc = fmaf(a.v_a[aa], e, acc);
      }
      acc = taco::warp_sum(acc);
      if (lane == 0) {
        const bool forbidden =
            a.constraint && (tt < pmax - a.win_back || tt >= pmax + a.win_fwd);
        al[tt] = (forbidden || mask[tt] <= 0.f) ? NEG_INF : acc;
      }
    }
    __syncthreads();

    // ---- masked softmax (or with smoothing the masked sigmoids; a
    // forbidden energy's sigmoid is 0), cumulative weights, window position
    float m = -INFINITY;
    if (!a.smoothing) {
      for (int i = tid; i < T; i += NT) m = fmaxf(m, al[i]);
      m = taco::block_max(m, red);
    }
    float sum = 0.f;
    for (int i = tid; i < T; i += NT) {
      const float e =
          (a.smoothing ? taco::sigmoidf(al[i]) : expf(al[i] - m)) * mask[i];
      al[i] = e;
      sum += e;
    }
    sum = taco::block_sum(sum, red);
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    for (int i = tid; i < T; i += NT) {
      const float v = al[i] / sum;
      put<W>(al, alr, i, v);
      put<W>(cum, cumr, i, cum[i] + v);
      if (v > best) {
        best = v;
        best_i = i;
      }
    }
    const int amax = taco::block_argmax(best, best_i, red, ired);
    if (tid == 0 && a.constraint) s_pmax = amax;
    if (a.align && rank == 0)
      for (int i = tid; i < T; i += NT)
        a.align[((size_t)b * a.s_total + t) * T + i] = al[i];

    // ---- this rank's context columns, shared with the cluster. Nobody
    // reads ctx between the last LSTM exchange and here, so the writes
    // need no barrier before them.
    for (int mm = tid; mm < Mc; mm += NT) {
      const int col = rank * Mc + mm;
      float acc = 0.f;
#pragma unroll 8
      for (int tt = 0; tt < T; ++tt)
        acc = fmaf(alr[tt], mem[(size_t)tt * M + col], acc);
      cnew[mm] = acc;
    }
    __syncthreads();
    for (int i = tid; i < CS * Mc; i += NT) {
      const int dst_rank = i / Mc, col = rank * Mc + i % Mc;
      put<W>(cluster.map_shared_rank(ctx, dst_rank),
             cluster.map_shared_rank(R(ctx), dst_rank), col, cnew[i % Mc]);
      put<W>(cluster.map_shared_rank(ctx2, dst_rank),
             cluster.map_shared_rank(R(ctx2), dst_rank), col, cnew[i % Mc]);
    }
    cluster.sync();

    // ---- fused frame + stop projection on [h2 | ctx], on every CTA
    mv<W>(a.proj_w, a.proj_b, R(h2), U + M, a.FOp, proj, part);
    const int nf = a.r * mels;
    if (rank == 0) {
      for (int i = tid; i < nf; i += NT) out[(size_t)t * FO + i] = proj[i];
      for (int i = tid; i < a.r; i += NT)
        out[(size_t)t * FO + nf + i] = taco::sigmoidf(proj[nf + i]);
    }
    for (int i = tid; i < mels; i += NT)
      put<W>(xprev, R(xprev), i, proj[(a.r - 1) * mels + i]);
    if (rank == 0 && tid == 0) {
      float lo = 1.f, hi = 0.f;
      for (int i = 0; i < a.r; ++i) {
        const float sp = taco::sigmoidf(proj[nf + i]);
        lo = fminf(lo, sp);
        hi = fmaxf(hi, sp);
      }
      if ((a.stop_at_any ? hi : lo) > 0.5f) s_fired = 1;
    }
    cluster.sync();
  }

  // ---- the state after the block; rank 0 writes what every CTA holds
  float* st_out = a.state_out + (size_t)b * (n_head + 2 * U);
  for (int i = tid; i < 2 * Uc; i += NT)
    st_out[n_head + rank * 2 * Uc + i] = c1[i];
  if (rank == 0) {
    for (int i = tid; i < n_head; i += NT) st_out[i] = sm[i];
    for (int i = tid; i < T; i += NT) a.cum_out[(size_t)b * T + i] = cum[i];
    if (tid == 0) {
      a.pmax_out[b] = s_pmax;
      if (a.fired_out) {
        a.fired_out[b] = s_fired;
        if (s_fired) atomicAdd(a.fired_out + a.B, 1);
      }
    }
  }
  cluster.sync();  // no CTA leaves while another may still address it
}

}  // namespace

extern "C" int taco_decoder_cluster_size() { return CS; }
extern "C" int taco_decoder_n_ptr() { return N_PTR; }
extern "C" int taco_decoder_n_int() { return N_INT; }

// Floats of one row's state vector (see DecArgs::state_in).
extern "C" int taco_decoder_state_floats(int mels, int P, int U, int M,
                                         int E) {
  return mels + 2 * P + 2 * M + E + 2 * U + 2 * U;
}

// E, Te, A2, EV, NH: the emt_attn widths.
extern "C" size_t taco_decoder_smem_bytes(int T, int mels, int P, int U,
                                          int M, int A, int KW, int FOp,
                                          int E, int Te, int A2, int EV,
                                          int NH) {
  const int Uc = U / CS, Mc = M / CS;
  const size_t head = (size_t)mels + 2 * P + 2 * M + E + 2 * U;
  // the head, c1 .. red, and the rounded copies of the head, cum and the
  // alignments (bf16 weights; the f32 kernel leaves them unused)
  size_t floats = head + 3 * Uc + 4 * Uc + Mc + NT * 8 + A + 2 * T + FOp +
                  KW * A + 32 + head + 2 * T;
  if (E)
    floats += (size_t)Te * (A2 + EV) + (size_t)NH * (A2 + Te + EV) + A2;
  return floats * sizeof(float);
}

// ptrs: N_PTR device pointers in `Ptr` order (fired_in, fired_out and
// align may be null; ekeys, escore, emem, l1_brow and w2e are needed,
// eout_w and eout_b for multihead); ints: N_INT values in `Int` order.
// Returns a CUDA error code, or 0.
extern "C" int taco_decoder_launch(const void* const* ptrs, int n_ptr,
                                   const int* ints, int n_int, float zoneout,
                                   void* stream) {
  if (n_ptr != N_PTR || n_int != N_INT) return (int)cudaErrorInvalidValue;
  DecArgs a;
  a.keys = (const float*)ptrs[P_KEYS];
  a.memory = (const float*)ptrs[P_MEMORY];
  a.mask = (const float*)ptrs[P_MASK];
  a.drop = (const float*)ptrs[P_DROP];
  a.pre_w0 = ptrs[P_PRE_W0];
  a.pre_b0 = (const float*)ptrs[P_PRE_B0];
  a.pre_w1 = ptrs[P_PRE_W1];
  a.pre_b1 = (const float*)ptrs[P_PRE_B1];
  a.l1_w = ptrs[P_L1_W];
  a.l2_w = ptrs[P_L2_W];
  a.l2_b = (const float*)ptrs[P_L2_B];
  a.wq = ptrs[P_WQ];
  a.wp = (const float*)ptrs[P_WP];
  a.v_a = (const float*)ptrs[P_V_A];
  a.proj_w = ptrs[P_PROJ_W];
  a.proj_b = (const float*)ptrs[P_PROJ_B];
  a.state_in = (const float*)ptrs[P_STATE_IN];
  a.cum_in = (const float*)ptrs[P_CUM_IN];
  a.pmax_in = (const int*)ptrs[P_PMAX_IN];
  a.state_out = (float*)ptrs[P_STATE_OUT];
  a.cum_out = (float*)ptrs[P_CUM_OUT];
  a.pmax_out = (int*)ptrs[P_PMAX_OUT];
  a.fired_in = (const int*)ptrs[P_FIRED_IN];
  a.fired_out = (int*)ptrs[P_FIRED_OUT];
  a.out = (float*)ptrs[P_OUT];
  a.align = (float*)ptrs[P_ALIGN];
  a.ekeys = (const float*)ptrs[P_EKEYS];
  a.escore = (const float*)ptrs[P_ESCORE];
  a.emem = (const float*)ptrs[P_EMEM];
  a.l1_brow = (const float*)ptrs[P_L1_BROW];
  a.w2e = ptrs[P_W2E];
  a.eout_w = ptrs[P_EOUT_W];
  a.eout_b = (const float*)ptrs[P_EOUT_B];
  a.B = ints[I_B];
  a.T = ints[I_T];
  a.t0 = ints[I_T0];
  a.nsteps = ints[I_NSTEPS];
  a.s_total = ints[I_STOTAL];
  a.mels = ints[I_MELS];
  a.P = ints[I_P];
  a.U = ints[I_U];
  a.M = ints[I_M];
  a.A = ints[I_A];
  a.KW = ints[I_KW];
  a.r = ints[I_R];
  a.FOp = ints[I_FOP];
  a.constraint = ints[I_CONSTRAINT];
  a.win_back = ints[I_WIN_BACK];
  a.win_fwd = ints[I_WIN_FWD];
  a.stop_at_any = ints[I_STOP_AT_ANY];
  a.E = ints[I_E];
  a.Te = ints[I_TE];
  a.A2 = ints[I_A2];
  a.EV = ints[I_EV];
  a.NH = ints[I_NH];
  a.smoothing = ints[I_SMOOTHING];
  a.tanh_bf16 = ints[I_TANH_BF16];
  const bool f32w = ints[I_F32_WEIGHTS] != 0;
  a.zoneout = zoneout;
  if (a.nsteps < 1 || a.t0 < 0 || a.t0 + a.nsteps > a.s_total)
    return (int)cudaErrorInvalidValue;
  // f32 weights: 16-byte loads of 4 of them, so every product's width and
  // row stride is a multiple of 4; the tanh is rounded only with bf16
  if (f32w && a.tanh_bf16) return (int)cudaErrorInvalidValue;
  // the emt operands: simple (no output Dense) has one score row and E =
  // EV; the output Dense's width E and the products' widths are multiples
  // of 8 (16-byte weight loads). Every decode without emt_attn is
  // csrc/decoder_rows.cu.
  if (a.E < 1 || !a.ekeys || !a.escore || !a.emem || !a.l1_brow || !a.w2e ||
      !a.eout_w != !a.eout_b || a.Te < 1 || a.NH < 1 || a.NH > MAXH ||
      a.A2 % 8 || a.E % 8 || (!a.eout_w && (a.NH != 1 || a.EV != a.E)))
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const DecArgs) =
      f32w ? decoder_kernel<float> : decoder_kernel<__nv_bfloat16>;
  const size_t smem =
      taco_decoder_smem_bytes(a.T, a.mels, a.P, a.U, a.M, a.A, a.KW, a.FOp,
                              a.E, a.Te, a.A2, a.EV, a.NH);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B * CS, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
