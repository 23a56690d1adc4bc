// Tacotron decode, autoregressive (the serve and eval decode) or
// teacher-forced (GTA, `embed`, the train forward), one thread-block
// cluster for 8 rows of the batch.
//
// Replaces, of tacotron2_tpu/ops/tacotron_decoder_kernel.py,
// `build_decoder_kernel` (the whole decode, pallas_call at :1105) and
// `build_decoder_block_kernel` (K steps from carried state, pallas_call at
// :700) without emt_attn; the block kernel's emt_attn scorers stay in
// csrc/decoder.cu. And of tacotron2_tpu/ops/tacotron_train_kernel.py
// `build_train_fwd` (pallas_call at :325) in its eval mode
// (train_zoneout=False) and its train mode: the teacher-forced mode below.
// The wrappers are tacotron2_tpu_torch/ops/tacotron_decoder_kernel.py
// (`decode`, `decode_block`) and ops/tacotron_train_kernel.py
// (`teacher_forced_fwd`, `teacher_forced_train_fwd`), the plain versions
// models/tacotron/decoder.py:decode_block and `teacher_forced`,
// `teacher_forced_train`, whose docstrings state the
// function: per step, prenet 2×FC with the caller's dropout multipliers,
// zoneout LSTM1 on [prenet | ctx | h1], LSTM2 on [h1 | h2], location-
// sensitive attention (the location conv folded with its projection into
// wp [K, A], its constant part folded into the keys by the wrapper), window
// constraint, masked softmax (or with `smoothing` the normalised sigmoids),
// cumulative weights, context, and the fused frame + stop projection.
//
// Launch contract of the autoregressive mode. One launch runs `nsteps`
// steps, global steps t0 .. t0+nsteps-1 of arrays laid out for s_total
// steps, from the state (each row's [xprev | ctx | h1 | h2 | c1 | c2], cum,
// pmax) and writes the state after them (in and out may alias: every read
// of it precedes the first cluster barrier, every write follows the
// last), the frames and stop probabilities, optionally the
// alignments, and each row's sticky stop flag (all r stop probabilities of
// a step above 0.5, or any with stop_at_any). The TPU kernels' early stop
// is a chain of launches on one stream: each launch counts its fired rows
// into a fresh slot (fired_out[B]); given fired_in, a launch first reads
// the previous launch's count and returns at once if every row has fired
// (counting them forward); the wrapper has pre-filled what a skipped step
// reads as (frames 0, stop 1.0, alignments 0).
//
// Teacher-forced mode (`decoder_rows_kernel<W, CSX, FIX, true>`). It is the
// same step, so it is a compile-time mode of this kernel and not a copy
// (the autoregressive instantiations compile without a line of it); it
// differs in five places. (1) Step t's input frame is teacher[t] ([s_total,
// B, mels]) where coins[t] is set, written into the prenet's operand at the
// top of the step over the frame fed back after the previous step's
// barrier D, else that fed-back frame (one coin per step, shared by the
// batch, as JAX's Decoder.teacher_forced draws them). (2) The stop head
// writes logits, no sigmoid. (3) No sticky stop flag and no early stop:
// the wrapper runs every step in one launch (t0 = 0, nsteps = s_total)
// with the window constraint off and softmax attention (build_train_fwd
// asserts both); it rounds neither the keys nor v_a (build_train_fwd keeps
// both f32). (4) Alignments are always written. (5) Train mode, a runtime
// mode of the same instantiation (the caller passes zmask and the
// residual buffers; build_train_fwd with train_zoneout=True): zoneout is
// the Bernoulli select from zmask [B, s_total, 4, U] uint8 for (c1, h1,
// c2, h2), c = m ? new : previous and the same for h, in `lstm_frag`
// beside the eval mode's EMA mix; and each step writes the residuals that
// csrc/decoder_bwd.cu reads, f32 [B, s_total, width] in `Res` order: rank
// 0 what every CTA holds (the cumulative alignments before the step, in
// the softmax's loop; the prenet outputs after dropout h0d and hpre, in
// the prenet's epilogues; the summed query q), each rank its own units of
// c1, h1, c2, h2 (after zoneout) and its gate columns of z1 and z2 in the
// natural (i, j, f, o) x U order, from the fragment by unit and gate (the
// stream lays them out unit by unit), and its own context columns.
//
// Rounding. The kernel is a template on the weight type W of every matmul
// weight (`__nv_bfloat16` or `float`). With bf16 weights every activation
// is rounded to bf16 where it enters a product (the frame, both prenet
// inputs, the LSTM inputs, h2 for the query and the projection, the
// context, the cumulative weights of the location features, the alignment
// of the context), as the TPU kernels do; the wrapper rounds the memory,
// the location taps, and as the route's TPU kernel does the keys and v_a;
// the energies' tanh is rounded at runtime flag `tanh_bf16`. Sums and the
// carried state stay f32. The products are bf16 × bf16 with f32 sums, mma
// m16n8k16. With f32 weights nothing is rounded and the products are
// 3xTF32 (m16n8k8, each operand split into two TF32 values, lo·lo
// dropped), not the FP32 cores: at 8 rows a tile they would need ~9M FMAs
// a CTA a step.
//
// Design, after csrc/decoder_bwd.cu. A cluster of CS CTAs (16 at a
// non-portable size where U and M split 16 ways, else 8) runs RB = 8 rows
// through every step; ceil(B/8) clusters, and a missing row reads zeros and
// is never written back. CTA `rank` owns the four gate columns of U/CS
// units of each LSTM and M/CS context columns, as csrc/decoder.cu does;
// every product is out[n][m] = sum_k A[m][k] · G[n][k] with the 8 rows as
// mma's n, so each weight tile, read once a step, serves all 8 rows:
//
//   pre0, pre1  A = the prenet's weights, transposed: every CTA the whole
//               prenet (~172 KB bf16 at the default widths, 8% of a CTA's
//               stream at CS 16), which saves two cluster barriers a step;
//   L1          A = this CTA's gate columns of [l1_wp; l1_wc; l1_wh];
//   L2          A = its gate columns of [l2_wx; l2_wh];
//   wq          A = the query weight's rows of own units (k over them): a
//               partial q that the cluster adds up;
//   proj        A = the projection's rows of own units and own context
//               columns: a partial of the frames | stop logits, alike.
//
// The weight stream. `pack_weights` packs each CTA's tiles of its four own
// products, then once the prenet's, which every CTA reads, as mma A
// fragments (`rows_stream`: 512 bytes a 16-row tile, m-tiles in groups of
// the 16 warps, 4 k-tiles a warp in each 32 KB chunk), once per set of
// weights. Each warp reads its fragments straight from the stream in
// global memory (L2) with 16-byte loads, the next PF chunks' in flight
// while it multiplies one (`product`). A 16-CTA cluster sits in one GPC,
// and there one SM draws ~66 GB/s from L2 whether by such loads or through
// a ring of TMA bulk copies fed by a producer warp (csrc/decoder_bwd.cu's
// design; scripts/stream_rate.py measures both, and CTAs spread over the
// card at ~100-140 GB/s an SM), so the plain loads are taken: no producer
// warp, no ring in shared memory, no mbarriers. The
// LSTM products' fragments go to the cell update without a round trip
// through shared memory: the stream lays a CTA's gate columns out unit by
// unit, so a lane quad's shuffles gather each unit's four gates
// (`lstm_frag`). Each k-step's product comes from zero and is added in f32
// in chunk order.
//
// Exchanges go through global memory (L2): each CTA writes its part, a
// cluster barrier (release / acquire at cluster scope) orders it, and each
// CTA reads what it needs, adding partials in rank order 0..CS-1. Four
// barriers a step: (A) the new h1, (B) the new h2 and the query's
// partials, (C) the energies, (D) the context and the projection's
// partials. The attention splits the input positions: CTA `rank` computes
// the energies of its ceil(T/CS) positions of all 8 rows; after (C) every
// CTA takes the softmax, the cumulative weights and the argmax of all 8
// rows from the same energies in the same order (so their copies agree),
// and the context of its own columns. Every sum goes in a fixed order, so
// reruns repeat every bit.
//
// Shared memory holds, in a fixed priority, the mma B operands, the
// attention's vectors and the carried states; what does not fit lives in
// a global scratch of the CTA instead (`layout`), so every width and T_in
// runs. At the default widths and T_in up to a few hundred everything
// fits.
//
// Bound: the bytes of the weight stream, once a cluster a step (~2.5 MB a
// CTA in bf16, ~5 MB in f32 at the default widths and CS 16), at what one
// SM of the cluster's GPC draws from L2 (~35 µs of a ~62 µs bf16 step; the
// f32 weights, 73 MB, come partly from HBM); the operations are far below.
// The train mode adds its residual writes (~27 KB a CTA a step at B 16).
// scripts/profile_taco_decode.py times each phase of the step, in either
// mode.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int NW = taco::kStreamWarps;  // warps a CTA, one a product's tile
constexpr int NT = NW * 32;             // threads a CTA
constexpr int RB = 8;                   // rows a cluster: mma's n
constexpr int KC = taco::kStreamKC;     // k-tiles a warp in each chunk
constexpr int CHUNK = taco::kChunk;     // bytes of a chunk of the stream
constexpr int TILE = taco::kTile;       // bytes of one A-fragment tile
constexpr int PROF_BYTES = 256;         // the measuring build's counters
constexpr int PF = 2;                   // chunks a warp's loads run ahead
constexpr int SMEM_MAX = 232448 - 256;  // and the static flags
constexpr int JP = 4;                   // positions an energy task covers
constexpr float NEG_INF = -4294967295.0f;  // -(2^32) + 1, attention.py:214
// the default widths' attention (attention_kernel, attention_dim), which
// keep an instantiation with fixed loop bounds
constexpr int FIX_KW = 31, FIX_A = 128;

// The train mode's residuals, in tacotron_train_kernel.RES_NAMES order:
// widths T, A, 4U, 4U, P, P, M, U, U, U, U.
enum Res {
  R_CUM, R_Q, R_Z1, R_Z2, R_H0D, R_HPRE, R_CTX, R_H1, R_C1, R_H2, R_C2, N_RES
};
enum Ptr {
  P_STREAM, P_KEYS, P_MEMORY, P_MASK, P_DROP, P_PRE_B0, P_PRE_B1, P_L1_B,
  P_L2_B, P_WP, P_V_A, P_PROJ_B, P_STATE_IN, P_CUM_IN, P_PMAX_IN,
  P_STATE_OUT, P_CUM_OUT, P_PMAX_OUT, P_FIRED_IN, P_FIRED_OUT, P_OUT,
  P_ALIGN, P_TEACHER, P_COINS, P_ZMASK, P_RES, P_SCRATCH = P_RES + N_RES,
  N_PTR
};
enum Int {
  I_B, I_T, I_T0, I_NSTEPS, I_STOTAL, I_MELS, I_P, I_U, I_M, I_A, I_KW, I_R,
  I_CONSTRAINT, I_WIN_BACK, I_WIN_FWD, I_STOP_AT_ANY, I_F32_WEIGHTS,
  I_SMOOTHING, I_TANH_BF16, I_CS, I_TEACHER_FORCED, N_INT
};
// The products: a CTA's own, then the prenet's, which every CTA reads.
enum Prod { PR_L1, PR_L2, PR_WQ, PR_PROJ, PR_PRE0, PR_PRE1, N_PROD };
// Buffers of a CTA, in the order they claim shared memory: the B operands
// (type W, pitched), the attention's vectors, the carried states.
enum Buf {
  B_X, B_XP, B_HP, B_GP, B_Z, B_Q, B_VA, B_CUMR, B_ALR, B_PROJ, B_WP, B_C1,
  B_C2, B_H1, B_H2, B_CUM, N_BUF
};

__host__ __device__ inline long long up(long long v, long long a) {
  return (v + a - 1) / a * a;
}

// The least p >= words with p = 4 (mod 8): a row pitch (32-bit words) at
// which the 8 rows' B-fragment loads hit 32 different banks.
__host__ __device__ inline int pitch_words(int words) {
  return words + (12 - words % 8) % 8;
}

// Where everything goes, the same on the host and in every CTA (it rides
// in the kernel's arguments).
struct Layout {
  int cs, Uc, Mc, Tc, FO, TP;
  int rows[N_PROD], kp[N_PROD], ng[N_PROD], nck[N_PROD];
  int c0[N_PROD];    // a product's first chunk in its stream
  int gx, gxp, ghp, ggp;  // the B operands' pitches (elements of W)
  int nch, nsh;      // chunks of a CTA's own stream, of the shared one
  long long own, shared;  // bytes of a CTA's own stream, of the shared one
  long long off[N_BUF];
  unsigned char sm[N_BUF];  // 1: in shared memory, 0: in the CTA's spill
  int smem;               // bytes of shared memory
  long long cta_spill;    // bytes of global scratch a CTA
  // a cluster's exchange buffers (bytes from its scratch)
  long long o_h1, o_h2, o_q, o_e, o_c, o_p, o_cta, cluster;
};

__host__ __device__ inline Layout layout(int T, int mels, int P, int U,
                                         int M, int A, int KW, int r, int cs,
                                         int f32) {
  Layout y;
  const int es = f32 ? 4 : 2, KS = f32 ? 8 : 16;
  y.cs = cs;
  y.Uc = U / cs;
  y.Mc = M / cs;
  y.Tc = (T + cs - 1) / cs;
  y.FO = r * mels + r;
  // the rounded cumulative weights, zero-padded for the taps and the last
  // energy task's positions past T
  y.TP = T + KW - 1 + JP;
  const int rows[N_PROD] = {4 * y.Uc, 4 * y.Uc, A, y.FO, P, P};
  const int ks[N_PROD] = {P + M + U, 2 * U, y.Uc, y.Uc + y.Mc, mels, P};
  int n[2] = {0, 0};  // chunks of the own and of the shared stream
  for (int p = 0; p < N_PROD; ++p) {
    int& c = n[p >= PR_PRE0];
    y.rows[p] = rows[p];
    y.kp[p] = (int)up(ks[p], KS * KC);
    y.ng[p] = (int)((up(rows[p], 16) / 16 + NW - 1) / NW);
    y.nck[p] = y.kp[p] / (KS * KC);
    y.c0[p] = c;
    c += y.ng[p] * y.nck[p];
  }
  y.nch = n[0];
  y.nsh = n[1];
  y.own = (long long)y.nch * CHUNK;
  y.shared = (long long)y.nsh * CHUNK;
  // X = [hpre | ctx | h1 | h2 | 0]: LSTM1 reads it from 0, LSTM2 from P + M
  const int xw = max(y.kp[PR_L1], P + M + y.kp[PR_L2]);
  const int gw[4] = {xw, y.kp[PR_PRE0], y.kp[PR_PRE1],
                     max(y.kp[PR_WQ], y.kp[PR_PROJ])};
  int* gp[4] = {&y.gx, &y.gxp, &y.ghp, &y.ggp};
  long long sz[N_BUF];
  for (int i = 0; i < 4; ++i) {
    *gp[i] = pitch_words(gw[i] * es / 4) * 4 / es;
    sz[i] = (long long)RB * *gp[i] * es;
  }
  const long long f = 4 * RB;  // a float for each row
  sz[B_Z] = f * (NW / RB) * y.Mc;
  sz[B_Q] = f * A;
  sz[B_VA] = 4LL * A;
  sz[B_WP] = 4LL * KW * (A + 1);
  sz[B_CUMR] = f * y.TP;
  sz[B_ALR] = f * T;
  sz[B_PROJ] = f * y.FO;
  sz[B_C1] = sz[B_C2] = sz[B_H1] = sz[B_H2] = f * y.Uc;
  sz[B_CUM] = f * T;
  long long used = 0, spill = 0;
  for (int i = 0; i < N_BUF; ++i) {
    const long long b = up(sz[i], 16);
    if (used + b <= SMEM_MAX) {
      y.sm[i] = 1;
      y.off[i] = used;
      used += b;
    } else {
      y.sm[i] = 0;
      y.off[i] = spill;
      spill += b;
    }
  }
  y.smem = (int)up(used, 128);
  y.cta_spill = up(spill, 256);
  const long long part = 4LL * cs * RB;  // a float for each rank and row
  y.o_h1 = PROF_BYTES;
  y.o_h2 = y.o_h1 + up(f * U, 256);
  y.o_q = y.o_h2 + up(f * U, 256);
  y.o_e = y.o_q + up(part * A, 256);
  y.o_c = y.o_e + up(f * T, 256);
  y.o_p = y.o_c + up(f * M, 256);
  y.o_cta = y.o_p + up(part * y.FO, 256);
  y.cluster = y.o_cta + (long long)cs * y.cta_spill;
  return y;
}

struct RowsArgs {
  // `rows_stream`: [cs, layout.own] bytes, each CTA's own products, then
  // the prenet's chunks, which every CTA reads
  const unsigned char* stream;
  const float* keys;    // [B, T, A] keys + folded attention bias
  const void* memory;   // [B, T, M] in the weight type
  const float* mask;    // [B, T] 1/0
  const float* drop;    // [B, s_total, 2, P] prenet dropout multipliers
  const float* pre_b0;  // [P]
  const float* pre_b1;  // [P]
  const float* l1_b;    // [cs, 4U/cs] own gate columns (forget bias folded)
  const float* l2_b;    // [cs, 4U/cs]
  const float* wp;      // [KW, A] folded location taps
  const float* v_a;     // [A]
  const float* proj_b;  // [FO]
  // state in / out: each row's [xprev | ctx | h1 | h2 | c1 | c2]; cum [B,
  // T]; pmax [B]
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
                        // (stop logits when teacher-forced)
  float* align;         // [B, s_total, T] alignments, or null
  // the teacher-forced mode: teacher frames [s_total, B, mels], coins
  // [s_total]; its train mode also the zoneout masks [B, s_total, 4, U]
  // and the residuals f32 [B, s_total, width] (`Res`); else null
  const float* teacher;
  const int* coins;
  const unsigned char* zmask;
  float* res[N_RES];
  unsigned char* scratch;  // [clusters, layout.cluster] bytes
  int B, T, t0, nsteps, s_total, mels, P, U, M, A, KW, r;
  int constraint, win_back, win_fwd, stop_at_any, smoothing, tanh_bf16;
  float zoneout;
  Layout y;
};

template <typename W>
__device__ __forceinline__ void put(W* p, float v);
template <>
__device__ __forceinline__ void put<float>(float* p, float v) {
  *p = v;
}
template <>
__device__ __forceinline__ void put<bf16>(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}

// D[m][n] = sum_k A[m][k] · G[n][k] for a product's m-tiles and the n < 8
// rows, A's tiles read straight from the packed stream in global memory
// (L2): its ng groups of 16 m-tiles (warp w takes m-tile 16·group + w),
// nck chunks of KC k-tiles a group, each warp its 2 KB of a chunk (16
// bytes a lane and tile), the next PF chunks' fragments in flight while it
// multiplies one. Each k-step's product comes from zero and is added in
// f32 in chunk order. Each lane hands its fragment to epi(m, n0, d): d =
// {D[m][n0], D[m][n0 + 1], D[m + 8][n0], D[m + 8][n0 + 1]}, m = 16·tile +
// lane / 4, n0 = 2·(lane % 4); every lane of the warp calls it (m may lie
// past the product's rows).
template <typename W, typename Epi>
__device__ __forceinline__ void product(const unsigned char* src, int ng,
                                        int nck, const W* G, int gp,
                                        Epi epi) {
  using St = taco::Step<W>;
  constexpr int KS = St::KS, CH16 = CHUNK / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  for (int gi = 0; gi < ng; ++gi) {
    const uint4* A = reinterpret_cast<const uint4*>(
                         src + (size_t)gi * nck * CHUNK + warp * KC * TILE) +
                     lane;
    auto fetch = [&](uint4* f, int c) {
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        f[kk] = c < nck ? __ldcg(A + (size_t)c * CH16 + kk * 32)
                        : make_uint4(0, 0, 0, 0);
    };
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    auto mul = [&](const uint4* f, int c) {
      float d[KC][4];
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        typename St::Frag fr;
        St::load(fr, f[kk], G, gp, (c * KC + kk) * KS, g8, t4);
        St::run(d[kk], fr);
      }
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += d[kk][e];
    };
    uint4 f[PF][KC];
#pragma unroll
    for (int j = 0; j < PF; ++j) fetch(f[j], j);
    for (int c = 0; c < nck; c += PF) {
#pragma unroll
      for (int j = 0; j < PF; ++j) {
        if (c + j < nck) {
          mul(f[j], c + j);
          fetch(f[j], c + j + PF);
        }
      }
    }
    epi((gi * NW + warp) * 16 + g8, 2 * t4, acc);
  }
}

// `product` with each output element to epi(m, n, value) for m < rows.
template <typename W, typename Epi>
__device__ __forceinline__ void product_each(const unsigned char* src,
                                             int ng, int nck, const W* G,
                                             int gp, int rows, Epi epi) {
  product<W>(src, ng, nck, G, gp, [&](int m, int n0, const float* d) {
    if (m < rows) {
      epi(m, n0, d[0]);
      epi(m, n0 + 1, d[1]);
    }
    if (m + 8 < rows) {
      epi(m + 8, n0, d[2]);
      epi(m + 8, n0 + 1, d[3]);
    }
  });
}

// dst[n * gp + j] = src[n * w + j] for the 8 rows, rounded to the weight
// type (an exchange row from L2 into a B operand): 16-byte loads, four in
// flight a thread, where w is a multiple of 4.
template <typename W>
__device__ void gather(const float* src, int w, W* dst, int gp) {
  constexpr bool kBf16 = std::is_same<W, bf16>::value;
  auto rg = [](float v) { return kBf16 ? taco::round_bf16(v) : v; };
  if (w % 4) {
    for (int i = threadIdx.x; i < RB * w; i += NT)
      put<W>(dst + (i / w) * gp + i % w, rg(__ldcg(src + i)));
    return;
  }
  const int n4 = RB * w / 4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += 4 * NT) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * NT;
      v[u] = i < n4 ? __ldcg(reinterpret_cast<const float4*>(src) + i)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * NT;
      if (i >= n4) break;
      W* d = dst + (4 * i / w) * gp + 4 * i % w;
      put<W>(d, rg(v[u].x));
      put<W>(d + 1, rg(v[u].y));
      put<W>(d + 2, rg(v[u].z));
      put<W>(d + 3, rg(v[u].w));
    }
  }
}

// One LSTM's train-mode operands at a step, for the cluster's first row
// (null pointers outside the train mode): its zoneout masks ([c | h] of U
// units) and its residual rows z [4U], both of row stride s4, c and h [U]
// (row stride s1); nb rows are real.
struct TrainRows {
  const unsigned char* m;
  float *z, *c, *h;
  size_t s4, s1;
  int nb;
};

// The zoneout LSTM update from an LSTM product's fragment: the stream lays
// a CTA's gate columns out unit by unit, (i, j, f, o) of each, so the four
// lanes of a quad-column (lane bits 2-3) hold the four gates of two units
// for two rows; each takes one (unit, row) and gathers its four gates by
// shuffles (every lane of the warp calls it). Zoneout is the EMA mix, or
// with tr.m (teacher-forced train mode) the Bernoulli select, which also
// writes the row's gates, c and h to its residual rows. c and h (f32, own
// units, [RB][Uc]) in place; the new h to the cluster's exchange row hg
// [RB][U] and, with hr, rounded to the query's and projection's operand.
template <typename W, bool TF>
__device__ __forceinline__ void lstm_frag(int m, int n0, const float* d,
                                          const float* bias, float* c,
                                          float* h, float* hg, W* hr, int gp,
                                          int rank, int Uc, int U, float zo,
                                          const TrainRows& tr) {
  const int lane = threadIdx.x & 31, gate = (lane >> 2) & 3;
  float z[4];
#pragma unroll
  for (int rnd = 0; rnd < 4; ++rnd) {
    const int j = (gate + rnd) & 3;     // the gate this round brings
    const int give = (gate - rnd) & 3;  // the asking lane's (unit, row)
    const float mine = give == 0 ? d[0] : give == 1 ? d[1]
                     : give == 2 ? d[2] : d[3];
    const float v = __shfl_sync(0xffffffffu, mine, (lane & ~12) | (j << 2));
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (g == j) z[g] = v;
  }
  const int u = m / 4 + 2 * (gate >> 1), n = n0 + (gate & 1);
  if (u >= Uc) return;
#pragma unroll
  for (int g = 0; g < 4; ++g) z[g] += bias[g * Uc + u];
  const int i = n * Uc + u;
  const float nc = taco::sigmoidf(z[2]) * c[i] +
                   taco::sigmoidf(z[0]) * tanhf(z[1]);
  const float nh = taco::sigmoidf(z[3]) * tanhf(nc);
  float cn = (1.f - zo) * nc + zo * c[i];
  float hn = (1.f - zo) * nh + zo * h[i];
  if constexpr (TF) {
    if (tr.m && n < tr.nb) {
      const int unit = rank * Uc + u;
      const unsigned char* mk = tr.m + n * tr.s4;
      cn = mk[unit] ? nc : c[i];
      hn = mk[U + unit] ? nh : h[i];
      float* rz = tr.z + n * tr.s4;
#pragma unroll
      for (int g = 0; g < 4; ++g) rz[g * U + unit] = z[g];
      tr.c[n * tr.s1 + unit] = cn;
      tr.h[n * tr.s1 + unit] = hn;
    }
  }
  c[i] = cn;
  h[i] = hn;
  hg[n * U + rank * Uc + u] = hn;
  if (hr) {
    if constexpr (std::is_same<W, bf16>::value)
      put<W>(hr + n * gp + u, taco::round_bf16(hn));
    else
      put<W>(hr + n * gp + u, hn);
  }
}

// The energies of this CTA's input positions tp0 .. tp0 + nT of rows n <
// nb: e = v_a · tanh(keys + q + loc), loc the location features of the
// rounded cumulative weights (cumr rows of pitch TP, zero-padded by KW / 2
// on the left), NEG_INF where the window constraint or the mask rules a
// position out, into eg [RB][T]. A warp takes JP positions of one row, its
// lanes the attention columns. FKW, FA: the fixed taps and columns of the
// default widths' instantiation, or 0.
template <int FKW, int FA>
__device__ void energies(const RowsArgs& a, int b0, int nb, int tp0, int nT,
                         const float* cumr, int TP, const float* wp,
                         const float* q, const float* va, const int* pmax,
                         float* eg) {
  const int KW = FKW ? FKW : a.KW, A = FA ? FA : a.A, T = a.T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int WPP = A + 1;
  const int nblk = (nT + JP - 1) / JP;
  // with fixed taps the task's window of cumulative weights sits in
  // registers
  constexpr int NWIN = FKW ? JP + FKW - 1 : 1;
  for (int task = warp; task < nb * nblk; task += NW) {
    const int n = task / nblk, i0 = (task % nblk) * JP;
    const float* cr = cumr + n * TP + tp0 + i0;  // cr[j + k]: tap k of i0 + j
    const float* kr = a.keys + ((size_t)(b0 + n) * T + tp0 + i0) * A;
    float acc[JP];
#pragma unroll
    for (int j = 0; j < JP; ++j) acc[j] = 0.f;
    float win[NWIN];
#pragma unroll
    for (int i = 0; i < NWIN; ++i) win[i] = FKW ? cr[i] : 0.f;
    for (int aa = lane; aa < A; aa += 32) {
      float key[JP], loc[JP];
#pragma unroll
      for (int j = 0; j < JP; ++j) {
        key[j] = i0 + j < nT ? kr[j * A + aa] : 0.f;
        loc[j] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < KW; ++k) {
        const float w = wp[k * WPP + aa];
#pragma unroll
        for (int j = 0; j < JP; ++j)
          loc[j] = fmaf(FKW ? win[j + k] : cr[j + k], w, loc[j]);
      }
      const float qa = q[n * A + aa], v = va[aa];
#pragma unroll
      for (int j = 0; j < JP; ++j) {
        float e = tanhf(key[j] + qa + loc[j]);
        if (a.tanh_bf16) e = taco::round_bf16(e);
        acc[j] = fmaf(v, e, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      const float s = taco::warp_sum(acc[j]);
      const int tt = tp0 + i0 + j;
      if (lane == 0 && i0 + j < nT) {
        const int pm = pmax[n];
        const bool forbidden =
            a.constraint && (tt < pm - a.win_back || tt >= pm + a.win_fwd);
        eg[n * T + tt] =
            (forbidden || a.mask[(size_t)(b0 + n) * T + tt] <= 0.f) ? NEG_INF
                                                                  : s;
      }
    }
  }
}

// Built with -DTACO_ROWS_PROFILE, thread 0 of the first CTA adds up the
// clock cycles of each phase of the step and writes them, as long longs,
// to the start of the scratch when it ends (a measuring build only).
#ifdef TACO_ROWS_PROFILE
#define PHASE(i)                    \
  if (tid == 0 && blockIdx.x == 0) { \
    const long long now = clock64(); \
    prof[i] += now - prof_t;         \
    prof_t = now;                    \
  }
#else
#define PHASE(i)
#endif

template <typename W, int CSX, bool FIX, bool TF>
__global__ void __cluster_dims__(CSX, 1, 1) __launch_bounds__(NT, 1)
    decoder_rows_kernel(const RowsArgs a) {
  constexpr bool kBf16 = std::is_same<W, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_pmax[RB], s_fired[RB];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout& y = a.y;
  const int rank = (int)cluster.block_rank();
  const int cb = blockIdx.x / CSX, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b0 = cb * RB, nb = min(RB, a.B - b0);  // rows of this cluster

  // ---- early stop: every row fired in an earlier launch -> nothing to
  // do; every CTA of the cluster reads the count and they leave together
  if (a.fired_in && a.fired_in[a.B] == a.B) {
    if (rank == 0 && tid == 0 && a.fired_out) {
      for (int n = 0; n < nb; ++n) a.fired_out[b0 + n] = 1;
      atomicAdd(a.fired_out + a.B, nb);
    }
    return;
  }

  const int T = a.T, P = a.P, U = a.U, M = a.M, A = a.A, KW = a.KW;
  const int mels = a.mels, nf = a.r * mels, fb0 = (a.r - 1) * mels;
  const int Uc = y.Uc, Mc = y.Mc, Tc = y.Tc, FO = y.FO, TP = y.TP;
  const int SW = mels + M + 4 * U;  // state floats of a row
  const int tp0 = rank * Tc;
  const int nT = max(0, min(Tc, T - tp0));  // this CTA's input positions
  const int pad = (KW - 1) / 2, WPP = A + 1;
  const int gx = y.gx, gxp = y.gxp, ghp = y.ghp, ggp = y.ggp;
  auto rg = [](float v) { return kBf16 ? taco::round_bf16(v) : v; };

  unsigned char* gcl = a.scratch + (size_t)cb * y.cluster;
  unsigned char* gcta = gcl + y.o_cta + (size_t)rank * y.cta_spill;
  auto buf = [&](int i) -> void* {
    return y.sm[i] ? (void*)(smem + y.off[i]) : (void*)(gcta + y.off[i]);
  };
  W* X = (W*)buf(B_X);    // [RB][gx]: [hpre | ctx | h1 | h2], rounded
  W* XP = (W*)buf(B_XP);  // [RB][gxp] the input frame, rounded
  W* HP = (W*)buf(B_HP);  // [RB][ghp] the first prenet layer's output
  W* GP = (W*)buf(B_GP);  // [RB][ggp] [own h2 | own ctx], rounded
  float* Z = (float*)buf(B_Z);        // [RB][NW/RB][Mc] context partials
  float* Q = (float*)buf(B_Q);        // [RB][A] the query
  float* VA = (float*)buf(B_VA);      // [A]
  float* WPS = (float*)buf(B_WP);     // [KW][A + 1] the location taps
  float* CUMR = (float*)buf(B_CUMR);  // [RB][TP] rounded, zero-padded
  float* ALR = (float*)buf(B_ALR);    // [RB][T] alignments, rounded
  float* PROJ = (float*)buf(B_PROJ);  // [RB][FO] frames | stop logits
  float* C1 = (float*)buf(B_C1);      // [RB][Uc] own units, f32
  float* C2 = (float*)buf(B_C2);
  float* H1 = (float*)buf(B_H1);
  float* H2 = (float*)buf(B_H2);
  float* CUM = (float*)buf(B_CUM);    // [RB][T]
  // the cluster's exchanges
  float* h1g = (float*)(gcl + y.o_h1);  // [RB][U]
  float* h2g = (float*)(gcl + y.o_h2);  // [RB][U]
  float* qg = (float*)(gcl + y.o_q);    // [cs][RB][A] query partials
  float* eg = (float*)(gcl + y.o_e);    // [RB][T] energies
  float* cg_ = (float*)(gcl + y.o_c);   // [RB][M] context
  float* pg = (float*)(gcl + y.o_p);    // [cs][RB][FO] projection partials

  // a product's tiles: this CTA's own, or the prenet's, which every CTA
  // reads
  const unsigned char* own = a.stream + (size_t)rank * y.own;
  const unsigned char* pre = a.stream + (size_t)CSX * y.own;
  auto tiles = [&](int p) {
    return (p >= PR_PRE0 ? pre : own) + (size_t)y.c0[p] * CHUNK;
  };

  // ---- set-up: the B operands zeroed (their padding stays zero), the
  // carried state of the cluster's rows (missing rows: zeros), constants
  {
    for (int i = tid; i < RB * gx; i += NT) put<W>(X + i, 0.f);
    for (int i = tid; i < RB * gxp; i += NT) put<W>(XP + i, 0.f);
    for (int i = tid; i < RB * ghp; i += NT) put<W>(HP + i, 0.f);
    for (int i = tid; i < RB * ggp; i += NT) put<W>(GP + i, 0.f);
    for (int i = tid; i < RB * TP; i += NT) CUMR[i] = 0.f;
  }
  __syncthreads();
  {
    for (int i = tid; i < nb * SW; i += NT) {
      const int n = i / SW, j = i % SW;
      const float v = a.state_in[(size_t)(b0 + n) * SW + j];
      if (j < mels) {
        put<W>(XP + n * gxp + j, rg(v));
      } else if (j < mels + M + 2 * U) {  // ctx | h1 | h2
        put<W>(X + n * gx + P + j - mels, rg(v));
        const int u = j - mels - M;
        const int own = u % U - rank * Uc;
        if (u >= 0 && own >= 0 && own < Uc)
          (u < U ? H1 : H2)[n * Uc + own] = v;
      } else {
        const int u = j - mels - M - 2 * U;  // c1 | c2
        const int own = u % U - rank * Uc;
        if (own >= 0 && own < Uc) (u < U ? C1 : C2)[n * Uc + own] = v;
      }
    }
    for (int i = tid; i < RB * Uc; i += NT) {
      if (i / Uc >= nb) H1[i] = H2[i] = C1[i] = C2[i] = 0.f;
    }
    for (int i = tid; i < RB * T; i += NT) {
      const int n = i / T;
      const float c = n < nb ? a.cum_in[(size_t)b0 * T + i] : 0.f;
      CUM[i] = c;
      CUMR[n * TP + pad + i % T] = rg(c);
    }
    for (int i = tid; i < KW * A; i += NT) WPS[(i / A) * WPP + i % A] = a.wp[i];
    for (int i = tid; i < A; i += NT) VA[i] = a.v_a[i];
    if (tid < RB) {
      s_pmax[tid] = tid < nb ? a.pmax_in[b0 + tid] : 0;
      s_fired[tid] = tid < nb && a.fired_in ? a.fired_in[b0 + tid] : 0;
    }
  }
  __syncthreads();
#ifdef TACO_ROWS_PROFILE
  long long prof[16] = {0}, prof_t = clock64();
#endif
  const float zo = a.zoneout;
  const float* l1_b = a.l1_b + rank * 4 * Uc;
  const float* l2_b = a.l2_b + rank * 4 * Uc;
  const W* memw = static_cast<const W*>(a.memory);

  const bool train = TF && a.zmask;  // the teacher-forced train mode
  for (int s = 0; s < a.nsteps; ++s) {
    const int t = a.t0 + s;  // global step: drop, out and align index
    auto drop = [&](int n, int layer, int p) {
      return n < nb ? a.drop[(((size_t)(b0 + n) * a.s_total + t) * 2 + layer) *
                                 P + p]
                    : 0.f;
    };
    // train mode: row n's residual r at this step, of width w
    auto res = [&](int r, int n, int w) {
      return a.res[r] + ((size_t)(b0 + n) * a.s_total + t) * w;
    };
    TrainRows tr1{}, tr2{};
    if constexpr (TF) {
      if (train) {
        const size_t row = (size_t)b0 * a.s_total + t;
        const size_t s4 = (size_t)a.s_total * 4 * U, s1 = (size_t)a.s_total * U;
        const unsigned char* mk = a.zmask + row * 4 * U;
        tr1 = {mk, a.res[R_Z1] + row * 4 * U, a.res[R_C1] + row * U,
               a.res[R_H1] + row * U, s4, s1, nb};
        tr2 = {mk + 2 * U, a.res[R_Z2] + row * 4 * U, a.res[R_C2] + row * U,
               a.res[R_H2] + row * U, s4, s1, nb};
      }
      // the teacher's frame where the coin is set, over the fed-back one
      // (the previous step's last barrier ordered every read of it)
      if (a.coins[t]) {
        for (int i = tid; i < nb * mels; i += NT) {
          const int n = i / mels, j = i % mels;
          put<W>(XP + n * gxp + j,
                 rg(a.teacher[((size_t)t * a.B + b0 + n) * mels + j]));
        }
        __syncthreads();
      }
    }

    // ---- prenet: 2x (FC + ReLU + dropout multiplier), every CTA, each
    // layer's epilogue on its products' outputs
    product_each<W>(tiles(PR_PRE0), y.ng[PR_PRE0], y.nck[PR_PRE0], XP, gxp,
                    P, [&](int p, int n, float v) {
                      const float x = fmaxf(v + a.pre_b0[p], 0.f) *
                                      drop(n, 0, p);
                      put<W>(HP + n * ghp + p, rg(x));
                      if constexpr (TF)
                        if (train && rank == 0 && n < nb)
                          res(R_H0D, n, P)[p] = x;
                    });
    __syncthreads();
    product_each<W>(tiles(PR_PRE1), y.ng[PR_PRE1], y.nck[PR_PRE1], HP, ghp,
                    P, [&](int p, int n, float v) {
                      const float x = fmaxf(v + a.pre_b1[p], 0.f) *
                                      drop(n, 1, p);
                      put<W>(X + n * gx + p, rg(x));
                      if constexpr (TF)
                        if (train && rank == 0 && n < nb)
                          res(R_HPRE, n, P)[p] = x;
                    });
    __syncthreads();
    PHASE(0)

    // ---- LSTM1 on [hpre | ctx | h1]: own gate columns, own units
    product<W>(tiles(PR_L1), y.ng[PR_L1], y.nck[PR_L1], X, gx,
               [&](int m, int n0, const float* d) {
                 lstm_frag<W, TF>(m, n0, d, l1_b, C1, H1, h1g, (W*)nullptr,
                                  ggp, rank, Uc, U, zo, tr1);
               });
    PHASE(1)
    cluster.sync();  // A: h1 is complete
    PHASE(2)
    gather<W>(h1g, U, X + P + M, gx);
    __syncthreads();
    PHASE(3)

    // ---- LSTM2 on [h1 | h2]; the query's partial over own units
    product<W>(tiles(PR_L2), y.ng[PR_L2], y.nck[PR_L2], X + P + M, gx,
               [&](int m, int n0, const float* d) {
                 lstm_frag<W, TF>(m, n0, d, l2_b, C2, H2, h2g, GP, ggp, rank,
                                  Uc, U, zo, tr2);
               });
    __syncthreads();
    PHASE(4)
    product_each<W>(tiles(PR_WQ), y.ng[PR_WQ], y.nck[PR_WQ], GP, ggp, A,
                    [&](int m, int n, float v) {
                      qg[(rank * RB + n) * A + m] = v;
                    });
    PHASE(5)
    cluster.sync();  // B: h2 and the query's partials are complete
    PHASE(6)
    gather<W>(h2g, U, X + P + M + U, gx);
    for (int i = tid; i < RB * A; i += NT) {
      float v = 0.f;
      for (int r = 0; r < CSX; ++r) v += __ldcg(qg + r * RB * A + i);
      Q[i] = v;
      if constexpr (TF)
        if (train && rank == 0 && i / A < nb) res(R_Q, i / A, A)[i % A] = v;
    }
    __syncthreads();
    PHASE(7)

    // ---- the energies of own positions
    if constexpr (FIX)
      energies<FIX_KW, FIX_A>(a, b0, nb, tp0, nT, CUMR, TP, WPS, Q, VA,
                              s_pmax, eg);
    else
      energies<0, 0>(a, b0, nb, tp0, nT, CUMR, TP, WPS, Q, VA, s_pmax, eg);
    PHASE(8)
    cluster.sync();  // C: the energies are complete
    PHASE(9)

    // ---- masked softmax (or the normalised masked sigmoids), cumulative
    // weights, window position: every CTA all rows, a warp a row
    if (warp < nb) {
      const int n = warp, b = b0 + n;
      const float* e = eg + n * T;
      const float* mk = a.mask + (size_t)b * T;
      // the row's energies into ALR with the mask, four positions in
      // flight a lane: a masked position's energy (NEG_INF) is kept as
      // -inf, whose exp and sigmoid are the 0 the mask would make of them
      float m = -INFINITY;
      for (int i0 = lane; i0 < T; i0 += 128) {
        float x[4], k[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + 32 * u;
          x[u] = i < T ? __ldcg(e + i) : -INFINITY;
          k[u] = i < T ? mk[i] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (i0 + 32 * u < T) ALR[n * T + i0 + 32 * u] =
              k[u] > 0.f ? x[u] : -INFINITY;
          m = fmaxf(m, x[u]);
        }
      }
      m = taco::warp_max(m);
      float sum = 0.f;
      for (int i = lane; i < T; i += 32) {
        const float x = ALR[n * T + i];
        const float v = a.smoothing ? taco::sigmoidf(x) : expf(x - m);
        ALR[n * T + i] = v;
        sum += v;
      }
      sum = taco::warp_sum(sum);
      float best = -INFINITY;
      int best_i = 0x7fffffff;
      for (int i = lane; i < T; i += 32) {
        const float v = ALR[n * T + i] / sum;
        if (a.align && rank == 0)
          a.align[((size_t)b * a.s_total + t) * T + i] = v;
        if constexpr (TF)
          if (train && rank == 0) res(R_CUM, n, T)[i] = CUM[n * T + i];
        const float c = CUM[n * T + i] + v;
        CUM[n * T + i] = c;
        CUMR[n * TP + pad + i] = rg(c);
        ALR[n * T + i] = rg(v);
        if (v > best) {
          best = v;
          best_i = i;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
        if (ov > best || (ov == best && oi < best_i)) {
          best = ov;
          best_i = oi;
        }
      }
      if (lane == 0 && a.constraint) s_pmax[n] = best_i;
    }
    __syncthreads();
    PHASE(10)

    // ---- own context columns, ctx[n][m] = sum_t alr[n][t] mem[n][t][m]:
    // NW / RB warps a row; a warp's lanes take 16-byte column groups of
    // 32 / ncg positions at once (coalesced rows of the memory), each lane
    // its positions t = phase (mod 32 / ncg · NW / RB), eight loads in
    // flight; the phases are added by shuffles, the warps of a row in
    // order through Z. Column groups that do not divide a warp: a warp a
    // (row, column), its lanes over the positions.
    {
      using Pk = taco::Pack<W>;
      constexpr int V = Pk::V, WPR = NW / RB;
      const int ncg = Mc / V;
      if (Mc % V == 0 && M % V == 0 && 32 % ncg == 0) {
        const int pw = 32 / ncg, n = warp / WPR, sub = warp % WPR;
        const int cgi = lane % ncg, ph = lane / ncg;
        float acc[V];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = 0.f;
        if (n < nb) {
          const float* al = ALR + n * T;
          const W* mr = memw + (size_t)(b0 + n) * T * M + rank * Mc + cgi * V;
          const int step = WPR * pw;
          for (int t0 = sub * pw + ph; t0 < T; t0 += 8 * step) {
            typename Pk::Raw raw[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int tt = t0 + u * step;
              raw[u] = tt < T ? Pk::ld(mr + (size_t)tt * M)
                              : typename Pk::Raw{};
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int tt = t0 + u * step;
              if (tt >= T) break;
              float v[V];
              Pk::cvt(raw[u], v);
              const float w = al[tt];
#pragma unroll
              for (int e = 0; e < V; ++e) acc[e] = fmaf(w, v[e], acc[e]);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < V; ++e)
          for (int o = ncg; o < 32; o <<= 1)
            acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
        if (ph == 0 && n < nb) {
#pragma unroll
          for (int e = 0; e < V; ++e)
            Z[(n * WPR + sub) * Mc + cgi * V + e] = acc[e];
        }
        __syncthreads();
        for (int i = tid; i < nb * Mc; i += NT) {
          const int n2 = i / Mc, m = i % Mc;
          float v = 0.f;
#pragma unroll
          for (int w = 0; w < WPR; ++w) v += Z[(n2 * WPR + w) * Mc + m];
          cg_[n2 * M + rank * Mc + m] = v;
          put<W>(GP + n2 * ggp + Uc + m, rg(v));
          if constexpr (TF)
            if (train) res(R_CTX, n2, M)[rank * Mc + m] = v;
        }
      } else {
        for (int task = warp; task < nb * Mc; task += NW) {
          const int n = task / Mc, m = task % Mc;
          const float* al = ALR + n * T;
          const W* mr = memw + (size_t)(b0 + n) * T * M + rank * Mc + m;
          float acc = 0.f;
#pragma unroll 4
          for (int tt = lane; tt < T; tt += 32)
            acc = fmaf(al[tt], ld(mr + (size_t)tt * M), acc);
          acc = taco::warp_sum(acc);
          if (lane == 0) {
            cg_[n * M + rank * Mc + m] = acc;
            put<W>(GP + n * ggp + Uc + m, rg(acc));
            if constexpr (TF)
              if (train) res(R_CTX, n, M)[rank * Mc + m] = acc;
          }
        }
      }
    }
    __syncthreads();
    PHASE(11)

    // ---- the projection's partial over own units and own columns
    product_each<W>(tiles(PR_PROJ), y.ng[PR_PROJ], y.nck[PR_PROJ], GP, ggp,
                    FO, [&](int m, int n, float v) {
                      pg[(rank * RB + n) * FO + m] = v;
                    });
    PHASE(12)
    cluster.sync();  // D: the context and the projection are complete
    PHASE(13)
    gather<W>(cg_, M, X + P, gx);
    for (int i = tid; i < RB * FO; i += NT) {
      float v = a.proj_b[i % FO];
      for (int r = 0; r < CSX; ++r) v += __ldcg(pg + r * RB * FO + i);
      PROJ[i] = v;
    }
    __syncthreads();
    PHASE(14)
    // the next input frame; rank 0 writes the outputs and the stop flags
    // (teacher-forced: the stop logits, no flags)
    for (int i = tid; i < RB * mels; i += NT) {
      const int n = i / mels, j = i % mels;
      put<W>(XP + n * gxp + j, rg(PROJ[n * FO + fb0 + j]));
    }
    if (rank == 0) {
      for (int i = tid; i < nb * FO; i += NT) {
        const int n = i / FO, f = i % FO;
        const float v = PROJ[i];
        a.out[((size_t)(b0 + n) * a.s_total + t) * FO + f] =
            TF || f < nf ? v : taco::sigmoidf(v);
      }
      if (!TF && tid < nb) {
        float lo = 1.f, hi = 0.f;
        for (int i = 0; i < a.r; ++i) {
          const float sp = taco::sigmoidf(PROJ[tid * FO + nf + i]);
          lo = fminf(lo, sp);
          hi = fmaxf(hi, sp);
        }
        if ((a.stop_at_any ? hi : lo) > 0.5f) s_fired[tid] = 1;
      }
    }
    __syncthreads();
    PHASE(15)
  }

  // ---- the state after the block: each CTA its units' cells, rank 0 the
  // rest (every CTA holds the same)
  for (int i = tid; i < nb * Uc; i += NT) {
    const int n = i / Uc, u = rank * Uc + i % Uc;
    float* so = a.state_out + (size_t)(b0 + n) * SW + mels + M + 2 * U;
    so[u] = C1[i];
    so[U + u] = C2[i];
  }
  if (rank == 0) {
    for (int i = tid; i < nb * (mels + M + 2 * U); i += NT) {
      const int w = mels + M + 2 * U, n = i / w, j = i % w;
      float v;
      if (j < mels)
        v = PROJ[n * FO + fb0 + j];
      else if (j < mels + M)
        v = __ldcg(cg_ + n * M + j - mels);
      else if (j < mels + M + U)
        v = __ldcg(h1g + n * U + j - mels - M);
      else
        v = __ldcg(h2g + n * U + j - mels - M - U);
      a.state_out[(size_t)(b0 + n) * SW + j] = v;
    }
    for (int i = tid; i < nb * T; i += NT)
      a.cum_out[(size_t)b0 * T + i] = CUM[i];
    if (tid < nb) {
      a.pmax_out[b0 + tid] = s_pmax[tid];
      if (a.fired_out) a.fired_out[b0 + tid] = s_fired[tid];
    }
    if (tid == 0 && a.fired_out) {
      int fired = 0;
      for (int n = 0; n < nb; ++n) fired += s_fired[n];
      if (fired) atomicAdd(a.fired_out + a.B, fired);
    }
  }
#ifdef TACO_ROWS_PROFILE
  if (tid == 0 && blockIdx.x == 0)
    for (int i = 0; i < 16; ++i)
      reinterpret_cast<long long*>(a.scratch)[i] = prof[i];
#endif
}

// The kernel's envelope: the widths its layout takes (the shared memory
// spills what does not fit, so T_in and the widths have no bound of their
// own here). The one statement of it, for every entry point.
bool supported(int T, int mels, int P, int U, int M, int A, int KW, int r,
               int cs) {
  return (cs == 8 || cs == 16) && T >= 1 && mels >= 1 && P >= 2 &&
         P % 2 == 0 && A >= 1 && KW >= 1 && r >= 1 && U >= cs && M >= cs &&
         U % cs == 0 && M % cs == 0 && M % 2 == 0;
}

template <typename W, int CSX, bool FIX, bool TF>
int launch(RowsArgs& a, cudaStream_t stream) {
  void (*kernel)(const RowsArgs) = decoder_rows_kernel<W, CSX, FIX, TF>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.y.smem);
  if (err == cudaSuccess && CSX > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  const int clusters = (a.B + RB - 1) / RB;
  kernel<<<clusters * CSX, NT, a.y.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename W, int CSX, bool FIX>
int launch_mode(RowsArgs& a, cudaStream_t stream, bool teacher_forced) {
  return teacher_forced ? launch<W, CSX, FIX, true>(a, stream)
                        : launch<W, CSX, FIX, false>(a, stream);
}

}  // namespace

extern "C" int taco_rows_rows() { return RB; }
extern "C" int taco_rows_n_ptr() { return N_PTR; }
extern "C" int taco_rows_n_int() { return N_INT; }

extern "C" int taco_rows_supported(int T, int mels, int P, int U, int M,
                                   int A, int KW, int r, int cs) {
  return supported(T, mels, P, U, M, A, KW, r, cs) ? 1 : 0;
}

// The plan of a launch: out = {shared memory bytes, bytes of a CTA's own
// weight stream, bytes of the stream every CTA reads, bytes of global
// scratch a cluster, bytes a CTA spills, buffers in shared memory}.
// Returns 0, or -1 outside the envelope.
extern "C" int taco_rows_plan(int T, int mels, int P, int U, int M, int A,
                              int KW, int r, int cs, int f32,
                              long long* out) {
  if (!supported(T, mels, P, U, M, A, KW, r, cs)) return -1;
  const Layout y = layout(T, mels, P, U, M, A, KW, r, cs, f32);
  int in_smem = 0;
  for (int i = 0; i < N_BUF; ++i) in_smem += y.sm[i];
  out[0] = y.smem;
  out[1] = y.own;
  out[2] = y.shared;
  out[3] = y.cluster;
  out[4] = y.cta_spill;
  out[5] = in_smem;

  return 0;
}

// ptrs: N_PTR device pointers in `Ptr` order (fired_in, fired_out, align,
// teacher, coins, zmask and the residuals may be null: the teacher-forced
// mode needs teacher, coins and align, its train mode also zmask and every
// residual, and the autoregressive mode none of these five); ints: N_INT
// values in `Int` order. Returns a CUDA error code, or 0.
extern "C" int taco_rows_launch(const void* const* ptrs, int n_ptr,
                                const int* ints, int n_int, float zoneout,
                                void* stream) {
  if (n_ptr != N_PTR || n_int != N_INT) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < N_PTR; ++i)
    if (!ptrs[i] && i != P_FIRED_IN && i != P_FIRED_OUT && i != P_ALIGN &&
        (i < P_TEACHER || i >= P_RES + N_RES))
      return (int)cudaErrorInvalidValue;
  RowsArgs a;
  a.stream = (const unsigned char*)ptrs[P_STREAM];
  a.keys = (const float*)ptrs[P_KEYS];
  a.memory = ptrs[P_MEMORY];
  a.mask = (const float*)ptrs[P_MASK];
  a.drop = (const float*)ptrs[P_DROP];
  a.pre_b0 = (const float*)ptrs[P_PRE_B0];
  a.pre_b1 = (const float*)ptrs[P_PRE_B1];
  a.l1_b = (const float*)ptrs[P_L1_B];
  a.l2_b = (const float*)ptrs[P_L2_B];
  a.wp = (const float*)ptrs[P_WP];
  a.v_a = (const float*)ptrs[P_V_A];
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
  a.teacher = (const float*)ptrs[P_TEACHER];
  a.coins = (const int*)ptrs[P_COINS];
  a.zmask = (const unsigned char*)ptrs[P_ZMASK];
  int n_res = 0;
  for (int r = 0; r < N_RES; ++r) {
    a.res[r] = (float*)ptrs[P_RES + r];
    n_res += a.res[r] != nullptr;
  }
  a.scratch = (unsigned char*)ptrs[P_SCRATCH];
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
  a.constraint = ints[I_CONSTRAINT];
  a.win_back = ints[I_WIN_BACK];
  a.win_fwd = ints[I_WIN_FWD];
  a.stop_at_any = ints[I_STOP_AT_ANY];
  a.smoothing = ints[I_SMOOTHING];
  a.tanh_bf16 = ints[I_TANH_BF16];
  a.zoneout = zoneout;
  const int f32 = ints[I_F32_WEIGHTS], cs = ints[I_CS];
  const bool tf = ints[I_TEACHER_FORCED] != 0;
  if (a.B < 1 || a.nsteps < 1 || a.t0 < 0 || a.t0 + a.nsteps > a.s_total ||
      (f32 && a.tanh_bf16) ||
      !supported(a.T, a.mels, a.P, a.U, a.M, a.A, a.KW, a.r, cs))
    return (int)cudaErrorInvalidValue;
  // teacher-forced: teacher, coins and alignments, no stop flags, no window
  // constraint, softmax attention, the tanh unrounded (build_train_fwd);
  // its train mode: the masks and every residual, all steps in one launch
  const bool train = a.zmask || n_res;
  if (tf ? (!a.teacher || !a.coins || !a.align || a.fired_in ||
            a.fired_out || a.constraint || a.smoothing || a.tanh_bf16 ||
            (train && (!a.zmask || n_res != N_RES || a.t0 != 0 ||
                       a.nsteps != a.s_total)))
         : (a.teacher || a.coins || train))
    return (int)cudaErrorInvalidValue;
  a.y = layout(a.T, a.mels, a.P, a.U, a.M, a.A, a.KW, a.r, cs, f32);
  cudaStream_t st = (cudaStream_t)stream;
  const bool fix = a.KW == FIX_KW && a.A == FIX_A;
  if (cs == 16) {
    if (f32)
      return fix ? launch_mode<float, 16, true>(a, st, tf)
                 : launch_mode<float, 16, false>(a, st, tf);
    return fix ? launch_mode<bf16, 16, true>(a, st, tf)
               : launch_mode<bf16, 16, false>(a, st, tf);
  }
  return f32 ? launch_mode<float, 8, false>(a, st, tf)
             : launch_mode<bf16, 8, false>(a, st, tf);
}
