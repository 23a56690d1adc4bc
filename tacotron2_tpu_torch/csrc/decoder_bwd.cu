// Tacotron teacher-forced decode, backward: the reverse-time (BPTT) chain of
// the train forward, one thread-block cluster for 8 rows of the batch.
//
// Replaces tacotron2_tpu/ops/tacotron_train_kernel.py `build_train_bwd`
// (pallas_call at :622). The wrapper is tacotron2_tpu_torch/ops/
// tacotron_train_kernel.py:teacher_forced_bwd, the plain version
// models/tacotron/decoder.py:teacher_forced_bwd_plain, whose docstring
// states the function. From the train forward's residuals (csrc/decoder.cu
// in train mode: gates z1, z2, cells c1, c2, prenet outputs h0d, hpre, the
// query q, the alignments and the cumulative alignments before each step)
// and the gradients of the frames | stop logits (dout) and of the
// alignments, it walks the steps from the last to the first and writes the
// per-step activation gradients dz1, dz2 (gates), da0, da1 (prenet
// pre-activations), dproj (with the scheduled-sampling feedback), dctx, dq
// and the cumulative alignments' gradient carried into the step (dcum);
// the sums over the steps of the gradients of the keys (with the folded
// attention bias); and partial sums of the gradients of the folded
// location taps wp [K, A] (per cluster and CTA) and of v_a (per row and
// CTA). The weight gradients are products outside the kernel
// (`weight_grads`, as JAX leaves them to XLA).
//
// Rounding. The kernel is a template on the weight type W (`__nv_bfloat16`
// or `float`, one type for every matmul weight). With bf16 weights it
// rounds where `build_train_bwd` rounds: the activations enter each
// product as they entered the forward's (the cumulative weights, the memory
// and the taps rounded), the gates and cells are read rounded as JAX
// stores them, and every gradient is rounded to bf16 where it enters a
// product (dproj, the summed dctx, the energies' gradient in the taps' sum
// and the cumulative-alignment chain, dq, dz2, dz1, da1, da0); the
// per-step outputs are those rounded values. The products are then
// bf16 × bf16 with f32 sums: mma.sync m16n8k16. dkeys, the v_a sums, the
// LSTM cell chain and the carried dh and dcum sums stay f32. With f32
// weights nothing is rounded and the products are 3xTF32 (m16n8k8, each
// operand split into two TF32 values, lo·lo dropped).
//
// Design. A cluster of CS CTAs (16 at a non-portable size where the
// widths split 16 ways, else 8; `bwd_cluster_size`) runs RB = 8 rows
// through every step; ceil(B/8) clusters, all resident at once at B = 16,
// and a missing row reads zeros and is never written back. CTA `rank`
// owns the four gate columns of U/CS units of each LSTM, as the forward
// does, so it forms its units' gate gradients dz locally; every
// transposed product is out[m][n] = sum_k A[m][k] · G[n][k] with the 8
// rows as mma's n, so each weight tile, read once a step, serves all 8:
//
//   proj  A = the projection's rows of own units and own context columns,
//         k over the frames | stop logits (G = dproj);
//   wq    A = the query weight's rows of own units, k over A (G = dq);
//   W2ᵀ   A = this CTA's gate columns of [l2_wx; l2_wh], k over its 4U/CS
//         gate columns (G = dz2): a partial over the cluster;
//   W1ᵀ   likewise [l1_wp; l1_wc; l1_wh] (G = dz1);
//   pre1  A = pre_w1, k over P (G = da1), and pre0 A = pre_w0 (G = da0):
//         every CTA the whole prenet, whose input gradient every CTA's
//         next step needs.
//
// The weight stream. The wrapper packs each CTA's tiles of its four own
// products, in that order, then once the prenet's, which every CTA reads,
// as mma A fragments (`bwd_stream`: 512 bytes a 16-row tile, 16 bytes a
// lane, m-tiles in groups of the 16 compute warps, k-tiles KC a warp in
// each 32 KB chunk); the weights change every train step, so it packs
// them on every call. A producer warp keeps a ring of chunks in shared
// memory full with cp.async.bulk (TMA) copies that complete on a slot's
// mbarrier; each compute warp waits for a chunk's bytes, takes its tiles
// and arrives on the slot's "empty" barrier, and the producer refills a
// slot once all 16 have, so no compute warp waits for another. The stream
// runs on across products and steps: while the cluster exchanges partials
// or works on the attention, the next product's first chunks are in
// flight. The producer takes its part in the cluster barriers (every
// thread of a cluster arrives at each): before barrier k it issues only
// the chunks the compute warps take before it, and a ring's worth past
// them. Each k-step's product comes from zero and is added in f32 in step
// order (the tensor cores' own accumulation truncates).
//
// Exchanges go through global memory (L2), not shared memory, so that no
// width of the envelope has to fit in a CTA: each CTA writes its partials
// (W2ᵀ and W1ᵀ over its gate columns, the dalign · memory product over its
// context columns, dq and the location conv's transpose over its input
// positions), a cluster barrier (release / acquire at cluster scope)
// orders them, and each CTA adds, in rank order 0..CS-1, what it needs
// (reads `__ldcg`, from L2): a reduce-scatter for the LSTM states and the
// context, an all-reduce for the prenet's input gradient, the alignment
// gradient and the cumulative-alignment chain. Four cluster barriers a
// step; every partial buffer is written again only after a barrier that
// each of its readers passed after reading it. The attention backward
// splits the input positions: CTA `rank` recomputes the energies' tanh for
// its ceil(T/CS) positions of all 8 rows (from the saved query and
// cumulative alignments: nothing [S, B, T, A]-sized is stored) and keeps
// the sums over the steps of the keys', taps' and v_a's gradients for
// them. Every sum goes in a fixed order, so reruns repeat every bit.
//
// Shared memory: the ring (at least MIN_SLOTS chunks) and, in a fixed
// priority, the mma B operands, the product outputs, the carried states
// and the attention's vectors and sums; what does not fit lives in a
// global scratch of the CTA instead (`layout`), so every width and T_in
// runs. At the default widths, CS 16 and T_in 96 everything fits.
//
// Bound: the bytes of the weight stream, once a cluster a step (~2.6 MB a
// CTA in bf16, ~5.2 MB in f32 at the default widths and CS 16), at what
// one SM draws from L2 through the ring; the operations are far below.
// scripts/profile_taco_bwd.py times each phase of the step.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int NW = 16;                 // compute warps a CTA
constexpr int NT = NW * 32;            // compute threads
constexpr int NTP = NT + 32;           // and the producer warp
constexpr int RB = 8;                  // rows a cluster: mma's n
constexpr int KC = 4;                  // k-tiles a warp in each chunk
constexpr int TILE = 512;              // bytes of one A-fragment tile
constexpr int CHUNK = NW * KC * TILE;  // bytes of one ring slot
constexpr int MIN_SLOTS = 2, MAX_SLOTS = 6;
constexpr int BAR_BYTES = 128;         // the slots' mbarriers
constexpr int SMEM_MAX = 232448;

enum Ptr {
  P_STREAM, P_KEYS, P_MEMORY, P_WP, P_V_A, P_ALIGN, P_CUM, P_Q, P_Z1, P_Z2,
  P_C1, P_C2, P_H0D, P_HPRE, P_DROP, P_ZMASK, P_COINS, P_DOUT, P_DALIGN,
  P_DZ1, P_DZ2, P_DA0, P_DA1, P_DPROJ, P_DCTX, P_DQ, P_DCUM, P_DKEYS, P_DWP,
  P_DVA, P_SCRATCH, N_PTR
};
enum Int {
  I_B, I_T, I_S, I_MELS, I_P, I_U, I_M, I_A, I_KW, I_R, I_FOP, I_F32_WEIGHTS,
  I_CS, N_INT
};
enum Prod { PR_PROJ, PR_WQ, PR_W2, PR_W1, PR_PRE1, PR_PRE0, N_PROD };
// Buffers of a CTA, in the order they claim shared memory: the B operands
// (type W, pitched), the product outputs, the carried and per-step state,
// the attention's vectors and scratch.
enum Buf {
  B_GPROJ, B_GQ, B_GZ, B_GA1, B_GA0, B_OPROJ, B_OWQ, B_OPRE1, B_OPRE0,
  B_DH1C, B_DC1C, B_DH2C, B_DC2C, B_DHZ, B_DCTXC, B_DCTXR, B_DX, B_CUMR,
  B_Q, B_VA, B_WP, B_DCUM, B_DEN, B_G, B_SDVA, B_SDWP, B_DE, B_SDKEYS,
  N_BUF
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
  int cs, KS, Uc, Mc, Tc, K1;
  int rows[N_PROD], kp[N_PROD], ng[N_PROD], nck[N_PROD];
  int c0[N_PROD];    // a product's first chunk in the step
  int gp[5];         // B operands' pitches (elements of W)
  int nch, npriv;    // chunks a step; of them, the CTA's own (the rest,
                     // the prenet's, every CTA of the cluster shares)
  long long stream, shared;  // bytes of a CTA's own stream, of the shared
  long long off[N_BUF];
  unsigned char sm[N_BUF];  // 1: in shared memory, 0: in the CTA's spill
  int ns, o_slots, smem;  // ring slots, their offset; bytes in all
  long long cta_spill;  // bytes of global scratch a CTA
  long long o_pt, o_pc, o_pq, o_ex2, o_ex1, o_cta, cluster;  // a cluster's
};

__host__ __device__ inline Layout layout(int T, int mels, int P, int U, int M,
                                         int A, int KW, int FOp, int cs,
                                         int f32) {
  Layout y;
  const int es = f32 ? 4 : 2;
  y.cs = cs;
  y.KS = f32 ? 8 : 16;
  y.Uc = U / cs;
  y.Mc = M / cs;
  y.Tc = (T + cs - 1) / cs;
  y.K1 = P + M + U;
  const int rows[N_PROD] = {y.Uc + y.Mc, y.Uc, 2 * U, y.K1, P, mels};
  const int ks[N_PROD] = {FOp, A, 4 * y.Uc, 4 * y.Uc, P, P};
  y.nch = y.npriv = 0;
  for (int p = 0; p < N_PROD; ++p) {
    y.rows[p] = rows[p];
    y.kp[p] = (int)up(ks[p], y.KS * KC);
    y.ng[p] = (int)((up(rows[p], 16) / 16 + NW - 1) / NW);
    y.nck[p] = y.kp[p] / (y.KS * KC);
    y.c0[p] = y.nch;
    y.nch += y.ng[p] * y.nck[p];
    if (p < PR_PRE1) y.npriv = y.nch;
  }
  y.stream = (long long)y.npriv * CHUNK;
  y.shared = (long long)(y.nch - y.npriv) * CHUNK;
  const int gk[5] = {y.kp[PR_PROJ], y.kp[PR_WQ], y.kp[PR_W2], y.kp[PR_PRE1],
                     y.kp[PR_PRE0]};
  long long sz[N_BUF];
  for (int i = 0; i < 5; ++i) {
    y.gp[i] = pitch_words(gk[i] * es / 4) * 4 / es;
    sz[i] = (long long)RB * y.gp[i] * es;
  }
  const long long f = 4 * RB;  // a float for each row
  sz[B_OPROJ] = f * (y.Uc + y.Mc);
  sz[B_OWQ] = f * y.Uc;
  sz[B_OPRE1] = f * P;
  sz[B_OPRE0] = f * mels;
  sz[B_DH1C] = sz[B_DC1C] = sz[B_DH2C] = sz[B_DC2C] = sz[B_DHZ] = f * y.Uc;
  sz[B_DCTXC] = sz[B_DCTXR] = f * y.Mc;
  sz[B_DX] = f * mels;
  sz[B_CUMR] = f * T;
  sz[B_Q] = f * A;
  sz[B_VA] = 4LL * A;
  sz[B_WP] = 4LL * KW * (A + 1);
  sz[B_DCUM] = f * T;
  sz[B_DEN] = f * y.Tc;
  sz[B_G] = f * y.Tc * KW;
  sz[B_SDVA] = f * A;
  sz[B_SDWP] = 4LL * KW * A;
  sz[B_DE] = f * y.Tc * A;
  sz[B_SDKEYS] = f * y.Tc * A;
  long long used = BAR_BYTES, spill = 0;
  const long long budget = SMEM_MAX - (long long)MIN_SLOTS * CHUNK;
  for (int i = 0; i < N_BUF; ++i) {
    const long long b = up(sz[i], 16);
    if (used + b <= budget) {
      y.sm[i] = 1;
      y.off[i] = used;
      used += b;
    } else {
      y.sm[i] = 0;
      y.off[i] = spill;
      spill += b;
    }
  }
  y.o_slots = (int)up(used, 128);
  y.ns = (int)((SMEM_MAX - y.o_slots) / CHUNK);
  if (y.ns > MAX_SLOTS) y.ns = MAX_SLOTS;
  y.smem = y.o_slots + y.ns * CHUNK;
  y.cta_spill = up(spill, 256);
  const long long part = 4LL * cs * RB;  // a float for each rank and row
  y.o_pt = 0;
  y.o_pc = y.o_pt + up(part * T, 256);
  y.o_pq = y.o_pc + up(part * T, 256);
  y.o_ex2 = y.o_pq + up(part * A, 256);
  y.o_ex1 = y.o_ex2 + up(part * 2 * U, 256);
  y.o_cta = y.o_ex1 + up(part * y.K1, 256);
  y.cluster = y.o_cta + (long long)cs * y.cta_spill;
  return y;
}

struct BwdArgs {
  // `bwd_stream`: [cs, layout.stream] bytes, each CTA's own products,
  // then the prenet's chunks, which every CTA reads
  const unsigned char* stream;
  const float* keys;    // [B, T, A] keys + folded attention bias
  const void* memory;   // [B, T, M] in the weight type
  const float* wp;      // [KW, A] folded location taps (rounded likewise)
  const float* v_a;     // [A]
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
  float* dcum;           // [B, S, T] the cumulative alignments' gradient
                         // carried into each step
  float* dkeys;          // [B, T, A]
  float* dwp;            // [clusters, cs, KW, A] per-CTA partial sums
  float* dva;            // [B, cs, A]
  unsigned char* scratch;  // [clusters, layout.cluster] bytes
  int B, T, S, mels, P, U, M, A, KW, r, FOp;
  Layout y;
};

// ------------------------------------------ TMA bulk copies and mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// The ring of weight chunks: slot q % ns holds chunk q of the whole run
// (step-major), whose bytes are chunk q % nch of the stream: the CTA's own
// chunks, then the shared ones.
struct Ring {
  unsigned char* slots;
  uint64_t* full;   // [ns] the copy's bytes arrived
  uint64_t* empty;  // [ns] every compute warp is done with the slot
  const unsigned char* own;
  const unsigned char* shared;
  int ns, nch, npriv;
  long long total;
};

// Chunk q into its slot once the slot's last chunk is consumed (the
// producer warp's lane 0).
__device__ __forceinline__ void issue(const Ring& r, long long q) {
  const int s = (int)(q % r.ns);
  if (q >= r.ns)
    mbar_wait(smem_u32(r.empty + s), (uint32_t)((q / r.ns - 1) & 1));
  const int c = (int)(q % r.nch);
  const unsigned char* src = c < r.npriv
                                 ? r.own + (size_t)c * CHUNK
                                 : r.shared + (size_t)(c - r.npriv) * CHUNK;
  const uint32_t bar = smem_u32(r.full + s);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(CHUNK)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(r.slots + (size_t)s * CHUNK)),
      "l"(src), "r"(CHUNK), "r"(bar)
      : "memory");
}

// the compute warps' barrier (the producer warp takes no part)
__device__ __forceinline__ void sync_compute() {
  asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory");
}

// ------------------------------------------------------------- products

using taco::Step;  // one k-step of a warp (common.cuh)

// out[n * ldo + m] = sum_k A[m][k] · G[n][k] for m < rows, n < RB: the
// product's ng groups of 16 m-tiles (warp w takes m-tile 16·group + w),
// nck chunks of KC k-tiles a group, taken from the ring from chunk q on
// (q advances past them). Every compute warp calls it; none waits for
// another, only for the chunks' bytes.
template <typename W>
__device__ __noinline__ void product(const Ring& r, long long& q, int ng,
                                     int nck, const W* G, int gp, float* out,
                                     int ldo, int rows) {
  constexpr int KS = std::is_same<W, bf16>::value ? 16 : 8;
  using St = Step<W>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  for (int gi = 0; gi < ng; ++gi) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < nck; ++c, ++q) {
      const int s = (int)(q % r.ns);
      mbar_wait(smem_u32(r.full + s), (uint32_t)((q / r.ns) & 1));
      const uint4* A = reinterpret_cast<const uint4*>(
                           r.slots + (size_t)s * CHUNK + warp * KC * TILE) +
                       lane;
      typename St::Frag fr[KC];
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        St::load(fr[kk], A[kk * 32], G, gp, (c * KC + kk) * KS, g8, t4);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(r.empty + s));
      float d[KC][4];
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) St::run(d[kk], fr[kk]);
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += d[kk][e];
    }
    const int m = (gi * NW + warp) * 16 + g8;
    if (m < rows) {
      out[(2 * t4) * ldo + m] = acc[0];
      out[(2 * t4 + 1) * ldo + m] = acc[1];
    }
    if (m + 8 < rows) {
      out[(2 * t4) * ldo + m + 8] = acc[2];
      out[(2 * t4 + 1) * ldo + m + 8] = acc[3];
    }
  }
}

// The producer warp: lane 0 keeps the ring full, and the warp takes its
// part in the cluster barriers of every step (all threads of a cluster
// arrive at each). Before barrier k it issues only the chunks the compute
// warps consume before it, and ns past them, so it never waits for a slot
// that only a later barrier frees.
__device__ void produce(const Ring& r, const Layout& y, int S,
                        cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31;
  // chunks of a step consumed before S1, S3 and S4 (S2: as S1) and at its end
  const int ends[5] = {y.c0[PR_WQ], y.c0[PR_WQ], y.c0[PR_W1], y.c0[PR_PRE1],
                       y.nch};
  long long q = 0;
  for (int t = 0; t < S; ++t) {
    for (int k = 0; k < 5; ++k) {
      const long long lim = (long long)t * y.nch + ends[k] + r.ns;
      if (lane == 0)
        for (; q < lim && q < r.total; ++q) issue(r, q);
      __syncwarp();
      if (k < 4) cluster.sync();
    }
  }
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}

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

// Backward of one train-mode zoneout LSTM unit (the plain version's
// _lstm_bwd) from its gates z (natural order, already rounded as the route
// reads them), previous cell cp, masks mc, mh, the gradient dh and the
// carried dc (updated to the previous cell's). Writes the gate gradients
// to g[4] and returns the part of dh that zoned out.
__device__ __forceinline__ float lstm_unit_bwd(const float* z, float cp,
                                               float mc, float mh, float dh,
                                               float& dc, float* g) {
  const float si = taco::sigmoidf(z[0]), tj = tanhf(z[1]);
  const float sf = taco::sigmoidf(z[2]), so = taco::sigmoidf(z[3]);
  const float tnc = tanhf(sf * cp + si * tj);
  const float dnh = dh * mh;
  const float dnc = dc * mc + dnh * so * (1.f - tnc * tnc);
  g[0] = dnc * tj * si * (1.f - si);
  g[1] = dnc * si * (1.f - tj * tj);
  g[2] = dnc * cp * sf * (1.f - sf);
  g[3] = dnh * tnc * so * (1.f - so);
  dc = dc * (1.f - mc) + dnc * sf;
  return dh * (1.f - mh);
}

// Built with -DTACO_BWD_PROFILE, thread 0 of the first CTA adds up the
// clock cycles of each phase of the step and writes them, as long longs,
// over the start of the scratch when it ends (a measuring build only).
#ifdef TACO_BWD_PROFILE
#define PHASE(i)                    \
  if (tid == 0 && blockIdx.x == 0) { \
    const long long now = clock64(); \
    prof[i] += now - prof_t;         \
    prof_t = now;                    \
  }
#else
#define PHASE(i)
#endif

template <typename W, int CSX>
__global__ void __cluster_dims__(CSX, 1, 1) __launch_bounds__(NTP, 1)
    decoder_bwd_kernel(const BwdArgs a) {
  constexpr bool kBf16 = std::is_same<W, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout& y = a.y;
  const int rank = (int)cluster.block_rank();
  const int cb = blockIdx.x / CSX, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int T = a.T, S = a.S, P = a.P, U = a.U, M = a.M, A = a.A, KW = a.KW;
  const int mels = a.mels, FO = a.r * mels + a.r, fb0 = (a.r - 1) * mels;
  const int Uc = y.Uc, Mc = y.Mc, Tc = y.Tc, K1 = y.K1;
  const int tp0 = rank * Tc;
  const int nT = max(0, min(Tc, T - tp0));  // this CTA's input positions
  const int pad = (KW - 1) / 2;
  const int b0 = cb * RB, nb = min(RB, a.B - b0);  // rows of this cluster
  auto rg = [](float v) { return kBf16 ? taco::round_bf16(v) : v; };

  unsigned char* gcl = a.scratch + (size_t)cb * y.cluster;
  unsigned char* gcta = gcl + y.o_cta + (size_t)rank * y.cta_spill;
  auto buf = [&](int i) -> void* {
    return y.sm[i] ? (void*)(smem + y.off[i]) : (void*)(gcta + y.off[i]);
  };
  W* gproj = (W*)buf(B_GPROJ);
  W* gq = (W*)buf(B_GQ);
  W* gz = (W*)buf(B_GZ);
  W* ga1 = (W*)buf(B_GA1);
  W* ga0 = (W*)buf(B_GA0);
  float* oproj = (float*)buf(B_OPROJ);  // [RB][Uc + Mc]: dh2 out | dctx
  float* owq = (float*)buf(B_OWQ);      // [RB][Uc]
  float* opre1 = (float*)buf(B_OPRE1);  // [RB][P]
  float* opre0 = (float*)buf(B_OPRE0);  // [RB][mels]
  float* dh1c = (float*)buf(B_DH1C);    // [RB][Uc] carried, own units
  float* dc1c = (float*)buf(B_DC1C);
  float* dh2c = (float*)buf(B_DH2C);
  float* dc2c = (float*)buf(B_DC2C);
  float* dhz = (float*)buf(B_DHZ);      // [RB][Uc] the zoned-out dh
  float* dctxc = (float*)buf(B_DCTXC);  // [RB][Mc] carried, own columns
  float* dctxr = (float*)buf(B_DCTXR);  // [RB][Mc] this step's, rounded
  float* dx = (float*)buf(B_DX);        // [RB][mels] the input frame's
  float* cumr = (float*)buf(B_CUMR);    // [RB][T] rounded as the forward
  float* qv = (float*)buf(B_Q);         // [RB][A]
  float* va = (float*)buf(B_VA);        // [A]
  // [KW][A + 1]: the pitch A + 1 keeps a warp's lanes on different banks
  // both along a row (the location features) and down a column (de · taps)
  float* wp = (float*)buf(B_WP);
  const int WPP = A + 1;
  float* dcum = (float*)buf(B_DCUM);    // [RB][T] the carried chain
  float* den = (float*)buf(B_DEN);      // [RB][Tc] own positions
  float* gk = (float*)buf(B_G);         // [RB][Tc][KW] de · taps
  float* sdva = (float*)buf(B_SDVA);    // [RB][A] v_a's sum, own positions
  float* sdwp = (float*)buf(B_SDWP);    // [KW][A] the taps' sum, alike
  float* de = (float*)buf(B_DE);        // [RB][Tc][A] rounded de
  float* sdkeys = (float*)buf(B_SDKEYS);  // [RB][Tc][A] dkeys' sum
  const W* memw = static_cast<const W*>(a.memory);
  // partials a cluster exchanges, [cs][RB][·]
  float* pt = (float*)(gcl + y.o_pt);
  float* pc = (float*)(gcl + y.o_pc);
  float* pq = (float*)(gcl + y.o_pq);
  float* ex2 = (float*)(gcl + y.o_ex2);
  float* ex1 = (float*)(gcl + y.o_ex1);
  const int gp0 = y.gp[0], gp1 = y.gp[1], gp2 = y.gp[2], gp3 = y.gp[3],
            gp4 = y.gp[4];

  Ring ring;
  ring.slots = smem + y.o_slots;
  ring.full = reinterpret_cast<uint64_t*>(smem);
  ring.empty = ring.full + MAX_SLOTS;
  ring.own = a.stream + (size_t)rank * y.stream;
  ring.shared = a.stream + (size_t)CSX * y.stream;
  ring.ns = y.ns;
  ring.nch = y.nch;
  ring.npriv = y.npriv;
  ring.total = (long long)S * y.nch;
  long long q = 0;  // the next chunk a compute warp takes
  auto prod = [&](int p, const W* G, int gp, float* out, int ldo) {
    product<W>(ring, q, y.ng[p], y.nck[p], G, gp, out, ldo, y.rows[p]);
  };

  // ---- set-up: zero the B operands (their padding stays zero), the
  // carried state; the attention's constants
  if (tid < NT) {
    for (int i = tid; i < RB * gp0; i += NT) put<W>(gproj + i, 0.f);
    for (int i = tid; i < RB * gp1; i += NT) put<W>(gq + i, 0.f);
    for (int i = tid; i < RB * gp2; i += NT) put<W>(gz + i, 0.f);
    for (int i = tid; i < RB * gp3; i += NT) put<W>(ga1 + i, 0.f);
    for (int i = tid; i < RB * gp4; i += NT) put<W>(ga0 + i, 0.f);
    for (int i = tid; i < RB * Uc; i += NT)
      dh1c[i] = dc1c[i] = dh2c[i] = dc2c[i] = 0.f;
    for (int i = tid; i < RB * Mc; i += NT) dctxc[i] = 0.f;
    for (int i = tid; i < RB * mels; i += NT) dx[i] = 0.f;
    for (int i = tid; i < RB * T; i += NT) dcum[i] = 0.f;
    for (int i = tid; i < KW * A; i += NT) {
      wp[(i / A) * WPP + i % A] = a.wp[i];
      sdwp[i] = 0.f;
    }
    for (int i = tid; i < A; i += NT) va[i] = a.v_a[i];
    for (int i = tid; i < RB * A; i += NT) sdva[i] = 0.f;
    for (int i = tid; i < RB * Tc * A; i += NT) sdkeys[i] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < y.ns; ++s) {
      mbar_init(smem_u32(ring.full + s), 1);
      mbar_init(smem_u32(ring.empty + s), NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == NW) {  // the producer warp
    produce(ring, y, S, cluster);
    return;
  }
#ifdef TACO_BWD_PROFILE
  long long prof[21] = {0}, prof_t = clock64();
#endif

  for (int t = S - 1; t >= 0; --t) {
    auto row = [&](int n) { return (size_t)(b0 + n) * S + t; };

    // ---- the projection's gradient, with the feedback into its last
    // frame; this step's cumulative alignments and query
    for (int i = tid; i < RB * y.kp[PR_PROJ]; i += NT) {
      const int n = i / y.kp[PR_PROJ], f = i % y.kp[PR_PROJ];
      if (f >= FO) continue;
      float v = n < nb ? a.dout[row(n) * FO + f] : 0.f;
      if (f >= fb0 && f < fb0 + mels) v += dx[n * mels + f - fb0];
      v = rg(v);
      put<W>(gproj + n * gp0 + f, v);
      if (rank == 0 && n < nb) a.dproj[row(n) * FO + f] = v;
    }
    for (int i = tid; i < RB * T; i += NT) {
      const int n = i / T;
      cumr[i] = n < nb ? rg(a.cum[row(n) * T + i % T]) : 0.f;
    }
    for (int i = tid; i < RB * A; i += NT) {
      const int n = i / A;
      qv[i] = n < nb ? a.q[row(n) * A + i % A] : 0.f;
    }
    sync_compute();
    PHASE(0)

    // ---- the projection's transpose: own units (dh2), own context
    // columns (dctx)
    prod(PR_PROJ, gproj, gp0, oproj, Uc + Mc);
    sync_compute();
    PHASE(1)
    for (int i = tid; i < RB * Mc; i += NT) {
      const int n = i / Mc, m = i % Mc;
      const float v = rg(oproj[n * (Uc + Mc) + Uc + m] + dctxc[i]);
      dctxr[i] = v;
      if (n < nb) a.dctx[row(n) * M + rank * Mc + m] = v;
    }
    sync_compute();
    PHASE(2)

    // ---- dalign = memory · dctx over this CTA's columns: partials
    // a thread a (row, position): its columns in 16-byte loads, four in
    // flight (scalar loads where the columns are not 16-byte aligned)
    {
      using Pk = taco::Pack<W>;
      constexpr int V = Pk::V;
      const bool vec = Mc % V == 0 && M % V == 0;
      for (int p = tid; p < RB * T; p += NT) {
        const int n = p / T, tt = p % T;
        float acc = 0.f;
        if (n < nb) {
          const W* mr = memw + ((size_t)(b0 + n) * T + tt) * M + rank * Mc;
          const float* x = dctxr + n * Mc;
          if (vec) {
            for (int m0 = 0; m0 < Mc; m0 += 4 * V) {
              typename Pk::Raw raw[4];
#pragma unroll
              for (int u = 0; u < 4; ++u)
                raw[u] = m0 + u * V < Mc ? Pk::ld(mr + m0 + u * V)
                                         : typename Pk::Raw{};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                if (m0 + u * V >= Mc) break;
                float v[V];
                Pk::cvt(raw[u], v);
#pragma unroll
                for (int e = 0; e < V; ++e)
                  acc = fmaf(x[m0 + u * V + e], v[e], acc);
              }
            }
          } else {
            for (int m = 0; m < Mc; ++m) acc = fmaf(x[m], ld(mr + m), acc);
          }
        }
        pt[(rank * RB + n) * T + tt] = acc;
      }
    }
    PHASE(3)
    cluster.sync();  // S1: the dalign partials are complete
    PHASE(4)

    // ---- softmax backward, a warp a row (masked positions have align 0:
    // no gradient); den for own positions
    if (warp < RB) {
      const int n = warp;
      float dot = 0.f;
      for (int i = lane; i < T; i += 32) {
        float dal = 0.f;
        for (int r = 0; r < CSX; ++r) dal += __ldcg(pt + (r * RB + n) * T + i);
        if (n < nb) dal += a.dalign[row(n) * T + i];
        const float dc = dcum[n * T + i];
        if (rank == 0 && n < nb) a.dcum[row(n) * T + i] = dc;
        dal += dc;
        const float al = n < nb ? a.align[row(n) * T + i] : 0.f;
        dot = fmaf(dal, al, dot);
        if (i >= tp0 && i < tp0 + nT) den[n * Tc + i - tp0] = dal;
      }
      dot = taco::warp_sum(dot);
      __syncwarp();
      for (int i = tp0 + lane; i < tp0 + nT; i += 32) {
        const float al = n < nb ? a.align[row(n) * T + i] : 0.f;
        den[n * Tc + i - tp0] = al * (den[n * Tc + i - tp0] - dot);
      }
    }
    sync_compute();
    PHASE(5)

    // ---- own positions: the energies' tanh again and its gradient; dkeys,
    // the rounded gradient, dq's partial, v_a's sum
    for (int p = tid; p < RB * A; p += NT) {
      const int n = p / A, aa = p % A;
      const float vaa = va[aa], qa = qv[p];
      const float* cr = cumr + n * T;
      float sq = 0.f, sv = 0.f;
      for (int i0 = 0; i0 < nT; i0 += 4) {
        // four positions at once: their keys in flight, each tap's weight
        // loaded once for the four location features
        float key[4], loc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          key[j] = n < nb && i0 + j < nT
                       ? a.keys[((size_t)(b0 + n) * T + tp0 + i0 + j) * A + aa]
                       : 0.f;
          loc[j] = 0.f;
        }
        for (int k = 0; k < KW; ++k) {
          const float w = wp[k * WPP + aa];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int si = tp0 + i0 + j + k - pad;
            if (si >= 0 && si < T) loc[j] = fmaf(cr[si], w, loc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = i0 + j;
          if (i >= nT) break;
          const float e = tanhf(key[j] + qa + loc[j]);
          const float dn = den[n * Tc + i];
          const float d = dn * vaa * (1.f - e * e);
          sdkeys[(n * Tc + i) * A + aa] += d;
          de[(n * Tc + i) * A + aa] = rg(d);
          sq += d;
          sv += e * dn;
        }
      }
      pq[(rank * RB + n) * A + aa] = sq;
      sdva[p] += sv;
    }
    sync_compute();
    PHASE(6)
    // the taps' gradient over the rows and own positions (each tap's
    // positions in range hoisted out of the loop); de · taps, a lane a tap
    for (int p = tid; p < KW * A; p += NT) {
      const int k = p / A, aa = p % A;
      const int i_lo = max(0, pad - k - tp0), i_hi = min(nT, T + pad - k - tp0);
      float acc = 0.f;
      for (int n = 0; n < RB; ++n) {
        const float* cr = cumr + n * T + tp0 + k - pad;
        const float* dr = de + n * Tc * A + aa;
#pragma unroll 4
        for (int i = i_lo; i < i_hi; ++i) acc = fmaf(cr[i], dr[i * A], acc);
      }
      sdwp[p] += acc;
    }
    PHASE(20)
    for (int task = warp; task < RB * nT; task += NW) {
      const int n = task / nT, i = task % nT;
      const float* dr = de + (n * Tc + i) * A;
      for (int k = lane; k < KW; k += 32) {
        float acc = 0.f;
#pragma unroll 4
        for (int aa = 0; aa < A; ++aa) acc = fmaf(dr[aa], wp[k * WPP + aa], acc);
        gk[(n * Tc + i) * KW + k] = acc;
      }
    }
    sync_compute();
    PHASE(7)
    // the location conv's transpose: position s takes g[i, s - tt_i + pad]
    for (int p = tid; p < RB * T; p += NT) {
      const int n = p / T, s = p % T;
      float acc = 0.f;
      for (int i = 0; i < nT; ++i) {
        const int k = s - (tp0 + i) + pad;
        if (k >= 0 && k < KW) acc += gk[(n * Tc + i) * KW + k];
      }
      pc[(rank * RB + n) * T + s] = acc;
    }
    PHASE(8)
    cluster.sync();  // S2: dq and dcum partials are complete
    PHASE(9)
    for (int p = tid; p < RB * A; p += NT) {
      const int n = p / A, aa = p % A;
      float v = 0.f;
      for (int r = 0; r < CSX; ++r) v += __ldcg(pq + (r * RB + n) * A + aa);
      v = rg(v);
      put<W>(gq + n * gp1 + aa, v);
      if (rank == 0 && n < nb) a.dq[row(n) * A + aa] = v;
    }
    for (int p = tid; p < RB * T; p += NT) {
      const int n = p / T, s = p % T;
      float v = 0.f;
      for (int r = 0; r < CSX; ++r) v += __ldcg(pc + (r * RB + n) * T + s);
      dcum[p] += v;
    }
    sync_compute();
    PHASE(10)

    // ---- LSTM2: dh = projection + attention query + carried
    prod(PR_WQ, gq, gp1, owq, Uc);
    sync_compute();
    PHASE(11)
    for (int p = tid; p < RB * Uc; p += NT) {
      const int n = p / Uc, u = p % Uc, unit = rank * Uc + u;
      const float dh = oproj[n * (Uc + Mc) + u] + owq[p] + dh2c[p];
      float z[4], cp = 0.f, mc = 0.f, mh = 0.f;
      for (int k = 0; k < 4; ++k) z[k] = 0.f;
      if (n < nb) {
        for (int k = 0; k < 4; ++k) z[k] = rg(a.z2[row(n) * 4 * U + k * U + unit]);
        if (t) cp = rg(a.c2[(row(n) - 1) * U + unit]);
        const uint8_t* zm = a.zmask + row(n) * 4 * U;
        mc = zm[2 * U + unit] ? 1.f : 0.f;
        mh = zm[3 * U + unit] ? 1.f : 0.f;
      }
      float g[4];
      dhz[p] = lstm_unit_bwd(z, cp, mc, mh, dh, dc2c[p], g);
      for (int k = 0; k < 4; ++k) {
        const float v = rg(g[k]);
        put<W>(gz + n * gp2 + k * Uc + u, v);
        if (n < nb) a.dz2[row(n) * 4 * U + k * U + unit] = v;
      }
    }
    sync_compute();
    PHASE(12)
    prod(PR_W2, gz, gp2, ex2 + rank * RB * 2 * U, 2 * U);
    PHASE(13)
    cluster.sync();  // S3: the W2ᵀ·dz2 partials are complete
    PHASE(14)

    // ---- LSTM1
    for (int p = tid; p < RB * Uc; p += NT) {
      const int n = p / Uc, u = p % Uc, unit = rank * Uc + u;
      float s1 = 0.f, s2 = 0.f;
      for (int r = 0; r < CSX; ++r) {
        const float* e2 = ex2 + (r * RB + n) * 2 * U;
        s1 += __ldcg(e2 + unit);
        s2 += __ldcg(e2 + U + unit);
      }
      dh2c[p] = dhz[p] + s2;
      const float dh = s1 + dh1c[p];
      float z[4], cp = 0.f, mc = 0.f, mh = 0.f;
      for (int k = 0; k < 4; ++k) z[k] = 0.f;
      if (n < nb) {
        for (int k = 0; k < 4; ++k) z[k] = rg(a.z1[row(n) * 4 * U + k * U + unit]);
        if (t) cp = rg(a.c1[(row(n) - 1) * U + unit]);
        const uint8_t* zm = a.zmask + row(n) * 4 * U;
        mc = zm[unit] ? 1.f : 0.f;
        mh = zm[U + unit] ? 1.f : 0.f;
      }
      float g[4];
      dhz[p] = lstm_unit_bwd(z, cp, mc, mh, dh, dc1c[p], g);
      for (int k = 0; k < 4; ++k) {
        const float v = rg(g[k]);
        put<W>(gz + n * gp2 + k * Uc + u, v);
        if (n < nb) a.dz1[row(n) * 4 * U + k * U + unit] = v;
      }
    }
    sync_compute();
    PHASE(15)
    prod(PR_W1, gz, gp2, ex1 + rank * RB * K1, K1);
    PHASE(16)
    cluster.sync();  // S4: the W1ᵀ·dz1 partials are complete
    PHASE(17)
    for (int p = tid; p < RB * P; p += NT) {
      const int n = p / P, i = p % P;
      float v = 0.f;
      for (int r = 0; r < CSX; ++r) v += __ldcg(ex1 + (r * RB + n) * K1 + i);
      // prenet (every CTA): relu and dropout through the saved outputs'
      // sign and the multipliers
      v = n < nb && a.hpre[row(n) * P + i] > 0.f
              ? v * a.drop[row(n) * 2 * P + P + i]
              : 0.f;
      v = rg(v);
      put<W>(ga1 + n * gp3 + i, v);
      if (rank == 0 && n < nb) a.da1[row(n) * P + i] = v;
    }
    for (int p = tid; p < RB * Mc; p += NT) {
      const int n = p / Mc, m = p % Mc;
      float v = 0.f;
      for (int r = 0; r < CSX; ++r)
        v += __ldcg(ex1 + (r * RB + n) * K1 + P + rank * Mc + m);
      dctxc[p] = v;
    }
    for (int p = tid; p < RB * Uc; p += NT) {
      const int n = p / Uc, u = p % Uc;
      float v = 0.f;
      for (int r = 0; r < CSX; ++r)
        v += __ldcg(ex1 + (r * RB + n) * K1 + P + M + rank * Uc + u);
      dh1c[p] = dhz[p] + v;
    }
    sync_compute();
    PHASE(18)
    prod(PR_PRE1, ga1, gp3, opre1, P);
    sync_compute();
    for (int p = tid; p < RB * P; p += NT) {
      const int n = p / P, i = p % P;
      float v = n < nb && a.h0d[row(n) * P + i] > 0.f
                    ? opre1[p] * a.drop[row(n) * 2 * P + i]
                    : 0.f;
      v = rg(v);
      put<W>(ga0 + n * gp4 + i, v);
      if (rank == 0 && n < nb) a.da0[row(n) * P + i] = v;
    }
    sync_compute();
    // the input frame's gradient feeds step t-1's projection where
    // coins[t] is 0
    prod(PR_PRE0, ga0, gp4, opre0, mels);
    sync_compute();
    const bool coin = a.coins[t] != 0;
    for (int p = tid; p < RB * mels; p += NT) dx[p] = coin ? 0.f : opre0[p];
    sync_compute();
    PHASE(19)
  }

  // ---- the sums over the steps
  for (int i = tid; i < RB * nT * A; i += NT) {
    const int n = i / (nT * A), r = i % (nT * A);
    if (n < nb)
      a.dkeys[((size_t)(b0 + n) * T + tp0) * A + r] =
          sdkeys[(n * Tc) * A + r];
  }
  for (int i = tid; i < KW * A; i += NT)
    a.dwp[((size_t)cb * CSX + rank) * KW * A + i] = sdwp[i];
  for (int i = tid; i < RB * A; i += NT) {
    const int n = i / A;
    if (n < nb)
      a.dva[((size_t)(b0 + n) * CSX + rank) * A + i % A] = sdva[i];
  }
#ifdef TACO_BWD_PROFILE
  if (tid == 0 && blockIdx.x == 0)
    for (int i = 0; i < 21; ++i) reinterpret_cast<long long*>(a.scratch)[i] = prof[i];
#endif
}

// The kernel's envelope: the widths its layout takes (the shared memory
// spills what does not fit, so T_in and the widths have no bound of
// their own here). The one statement of it, for every entry point.
bool supported(int T, int mels, int P, int U, int M, int A, int KW, int FOp,
               int r, int cs) {
  return (cs == 8 || cs == 16) && T >= 1 && mels >= 1 && P >= 1 && KW >= 1 &&
         A >= 1 && U >= cs && M >= cs && U % cs == 0 && M % cs == 0 &&
         (4 * U / cs) % 8 == 0 && P % 8 == 0 && A % 8 == 0 && FOp % 8 == 0 &&
         FOp >= r * mels + r && r >= 1;
}

template <typename W, int CSX>
int launch(BwdArgs& a, cudaStream_t stream) {
  void (*kernel)(const BwdArgs) = decoder_bwd_kernel<W, CSX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.y.smem);
  if (err == cudaSuccess && CSX > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  const int clusters = (a.B + RB - 1) / RB;
  kernel<<<clusters * CSX, NTP, a.y.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int taco_decoder_bwd_rows() { return RB; }
extern "C" int taco_decoder_bwd_n_ptr() { return N_PTR; }
extern "C" int taco_decoder_bwd_n_int() { return N_INT; }

extern "C" int taco_decoder_bwd_supported(int T, int mels, int P, int U,
                                          int M, int A, int KW, int FOp,
                                          int r, int cs) {
  return supported(T, mels, P, U, M, A, KW, FOp, r, cs) ? 1 : 0;
}

// The plan of a launch: out = {shared memory bytes, bytes of a CTA's own
// weight stream, bytes of the stream every CTA reads, bytes of global
// scratch a cluster, bytes a CTA spills, buffers in shared memory, ring
// slots}.
// Returns 0, or -1 outside the envelope.
extern "C" int taco_decoder_bwd_plan(int T, int mels, int P, int U, int M,
                                     int A, int KW, int FOp, int r, int cs,
                                     int f32, long long* out) {
  if (!supported(T, mels, P, U, M, A, KW, FOp, r, cs)) return -1;
  const Layout y = layout(T, mels, P, U, M, A, KW, FOp, cs, f32);
  int in_smem = 0;
  for (int i = 0; i < N_BUF; ++i) in_smem += y.sm[i];
  out[0] = y.smem;
  out[1] = y.stream;
  out[2] = y.shared;
  out[3] = y.cluster;
  out[4] = y.cta_spill;
  out[5] = in_smem;
  out[6] = y.ns;
  return 0;
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
  a.stream = (const unsigned char*)ptrs[P_STREAM];
  a.keys = (const float*)ptrs[P_KEYS];
  a.memory = ptrs[P_MEMORY];
  a.wp = (const float*)ptrs[P_WP];
  a.v_a = (const float*)ptrs[P_V_A];
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
  a.dcum = (float*)ptrs[P_DCUM];
  a.dkeys = (float*)ptrs[P_DKEYS];
  a.dwp = (float*)ptrs[P_DWP];
  a.dva = (float*)ptrs[P_DVA];
  a.scratch = (unsigned char*)ptrs[P_SCRATCH];
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
  const int f32 = ints[I_F32_WEIGHTS], cs = ints[I_CS];
  if (a.S < 1 || a.B < 1 ||
      !supported(a.T, a.mels, a.P, a.U, a.M, a.A, a.KW, a.FOp, a.r, cs))
    return (int)cudaErrorInvalidValue;
  a.y = layout(a.T, a.mels, a.P, a.U, a.M, a.A, a.KW, a.FOp, cs, f32);
  cudaStream_t st = (cudaStream_t)stream;
  if (cs == 16)
    return f32 ? launch<float, 16>(a, st) : launch<bf16, 16>(a, st);
  return f32 ? launch<float, 8>(a, st) : launch<bf16, 8>(a, st);
}
