// Whole WaveNet sample loop, every output head, one thread-block cluster for
// up to 8 rows of the batch.
//
// Replaces the TPU kernel tacotron2_tpu/ops/wavenet_kernel.py
// `build_sampler_kernel` (pallas_call at :313) and its HBM-delay variant
// `build_sampler_kernel_hbm` (:566), which give bit-identical results, with
// the three heads of `_HeadPlan` (:56) and its f32 or bf16 delay cache and
// weights. Per sample and layer: the kw=3 dilated conv over the taps
// (x_{t-2d}, x_{t-d}, x_t) and the 1x1 conditioning projection of c_up[t]
// as ONE product against the stacked weight czw [3R + C, G] (the TPU
// kernel's fusion), tanh·σ gate, and h @ [skip | out] as one product, with
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
// layer weights in bf16 and rounds the products' inputs (the taps, x, c_t
// and h) to bf16, with f32 sums: the function the TPU computes on its MXU
// (bf16 × bf16 products are exact in f32). Biases, residual and skip sums
// and the head stay f32.
//
// Bound: the operations of a sample, ~2·(L·((3R + C)·G + G/2·(S + R)) +
// S·S + S·out), at the f32 rate for f32 weights or the bf16 tensor-core
// rate for bf16 weights, and the bytes (the weights once, c_up and the
// noise read, the samples written): for 512 samples of 8 rows at the
// default width 0.37 ms (f32) and 0.03 ms (bf16), set by operations
// (`sampler_bound_s` in chip_smoke.py). What sets the time is the serial
// chain of 20 layers a sample: each layer's product waits for the last
// layer's x, and every CTA for the others' h and x; on this chain a warp
// runs its dependent instructions one latency at a time.
//
// Design. A cluster of CTAs (`__cluster_dims__`, co-scheduled by the
// hardware: CS = 8 for bf16 weights, CS_F32 = 16, a non-portable size, for
// f32 weights, whose three TF32 products a k-step want each CTA's share
// halved) runs RB = 8 rows of the batch through all T samples with a
// static trip count; a batch of B takes ceil(B/8) clusters, and a missing
// row runs on zero conditioning and noise and is never written back. The
// rows share every weight tile: each layer's products are real small
// matrix products, the rows the n = 8 of mma.sync (bf16: m16n8k16; f32
// weights: 3xTF32 m16n8k8 on taco::split_tf32), each k-step's product
// added to its running sum in f32. CTA `rank` owns G/(2·CS) gate units and
// S/CS skip and R/CS residual columns of every layer; the wrapper packs its
// columns of a layer as one slice of mma A-fragment tiles (16 bytes a
// lane, conflict-free 16-byte loads) and biases: 8 units an m-tile of the
// gate products, 16 columns an m-tile of the skip|out product, the last
// m-tile zero-padded. Where a product has more m-tiles than its warps, the
// warps take them in turn; where fewer, they split its k-tiles.
//
// - Weights staged ahead: they do not depend on the samples, so a ring of
//   up to MAX_SLOTS layer slices in shared memory (four at the default
//   width) is refilled by a producer warp with cp.async.bulk (TMA) copies
//   completing on an mbarrier, as soon as a layer's chain is done with its
//   slot, across the wrap from the last layer to the next sample's first.
//   A slice too large for shared memory (R 512, G 1024 in bf16) is read by
//   the products from global memory instead (through L2), unstaged.
// - Widths: `supported` takes every width whose k-tiles are whole, whose
//   columns split evenly over the cluster and whose operand buffers fit
//   in shared memory. Each weight type has two instantiations: without
//   GEN for the widths `fixed` admits (the default ones), where every loop
//   over m-tiles, copies and loads is a single pass, and with GEN for the
//   rest. The default widths ran 13-18% slower through the GEN code; the
//   instantiation without it is within 3% of the kernel that took the
//   default widths alone (an H100, in turns).
// - Work taken off the chain: only the x_t rows of the gate product and
//   the skip|out product wait for the last layer. The older taps x_{t-2d},
//   x_{t-d} and c_t are known a layer ahead, so while the chain warps run
//   layer l, the other compute warps ("older" warps) store the next
//   layer's taps (loaded from the ring into registers a layer earlier),
//   take their part of its gate product and add its bias (zpre, two
//   buffers); the chain's gate product is then only R deep. The chain
//   warps split their two products' k-tiles (4 ways for f32 weights) and
//   an owner warp of each m-tile adds the splits in a fixed order; the gate
//   tiles hold a unit's a and b columns 8 rows apart, so one lane holds
//   both and the gate is done in registers.
// - Exchanges: the chain warps copy the CTA's h units, then its new
//   residual columns (16-, 8- or 4-byte copies, as the block's width
//   allows), to every other CTA with st.async stores that
//   complete their bytes on the receiver's mbarrier (one for h, one for x,
//   re-armed after each wait and before this CTA can cause the next send),
//   so no layer waits on a cluster-wide barrier. The skip sums stay with
//   their owner until the last layer, which sends row n's to CTA n; one
//   cluster barrier then makes them and the ring visible, CTA n runs row
//   n's head (f1 and f2 as f32 matvecs from L2) and draws (warp 0: the
//   softmax and the cumulative sum in a fixed order, a max, then 32 lanes
//   summing consecutive runs of exp(l - max) and a shuffle scan over the
//   lanes), writes the sample and sends it to every CTA, and a second
//   cluster barrier ends the sample; every CTA computes the next first
//   conv for all rows.
// - The delay rings live in global memory (2d+1 rows of R values per layer
//   and row, 16.8 MB in f32 for 8 rows): each value is written once, by the
//   CTA that owns its channel, and read (through L2, `__ldcg`) by every CTA
//   at least one sample later, after a cluster barrier; a layer-0 or
//   layer-1 tap of the next sample is loaded only after the last layer's
//   barrier (during the head).
//
// The instruction cache matters here: the layer loop is long and each warp
// runs its part once a layer, so the loops that need no register arrays
// stay rolled and the draw is out of line (the smaller loop ran 5-10%
// faster on an H100). Synchronisation is only the CTAs' __syncthreads()
// and named barriers, the cluster's hardware barrier and mbarriers; every
// CTA of a cluster passes the same barriers: the head kind and dtypes are
// launch arguments, the same for every thread, and no branch around a
// barrier depends on data. Every sum has a fixed order and a row's
// arithmetic does not depend on the other rows, so reruns, and runs at
// other batch sizes, repeat each row bit for bit.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int NC = 256;       // compute threads a CTA (warps 0-7)
constexpr int NW = NC / 32;   // compute warps
constexpr int NT = NC + 32;   // and one producer warp, which issues the copies
// CTAs a cluster: CS for bf16 weights, CS_F32 (a non-portable size) for
// f32 weights, whose three TF32 products a k-step want the m-tiles halved
constexpr int CS = 8;
constexpr int CS_F32 = 16;
constexpr int RB = 8;         // rows of the batch a cluster: mma's n
constexpr int MAX_SLOTS = 4;  // layer slices staged a CTA
constexpr int TILE = 512;     // bytes of one A-fragment tile (32 lanes × 16)
constexpr int PF = 4;         // 16-byte tap loads in flight a thread
constexpr int PC = 8;         // conditioning loads in flight a thread
constexpr int DEPTH = 8;      // the head's weight loads in flight a thread
constexpr int SMEM_MAX = 232448;
constexpr int CHUNK = 16384;  // bytes of one bulk copy
static_assert(RB <= CS && RB <= CS_F32, "CTA n < RB runs row n's head");

enum Head { GAUSSIAN = 0, MOL = 1, CATEGORICAL = 2 };

// Operand order of taco_sampler_launch's pointer and int arrays.
enum Ptr {
  P_C_UP,      // f32 [B, T, C]
  P_NOISE,     // f32 [planes, B, T]
  P_SLICES,    // bytes [cluster size, L, slice]: a CTA's layer operands
  P_FIRST_W,   // f32 [1, R] scalar input, [Q, R] categorical
  P_FIRST_B,   // f32 [R]
  P_F1_W,      // f32 [S, S]
  P_F1_B,      // f32 [S]
  P_F2_W,      // f32 [S, NO] out columns zero-padded to NO
  P_F2_B,      // f32 [NO]
  P_DIL,       // int [L]
  P_RING_OFF,  // int [L] row offset of each layer's ring
  P_RING,      // f32 or bf16 [clusters·RB, ring_rows, R], zero on entry
  P_OUT,       // f32 [B, T]
  N_PTR
};
enum Int {
  I_B, I_T, I_L, I_R, I_G, I_S, I_C, I_RING_ROWS, I_LEGACY,
  I_RESIDUAL_LEGACY, I_HEAD, I_N_OUT, I_NO, I_FIRST_IDX, I_WEIGHT_BF16,
  I_CACHE_BF16, I_SLICE_BYTES, N_INT
};

// u1's clip bounds, the f32 values of the reference's 1e-5 and 1 - 1e-5
constexpr float U_LO = (float)1e-5;
constexpr float U_HI = (float)(1.0 - 1e-5);

struct SmpArgs {
  const float* c_up;
  const float* noise;
  const unsigned char* slices;
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
  int head, n_out, NO, first_idx, cache_bf16, slice_bytes;
  float log_scale_min;
};

__host__ __device__ inline int up(int v, int a) { return (v + a - 1) / a * a; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The least p >= words with p = 4 (mod 8): a row pitch (in 32-bit words)
// at which the 8 rows' B-fragment loads (lanes g, t: row g, word t) hit
// 32 different banks.
__host__ __device__ inline int pitch(int words) {
  return words + (12 - words % 8) % 8;
}

// A CTA's share of the widths, its layer slice and its shared memory.
// Slice (bytes, one per CTA and layer), A-fragment tiles [MT][KT][32
// lanes][16 B] of three products, then the biases as f32:
//   x    the gate product's x_t rows (depth R);
//   old  its x_{t-2d}, x_{t-d} and c_t rows (depth 2R + C16, c zero-padded
//        to C16);
//   so   the skip|out product (depth G/2);
// both gate products' m-tile mt holds the a columns of the CTA's units
// 8mt .. 8mt+7 in rows 0-7 and their b columns in rows 8-15, so one lane
// holds a and b of a unit; the so product's tiles hold sc skip, then rc out
// columns, 16 a tile; then the gate biases (16·MTg, that order) and the
// skip|out biases (16·MTs).
struct Layout {
  int gc, sc, rc, C16, KO, KS, MTg, KTx, KTo, MTs, KTs;
  int tiles_x, tiles_o, tiles_s, slice;
  int XP, OP, HP;  // row pitches (elements) of the x_t, older-tap, h buffers
  int o_x, o_o, o_h, o_xres, o_skips, o_skg, o_part, o_ppart, o_y1, o_y2;
  int o_yh, o_prev, o_fw, o_zpre, o_int, o_bar, o_slots, ns, bytes;
};

__host__ __device__ inline int cluster_size(int wbf) {
  return wbf ? CS : CS_F32;
}

__host__ __device__ inline Layout layout(int L, int R, int G, int S, int C,
                                         int NO, int wbf) {
  Layout y;
  const int cs = cluster_size(wbf);
  y.gc = G / 2 / cs;
  y.sc = S / cs;
  y.rc = R / cs;
  y.C16 = up(C, 16);
  y.KO = 2 * R + y.C16;
  y.KS = wbf ? 16 : 8;
  y.MTg = up(y.gc, 8) / 8;
  y.KTx = R / y.KS;
  y.KTo = y.KO / y.KS;
  y.MTs = up(y.sc + y.rc, 16) / 16;
  y.KTs = G / 2 / y.KS;
  y.tiles_x = TILE * y.MTg * y.KTx;
  y.tiles_o = TILE * y.MTg * y.KTo;
  y.tiles_s = TILE * y.MTs * y.KTs;
  y.slice = y.tiles_x + y.tiles_o + y.tiles_s + 64 * (y.MTg + y.MTs);
  const int es = wbf ? 2 : 4;
  y.XP = wbf ? 2 * pitch(R / 2) : pitch(R);
  y.OP = wbf ? 2 * pitch(y.KO / 2) : pitch(y.KO);
  y.HP = wbf ? 2 * pitch(G / 4) : pitch(G / 2);
  int o = 0;
  y.o_x = o;  // [RB][XP]: this layer's x_t
  o += up(RB * y.XP * es, 16);
  y.o_o = o;  // [RB][OP]: the next layer's older taps and c_t
  o += up(RB * y.OP * es, 16);
  y.o_h = o;  // [RB][HP]
  o += up(RB * y.HP * es, 16);
  y.o_xres = o;  // f32 [RB][rc]: own residual columns
  o += up(RB * y.rc * 4, 16);
  y.o_skips = o;  // f32 [RB][sc]: own skip sums
  o += up(RB * y.sc * 4, 16);
  y.o_skg = o;  // f32 [S]: the skip sums of this CTA's row
  o += up(S * 4, 16);
  // f32: the chain's product partials (128 a work item: at most NW, or
  // one per m-tile), or NT·4 matvec partials
  const int items = imax(NW, imax(y.MTg, y.MTs));
  y.o_part = o;
  o += up(imax(NT * 4, items * 128) * 4, 16);
  y.o_ppart = o;  // f32: the next layer's older-tap partials, alike
  o += imax(NW, y.MTg) * 128 * 4;
  y.o_y1 = o;
  o += up(S * 4, 16);
  y.o_y2 = o;
  o += up(S * 4, 16);
  y.o_yh = o;
  o += up(NO * 4, 16);
  y.o_prev = o;  // RB samples, RB classes, noise [2 samples][2 planes]
  o += 2 * RB * 4 + 16;
  y.o_fw = o;  // f32 [2][R]: the scalar input's first conv (weights, bias)
  o += 2 * R * 4;
  y.o_zpre = o;  // f32 [2][MTg][32 lanes][4]: a gate's bias + older part
  o += 2 * y.MTg * 32 * 16;
  y.o_int = o;  // dilations, ring offsets
  o += up(2 * L * 4, 16);
  y.o_bar = o;  // the weight slots' mbarriers, then the h and x exchanges'
  o += 8 * (MAX_SLOTS + 2);
  o = up(o, 128);
  y.o_slots = o;
  // weight slots; none where a slice does not fit: then the products read
  // their tiles from global memory (through L2)
  y.ns = o < SMEM_MAX ? (SMEM_MAX - o) / y.slice : 0;
  if (y.ns > MAX_SLOTS) y.ns = MAX_SLOTS;
  y.bytes = o + y.ns * y.slice;
  return y;
}

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

// Layer q's slice (q counted over all samples) into slot q % ns, with its
// mbarrier expecting the bytes. Thread 0 only.
__device__ void issue_slice(long long q, int ns, int L, int slice,
                            const unsigned char* src, unsigned char* slots,
                            uint64_t* bars) {
  const int s = (int)(q % ns);
  const uint32_t bar = smem_u32(bars + s);
  const uint32_t dst = smem_u32(slots + (size_t)s * slice);
  const unsigned char* g = src + (size_t)(q % L) * slice;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(slice)
               : "memory");
  for (int o = 0; o < slice; o += CHUNK) {
    const int n = slice - o < CHUNK ? slice - o : CHUNK;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(dst + o),
        "l"(g + o), "r"(n), "r"(bar)
        : "memory");
  }
}

// ------------------------------------------------------------- products

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (not volatile: no side effects, so independent k-steps may interleave)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step of a warp: `load` brings the lane's A fragment `a` (16 × KS)
// and B = rows n of Bm (pitch BP), columns k0 .. k0 + KS, into registers;
// `run` gives their product in d (from zero).
template <typename WT>
struct Step;

template <>
struct Step<bf16> {
  struct Frag {
    uint32_t a[4], b[2];
  };
  __device__ __forceinline__ static void load(Frag& f, const uint4* A,
                                              const bf16* Bm, int BP, int k0,
                                              int g, int t) {
    const uint4 v = *A;
    f.a[0] = v.x;
    f.a[1] = v.y;
    f.a[2] = v.z;
    f.a[3] = v.w;
    const bf16* p = Bm + g * BP + k0 + 2 * t;
    f.b[0] = ld32(p);
    f.b[1] = ld32(p + 8);
  }
  __device__ __forceinline__ static void run(float* d, const Frag& f) {
    d[0] = d[1] = d[2] = d[3] = 0.f;
    mma_bf16(d, f.a, f.b);
  }
};

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
struct Step<float> {
  struct Frag {
    uint4 a;
    float b[2];
  };
  __device__ __forceinline__ static void load(Frag& f, const uint4* A,
                                              const float* Bm, int BP, int k0,
                                              int g, int t) {
    f.a = *A;
    const float* p = Bm + g * BP + k0 + t;
    f.b[0] = p[0];
    f.b[1] = p[4];
  }
  // taco::mma_3xtf32's three products, each from zero so that none waits
  // for another, added in f32: (lo·hi + hi·lo) + hi·hi
  __device__ __forceinline__ static void run(float* d, const Frag& f) {
    uint32_t bh[2], bl[2], ah[4], al[4];
    taco::split_tf32(f.b[0], bh[0], bl[0]);
    taco::split_tf32(f.b[1], bh[1], bl[1]);
    taco::split_tf32(__uint_as_float(f.a.x), ah[0], al[0]);
    taco::split_tf32(__uint_as_float(f.a.y), ah[1], al[1]);
    taco::split_tf32(__uint_as_float(f.a.z), ah[2], al[2]);
    taco::split_tf32(__uint_as_float(f.a.w), ah[3], al[3]);
    float p1[4] = {0.f, 0.f, 0.f, 0.f}, p2[4] = {0.f, 0.f, 0.f, 0.f};
    d[0] = d[1] = d[2] = d[3] = 0.f;
    mma_tf32(p1, al, bh);
    mma_tf32(p2, ah, bl);
    mma_tf32(d, ah, bh);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += p1[e] + p2[e];
  }
};

// acc += the k-steps kt = k0, k0 + stride, ... < KT of m-tile A (its
// lane's fragments, 32 apart a k-tile), each added in f32 in step order.
// Four steps at a time: their loads, then their products, then the adds, so
// the shared-memory and tensor-core latencies of four steps overlap.
template <typename WT>
__device__ __forceinline__ void k_steps(float* acc, const uint4* A, int k0,
                                        int KT, int stride, int KS,
                                        const WT* Bm, int BP, int g, int t) {
  using St = Step<WT>;
  int kt = k0;
  for (; kt + 3 * stride < KT; kt += 4 * stride) {
    typename St::Frag f[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      St::load(f[u], A + (kt + u * stride) * 32, Bm, BP,
               (kt + u * stride) * KS, g, t);
    float d[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) St::run(d[u], f[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += d[u][e];
  }
  for (; kt < KT; kt += stride) {
    typename St::Frag f;
    St::load(f, A + kt * 32, Bm, BP, kt * KS, g, t);
    float d[4];
    St::run(d, f);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += d[e];
  }
}

// The k-splits of each of MT m-tiles that nw warps share: several where
// there are more warps than m-tiles, else one (the warps take m-tiles in
// turn).
__device__ __forceinline__ int splits_of(int nw, int MT) {
  return nw >= MT ? nw / MT : 1;
}

// part[(j·32 + lane)·4 + e] = fragment (lane, e) of work item j = s·MT +
// mt: the sum over k-tiles s, s + ns, ... of A[mt] · B (ns = splits_of(nw,
// MT)), items i, i + nw, ... for warp i of a group of nw (warps past the
// items idle; without GEN no warp has two). Fragment e of lane (g, t) is
// row g (e < 2) or g + 8, batch row 2t + e % 2. A's tiles lie in shared or
// in global memory.
template <typename WT, bool GEN>
__device__ __forceinline__ void product(const unsigned char* tiles, int MT,
                                        int KT, int KS, const WT* Bm, int BP,
                                        float* part, int i, int nw) {
  const int lane = threadIdx.x & 31, ns = splits_of(nw, MT);
  const int g = lane >> 2, t = lane & 3;
  for (int j = i; j < MT * ns; j += nw) {
    const int mt = j % MT, sp = j / MT;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const uint4* A = reinterpret_cast<const uint4*>(tiles) +
                     (size_t)mt * KT * 32 + lane;
    k_steps<WT>(acc, A, sp, KT, ns, KS, Bm, BP, g, t);
    reinterpret_cast<float4*>(part)[j * 32 + lane] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    if (!GEN) break;
  }
}

// v[e] += every split's fragment (lane, e) of m-tile mt, in split order.
__device__ __forceinline__ void add_splits(float* v, const float* part,
                                           int MT, int nsplit, int mt,
                                           int lane) {
  for (int s = 0; s < nsplit; ++s) {
    const float4 p = reinterpret_cast<const float4*>(part)[(s * MT + mt) * 32 +
                                                            lane];
    v[0] += p.x;
    v[1] += p.y;
    v[2] += p.z;
    v[3] += p.w;
  }
}

// ------------------------------------------------- operands in their type

template <typename WT>
__device__ __forceinline__ void put(WT* p, float v);
template <>
__device__ __forceinline__ void put<float>(float* p, float v) {
  *p = v;
}
template <>
__device__ __forceinline__ void put<bf16>(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of ring (8 bf16 or 4 f32 values) stored as product inputs.
template <typename WT>
__device__ __forceinline__ void put16(WT* p, const uint4& raw, int cbf);
template <>
__device__ __forceinline__ void put16<float>(float* p, const uint4& raw,
                                             int cbf) {
  if (!cbf) {
    *reinterpret_cast<uint4*>(p) = raw;
    return;
  }
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(p)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(p)[1] = make_float4(c.x, c.y, d.x, d.y);
}
template <>
__device__ __forceinline__ void put16<bf16>(bf16* p, const uint4& raw,
                                            int cbf) {
  if (cbf) {
    *reinterpret_cast<uint4*>(p) = raw;
    return;
  }
  const float* f = reinterpret_cast<const float*>(&raw);
  __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void ring_put(void* ring, size_t i, float v,
                                         int bf) {
  if (bf)
    ((bf16*)ring)[i] = __float2bfloat16(v);
  else
    ((float*)ring)[i] = v;
}

// The operands of a layer that do not wait for the layer before: the older
// taps of layer l1 at sample t1 for the cluster's rows (16-byte ring
// vectors, vector i: row i / (2·R/V), tap x_{t-2d} then x_{t-d}, channels
// V apart), and at a sample's first layer c_t1 and the noise of this CTA's
// row. Thread `me` of a group of `nthr` loads its first PF vectors and PC
// conditioning values into registers ahead (pf_load) and stores them
// (pf_store), which loads and stores the rest, if any, itself.
struct Prefetch {
  uint4 v[PF];
  float c[PC];
  float nz;
};

// Vector i's place in the older-tap buffer (pitch KP): row i / (2·per),
// tap x_{t-2d} then x_{t-d} of R channels, V channels a vector.
__device__ __forceinline__ int tap_dst(int i, int per, int V, int KP, int R) {
  const int n = i / (2 * per), rem = i - n * 2 * per, tp = rem / per;
  return n * KP + tp * R + (rem - tp * per) * V;
}

// The ring rows of layer l1's older taps at sample t1.
struct Taps {
  const char* ring;
  size_t base;  // element of row 0, ring row 0 of layer l1
  int s2, s1, per, V, es;
  __device__ __forceinline__ Taps(const SmpArgs& a, const int* dil,
                                  const int* off, int cb, int t1, int l1) {
    const int d = dil[l1], w = 2 * d + 1;
    s2 = (t1 - 2 * d) % w;
    s1 = (t1 - d) % w;
    if (s2 < 0) s2 += w;
    if (s1 < 0) s1 += w;
    V = a.cache_bf16 ? 8 : 4;
    es = 16 / V;
    per = a.R / V;
    ring = (const char*)a.ring;
    base = (size_t)cb * RB * a.ring_rows + off[l1];
  }
  __device__ __forceinline__ int count() const { return RB * 2 * per; }
  // vector i from the ring; its place in the older-tap buffer (pitch KP)
  __device__ __forceinline__ uint4 load(const SmpArgs& a, int i) const {
    const int n = i / (2 * per), rem = i - n * 2 * per, tp = rem / per;
    const size_t e = (base + (size_t)n * a.ring_rows + (tp ? s1 : s2)) * a.R +
                     (rem - tp * per) * V;
    return __ldcg(reinterpret_cast<const uint4*>(ring + e * es));
  }
  __device__ __forceinline__ int dst(int i, int KP, int R) const {
    return tap_dst(i, per, V, KP, R);
  }
};

__device__ __forceinline__ float c_load(const SmpArgs& a, int cb, int t1,
                                        int i) {
  const int n = i / a.C, ch = i - n * a.C, b = cb * RB + n;
  return b < a.B ? __ldg(a.c_up + ((size_t)b * a.T + t1) * a.C + ch) : 0.f;
}

__device__ __forceinline__ void pf_load(Prefetch& pf, const SmpArgs& a,
                                        const int* dil, const int* off,
                                        int cb, int rank, int t1, int l1,
                                        int me, int nthr) {
  const Taps tp(a, dil, off, cb, t1, l1);
#pragma unroll
  for (int j = 0; j < PF; ++j) {
    const int i = me + j * nthr;
    if (i < tp.count()) pf.v[j] = tp.load(a, i);
  }
  if (l1 == 0) {
#pragma unroll
    for (int j = 0; j < PC; ++j) {
      const int i = me + j * nthr;
      if (i < RB * a.C) pf.c[j] = c_load(a, cb, t1, i);
    }
    const int b = cb * RB + rank, planes = a.head == MOL ? 2 : 1;
    if (me < planes)
      pf.nz = rank < RB && b < a.B
                  ? __ldg(a.noise + ((size_t)me * a.B + b) * a.T + t1)
                  : 0.f;
  }
}

// ... stored into the older-tap buffer (`dst`, rows [x_{t-2d} | x_{t-d} |
// c_t1]), the noise into nz[t1 & 1].
template <typename WT, bool GEN>
__device__ __forceinline__ void pf_store(const Prefetch& pf, const SmpArgs& a,
                                         const int* dil, const int* off,
                                         int cb, int KP, WT* dst, float* nz,
                                         int t1, int l1, int me, int nthr) {
  const int R = a.R, V = a.cache_bf16 ? 8 : 4, per = R / V;
#pragma unroll
  for (int j = 0; j < PF; ++j) {
    const int i = me + j * nthr;
    if (i < RB * 2 * per)
      put16<WT>(dst + tap_dst(i, per, V, KP, R), pf.v[j], a.cache_bf16);
  }
  if (GEN && PF * nthr < RB * 2 * per) {
    // (wide rings: the vectors past the registers' PF a thread)
    const Taps tp(a, dil, off, cb, t1, l1);
#pragma unroll 1
    for (int i = me + PF * nthr; i < tp.count(); i += nthr)
      put16<WT>(dst + tp.dst(i, KP, R), tp.load(a, i), a.cache_bf16);
  }
  if (l1 == 0) {
#pragma unroll
    for (int j = 0; j < PC; ++j) {
      const int i = me + j * nthr;
      if (i < RB * a.C) {
        const int n = i / a.C, ch = i - n * a.C;
        put<WT>(dst + n * KP + 2 * R + ch, pf.c[j]);
      }
    }
#pragma unroll 1
    for (int i = me + PC * nthr; GEN && i < RB * a.C; i += nthr) {
      const int n = i / a.C, ch = i - n * a.C;
      put<WT>(dst + n * KP + 2 * R + ch, c_load(a, cb, t1, i));
    }
    const int planes = a.head == MOL ? 2 : 1;
    if (me < planes) nz[(t1 & 1) * 2 + me] = pf.nz;
  }
}

// The first conv of sample t for every row (from the last samples or
// classes): layer 0's x_t into `dst` (pitch KP), own residual columns, and
// the own channels of layer 0's ring slot. fw: the scalar input's first
// conv weights [R] and the bias [R]. Compute threads.
template <typename WT>
__device__ __forceinline__ void first_conv(const SmpArgs& a, const float* prevf,
                                           const int* previ, const float* fw,
                                           WT* dst, float* xres,
                                           const int* dil, const int* off,
                                           int KP, int rc, int rank, int cb,
                                           int t) {
  const int R = a.R, w0 = 2 * dil[0] + 1;
  for (int i = threadIdx.x; i < RB * R; i += NC) {
    const int n = i / R, ch = i - n * R;
    float x0;
    if (a.head == CATEGORICAL) {
      const int k = previ[n];
      x0 = (k >= 0 ? __ldg(a.first_w + (size_t)k * R + ch) : 0.f) + fw[R + ch];
    } else {
      x0 = prevf[n] * fw[ch] + fw[R + ch];
    }
    put<WT>(dst + n * KP + ch, x0);
    if (ch / rc == rank) {
      xres[n * rc + ch - rank * rc] = x0;
      ring_put(a.ring,
               ((size_t)(cb * RB + n) * a.ring_rows + off[0] + t % w0) * R +
                   ch,
               x0, a.cache_bf16);
    }
  }
}

// This CTA's block of every row of `buf` (`bytes` bytes, BYTES where it is
// known at compile time, from byte `col` of each row, rows `pitch` bytes
// apart, a multiple of 16) into the same place of every other CTA of the
// cluster: U-byte st.async copies (U divides bytes and col), each
// completing its bytes on that CTA's mbarrier `bar` (the same offset in
// every CTA), spread over `nthr` threads (`me`).
template <int BYTES, int U, int CSX>
__device__ __forceinline__ void send_rows(unsigned char* buf, int pitch,
                                          int col, int bytes, int rank,
                                          uint64_t* bar, int me, int nthr) {
  const int PER = (BYTES ? BYTES : bytes) / U, ITEMS = RB * PER * (CSX - 1);
  const uint32_t base = smem_u32(buf), lbar = smem_u32(bar);
#pragma unroll 1
  for (int i = me; i < ITEMS; i += nthr) {
    const int r0 = i / (RB * PER), rem = i % (RB * PER);
    const int o = (rem / PER) * pitch + col + (rem % PER) * U;
    const int r = r0 < rank ? r0 : r0 + 1;
    uint32_t ra, rb;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(ra)
                 : "r"(base + o), "r"(r));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(rb)
                 : "r"(lbar), "r"(r));
    if (U == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(buf + o);
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
          "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(ra),
          "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(rb)
          : "memory");
    } else if (U == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(buf + o);
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
          "[%0], {%1, %2}, [%3];" ::"r"(ra),
          "r"(v.x), "r"(v.y), "r"(rb)
          : "memory");
    } else {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(buf + o);
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
          "[%0], %1, [%2];" ::"r"(ra),
          "r"(v), "r"(rb)
          : "memory");
    }
  }
}

// (out of line: only widths other than the default take it)
template <int CSX>
__device__ __noinline__ void send_rows_any(unsigned char* buf, int pitch,
                                           int col, int bytes, int rank,
                                           uint64_t* bar, int me, int nthr) {
  if (bytes % 16 == 0)
    send_rows<0, 16, CSX>(buf, pitch, col, bytes, rank, bar, me, nthr);
  else if (bytes % 8 == 0)
    send_rows<0, 8, CSX>(buf, pitch, col, bytes, rank, bar, me, nthr);
  else
    send_rows<0, 4, CSX>(buf, pitch, col, bytes, rank, bar, me, nthr);
}

// Without GEN the blocks are 32 bytes a row (8 f32 or 16 bf16 values).
template <int CSX, bool GEN>
__device__ __forceinline__ void send_block(unsigned char* buf, int pitch,
                                           int col, int bytes, int rank,
                                           uint64_t* bar, int me, int nthr) {
  if (!GEN)
    send_rows<32, 16, CSX>(buf, pitch, col, 32, rank, bar, me, nthr);
  else
    send_rows_any<CSX>(buf, pitch, col, bytes, rank, bar, me, nthr);
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Inverse-CDF pick over n logits, by the 32 lanes of one warp, all of which
// get the result: the first index whose cumulative exp(l - max) exceeds
// u·total, else n - 1. The order of every sum is fixed by n alone.
// (out of line: once a sample, and it keeps the layer loop's code small,
// which the instruction cache rewards)
__device__ __noinline__ int warp_inverse_cdf(const float* logits, int n,
                                             float u) {
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

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// out = bias + x · w for w [K, N] f32 in global memory, in blocks of the
// columns that one matvec pass covers (4 a thread; without GEN, one).
template <bool GEN>
__device__ __forceinline__ void head_matvec(const float* w, const float* b,
                                            const float* x, int K, int N,
                                            float* out, float* part) {
  if (!GEN) {
    taco::matvec<DEPTH>(w, b, x, K, N, out, part);
    return;
  }
  for (int c0 = 0; c0 < N; c0 += 4 * NT)
    taco::matvec<DEPTH>(w + c0, b + c0, x, K, min(4 * NT, N - c0), out + c0,
                        part, N);
}

// The chain's warps: its two products' m-tiles times a k-split (4 for f32
// weights, whose k-steps are three TF32 products each), at most half the
// compute warps, so that the older-tap warps are never fewer.
__host__ __device__ inline int chain_warps(const Layout& y, int wbf) {
  const int w = imax(y.MTg, y.MTs) * (wbf ? 1 : 4);
  return w < NW / 2 ? w : NW / 2;
}

// Named barriers: 1 the chain warps, 2 the chain warps and the producer, 3
// the older-tap warps (0 is __syncthreads).
constexpr int BAR_CHAIN = 1, BAR_FREE = 2, BAR_OLD = 3;

// GEN: any width `supported` takes; without it only those `fixed` admits
// (the default widths among them), where every loop over m-tiles, copies
// and loads is one pass: that smaller code runs faster.
template <typename WT, int CSX, bool GEN>
__global__ void __cluster_dims__(CSX, 1, 1) __launch_bounds__(NT, 1)
    sampler_kernel(const SmpArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cb = blockIdx.x / CSX, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const bool compute = tid < NC;
  const int R = a.R, S = a.S, T = a.T, L = a.L;
  const Layout y = layout(L, R, a.G, S, a.C, a.NO, sizeof(WT) == 2);
  const int es = sizeof(WT);
  // warp roles: the chain (the products that wait for the last layer),
  // the older-tap part of the next layer, the producer (warp NW)
  const int NCH = chain_warps(y, sizeof(WT) == 2), NP = NW - NCH;
  const bool chain = warp < NCH, older = compute && !chain;
  // one skip|out m-tile a chain warp: its new x waits in registers for the
  // ring until after the send
  const bool defer = !GEN || y.MTs <= NCH;
  WT* xb = (WT*)(smem + y.o_x);
  WT* ob = (WT*)(smem + y.o_o);
  WT* hb = (WT*)(smem + y.o_h);
  float* xres = (float*)(smem + y.o_xres);
  float* skips = (float*)(smem + y.o_skips);
  float* skg = (float*)(smem + y.o_skg);
  float* part = (float*)(smem + y.o_part);
  float* ppart = (float*)(smem + y.o_ppart);
  float* y1 = (float*)(smem + y.o_y1);
  float* y2 = (float*)(smem + y.o_y2);
  float* yh = (float*)(smem + y.o_yh);
  float* prevf = (float*)(smem + y.o_prev);
  int* previ = (int*)(prevf + RB);
  float* nz = prevf + 2 * RB;
  float* fw = (float*)(smem + y.o_fw);
  float4* zpre = (float4*)(smem + y.o_zpre);  // [2][MTg][32]
  int* dil = (int*)(smem + y.o_int);
  int* off = dil + L;
  uint64_t* bars = (uint64_t*)(smem + y.o_bar);
  uint64_t* hbar = bars + MAX_SLOTS;  // h of the layer, from the others
  uint64_t* xbar = hbar + 1;          // x of the next layer, alike
  unsigned char* slots = smem + y.o_slots;
  const int ns = y.ns;
  const long long total = (long long)T * L;
  const unsigned char* src = a.slices + (size_t)rank * L * y.slice;
  // layer q's slice: its slot, or with no slots (a slice too large for
  // shared memory) its place in global memory
  auto slice_at = [&](long long q, int slot) -> const unsigned char* {
    return !GEN || ns ? slots + (size_t)slot * y.slice
                      : src + (size_t)(q % L) * y.slice;
  };
  const float scale = sqrtf(0.5f);
  const uint32_t expect_h = (CSX - 1) * RB * y.gc * es;
  const uint32_t expect_x = (CSX - 1) * RB * y.rc * es;
  if (T < 1) return;  // the same for every CTA

  // zero the operand buffers, padding included
  for (int i = tid; i < (y.o_part - y.o_x) / 4; i += NT)
    ((float*)(smem + y.o_x))[i] = 0.f;
  for (int i = tid; i < L; i += NT) {
    dil[i] = a.dil[i];
    off[i] = a.ring_off[i];
  }
  for (int i = tid; i < R; i += NT) {
    fw[i] = a.head == CATEGORICAL ? 0.f : a.first_w[i];
    fw[R + i] = a.first_b[i];
  }
  if (tid < RB) {
    prevf[tid] = 0.f;
    previ[tid] = a.first_idx;
  }
  if (tid == NC) {
    for (int s = 0; s < ns + 2; ++s)
      mbar_init(smem_u32(s < ns ? bars + s : bars + MAX_SLOTS + s - ns), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(hbar, expect_h);
    mbar_expect(xbar, expect_x);
  }
  __syncthreads();
  if (tid == NC)
    for (long long q = 0; q < ns && q < total; ++q)
      issue_slice(q, ns, L, y.slice, src, slots, bars);
  Prefetch pf;
  cluster.sync();  // every CTA started, its barriers set, before any send

  int t = 0, l = 0, slot = 0;
  uint32_t parity = 0, hpar = 0, xpar = 0;
  for (long long q = 0; q < total; ++q) {
    const int slot1 = slot + 1 < ns ? slot + 1 : 0;
    const uint32_t parity1 = slot + 1 < ns ? parity : parity ^ 1u;
    const unsigned char* sl = slice_at(q, slot);
    const int zb = (int)(q & 1) * y.MTg * 32;  // this layer's zpre
    if (l == 0) {
      // a sample's start (after the last one's cluster barriers, so every
      // ring value of the samples before is visible): x_t of layer 0, its
      // older taps and c_t, the older part of its gate product with every
      // compute warp, and the older-tap warps' loads of layer 1
      if (compute) {
        first_conv<WT>(a, prevf, previ, fw, xb, xres, dil, off, y.XP, y.rc,
                       rank, cb, t);
        // (sample 0's; the others' were loaded during the last head)
        if (t == 0) pf_load(pf, a, dil, off, cb, rank, t, 0, tid, NC);
        pf_store<WT, GEN>(pf, a, dil, off, cb, y.OP, ob, nz, t, 0, tid, NC);
      }
      __syncthreads();
      if (compute) {
        if (!GEN || ns) mbar_wait(smem_u32(bars + slot), parity);
        product<WT, GEN>(sl + y.tiles_x, y.MTg, y.KTo, y.KS, ob, y.OP, ppart, warp,
                    NW);
      }
      __syncthreads();
      const float* bg = (const float*)(sl + y.tiles_x + y.tiles_o +
                                       y.tiles_s);
      for (int mt = warp; compute && mt < y.MTg; mt += NW) {
        float z[4] = {bg[16 * mt + g8], bg[16 * mt + g8],
                      bg[16 * mt + g8 + 8], bg[16 * mt + g8 + 8]};
        add_splits(z, ppart, y.MTg, splits_of(NW, y.MTg), mt, lane);
        zpre[zb + mt * 32 + lane] = make_float4(z[0], z[1], z[2], z[3]);
        if (!GEN) break;
      }
      if (older && L > 1)
        pf_load(pf, a, dil, off, cb, rank, t, 1, tid - NCH * 32, NP * 32);
      __syncthreads();
    }
    const unsigned char* sl1 = slice_at(q + 1, slot1);
    if (chain) {
      // (A, B) the x_t rows of the gate product (the older taps' part and
      // the bias are in zpre), then in the owner warp of each m-tile its
      // units' gate, every row
      // (the first m-tile's older part read ahead of the product)
      const float4 zp0 = warp < y.MTg ? zpre[zb + warp * 32 + lane]
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      product<WT, GEN>(sl, y.MTg, y.KTx, y.KS, xb, y.XP, part, warp, NCH);
      bar_sync(BAR_CHAIN, NCH * 32);
      for (int mt = warp; mt < y.MTg; mt += NCH) {
        const float4 zp = mt == warp ? zp0 : zpre[zb + mt * 32 + lane];
        float z[4] = {zp.x, zp.y, zp.z, zp.w};
        add_splits(z, part, y.MTg, splits_of(NCH, y.MTg), mt, lane);
        const int u = 8 * mt + g8;  // (units past gc are padding)
        if (!GEN || u < y.gc) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            put<WT>(hb + (2 * t4 + e) * y.HP + rank * y.gc + u,
                    tanhf(z[e]) * taco::sigmoidf(z[2 + e]));
        }
        if (!GEN) break;
      }
      bar_sync(BAR_CHAIN, NCH * 32);
      // the CTA's units of h to the others, by the chain
      send_block<CSX, GEN>((unsigned char*)hb, y.HP * es, rank * y.gc * es,
                      y.gc * es, rank, hbar, tid, NCH * 32);
      mbar_wait(smem_u32(hbar), hpar);
      if (tid == 0) mbar_expect(hbar, expect_h);  // the next layer's h
      bar_sync(BAR_CHAIN, NCH * 32);  // set before this CTA's x starts it
      // (D) own output columns [skip (sc) | out (rc)], every row: the owner
      // warp of each m-tile adds the skip sums and the new residual x
      const float* bs = (const float*)(sl + y.tiles_x + y.tiles_o +
                                       y.tiles_s) + 16 * y.MTg;
      const float bs0 = warp < y.MTs ? bs[16 * warp + g8] : 0.f;
      const float bs1 = warp < y.MTs ? bs[16 * warp + g8 + 8] : 0.f;
      product<WT, GEN>(sl + y.tiles_x + y.tiles_o, y.MTs, y.KTs, y.KS, hb, y.HP,
                  part, warp, NCH);
      bar_sync(BAR_CHAIN, NCH * 32);
      // the ring's own channels of the new x (read a sample later at the
      // earliest, after a cluster barrier): in registers until after the
      // send, or (several m-tiles a warp) stored at once; row 0's ring row
      auto ring_row = [&]() -> size_t {
        return (size_t)cb * RB * a.ring_rows + off[l + 1] +
               t % (2 * dil[l + 1] + 1);
      };
      float xv[4] = {0.f, 0.f, 0.f, 0.f};
      for (int mt = warp; mt < y.MTs; mt += NCH) {
        float v[4];
        v[0] = v[1] = mt == warp ? bs0 : bs[16 * mt + g8];
        v[2] = v[3] = mt == warp ? bs1 : bs[16 * mt + g8 + 8];
        add_splits(v, part, y.MTs, splits_of(NCH, y.MTs), mt, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 16 * mt + g8 + 8 * (e >> 1), n = 2 * t4 + (e & 1);
          const int j = col - y.sc;  // (columns past sc + rc are padding)
          if (col < y.sc) {
            float& sk = skips[n * y.sc + col];
            sk = l == 0 ? v[e] : (a.legacy ? (sk + v[e]) * scale : sk + v[e]);
            if (l == L - 1)
              cluster.map_shared_rank(skg, n)[rank * y.sc + col] = sk;
          } else if (!GEN || j < y.rc) {
            xv[e] = xres[n * y.rc + j] + v[e];
            if (a.residual_legacy) xv[e] *= scale;
            xres[n * y.rc + j] = xv[e];
            if (l + 1 < L) {
              put<WT>(xb + n * y.XP + rank * y.rc + j, xv[e]);
              if (!defer)
                ring_put(a.ring, (ring_row() + (size_t)n * a.ring_rows) * R +
                                     rank * y.rc + j,
                         xv[e], a.cache_bf16);
            }
          }
        }
        if (!GEN) break;
      }
      if (l + 1 < L) {
        // the CTA's residual columns of x to the others
        bar_sync(BAR_CHAIN, NCH * 32);
        send_block<CSX, GEN>((unsigned char*)xb, y.XP * es, rank * y.rc * es,
                        y.rc * es, rank, xbar, tid, NCH * 32);
      }
      bar_sync(BAR_FREE, NCH * 32 + 32);  // the slot is read no more
      if (l + 1 < L) {
        if (defer && warp < y.MTs) {
          const size_t row0 = ring_row();
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = 2 * t4 + (e & 1);
            const int j = 16 * warp + g8 + 8 * (e >> 1) - y.sc;
            if (j >= 0 && j < y.rc)
              ring_put(a.ring, (row0 + (size_t)n * a.ring_rows) * R +
                                   rank * y.rc + j,
                       xv[e], a.cache_bf16);
          }
        }
        mbar_wait(smem_u32(xbar), xpar);
        if (tid == 0) mbar_expect(xbar, expect_x);  // the next layer's x
      }
    } else if (older) {
      // the next layer's older-tap part with its bias, meanwhile
      if (l + 1 < L) {
        const int me = tid - NCH * 32;
        pf_store<WT, GEN>(pf, a, dil, off, cb, y.OP, ob, nz, t, l + 1, me,
                     NP * 32);
        bar_sync(BAR_OLD, NP * 32);
        if (!GEN || ns) mbar_wait(smem_u32(bars + slot1), parity1);
        product<WT, GEN>(sl1 + y.tiles_x, y.MTg, y.KTo, y.KS, ob, y.OP, ppart,
                    warp - NCH, NP);
        if (l + 2 < L) pf_load(pf, a, dil, off, cb, rank, t, l + 2, me, NP * 32);
        bar_sync(BAR_OLD, NP * 32);
        const float* bg = (const float*)(sl1 + y.tiles_x + y.tiles_o +
                                         y.tiles_s);
        for (int mt = warp - NCH; mt < y.MTg; mt += NP) {
          float z[4] = {bg[16 * mt + g8], bg[16 * mt + g8],
                        bg[16 * mt + g8 + 8], bg[16 * mt + g8 + 8]};
          add_splits(z, ppart, y.MTg, splits_of(NP, y.MTg), mt, lane);
          zpre[(y.MTg * 32 - zb) + mt * 32 + lane] =
              make_float4(z[0], z[1], z[2], z[3]);
          if (!GEN) break;
        }
      }
    } else {
      // the producer: once the chain is done with the slot, refill it with
      // layer q + ns
      bar_sync(BAR_FREE, NCH * 32 + 32);
      if (lane == 0 && ns && q + ns < total) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        issue_slice(q + ns, ns, L, y.slice, src, slots, bars);
      }
    }
    hpar ^= 1u;
    if (l + 1 < L) xpar ^= 1u;
    slot = slot1;
    parity = parity1;
    __syncthreads();  // the layer's end: x, zpre, the older taps in place
    if (l + 1 < L) {
      ++l;
      continue;
    }
    cluster.sync();  // every row's skip sums with its CTA, and the ring
    // the next sample's layer-0 taps, c_t and noise fly during the head
    if (compute && t + 1 < T)
      pf_load(pf, a, dil, off, cb, rank, t + 1, 0, tid, NC);
    // ---- the head of row `rank`, its draw
    for (int i = tid; i < S; i += NT) y1[i] = fmaxf(skg[i], 0.f);
    __syncthreads();
    head_matvec<GEN>(a.f1_w, a.f1_b, y1, S, S, y2, part);
    for (int i = tid; i < S; i += NT) y2[i] = fmaxf(y2[i], 0.f);
    __syncthreads();
    head_matvec<GEN>(a.f2_w, a.f2_b, y2, S, a.NO, yh, part);
    if (tid < 32) {
      const float u0 = nz[(t & 1) * 2];
      float smp;
      int k = 0;
      if (a.head == GAUSSIAN) {
        const float log_s = fmaxf(yh[1], a.log_scale_min);
        smp = fminf(fmaxf(yh[0] + expf(log_s) * u0, -1.f), 1.f);
      } else if (a.head == MOL) {
        const int nr = a.n_out / 3;
        k = warp_inverse_cdf(yh, nr, u0);
        const float log_s = fmaxf(yh[2 * nr + k], a.log_scale_min);
        const float u1 = fminf(fmaxf(nz[(t & 1) * 2 + 1], U_LO), U_HI);
        smp = fminf(fmaxf(yh[nr + k] + expf(log_s) *
                                           (logf(u1) - logf(1.f - u1)),
                          -1.f),
                    1.f);
      } else {
        k = warp_inverse_cdf(yh, a.n_out, u0);
        smp = (float)k;
      }
      if (rank < RB) {
        for (int r = tid; r < CSX; r += 32) {
          *cluster.map_shared_rank(prevf + rank, r) = smp;
          *cluster.map_shared_rank(previ + rank, r) = k;
        }
        const int b = cb * RB + rank;
        if (tid == 0 && b < a.B) a.out[(size_t)b * T + t] = smp;
      }
    }
    cluster.sync();  // every row's sample everywhere
    l = 0;
    ++t;
  }
  cluster.sync();  // no CTA leaves while another may still address it
}

}  // namespace

extern "C" int taco_sampler_cluster_size(int weight_bf16) {
  return cluster_size(weight_bf16);
}
extern "C" int taco_sampler_rows_per_cluster() { return RB; }
extern "C" int taco_sampler_n_ptr() { return N_PTR; }
extern "C" int taco_sampler_n_int() { return N_INT; }

// The CTA's share for the widths: out[0] slice bytes, out[1] weight slots
// (0: the products read the weights from global memory), out[2] shared
// memory bytes.
extern "C" void taco_sampler_layout(int L, int R, int G, int S, int C, int NO,
                                    int weight_bf16, int* out) {
  const Layout y = layout(L, R, G, S, C, NO, weight_bf16);
  out[0] = y.slice;
  out[1] = y.ns;
  out[2] = y.bytes;
}

// The widths and heads the kernel takes: whole k-tiles in every product
// (R and G/2 multiples of 16), the cluster's even split of the gate units
// and of the skip and residual columns, a CTA's h units and residual
// columns a whole number of 4-byte words a row (its st.async copies), head
// widths a whole number of the matvec's 4-column loads, and the operand
// buffers in shared memory (the weight slots are not needed).
static bool supported(const SmpArgs& a, int wbf) {
  const int cs = cluster_size(wbf), es = wbf ? 2 : 4;
  if (a.R < 16 || a.R % 16 || a.G < 32 || (a.G / 2) % 16 ||
      a.G % (2 * cs) || a.S < cs || a.S % cs || a.R % cs || a.C < 0 ||
      a.L < 1 || a.B < 1 || a.T < 0)
    return false;
  const Layout y = layout(a.L, a.R, a.G, a.S, a.C, a.NO, wbf);
  return (y.gc * es) % 4 == 0 && (y.rc * es) % 4 == 0 && a.S % 4 == 0 &&
         a.NO % 4 == 0 && a.n_out <= a.NO && a.n_out >= 2 &&
         a.head >= GAUSSIAN && a.head <= CATEGORICAL &&
         (a.head != MOL || a.n_out % 3 == 0) && y.bytes <= SMEM_MAX;
}

// 1 where the kernel takes these widths and this head, else 0 (the
// wrapper's check, before it launches).
extern "C" int taco_sampler_supported(int L, int R, int G, int S, int C,
                                      int NO, int n_out, int head,
                                      int weight_bf16) {
  SmpArgs a = {};
  a.B = 1;
  a.T = 1;
  a.L = L;
  a.R = R;
  a.G = G;
  a.S = S;
  a.C = C;
  a.NO = NO;
  a.n_out = n_out;
  a.head = head;
  return supported(a, weight_bf16) ? 1 : 0;
}

// The widths the kernel without GEN takes (within `supported`): every
// product's m-tiles one a warp (chain, older-tap and all compute warps)
// and none padded, h units and residual columns 32 bytes a row, the older
// taps and c_t within the registers' prefetch, weight slots, the head in
// one matvec pass.
static bool fixed(const SmpArgs& a, int wbf) {
  const Layout y = layout(a.L, a.R, a.G, a.S, a.C, a.NO, wbf);
  const int es = wbf ? 2 : 4, nch = chain_warps(y, wbf), V = a.cache_bf16 ? 8 : 4;
  return y.MTg <= nch && y.MTs <= nch && y.MTg <= NW - nch &&
         y.gc * es == 32 && y.rc * es == 32 && (y.sc + y.rc) % 16 == 0 &&
         y.ns >= 1 &&
         RB * 2 * (a.R / V) <= PF * (NW - nch) * 32 && RB * a.C <= PC * NC &&
         a.S <= 4 * NT && a.NO <= 4 * NT;
}

template <typename WT, int CSX, bool GEN>
static int launch(const SmpArgs& a, const Layout& y, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sampler_kernel<WT, CSX, GEN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, y.bytes);
  if (err == cudaSuccess && CSX > 8)
    err = cudaFuncSetAttribute(sampler_kernel<WT, CSX, GEN>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return (int)err;
  const int clusters = (a.B + RB - 1) / RB;
  sampler_kernel<WT, CSX, GEN><<<clusters * CSX, NT, y.bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename WT, int CSX>
static int launch(const SmpArgs& a, cudaStream_t stream) {
  const int wbf = sizeof(WT) == 2;
  const Layout y = layout(a.L, a.R, a.G, a.S, a.C, a.NO, wbf);
  if (y.slice != a.slice_bytes) return (int)cudaErrorInvalidValue;
  return fixed(a, wbf) ? launch<WT, CSX, false>(a, y, stream)
                       : launch<WT, CSX, true>(a, y, stream);
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
  a.slices = (const unsigned char*)ptrs[P_SLICES];
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
  a.slice_bytes = ints[I_SLICE_BYTES];
  a.log_scale_min = log_scale_min;
  const int weight_bf16 = ints[I_WEIGHT_BF16];
  if (!supported(a, weight_bf16)) return (int)cudaErrorInvalidValue;
  return weight_bf16 ? launch<bf16, CS>(a, (cudaStream_t)stream)
                     : launch<float, CS_F32>(a, (cudaStream_t)stream);
}
