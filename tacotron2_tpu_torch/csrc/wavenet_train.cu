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
// What bounds it. At the r5 shapes (N 128,000, R 128, G 256, S 128, cin
// 80, 20 layers) the forward's products are ~776 GFLOP (0.78 ms at bf16's
// 989 TFLOP/s; 4.7 ms as 3xTF32 at 495 / 3), the backward's twice that;
// counted once, the bytes (~2 GB forward) come under that. But a
// layer-by-layer design moves more than the bound counts: every layer
// reads and writes its f32 block input, output and skip sum and writes its
// saved activations (~380 MB a bf16 forward layer, ~2.3 ms over 20 at
// 3.35 TB/s), and the backward's gate, dx and weight gradients each read
// their operands again. The TPU kernel's halo-carried whole-stack fusion,
// built for one core's sequential grid, does not map onto 132 parallel
// SMs, so these kernels keep one launch a layer and are bound by those
// bytes and by the L2 traffic of their tiles, not by the tensor cores.
//
// Design:
// - One mainloop for every product (see "mainloop"): a producer warp keeps
//   TMA loads in flight into a ring of stages (mbarrier completion), two
//   consumer warpgroups multiply, 64 rows each. TMA reads zeros for rows
//   outside [0, N): the causal pad of a shifted tap and the ragged tail,
//   so no product masks rows. Persistent CTAs walk the 128-row tiles, so
//   one tile's epilogue overlaps the next one's loads.
// - Each product's route. bf16: wgmma m64n128k16, 128-byte-swizzled
//   operands, f32 sums. f32 products compute the f32 function, not TF32
//   (a single TF32 product keeps ~3 digits, too few against the f32 plain
//   version): K-major products (the forward's, dh, dx, dc) as 3xTF32 on
//   wgmma m64n128k8, A split hi + lo in registers, B as the TF32 hi and lo
//   planes the wrapper splits once a call, each stage's three products
//   summed in the tensor cores and added to the running sum in f32 (round
//   to nearest): summed in the tensor cores, whose accumulation
//   truncates, long sums drift. The weight gradients' depth is rows, so
//   their operands arrive MN-major, which tf32 wgmma does not take: the
//   consumers write each stage transposed into K-major hi and lo planes
//   first (bf16 wgmma reads the MN-major tiles as they are).
// - Widths at run time: every product walks 128-byte slabs of its depth
//   and 128 output columns a pass (the forward's first product 64 gated
//   channels a pass: the tanh half's 64 weight rows and the sigmoid half's
//   matching 64, so each lane holds a and b of the same channels). The
//   wrapper zero-pads R, Ch, S to multiples of 128 and cin to 16 (each
//   gate half on its own, so Ch stays the split point); shared memory
//   does not grow with any width, so none is refused for its size.
// - Operands are rounded to bf16 where the TPU kernel rounds them: the
//   dropped-out input of the taps, the conditioning, h = tanh·σ before
//   the skip and out products; in the backward c_res·dres, the scaled
//   skip gradient, the gate gradient dy and the dropped-out input.
// - Dropout is a counter-based hash of (seed, layer, row, channel)
//   (`keep_bit`), the plain version's `keep_bits` bit for bit, regenerated
//   in the backward, never stored. It counts channels by the true R, so
//   padding does not move the masks; its bits do not depend on the tile.
// - Forward (kernel 5a): a pre-pass writes layer 0's saved x and its tap
//   operand xd = W(dropout_0(x0)); then one launch a layer, whose
//   epilogue writes the next layer's saved x and xd, masks keyed by the
//   row. So the mainloop reads plain TMA tiles: no hash, no conversion.
//   Outputs leave through shared memory by TMA stores (`Stager`): stored
//   from registers, the epilogue's pairs of 4-8 bytes cost a layer twice
//   its products (PERF.md §5).
// - Backward (kernel 5b), per layer top down, 4 launches: gate (go, xd,
//   dh on the ring, h and the gate gradients dy, the per-CTA column sums
//   that give the bias gradients; its elementwise operands come through
//   the ring too), dx (the taps as three K-blocks over row-shifted windows
//   of dy, dropout and the residual path in the epilogue; dc over the
//   unshifted window), the five weight gradients in one launch (each CTA
//   one 128 × 128 output tile over one row split), and the reduction of
//   the splits' and the gate CTAs' partials in a fixed order: no float
//   atomics, so a rerun is bit-exact. go and h round-trip through global
//   memory inside a launch (written, fenced, read back by TMA after an
//   mbarrier), so their size is not bound by shared memory.
// - No software barrier across CTAs; no library call.

#include "common.cuh"
#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

// The widths a launch runs at: R the true residual width (the dropout
// hash's), then the padded R, Ch, S and cin.
struct Widths {
  int R, Rp, Chp, Sp, Cip;
};

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

__device__ __forceinline__ uint2 pack4(float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 r;
  r.x = *reinterpret_cast<uint32_t*>(&lo);
  r.y = *reinterpret_cast<uint32_t*>(&hi);
  return r;
}

// stores of 1, 2, 4 or 8 values and loads of 4 or 8, in bf16 (rounded to
// nearest) or f32
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

// ------------------------------------------------------------- mainloop
//
// Every product below runs on one ring: a producer warp issues TMA loads
// into a ring of stages in shared memory, each a few slabs of 128 rows × 128
// bytes (16 KB), completing on the stage's `full` mbarrier; two consumer
// warpgroups (64 rows each) multiply the stage and release it on its
// `empty` mbarrier (one arrival a consumer warp). Both sides walk the
// same sequence of stages, so the ring needs no other bookkeeping.
// K-major products (the activations' rows against the weights): a stage is
// an A slab and a B slab, bf16 64 values deep on wgmma; f32 32 deep as
// 3xTF32 on wgmma, A split into TF32 hi + lo in registers, B as the two
// planes the wrapper split once a call (A | B hi | B lo). The weight
// gradients (MN-major: the depth is rows) take P and Q slabs, bf16 on
// wgmma's transposed layouts, f32 transposed into K-major TF32 planes
// first (tf32 wgmma takes K-major operands only; see `Mnmajor<float>`).

constexpr int BM = 128;                // rows a tile
constexpr int CONS = 256;              // consumer threads: 2 warpgroups
constexpr int NTHREADS = CONS + 32;    // + the producer warp
constexpr int MAX_STAGES = 8;
constexpr int SLAB = BM * 128;         // 16 KB
// shared memory: 1 KB of alignment slack, 1 KB of barriers, the ring, then
// a kernel's own arrays
constexpr int RING0 = 1024;

// values of depth in a 128-byte slab row
template <typename W>
__host__ __device__ constexpr int kd() {
  return 128 / (int)sizeof(W);
}

// bytes of a K-major stage: A | B (bf16), A | B hi | B lo (f32)
template <typename W>
__host__ __device__ constexpr int kstage() {
  return sizeof(W) == 2 ? 2 * SLAB : 3 * SLAB;
}

// CTAs an SM runs. Two bf16 CTAs (96 registers a thread) overlap one's
// epilogue with the other's products where the epilogue is light (dx, the
// weight gradients); the gate and the forward, whose epilogues hold more
// live values, spill at 96 and run one CTA of 168 registers with a deeper
// ring. f32 kernels take one CTA (168).
template <typename W>
__host__ __device__ constexpr int min_ctas(bool heavy) {
  return sizeof(W) == 2 && !heavy ? 2 : 1;
}

// ring stages: about 96 KB a CTA at two CTAs an SM; at one, what 225 KB
// (the 227 KB a CTA may take, less the alignment slack and the barriers)
// leaves beside the kernel's own `extra` bytes
constexpr int SMEM_BUDGET = 225 * 1024;
__host__ __device__ constexpr int n_stages(int stage, int ctas, int extra) {
  return ctas == 2 ? 3
                   : ((SMEM_BUDGET - extra) / stage < MAX_STAGES
                          ? (SMEM_BUDGET - extra) / stage
                          : MAX_STAGES);
}

__host__ __device__ constexpr int smem_bytes(int stage, int ctas,
                                             int extra) {
  return 1024 + RING0 + n_stages(stage, ctas, extra) * stage + extra;
}

__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
}

struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int bytes, n;
  int s = 0;
  uint32_t ph = 0;
  __device__ Ring(unsigned char* sm, int stage, int ctas, int extra = 0)
      : base(sm + RING0),
        full(reinterpret_cast<uint64_t*>(sm)),
        empty(reinterpret_cast<uint64_t*>(sm) + MAX_STAGES),
        bytes(stage),
        n(n_stages(stage, ctas, extra)) {}
  // the kernel's own arrays, past the ring
  __device__ unsigned char* tail() const { return base + n * bytes; }
  __device__ uint64_t* extra(int i) const { return empty + MAX_STAGES + i; }
  __device__ void next() {
    if (++s == n) {
      s = 0;
      ph ^= 1;
    }
  }
  // producer: take the next stage, expecting a whole stage of bytes
  __device__ unsigned char* produce(int expect = 0) {
    hop::mbar_wait(&empty[s], ph ^ 1);
    hop::mbar_expect_tx(&full[s], expect ? expect : bytes);
    return base + s * bytes;
  }
  __device__ uint64_t* bar() { return &full[s]; }
  // consumer: wait for the next stage's bytes
  __device__ const unsigned char* consume() {
    hop::mbar_wait(&full[s], ph);
    return base + s * bytes;
  }
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) hop::mbar_arrive(&empty[s]);
    next();
  }
};

// Barriers: every stage's full (1 arrival + bytes) and empty (one arrival
// a consumer warp), then `extra` ones of `extra_count` arrivals.
__device__ __forceinline__ void ring_init(unsigned char* sm, const Ring& r,
                                          int extra, int extra_count) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < r.n; ++i) {
      hop::mbar_init(&r.full[i], 1);
      hop::mbar_init(&r.empty[i], CONS / 32);
    }
    for (int i = 0; i < extra; ++i)
      hop::mbar_init(r.extra(i), extra_count);
    hop::fence_barrier_init();
  }
  __syncthreads();
}

// Producer: one stage of a K-major product, A rows [arow, arow + 128) and
// B rows [brow, brow + 128) of layer `layer` (B's lo plane too, with f32),
// depth [k0, k0 + kd).
__device__ __forceinline__ void load_kmajor(Ring& r, const CUtensorMap* am,
                                            int k0, int arow,
                                            const CUtensorMap* bm,
                                            const CUtensorMap* bm_lo,
                                            int brow, int layer) {
  unsigned char* st = r.produce();
  hop::tma_load(st, am, r.bar(), k0, arow);
  hop::tma_load(st + SLAB, bm, r.bar(), k0, brow, layer);
  if (bm_lo) hop::tma_load(st + 2 * SLAB, bm_lo, r.bar(), k0, brow, layer);
  r.next();
}

// The lane's place in a consumer warpgroup's 64 × 128 accumulator (the
// wgmma and mma.sync layouts agree): d[4j + 2h + e] is row 16·w4 + grp +
// 8h, column 8j + 2·tig + e.
struct Lane {
  int wg, w4, grp, tig;
  __device__ Lane()
      : wg(threadIdx.x >> 7),
        w4((threadIdx.x >> 5) & 3),
        grp((threadIdx.x & 31) >> 2),
        tig(threadIdx.x & 3) {}
  __device__ int row(int h) const { return 64 * wg + 16 * w4 + grp + 8 * h; }
  __device__ int col(int j) const { return 8 * j + 2 * tig; }
};

// Output blocks staged in shared memory and written by TMA stores. Each
// consumer warpgroup owns two 16 KB halves, used in turn, so filling one
// overlaps the store of the other; a block is the warpgroup's 64 rows ×
// 256 bytes (two slabs of 128-byte rows: 128 bf16 or 64 f32 columns).
constexpr int STAGER = 4 * SLAB;
constexpr int HSLAB = SLAB / 2;  // a slab of 64 rows

struct Stager {
  unsigned char* buf;
  int half = 0, bar;
  bool leader;
  __device__ explicit Stager(unsigned char* base)
      : buf(base + (threadIdx.x >> 7) * 2 * SLAB),
        bar(2 + (threadIdx.x >> 7)),
        leader((threadIdx.x & 127) == 0) {}
  // the next half, once the store that last read it has read it
  __device__ unsigned char* begin() {
    half ^= 1;
    if (leader) hop::bulk_wait_read<1>();
    hop::named_sync(bar, 128);
    return buf + half * SLAB;
  }
  // a pair of E at the warpgroup's row r (< 64), column c (even)
  template <typename E>
  __device__ static void put(unsigned char* blk, int r, int c, float x,
                             float y) {
    const int byte = c * (int)sizeof(E);
    put2(reinterpret_cast<E*>(blk + (byte >> 7) * HSLAB +
                              hop::sw128(r, byte & 127)),
         x, y);
  }
  // store the block's first `slabs` slabs at column col0, row row0 (and
  // `layer` of a rank-3 map)
  template <typename E>
  __device__ void end(const unsigned char* blk, const CUtensorMap* m,
                      int col0, int row0, int slabs, int layer = -1) {
    hop::fence_proxy_async_shared();
    hop::named_sync(bar, 128);
    if (leader) {
      for (int q = 0; q < slabs; ++q) {
        const int c = col0 + q * (128 / (int)sizeof(E));
        if (layer < 0)
          hop::tma_store(m, blk + q * HSLAB, c, row0);
        else
          hop::tma_store(m, blk + q * HSLAB, c, row0, layer);
      }
      hop::bulk_commit();
    }
  }
  // this warpgroup's stores complete (written, not only read)
  __device__ void drain() {
    if (leader) hop::bulk_wait<0>();
  }
};

__device__ __forceinline__ float lds_sw(const unsigned char* slab, int r,
                                        int byte) {
  return *reinterpret_cast<const float*>(slab + hop::sw128(r, byte));
}

// Values of an elementwise operand that a stage holds as slabs (`E` the
// element type, column c of the slab): a pair (c even), or 8 (c a
// multiple of 8).
__device__ __forceinline__ float2 lds_pair(const unsigned char* slab, int r,
                                           int c, const bf16*) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(
      slab + hop::sw128(r, 2 * c));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 lds_pair(const unsigned char* slab, int r,
                                           int c, const float*) {
  return *reinterpret_cast<const float2*>(slab + hop::sw128(r, 4 * c));
}
__device__ __forceinline__ void lds8(const unsigned char* slab, int r, int c,
                                     float* v, const bf16*) {
  get8(reinterpret_cast<const bf16*>(slab + hop::sw128(r, 2 * c)), v);
}
__device__ __forceinline__ void lds8(const unsigned char* slab, int r, int c,
                                     float* v, const float*) {
  get4(reinterpret_cast<const float*>(slab + hop::sw128(r, 4 * c)), v);
  get4(reinterpret_cast<const float*>(slab + hop::sw128(r, 4 * c + 16)),
       v + 4);
}

// acc (+)= A[warpgroup's 64 rows] · B[128 rows]ᵀ over one K-major stage.
template <typename W>
struct Kmajor;

template <>
struct Kmajor<bf16> {
  __device__ static void run(float (&acc)[64], const unsigned char* st,
                             const Lane& ln, bool first,
                             const unsigned char* a_src = nullptr) {
    const uint32_t a = hop::smem_u32(a_src ? a_src : st) + ln.wg * 8192;
    const uint32_t b = hop::smem_u32(st + SLAB);
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hop::wgmma_m64n128k16_bf16<0, 0>(acc, hop::desc(a + 32 * k, 16, 1024),
                                       hop::desc(b + 32 * k, 16, 1024),
                                       first && k == 0 ? 0 : 1);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::reg_fence(acc);
  }
};

// f32: each 8-deep step is lo·hi + hi·lo + hi·hi (A's TF32 split taken in
// registers from the swizzled slab, B's two planes from the wrapper) on
// the tensor cores, into a stage sum that an f32 add (round to nearest)
// adds to acc: the tensor cores' own accumulation truncates, so the
// running sum stays out of them (summed in them, long sums drift).
template <>
struct Kmajor<float> {
  __device__ static void run(float (&acc)[64], const unsigned char* st,
                             const Lane& ln, bool first,
                             const unsigned char* a_src = nullptr) {
    const uint32_t bh = hop::smem_u32(st + SLAB);
    const uint32_t bl = hop::smem_u32(st + 2 * SLAB);
    const unsigned char* A = a_src ? a_src : st;
    const int m = ln.row(0);
    float part[64];
    // two 8-deep steps a wgmma group (their A registers live until it ends)
#pragma unroll
    for (int k2 = 0; k2 < 4; k2 += 2) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kb = (8 * (k2 + i) + ln.tig) * 4;
        taco::split_tf32(lds_sw(A, m, kb), ah[i][0], al[i][0]);
        taco::split_tf32(lds_sw(A, m + 8, kb), ah[i][1], al[i][1]);
        taco::split_tf32(lds_sw(A, m, kb + 16), ah[i][2], al[i][2]);
        taco::split_tf32(lds_sw(A, m + 8, kb + 16), ah[i][3], al[i][3]);
      }
      hop::wgmma_fence();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = k2 + i;
        const uint64_t dh = hop::desc(bh + 32 * k, 16, 1024);
        const uint64_t dl = hop::desc(bl + 32 * k, 16, 1024);
        hop::wgmma_m64n128k8_tf32_rs(part, al[i], dh, k == 0 ? 0 : 1);
        hop::wgmma_m64n128k8_tf32_rs(part, ah[i], dl, 1);
        hop::wgmma_m64n128k8_tf32_rs(part, ah[i], dh, 1);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
    }
    hop::reg_fence(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = first ? part[i] : acc[i] + part[i];
  }
};

// The weight gradients' stage: P rows r .. r + rd of output rows i0 ..
// i0 + 128 and Q rows of output columns j0 .. j0 + 128, both as they lie
// (MN-major), in boxes kd() wide: bf16 2 boxes of 64 rows each side, f32
// 4 boxes of 32 rows.
template <typename W>
__host__ __device__ constexpr int wg_rows() {
  return sizeof(W) == 2 ? 64 : 32;
}

template <typename W>
struct Mnmajor;

template <>
struct Mnmajor<bf16> {
  __device__ static void run(float (&acc)[64], const unsigned char* st,
                             bool first) {
    const Lane ln;
    const uint32_t a = hop::smem_u32(st) + ln.wg * 8192;
    const uint32_t b = hop::smem_u32(st + SLAB);
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hop::wgmma_m64n128k16_bf16<1, 1>(
          acc, hop::desc(a + 2048 * k, 8192, 1024),
          hop::desc(b + 2048 * k, 8192, 1024), first && k == 0 ? 0 : 1);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::reg_fence(acc);
  }
  // the 128 × 128 tile, row-major
  __device__ static void store(const float (&acc)[64], float* out) {
    const Lane ln;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(out + ln.row(hh) * 128 + ln.col(j)) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
};

// f32: tf32 wgmma takes K-major operands only, so the consumers write each
// stage transposed into K-major TF32 planes (P and Q each split hi + lo)
// in one of two scratch buffers, `WG_SCRATCH` bytes each past the ring,
// while the previous stage's wgmmas run on the other; lo·hi + hi·lo + hi·hi
// go into a stage sum that an f32 add (round to nearest) adds to acc, as
// `Kmajor<float>` does.
constexpr int WG_SCRATCH = 4 * SLAB;

template <typename W>
__host__ __device__ constexpr int wg_scratch() {
  return sizeof(W) == 4 ? 2 * WG_SCRATCH : 0;
}

template <>
struct Mnmajor<float> {
  // element (r, c) of a stage side: box c / 32, byte 4·(c mod 32) of row r
  __device__ static float at(const unsigned char* side, int r, int c) {
    return lds_sw(side + (c >> 5) * 4096, r, (c & 31) * 4);
  }
  // a stage into buf: P hi, P lo, Q hi, Q lo, each 128 rows (i or j) × 32
  // deep, K-major. A lane takes 4 depths of one row: 4 reads along a
  // 128-byte row of the stage (a warp's 32 lanes one row of a box), one
  // 16-byte write a plane (8 lanes' writes in 8 distinct chunks).
  __device__ static void transpose(const unsigned char* st,
                                   unsigned char* buf) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int task = threadIdx.x + CONS * it;
      const int c = task & 127, r = 4 * (task >> 7);
      const uint32_t o = hop::sw128(c, 4 * r);
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        uint4 hi, lo;
        taco::split_tf32(at(st + side * SLAB, r, c), hi.x, lo.x);
        taco::split_tf32(at(st + side * SLAB, r + 1, c), hi.y, lo.y);
        taco::split_tf32(at(st + side * SLAB, r + 2, c), hi.z, lo.z);
        taco::split_tf32(at(st + side * SLAB, r + 3, c), hi.w, lo.w);
        *reinterpret_cast<uint4*>(buf + 2 * side * SLAB + o) = hi;
        *reinterpret_cast<uint4*>(buf + (2 * side + 1) * SLAB + o) = lo;
      }
    }
  }
  // part = Σ over the stage's depth of the three products, asynchronous
  __device__ static void issue(float (&part)[64], const unsigned char* buf,
                               const Lane& ln) {
    const uint32_t s0 = hop::smem_u32(buf);
    const uint32_t ph = s0 + ln.wg * 8192, pl = ph + SLAB;
    const uint32_t qh = s0 + 2 * SLAB, ql = s0 + 3 * SLAB;
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = 32 * k;
      hop::wgmma_m64n128k8_tf32_ss(part, hop::desc(pl + o, 16, 1024),
                                   hop::desc(qh + o, 16, 1024),
                                   k == 0 ? 0 : 1);
      hop::wgmma_m64n128k8_tf32_ss(part, hop::desc(ph + o, 16, 1024),
                                   hop::desc(ql + o, 16, 1024), 1);
      hop::wgmma_m64n128k8_tf32_ss(part, hop::desc(ph + o, 16, 1024),
                                   hop::desc(qh + o, 16, 1024), 1);
    }
    hop::wgmma_commit();
  }
  __device__ static void store(const float (&acc)[64], float* out) {
    Mnmajor<bf16>::store(acc, out);
  }
};

// shared memory past the forward's ring: the stager, and h's slabs when
// they stay there
__host__ __device__ constexpr int fwd_extra(int h_smem, int h_bytes) {
  return STAGER + (h_smem ? h_bytes : 0);
}
// h stays in shared memory up to this size (Ch <= 128 in f32, 256 in bf16)
constexpr int H_SMEM_MAX = 4 * SLAB;

// A layer's dropout multipliers over a tile: layer key, threshold, the
// true R, 1/keep; the tile's first row and column.
struct Mask {
  uint32_t key, keep24;
  int R;
  float inv_keep;
  int row0, col0;
};

// The accumulator's columns [c0, c0 + cw) of the warpgroup's rows into a
// staged block as E, times the dropout multipliers when m is set.
template <typename E>
__device__ __forceinline__ void put_block(unsigned char* blk,
                                          const float (&acc)[64],
                                          const Lane& ln, int c0, int cw,
                                          const Mask* m = nullptr) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = ln.col(j);
    if (c < c0 || c >= c0 + cw) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
      if (m) {
        const int row = m->row0 + ln.row(hh), col = m->col0 + c;
        v0 *= keep_mult(m->key, row, col, m->keep24, m->R, m->inv_keep);
        v1 *= keep_mult(m->key, row, col + 1, m->keep24, m->R, m->inv_keep);
      }
      Stager::put<E>(blk, ln.row(hh) - 64 * ln.wg, c - c0, v0, v1);
    }
  }
}

// ----------------------------------------------------------------- forward
//
// One launch a layer (after a pre-pass for layer 0's operands). A CTA's
// tile of 128 rows:
//   product 1  y = Σ_q xd[t - (2-q)d] · W_q + c · W_cin, the taps three
//              K-blocks over row-shifted TMA windows of xd = W(dropout(x))
//              (rows before 0 or past N read zeros: the causal pad and the
//              ragged tail), 64 gated channels a pass: B holds the tanh
//              half's 64 weight rows and the sigmoid half's matching 64,
//              so each lane holds a and b of the same channels
//   gate       tanh a, σ b saved; h = W(tanh a · σ b) to a global scratch
//              (the tile's own rows, read back by TMA after a barrier)
//   product 2  [skip | out] = h · [W_skip | W_out], 128 columns a pass
//              (the last layer skips the out columns)
//   epilogue   skip += scale·(· + skip_b); x_out = c_res·(· + out_b + x);
//              the next layer's saved x and its tap operand
//              xd' = W(dropout_{l+1}(x_out)), masks keyed by the row
// So the mainloop reads plain TMA tiles: no hash, no conversion, no mask.

template <typename W, typename A>
struct FwdArgs {
  CUtensorMap xd_map;     // this layer's xd [N, Rp], boxes of 128 rows
  CUtensorMap cb_map;     // [N, Cip] conditioning
  CUtensorMap h_map;      // [N, Chp] scratch
  CUtensorMap w1_map;     // [L, Gp, 3·Rp + Cip]: taps and cin, transposed;
                          // boxes of 64 rows
  CUtensorMap w1_lo_map;  // TF32 lo planes (f32 weights)
  CUtensorMap w2_map;     // [L, Sp + Rp, Chp]: skip | out, transposed
  CUtensorMap w2_lo_map;
  // the epilogue's f32 inputs through the ring, 32-column boxes: the skip
  // sum so far [N, Sp] and the block input [N, Rp]
  CUtensorMap skip_map, xin_map;
  // the stores, boxes of 64 rows: the saved activations ([3·L, N, AW],
  // layer l's x, tanh a, σ b at 3l, 3l + 1, 3l + 2), h, the skip sum, x_out
  // and the next xd
  CUtensorMap acts_st, h_st, skip_st, xout_st, xdn_st;
  int N, step, layer, tiles, first, last;  // step = d·B rows
  int h_smem;  // h stays in shared memory for product 2 (it fits)
  const float* b1;        // [Gp] conv bias + cin bias
  const float* skip_b;    // [Sp]
  const float* out_b;     // [Rp]
  Widths w;
  uint32_t key_next, keep24;
  float inv_keep, scale, c_res;
  int drop;
};

template <typename W, typename A>
__global__ void __launch_bounds__(NTHREADS, min_ctas<W>(true))
    fwd_layer_kernel(const __grid_constant__ FwdArgs<W, A> a) {
  unsigned char* sm = smem_base();
  const Widths w = a.w;
  const int R = w.R, Rp = w.Rp, Chp = w.Chp, Sp = w.Sp, Cip = w.Cip;
  const int N = a.N;
  const int NO = a.last ? Sp : Sp + Rp;  // product 2's columns
  constexpr int KD = kd<W>();
  const int nst1 = 3 * (Rp / KD) + (Cip + KD - 1) / KD;
  Ring ring(sm, kstage<W>(), min_ctas<W>(true),
            fwd_extra(a.h_smem, Chp * BM * (int)sizeof(W)));
  ring_init(sm, ring, 1, 2);
  uint64_t* hready = ring.extra(0);  // the tile's h rows are written

  if (threadIdx.x >= CONS) {  // the producer warp
    if (threadIdx.x == CONS) {
      const bool f32 = sizeof(W) == 4;
      const CUtensorMap* lo2 = f32 ? &a.w2_lo_map : nullptr;
      int it = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++it) {
        const int r0 = t * BM;
        for (int c0 = 0; c0 < Chp; c0 += 64)
          for (int q = 0; q < 4; ++q) {
            const int K = q < 3 ? Rp : Cip;
            for (int k0 = 0; k0 < K; k0 += KD) {
              unsigned char* st = ring.produce();
              if (q < 3)
                hop::tma_load(st, &a.xd_map, ring.bar(), k0,
                              r0 - (2 - q) * a.step);
              else
                hop::tma_load(st, &a.cb_map, ring.bar(), k0, r0);
              const int kc = q * Rp + k0;
              for (int p = 0; p < (f32 ? 2 : 1); ++p) {
                const CUtensorMap* m = p ? &a.w1_lo_map : &a.w1_map;
                unsigned char* b = st + (1 + p) * SLAB;
                hop::tma_load(b, m, ring.bar(), kc, c0, a.layer);
                hop::tma_load(b + 64 * 128, m, ring.bar(), kc, Chp + c0,
                              a.layer);
              }
              ring.next();
            }
          }
        if (!a.h_smem) hop::mbar_wait(hready, it & 1);
        for (int n0 = 0; n0 < NO; n0 += 128) {
          for (int k0 = 0; k0 < Chp; k0 += KD) {
            if (!a.h_smem) {
              load_kmajor(ring, &a.h_map, k0, r0, &a.w2_map, lo2, n0,
                          a.layer);
              continue;
            }
            // A is h in shared memory: the stage holds B alone
            unsigned char* st = ring.produce(kstage<W>() - SLAB);
            hop::tma_load(st + SLAB, &a.w2_map, ring.bar(), k0, n0, a.layer);
            if (lo2)
              hop::tma_load(st + 2 * SLAB, lo2, ring.bar(), k0, n0, a.layer);
            ring.next();
          }
          const bool is_skip = n0 < Sp;
          if (is_skip && a.first) continue;  // no skip sum yet
          const CUtensorMap* m = is_skip ? &a.skip_map : &a.xin_map;
          for (int c = 0; c < 128; c += 64) {  // 64 f32 columns a stage
            unsigned char* st = ring.produce(2 * SLAB);
            const int col = (is_skip ? n0 : n0 - Sp) + c;
            hop::tma_load(st, m, ring.bar(), col, r0);
            hop::tma_load(st + SLAB, m, ring.bar(), col + 32, r0);
            ring.next();
          }
        }
      }
    }
    return;
  }

  const Lane ln;
  Stager stg(ring.tail());
  unsigned char* hbuf = ring.tail() + STAGER;  // [Chp / KD] slabs, h_smem
  // a block's columns and slabs: W and A values, 64 f32 columns
  constexpr int WC = 128 / (int)sizeof(W), AC = 128 / (int)sizeof(A);
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const int r0 = t * BM, rw = r0 + 64 * ln.wg;  // the warpgroup's rows
    float acc[64];
    for (int c0 = 0; c0 < Chp; c0 += 64) {
      for (int s = 0; s < nst1; ++s) {
        const unsigned char* st = ring.consume();
        Kmajor<W>::run(acc, st, ln, s == 0);
        ring.release();
      }
      // the gate, in place: columns j < 8 hold tanh a of channels c0 +
      // 8j + 2·tig + e, j + 8 the sigmoid of the same channels
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + ln.col(j);
        const float2 ba = __ldg(reinterpret_cast<const float2*>(a.b1 + col));
        const float2 bb =
            __ldg(reinterpret_cast<const float2*>(a.b1 + Chp + col));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float* v = &acc[4 * j + 2 * hh];
          float* u = &acc[4 * (j + 8) + 2 * hh];
          v[0] = tanhf(v[0] + ba.x);
          v[1] = tanhf(v[1] + ba.y);
          u[0] = taco::sigmoidf(u[0] + bb.x);
          u[1] = taco::sigmoidf(u[1] + bb.y);
        }
      }
      // tanh a, sigmoid b (saved, in A) and h = W(tanh a · sigmoid b),
      // each a block of the pass's 64 channels; or h into its slabs
      if (a.h_smem) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float* v = &acc[4 * j + 2 * hh];
            const float* u = &acc[4 * (j + 8) + 2 * hh];
            const int c = c0 + ln.col(j), b = (c % KD) * (int)sizeof(W);
            put2(reinterpret_cast<W*>(hbuf + (c / KD) * SLAB +
                                      hop::sw128(ln.row(hh), b)),
                 v[0] * u[0], v[1] * u[1]);
          }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (q == 2 && a.h_smem) break;
        unsigned char* blk = stg.begin();
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float* v = &acc[4 * j + 2 * hh];
            const float* u = &acc[4 * (j + 8) + 2 * hh];
            const int r = ln.row(hh) - 64 * ln.wg, c = ln.col(j);
            if (q == 0) Stager::put<A>(blk, r, c, v[0], v[1]);
            if (q == 1) Stager::put<A>(blk, r, c, u[0], u[1]);
            if (q == 2) Stager::put<W>(blk, r, c, v[0] * u[0], v[1] * u[1]);
          }
        if (q < 2)
          stg.end<A>(blk, &a.acts_st, c0, rw, 64 / AC,
                     3 * a.layer + 1 + q);
        else
          stg.end<W>(blk, &a.h_st, c0, rw, 64 / WC);
      }
    }
    if (a.h_smem) {
      // the warpgroup's h rows written before its wgmma reads them
      hop::fence_proxy_async_shared();
      hop::named_sync(stg.bar, 128);
    } else {
      // h written (complete, not only read) before the producer loads it
      stg.drain();
      if (stg.leader) {
        hop::fence_proxy_async_global();
        hop::mbar_arrive(hready);
      }
    }

    for (int n0 = 0; n0 < NO; n0 += 128) {
      for (int k0 = 0; k0 < Chp; k0 += KD) {
        const unsigned char* st = ring.consume();
        Kmajor<W>::run(acc, st, ln, k0 == 0,
                       a.h_smem ? hbuf + (k0 / KD) * SLAB : nullptr);
        ring.release();
      }
      const bool is_skip = n0 < Sp;
      const int cb = is_skip ? n0 : n0 - Sp;
      const float* bias = is_skip ? a.skip_b + n0 : a.out_b + n0 - Sp;
      const bool has_prev = !(is_skip && a.first);
      // in place: the new skip sum, or x_out, from the previous values'
      // two stages (64 f32 columns each)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const unsigned char* st = has_prev ? ring.consume() : nullptr;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * e + jj, cs = 8 * jj + 2 * ln.tig;
          const float2 bv =
              __ldg(reinterpret_cast<const float2*>(bias + ln.col(j)));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float* v = &acc[4 * j + 2 * hh];
            float2 p = make_float2(0.f, 0.f);
            if (has_prev)
              p = lds_pair(st + (cs >> 5) * SLAB, ln.row(hh), cs & 31,
                           (const float*)nullptr);
            if (is_skip) {
              v[0] = p.x + a.scale * (v[0] + bv.x);
              v[1] = p.y + a.scale * (v[1] + bv.y);
            } else {
              v[0] = a.c_res * (v[0] + bv.x + p.x);
              v[1] = a.c_res * (v[1] + bv.y + p.y);
            }
          }
        }
        if (has_prev) ring.release();
      }
      // blocks: the new skip sum or x_out in f32, 64 columns a block; with
      // x_out also the next layer's saved x (A) and its xd (W, dropped out
      // by layer l + 1's mask), two slabs of columns a block
      for (int part = 0; part < 128; part += 64) {
        unsigned char* blk = stg.begin();
        put_block<float>(blk, acc, ln, part, 64);
        stg.end<float>(blk, is_skip ? &a.skip_st : &a.xout_st, cb + part,
                       rw, 2);
      }
      if (is_skip) continue;
      for (int part = 0; part < 128; part += 2 * AC) {
        unsigned char* blk = stg.begin();
        put_block<A>(blk, acc, ln, part, 2 * AC);
        stg.end<A>(blk, &a.acts_st, cb + part, rw, 2, 3 * a.layer + 3);
      }
      const Mask mask{a.key_next, a.keep24, R, a.inv_keep, r0, cb};
      for (int part = 0; part < 128; part += 2 * WC) {
        unsigned char* blk = stg.begin();
        put_block<W>(blk, acc, ln, part, 2 * WC, a.drop ? &mask : nullptr);
        stg.end<W>(blk, &a.xdn_st, cb + part, rw, 2);
      }
    }
  }
  stg.drain();
}

// Layer 0's operands: its saved x and xd = W(dropout_0(x0)).
template <typename W, typename A>
__global__ void fwd_pre_kernel(const float* __restrict__ x0, A* acts, W* xd,
                               int N, Widths w, uint32_t key,
                               uint32_t keep24, float inv_keep, int drop) {
  const int Rp = w.Rp, AW = w.Rp > w.Chp ? w.Rp : w.Chp;
  const long long units = (long long)N * (Rp / 8);
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < units; u += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(u / (Rp / 8)), c8 = (int)(u % (Rp / 8)) * 8;
    float v[8];
    get8(x0 + (size_t)row * Rp + c8, v);
    put8(acts + (size_t)row * AW + c8, v);
    if (drop) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = v[e] * keep_mult(key, row, c8 + e, keep24, w.R, inv_keep);
    }
    put8(xd + (size_t)row * Rp + c8, v);
  }
}

// ---------------------------------------------------------------- backward
//
// One layer, top down, in 4 launches:
//   gate    go = [W(c_res·dres) | W(scale·dskip)], xd = W(x·dropout),
//           h = W(tanh a · σ b) (for the weight gradients), then
//           dh = go·[W_out | W_skip]ᵀ on the ring and the gate gradients
//           dy = W([da | db]); per-CTA column sums of go and da | db
//   dx      dres_out = c_res·dres + dropout · Σ_k dy[t + (2-k)d]·W_kᵀ, the
//           three taps three K-blocks over row-shifted TMA windows of dy,
//           and dc (+)= dy·W_cinᵀ over the unshifted window
//   wgrad   all five weight gradients Σ_r Pᵀ·Q (3 taps, cin, out|skip):
//           each CTA one 128 × 128 output tile over one row split
//   reduce  the splits' partials and the gate CTAs' column sums, summed
//           in a fixed order into the layer's gradients

template <typename W, typename A>
struct GateArgs {
  CUtensorMap go_map;      // go [N, NG], boxes of 128 rows
  CUtensorMap wos_map;     // [L, Chp, NG]: out | skip, as stored
  CUtensorMap wos_lo_map;  // its TF32 lo planes (f32 weights)
  CUtensorMap dres_map;    // dres [N, Rp] f32, 32-column boxes
  CUtensorMap dskip_map;   // dskip [N, Sp] f32
  CUtensorMap acts_map;    // this layer's [3, N, AW] in A, 128-byte boxes
  CUtensorMap h_st, dy_st;  // stores of h and dy, boxes of 64 rows
  W* go;                   // [N, NG] (its residual half zero at the top)
  W* dy;                   // [N, Gp]
  W* xd;                   // [N, Rp]
  W* h;                    // [N, Chp]
  float* bpart;            // [CTAs, Gp + NG] column sums of dy | go
  int N, layer, tiles, has_dres;
  Widths w;
  uint32_t key, keep24;
  float inv_keep, scale, c_res;
  int drop;
};

// shared memory past the gate's ring: column sums of dy | go, the
// consumers' partial sums, and with bf16 weights and saved activations
// the stager
__host__ __device__ constexpr int gate_extra(int cols, bool staged) {
  return 4 * cols + 4 * 8 * 256 + (staged ? STAGER : 0);
}

// The gate launch's elementwise operands come through the ring too, two
// slabs a stage: dres and dskip 64 f32 columns a stage, x 2·XC columns,
// tanh a and σ b XC columns each (XC = a slab's columns in A).
template <typename W, typename A>
__global__ void __launch_bounds__(NTHREADS, min_ctas<W>(true))
    bwd_gate_kernel(const __grid_constant__ GateArgs<W, A> a) {
  unsigned char* sm = smem_base();
  const Widths w = a.w;
  const int R = w.R, Rp = w.Rp, Chp = w.Chp, Sp = w.Sp;
  const int NG = Rp + Sp, Gp = 2 * Chp;
  const int N = a.N;
  constexpr int XC = 128 / (int)sizeof(A);
  Ring ring(sm, kstage<W>(), min_ctas<W>(true),
            gate_extra(Gp + NG, sizeof(A) == 2 && sizeof(W) == 2));
  float* bsum = reinterpret_cast<float*>(ring.tail());  // [Gp + NG]
  float* red = bsum + Gp + NG;                           // [8][256]
  Stager stg(ring.tail() + gate_extra(Gp + NG, false));
  for (int c = threadIdx.x; c < Gp + NG; c += NTHREADS) bsum[c] = 0.f;
  ring_init(sm, ring, 1, CONS);
  uint64_t* ready = ring.extra(0);  // the tile's go rows are written

  if (threadIdx.x >= CONS) {  // the producer warp
    if (threadIdx.x == CONS) {
      const CUtensorMap* lo = sizeof(W) == 4 ? &a.wos_lo_map : nullptr;
      int it = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++it) {
        const int r0 = t * BM;
        for (int q = a.has_dres ? 0 : 1; q < 2; ++q) {
          const CUtensorMap* m = q ? &a.dskip_map : &a.dres_map;
          for (int c = 0; c < (q ? Sp : Rp); c += 64) {
            unsigned char* st = ring.produce(2 * SLAB);
            hop::tma_load(st, m, ring.bar(), c, r0);
            hop::tma_load(st + SLAB, m, ring.bar(), c + 32, r0);
            ring.next();
          }
        }
        for (int c = 0; c < Rp; c += 2 * XC) {
          unsigned char* st = ring.produce(2 * SLAB);
          hop::tma_load(st, &a.acts_map, ring.bar(), c, r0, 0);
          hop::tma_load(st + SLAB, &a.acts_map, ring.bar(), c + XC, r0, 0);
          ring.next();
        }
        hop::mbar_wait(ready, it & 1);
        for (int c0 = 0; c0 < Chp; c0 += 128) {
          for (int k0 = 0; k0 < NG; k0 += kd<W>())
            load_kmajor(ring, &a.go_map, k0, r0, &a.wos_map, lo, c0,
                        a.layer);
          for (int c = 0; c < 128; c += XC) {
            unsigned char* st = ring.produce(2 * SLAB);
            hop::tma_load(st, &a.acts_map, ring.bar(), c0 + c, r0, 1);
            hop::tma_load(st + SLAB, &a.acts_map, ring.bar(), c0 + c, r0, 2);
            ring.next();
          }
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x, warp = tid >> 5;
  const Lane ln;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const int r0 = t * BM;
    // go = W(c_res·dres | scale·dskip) and its column sums: a stage's 64
    // columns, a thread 32 rows of one column (the four row groups' sums
    // add in order)
    {
      const int c = tid & 63, g = tid >> 6;
      for (int q = a.has_dres ? 0 : 1; q < 2; ++q)
        for (int c0 = 0; c0 < (q ? Sp : Rp); c0 += 64) {
          const unsigned char* st = ring.consume();
          const unsigned char* slab = st + (c >> 5) * SLAB;
          const float mul = q ? a.scale : a.c_res;
          const int j = (q ? Rp : 0) + c0 + c;
          float sum = 0.f;
#pragma unroll 8
          for (int i = 32 * g; i < 32 * g + 32; ++i) {
            const float v = mul * lds_sw(slab, i, (c & 31) * 4);
            if (r0 + i < N) put1(a.go + (size_t)(r0 + i) * NG + j, v);
            sum += v;
          }
          red[g * 64 + c] = sum;
          ring.release();
          hop::named_sync(1, CONS);
          if (tid < 64)
            bsum[Gp + j] += ((red[tid] + red[64 + tid]) + red[128 + tid]) +
                            red[192 + tid];
          hop::named_sync(1, CONS);
        }
    }
    hop::fence_proxy_async_global();
    hop::mbar_arrive(ready);
    // xd = W(x · dropout multiplier), the tap weight gradients' left
    // operand: 8 channels a unit
    for (int c0 = 0; c0 < Rp; c0 += 2 * XC) {
      const unsigned char* st = ring.consume();
      constexpr int per_row = 2 * XC / 8;
      for (int u = tid; u < BM * per_row; u += CONS) {
        const int i = u / per_row, c8 = (u % per_row) * 8;
        const int row = r0 + i;
        if (row >= N) continue;
        float v[8];
        lds8(st + (c8 / XC) * SLAB, i, c8 % XC, v, (const A*)nullptr);
        if (a.drop) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = v[e] * keep_mult(a.key, row, c0 + c8 + e, a.keep24, R,
                                    a.inv_keep);
        }
        put8(a.xd + (size_t)row * Rp + c0 + c8, v);
      }
      ring.release();
    }

    // dh, 128 gated channels a pass; then, from the tanh a and σ b
    // stages, h = W(tanh a · σ b) (the out | skip weight gradients' left
    // operand), da and db into dy and their column sums
    for (int c0 = 0; c0 < Chp; c0 += 128) {
      float acc[64];
      for (int k0 = 0; k0 < NG; k0 += kd<W>()) {
        const unsigned char* st = ring.consume();
        Kmajor<W>::run(acc, st, ln, k0 == 0);
        ring.release();
      }
#pragma unroll
      for (int e = 0; e < 128 / XC; ++e) {
        const unsigned char* st = ring.consume();
        if constexpr (sizeof(A) == 2 && sizeof(W) == 2) {
          // bf16 weights and saved activations: h, da, db each a staged
          // block of the stage's 64 columns, stored by TMA (with f32
          // weights the staging's registers spill and it runs slower)
          constexpr int WC = 128 / (int)sizeof(W);
          const int rw = r0 + 64 * ln.wg;
          float sa[8][2], sb[8][2];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            unsigned char* blk = stg.begin();
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int j = 8 * e + jj, cs = 8 * jj + 2 * ln.tig;
              if (q == 1) sa[jj][0] = sa[jj][1] = 0.f;
              if (q == 2) sb[jj][0] = sb[jj][1] = 0.f;
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int rl = ln.row(hh);
                const float2 tv = lds_pair(st, rl, cs, (const A*)nullptr);
                const float2 sv =
                    lds_pair(st + SLAB, rl, cs, (const A*)nullptr);
                float v[2];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                  const float ta = i ? tv.y : tv.x, sg = i ? sv.y : sv.x;
                  const float dh = acc[4 * j + 2 * hh + i];
                  if (q == 0) v[i] = ta * sg;
                  if (q == 1) sa[jj][i] += v[i] = dh * sg * (1.f - ta * ta);
                  if (q == 2) sb[jj][i] += v[i] = dh * ta * sg * (1.f - sg);
                }
                Stager::put<W>(blk, rl - 64 * ln.wg, cs, v[0], v[1]);
              }
            }
            const int col = (q == 2 ? Chp : 0) + c0 + 64 * e;
            stg.end<W>(blk, q == 0 ? &a.h_st : &a.dy_st, col, rw, 64 / WC);
          }
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * e + jj;
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int o = 4; o < 32; o <<= 1) {
                sa[jj][q] += __shfl_xor_sync(0xffffffffu, sa[jj][q], o);
                sb[jj][q] += __shfl_xor_sync(0xffffffffu, sb[jj][q], o);
              }
            if (ln.grp == 0) {
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                red[warp * 256 + ln.col(j) + q] = sa[jj][q];
                red[warp * 256 + 128 + ln.col(j) + q] = sb[jj][q];
              }
            }
          }
          ring.release();
          continue;
        }
#pragma unroll
        for (int jj = 0; jj < XC / 8; ++jj) {
          const int j = e * (XC / 8) + jj;
          const int cs = 8 * jj + 2 * ln.tig;  // column in the slab
          const int col = c0 + ln.col(j);
          float sa[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int rl = ln.row(hh), row = r0 + rl;
            const float2 tv = lds_pair(st, rl, cs, (const A*)nullptr);
            const float2 sv = lds_pair(st + SLAB, rl, cs, (const A*)nullptr);
            float da[2], db[2], hv[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float ta = q ? tv.y : tv.x, sg = q ? sv.y : sv.x;
              const float dh = acc[4 * j + 2 * hh + q];
              hv[q] = ta * sg;
              da[q] = dh * sg * (1.f - ta * ta);
              db[q] = dh * ta * sg * (1.f - sg);
              sa[q] += da[q];
              sb[q] += db[q];
            }
            if (row < N) {
              put2(a.h + (size_t)row * Chp + col, hv[0], hv[1]);
              put2(a.dy + (size_t)row * Gp + col, da[0], da[1]);
              put2(a.dy + (size_t)row * Gp + Chp + col, db[0], db[1]);
            }
          }
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              sa[q] += __shfl_xor_sync(0xffffffffu, sa[q], o);
              sb[q] += __shfl_xor_sync(0xffffffffu, sb[q], o);
            }
          if (ln.grp == 0) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              red[warp * 256 + ln.col(j) + q] = sa[q];
              red[warp * 256 + 128 + ln.col(j) + q] = sb[q];
            }
          }
        }
        ring.release();
      }
      hop::named_sync(1, CONS);
      {
        float sum = 0.f;
        for (int v = 0; v < CONS / 32; ++v) sum += red[v * 256 + tid];
        bsum[tid < 128 ? c0 + tid : Chp + c0 + tid - 128] += sum;
      }
      hop::named_sync(1, CONS);
    }
  }
  for (int c = tid; c < Gp + NG; c += CONS)
    a.bpart[(size_t)blockIdx.x * (Gp + NG) + c] = bsum[c];
  stg.drain();
}

template <typename W>
struct DxArgs {
  CUtensorMap dy_map;        // dy [N, Gp], boxes of 128 rows
  CUtensorMap wconv_map;     // [L, 3·Rp, Gp]: the taps' weights, as stored
  CUtensorMap wconv_lo_map;  // TF32 lo planes (f32 weights)
  CUtensorMap wcin_map;      // [L, Cip, Gp]
  CUtensorMap wcin_lo_map;
  // the epilogues' f32 inputs through the ring, 32-column boxes: dres
  // [N, Rp] (where there is one) and dc so far [N, Cip]
  CUtensorMap dres_map, dc_map;
  float* dres_out;           // [N, Rp]: gradient of the block input
  float* dc;                 // [N, Cip], summed over layers
  int N, step, layer, tiles;  // step = d·B rows
  Widths w;
  uint32_t key, keep24;
  float inv_keep, c_res;
  int drop, acc_dc, has_dres;
};

// An epilogue input's two stages of 64 f32 columns through the ring.
__device__ __forceinline__ void load_f32_tile(Ring& r, const CUtensorMap* m,
                                              int col0, int row0) {
  for (int c = 0; c < 128; c += 64) {
    unsigned char* st = r.produce(2 * SLAB);
    hop::tma_load(st, m, r.bar(), col0 + c, row0);
    hop::tma_load(st + SLAB, m, r.bar(), col0 + c + 32, row0);
    r.next();
  }
}

template <typename W>
__global__ void __launch_bounds__(NTHREADS, min_ctas<W>(false))
    bwd_dx_kernel(const __grid_constant__ DxArgs<W> a) {
  unsigned char* sm = smem_base();
  const Widths w = a.w;
  const int R = w.R, Rp = w.Rp, Cip = w.Cip, Gp = 2 * w.Chp;
  const int N = a.N;
  Ring ring(sm, kstage<W>(), min_ctas<W>(false));
  ring_init(sm, ring, 0, 0);

  if (threadIdx.x >= CONS) {
    if (threadIdx.x == CONS) {
      const bool f32 = sizeof(W) == 4;
      const CUtensorMap* clo = f32 ? &a.wconv_lo_map : nullptr;
      const CUtensorMap* ilo = f32 ? &a.wcin_lo_map : nullptr;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const int r0 = t * BM;
        for (int c0 = 0; c0 < Rp; c0 += 128) {
          for (int k = 0; k < 3; ++k)
            for (int k0 = 0; k0 < Gp; k0 += kd<W>())
              load_kmajor(ring, &a.dy_map, k0, r0 + (2 - k) * a.step,
                          &a.wconv_map, clo, k * Rp + c0, a.layer);
          if (a.has_dres) load_f32_tile(ring, &a.dres_map, c0, r0);
        }
        for (int n0 = 0; n0 < Cip; n0 += 128) {
          for (int k0 = 0; k0 < Gp; k0 += kd<W>())
            load_kmajor(ring, &a.dy_map, k0, r0, &a.wcin_map, ilo, n0,
                        a.layer);
          if (a.acc_dc) load_f32_tile(ring, &a.dc_map, n0, r0);
        }
      }
    }
    return;
  }

  const Lane ln;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const int r0 = t * BM;
    float acc[64];
    for (int c0 = 0; c0 < Rp; c0 += 128) {
      for (int q = 0; q < 3 * Gp; q += kd<W>()) {
        const unsigned char* st = ring.consume();
        Kmajor<W>::run(acc, st, ln, q == 0);
        ring.release();
      }
      // dres_out = c_res·dres + dropout · the taps' sum; dres from the
      // ring's two stages of 64 columns
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const unsigned char* st = a.has_dres ? ring.consume() : nullptr;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * e + jj, cs = 8 * jj + 2 * ln.tig;
          const int col = c0 + ln.col(j);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r0 + ln.row(hh);
            float2 r = make_float2(0.f, 0.f);
            if (a.has_dres)
              r = lds_pair(st + (cs >> 5) * SLAB, ln.row(hh), cs & 31,
                           (const float*)nullptr);
            if (row >= N) continue;
            float v[2] = {acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]};
            if (a.drop) {
#pragma unroll
              for (int q = 0; q < 2; ++q)
                v[q] = v[q] * keep_mult(a.key, row, col + q, a.keep24, R,
                                        a.inv_keep);
            }
            *reinterpret_cast<float2*>(a.dres_out + (size_t)row * Rp + col) =
                make_float2(a.c_res * r.x + v[0], a.c_res * r.y + v[1]);
          }
        }
        if (a.has_dres) ring.release();
      }
    }
    for (int n0 = 0; n0 < Cip; n0 += 128) {
      for (int k0 = 0; k0 < Gp; k0 += kd<W>()) {
        const unsigned char* st = ring.consume();
        Kmajor<W>::run(acc, st, ln, k0 == 0);
        ring.release();
      }
      // dc (+)= dy · W_cinᵀ; dc so far from the ring
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const unsigned char* st = a.acc_dc ? ring.consume() : nullptr;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * e + jj, cs = 8 * jj + 2 * ln.tig;
          const int col = n0 + ln.col(j);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r0 + ln.row(hh);
            float2 o = make_float2(0.f, 0.f);
            if (a.acc_dc)
              o = lds_pair(st + (cs >> 5) * SLAB, ln.row(hh), cs & 31,
                           (const float*)nullptr);
            if (row >= N || col >= Cip) continue;
            *reinterpret_cast<float2*>(a.dc + (size_t)row * Cip + col) =
                make_float2(o.x + acc[4 * j + 2 * hh],
                            o.y + acc[4 * j + 2 * hh + 1]);
          }
        }
        if (a.acc_dc) ring.release();
      }
    }
  }
}

// The weight gradients: product p is Σ_r P_p[r, :K1]ᵀ · Q_p[r + qoff, :K2]
// (Q rows past N read 0), cut into 128 × 128 output tiles, tiles
// tile0[p] .. tile0[p + 1] - 1 in row-major order of its tj[p] columns.
// CTA b takes tile b / splits over row split b mod splits (rows_per rows,
// a multiple of the stage depth) and writes its partial sum to
// part[(tile · splits + split) · 16384 ...] as a row-major 128 × 128 tile.
constexpr int NPROD = 5;

struct WgArgs {
  CUtensorMap pm[3];  // xd, cb, h: boxes kd() wide, wg_rows() deep
  CUtensorMap qm[2];  // dy, go
  int pi[NPROD], qi[NPROD], qoff[NPROD], tj[NPROD], tile0[NPROD + 1];
  int N, rows_per, splits;
  float* part;
};

template <typename W>
__global__ void __launch_bounds__(NTHREADS, min_ctas<W>(false))
    wgrad_kernel(const __grid_constant__ WgArgs a) {
  unsigned char* sm = smem_base();
  constexpr int RD = wg_rows<W>(), KD = kd<W>();
  const int tile = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
  int p = 0;
  while (tile >= a.tile0[p + 1]) ++p;
  const int lt = tile - a.tile0[p];
  const int i0 = (lt / a.tj[p]) * 128, j0 = (lt % a.tj[p]) * 128;
  const int rb = split * a.rows_per;
  const int re = rb + a.rows_per < a.N ? rb + a.rows_per : a.N;
  const int nst = (re - rb + RD - 1) / RD;
  Ring ring(sm, 2 * SLAB, min_ctas<W>(false), wg_scratch<W>());
  ring_init(sm, ring, 0, 0);

  if (threadIdx.x >= CONS) {
    if (threadIdx.x == CONS) {
      const CUtensorMap* pm = &a.pm[a.pi[p]];
      const CUtensorMap* qm = &a.qm[a.qi[p]];
      for (int s = 0; s < nst; ++s) {
        const int r = rb + s * RD;
        unsigned char* st = ring.produce();
#pragma unroll
        for (int q = 0; q < 128 / KD; ++q) {
          hop::tma_load(st + q * RD * 128, pm, ring.bar(), i0 + q * KD, r);
          hop::tma_load(st + SLAB + q * RD * 128, qm, ring.bar(),
                        j0 + q * KD, r + a.qoff[p]);
        }
        ring.next();
      }
    }
    return;
  }

  float acc[64];
  if constexpr (sizeof(W) == 2) {
    for (int s = 0; s < nst; ++s) {
      const unsigned char* st = ring.consume();
      Mnmajor<bf16>::run(acc, st, s == 0);
      ring.release();
    }
  } else {
    // stage s is transposed while stage s - 1's wgmmas run; the barrier
    // after each wait makes both warpgroups' reads of a buffer end before
    // either writes it again
    const Lane ln;
    unsigned char* scratch = ring.tail();
    float part[64];
    for (int s = 0; s < nst; ++s) {
      const unsigned char* st = ring.consume();
      unsigned char* buf = scratch + (s & 1) * WG_SCRATCH;
      Mnmajor<float>::transpose(st, buf);
      ring.release();
      hop::fence_proxy_async_shared();
      if (s > 0) {
        hop::wgmma_wait<0>();
        hop::reg_fence(part);
#pragma unroll
        for (int i = 0; i < 64; ++i)
          acc[i] = s == 1 ? part[i] : acc[i] + part[i];
      }
      hop::named_sync(1, CONS);
      Mnmajor<float>::issue(part, buf, ln);
    }
    hop::wgmma_wait<0>();
    hop::reg_fence(part);
#pragma unroll
    for (int i = 0; i < 64; ++i)
      acc[i] = nst == 1 ? part[i] : acc[i] + part[i];
  }
  Mnmajor<W>::store(acc,
                    a.part + ((size_t)tile * a.splits + split) * 16384);
}

// The fixed-order sums: every element of the weight gradients' tiles (the
// sum over `splits` partials) and of the column sums (over `bctas` gate
// CTAs). A block takes 32 elements; warp g sums the partials s ≡ g (mod
// 8) in order, then the 8 warps' sums add in order g = 0 .. 7.
struct RedArgs {
  const float* wpart;
  int splits, wtiles;
  float* dst[NPROD];
  int K1[NPROD], K2[NPROD], tj[NPROD], tile0[NPROD + 1];
  const float* bpart;
  int bctas, bw;
  float* bdst;
};

__global__ void __launch_bounds__(256) reduce_kernel(const RedArgs a) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const long long e = (long long)blockIdx.x * 32 + lane;
  const long long ew = (long long)a.wtiles * 16384;
  float s = 0.f;
  if (e < ew) {
    const long long tile = e >> 14, off = e & 16383;
    const float* src = a.wpart + tile * a.splits * 16384 + off;
    for (int k = g; k < a.splits; k += 8) s += src[(size_t)k * 16384];
  } else if (e < ew + a.bw) {
    const long long c = e - ew;
    for (int k = g; k < a.bctas; k += 8) s += a.bpart[(size_t)k * a.bw + c];
  }
  red[g][lane] = s;
  __syncthreads();
  if (g != 0) return;
  s = red[0][lane];
  for (int k = 1; k < 8; ++k) s += red[k][lane];
  if (e < ew) {
    const int tile = (int)(e >> 14), off = (int)(e & 16383);
    int p = 0;
    while (tile >= a.tile0[p + 1]) ++p;
    const int lt = tile - a.tile0[p];
    const int i = (lt / a.tj[p]) * 128 + (off >> 7);
    const int j = (lt % a.tj[p]) * 128 + (off & 127);
    if (i < a.K1[p]) a.dst[p][(size_t)i * a.K2[p] + j] = s;
  } else if (e < ew + a.bw) {
    a.bdst[e - ew] = s;
  }
}

// ------------------------------------------------------------------- host

int device_attr(cudaDeviceAttr what) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, what, dev);
  return v;
}

int sm_count() { return device_attr(cudaDevAttrMultiProcessorCount); }

// Lets the kernel take the card's whole opt-in shared memory, checks that
// a CTA with `smem` bytes fits, and, for a persistent kernel, sets its
// grid: as many CTAs as fit on the card at once, at most `tiles`.
template <typename K>
int prepare(K kernel, int smem, int tiles, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin));
  if (e != cudaSuccess) return (int)e;
  int per = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, NTHREADS,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per < 1) return 901;
  if (grid) {
    const int most = per * sm_count();
    *grid = tiles < most ? tiles : most;
  }
  return 0;
}

struct FwdPtrs {
  const void *x0, *cb, *w1, *w1_lo, *w2, *w2_lo, *b1, *skip_b, *out_b;
  void *acts, *skip, *h, *xd0, *xd1, *xa, *xb;
};

template <typename W, typename A>
int fwd_typed(const FwdPtrs& p, int N, int B, int L, const int* dil,
              const uint32_t* keys, const float* scales, Widths w,
              uint32_t keep24, float inv_keep, int drop, float c_res,
              cudaStream_t st, int* launches) {
  constexpr int es = sizeof(W), KD = kd<W>();
  const int Rp = w.Rp, Chp = w.Chp, Sp = w.Sp, Cip = w.Cip, Gp = 2 * Chp;
  const int AW = Rp > Chp ? Rp : Chp;
  const int tiles = (N + BM - 1) / BM;
  int rc;
#define TRY(x)         \
  if ((rc = (x)) != 0) \
  return rc
  FwdArgs<W, A> a{};
  CUtensorMap xdm[2];
  TRY(hop::make_map(&xdm[0], p.xd0, es, 2, 1, N, Rp, KD, BM));
  TRY(hop::make_map(&xdm[1], p.xd1, es, 2, 1, N, Rp, KD, BM));
  TRY(hop::make_map(&a.cb_map, p.cb, es, 2, 1, N, Cip, KD, BM));
  TRY(hop::make_map(&a.h_map, p.h, es, 2, 1, N, Chp, KD, BM));
  TRY(hop::make_map(&a.w1_map, p.w1, es, 3, L, Gp, 3 * Rp + Cip, KD, 64));
  TRY(hop::make_map(&a.w2_map, p.w2, es, 3, L, Sp + Rp, Chp, KD, 128));
  if (es == 4) {
    TRY(hop::make_map(&a.w1_lo_map, p.w1_lo, es, 3, L, Gp, 3 * Rp + Cip,
                      KD, 64));
    TRY(hop::make_map(&a.w2_lo_map, p.w2_lo, es, 3, L, Sp + Rp, Chp, KD,
                      128));
  }
  // stores: boxes of 64 rows
  CUtensorMap xout_st[2], xdn_st[2];
  const void* xb[2] = {p.xa, p.xb};
  const void* xdb[2] = {p.xd0, p.xd1};
  for (int i = 0; i < 2; ++i) {
    TRY(hop::make_map(&xout_st[i], xb[i], 4, 2, 1, N, Rp, 32, 64));
    TRY(hop::make_map(&xdn_st[i], xdb[i], es, 2, 1, N, Rp, KD, 64));
  }
  TRY(hop::make_map(&a.h_st, p.h, es, 2, 1, N, Chp, KD, 64));
  TRY(hop::make_map(&a.skip_st, p.skip, 4, 2, 1, N, Sp, 32, 64));
  TRY(hop::make_map(&a.skip_map, p.skip, 4, 2, 1, N, Sp, 32, BM));
  CUtensorMap xin[3];  // x0, xa, xb
  TRY(hop::make_map(&xin[0], p.x0, 4, 2, 1, N, Rp, 32, BM));
  for (int i = 0; i < 2; ++i)
    TRY(hop::make_map(&xin[1 + i], xb[i], 4, 2, 1, N, Rp, 32, BM));
  constexpr int ea = sizeof(A);
  TRY(hop::make_map(&a.acts_st, p.acts, ea, 3, 3LL * L, N, AW, 128 / ea, 64));
  const long long units = (long long)N * (Rp / 8);
  const int pre_grid = (int)((units + 255) / 256 < 8 * sm_count()
                                 ? (units + 255) / 256
                                 : 8 * sm_count());
  fwd_pre_kernel<W, A><<<pre_grid, 256, 0, st>>>(
      (const float*)p.x0, (A*)p.acts, (W*)xdb[0], N, w, keys[0], keep24,
      inv_keep, drop);
  TRY((int)cudaGetLastError());
  int n = 1;
  a.h_smem = Chp * BM * es <= H_SMEM_MAX;
  const int smem = smem_bytes(kstage<W>(), min_ctas<W>(true),
                              fwd_extra(a.h_smem, Chp * BM * es));
  int grid = 0;
  TRY(prepare(fwd_layer_kernel<W, A>, smem, tiles, &grid));
  a.N = N;
  a.tiles = tiles;
  a.w = w;
  a.keep24 = keep24;
  a.inv_keep = inv_keep;
  a.c_res = c_res;
  a.drop = drop;
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    a.xd_map = xdm[l % 2];
    if (!last) {
      a.xout_st = xout_st[l % 2];
      a.xdn_st = xdn_st[(l + 1) % 2];
    }
    a.xin_map = xin[l ? 1 + (l - 1) % 2 : 0];
    a.b1 = (const float*)p.b1 + (size_t)l * Gp;
    a.skip_b = (const float*)p.skip_b + (size_t)l * Sp;
    a.out_b = (const float*)p.out_b + (size_t)l * Rp;
    a.step = dil[l] * B;
    a.layer = l;
    a.first = l == 0;
    a.last = last;
    a.key_next = last ? 0u : keys[l + 1];
    a.scale = scales[l];
    fwd_layer_kernel<W, A><<<grid, NTHREADS, smem, st>>>(a);
    TRY((int)cudaGetLastError());
    ++n;
  }
  *launches = n;
  return 0;
#undef TRY
}

struct BwdPtrs {
  const void *dres, *dskip, *acts, *cb, *wos, *wcin, *wconv;
  const void *wos_lo, *wcin_lo, *wconv_lo;  // TF32 lo planes, f32 only
  void *go, *dy, *xd, *h, *dc, *bpart, *wpart, *dres_out, *d_conv, *d_cin,
      *d_os, *sums;
};

struct BwdDims {
  int N, B, d, layer, L;
  Widths w;
  uint32_t key, keep24;
  float inv_keep, scale, c_res;
  int drop, acc_dc, rows_per, splits;
};

template <typename W, typename A>
int bwd_layer_typed(const BwdPtrs& p, const BwdDims& d, cudaStream_t st,
                    int* launches) {
  constexpr int es = sizeof(W), KD = kd<W>(), RD = wg_rows<W>();
  const Widths w = d.w;
  const int Rp = w.Rp, Chp = w.Chp, Sp = w.Sp, Cip = w.Cip;
  const int NG = Rp + Sp, Gp = 2 * Chp, N = d.N;
  const int tiles = (N + BM - 1) / BM;
  int rc;
#define TRY(x)         \
  if ((rc = (x)) != 0) \
  return rc

  GateArgs<W, A> g{};
  TRY(hop::make_map(&g.go_map, p.go, es, 2, 1, N, NG, KD, BM));
  TRY(hop::make_map(&g.wos_map, p.wos, es, 3, d.L, Chp, NG, KD, 128));
  if (es == 4)
    TRY(hop::make_map(&g.wos_lo_map, p.wos_lo, es, 3, d.L, Chp, NG, KD,
                      128));
  g.has_dres = p.dres != nullptr;
  if (g.has_dres)
    TRY(hop::make_map(&g.dres_map, p.dres, 4, 2, 1, N, Rp, 32, BM));
  TRY(hop::make_map(&g.dskip_map, p.dskip, 4, 2, 1, N, Sp, 32, BM));
  TRY(hop::make_map(&g.acts_map, p.acts, (int)sizeof(A), 3, 3, N,
                    Rp > Chp ? Rp : Chp, 128 / (int)sizeof(A), BM));
  TRY(hop::make_map(&g.h_st, p.h, es, 2, 1, N, Chp, KD, 64));
  TRY(hop::make_map(&g.dy_st, p.dy, es, 2, 1, N, Gp, KD, 64));
  g.go = (W*)p.go;
  g.dy = (W*)p.dy;
  g.xd = (W*)p.xd;
  g.h = (W*)p.h;
  g.bpart = (float*)p.bpart;
  g.N = N;
  g.layer = d.layer;
  g.tiles = tiles;
  g.w = w;
  g.key = d.key;
  g.keep24 = d.keep24;
  g.inv_keep = d.inv_keep;
  g.scale = d.scale;
  g.c_res = d.c_res;
  g.drop = d.drop;
  const int gsmem =
      smem_bytes(kstage<W>(), min_ctas<W>(true),
                 gate_extra(Gp + NG, sizeof(A) == 2 && es == 2));
  int ggrid = 0;
  TRY(prepare(bwd_gate_kernel<W, A>, gsmem, tiles, &ggrid));
  bwd_gate_kernel<W, A><<<ggrid, NTHREADS, gsmem, st>>>(g);
  TRY((int)cudaGetLastError());
  int n = 1;

  DxArgs<W> x{};
  TRY(hop::make_map(&x.dy_map, p.dy, es, 2, 1, N, Gp, KD, BM));
  TRY(hop::make_map(&x.wconv_map, p.wconv, es, 3, d.L, 3 * Rp, Gp, KD, 128));
  TRY(hop::make_map(&x.wcin_map, p.wcin, es, 3, d.L, Cip, Gp, KD, 128));
  if (es == 4) {
    TRY(hop::make_map(&x.wconv_lo_map, p.wconv_lo, es, 3, d.L, 3 * Rp, Gp,
                      KD, 128));
    TRY(hop::make_map(&x.wcin_lo_map, p.wcin_lo, es, 3, d.L, Cip, Gp, KD,
                      128));
  }
  x.has_dres = p.dres != nullptr;
  if (x.has_dres)
    TRY(hop::make_map(&x.dres_map, p.dres, 4, 2, 1, N, Rp, 32, BM));
  TRY(hop::make_map(&x.dc_map, p.dc, 4, 2, 1, N, Cip, 32, BM));
  x.dres_out = (float*)p.dres_out;
  x.dc = (float*)p.dc;
  x.N = N;
  x.step = d.d * d.B;
  x.layer = d.layer;
  x.tiles = tiles;
  x.w = w;
  x.key = d.key;
  x.keep24 = d.keep24;
  x.inv_keep = d.inv_keep;
  x.c_res = d.c_res;
  x.drop = d.drop;
  x.acc_dc = d.acc_dc;
  int xgrid = 0;
  const int xsmem = smem_bytes(kstage<W>(), min_ctas<W>(false), 0);
  TRY(prepare(bwd_dx_kernel<W>, xsmem, tiles, &xgrid));
  bwd_dx_kernel<W><<<xgrid, NTHREADS, xsmem, st>>>(x);
  TRY((int)cudaGetLastError());
  ++n;

  WgArgs a{};
  TRY(hop::make_map(&a.pm[0], p.xd, es, 2, 1, N, Rp, KD, RD));
  TRY(hop::make_map(&a.pm[1], p.cb, es, 2, 1, N, Cip, KD, RD));
  TRY(hop::make_map(&a.pm[2], p.h, es, 2, 1, N, Chp, KD, RD));
  TRY(hop::make_map(&a.qm[0], p.dy, es, 2, 1, N, Gp, KD, RD));
  TRY(hop::make_map(&a.qm[1], p.go, es, 2, 1, N, NG, KD, RD));
  RedArgs r{};
  const int K1[NPROD] = {Rp, Rp, Rp, Cip, Chp};
  const int K2[NPROD] = {Gp, Gp, Gp, Gp, NG};
  float* dst[NPROD] = {(float*)p.d_conv, (float*)p.d_conv + (size_t)Rp * Gp,
                       (float*)p.d_conv + 2 * (size_t)Rp * Gp,
                       (float*)p.d_cin, (float*)p.d_os};
  int t0 = 0;
  for (int q = 0; q < NPROD; ++q) {
    a.pi[q] = q < 3 ? 0 : q - 2;
    a.qi[q] = q < 4 ? 0 : 1;
    a.qoff[q] = q < 3 ? (2 - q) * d.d * d.B : 0;
    a.tj[q] = r.tj[q] = K2[q] / 128;
    a.tile0[q] = r.tile0[q] = t0;
    t0 += ((K1[q] + 127) / 128) * (K2[q] / 128);
    r.dst[q] = dst[q];
    r.K1[q] = K1[q];
    r.K2[q] = K2[q];
  }
  a.tile0[NPROD] = r.tile0[NPROD] = t0;
  a.N = N;
  a.rows_per = d.rows_per;
  a.splits = d.splits;
  a.part = (float*)p.wpart;
  const int wsmem = smem_bytes(2 * SLAB, min_ctas<W>(false), wg_scratch<W>());
  TRY(prepare(wgrad_kernel<W>, wsmem, 0, nullptr));
  wgrad_kernel<W><<<t0 * d.splits, NTHREADS, wsmem, st>>>(a);
  TRY((int)cudaGetLastError());
  ++n;

  r.wpart = (const float*)p.wpart;
  r.splits = d.splits;
  r.wtiles = t0;
  r.bpart = (const float*)p.bpart;
  r.bctas = ggrid;
  r.bw = Gp + NG;
  r.bdst = (float*)p.sums;
  const long long elems = (long long)t0 * 16384 + Gp + NG;
  reduce_kernel<<<(unsigned)((elems + 31) / 32), 256, 0, st>>>(r);
  TRY((int)cudaGetLastError());
  ++n;
  *launches = n;
  return 0;
#undef TRY
}

// A K-major product alone, out[M, Nc] = A[M, K] · B[Nc, K]ᵀ (f32 out; M
// any, Nc a multiple of 128, K a multiple of kd): the ring and Kmajor.
template <typename W>
struct MmArgs {
  CUtensorMap a_map, b_map, b_lo_map;
  float* out;
  int M, Nc, K, tiles;
};

template <typename W>
__global__ void __launch_bounds__(NTHREADS, min_ctas<W>(false))
    mm_test_kernel(const __grid_constant__ MmArgs<W> a) {
  unsigned char* sm = smem_base();
  Ring ring(sm, kstage<W>(), min_ctas<W>(false));
  ring_init(sm, ring, 0, 0);
  if (threadIdx.x >= CONS) {
    if (threadIdx.x == CONS) {
      const CUtensorMap* lo = sizeof(W) == 4 ? &a.b_lo_map : nullptr;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x)
        for (int n0 = 0; n0 < a.Nc; n0 += 128)
          for (int k0 = 0; k0 < a.K; k0 += kd<W>())
            load_kmajor(ring, &a.a_map, k0, t * BM, &a.b_map, lo, n0, 0);
    }
    return;
  }
  const Lane ln;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x)
    for (int n0 = 0; n0 < a.Nc; n0 += 128) {
      float acc[64];
      for (int k0 = 0; k0 < a.K; k0 += kd<W>()) {
        const unsigned char* st = ring.consume();
        Kmajor<W>::run(acc, st, ln, k0 == 0);
        ring.release();
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = t * BM + ln.row(hh);
          if (row < a.M)
            *reinterpret_cast<float2*>(a.out + (size_t)row * a.Nc + n0 +
                                       ln.col(j)) =
                make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        }
    }
}

template <typename W>
int mm_test_typed(const void* A, const void* B, const void* B_lo, void* out,
                  int M, int Nc, int K, cudaStream_t st) {
  constexpr int es = sizeof(W), KD = kd<W>();
  MmArgs<W> a{};
  int rc = hop::make_map(&a.a_map, A, es, 2, 1, M, K, KD, BM);
  if (!rc) rc = hop::make_map(&a.b_map, B, es, 3, 1, Nc, K, KD, 128);
  if (!rc && es == 4)
    rc = hop::make_map(&a.b_lo_map, B_lo, es, 3, 1, Nc, K, KD, 128);
  if (rc) return rc;
  a.out = (float*)out;
  a.M = M;
  a.Nc = Nc;
  a.K = K;
  a.tiles = (M + BM - 1) / BM;
  int grid = 0;
  const int smem = smem_bytes(kstage<W>(), min_ctas<W>(false), 0);
  rc = prepare(mm_test_kernel<W>, smem, a.tiles, &grid);
  if (rc) return rc;
  mm_test_kernel<W><<<grid, NTHREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// A weight gradient alone, out[K1, K2] = Σ_r P[r, :K1]ᵀ · Q[r + qoff, :K2]
// through the wgrad and reduce kernels (one product).
template <typename W>
int wgrad_test_typed(const void* P, const void* Q, void* out, void* part,
                     int rows, int K1, int K2, int qoff, int rows_per,
                     int splits, cudaStream_t st) {
  constexpr int es = sizeof(W), KD = kd<W>(), RD = wg_rows<W>();
  WgArgs a{};
  RedArgs r{};
  int rc = hop::make_map(&a.pm[0], P, es, 2, 1, rows, K1, KD, RD);
  if (!rc) rc = hop::make_map(&a.qm[0], Q, es, 2, 1, rows, K2, KD, RD);
  if (rc) return rc;
  const int t0 = ((K1 + 127) / 128) * (K2 / 128);
  for (int q = 0; q < NPROD; ++q) {
    a.tj[q] = r.tj[q] = K2 / 128;
    a.tile0[q] = r.tile0[q] = q == 0 ? 0 : t0;
    a.qoff[q] = qoff;
    r.dst[q] = (float*)out;
    r.K1[q] = K1;
    r.K2[q] = K2;
  }
  a.tile0[NPROD] = r.tile0[NPROD] = t0;
  a.N = rows;
  a.rows_per = rows_per;
  a.splits = splits;
  a.part = (float*)part;
  const int smem = smem_bytes(2 * SLAB, min_ctas<W>(false), wg_scratch<W>());
  rc = prepare(wgrad_kernel<W>, smem, 0, nullptr);
  if (rc) return rc;
  wgrad_kernel<W><<<t0 * splits, NTHREADS, smem, st>>>(a);
  if ((rc = (int)cudaGetLastError())) return rc;
  r.wpart = (const float*)part;
  r.splits = splits;
  r.wtiles = t0;
  reduce_kernel<<<(unsigned)(((long long)t0 * 16384 + 31) / 32), 256, 0,
                  st>>>(r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One layer of the backward in 4 launches (written to *launches): the
// weights are the whole stack's ([L, ...], as the wrapper lays them out),
// the gradients this layer's; with f32 weights also their TF32 lo planes
// (`split_tf32` of the wrapper), else null. Widths: R (the hash's), then
// the padded R, Ch, S, cin (R, Ch, S multiples of 128, cin of 16). w_f32 /
// a_f32: f32 weights / saved activations, else bf16. `bpart` holds ceil(N / 128)
// rows of Gp + Rp + Sp floats, `wpart` splits · (weight-gradient tiles) ·
// 16,384.
int wn_bwd_layer(const void* dres, const void* dskip, const void* acts,
                 const void* cb, const void* wos, const void* wcin,
                 const void* wconv, const void* wos_lo, const void* wcin_lo,
                 const void* wconv_lo, void* go, void* dy, void* xd, void* h,
                 void* dc, void* bpart, void* wpart, void* dres_out,
                 void* d_conv, void* d_cin, void* d_os, void* sums, int N,
                 int B, int d, int layer, int L, int R, int Rp, int Chp,
                 int Sp, int Cip, uint32_t key, uint32_t keep24,
                 float inv_keep, int drop, float scale, float c_res,
                 int acc_dc, int rows_per, int splits, int w_f32, int a_f32,
                 void* stream, int* launches) {
  const BwdPtrs p{dres, dskip, acts, cb, wos, wcin, wconv, wos_lo, wcin_lo,
                  wconv_lo, go, dy, xd, h,
                  dc, bpart, wpart, dres_out, d_conv, d_cin, d_os, sums};
  const BwdDims m{N, B, d, layer, L, Widths{R, Rp, Chp, Sp, Cip}, key,
                  keep24, inv_keep, scale, c_res, drop, acc_dc, rows_per,
                  splits};
  cudaStream_t st = (cudaStream_t)stream;
  if (w_f32)
    return a_f32 ? bwd_layer_typed<float, float>(p, m, st, launches)
                 : bwd_layer_typed<float, bf16>(p, m, st, launches);
  return a_f32 ? bwd_layer_typed<bf16, float>(p, m, st, launches)
               : bwd_layer_typed<bf16, bf16>(p, m, st, launches);
}

// The mainloop alone (tests): out[M, Nc] = A[M, K] · B[Nc, K]ᵀ in f32
// (f32: B as its TF32 hi and lo planes).
int wn_mm_test(const void* A, const void* B, const void* B_lo, void* out,
               int M, int Nc, int K, int w_f32, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return w_f32 ? mm_test_typed<float>(A, B, B_lo, out, M, Nc, K, st)
               : mm_test_typed<bf16>(A, B, B_lo, out, M, Nc, K, st);
}

// The weight-gradient route alone (tests): out[K1, K2] = Σ_r P[r]ᵀ·Q[r +
// qoff]; part holds splits · ceil(K1 / 128) · K2 / 128 · 16,384 floats.
int wn_wgrad_test(const void* P, const void* Q, void* out, void* part,
                  int rows, int K1, int K2, int qoff, int rows_per,
                  int splits, int w_f32, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return w_f32 ? wgrad_test_typed<float>(P, Q, out, part, rows, K1, K2, qoff,
                                         rows_per, splits, st)
               : wgrad_test_typed<bf16>(P, Q, out, part, rows, K1, K2, qoff,
                                        rows_per, splits, st);
}


// The whole forward: a pre-pass, then one launch a layer (the count in
// *launches). x0 [N, Rp] f32; cb [N, Cip]; w1 [L, Gp, 3·Rp + Cip] (taps
// and cin, transposed), w2 [L, Sp + Rp, Chp] (skip | out, transposed), in
// W, with f32 weights also their TF32 lo planes (else null); b1 [L, Gp],
// skip_b [L, Sp], out_b [L, Rp] f32. Writes acts [L, 3, N, AW] and skip
// [N, Sp]; h, xd0, xd1 ([N, Chp], [N, Rp] in W) and xa, xb ([N, Rp] f32)
// are scratch. dil, keys, scales: the layers' dilations, dropout keys and
// skip scales (host arrays).
int wn_fwd(const void* x0, const void* cb, const void* w1, const void* w1_lo,
           const void* w2, const void* w2_lo, const void* b1,
           const void* skip_b, const void* out_b, void* acts, void* skip,
           void* h, void* xd0, void* xd1, void* xa, void* xb, int N, int B,
           int L, const int* dil, const uint32_t* keys, const float* scales,
           int R, int Rp, int Chp, int Sp, int Cip, uint32_t keep24,
           float inv_keep, int drop, float c_res, int w_f32, int a_f32,
           void* stream, int* launches) {
  const FwdPtrs p{x0,  cb,   w1, w1_lo, w2,  w2_lo, b1, skip_b,
                  out_b, acts, skip, h,  xd0, xd1, xa, xb};
  const Widths w{R, Rp, Chp, Sp, Cip};
  cudaStream_t st = (cudaStream_t)stream;
#define WN_FWD(W_, A_)                                                    \
  fwd_typed<W_, A_>(p, N, B, L, dil, keys, scales, w, keep24, inv_keep, \
                    drop, c_res, st, launches)
  if (w_f32) return a_f32 ? WN_FWD(float, float) : WN_FWD(float, bf16);
  return a_f32 ? WN_FWD(bf16, float) : WN_FWD(bf16, bf16);
#undef WN_FWD
}

}  // extern "C"
