// Griffin-Lim phase reconstruction, all iterations for a batch [B, F, K].
//
// Replaces the TPU kernel tacotron2_tpu/ops/griffin_lim_kernel.py
// `build_griffin_lim_kernel` (pallas_call at :158). Semantics are those of
// tacotron2_tpu/ops/griffin_lim.py:griffin_lim (the plain version here is
// tacotron2_tpu_torch/ops/griffin_lim_kernel.py:griffin_lim_plain):
//
//   y = iSTFT(re0, im0)
//   repeat iters: est = STFT(y); y = iSTFT(S · est / max(|est|, 1e-8))
//
// with librosa's centred frames, the periodic Hann window of win samples
// centred in n_fft, the window-sum-square normalisation and the centre trim.
// The TPU kernel folded overlap-add and re-framing into 0/1 shift matrices
// because Mosaic has no offset slices; here they are index arithmetic.
//
// Design. Every iteration is two f32 products over the window's support
// (W = win samples of each n_fft frame; the padded window is zero outside
// it, so this is exact), each one launch of one tiled GEMM kernel:
//
//   synthesis  frames[b, f, j] = sum_kk A[b, f, kk] · Bsyn[kk, j]
//              A = [re | im] (2K columns); with `project` set, A is made
//              while the tile is loaded: S·est/max(|est|, 1e-8) from the
//              previous analysis (the magnitude projection costs no pass);
//              Bsyn = [window·ci ; -window·si] restricted to the support;
//   overlap-add  y[b, n] = g[n] · sum_f frames[b, f, n - f·hop - lpad],
//              g = 1/window-sum-square inside the centre-trimmed span and 0
//              outside it (the next STFT re-pads with zeros there);
//   analysis   est[b, f, kk] = sum_j y[b, f·hop + lpad + j] · Bana[j, kk],
//              Bana = [window·cos | -window·sin] over the support, so the
//              re-framing is the A tile's load.
//
// The GEMM runs on the tensor cores in TF32 with each f32 operand split
// into two TF32 parts ("3xTF32": hi·hi + hi·lo + lo·hi), which keeps each
// operand to ~2^-22 of itself (one TF32 product alone keeps ~3 digits, too
// few against the f32 plain version): 128×128 tiles a CTA of 8 warps,
// mma.sync m16n8k8. Each 8-deep step's three products go into a zeroed
// fragment that an f32 add (round to nearest) adds to the running sum: the
// tensor cores' own accumulation rounds toward zero, and summed in them
// over the 257 steps of a 2K-deep product the samples lay ~20× farther
// from float64 than the f32 plain version's; with the adds, ~2× (PERF.md).
//
// Bound: the function needs 2·iters+1 real transforms of n_fft points a
// frame; as FFTs (~2.5·n·log2(n) operations each) that is under 1/50 of
// the dense DFT products here, so its floor lies far below this design's:
// 2·iters+1 products of 2·F·W·2K operations a row, three TF32 products
// each, at the tensor cores' TF32 rate (chip_smoke.py prints both). A
// per-frame FFT is the design that reaches for the first. This version is
// latency-bound besides: each 16-deep slice is loaded (through the
// projection for A), stored and synchronised before its products, and
// only the other CTA on the SM overlaps that wait. It is 7% faster than
// the first, f32-FMA tiling (14% before the f32 adds); fetching the next slice into registers during
// the products cost a CTA per SM and was 40% slower (PERF.md). An
// async-copy pipeline with the projection in its own pass is the next step.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int BM = 128, BN = 128, BK = 16;

// A operand of the synthesis product: [re | im] of the current estimate.
struct SynA {
  const float* est;  // [B, F, 2K]: initial (re | im), or the last analysis
  const float* S;    // [B, F, K] target magnitude
  int F, K;
  int project;       // 1: apply the magnitude projection on load
  __device__ __forceinline__ float operator()(int b, int f, int kk) const {
    const int K2 = 2 * K;
    if (f >= F || kk >= K2) return 0.f;
    const float* row = est + ((size_t)b * F + f) * K2;
    if (!project) return row[kk];
    const int k = kk < K ? kk : kk - K;
    const float er = row[k], ei = row[K + k];
    const float mag = fmaxf(sqrtf(er * er + ei * ei), 1e-8f);
    const float s = S[((size_t)b * F + f) * K + k];
    return s * (kk < K ? er : ei) / mag;
  }
};

// A operand of the analysis product: the frames of the normalised signal.
struct AnaA {
  const float* y;  // [B, total]
  int F, W, hop, lpad, total;
  __device__ __forceinline__ float operator()(int b, int f, int j) const {
    if (f >= F || j >= W) return 0.f;
    return y[(size_t)b * total + (size_t)f * hop + lpad + j];
  }
};

// C[b] (M×N) = A[b] (M×Kd, through the loader) · Bm (Kd×N, row-major).
// A CTA of 8 warps computes a 128×128 tile from 16-deep slices of A and B
// staged k-major in shared memory (a row pitch of 136 floats makes every
// fragment load free of bank conflicts); each warp owns 64×32 of the tile,
// 4×4 tensor-core tiles of 16×8, and runs each k8 step as three TF32
// products per tile (split_tf32).
template <class ALoad>
__global__ void __launch_bounds__(NT, 2)
    gemm_kernel(const ALoad al, const float* __restrict__ Bm,
                float* __restrict__ C, int M, int N, int Kd) {
  __shared__ float As[BK][BM + 8];
  __shared__ float Bs[BK][BN + 8];
  const int b = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;           // fragment coordinates
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int am = tid >> 1, ak = (tid & 1) * 8;     // A slice: row, 8 k
  const int bk = tid >> 4, bn = (tid & 15) * 8;    // B slice: k, 8 columns
  for (int k0 = 0; k0 < Kd; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) As[ak + i][am] = al(b, m0 + am, k0 + ak + i);
    const int kk = k0 + bk;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int nn = n0 + bn + i;
      Bs[bk][bn + i] = (kk < Kd && nn < N) ? Bm[(size_t)kk * N + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k8 = 0; k8 < BK; k8 += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + g;
        taco::split_tf32(Bs[k8 + t][n], bh[j][0], bl[j][0]);
        taco::split_tf32(Bs[k8 + t + 4][n], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm + i * 16 + g;
        uint32_t ah[4], alo[4];
        taco::split_tf32(As[k8 + t][m], ah[0], alo[0]);
        taco::split_tf32(As[k8 + t][m + 8], ah[1], alo[1]);
        taco::split_tf32(As[k8 + t + 4][m], ah[2], alo[2]);
        taco::split_tf32(As[k8 + t + 4][m + 8], ah[3], alo[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          taco::mma_3xtf32(acc[i][j], ah, alo, bh[j], bl[j]);
      }
    }
    __syncthreads();
  }
  float* Cb = C + (size_t)b * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + 2 * t + e;
          if (n < N) Cb[(size_t)m * N + n] = acc[i][j][2 * h + e];
        }
    }
}

// y[b, n] = g[n] · sum over the frames f covering n of frames[b, f, n -
// f·hop - lpad], in increasing f.
__global__ void __launch_bounds__(NT)
    overlap_add_kernel(const float* __restrict__ frames,
                       const float* __restrict__ g, float* __restrict__ y,
                       int F, int W, int hop, int lpad, int total) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * NT + threadIdx.x;
  if (n >= total) return;
  float s = 0.f;
  const int rel = n - lpad;  // n - f·hop - lpad must lie in [0, W)
  if (g[n] != 0.f && rel >= 0) {
    int f_lo = rel - W + 1 <= 0 ? 0 : (rel - W + 1 + hop - 1) / hop;
    int f_hi = rel / hop;
    if (f_hi > F - 1) f_hi = F - 1;
    const float* fb = frames + (size_t)b * F * W;
    for (int f = f_lo; f <= f_hi; ++f)
      s += fb[(size_t)f * W + (rel - f * hop)];
  }
  y[(size_t)b * total + n] = s * g[n];
}

int launch_synthesis(const float* est, const float* S, int project,
                     const float* bsyn, float* frames, int B, int F, int K,
                     int W, cudaStream_t st) {
  SynA al{est, S, F, K, project};
  dim3 grid((W + BN - 1) / BN, (F + BM - 1) / BM, B);
  gemm_kernel<SynA><<<grid, NT, 0, st>>>(al, bsyn, frames, F, W, 2 * K);
  return (int)cudaGetLastError();
}

int launch_ola(const float* frames, const float* g, float* y, int B, int F,
               int W, int hop, int lpad, int total, cudaStream_t st) {
  dim3 grid((total + NT - 1) / NT, B);
  overlap_add_kernel<<<grid, NT, 0, st>>>(frames, g, y, F, W, hop, lpad,
                                          total);
  return (int)cudaGetLastError();
}

}  // namespace

// One call runs the whole reconstruction on `stream`:
//   reim0 [B, F, 2K] initial (re | im); S [B, F, K]; bsyn [2K, W];
//   bana [W, 2K]; g [total]; scratch frames [B, F, W], est [B, F, 2K];
//   y [B, total] (total = n_fft + hop·(F-1)) receives the last
//   overlap-add, whose centre-trimmed span [n_fft/2, n_fft/2 + hop·(F-1))
//   is the waveform. Returns the first CUDA error code, or 0.
extern "C" int taco_griffin_lim_launch(
    const void* reim0, const void* S, const void* bsyn, const void* bana,
    const void* g, void* frames, void* est, void* y, int B, int F, int K,
    int W, int hop, int lpad, int n_fft, int iters, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int total = n_fft + hop * (F - 1);
  const float* Sf = (const float*)S;
  float* fr = (float*)frames;
  float* es = (float*)est;
  float* yy = (float*)y;
  int rc = launch_synthesis((const float*)reim0, Sf, 0, (const float*)bsyn,
                            fr, B, F, K, W, st);
  if (rc) return rc;
  rc = launch_ola(fr, (const float*)g, yy, B, F, W, hop, lpad, total, st);
  if (rc) return rc;
  for (int it = 0; it < iters; ++it) {
    AnaA al{yy, F, W, hop, lpad, total};
    dim3 grid((2 * K + BN - 1) / BN, (F + BM - 1) / BM, B);
    gemm_kernel<AnaA><<<grid, NT, 0, st>>>(al, (const float*)bana, es, F,
                                           2 * K, W);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    rc = launch_synthesis(es, Sf, 1, (const float*)bsyn, fr, B, F, K, W, st);
    if (rc) return rc;
    rc = launch_ola(fr, (const float*)g, yy, B, F, W, hop, lpad, total, st);
    if (rc) return rc;
  }
  return 0;
}
