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
// Bound: the function needs 2·iters+1 real transforms of n_fft points a
// frame; as FFTs (~2.5·n·log2(n) operations each, `griffin_lim_flops` in
// chip_smoke.py) at the f32 rate, which the bytes (S, the start and the
// waveform once) undercut. Two routes, chosen by shape alone:
//
// FFT route (n_fft a power of two: every preset). Each transform is a real
// FFT of n_fft points in shared memory, one CTA a frame: an M = n_fft/2
// point complex FFT (Stockham passes, radix 4, and one radix-2 pass when
// log2(M) is odd) plus the real-input twiddle step, in f32, with the
// twiddles e^{-2πi t/n_fft} from one table made in float64 on the host and
// rounded to f32 once. Two launches an iteration:
//
//   analysis   for each frame: its W = win support samples of y, each the
//              overlap-add of the <= ceil(W/hop) synthesized frames that
//              cover it (in increasing frame order, times g = the inverse
//              window-sum-square inside the centre-trimmed span, 0
//              outside), so no y pass exists; times the window, zero-padded
//              to n_fft; the forward real FFT; the magnitude projection
//              S · X / max(|X|, 1e-8) as its epilogue; the projected
//              spectrum [B, F, 2K] (re | im) written;
//   synthesis  for each frame: that spectrum (or the start), the inverse
//              real FFT, the window over the support; [B, F, W] written.
//
// The last synthesis is followed by one overlap-add into y (the same
// per-sample sum, so its samples are those the analysis saw). The working
// set (frames and spectra, ~29 MB at [8, 321, 1025]) stays in the 50 MB L2;
// every sum has a fixed order and there are no atomics, so reruns repeat
// bit for bit. Per frame a transform costs ~5 shared-memory passes of
// n_fft/8 butterflies a thread pair, far below the dense products below.
//
// DFT route (any other n_fft). Every iteration is two f32 products over the
// window's support (W = win samples of each n_fft frame; the padded window
// is zero outside it, so this is exact), each one launch of one tiled GEMM
// kernel:
//
//   synthesis  frames[b, f, j] = sum_kk A[b, f, kk] · Bsyn[kk, j]
//              A = [re | im] (2K columns); with `project` set, A is made
//              while the tile is loaded: S·est/max(|est|, 1e-8) from the
//              previous analysis (the magnitude projection costs no pass);
//              Bsyn = [window·ci ; -window·si] restricted to the support;
//   overlap-add  y[b, n] = g[n] · sum_f frames[b, f, n - f·hop - lpad];
//   analysis   est[b, f, kk] = sum_j y[b, f·hop + lpad + j] · Bana[j, kk],
//              Bana = [window·cos | -window·sin] over the support, so the
//              re-framing is the A tile's load.
//
// The GEMM runs on the tensor cores in TF32 with each f32 operand split
// into two TF32 parts ("3xTF32": hi·hi + hi·lo + lo·hi), which keeps each
// operand to ~2^-22 of itself: 128×128 tiles a CTA of 8 warps, mma.sync
// m16n8k8, each 8-deep step's three products added in f32 (round to
// nearest; the tensor cores' own accumulation truncates). Its dense
// products are 2·iters+1 of 2·F·W·2K operations a row, over 50× the
// transforms as FFTs, and its tile loop is latency-bound (PERF.md).
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

// g[n] · sum over the frames f covering sample n of the padded signal of
// frames[f, n - f·hop - lpad] (fb: one row's [F, W] frames), in increasing
// f: the overlap-add of both routes, and of the FFT route's analysis.
__device__ __forceinline__ float ola_at(const float* __restrict__ fb,
                                        const float* __restrict__ g, int n,
                                        int F, int W, int hop, int lpad) {
  const float gn = g[n];
  const int rel = n - lpad;  // n - f·hop - lpad must lie in [0, W)
  float s = 0.f;
  if (gn != 0.f && rel >= 0) {
    const int f_lo = rel - W + 1 <= 0 ? 0 : (rel - W + 1 + hop - 1) / hop;
    const int f_hi = min(rel / hop, F - 1);
    for (int f = f_lo; f <= f_hi; ++f) s += fb[(size_t)f * W + (rel - f * hop)];
  }
  return s * gn;
}

// y[b, n] = ola_at(frames[b], n) for every sample n of the padded signal.
__global__ void __launch_bounds__(NT)
    overlap_add_kernel(const float* __restrict__ frames,
                       const float* __restrict__ g, float* __restrict__ y,
                       int F, int W, int hop, int lpad, int total) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * NT + threadIdx.x;
  if (n >= total) return;
  y[(size_t)b * total + n] =
      ola_at(frames + (size_t)b * F * W, g, n, F, W, hop, lpad);
}

// ------------------------------------------------------------ FFT route

constexpr int FT = 256;  // threads of an FFT CTA (one frame)

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Forward DFT of M = 2^m points held in `a` (Z[k] = sum_j z[j]
// e^{-2πi jk/M}) by Stockham passes: radix 4 while 4 divides the
// remaining length n, then one radix-2 pass if m is odd; pass p reads one
// buffer and writes the other (a, b: M points each). tw[t] = e^{-2πi t /
// (2M)}, so w_n^p = e^{-2πi p s / M} = tw[2ps] with s = M/n. Called by
// every thread of the CTA; returns the buffer that holds the result, after
// a __syncthreads().
__device__ float2* fft_forward(float2* a, float2* b, int M,
                               const float2* __restrict__ tw) {
  int n = M, s = 1, ls = 0;  // s = 2^ls
  while (n > 1) {
    if (n >= 4) {
      const int n4 = n >> 2;
      for (int i = threadIdx.x; i < (M >> 2); i += FT) {
        const int p = i >> ls, q = i & (s - 1);
        const float2 A = a[q + s * p], B = a[q + s * (p + n4)];
        const float2 C = a[q + s * (p + 2 * n4)], D = a[q + s * (p + 3 * n4)];
        const float2 apc = make_float2(A.x + C.x, A.y + C.y);
        const float2 amc = make_float2(A.x - C.x, A.y - C.y);
        const float2 bpd = make_float2(B.x + D.x, B.y + D.y);
        // -i·(B - D)
        const float2 jb = make_float2(B.y - D.y, D.x - B.x);
        const int e = 2 * p * s;
        b[q + s * 4 * p] = make_float2(apc.x + bpd.x, apc.y + bpd.y);
        b[q + s * (4 * p + 1)] =
            cmul(tw[e], make_float2(amc.x + jb.x, amc.y + jb.y));
        b[q + s * (4 * p + 2)] =
            cmul(tw[2 * e], make_float2(apc.x - bpd.x, apc.y - bpd.y));
        b[q + s * (4 * p + 3)] =
            cmul(tw[3 * e], make_float2(amc.x - jb.x, amc.y - jb.y));
      }
      n = n4;
      s <<= 2;
      ls += 2;
    } else {  // n == 2
      for (int i = threadIdx.x; i < (M >> 1); i += FT) {
        const int p = i >> ls, q = i & (s - 1);
        const float2 A = a[q + s * p], B = a[q + s * (p + 1)];
        b[q + s * 2 * p] = make_float2(A.x + B.x, A.y + B.y);
        b[q + s * (2 * p + 1)] =
            cmul(tw[2 * p * s], make_float2(A.x - B.x, A.y - B.y));
      }
      n = 1;
    }
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
  }
  return a;
}

// One frame's inverse real FFT: spec [B, F, 2K] (re | im; Im X[0] and
// Im X[M] are dropped, as irfft drops them) -> the window's support of the
// frame times the window, frames [B, F, W]. With X = DFT_{2M}(x):
// E[k] = (X[k] + conj X[M-k]) / 2 and O[k] = (X[k] - conj X[M-k]) ·
// e^{+2πik/2M} / 2 are the DFTs of x's even and odd samples, so z = x_even
// + i·x_odd = IFFT_M(E + iO) = conj(FFT_M(conj(E + iO))) / M.
__global__ void __launch_bounds__(FT)
    gl_synthesis_kernel(const float* __restrict__ spec,
                        const float* __restrict__ win,
                        const float2* __restrict__ tw,
                        float* __restrict__ frames, int F, int K, int W,
                        int lpad, int M) {
  extern __shared__ float2 fsm[];
  float2* A = fsm;           // M + 1 points
  float2* Bf = fsm + M + 1;  // M points
  const int f = blockIdx.x, b = blockIdx.y;
  const float* row = spec + ((size_t)b * F + f) * 2 * K;
  for (int k = threadIdx.x; k <= M; k += FT)
    A[k] = make_float2(row[k], (k == 0 || k == M) ? 0.f : row[K + k]);
  __syncthreads();
  for (int k = threadIdx.x; k < M; k += FT) {
    const float2 xk = A[k], xm = A[M - k];  // conj(X[M-k]) = (xm.x, -xm.y)
    const float2 E = make_float2(0.5f * (xk.x + xm.x), 0.5f * (xk.y - xm.y));
    const float2 D = make_float2(0.5f * (xk.x - xm.x), 0.5f * (xk.y + xm.y));
    const float2 w = tw[k];
    const float2 O = cmul(D, make_float2(w.x, -w.y));
    // conj(E + i·O)
    Bf[k] = make_float2(E.x - O.y, -(E.y + O.x));
  }
  __syncthreads();
  const float2* z = fft_forward(Bf, A, M, tw);
  const float inv = 1.f / (float)M;
  float* fr = frames + ((size_t)b * F + f) * W;
  for (int j = threadIdx.x; j < W; j += FT) {
    const int n = lpad + j;
    const float2 v = z[n >> 1];
    fr[j] = ((n & 1) ? -v.y : v.x) * inv * win[j];
  }
}

// One frame's analysis: its support samples of y gathered from the
// synthesized frames (ola_at), windowed and zero-padded to 2M, the forward
// real FFT (z = x_even + i·x_odd, Z = FFT_M(z), X[k] = E[k] + e^{-2πik/2M}
// O[k] with E = (Z[k] + conj Z[M-k]) / 2, O = (Z[k] - conj Z[M-k]) / 2i),
// then the magnitude projection with S; spec [B, F, 2K] written.
__global__ void __launch_bounds__(FT)
    gl_analysis_kernel(const float* __restrict__ frames,
                       const float* __restrict__ g,
                       const float* __restrict__ win,
                       const float2* __restrict__ tw,
                       const float* __restrict__ S, float* __restrict__ spec,
                       int F, int K, int W, int hop, int lpad, int M) {
  extern __shared__ float2 fsm[];
  float2* A = fsm;
  float2* Bf = fsm + M + 1;
  const int f = blockIdx.x, b = blockIdx.y;
  const float* fb = frames + (size_t)b * F * W;
  for (int m = threadIdx.x; m < M; m += FT) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * m + e - lpad;
      v[e] = (j >= 0 && j < W)
                 ? win[j] * ola_at(fb, g, f * hop + 2 * m + e, F, W, hop, lpad)
                 : 0.f;
    }
    A[m] = make_float2(v[0], v[1]);
  }
  __syncthreads();
  const float2* Z = fft_forward(A, Bf, M, tw);
  const float* Sr = S + ((size_t)b * F + f) * K;
  float* out = spec + ((size_t)b * F + f) * 2 * K;
  for (int k = threadIdx.x; k <= M; k += FT) {
    const float2 zk = Z[k & (M - 1)], zm = Z[(M - k) & (M - 1)];
    const float2 E = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
    const float2 D = make_float2(0.5f * (zk.x - zm.x), 0.5f * (zk.y + zm.y));
    const float2 O = make_float2(D.y, -D.x);  // D / i
    const float2 t = cmul(tw[k], O);
    const float xr = E.x + t.x, xi = E.y + t.y;
    const float mag = fmaxf(sqrtf(xr * xr + xi * xi), 1e-8f);
    const float sk = Sr[k];
    out[k] = sk * xr / mag;
    out[K + k] = sk * xi / mag;
  }
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

// The DFT route: one call runs the whole reconstruction on `stream`:
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

// The FFT route (n_fft = 2M a power of two), on `stream`:
//   reim0 [B, F, 2K] initial (re | im); S [B, F, K]; win [W] the window
//   over its support; tw [2M] complex e^{-2πi t/2M}; g [total]; scratch
//   frames [B, F, W], spec [B, F, 2K]; y [B, total] as above.
// 2·iters + 2 launches. Returns the first CUDA error code, or 0.
extern "C" int taco_griffin_lim_fft_launch(
    const void* reim0, const void* S, const void* win, const void* tw,
    const void* g, void* frames, void* spec, void* y, int B, int F, int K,
    int W, int hop, int lpad, int n_fft, int iters, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = n_fft / 2, total = n_fft + hop * (F - 1);
  if (n_fft < 4 || (n_fft & (n_fft - 1)) || K != M + 1 || W > n_fft)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * M + 1) * sizeof(float2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gl_synthesis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gl_analysis_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float* Sf = (const float*)S;
  const float* wf = (const float*)win;
  const float2* t2 = (const float2*)tw;
  const float* gf = (const float*)g;
  float* fr = (float*)frames;
  float* sp = (float*)spec;
  const dim3 grid(F, B);
  gl_synthesis_kernel<<<grid, FT, smem, st>>>((const float*)reim0, wf, t2, fr,
                                              F, K, W, lpad, M);
  int rc = (int)cudaGetLastError();
  for (int it = 0; it < iters && !rc; ++it) {
    gl_analysis_kernel<<<grid, FT, smem, st>>>(fr, gf, wf, t2, Sf, sp, F, K,
                                               W, hop, lpad, M);
    rc = (int)cudaGetLastError();
    if (rc) break;
    gl_synthesis_kernel<<<grid, FT, smem, st>>>(sp, wf, t2, fr, F, K, W,
                                                lpad, M);
    rc = (int)cudaGetLastError();
  }
  if (rc) return rc;
  return launch_ola(fr, gf, (float*)y, B, F, W, hop, lpad, total, st);
}
