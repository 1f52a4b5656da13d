// K1 (STFT) and K2 (ISTFT) for the 320/160 framing, f32 in and out.
//
// These replace the Pallas kernels of prior_diffuse_tpu/ops/pallas/stft_kernel.py:
//   K1 stft_kernel   <- _stft_kernel  (called by stft_pallas)
//   K2 istft_kernel  <- _istft_kernel (called by istft_pallas) plus the XLA
//                       epilogue that follows it there (overlap-add,
//                       envelope divide, centre-pad removal, trim/pad).
//
// What bounds them on the card: both are small GEMMs (batch 8 x 3 s:
// M = 2408 frames, N = 322, K = 320 for K1; M = 2400 rows, N = 160,
// K = 644 for K2; about 0.5 GFLOP each) over about 1.5 MB of signal and
// 3 MB of spectrum.  They are latency and launch bound, not bandwidth or
// FLOP bound.  The design therefore removes every pass over device memory
// that the TPU path makes around its kernel: K1 reads the unpadded wav and
// mirrors indices at both ends for the reflect pad (no padded copy, no
// framed copy), and writes [B, T, 161, 2] interleaved (no split/stack);
// K2 reads the interleaved spectrum, does the overlap-add inside the
// product (row r of the output is [spec_r | spec_{r-1}] times the stacked
// first/second halves of the inverse matrix) and divides by the envelope
// in the epilogue, writing [B, length] once.  A plain 64x64-tile SIMT f32
// GEMM with f32 accumulation; wgmma/TMA tiling is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kHop = 160;
constexpr int kWin = 320;
constexpr int kPacked = 322;  // 161 bins x (re, im), interleaved

constexpr int BM = 64, BN = 64, BK = 16, kThreads = 256;

// acc = A[m0:m0+64, :] @ B[:, n0:n0+64] for A[M, K] given element-wise by
// a_at(m, k) and B row-major [K, N] in device memory.  Thread (tx, ty) of
// the 16 x 16 block owns rows m0 + ty + 16 i and columns n0 + tx + 16 j.
template <typename ALoad>
__device__ __forceinline__ void gemm_tile(const ALoad& a_at,
                                          const float* __restrict__ bmat,
                                          int M, int N, int K, int m0, int n0,
                                          float (&acc)[4][4]) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int m = e / BK, k = e % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? a_at(gm, gk) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int k = e / BN, n = e % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? bmat[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Frame t, sample n of the reflect-padded signal of one utterance.
struct FrameAt {
  const float* x;
  int L;
  __device__ float operator()(int t, int n) const {
    int i = t * kHop + n - kHop;      // index into the unpadded signal
    i = i < 0 ? -i : i;               // reflect at the start
    i = i >= L ? 2 * (L - 1) - i : i; // reflect at the end
    return __ldg(x + i);
  }
};

// Output row q (samples q*160 .. q*160+159 after the centre pad is
// dropped) is padded row r = q + 1, the sum of the first half of frame r
// and the second half of frame r - 1: A[q] = [spec_r | spec_{r-1}].
struct OlaRowAt {
  const float* spec;  // [T, 322] of one utterance
  int T;
  __device__ float operator()(int q, int k) const {
    const int r = q + 1;
    if (k < kPacked) return r < T ? __ldg(spec + (size_t)r * kPacked + k) : 0.f;
    return r <= T ? __ldg(spec + (size_t)(r - 1) * kPacked + k - kPacked) : 0.f;
  }
};

__global__ void __launch_bounds__(kThreads)
stft_kernel(const float* __restrict__ x, const float* __restrict__ dft,
            float* __restrict__ out, int L, int T) {
  const int b = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
  gemm_tile(FrameAt{x + (size_t)b * L, L}, dft, T, kPacked, kWin, m0, n0, acc);
  float* ob = out + (size_t)b * T * kPacked;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (t < T && n < kPacked) ob[(size_t)t * kPacked + n] = acc[i][j];
    }
}

__global__ void __launch_bounds__(kThreads)
istft_kernel(const float* __restrict__ spec, const float* __restrict__ inv,
             const float* __restrict__ env, float* __restrict__ out, int T,
             int length) {
  const int b = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int Q = (length + kHop - 1) / kHop;
  float acc[4][4];
  gemm_tile(OlaRowAt{spec + (size_t)b * T * kPacked, T}, inv, Q, kHop,
            2 * kPacked, m0, n0, acc);
  float* ob = out + (size_t)b * length;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      const int s = q * kHop + n, r = q + 1;
      if (q < Q && n < kHop && s < length)
        // rows past the last frame are the zero pad up to `length`;
        // row T holds only frame T-1's second half (envelope table 1)
        ob[s] = r <= T ? acc[i][j] / env[(r == T) * kHop + n] : 0.f;
    }
}

}  // namespace

extern "C" {

const char* pdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, L] -> out [B, T, 161, 2]; dft [320, 322] has the Hann window folded
// in and its columns interleaved (re_f at 2f, im_f at 2f+1).  L > 160.
int pdt_stft_f32(const float* x, const float* dft, float* out, int B, int L,
                 int T, void* stream) {
  dim3 grid((kPacked + BN - 1) / BN, (T + BM - 1) / BM, B);
  stft_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dft, out, L, T);
  return static_cast<int>(cudaGetLastError());
}

// spec [B, T, 161, 2] -> out [B, length]; inv [644, 160] stacks the
// window-folded inverse's first-half columns over its second-half columns
// (rows interleaved like the spectrum); env [2, 160] holds the floored
// window-square envelope of rows 1..T-1 and of row T.
int pdt_istft_f32(const float* spec, const float* inv, const float* env,
                  float* out, int B, int T, int length, void* stream) {
  const int Q = (length + kHop - 1) / kHop;
  dim3 grid((kHop + BN - 1) / BN, (Q + BM - 1) / BM, B);
  istft_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      spec, inv, env, out, T, length);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
