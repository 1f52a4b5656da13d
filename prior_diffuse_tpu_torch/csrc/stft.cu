// K1 (STFT) and K2 (ISTFT) for the 320/160 framing, f32 in and out.
//
// These replace the Pallas kernels of prior_diffuse_tpu/ops/pallas/stft_kernel.py:
//   K1 stft_kernel   <- _stft_kernel  (called by stft_pallas)
//   K2 istft_kernel  <- _istft_kernel (called by istft_pallas) plus the XLA
//                       epilogue that follows it there (overlap-add,
//                       envelope divide, centre-pad removal, trim/pad).
//
// K1: what bounds it on the card is memory: batch 8 x 3 s reads 1.5 MB of
// wav and writes 3.1 MB of spectrum (1.4 us at 3.35 TB/s), while a radix
// FFT needs ~17 MFLOP (0.25 us); the plain version's DFT-as-GEMM does 0.5
// GFLOP (7.4 us at the 67 TFLOP/s f32 rate).  The design is one fused pass
// with an FFT: a block takes 8 frames of one utterance, reads the 9 hop
// rows they span once (coalesced; the reflect pad is an index map on the
// first and last rows), and one warp per frame computes the 320-point real
// FFT as a 160-point complex FFT of z[n] = xw[2n] + i xw[2n+1] (160 = 5 x
// 32: a radix-5 DFT in each lane, the 32-point rest as radix-2 butterflies
// across the lanes with warp shuffles), then splits Z into the 161 bins of
// the real spectrum and writes [T, 161, 2] interleaved.  The Hann window
// and the twiddles come from a table built on the host in float64 and cast
// to float32.  No DFT matrix, no framed copy.  The FFT rounds differently
// from the plain GEMM (both are within ~1e-5 of max|X|).
//
// K2: a GEMM (M = 2400 rows, N = 160, K = 644 at batch 8 x 3 s, ~0.5 GFLOP)
// over about 3 MB of spectrum and 1.5 MB of signal.  It removes every pass
// over device memory that the TPU path makes around its kernel: it reads
// the interleaved spectrum, does the overlap-add inside the product (row r
// of the output is [spec_r | spec_{r-1}] times the stacked first/second
// halves of the inverse matrix) and divides by the envelope in the
// epilogue, writing [B, length] once.  A plain 64x64-tile SIMT f32 GEMM
// with f32 accumulation.
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

// K1's table, floats: the Hann window [320], then e^{-2 pi i m / 160} for
// m < 160 and e^{-2 pi i k / 320} for k <= 160, (re, im) interleaved.
constexpr int kTw160 = kWin, kTw320 = kWin + 2 * kHop;
constexpr int kFrames = 8;  // frames per block, one warp each
constexpr int kFftThreads = 32 * kFrames;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(kFftThreads)
stft_kernel(const float* __restrict__ x, const float* __restrict__ tab,
            float* __restrict__ out, int L, int T) {
  __shared__ __align__(16) float rows[(kFrames + 1) * kHop];
  __shared__ float2 z[kFrames][kHop];
  const int b = blockIdx.y, t0 = blockIdx.x * kFrames;
  const float* xb = x + static_cast<size_t>(b) * L;
  // hop rows t0 .. t0 + 8 of the reflect-padded signal: padded sample
  // t0 * 160 + e is sample (t0 - 1) * 160 + e of the wav, mirrored at the ends
  const int base = (t0 - 1) * kHop, n_rows = min(kFrames + 1, T + 1 - t0);
  for (int e = threadIdx.x; e < n_rows * kHop; e += kFftThreads) {
    int i = base + e;
    i = i < 0 ? -i : i;
    i = i >= L ? 2 * (L - 1) - i : i;
    rows[e] = __ldg(xb + i);
  }
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, t = t0 + w;
  if (t >= T) return;
  const float* frame = rows + w * kHop;  // rows w and w + 1: 320 samples
  const float2* tw = reinterpret_cast<const float2*>(tab + kTw160);

  // z[32 n1 + lane] for n1 < 5, windowed; then the 5-point DFT over n1 and
  // the twiddle W160^(lane k1)
  float2 u[5], v[5];
#pragma unroll
  for (int n1 = 0; n1 < 5; ++n1) {
    const int s = 64 * n1 + 2 * lane;
    const float2 a = *reinterpret_cast<const float2*>(frame + s);
    const float2 wv = __ldg(reinterpret_cast<const float2*>(tab + s));
    u[n1] = make_float2(a.x * wv.x, a.y * wv.y);
  }
#pragma unroll
  for (int k1 = 0; k1 < 5; ++k1) {
    float2 acc = u[0];
#pragma unroll
    for (int n1 = 1; n1 < 5; ++n1) {
      const float2 p = cmul(u[n1], __ldg(tw + 32 * ((n1 * k1) % 5)));  // W5^(n1 k1)
      acc.x += p.x;
      acc.y += p.y;
    }
    v[k1] = k1 ? cmul(acc, __ldg(tw + lane * k1)) : acc;
  }
  // 32-point DFTs across the lanes (decimation in frequency): lane l ends
  // with Z[k1 + 5 * bitrev5(l)]
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
    const bool upper = lane & h;
    const float2 wt = __ldg(tw + 5 * (lane & (h - 1)) * (16 / h));  // W_{2h}^j
#pragma unroll
    for (int k1 = 0; k1 < 5; ++k1) {
      const float2 o = make_float2(__shfl_xor_sync(0xffffffffu, v[k1].x, h),
                                   __shfl_xor_sync(0xffffffffu, v[k1].y, h));
      v[k1] = upper ? cmul(make_float2(o.x - v[k1].x, o.y - v[k1].y), wt)
                    : make_float2(v[k1].x + o.x, v[k1].y + o.y);
    }
  }
  const int k2 = __brev(lane) >> 27;
#pragma unroll
  for (int k1 = 0; k1 < 5; ++k1) z[w][k1 + 5 * k2] = v[k1];
  __syncwarp();

  // real split: X[k] = E[k] + W320^k O[k], E = (Z[k] + conj Z[160-k]) / 2,
  // O = (Z[k] - conj Z[160-k]) / 2i
  const float2* w320 = reinterpret_cast<const float2*>(tab + kTw320);
  float2* ob = reinterpret_cast<float2*>(out + (static_cast<size_t>(b) * T + t) * kPacked);
  for (int k = lane; k <= kHop; k += 32) {
    const float2 zk = z[w][k == kHop ? 0 : k], zm = z[w][k == 0 ? 0 : kHop - k];
    const float er = 0.5f * (zk.x + zm.x), ei = 0.5f * (zk.y - zm.y);
    const float2 o = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
    const float2 wo = cmul(__ldg(w320 + k), o);
    ob[k] = make_float2(er + wo.x, ei + wo.y);
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

// x [B, L] -> out [B, T, 161, 2], T = L / 160 + 1; tab: the 962-float
// window and twiddle table (ops/cuda/stft.py::fft_table_np).  L > 160.
int pdt_stft_f32(const float* x, const float* tab, float* out, int B, int L,
                 int T, void* stream) {
  dim3 grid((T + kFrames - 1) / kFrames, B);
  stft_kernel<<<grid, kFftThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, tab, out, L, T);
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
