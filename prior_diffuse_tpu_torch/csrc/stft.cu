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
// K2: K1 run backwards, and like K1 bound by bytes: batch 8 x 3 s reads
// 3.1 MB of spectrum and writes 1.5 MB of signal (1.4 us at 3.35 TB/s),
// while the inverse FFTs need ~17 MFLOP.  A block owns R output rows of 160
// samples of one utterance.  Output row q is padded row q + 1: the first
// half of frame q + 1 plus the second half of frame q, so the block takes
// frames q0 .. q0 + R, one warp each; the last is a halo frame that the
// next block computes too (1/R more FFT work, its spectrum mostly read
// from L2).  R is a template parameter (4, 8 or 16) that the caller passes
// at launch (ops/cuda/stft.py::ISTFT_ROWS, chosen there from the serving
// and eval shapes by tools/kernel_probe.py k2).

// Per frame (one warp): the 161 bins into shared memory (coalesced float2
// loads) with Im X[0] and Im X[160] taken as 0, as the plain inverse and
// irfft take them; the Hermitian pre-split into the 160-point complex Z
// whose inverse DFT is 320 (x[2n] + i x[2n+1]); that inverse as K1's FFT
// reversed: radix-2 decimation-in-time butterflies across the lanes by
// warp shuffles, taking Z in K1's bit-reversed lane order, the twiddle
// W160^-(lane k1), a 5-point inverse DFT in each lane, so that lane l
// holds z[32 n1 + l]; then the synthesis window times 1/320 in one
// product, into shared memory.  After one barrier the block overlap-adds
// its rows, divides by the window-square envelope, drops the centre pad,
// trims or zero-pads to `length`, and writes its samples once, coalesced.
// No DFT matrix, no frames in device memory.  Window, twiddles and
// envelope come from a table built on the host in float64 and cast to
// float32.
#include <cuda_runtime.h>

namespace {

constexpr int kHop = 160;
constexpr int kWin = 320;
constexpr int kPacked = 322;  // 161 bins x (re, im), interleaved

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

// K2's table, floats: the Hann window / 320 [320], then e^{+2 pi i m / 160}
// for m < 160 and e^{+2 pi i k / 320} for k < 160, (re, im) interleaved,
// then the floored window-square envelope of rows 1..T-1 and of row T
// [2, 160].
constexpr int kItw160 = kWin, kItw320 = kWin + 2 * kHop, kIenv = kWin + 4 * kHop;

template <int R>  // output rows per block; frames q0 .. q0 + R
__global__ void __launch_bounds__(32 * (R + 1))
istft_kernel(const float* __restrict__ spec, const float* __restrict__ tab,
             float* __restrict__ out, int T, int length) {
  __shared__ float2 xs[R + 1][kHop + 1];
  __shared__ __align__(16) float fr[R + 1][kWin];
  const int b = blockIdx.y, q0 = blockIdx.x * R;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, f = q0 + w;
  if (f < T) {
    const float2* sf = reinterpret_cast<const float2*>(spec) +
                       (static_cast<size_t>(b) * T + f) * (kHop + 1);
    for (int k = lane; k <= kHop; k += 32) {
      float2 x = __ldg(sf + k);
      if (k == 0 || k == kHop) x.y = 0.f;
      xs[w][k] = x;
    }
    __syncwarp();
    const float2* tw = reinterpret_cast<const float2*>(tab + kItw160);
    const float2* w320 = reinterpret_cast<const float2*>(tab + kItw320);

    // pre-split: Z[k] = E + i O, E = X[k] + conj X[160-k],
    // O = (X[k] - conj X[160-k]) e^{+2 pi i k / 320}; lane l takes
    // k = k1 + 5 * bitrev5(l), where K1's lane l ends
    const int k2 = __brev(lane) >> 27;
    float2 v[5];
#pragma unroll
    for (int k1 = 0; k1 < 5; ++k1) {
      const int k = k1 + 5 * k2;
      const float2 a = xs[w][k], c = xs[w][kHop - k];
      const float2 o = cmul(make_float2(a.x - c.x, a.y + c.y), __ldg(w320 + k));
      v[k1] = make_float2(a.x + c.x - o.y, a.y - c.y + o.x);
    }
    // 32-point inverse DFTs across the lanes (decimation in time: K1's
    // stages undone in reverse order): lane l ends with the sum over k2 of
    // W32^-(l k2) Z[k1 + 5 k2].  The upper lane of a pair multiplies its
    // own value by W_{2h}^-j before the exchange.
#pragma unroll
    for (int h = 1; h <= 16; h <<= 1) {
      const bool upper = lane & h;
      const float2 wt = __ldg(tw + 5 * (lane & (h - 1)) * (16 / h));  // W_{2h}^-j
#pragma unroll
      for (int k1 = 0; k1 < 5; ++k1) {
        const float2 t = upper ? cmul(v[k1], wt) : v[k1];
        const float2 o = make_float2(__shfl_xor_sync(0xffffffffu, t.x, h),
                                     __shfl_xor_sync(0xffffffffu, t.y, h));
        v[k1] = upper ? make_float2(o.x - t.x, o.y - t.y)
                      : make_float2(t.x + o.x, t.y + o.y);
      }
    }
    // the twiddle W160^-(lane k1), then the 5-point inverse DFT over k1:
    // z[32 n1 + lane], windowed and scaled, to shared memory
#pragma unroll
    for (int k1 = 1; k1 < 5; ++k1) v[k1] = cmul(v[k1], __ldg(tw + lane * k1));
#pragma unroll
    for (int n1 = 0; n1 < 5; ++n1) {
      float2 acc = v[0];
#pragma unroll
      for (int k1 = 1; k1 < 5; ++k1) {
        const float2 p = cmul(v[k1], __ldg(tw + 32 * ((n1 * k1) % 5)));  // W5^-(n1 k1)
        acc.x += p.x;
        acc.y += p.y;
      }
      const int s = 64 * n1 + 2 * lane;
      const float2 wv = __ldg(reinterpret_cast<const float2*>(tab + s));
      *reinterpret_cast<float2*>(&fr[w][s]) = make_float2(acc.x * wv.x, acc.y * wv.y);
    }
  } else {
    // frames past the last one contribute nothing
    for (int s = lane; s < kWin; s += 32) fr[w][s] = 0.f;
  }
  __syncthreads();

  // overlap-add: output row q0 + i = first half of frame i + 1 + second
  // half of frame i (block-local); row T holds only frame T-1's second half
  // (envelope row 1), rows past T are the zero pad up to `length`
  const float* env = tab + kIenv;
  float* ob = out + static_cast<size_t>(b) * length + static_cast<size_t>(q0) * kHop;
  const int n_out = min(R * kHop, length - q0 * kHop);
  for (int e = threadIdx.x; e < n_out; e += 32 * (R + 1)) {
    const int i = e / kHop, n = e - i * kHop, r = q0 + i + 1;
    ob[e] = r <= T ? (fr[i + 1][n] + fr[i][kHop + n]) / __ldg(env + (r == T) * kHop + n)
                   : 0.f;
  }
}

template <int R>
void launch_istft(const float* spec, const float* tab, float* out, int B, int T,
                  int length, cudaStream_t stream) {
  const int Q = (length + kHop - 1) / kHop;  // output rows
  istft_kernel<R><<<dim3((Q + R - 1) / R, B), 32 * (R + 1), 0, stream>>>(
      spec, tab, out, T, length);
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

// spec [B, T, 161, 2] -> out [B, length]; tab: the 1280-float window,
// twiddle and envelope table (ops/cuda/stft.py::istft_table_np); rows: the
// output rows a block owns, 4, 8 or 16.  T >= 1; spec 8-byte aligned.
int pdt_istft_f32(const float* spec, const float* tab, float* out, int B, int T,
                  int length, int rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 4: launch_istft<4>(spec, tab, out, B, T, length, s); break;
    case 8: launch_istft<8>(spec, tab, out, B, T, length, s); break;
    case 16: launch_istft<16>(spec, tab, out, B, T, length, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
