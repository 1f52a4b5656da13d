// K3: one inference encoder stage of DiffUNet / DiffUNet1, f32 in and out,
// its three products on the tensor cores in 3xTF32.
//
// Replaces the Pallas kernel of prior_diffuse_tpu/ops/pallas/convblock_kernel.py
// (_chain_kernel, called by _chain_pallas / fused_enc_stage) together with the
// XLA im2col in front of it.  Per output row (b, t, fo):
//   col  = window of the causally padded input, (2, k) taps, stride (1, 2)
//   y    = col @ W[K, 64] + bias_b[b]          (conv1 and the time
//                                               projection folded in)
//   m    = y @ blockdiag(Wl, Wr)[64, 64] + bg  (the two 1x1 gate convs)
//   comb = y[:32] * sigmoid(m[32:]) + y[32:] * sigmoid(m[:32])
//   out  = PReLU(comb @ W2[32, 64] + b2)       (inference BN folded in)
//
// What bounds it on the card: the multiply-adds.  One UNet forward at batch
// 8 x 3 s is 7.65 GFLOP over the five stages (10,752 FLOP a row at K = 20,
// 32,768 at K = 192), 0.114 ms at the 67 TFLOP/s f32 rate outside the
// tensor cores, against 141 MB of stage inputs and outputs (0.042 ms).
// What the design does about it:
// * every product runs as mma.sync m16n8k8 TF32 with each operand split into
//   hi = rna(x) and lo = rna(x - hi) and three products (lo*hi + hi*lo +
//   hi*hi) summed in f32, which keeps f32-level error (3 x 7.65 GFLOP at
//   495 TFLOP/s: 0.046 ms);
// * implicit GEMM over a time tile: a block owns `tt` output frames of one
//   utterance (all Fo, all 64 channels, at most 256 rows: one 16-row
//   m-tile for each of the 16 warps) and stages the
//   tt + 1 input frames they read with cp.async into shared memory with a
//   padded channel stride (no bank conflicts on the A loads); the next
//   tile's copy runs under this tile's gate and W2 products; the A
//   fragments are read through a row offset computed once per row and a
//   per-k offset table, no division in the K loop; frames before 0
//   (pad = 1) and past the end are zero-filled;
// * the stage's weights stay in shared memory for the block's life, split
//   into hi and lo once and stored in fragment order (one 16-byte load per
//   lane per fragment);
// * the three products of each 3xTF32 step run as three passes over the
//   n-tiles, so no product waits on the one before;
// * y, m and comb stay in registers: with the k order of each 8-wide step
//   permuted (slot t <-> k 2t, slot t + 4 <-> k 2t + 1, the weights stored
//   to match) the accumulator fragment of one product is the A fragment of
//   the next, with no exchange between threads;
// * persistent blocks (one per SM) walk the (b, time-tile) space.
// The tile plan (tt, grid, shared-memory bytes) comes from
// ops/cuda/convblock.py::tile_plan; this file checks the bytes against its
// own layout.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kG = 32;         // BiConvGLU gate width
constexpr int kC = 64;         // stage output channels
constexpr int kMT = 1;          // 16-row m-tiles per warp
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 16 * kMT * kWarps;  // rows of a tile at most
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use

struct Params {
  const float* x;       // [B, Tin, F, C]
  const float* w;       // [K, 64], rows in (kt, kf, c) order
  const float* bias_b;  // [B, 64]
  const float* wg;      // [64, 64], block-diagonal
  const float* bg;      // [64]
  const float* w2;      // [32, 64]
  const float* b2;      // [64]
  const float* alpha;   // [1]
  float* out;           // [B, T, Fo, 64]
  int Tin, F, pad, T, Fo, tt, tiles_per_utt, n_tiles;
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a * b on one m16n8k8 tile, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (a0..a3 = rows g, g+8 at slot t, rows g, g+8 at slot t+4) split
// into hi and lo.
struct AFrag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ AFrag() {}
  __device__ __forceinline__ AFrag(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
  // from an accumulator fragment (c0, c1 = row g, cols 2t, 2t+1; c2, c3 =
  // row g+8): slot t holds k 2t, slot t+4 holds k 2t+1
  __device__ __forceinline__ explicit AFrag(const float (&c)[4])
      : AFrag(c[0], c[2], c[1], c[3]) {}
};

// 3xTF32 over M m-tiles and N n-tiles: d[i][j] += a_lo b_hi + a_hi b_lo +
// a_hi b_hi, with a = a[i] and b[j] = (b0_hi, b1_hi, b0_lo, b1_lo) of this
// lane.  Each pass runs over all tiles, so consecutive products never wait
// on one accumulator.
template <int M, int N>
__device__ __forceinline__ void mma3(float (*d)[N][4], const AFrag* a, const uint4* b) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma(d[i][j], a[i].lo, b[j].x, b[j].y);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma(d[i][j], a[i].hi, b[j].z, b[j].w);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma(d[i][j], a[i].hi, b[j].x, b[j].y);
}

// Weights into fragment order, split: dst[(s * nj + j) * 32 + lane] holds
// the hi parts of (W[8s + 2t][8j + g], W[8s + 2t + 1][8j + g]), then their
// lo parts, for lane = 4g + t; W[k][n] = w[k * 64 + n] for k < krows, zero
// up to 8 ks.  Each thread sends 4 fragments' loads before it waits.
__device__ void stage_frag(uint4* dst, const float* __restrict__ w, int krows,
                           int ks, int nj) {
  const int n = ks * nj * 32;
  for (int e0 = threadIdx.x; e0 < n; e0 += 4 * kThreads) {
    float2 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = e0 + i * kThreads, lane = e & 31, sj = e >> 5;
      const int k = 8 * (sj / nj) + 2 * (lane & 3), c = 8 * (sj % nj) + (lane >> 2);
      v[i].x = e < n && k < krows ? __ldg(w + k * kC + c) : 0.f;
      v[i].y = e < n && k + 1 < krows ? __ldg(w + (k + 1) * kC + c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = e0 + i * kThreads;
      if (e < n) {
        uint4 f;
        split(v[i].x, f.x, f.z);
        split(v[i].y, f.y, f.w);
        dst[e] = f;
      }
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Copy BYTES (8 or 16) from global to shared memory; zero-fill if !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
}

template <int C>
struct Geo {
  static constexpr int CS = C == 2 ? 4 : C + 4;  // channel stride in smem
  static constexpr int CH = C == 2 ? 2 : 4;      // floats per cp.async
};

// Stage input frames t0 - pad .. t0 - pad + tt of utterance b into buf as
// [tt + 1][F][CS]; frames outside [0, Tin) are zeros.
template <int C>
__device__ void load_tile(const Params& p, float* buf, int tile) {
  constexpr int CS = Geo<C>::CS, CH = Geo<C>::CH, NCH = C / CH;
  const int b = tile / p.tiles_per_utt, t0 = (tile % p.tiles_per_utt) * p.tt;
  const int n = (p.tt + 1) * p.F * NCH;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int q = e % NCH, jf = e / NCH, j = jf / p.F;
    const int tin = t0 - p.pad + j;
    const bool ok = tin >= 0 && tin < p.Tin;
    const float* src =
        ok ? p.x + ((static_cast<size_t>(b) * p.Tin + tin) * p.F + jf % p.F) * C + q * CH
           : p.x;
    cp_async<CH * 4>(buf + jf * CS + q * CH, src, ok);
  }
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Bias of this lane's accumulator columns 8j + 2t, 8j + 2t + 1.
__device__ __forceinline__ void init_acc(float (*d)[4], const float* __restrict__ bias) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    d[j][0] = d[j][2] = __ldg(bias + 8 * j + 2 * t4);
    d[j][1] = d[j][3] = __ldg(bias + 8 * j + 2 * t4 + 1);
  }
}

// The chain after the window product, for the warp's m-tiles together:
// gates, cross gate, W2, PReLU; rows r0 + 8h + 16i of this lane at ob,
// those below `rows` stored.
__device__ __forceinline__ void epilogue(float (&y)[kMT][8][4], const uint4* glf,
                                         const uint4* grf, const uint4* w2f,
                                         const Params& p, float alpha, float* ob,
                                         int r0, int rows) {
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  // m = y @ blockdiag(Wl, Wr) + bg: left half from y[.][0..3], right from y[.][4..7]
  float ml[kMT][4][4], mr[kMT][4][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 8 * j + 2 * t4;
      ml[i][j][0] = ml[i][j][2] = __ldg(p.bg + c);
      ml[i][j][1] = ml[i][j][3] = __ldg(p.bg + c + 1);
      mr[i][j][0] = mr[i][j][2] = __ldg(p.bg + kG + c);
      mr[i][j][1] = mr[i][j][3] = __ldg(p.bg + kG + c + 1);
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = glf[(s * 4 + j) * 32 + lane];
    AFrag a[kMT];
#pragma unroll
    for (int i = 0; i < kMT; ++i) a[i] = AFrag(y[i][s]);
    mma3<kMT, 4>(ml, a, b);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = grf[(s * 4 + j) * 32 + lane];
#pragma unroll
    for (int i = 0; i < kMT; ++i) a[i] = AFrag(y[i][s + 4]);
    mma3<kMT, 4>(mr, a, b);
  }
  // the cross gate, 32 wide
  float comb[kMT][4][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        comb[i][j][e] = y[i][j][e] * sigmoid(mr[i][j][e]) + y[i][j + 4][e] * sigmoid(ml[i][j][e]);
  // out = PReLU(comb @ W2 + b2)
  float o[kMT][8][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i) init_acc(o[i], p.b2);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    AFrag a[kMT];
#pragma unroll
    for (int i = 0; i < kMT; ++i) a[i] = AFrag(comb[i][s]);
    uint4 b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = w2f[(s * 8 + j) * 32 + lane];
    mma3<kMT, 8>(o, a, b);
  }
  auto prelu = [&](float v) { return v >= 0.f ? v : alpha * v; };
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * i + 8 * h;
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(ob + r * kC + 8 * j + 2 * t4) =
              make_float2(prelu(o[i][j][2 * h]), prelu(o[i][j][2 * h + 1]));
      }
    }
}

// A tile has at most kTileRows rows; warp w owns rows 16 kMT w onwards
// (kMT m-tiles).  Per tile: wait for its input frames, the window product of
// every warp, a barrier, then the next tile's copy into the same buffer
// runs under the epilogues.
template <int C, int KF>
__global__ void __launch_bounds__(kThreads, 1) enc_chain_kernel(const Params p) {
  constexpr int K = 2 * KF * C, KS = (K + 7) / 8, NP = 4 * KS;
  constexpr int CS = Geo<C>::CS;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* wf = reinterpret_cast<uint4*>(smem);  // [KS][8][32]
  uint4* glf = wf + KS * 8 * 32;               // [4][4][32]
  uint4* grf = glf + 4 * 4 * 32;               // [4][4][32]
  uint4* w2f = grf + 4 * 4 * 32;               // [4][8][32]
  int* koff = reinterpret_cast<int*>(w2f + 4 * 8 * 32);
  float* xs = reinterpret_cast<float*>(koff + NP);  // [tt + 1][F][CS]
  const int F = p.F, Fo = p.Fo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  int tile = blockIdx.x;
  if (tile < p.n_tiles) load_tile<C>(p, xs, tile);
  cp_async_commit();

  stage_frag(wf, p.w, K, KS, 8);
  stage_frag(glf, p.wg, kG, 4, 4);
  stage_frag(grf, p.wg + kG * kC + kG, kG, 4, 4);
  stage_frag(w2f, p.w2, kG, 4, 8);
  for (int q = threadIdx.x; q < NP; q += kThreads) {
    // pair q covers k = 2q, 2q + 1: channels c, c + 1 of one tap (C even)
    const int k = 2 * q, kt = k / (KF * C), r = k % (KF * C);
    koff[q] = k < K ? (kt * F + r / C) * CS + r % C : 0;
  }
  const float alpha = __ldg(p.alpha);

  for (; tile < p.n_tiles; tile += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();
    const int b = tile / p.tiles_per_utt, t0 = (tile % p.tiles_per_utt) * p.tt;
    const int rows = min(p.tt, p.T - t0) * Fo;  // valid rows of this tile
    const int r0 = warp * 16 * kMT + g;  // this lane's rows r0 + 8h + 16i
    const bool busy = warp * 16 * kMT < rows;

    // y = col @ W + bias_b[b] for the warp's m-tiles
    float y[kMT][8][4];
    if (busy) {
      int off[kMT][2];  // smem offset of each row's window origin
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int r = r0 + 16 * i + 8 * h;
          r = r < rows ? r : 0;  // rows past the tile read row 0
          off[i][h] = ((r / Fo) * F + 2 * (r % Fo)) * CS;
        }
#pragma unroll
      for (int i = 0; i < kMT; ++i) init_acc(y[i], p.bias_b + b * kC);
#pragma unroll 2
      for (int s = 0; s < KS; ++s) {
        const int ko = koff[4 * s + t4];
        AFrag a[kMT];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const float2 v0 = *reinterpret_cast<const float2*>(xs + off[i][0] + ko);
          const float2 v1 = *reinterpret_cast<const float2*>(xs + off[i][1] + ko);
          a[i] = AFrag(v0.x, v1.x, v0.y, v1.y);
        }
        uint4 bw[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) bw[j] = wf[(s * 8 + j) * 32 + lane];
        mma3<kMT, 8>(y, a, bw);
      }
    }
    __syncthreads();  // every warp is done with xs
    if (tile + gridDim.x < p.n_tiles) load_tile<C>(p, xs, tile + gridDim.x);
    cp_async_commit();

    if (busy)
      epilogue(y, glf, grf, w2f, p, alpha,
               p.out + (static_cast<size_t>(b) * p.T + t0) * Fo * kC, r0, rows);
  }
}

// Dynamic shared memory of one block; ops/cuda/convblock.py::smem_bytes
// computes the same.
int smem_bytes(int c, int kf, int F, int tt) {
  const int K = 2 * kf * c, KS = (K + 7) / 8, NP = 4 * KS;
  const int CS = c == 2 ? 4 : c + 4;
  return 16 * (KS * 8 * 32 + 2 * 4 * 4 * 32 + 4 * 8 * 32) + 4 * NP +
         4 * (tt + 1) * F * CS;
}

template <int C, int KF>
int launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  static unsigned attr_set = 0;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(attr_set & (1u << dev))) {
    err = cudaFuncSetAttribute(enc_chain_kernel<C, KF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= 1u << dev;
  }
  enc_chain_kernel<C, KF><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [B, Tin, F, C] -> out [B, T, Fo, 64], T = Tin - 1 + pad,
// Fo = (F - kf) / 2 + 1, for the two stage geometries of the encoder:
// (C, kf) = (2, 5) and (32, 3).  bias_b [B, 64]; w [2*kf*C, 64] with rows
// in (kt, kf, c) order; wg [64, 64]; bg, b2 [64]; w2 [32, 64]; alpha [1];
// x, w, wg and w2 16-byte aligned.
// tt, grid and smem are the tile plan of convblock.py::tile_plan.
int pdt_enc_stage_f32(const float* x, const float* bias_b, const float* w,
                      const float* wg, const float* bg, const float* w2,
                      const float* b2, const float* alpha, float* out, int B,
                      int Tin, int F, int C, int kf, int pad, int tt, int grid,
                      int smem, void* stream) {
  const int T = Tin - 1 + pad, Fo = (F - kf) / 2 + 1;
  if (B < 1 || T < 1 || Fo < 1 || tt < 1 || tt * Fo > kTileRows || grid < 1 ||
      (pad != 0 && pad != 1) || smem != smem_bytes(C, kf, F, tt) || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_per_utt = (T + tt - 1) / tt;
  const Params p{x,   w,  bias_b, wg, bg, w2,         b2,           alpha,
                 out, Tin, F,     pad, T, Fo, tt, tiles_per_utt, B * tiles_per_utt};
  const auto s = static_cast<cudaStream_t>(stream);
  if (C == 2 && kf == 5) return launch<2, 5>(p, grid, smem, s);
  if (C == 32 && kf == 3) return launch<32, 3>(p, grid, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
