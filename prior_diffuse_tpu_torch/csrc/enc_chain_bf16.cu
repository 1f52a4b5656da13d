// K3 in bf16: one inference encoder stage of DiffUNet / DiffUNet1, bf16 in
// and out, its three products on the tensor cores as bf16 x bf16 -> f32.
//
// Replaces the Pallas kernel of prior_diffuse_tpu/ops/pallas/convblock_kernel.py
// (_chain_kernel at dtype=bfloat16, its default, called by _chain_pallas /
// fused_enc_stage) together with the XLA im2col in front of it.  Per output
// row (b, t, fo), with the rounding points of _chain_kernel:
//   col  = window of the causally padded bf16 input, (2, k) taps, stride (1, 2)
//   y    = col @ W[K, 64] + bias_b[b]           bf16 operands, f32 sums; y f32
//   m    = bf16(y) @ blockdiag(Wl, Wr) + bg     only this operand is rounded
//   comb = y[:32] * sigmoid(m[32:]) + y[32:] * sigmoid(m[:32])   from f32 y
//   out  = bf16(PReLU(bf16(comb) @ W2[32, 64] + b2))
// A kernel that kept y in bf16 for the combine would compute another
// function (tests/test_torch_bf16.py holds the plain version to that).
//
// What bounds it on the card: the bytes.  One DiffUNet1 forward at batch
// 8 x 3 s is 7.65 GFLOP over the five stages (7.7 us at the 989 TFLOP/s
// bf16 tensor rate) against 71 MB of bf16 stage inputs and outputs (21 us
// at 3.35 TB/s).  The design is the f32 kernel's (csrc/enc_chain.cu) with
// one product per step in place of three:
// * mma.sync m16n8k16 bf16 with f32 accumulators;
// * implicit GEMM over a time tile: a block owns `tt` output frames of one
//   utterance (all Fo, all 64 channels, at most 256 rows: one 16-row m-tile
//   for each of the 16 warps) and stages the tt + 1 input frames they read
//   with cp.async into shared memory, the next tile's copy under this
//   tile's gate and W2 products; each 32-bit A load takes the channels c,
//   c + 1 of one tap (a k pair) through a row offset computed once per row
//   and a per-pair offset table; C = 32 pixels are padded to 40 channels
//   (80 bytes), so the 8 rows of a fragment hit 8 distinct 4-bank groups;
//   frames before 0 (pad = 1) and past the end are zero-filled;
// * the stage's weights stay in shared memory for the block's life, in
//   fragment order (one 8-byte load per lane per fragment);
// * y, m and comb stay in registers: the f32 accumulator fragments of two
//   adjacent n-tiles are, packed in pairs to bf16, the A fragment of the
//   next product's k16 step, with no exchange between threads;
// * persistent blocks (one per SM) walk the (b, time-tile) space.
// The tile plan (tt, grid, shared-memory bytes) comes from
// ops/cuda/convblock.py::tile_plan(..., elem=2); this file checks the bytes
// against its own layout.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kG = 32;         // BiConvGLU gate width
constexpr int kC = 64;         // stage output channels
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 16 * kWarps;  // rows of a tile at most
constexpr int kSmemMax = 232448;        // dynamic shared memory a block may use

using bf16_t = __nv_bfloat16;

struct Params {
  const bf16_t* x;        // [B, Tin, F, C]
  const float* bias_b;  // [B, 64]
  const bf16_t* w;        // [K, 64], rows in (kt, kf, c) order
  const bf16_t* wg;       // [64, 64], block-diagonal
  const float* bg;      // [64]
  const bf16_t* w2;       // [32, 64]
  const float* b2;      // [64]
  const float* alpha;   // [1]
  bf16_t* out;            // [B, T, Fo, 64]
  int Tin, F, pad, T, Fo, tt, tiles_per_utt, n_tiles;
};

// Two floats rounded to bf16 (nearest, ties to even), lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a * b on one m16n8k16 tile, bf16 operands, f32 accumulators.
// a: rows g, g + 8 at k 2t..2t+1, then rows g, g + 8 at k 2t+8..2t+9;
// b: k 2t..2t+1 and 2t+8..2t+9 of column g (lane = 4g + t).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The A fragment of a k16 step from the accumulators of n-tiles j, j + 1
// (c0, c1 = row g, cols 2t, 2t+1; c2, c3 = row g + 8), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Weights into fragment order: dst[(s * nj + j) * 32 + lane] holds
// (W[16s + 2t][n], W[16s + 2t + 1][n]) and (W[16s + 2t + 8][n],
// W[16s + 2t + 9][n]) for n = 8j + g, lane = 4g + t; W[k][n] = w[k * 64 + n]
// for k < krows, zero up to 16 ks.
__device__ void stage_frag(uint2* dst, const bf16_t* __restrict__ w, int krows, int ks,
                           int nj) {
  const unsigned short* wb = reinterpret_cast<const unsigned short*>(w);
  const int n = ks * nj * 32;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int lane = e & 31, sj = e >> 5;
    const int k = 16 * (sj / nj) + 2 * (lane & 3), c = 8 * (sj % nj) + (lane >> 2);
    auto at = [&](int kk) -> uint32_t {
      return kk < krows ? static_cast<uint32_t>(__ldg(wb + kk * kC + c)) : 0u;
    };
    dst[e] = make_uint2(at(k) | at(k + 1) << 16, at(k + 8) | at(k + 9) << 16);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Copy BYTES (4 or 16) from global to shared memory; zero-fill if !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(n));
}

template <int C>
struct Geo {
  static constexpr int CS = C == 2 ? 2 : C + 8;  // bf16 channel stride in smem
  static constexpr int CH = C == 2 ? 2 : 8;      // bf16 values per cp.async
};

// Stage input frames t0 - pad .. t0 - pad + tt of utterance b into buf as
// [tt + 1][F][CS]; frames outside [0, Tin) are zeros.
template <int C>
__device__ void load_tile(const Params& p, bf16_t* buf, int tile) {
  constexpr int CS = Geo<C>::CS, CH = Geo<C>::CH, NCH = C / CH;
  const int b = tile / p.tiles_per_utt, t0 = (tile % p.tiles_per_utt) * p.tt;
  const int n = (p.tt + 1) * p.F * NCH;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int q = e % NCH, jf = e / NCH, j = jf / p.F;
    const int tin = t0 - p.pad + j;
    const bool ok = tin >= 0 && tin < p.Tin;
    const bf16_t* src =
        ok ? p.x + ((static_cast<size_t>(b) * p.Tin + tin) * p.F + jf % p.F) * C + q * CH
           : p.x;
    cp_async<CH * 2>(buf + jf * CS + q * CH, src, ok);
  }
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Bias of this lane's accumulator columns 8j + 2t, 8j + 2t + 1, j < N.
template <int N>
__device__ __forceinline__ void init_acc(float (*d)[4], const float* __restrict__ bias) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    d[j][0] = d[j][2] = __ldg(bias + 8 * j + 2 * t4);
    d[j][1] = d[j][3] = __ldg(bias + 8 * j + 2 * t4 + 1);
  }
}

// The chain after the window product for the warp's m-tile: gates, cross
// gate, W2, PReLU; rows r0 and r0 + 8 of this lane at ob, those below
// `rows` stored.
__device__ __forceinline__ void epilogue(const float (&y)[8][4], const uint2* glf,
                                         const uint2* grf, const uint2* w2f,
                                         const Params& p, float alpha, bf16_t* ob, int r0,
                                         int rows) {
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  // m = bf16(y) @ blockdiag(Wl, Wr) + bg: left from y n-tiles 0..3, right from 4..7
  float ml[4][4], mr[4][4];
  init_acc<4>(ml, p.bg);
  init_acc<4>(mr, p.bg + kG);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    uint32_t a[4];
    acc_to_a(a, y[2 * s], y[2 * s + 1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma(ml[j], a, glf[(s * 4 + j) * 32 + lane]);
    acc_to_a(a, y[4 + 2 * s], y[5 + 2 * s]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma(mr[j], a, grf[(s * 4 + j) * 32 + lane]);
  }
  // the cross gate, 32 wide, from the f32 y
  float comb[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      comb[j][e] = y[j][e] * sigmoid(mr[j][e]) + y[j + 4][e] * sigmoid(ml[j][e]);
  // out = PReLU(bf16(comb) @ W2 + b2)
  float o[8][4];
  init_acc<8>(o, p.b2);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    uint32_t a[4];
    acc_to_a(a, comb[2 * s], comb[2 * s + 1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(o[j], a, w2f[(s * 8 + j) * 32 + lane]);
  }
  auto prelu = [&](float v) { return v >= 0.f ? v : alpha * v; };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + r * kC + 8 * j + 2 * t4) =
            pack(prelu(o[j][2 * h]), prelu(o[j][2 * h + 1]));
    }
  }
}

// A tile has at most kTileRows rows; warp w owns rows 16 w .. 16 w + 15.
// Per tile: wait for its input frames, the window product of every warp, a
// barrier, then the next tile's copy into the same buffer runs under the
// epilogues.
template <int C, int KF>
__global__ void __launch_bounds__(kThreads, 1) enc_chain_bf16_kernel(const Params p) {
  constexpr int K = 2 * KF * C, KS = (K + 15) / 16, NP = 8 * KS;
  constexpr int CS = Geo<C>::CS;
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* wf = reinterpret_cast<uint2*>(smem);  // [KS][8][32]
  uint2* glf = wf + KS * 8 * 32;               // [2][4][32]
  uint2* grf = glf + 2 * 4 * 32;               // [2][4][32]
  uint2* w2f = grf + 2 * 4 * 32;               // [2][8][32]
  int* koff = reinterpret_cast<int*>(w2f + 2 * 8 * 32);
  bf16_t* xs = reinterpret_cast<bf16_t*>(koff + NP);  // [tt + 1][F][CS]
  const int F = p.F, Fo = p.Fo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  int tile = blockIdx.x;
  if (tile < p.n_tiles) load_tile<C>(p, xs, tile);
  cp_async_commit();

  stage_frag(wf, p.w, K, KS, 8);
  stage_frag(glf, p.wg, kG, 2, 4);
  stage_frag(grf, p.wg + kG * kC + kG, kG, 2, 4);
  stage_frag(w2f, p.w2, kG, 2, 8);
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
    const int r0 = warp * 16 + g;               // this lane's rows r0, r0 + 8
    const bool busy = warp * 16 < rows;

    // y = col @ W + bias_b[b] for the warp's m-tile
    float y[8][4];
    if (busy) {
      int off[2];  // smem offset of each row's window origin
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r = r0 + 8 * h;
        r = r < rows ? r : 0;  // rows past the tile read row 0
        off[h] = ((r / Fo) * F + 2 * (r % Fo)) * CS;
      }
      init_acc<8>(y, p.bias_b + b * kC);
#pragma unroll 2
      for (int s = 0; s < KS; ++s) {
        const int k0 = koff[8 * s + t4], k1 = koff[8 * s + 4 + t4];
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(xs + off[0] + k0);
        a[1] = *reinterpret_cast<const uint32_t*>(xs + off[1] + k0);
        a[2] = *reinterpret_cast<const uint32_t*>(xs + off[0] + k1);
        a[3] = *reinterpret_cast<const uint32_t*>(xs + off[1] + k1);
        uint2 bw[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) bw[j] = wf[(s * 8 + j) * 32 + lane];
#pragma unroll
        for (int j = 0; j < 8; ++j) mma(y[j], a, bw[j]);
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
// (elem = 2) computes the same.
int smem_bytes(int c, int kf, int F, int tt) {
  const int K = 2 * kf * c, KS = (K + 15) / 16, NP = 8 * KS;
  const int CS = c == 2 ? 2 : c + 8;
  return 8 * 32 * (KS * 8 + 2 * 2 * 4 + 2 * 8) + 4 * NP + 2 * (tt + 1) * F * CS;
}

template <int C, int KF>
int launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  static unsigned attr_set = 0;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(attr_set & (1u << dev))) {
    err = cudaFuncSetAttribute(enc_chain_bf16_kernel<C, KF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= 1u << dev;
  }
  enc_chain_bf16_kernel<C, KF><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 x [B, Tin, F, C] -> bf16 out [B, T, Fo, 64], T = Tin - 1 + pad,
// Fo = (F - kf) / 2 + 1, for the two stage geometries of the encoder:
// (C, kf) = (2, 5) and (32, 3).  bias_b [B, 64] f32; w [2*kf*C, 64] bf16
// with rows in (kt, kf, c) order; wg [64, 64] bf16; bg, b2 [64] f32; w2
// [32, 64] bf16; alpha [1] f32; x 16-byte aligned.
// tt, grid and smem are the tile plan of convblock.py::tile_plan(..., elem=2).
int pdt_enc_stage_bf16(const void* x, const float* bias_b, const void* w, const void* wg,
                       const float* bg, const void* w2, const float* b2,
                       const float* alpha, void* out, int B, int Tin, int F, int C,
                       int kf, int pad, int tt, int grid, int smem, void* stream) {
  const int T = Tin - 1 + pad, Fo = (F - kf) / 2 + 1;
  if (B < 1 || T < 1 || Fo < 1 || tt < 1 || tt * Fo > kTileRows || grid < 1 ||
      (pad != 0 && pad != 1) || smem != smem_bytes(C, kf, F, tt) || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_per_utt = (T + tt - 1) / tt;
  const Params p{static_cast<const bf16_t*>(x),
                 bias_b,
                 static_cast<const bf16_t*>(w),
                 static_cast<const bf16_t*>(wg),
                 bg,
                 static_cast<const bf16_t*>(w2),
                 b2,
                 alpha,
                 static_cast<bf16_t*>(out),
                 Tin,
                 F,
                 pad,
                 T,
                 Fo,
                 tt,
                 tiles_per_utt,
                 B * tiles_per_utt};
  const auto s = static_cast<cudaStream_t>(stream);
  if (C == 2 && kf == 5) return launch<2, 5>(p, grid, smem, s);
  if (C == 32 && kf == 3) return launch<32, 3>(p, grid, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
