// K3 in bf16: one inference encoder stage of DiffUNet / DiffUNet1, bf16 in
// and out, every product on the Hopper tensor cores (wgmma, bf16 x bf16 ->
// f32), with stage 2-5's 1x1 conv1 inside the kernel.
//
// Replaces the Pallas kernel of prior_diffuse_tpu/ops/pallas/convblock_kernel.py
// (_chain_kernel at dtype=bfloat16, its default, called by _chain_pallas /
// fused_enc_stage) together with the XLA conv1 and im2col in front of it.
// Per output row (b, t, fo), with the rounding points of fused_enc_stage:
//   stages 2-5: xc = bf16(f32(bf16(x @ W1)) + bias1[b]) per input pixel, the
//               causal pad frame is xc of a zero frame = bf16(bias1[b]);
//               stage 1 (C = 2) has conv1 composed into W (K = 20)
//   col  = window of the padded input, (2, k) taps, stride (1, 2)
//   y    = col @ W[K, 64] + bias_b[b]           bf16 operands, f32 sums; y f32
//   m    = bf16(y) @ blockdiag(Wl, Wr) + bg     only this operand is rounded
//   comb = y[:32] * sigmoid(m[32:]) + y[32:] * sigmoid(m[:32])   from f32 y
//   out  = bf16(PReLU(bf16(comb) @ W2[32, 64] + b2))
//
// What bounds it on the card: the bytes.  One DiffUNet1 forward at batch
// 8 x 3 s reads the five stage inputs and writes the five outputs once, about
// 93 MB (28 us at 3.35 TB/s), against 9.1 GFLOP (9.2 us at the 989 TFLOP/s
// bf16 tensor rate).  So the design keeps the byte stream moving and the SMs
// busy:
// * a persistent block per SM walks (utterance, time-tile) tiles; one
//   producer warp keeps the next tile's copy in flight in a two-slot ring
//   (full / empty mbarriers) while two consumer warpgroups compute;
// * stages 2-5: the tile's tt + 1 input frames [F, 64] come in by one TMA
//   copy (4-D tensor map over [B, T, F, 64], 128-byte swizzle; frame t0 - 1
//   of the first tile lies outside the tensor and is zero-filled, which
//   makes conv1's pad frame bf16(bias1)); conv1 runs as m64n32k16 wgmma on
//   the slot, the slot is released, and its rounded result goes to a
//   32-channel tile whose 16-byte chunks are swizzled per pixel pair;
// * stage 1 (a 644-byte frame stride, which TMA cannot take): the producer
//   warp stages the frames with 4-byte cp.async, completing on the same
//   mbarrier ring;
// * the window product: each 64-row m-tile's im2col A operand is gathered
//   from the staged tile by ldmatrix (stage 1: 32-bit loads, one pixel a k
//   pair) and fed to m64n64k16 wgmma in register-A form; y, m and comb stay
//   in registers, their f32 accumulators packed in pairs to the bf16 A
//   fragments of the next wgmma;
// * the weights (wmain, the block-diagonal gate, W2, W1) are packed once on
//   the host in the canonical K-major 128-byte-swizzled wgmma B layout
//   (ops/cuda/convblock.py::wgmma_image) and come in by one bulk copy on
//   the first tile's barrier;
// * the output tile is staged in shared memory (swizzled) and leaves as
//   16-byte stores, full 128-byte rows, coalesced.
// The tile plan (tt, grid, shared-memory bytes) comes from
// ops/cuda/convblock.py::bf16_plan; this file checks the bytes against its
// own layout.
#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kG = 32;          // BiConvGLU gate width
constexpr int kC = 64;          // stage output channels
constexpr int kConsumerWG = 2;  // consumer warpgroups
constexpr int kConsumers = 128 * kConsumerWG;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kRing = 2;                   // input slots
constexpr int kSmemMax = 232448;           // dynamic shared memory a block may use

using bf16_t = __nv_bfloat16;

struct Params {
  const bf16_t* x;       // stage 1: [B, T, 161, 2] (stages 2-5 through the tensor map)
  const float* bias_b;   // [B, 64]
  const float* bias1;    // [B, 32], stages 2-5
  const uint8_t* wpack;  // the B images
  const float* bg;       // [64]
  const float* b2;       // [64]
  const float* alpha;    // [1]
  bf16_t* out;           // [B, T, Fo, 64]
  int T, F, Fo, tt, tiles_per_utt, n_tiles;
  int bias_b_stride, bias1_stride;  // batch strides of the biases (0: one row)
  int w_bytes, slot_bytes, tile_bytes, xs1_bytes;
  int x_off, xs1_off, o_off, bar_off;
};

// Shared-memory layout of one block (offsets from a 1024-byte aligned base).
struct Layout {
  int w_bytes, slot_bytes, xs1_bytes, x_off, xs1_off, o_off, bar_off, total;
};

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// c: input channels (2 or 64), kf: frequency taps, F: input frequencies,
// tt: output frames a tile.  ops/cuda/convblock.py::bf16_smem_bytes mirrors it.
Layout layout(int c, int kf, int F, int tt) {
  Layout L{};
  const bool tma = c == 64;
  const int k = 2 * kf * (tma ? kG : c);
  L.w_bytes = (k + 63) / 64 * 8192 + 8192 + 8192 + (tma ? 4096 : 0);
  const int pixels = (tt + 1) * F;
  L.slot_bytes = tma ? round_up(pixels, 64) * 128 : round_up(pixels * 4, 1024);
  L.xs1_bytes = tma ? round_up((pixels + 1) / 2 * 128, 1024) : 0;
  L.x_off = L.w_bytes;
  L.xs1_off = L.x_off + kRing * L.slot_bytes;
  L.o_off = L.xs1_off + 2 * L.xs1_bytes;
  L.bar_off = L.o_off + kConsumerWG * 64 * 128;
  L.total = L.bar_off + 2 * kRing * 8 + 1024;  // + slack to align the base
  return L;
}

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts 2^26 tries (seconds) traps: a lost arrival fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One bulk copy of `bytes` (a multiple of 16) global -> shared on `bar`.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The TMA box at (c0, c1, c2, c3) of a 4-D tensor map -> shared, on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// 4 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Arrive on `bar` once this thread's cp.asyncs have landed (no pending count).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Descriptor of a K-major operand in the 128-byte swizzle: rows 128 bytes
// apart, 8-row groups 1024 bytes apart; `addr` is the first row's k offset.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator accesses across a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] += A (registers, bf16) @ B (shared, descriptor); f32 sums.
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 32] += A (shared, descriptor) @ B (shared, descriptor); f32 sums.
__device__ __forceinline__ void wgmma_n32_ss(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// ------------------------------------------------------------------ math

// Two floats rounded to bf16 (nearest, ties to even), lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 1 / (1 + e^-v) on the special-function unit (ex2 and rcp, ~2^-21
// relative; the IEEE expf and divide made the kernel 1.6x slower), far
// below the bf16 step of comb
__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }

// Accumulator register i of a lane (lane = 4g + t, warp w of the warpgroup)
// holds row 16w + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2t + (i & 1):
// per n8 tile the m16n8 layout of mma.sync.  The A fragment of k16 step s
// from n-tiles 2s, 2s + 1, rounded to bf16 (register-A wgmma takes the
// m16n8k16 A layout per warp).
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N], int s) {
  a[0] = pack(d[8 * s + 0], d[8 * s + 1]);
  a[1] = pack(d[8 * s + 2], d[8 * s + 3]);
  a[2] = pack(d[8 * s + 4], d[8 * s + 5]);
  a[3] = pack(d[8 * s + 6], d[8 * s + 7]);
}

// Accumulators of N columns set to the bias of each register's column.
template <int N>
__device__ __forceinline__ void init_acc(float (&d)[N / 2], const float* __restrict__ bias) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    d[4 * j] = d[4 * j + 2] = __ldg(bias + 8 * j + 2 * t4);
    d[4 * j + 1] = d[4 * j + 3] = __ldg(bias + 8 * j + 2 * t4 + 1);
  }
}

// Byte offset of (pixel p, channel c) in the 32-channel conv1 tile: two
// pixels a 128-byte line, its 16-byte chunks XOR-swizzled by the line.
__device__ __forceinline__ uint32_t xs1_offset(int p, int c) {
  const int line = p >> 1, chunk = ((p & 1) << 2) | (c >> 3);
  return line * 128 + ((chunk ^ (line & 7)) << 4) + (c & 7) * 2;
}

// Start conv1 of the slot's m-tile i (64 pixels, 64 -> 32 channels) into d.
__device__ __forceinline__ void conv1_start(float (&d)[16], uint32_t slot, uint32_t w1, int i) {
#pragma unroll
  for (int e = 0; e < 16; ++e) d[e] = 0.f;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_n32_ss(d, desc_sw128(slot + i * 8192 + ks * 32), desc_sw128(w1 + ks * 32));
  wgmma_commit();
}

// conv1's rounding of m-tile i, bf16(f32(bf16(d)) + bias1), into the
// 32-channel tile (pixels past the tile dropped); d's wgmma has completed.
__device__ __forceinline__ void conv1_store(float (&d)[16], unsigned char* xs1,
                                            const float (&b1)[8], int i, int pixels) {
  fence_regs(d);
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int px = i * 64 + wl * 16 + (lane >> 2) + 8 * h;
    if (px < pixels) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(xs1 + xs1_offset(px, 8 * j + 2 * (lane & 3))) =
            pack(bf16_round(d[4 * j + 2 * h]) + b1[2 * j],
                 bf16_round(d[4 * j + 2 * h + 1]) + b1[2 * j + 1]);
    }
  }
}

// ------------------------------------------------------------------ kernel

// C = 2: stage 1 (cp.async staging, K = 20); C = 64: stages 2-5 (TMA,
// conv1 in the kernel, K = 192).
template <int C, int KF>
__global__ void __launch_bounds__(kThreads, 1)
    enc_chain_bf16_kernel(const __grid_constant__ CUtensorMap xmap, const Params p) {
  constexpr bool kTma = C == 64;
  constexpr int CW = kTma ? kG : C;  // channels the window reads
  constexpr int K = 2 * KF * CW, KS = (K + 15) / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sb = smem_u32(smem);
  const uint32_t full = sb + p.bar_off, empty = full + 8 * kRing;
  const uint32_t w_main = sb, w_gate = w_main + (K + 63) / 64 * 8192, w_2 = w_gate + 8192,
                 w_1 = w_2 + 8192;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, kTma ? 1 : 32);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---------------------------------------------------------- producer
    int it = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++it) {
      const int s = it % kRing, use = it / kRing;
      if (use > 0) mbar_wait(empty + 8 * s, (use - 1) & 1);
      const int b = tile / p.tiles_per_utt, t0 = (tile % p.tiles_per_utt) * p.tt;
      const uint32_t slot = sb + p.x_off + s * p.slot_bytes, bar = full + 8 * s;
      if constexpr (kTma) {
        if (lane == 0) {
          mbar_arrive_expect_tx(bar, p.tile_bytes + (it == 0 ? p.w_bytes : 0));
          if (it == 0) bulk_g2s(w_main, p.wpack, p.w_bytes, bar);
          tma_load_4d(slot, &xmap, bar, 0, 0, t0 - 1, b);
        }
      } else {
        if (lane == 0 && it == 0) {
          mbar_expect_tx(bar, p.w_bytes);
          bulk_g2s(w_main, p.wpack, p.w_bytes, bar);
        }
        const int n = (p.tt + 1) * p.F;
        for (int e = lane; e < n; e += 32) {
          const int tin = t0 - 1 + e / p.F;
          const bool ok = tin >= 0 && tin < p.T;
          const bf16_t* src =
              ok ? p.x + ((static_cast<size_t>(b) * p.T + tin) * p.F + e % p.F) * C : p.x;
          cp_async4(slot + 4 * e, src, ok);
        }
        cp_async_arrive(bar);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int tid = threadIdx.x & 127;  // thread of the warpgroup
  const float alpha = __ldg(p.alpha);
  unsigned char* ostage = smem + p.o_off + wg * 8192;
  const uint32_t ostage_u = smem_u32(ostage);
  int it = 0;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++it) {
    const int s = it % kRing;
    mbar_wait(full + 8 * s, (it / kRing) & 1);
    const int b = tile / p.tiles_per_utt, t0 = (tile % p.tiles_per_utt) * p.tt;
    const int rows = min(p.tt, p.T - t0) * p.Fo;  // valid output rows of this tile
    // the biases' rows (0 where one row serves every utterance), times a
    // constant stride: a runtime stride made ptxas spill (8 % slower)
    const int row_b = p.bias_b_stride ? b : 0, row_1 = p.bias1_stride ? b : 0;
    const uint32_t slot = sb + p.x_off + s * p.slot_bytes;
    uint32_t xw = slot;  // the tile the window reads
    if constexpr (kTma) {
      // conv1 on the (tt + 1) F pixels of the slot, 64 at a time
      const int pixels = (p.tt + 1) * p.F;
      unsigned char* xs1 = smem + p.xs1_off + (it & 1) * p.xs1_bytes;
      xw = smem_u32(xs1);
      float b1[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b1[2 * j] = __ldg(p.bias1 + row_1 * kG + 8 * j + 2 * t4);
        b1[2 * j + 1] = __ldg(p.bias1 + row_1 * kG + 8 * j + 2 * t4 + 1);
      }
      // (two accumulators in flight, one m-tile apart, make ptxas serialize
      // every wgmma of the kernel: C7518, a wait on a divergent path)
      for (int i = wg; i * 64 < pixels; i += kConsumerWG) {
        float d[16];
        conv1_start(d, slot, w_1, i);
        wgmma_wait();
        conv1_store(d, xs1, b1, i, pixels);
      }
      mbar_arrive(empty + 8 * s);  // this thread's reads of the slot are done
      named_sync(1, kConsumers);   // the conv1 tile is complete
    }

    for (int mt = wg; mt * 64 < rows; mt += kConsumerWG) {
      // y = col @ W + bias_b[b]: the window's A fragments, then 12 (2) wgmma
      uint32_t a[KS][4];
      if constexpr (kTma) {
        // ldmatrix x4: lane supplies row (lane & 7) + 8 ((lane >> 3) & 1) of
        // the warp's 16, at k chunk 8 (lane >> 4) of each k16 step
        int r = mt * 64 + wl * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        r = r < rows ? r : 0;  // rows past the tile read row 0
        const int base = (r / p.Fo) * p.F + 2 * (r % p.Fo);
        const int c0 = 8 * (lane >> 4);
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          const int tap = st >> 1, kt = tap / KF, kf = tap % KF;
          ldmatrix_x4(a[st], xw + xs1_offset(base + kt * p.F + kf, 16 * (st & 1) + c0));
        }
      } else {
        int off[2];  // byte offset of each of this lane's rows' window origin
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int r = mt * 64 + wl * 16 + g + 8 * h;
          r = r < rows ? r : 0;
          off[h] = ((r / p.Fo) * p.F + 2 * (r % p.Fo)) * 4;
        }
        // k pair q is tap q (C = 2): pixel (kt, kf); pairs past K read the
        // origin (zero weights)
        auto toff = [&](int q) { return q < 2 * KF ? ((q / KF) * p.F + q % KF) * 4 : 0; };
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          const int k0 = toff(8 * st + t4), k1 = toff(8 * st + 4 + t4);
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(a[st][0]) : "r"(xw + off[0] + k0));
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(a[st][1]) : "r"(xw + off[1] + k0));
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(a[st][2]) : "r"(xw + off[0] + k1));
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(a[st][3]) : "r"(xw + off[1] + k1));
        }
      }
      float y[32];
      init_acc<64>(y, p.bias_b + row_b * kC);
      fence_regs(y);
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < KS; ++st)
        wgmma_n64_rs(y, a[st], desc_sw128(w_main + (st >> 2) * 8192 + (st & 3) * 32));
      wgmma_commit();
      wgmma_wait();
      fence_regs(y);

      // m = bf16(y) @ blockdiag(Wl, Wr) + bg: m's n8 tiles 0-3 from y's
      // k16 steps 0-1 (Wl), tiles 4-7 from steps 2-3 (Wr)
      float m[32];
      init_acc<64>(m, p.bg);
      uint32_t ay[4][4];
#pragma unroll
      for (int st = 0; st < 4; ++st) acc_to_a(ay[st], y, st);
      fence_regs(m);
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < 4; ++st) wgmma_n64_rs(m, ay[st], desc_sw128(w_gate + st * 32));
      wgmma_commit();
      wgmma_wait();
      fence_regs(m);

      // the cross gate, 32 wide, from the f32 y (columns j < 16 of 32 regs)
      float comb[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        comb[e] = y[e] * sigmoid(m[e + 16]) + y[e + 16] * sigmoid(m[e]);

      // out = PReLU(bf16(comb) @ W2 + b2)
      float o[32];
      init_acc<64>(o, p.b2);
      uint32_t ac[2][4];
#pragma unroll
      for (int st = 0; st < 2; ++st) acc_to_a(ac[st], comb, st);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < 2; ++st) wgmma_n64_rs(o, ac[st], desc_sw128(w_2 + st * 32));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);

      // stage the 64 x 64 tile (16-byte chunks swizzled by row), then full rows out
      named_sync(2 + wg, 128);  // the last m-tile's stores have read the stage
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = wl * 16 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v0 = o[4 * j + 2 * h], v1 = o[4 * j + 2 * h + 1];
          *reinterpret_cast<uint32_t*>(ostage + rr * 128 + ((j ^ (rr & 7)) << 4) + 4 * t4) =
              pack(v0 >= 0.f ? v0 : alpha * v0, v1 >= 0.f ? v1 : alpha * v1);
        }
      }
      named_sync(2 + wg, 128);
      uint4* dst = reinterpret_cast<uint4*>(
          p.out + ((static_cast<size_t>(b) * p.T + t0) * p.Fo + mt * 64) * kC);
      const int valid = min(64, rows - mt * 64);
#pragma unroll
      for (int q = tid; q < 64 * 8; q += 128) {
        const int rr = q >> 3, ch = q & 7;
        if (rr < valid) {
          uint4 v;
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                       : "r"(ostage_u + rr * 128 + ((ch ^ (rr & 7)) << 4)));
          dst[q] = v;
        }
      }
    }
    if constexpr (!kTma) mbar_arrive(empty + 8 * s);  // the window has read the slot
  }
}

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

template <int C, int KF>
int launch(const CUtensorMap& map, const Params& p, int grid, int smem, cudaStream_t stream) {
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
  enc_chain_bf16_kernel<C, KF><<<grid, kThreads, smem, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 x [B, T, F, C] -> bf16 out [B, T, Fo, 64], Fo = (F - kf) / 2 + 1, the
// causal pad frame before frame 0, for the two stage geometries of the
// encoder: (C, kf) = (2, 5), stage 1, and (64, 3), stages 2-5 with conv1
// (W1 [64, 32] in wpack, bias1 [B, 32] f32) in the kernel.  bias_b [B, 64]
// f32; the biases' rows bias_b_stride and bias1_stride floats apart (0: one
// row for every utterance); wpack the B images of
// convblock.py::pack_wgmma, 16-byte aligned; bg,
// b2 [64] f32; alpha [1] f32; x 16-byte aligned.  tt, grid and smem are the
// plan of convblock.py::bf16_plan.
int pdt_enc_stage_bf16(const void* x, const float* bias_b, const float* bias1,
                       const void* wpack, const float* bg, const float* b2, const float* alpha,
                       void* out, int B, int T, int F, int C, int kf, int bias_b_stride,
                       int bias1_stride, int tt, int grid, int smem, void* stream) {
  const int Fo = (F - kf) / 2 + 1;
  const bool tma = C == 64 && kf == 3;
  if (!tma && !(C == 2 && kf == 5)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(C, kf, F, tt);
  if (B < 1 || T < 1 || Fo < 1 || tt < 1 || tt > T || grid < 1 || smem != L.total ||
      (bias_b_stride != 0 && bias_b_stride != kC) || (bias1_stride != 0 && bias1_stride != kG) ||
      smem > kSmemMax || (tma && (F > 256 || tt + 1 > 256)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_per_utt = (T + tt - 1) / tt;
  const Params p{static_cast<const bf16_t*>(x),
                 bias_b,
                 bias1,
                 static_cast<const uint8_t*>(wpack),
                 bg,
                 b2,
                 alpha,
                 static_cast<bf16_t*>(out),
                 T,
                 F,
                 Fo,
                 tt,
                 tiles_per_utt,
                 B * tiles_per_utt,
                 bias_b_stride,
                 bias1_stride,
                 L.w_bytes,
                 L.slot_bytes,
                 (tt + 1) * F * C * 2,
                 L.xs1_bytes,
                 L.x_off,
                 L.xs1_off,
                 L.o_off,
                 L.bar_off};
  CUtensorMap map{};
  if (tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(F), static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {128, static_cast<cuuint64_t>(F) * 128,
                                   static_cast<cuuint64_t>(T) * F * 128};
    const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(F), static_cast<cuuint32_t>(tt + 1),
                               1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return tma ? launch<64, 3>(map, p, grid, smem, s) : launch<2, 5>(map, p, grid, smem, s);
}

}  // extern "C"
