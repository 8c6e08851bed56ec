// Forward flash attention (causal, sliding-window or bidirectional; GQA),
// in CUDA C++ for Hopper (sm_90a).  Built by repro_torch/kernels/build.py
// with nvcc into a shared library with a plain C interface, loaded with
// ctypes.
//
//   q: (B, S, H, dh)  k, v: (B, S, KV, dh)  ->  o: (B, S, H, dh)
//   bf16 or float32 in and out, float32 softmax state and accumulator;
//   dh in {16, 32, 64, 128, 256}
//
// Replaces _flash_kernel of src/repro/kernels/flash_attention.py (:33,
// pallas_call at :121) and computes what it computes: per (q-tile, k-tile)
// the scores q k^T * scale, the optional soft cap cap * tanh(s / cap), the
// mask (causal k <= q, window k > q - window, NEG_INF = -2^30 rather than
// -inf), then the online softmax with a float32 accumulator, and at the end
// acc / max(l, 1e-30).  Tiles that lie wholly above the diagonal or wholly
// before the window are never visited, as pl.when(live) skips them.  The
// sequential k axis of the TPU grid becomes a loop inside the block, and
// its VMEM scratch (acc, m, l) becomes registers.  GQA: head h reads KV
// head h / (H / KV), through the strides, with no repeat and no transposed
// copy.  The last tile is ragged: q rows past S are not written, k/v rows
// past S are loaded as zeros and masked, so S need not divide into tiles
// (the reference asserts it does).
//
// Two kernels, one per input type:
//
// * bf16 (the serve path): flash_attention_bf16_kernel, one kernel for
//   every dh, warp-specialised on TMA and wgmma.
//   - CTA: 3 warpgroups, 384 threads, one CTA per (128 q rows, head,
//     batch).  Warpgroup 0 produces: after setmaxnreg.dec to 24 registers
//     one of its threads issues every TMA load.  Warpgroups 1 and 2
//     consume, 64 q rows each, after setmaxnreg.inc to 240 registers
//     (24 x 128 + 240 x 256 = 64,512 of the SM's 65,536): at dh 256 a
//     consumer's O accumulator alone is 64 x 256 float32, 128 registers a
//     thread.
//   - Shared memory: the Q tile (128 x dh, loaded once) and a ring of
//     kFaStages = 2 stages of one K and one V tile (64 keys x dh each),
//     with a "full" and an "empty" mbarrier per stage.  The producer
//     waits "empty" (parity flipped, so each stage's first round passes),
//     then loads K and V onto "full" with their byte count; the consumers
//     wait "full" and each of their 8 warps arrives on "empty" once its
//     P V product has retired, whether or not its rows needed the tile.
//     At dh 256: Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB of the 227 KB
//     a block may hold, opted in with cudaFuncSetAttribute.
//   - TMA: 4-D tensor maps over (dh, heads, S, B) with the tensors' own
//     strides (the reference's (B, S, heads, dh) layout, or any view whose
//     strides are 16-byte multiples), built on the host by
//     cuTensorMapEncodeTiled, which the library reaches through
//     cudaGetDriverEntryPoint (no -lcuda), and passed as __grid_constant__
//     parameters.  A box row is one swizzle span: 32 B at dh 16, 64 B at
//     dh 32, 128 B (64 bf16) from dh 64 on, so a tile of dh 256 arrives as
//     4 boxes side by side.  Rows past S arrive as zeros.
//   - Products: S = Q K^T by wgmma m64n64k16, A and B both from shared
//     memory, K-major, dh / 16 steps.  O += P V by wgmma m64n{dh}k16 with
//     A = P from registers (the float32 accumulator layout of S is, pair
//     by pair, the bf16 A-fragment layout, so P is rounded to bf16 in
//     place, as the reference model casts p to v's dtype) and B = V from
//     shared memory with the transpose bit (V is keys x dh, MN-major for
//     this product).  The shared memory descriptors use the swizzle that
//     the tensor maps wrote.  A row of the softmax lives on the 4 lanes of
//     a quad and is reduced with two shuffles.
//   - Plan: the host (kernels/flash_attention.py, launch_plans) orders
//     the q tiles and works out each one's live k tiles, for the CTA and
//     for each consumer, with one definition (live_k_tiles, checked on
//     the CPU against the dense mask); it passes that table as a
//     __grid_constant__ FaPlan of at most kFaMaxTiles = 96 q tiles
//     (longer S takes several launches), and the kernel only reads it.
//     blockIdx.x walks the plan's tiles with heads and batch inner, the
//     tiles with the most live k tiles first (under a causal mask, the
//     last), so the light ones fill the last wave.  The producer loads
//     only the CTA's live k tiles; a consumer computes only its own.
// * float32 (the reference checks): flash_attention_f32_kernel, the
//   products on the float32 CUDA cores from shared memory, so that no
//   TF32 rounding enters.  One block of 128 threads per (32 q rows, head,
//   batch); thread (ty, tx) owns rows ty + 8i (i < 4) and accumulator
//   columns tx + 16c, scores against keys tx + 16j; a row's 16 owners sit
//   in one half-warp.  Rows padded to dh + 4 floats (float4 reads of 8
//   lanes on 8 rows hit 32 banks); one buffer holds K, then V.
//
// What bounds it: operations.  With L live (q, k) pairs it does
// 4 B H dh L flops (two products) and moves (2 B S H dh + 2 B S KV dh)
// elements.  At the hybrid prefill (S = 2100, window 2048, H = 10, KV = 1,
// dh = 256, bf16) that is 22.6 GFLOP, 22.8 us at the H100 SXM's published
// 989 TFLOP/s in bf16 (at its 700 W limit), against 7.1 us for its
// 23.7 MB.  wgmma is the only way to the tensor cores' full rate, and TMA
// on an mbarrier ring takes the loads off the warps that compute, so the
// next tile lands while this one is multiplied; the 10 heads share one KV
// head, 2.1 MB of K and V, which stays in L2.  The 170 CTAs of that call
// (17 q tiles x 10 heads, one CTA an SM) fill 132 SMs 1.29 times; the
// heaviest-first order puts the 38 lightest CTAs in the second wave.
// PERF.md holds the times chip_smoke.py measures.
//
// The kernels allocate nothing and do not synchronise: they launch on the
// stream the caller passes, and each entry point returns
// cudaGetLastError() (or cudaErrorInvalidValue for a tensor map that
// cuTensorMapEncodeTiled refuses).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_map.cuh"   // CUtensorMap; tensor_map_encoder

namespace {

constexpr int kBQ = 32;        // float32 kernel tiles
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr int kPS = kBK + 16;   // P row stride: the two rows of a warp
                                // land 16 banks apart
constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;   // strides in elements; the last dim is dense
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int S, H, KV;
  int causal;
  int window;   // <= 0: none
  float scale;
  float cap;    // <= 0: none
};

template <int DH>
__host__ __device__ constexpr int smem_floats() {
  return (kBQ + kBK) * (DH + 4) + kBQ * kPS;
}

// Rows [r0, r0 + rows) of one head into shared memory, row stride DH + 4
// floats; rows at or past S are zeros.  16-byte loads and stores.
template <int DH>
__device__ __forceinline__ void load_tile_f32(const float* __restrict__ base,
                                              long long row_stride, int r0,
                                              int rows, int S, float* sm) {
  constexpr int kChunks = DH / 4;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int d0 = (c - r * kChunks) * 4;
    const int s = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S)
      v = __ldg(reinterpret_cast<const float4*>(
          base + static_cast<long long>(s) * row_stride + d0));
    *reinterpret_cast<float4*>(sm + r * (DH + 4) + d0) = v;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32_kernel(const Params p) {
  constexpr int SD = DH + 4;
  constexpr int NC = DH / 16;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + kBQ * SD;
  float* sP = sKV + kBK * SD;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int S = p.S;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb =
      static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vb =
      static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_tile_f32<DH>(qb, p.q_ss, q0, kBQ, S, sQ);

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // live k-tiles only: none wholly above the diagonal or before the window
  const int nk = (S + kBK - 1) / kBK;
  int kt_lo = 0, kt_hi = nk;
  if (p.causal) kt_hi = min(nk, min(q0 + kBQ - 1, S - 1) / kBK + 1);
  if (p.window > 0) kt_lo = max(0, q0 - p.window + 1) / kBK;
  __syncthreads();

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    load_tile_f32<DH>(kb, p.k_ss, k0, kBK, S, sKV);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty + 8 * i) * SD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sKV + (tx + 16 * j) * SD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 8 * i;
      float mcur = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
        bool live = col < S;
        if (p.causal) live = live && col <= row;
        if (p.window > 0) live = live && col > row - p.window;
        s[i][j] = live ? x : kNegInf;
        mcur = fmaxf(mcur, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, off));
      const float mnew = fmaxf(m[i], mcur);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(s[i][j] - mnew);
        sP[(ty + 8 * i) * kPS + tx + 16 * j] = pj;
        psum += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m[i] - mnew);
      l[i] = l[i] * alpha + psum;
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();   // every warp is done with K (and P is written)

    load_tile_f32<DH>(vb, p.v_ss, k0, kBK, S, sKV);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 8 * i) * kPS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sKV[j * SD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
    __syncthreads();   // V and P are free for the next tile
  }

  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = ob + static_cast<long long>(row) * p.o_ss;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[i][c] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma and TMA, warp-specialised
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kFaBQ = 128;        // q rows of a CTA: 2 consumers x 64
constexpr int kFaBK = 64;         // keys of a k tile
constexpr int kFaStages = 2;      // K/V tiles in flight
constexpr int kFaThreads = 384;   // producer warpgroup + 2 consumers
constexpr int kFaMaxTiles = 96;   // q tiles in one launch's plan
constexpr float kLog2e = 1.4426950408889634f;

// One tensor map as the wrapper plans it (kernels/flash_attention.py,
// tensor_map_spec): dims (dh, heads, S, B), the byte strides of heads, S
// and B, the box, and the swizzle span in bytes.
struct TmaSpec {
  unsigned long long base;
  unsigned long long dims[4];
  unsigned long long strides[3];
  unsigned int box[4];
  unsigned int swizzle;
};

struct FaParams {
  bf16* o;
  long long o_sb, o_ss, o_sh;   // elements; the last dim is dense
  int S, H, KV, B;
  int causal;
  int window;                   // <= 0: none
  float scale;
  float cap;                    // <= 0: none
};

// One q tile of a launch: the live k tiles [lo, hi) of its CTA and
// [c_lo[c], c_hi[c]) of consumer c's 64 rows.
struct FaTile {
  int qt;
  int lo, hi;
  int c_lo[2], c_hi[2];
};

// The launch plan (kernels/flash_attention.py, launch_plans), passed by
// value: CTA i runs tile i / (H B), head i % (H B) % H, batch
// i % (H B) / H.  The kernel computes no order and no live range itself.
struct FaPlan {
  int n;
  FaTile tile[kFaMaxTiles];
};

static_assert(sizeof(FaTile) == 28, "FaTile is 7 ints");
static_assert(3 * sizeof(CUtensorMap) + sizeof(FaParams) + sizeof(FaPlan) <=
                  4096,
              "the kernel's parameters must fit 4,096 bytes");

// Shared memory of one CTA at head dim DH.  A box row is one swizzle span
// (kSwizzle bytes, kBoxCols bf16); a tile of R rows is kBoxes boxes of
// R x kSwizzle bytes side by side.  Q, then per stage K and V, then the
// barriers; every tile starts on a 1,024-byte boundary (the period of
// the 128-byte swizzle).
template <int DH>
struct FaSmem {
  static constexpr int kSwizzle = DH >= 64 ? 128 : 2 * DH;
  static constexpr int kBoxCols = kSwizzle / 2;
  static constexpr int kBoxes = DH / kBoxCols;
  static constexpr int kQBytes = kFaBQ * DH * 2;
  static constexpr int kTileBytes = kFaBK * DH * 2;   // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = kQBytes + kFaStages * kStageBytes;
  static constexpr int kBytes = kBarOffset + 64 + 1024;   // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma's shared memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode (1: 128 B,
// 2: 64 B, 3: 32 B), the same swizzle as the tensor map that wrote it.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  const uint64_t mode = swizzle == 128 ? 1 : swizzle == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 64, float32) (+)= A (64 x 16) B (16 x 64): A and B from shared
// memory through their descriptors, both K-major; scale_d = 0 overwrites.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 16, float32) += A (64 x 16, bf16 in registers) B (16 x 16): B
// from shared memory through its descriptor, MN-major (transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 32, float32) += A (64 x 16, bf16 in registers) B (16 x 32): B
// from shared memory through its descriptor, MN-major (transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 64, float32) += A (64 x 16, bf16 in registers) B (16 x 64): B
// from shared memory through its descriptor, MN-major (transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128, float32) += A (64 x 16, bf16 in registers) B (16 x 128): B
// from shared memory through its descriptor, MN-major (transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 256, float32) += A (64 x 16, bf16 in registers) B (16 x 256): B
// from shared memory through its descriptor, MN-major (transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Scale, cap and mask one consumer's 64 x 64 scores in registers, then
// the online softmax step: new row maxima, the rescale of l and O, and P
// in place of S.  Accumulator layout of wgmma m64nN (mma.sync's, per 8
// columns): warp w holds rows 16w + g and 16w + g + 8 (g = lane / 4);
// d[4j], d[4j + 1] are row 16w + g, columns 8j + 2t and 8j + 2t + 1
// (t = lane % 4); d[4j + 2], d[4j + 3] the same columns of row
// 16w + g + 8.  A row lives on the 4 lanes of a quad.
template <int DH>
__device__ __forceinline__ void softmax_step(float (&s)[32],
                                             float (&o)[DH / 2],
                                             float (&m)[2], float (&l)[2],
                                             const FaParams& p, int k0,
                                             int r_first, const int (&row)[2],
                                             int t) {
  // a tile that no mask touches for any of the 64 rows skips the tests
  const bool dense =
      k0 + kFaBK <= p.S && (!p.causal || k0 + kFaBK - 1 <= r_first) &&
      (p.window <= 0 || k0 > r_first + 63 - p.window);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int half = e >> 1;
      float x = s[4 * j + e] * p.scale;
      if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
      if (!dense) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        bool live = col < p.S;
        if (p.causal) live = live && col <= row[half];
        if (p.window > 0) live = live && col > row[half] - p.window;
        x = live ? x : kNegInf;
      }
      s[4 * j + e] = x;
      mx[half] = fmaxf(mx[half], x);
    }
  float alpha[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
    const float mnew = fmaxf(m[half], mx[half]);
    alpha[half] = exp2f((m[half] - mnew) * kLog2e);
    m[half] = mnew;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int half = e >> 1;
      const float pe = exp2f((s[4 * j + e] - m[half]) * kLog2e);
      s[4 * j + e] = pe;
      sum[half] += pe;
    }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
    sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
    l[half] = l[half] * alpha[half] + sum[half];
  }
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

template <int DH>
__global__ void __launch_bounds__(kFaThreads, 1)
    flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const FaParams p,
                                const __grid_constant__ FaPlan plan) {
  using L = FaSmem<DH>;
  extern __shared__ uint8_t fa_smem[];
  const uint32_t base = (smem_u32(fa_smem) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = base + L::kQBytes;        // stage s: K, then V
  const uint32_t bar_full = base + L::kBarOffset;   // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kFaStages;   // + 8 s
  const uint32_t bar_q = bar_empty + 8 * kFaStages;

  // the plan's tile; heads, then batch, inner
  const int hb = p.H * p.B;
  const FaTile& tile = plan.tile[blockIdx.x / hb];
  const int h = static_cast<int>(blockIdx.x) % hb % p.H;
  const int b = static_cast<int>(blockIdx.x) % hb / p.H;
  const int q0 = tile.qt * kFaBQ;
  const int lo = tile.lo;
  const int n_live = tile.hi - tile.lo;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kFaStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);     // the producer's expect_tx
      mbar_init(bar_empty + 8 * s, 8);    // one per consumer warp
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load, Q once, then K and V of
    // each live k tile into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int kvh = h / (p.H / p.KV);
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load_4d(sQ + c * kFaBQ * L::kSwizzle, &tm_q, bar_q,
                    c * L::kBoxCols, h, q0, b);
      for (int i = 0; i < n_live; ++i) {
        const int s = i % kFaStages;
        const uint32_t full = bar_full + 8 * s;
        // the first round of each stage passes: its buffer starts empty
        mbar_wait(bar_empty + 8 * s, ((i / kFaStages) & 1) ^ 1);
        mbar_expect_tx(full, L::kStageBytes);
        const int k0 = (lo + i) * kFaBK;
        const uint32_t sk = sKV + s * L::kStageBytes;
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_4d(sk + c * kFaBK * L::kSwizzle, &tm_k, full,
                      c * L::kBoxCols, kvh, k0, b);
          tma_load_4d(sk + L::kTileBytes + c * kFaBK * L::kSwizzle, &tm_v,
                      full, c * L::kBoxCols, kvh, k0, b);
        }
      }
    }
  } else {
    // consumers: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r_first = q0 + 64 * c;
    const int row[2] = {r_first + 16 * warp + g, r_first + 16 * warp + g + 8};
    const int c_lo = tile.c_lo[c];
    const int c_hi = tile.c_hi[c];

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    constexpr int kSteps = L::kBoxCols / 16;   // k16 steps in one box row
    const uint32_t q_rows = sQ + 64 * c * L::kSwizzle;
    mbar_wait(bar_q, 0);

    for (int i = 0; i < n_live; ++i) {
      const int s = i % kFaStages;
      const int kt = lo + i;
      mbar_wait(bar_full + 8 * s, (i / kFaStages) & 1);
      if (kt >= c_lo && kt < c_hi) {
        const uint32_t sk = sKV + s * L::kStageBytes;
        const uint32_t sv = sk + L::kTileBytes;
        // S = Q K^T: dh / 16 steps, both K-major; a step advances 32
        // bytes along a swizzled row, or to the next box
        float sc[32];
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const int box = kk / kSteps;
          const uint32_t col = (kk % kSteps) * 32;
          const uint64_t da =
              smem_desc(q_rows + box * kFaBQ * L::kSwizzle + col, 16,
                        8 * L::kSwizzle, L::kSwizzle);
          const uint64_t db =
              smem_desc(sk + box * kFaBK * L::kSwizzle + col, 16,
                        8 * L::kSwizzle, L::kSwizzle);
          wgmma_ss_m64n64k16(sc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        softmax_step<DH>(sc, o, m, l, p, kt * kFaBK, r_first, row, t);

        // P (bf16, registers) V: A fragment kk holds keys 16kk..16kk+15
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // V is MN-major: a step is 16 key rows; boxes lie kFaBK rows
          // apart along dh
          const uint64_t dv =
              smem_desc(sv + kk * 16 * L::kSwizzle, kFaBK * L::kSwizzle,
                        8 * L::kSwizzle, L::kSwizzle);
          wgmma_rs(o, pa[kk], dv);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      // this warp is done with the stage (its products have retired)
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }

    // epilogue: normalise, round to bf16, store the rows below S
    bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (row[half] >= p.S) continue;
      const float denom = fmaxf(l[half], 1e-30f);
      bf16* orow = ob + static_cast<long long>(row[half]) * p.o_ss + 2 * t;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o[4 * j + 2 * half] / denom,
                      o[4 * j + 2 * half + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int opt_in(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  *done = true;
  return 0;
}

template <int DH>
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<DH>() * sizeof(float);
  static bool opted_in = false;
  const int rc = opt_in(flash_attention_f32_kernel<DH>, bytes,
                        &opted_in);
  if (rc) return rc;
  dim3 grid((p.S + kBQ - 1) / kBQ, p.H, B);
  flash_attention_f32_kernel<DH><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Rows past S (and any box past a tensor's end) arrive as zeros.
bool encode(const TmaSpec& s, CUtensorMap* map) {
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      s.swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : s.swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            reinterpret_cast<void*>(s.base),
            reinterpret_cast<const cuuint64_t*>(s.dims),
            reinterpret_cast<const cuuint64_t*>(s.strides),
            reinterpret_cast<const cuuint32_t*>(s.box), elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_bf16(const TmaSpec* const (&specs)[3], const FaParams& p,
                const FaPlan& plan, cudaStream_t stream) {
  using L = FaSmem<DH>;
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    if (specs[i]->swizzle != L::kSwizzle || specs[i]->box[0] != L::kBoxCols ||
        specs[i]->box[2] != static_cast<unsigned>(i ? kFaBK : kFaBQ) ||
        !encode(*specs[i], &maps[i]))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool opted_in = false;
  const int rc =
      opt_in(flash_attention_bf16_kernel<DH>, L::kBytes, &opted_in);
  if (rc) return rc;
  const long long ctas = static_cast<long long>(plan.n) * p.H * p.B;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_bf16_kernel<DH>
      <<<static_cast<unsigned>(ctas), kFaThreads, L::kBytes, stream>>>(
          maps[0], maps[1], maps[2], p, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 int64, (batch, seq, head) strides in elements of q, k, v, o.
// window <= 0 and cap <= 0 mean none.
extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* o,
                                          const long long* strides, int B,
                                          int S, int H, int KV, int dh,
                                          int causal, int window, float scale,
                                          float cap, void* stream) {
  if (B < 1 || S < 1 || H < 1 || KV < 1 || H % KV || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.S = S;
  p.H = H;
  p.KV = KV;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.cap = cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_f32<16>(p, B, st);
    case 32: return launch_f32<32>(p, B, st);
    case 64: return launch_f32<64>(p, B, st);
    case 128: return launch_f32<128>(p, B, st);
    case 256: return launch_f32<256>(p, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, k, v: the wrapper's TmaSpecs and plan: one FaPlan, all in host
// memory (the launch copies the plan into the kernel's parameters); o:
// the output, o_strides its (batch, seq, head) strides in elements.
extern "C" int flash_attention_bf16_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* o_strides, const void* plan, int B, int S, int H,
    int KV, int dh, int causal, int window, float scale, float cap,
    void* stream) {
  const FaPlan& pl = *static_cast<const FaPlan*>(plan);
  if (B < 1 || S < 1 || H < 1 || KV < 1 || H % KV || pl.n < 1 ||
      pl.n > kFaMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  FaParams p;
  p.o = static_cast<bf16*>(o);
  p.o_sb = o_strides[0];
  p.o_ss = o_strides[1];
  p.o_sh = o_strides[2];
  p.S = S;
  p.H = H;
  p.KV = KV;
  p.B = B;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.cap = cap;
  const TmaSpec* const specs[3] = {static_cast<const TmaSpec*>(q),
                                   static_cast<const TmaSpec*>(k),
                                   static_cast<const TmaSpec*>(v)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_bf16<16>(specs, p, pl, st);
    case 32: return launch_bf16<32>(specs, p, pl, st);
    case 64: return launch_bf16<64>(specs, p, pl, st);
    case 128: return launch_bf16<128>(specs, p, pl, st);
    case 256: return launch_bf16<256>(specs, p, pl, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
