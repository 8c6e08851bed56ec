// The RG-LRU diagonal linear recurrence, in CUDA C++ for Hopper (sm_90a).
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.
//
//   h_t = a_t * h_{t-1} + b_t      a, b: (B, T, W) float32, h_{-1} = h0
//
// Replaces _rg_lru_kernel of src/repro/kernels/rg_lru.py (:24, pallas_call
// at :57).  The TPU kernel runs a grid (B, W/bw, T/bt) whose time axis is
// sequential, carrying h in VMEM scratch from one time block to the next.
// Here one lane owns one (b, w) channel and walks the whole of T with h in
// a register: a serial scan, as on the TPU.
//
// Arithmetic: each step is a multiply and then an add, each rounded
// (__fmul_rn, __fadd_rn keep nvcc from contracting them into one FMA), so
// the kernel gives the bits of its plain PyTorch version, which computes
// a[:, t] * h + b[:, t] as two rounded ops.
//
// What bounds it: bytes.  It reads a and b once and writes h once
// (12 B T W bytes) and reads h0 (4 B W).  At the hybrid prefill (B=1,
// T=2100, W=2560) that is 64.5 MB, 19.3 us at the H100 SXM's published
// 3.35 TB/s.  What kept the first version of this kernel (one thread per
// channel, 8 steps of loads ahead of its chain) at 14x its bound was the
// loads in flight: 2560 threads x 8 steps x 8 bytes = 164 KB across the
// card, where Little's law wants the read rate times the loaded latency,
// several MB.  The chain itself, one rounded multiply and one rounded add
// a step, fits under the byte bound if nothing else sits on it.  So the
// scan stays serial, a TMA producer keeps the loads in flight, and the
// consumer's loop holds nothing but the chain and shared memory traffic:
//
// - CTA: one per (batch row, tile of 16 or 32 channels), two warps.  Warp
//   0 produces; warp 1 runs the chains, lane l on channel c0 + l (at a
//   tile of 16 the upper half-warp repeats the lower one's chains).
// - Ring: `stages` stages in shared memory, each the next kSteps = 64
//   time steps of the tile's a and then of its b ([kSteps][tile] float32
//   each), with a full and an empty mbarrier per stage.  The producer
//   waits "empty" (parity flipped, so each stage's first round passes)
//   and loads a stage; the consumer waits "full" and, once its chains have
//   read the stage, one lane arrives on "empty".
// - Loads: where W % 4 == 0 (a tensor map's row stride must be a multiple
//   of 16 bytes) and a, b are 16-byte aligned, one producer thread issues
//   two TMA tile loads a stage, boxes of tile x kSteps x 1 over (W, T, B)
//   as a 3-D tensor map, built on the host by cuTensorMapEncodeTiled
//   (tensor_map.cuh) and passed as __grid_constant__ parameters; boxes
//   past T or W arrive as zeros.  Otherwise the same ring is filled by the
//   producer warp's 32 lanes with 4-byte cp.async, completing on the same
//   "full" barrier (cp.async.mbarrier.arrive.noinc, 32 arrivals); rows
//   past T and columns past W are not loaded.  A chain past T or W is
//   never written out.
// - Consumer: a lane reads its column of a stage (neighbouring lanes on
//   neighbouring words: no bank conflicts) kGroup steps at a time into
//   registers, loading the next group, across stage boundaries too,
//   before it runs the chain over this one.  The loop over a stage is
//   unrolled whole (kSteps is a constant), so the only instructions
//   beside the multiply and add of a step are its two shared loads and
//   one shared store: h_t goes into one of two h buffers ([kSteps][tile],
//   the layout of an output box).  After each stage one lane writes the
//   buffer out with a TMA tile store over the output's tensor map, which
//   drops rows past T and columns past W, and the other buffer takes the
//   next stage while the store reads this one.  On the cp.async route the
//   lanes store their column of the buffer themselves.
// - Plan (kernels/rg_lru.py::plan, passed as an LruPlan and checked
//   here): the tile is 32 channels where B * ceil(W / 32) CTAs cover the
//   SMs, else 16 (B=1, W=2560: 160 CTAs on 132 SMs); the ring has enough
//   stages that the CTAs hold 8 MiB of a and b (Little's law: about
//   2.2 TB/s of reads times 1.5-2 us of loaded latency is 3-4 MB; the
//   plan takes twice that), at least two, at most what fits 232,448 bytes
//   beside the h buffers and no more than the scan has.  B=1, W=2560:
//   7 stages of 8 KB a CTA, 9.2 MB in flight; B=4: 2 stages of 16 KB on
//   320 CTAs, 10.5 MB.  The tensor map (LruMap: dims, byte strides, box)
//   is planned on the host too (kernels/rg_lru.py::tensor_map) and
//   checked here against the shape and plan before it is encoded.
//
// PERF.md holds the times chip_smoke.py measures.  The kernel allocates
// nothing and does not synchronise: it launches on the stream the caller
// passes, and the entry point returns cudaGetLastError() (or
// cudaErrorInvalidValue for a plan or map it refuses).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_map.cuh"   // CUtensorMap; tensor_map_encoder

namespace {

constexpr int kThreads = 64;       // warp 0 produces, warp 1 runs chains
constexpr int kSteps = 64;         // time steps of a stage
constexpr int kGroup = 8;          // steps a lane holds ahead of its chain
constexpr int kMaxSmem = 232448;   // dynamic shared memory a CTA may use

// The wrapper's plan (kernels/rg_lru.py::plan).
struct LruPlan {
  int tile;     // channels of a CTA: 16 or 32
  int steps;    // time steps of a stage: kSteps
  int stages;   // ring depth
  int tma;      // 1: TMA tile loads (W % 4 == 0); 0: 4-byte cp.async
};

// One 3-D tensor map over a (B, T, W) float32 tensor (kernels/rg_lru.py::
// tensor_map): dims {W, T, B}, the byte strides of T and B, box
// {tile, steps, 1}.
struct LruMap {
  unsigned long long dims[3];
  unsigned long long strides[2];
  unsigned int box[3];
};

struct LruArgs {
  const float* a;
  const float* b;
  const float* h0;   // nullptr: zeros
  float* out;
  int T, W;
  int n_tiles;       // channel tiles of a batch row
  int stages;
};

__host__ __device__ constexpr int header_bytes(int stages) {
  // a full and an empty mbarrier per stage, padded so stages start
  // 128-aligned
  return ((16 * stages + 127) / 128) * 128;
}

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

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// One arrival on `bar` once every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// kGroup steps of a lane's column of a stage: a at col[u * TILE], b kRows
// floats later.
template <int TILE>
__device__ __forceinline__ void load_group(const float* col,
                                           float (&a)[kGroup],
                                           float (&b)[kGroup]) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    a[u] = col[u * TILE];
    b[u] = col[kSteps * TILE + u * TILE];
  }
}

template <int TILE, bool TMA>
__global__ void __launch_bounds__(kThreads)
    rg_lru_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_h,
                  const LruArgs p) {
  constexpr int kRows = kSteps * TILE;   // floats of a stage's a (or b)
  constexpr int kGroups = kSteps / kGroup;
  extern __shared__ __align__(128) uint8_t smem[];
  const int bi = blockIdx.x / p.n_tiles;
  const int c0 = (blockIdx.x - bi * p.n_tiles) * TILE;
  const int lane = threadIdx.x & 31;
  const uint32_t full = smem_u32(smem);          // stage s: full + 8 s
  const uint32_t empty = full + 8 * p.stages;    // stage s: empty + 8 s
  float* const ring = reinterpret_cast<float*>(smem + header_bytes(p.stages));
  float* const hring = ring + 2 * p.stages * kRows;   // two h buffers
  const int n_chunks = (p.T + kSteps - 1) / kSteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, TMA ? 1 : 32);
      mbar_init(empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {   // producer
    if (TMA && lane != 0) return;
    const int cols = min(TILE, p.W - c0);
    for (int k = 0; k < n_chunks; ++k) {
      const int s = k % p.stages;
      mbar_wait(empty + 8 * s, ((k / p.stages) & 1) ^ 1);
      float* sa = ring + 2 * s * kRows;
      float* sb = sa + kRows;
      const int t0 = k * kSteps;
      if (TMA) {
        mbar_expect_tx(full + 8 * s, 2 * kRows * 4);
        tma_load_3d(smem_u32(sa), &map_a, full + 8 * s, c0, t0, bi);
        tma_load_3d(smem_u32(sb), &map_b, full + 8 * s, c0, t0, bi);
      } else {
        const int live_rows = min(kSteps, p.T - t0);
        const long long base =
            (static_cast<long long>(bi) * p.T + t0) * p.W + c0;
        for (int i = lane; i < live_rows * TILE; i += 32) {
          const int r = i / TILE, c = i % TILE;
          if (c < cols) {
            const long long off = base + static_cast<long long>(r) * p.W + c;
            cp_async_4(smem_u32(sa + i), p.a + off);
            cp_async_4(smem_u32(sb + i), p.b + off);
          }
        }
        cp_async_arrive(full + 8 * s);
      }
    }
    return;
  }

  // consumer: lane l on channel c0 + l
  const int l = lane % TILE;
  const int c = c0 + l;
  float h = 0.f;
  if (p.h0 != nullptr && c < p.W)
    h = p.h0[static_cast<long long>(bi) * p.W + c];
  float av[kGroup], bv[kGroup];
  mbar_wait(full, 0);
  load_group<TILE>(ring + l, av, bv);
  int s = 0;
  for (int k = 0; k < n_chunks; ++k) {
    const float* const col = ring + 2 * s * kRows + l;   // this lane's column
    float* const hcol = hring + (k & 1) * kRows + l;
    const int sn = s + 1 == p.stages ? 0 : s + 1;
    if (TMA && k >= 2) {   // chunk k - 2's store has read this h buffer
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      __syncwarp();
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      // the next group's operands are loaded before this group's chain,
      // the last group's from the next stage (stale past the last chunk)
      const float* nxt = col + (g + 1) * kGroup * TILE;
      if (g + 1 == kGroups) {
        if (k + 1 < n_chunks)
          mbar_wait(full + 8 * sn, ((k + 1) / p.stages) & 1);
        nxt = ring + 2 * sn * kRows + l;
      }
      float na[kGroup], nb[kGroup];
      load_group<TILE>(nxt, na, nb);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
        hcol[(g * kGroup + u) * TILE] = h;
        av[u] = na[u];
        bv[u] = nb[u];
      }
    }
    __syncwarp();   // every lane has read stage s
    if (lane == 0) mbar_arrive(empty + 8 * s);
    // chunk k's h out: rows past T and columns past W are dropped
    const int t0 = k * kSteps;
    if (TMA) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) tma_store_3d(&map_h, smem_u32(hcol - l), c0, t0, bi);
    } else if (lane < TILE && c < p.W) {
      const int n = min(kSteps, p.T - t0);
      float* o = p.out + (static_cast<long long>(bi) * p.T + t0) * p.W + c;
      for (int r = 0; r < n; ++r, o += p.W) *o = hcol[r * TILE];
    }
    s = sn;
  }
  // the last stores have landed before the CTA (and its shared memory) goes
  if (TMA && lane == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The tensor map of a, b or out; boxes past T or W load as zeros, and a
// store drops them.
bool encode(const LruMap& m, const void* base, CUtensorMap* map) {
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base),
            reinterpret_cast<const cuuint64_t*>(m.dims),
            reinterpret_cast<const cuuint64_t*>(m.strides),
            reinterpret_cast<const cuuint32_t*>(m.box), elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TILE, bool TMA>
int launch(const CUtensorMap (&maps)[3], const LruArgs& p, unsigned ctas,
           size_t smem, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        rg_lru_kernel<TILE, TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  rg_lru_kernel<TILE, TMA><<<ctas, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], p);
  return static_cast<int>(cudaGetLastError());
}

bool map_matches(const LruMap& m, const LruPlan& pl, int B, int T, int W) {
  return m.dims[0] == static_cast<unsigned long long>(W) &&
         m.dims[1] == static_cast<unsigned long long>(T) &&
         m.dims[2] == static_cast<unsigned long long>(B) &&
         m.strides[0] == 4ULL * W &&
         m.strides[1] == 4ULL * T * static_cast<unsigned long long>(W) &&
         m.box[0] == static_cast<unsigned>(pl.tile) &&
         m.box[1] == static_cast<unsigned>(pl.steps) && m.box[2] == 1;
}

}  // namespace

// plan: one LruPlan; map: one LruMap (nullptr where plan->tma is 0), both
// in host memory.
extern "C" int rg_lru_scan_launch(const void* a, const void* b,
                                  const void* h0, void* out, int n_batch,
                                  int T, int W, const void* plan,
                                  const void* map, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (n_batch < 1 || T < 1 || W < 1 || plan == nullptr) return invalid;
  const LruPlan pl = *static_cast<const LruPlan*>(plan);
  // one stage serves only a scan of one stage: the consumer waits for
  // the next stage before it releases this one
  if ((pl.tile != 16 && pl.tile != 32) || pl.steps != kSteps ||
      pl.stages < 1 || (pl.stages < 2 && T > kSteps))
    return invalid;
  // the ring and the two h buffers, each of a stage's size
  const long long smem = header_bytes(pl.stages) +
                         2LL * (pl.stages + 1) * kSteps * pl.tile * 4;
  if (smem > kMaxSmem) return invalid;
  const int n_tiles = (W + pl.tile - 1) / pl.tile;
  const long long ctas = static_cast<long long>(n_tiles) * n_batch;
  if (ctas > 0x7fffffffLL) return invalid;
  CUtensorMap maps[3] = {};   // a, b, out: read only by the TMA route
  if (pl.tma) {
    const void* const bases[3] = {a, b, out};
    if (map == nullptr || W % 4) return invalid;
    const LruMap& m = *static_cast<const LruMap*>(map);
    if (!map_matches(m, pl, n_batch, T, W)) return invalid;
    for (int i = 0; i < 3; ++i)
      if (reinterpret_cast<uintptr_t>(bases[i]) % 16 ||
          !encode(m, bases[i], &maps[i]))
        return invalid;
  }
  LruArgs p;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.h0 = static_cast<const float*>(h0);
  p.out = static_cast<float*>(out);
  p.T = T;
  p.W = W;
  p.n_tiles = n_tiles;
  p.stages = pl.stages;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(ctas);
  const size_t bytes = static_cast<size_t>(smem);
  if (pl.tile == 16)
    return pl.tma ? launch<16, true>(maps, p, grid, bytes, st)
                  : launch<16, false>(maps, p, grid, bytes, st);
  return pl.tma ? launch<32, true>(maps, p, grid, bytes, st)
                : launch<32, false>(maps, p, grid, bytes, st);
}
