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
// * bf16 (the serve path): flash_attention_bf16_kernel, tensor cores
//   through mma.sync.m16n8k16 (bf16 in, float32 sums).  One block of 4
//   warps per (64 q rows, head, batch); each warp owns 16 q rows outright,
//   so a row's max and sum are two xor-shuffles among the 4 lanes that
//   hold it and no warp waits on another's softmax.  Per k-tile of 64 keys:
//   S = Q K^T from the Q and K tiles in shared memory (A and B fragments
//   read as 32-bit words), the mask and online softmax on the S fragments
//   in registers, then P (rounded to bf16 in registers: the S accumulator
//   layout is the A operand's) times V, whose B fragments come through
//   ldmatrix.trans.  Shared memory holds Q, K and V as bf16, rows padded
//   to dh + 8 so that every fragment read and ldmatrix phase hits 32
//   distinct banks: 99 KB at dh = 256, dynamic, opted in with
//   cudaFuncSetAttribute.  P goes to bf16 before P V, as the reference
//   model's attention_chunked casts p to v's dtype.
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
// 989 TFLOP/s in bf16, against 7.1 us for its 23.7 MB.  mma.sync reaches
// only part of that rate (wgmma and TMA with a pipelined ring are the
// route to the rest), and this first version loads each tile before it
// computes on it, without overlap; PERF.md holds the times chip_smoke.py
// measures.
//
// The kernels allocate nothing and do not synchronise: they launch on the
// stream the caller passes, and the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;        // float32 kernel tiles
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr int kTcBQ = 64;      // bf16 tensor-core kernel tiles: 4 warps
constexpr int kTcBK = 64;      // of 16 q rows each
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
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

template <int DH>
__host__ __device__ constexpr int tc_smem_bytes() {
  return (kTcBQ + 2 * kTcBK) * (DH + 8) * 2;
}

// Rows [r0, r0 + rows) of one head into shared memory as bf16, row stride
// DH + 8; rows at or past S are zeros.  16-byte loads and stores.
template <int DH>
__device__ __forceinline__ void load_tile_bf16(const bf16* __restrict__ base,
                                               long long row_stride, int r0,
                                               int rows, int S, bf16* sm) {
  constexpr int kChunks = DH / 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int d0 = (c - r * kChunks) * 8;
    const int s = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s < S)
      v = __ldg(reinterpret_cast<const uint4*>(
          base + static_cast<long long>(s) * row_stride + d0));
    *reinterpret_cast<uint4*>(sm + r * (DH + 8) + d0) = v;
  }
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed on the way in
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const bf16* p) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Fragment layouts of mma.m16n8k16 (lane = 4 g + t):
//   A (16x16): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 8+2t..)  a3 (g+8, 8+2t..)
//   B (16x8):  b0 (k 2t..2t+1, n g)  b1 (k 8+2t.., n g)
//   C (16x8):  c0 c1 (g, 2t..2t+1)   c2 c3 (g+8, 2t..2t+1)
template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bf16_kernel(const Params p) {
  constexpr int SD = DH + 8;
  constexpr int ND = DH / 8;       // n-tiles of the output over dh
  constexpr int KD = DH / 16;      // k-steps of Q K^T over dh
  constexpr int NK = kTcBK / 8;    // n-tiles of S over the keys
  extern __shared__ uint4 smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);
  bf16* sK = sQ + kTcBQ * SD;
  bf16* sV = sK + kTcBK * SD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kTcBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int S = p.S;
  const int lr = warp * 16 + g;            // local rows lr and lr + 8
  const int rows[2] = {q0 + lr, q0 + lr + 8};

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_tile_bf16<DH>(qb, p.q_ss, q0, kTcBQ, S, sQ);

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const int nk = (S + kTcBK - 1) / kTcBK;
  int kt_lo = 0, kt_hi = nk;
  if (p.causal) kt_hi = min(nk, min(q0 + kTcBQ - 1, S - 1) / kTcBK + 1);
  if (p.window > 0) kt_lo = max(0, q0 - p.window + 1) / kTcBK;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kTcBK;
    load_tile_bf16<DH>(kb, p.k_ss, k0, kTcBK, S, sK);
    load_tile_bf16<DH>(vb, p.v_ss, k0, kTcBK, S, sV);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const bf16* qa = sQ + lr * SD + kd * 16 + 2 * t;
      const uint32_t a[4] = {lds32(qa), lds32(qa + 8 * SD), lds32(qa + 8),
                             lds32(qa + 8 * SD + 8)};
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const bf16* kp = sK + (n * 8 + g) * SD + kd * 16 + 2 * t;
        mma_bf16(s[n], a, lds32(kp), lds32(kp + 8));
      }
    }

    // scale, cap, mask; online softmax per row (4 lanes hold a row)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = rows[half];
      float mcur = kNegInf;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + n * 8 + 2 * t + e;
          float x = s[n][2 * half + e] * p.scale;
          if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
          bool live = col < S;
          if (p.causal) live = live && col <= row;
          if (p.window > 0) live = live && col > row - p.window;
          x = live ? x : kNegInf;
          s[n][2 * half + e] = x;
          mcur = fmaxf(mcur, x);
        }
      mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, 1));
      mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, 2));
      const float mnew = fmaxf(m[half], mcur);
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = expf(s[n][2 * half + e] - mnew);
          s[n][2 * half + e] = pe;
          psum += pe;
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      const float alpha = expf(m[half] - mnew);
      l[half] = l[half] * alpha + psum;
      m[half] = mnew;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * half] *= alpha;
        o[n][2 * half + 1] *= alpha;
      }
    }

    // O += P V: P's A fragments are S's C fragments, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int mi = lane >> 3;
      const bf16* vrow =
          sV + (kk * 16 + (lane & 7) + (mi & 1) * 8) * SD + (mi >> 1) * 8;
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + n * 8);
        mma_bf16(o[n], a, bv[0], bv[1]);
        mma_bf16(o[n + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();   // K and V are free for the next tile
  }

  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = rows[half];
    if (row >= S) continue;
    const float denom = fmaxf(l[half], 1e-30f);
    bf16* orow = ob + static_cast<long long>(row) * p.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][2 * half] / denom, o[n][2 * half + 1] / denom);
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

template <int DH>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t bytes = tc_smem_bytes<DH>();
  static bool opted_in = false;
  const int rc = opt_in(flash_attention_bf16_kernel<DH>, bytes, &opted_in);
  if (rc) return rc;
  dim3 grid((p.S + kTcBQ - 1) / kTcBQ, p.H, B);
  flash_attention_bf16_kernel<DH><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int launch_dh(const Params& p, int B, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return kBf16 ? launch_bf16<16>(p, B, stream)
                          : launch_f32<16>(p, B, stream);
    case 32: return kBf16 ? launch_bf16<32>(p, B, stream)
                          : launch_f32<32>(p, B, stream);
    case 64: return kBf16 ? launch_bf16<64>(p, B, stream)
                          : launch_f32<64>(p, B, stream);
    case 128: return kBf16 ? launch_bf16<128>(p, B, stream)
                           : launch_f32<128>(p, B, stream);
    case 256: return kBf16 ? launch_bf16<256>(p, B, stream)
                           : launch_f32<256>(p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 int64, (batch, seq, head) strides in elements of q, k, v, o.
// dtype: 0 float32, 1 bfloat16.  window <= 0 and cap <= 0 mean none.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B, int S,
                                      int H, int KV, int dh, int dtype,
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
  if (dtype == 0) return launch_dh<false>(p, B, dh, st);
  if (dtype == 1) return launch_dh<true>(p, B, dh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
