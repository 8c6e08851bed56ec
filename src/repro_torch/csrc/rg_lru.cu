// The RG-LRU diagonal linear recurrence, in CUDA C++ for Hopper (sm_90a).
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.
//
//   h_t = a_t * h_{t-1} + b_t      a, b: (B, T, W) float32, h_{-1} = h0
//
// Replaces _rg_lru_kernel of src/repro/kernels/rg_lru.py (:24, pallas_call
// at :57).  The TPU kernel runs a grid (B, W/bw, T/bt) whose time axis is
// sequential, carrying h in VMEM scratch from one time block to the next.
// Blocks on Hopper run in no order, so nothing carries between them: here
// one thread owns one (b, w) channel and walks the whole of T with h in a
// register.  Neighbouring threads hold neighbouring w, so every load and
// store of a warp is one coalesced 128-byte line.  Each thread first loads
// kUnroll steps of a and b (independent of h, so they are all in flight at
// once), then runs the dependent chain over them.  T and W are ragged: no
// block size has to divide them.
//
// Arithmetic: each step is a multiply and then an add, each rounded
// (__fmul_rn, __fadd_rn keep nvcc from contracting them into one FMA), so
// the kernel gives the bits of its plain PyTorch version, which computes
// a[:, t] * h + b[:, t] as two rounded ops.
//
// What bounds it: bytes.  It reads a and b once and writes h once
// (12 B T W bytes) and reads h0 (4 B W): no operation count comes near.
// At the hybrid prefill (B=1, T=2100, W=2560) that is 64.5 MB, about 19 us
// at the H100 SXM's published 3.35 TB/s.  But B W = 2560 channels give
// only 2560 threads, 40 blocks of 64, on 132 SMs: too few loads in flight
// to reach that rate.  A chunked scan over T (per-chunk carries, then a
// pass that applies them) would fill the card; it is later work.  PERF.md
// holds the time chip_smoke.py measures.
//
// The kernel allocates nothing and does not synchronise: it launches on the
// stream the caller passes, and the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

__global__ void rg_lru_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              const float* __restrict__ h0,
                              float* __restrict__ out, int n_batch, int T,
                              int W) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n_batch) * W) return;
  const long long bi = idx / W;
  const long long w = idx - bi * W;
  const long long base = bi * T * W + w;
  float h = h0 != nullptr ? h0[bi * W + w] : 0.0f;
  int t = 0;
  for (; t + kUnroll <= T; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = base + static_cast<long long>(t + u) * W;
      av[u] = __ldg(a + off);
      bv[u] = __ldg(b + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      out[base + static_cast<long long>(t + u) * W] = h;
    }
  }
  for (; t < T; ++t) {
    const long long off = base + static_cast<long long>(t) * W;
    h = __fadd_rn(__fmul_rn(__ldg(a + off), h), __ldg(b + off));
    out[off] = h;
  }
}

}  // namespace

extern "C" int rg_lru_scan_launch(const void* a, const void* b,
                                  const void* h0, void* out, int n_batch,
                                  int T, int W, void* stream) {
  if (n_batch < 1 || T < 1 || W < 1) return cudaErrorInvalidValue;
  const long long channels = static_cast<long long>(n_batch) * W;
  const long long blocks = (channels + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rg_lru_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), n_batch, T,
      W);
  return static_cast<int>(cudaGetLastError());
}
