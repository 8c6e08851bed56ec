// Tiered stream copy, device memory -> shared memory -> device memory,
// through a ring of n_buffers stages, in CUDA C++ for Hopper (sm_90a).
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.
//
// Replaces _stream_copy_kernel of src/repro/kernels/streamcopy.py (:24,
// pallas_call at :81): the paper's multi-channel DMA engine, where
// n_buffers stands for the XDMA channel count and block_rows for the
// transfer size.  The TPU kernel copies an (R, C) array in blocks of
// block_rows rows through n_buffers VMEM buffers with one DMA semaphore
// pair each.  Per stage s and block i (s = i % n_buffers) it keeps one
// hazard rule, and so does this kernel:
//   wait load(i) -> start store(i) -> wait store(i) -> load(i + n_buffers)
// With n_buffers = 1 a block's load and store never overlap; with more,
// the loads of the next n_buffers - 1 blocks are in flight while block i
// is stored.
//
// Mechanism: the 1-D bulk copies of the Tensor Memory Accelerator, the
// Hopper counterpart of pltpu.make_async_copy plus a DMA semaphore.  A
// load is cp.async.bulk (global -> shared) completing on one mbarrier per
// stage (the "in" semaphore); a store is cp.async.bulk (shared -> global)
// in its own bulk group, and cp.async.bulk.wait_group.read 0 is the "out"
// semaphore's wait: it returns once the store has read the stage, which
// is what reusing the stage needs.  One thread per block issues every
// copy; the copy engine computes the addresses.
//
// Layout across the card.  A block of the sweep holds up to 256 KB
// (128 x 512 float32), more than the 227 KB of shared memory one CTA may
// use, and one CTA reaches only a small share of the card's memory rate.
// So every block's block_bytes contiguous bytes are cut into P slices of
// slice_bytes, a multiple of 128 so that every slice starts on a 128-byte
// line (only the last slice is shorter), one per CTA, and each CTA walks
// all blocks in order with its own ring of n_buffers slice-sized stages.
// Across the card n_buffers blocks are then in flight at once, as on the
// TPU, whatever P is.  The wrapper (kernels/streamcopy.py::plan) picks P
// so that about four stages sit on each SM: one CTA per SM with four
// buffers, two with two, four with one.  A CTA's copies are serial (its
// next load into a stage waits for the store that reads it), so an SM
// with one CTA of one or two stages idles between them; with several
// CTAs, one CTA's wait hides behind another's load.  P is raised where
// n_buffers stages would not fit 232,448 bytes and never exceeds one
// 128-byte line a slice.  The wrapper raises where no P fits and never
// changes block_rows or n_buffers.  Bulk copies need 16-byte aligned
// addresses and sizes: the wrapper raises unless both base pointers and
// block_bytes are multiples of 16.
//
// What bounds it: bytes.  Each byte is read once and written once,
// 2 * R * C * itemsize bytes over the H100 SXM's published 3.35 TB/s; no
// arithmetic.  The bytes in flight, n_buffers * block_bytes across the
// card, bound the rate by Little's law once they fall below the rate
// times the copy latency: the paper's small-transfer, single-channel
// flank, which the Fig-8 sweep reproduces.  Above it (4 MiB blocks, 2 or
// 4 buffers) the kernel stays a few percent short of Tensor.copy_: there
// P moves the rate little, and an evict-first L2 policy on the bulk
// copies, tried, slowed the 1 MiB blocks and the Fig-8 rows, so the copies
// carry no cache hint.  With four buffers P stays at the SM count, and
// 128-byte lines make the largest slice of a 4 MiB block 0.3% larger than
// an even cut into 16-byte multiples: that row is a little slower than
// one without lines.  PERF.md holds the times chip_smoke.py measured.
//
// The kernel allocates nothing and does not synchronise: it launches on
// the stream the caller passes, and the entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;   // dynamic shared memory a CTA may use
constexpr int kLine = 128;         // slices start on 128-byte lines

__host__ __device__ constexpr int header_bytes(int n_buffers) {
  // one 8-byte mbarrier per stage, padded so stages start 128-aligned
  return ((8 * n_buffers + 127) / 128) * 128;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void load_stage(uint32_t dst, const void* src,
                                           uint32_t bytes, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wait_loaded(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void store_stage(void* dst, uint32_t src,
                                            uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void stream_copy_kernel(const uint8_t* __restrict__ src,
                                   uint8_t* __restrict__ dst,
                                   long long block_bytes, int n_blocks,
                                   int slice_bytes, int n_buffers) {
  extern __shared__ __align__(128) uint8_t smem[];
  if (threadIdx.x != 0) return;
  const long long off = static_cast<long long>(blockIdx.x) * slice_bytes;
  if (off >= block_bytes) return;
  const long long left = block_bytes - off;
  const uint32_t len =
      static_cast<uint32_t>(left < slice_bytes ? left : slice_bytes);
  const uint32_t bars = smem_addr(smem);
  const uint32_t stages = bars + header_bytes(n_buffers);
  for (int s = 0; s < n_buffers; ++s) bar_init(bars + 8 * s);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  const int warm = n_blocks < n_buffers ? n_blocks : n_buffers;
  for (int s = 0; s < warm; ++s)
    load_stage(stages + s * slice_bytes, src + s * block_bytes + off, len,
               bars + 8 * s);
  for (int i = 0; i < n_blocks; ++i) {
    const int s = i % n_buffers;
    const uint32_t stage = stages + s * slice_bytes;
    wait_loaded(bars + 8 * s, static_cast<uint32_t>((i / n_buffers) & 1));
    store_stage(dst + i * block_bytes + off, stage, len);
    // the stage is free again once the store has read it
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    const int nxt = i + n_buffers;
    if (nxt < n_blocks)
      load_stage(stage, src + nxt * block_bytes + off, len, bars + 8 * s);
  }
  // every store has landed before the CTA (and its shared memory) goes
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" int stream_copy_launch(const void* src, void* dst,
                                  long long block_bytes, int n_blocks,
                                  int slice_bytes, int n_ctas, int n_buffers,
                                  void* stream) {
  if (block_bytes < 16 || block_bytes % 16 || n_blocks < 1 ||
      slice_bytes < kLine || slice_bytes % kLine || n_ctas < 1 ||
      n_buffers < 1)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(n_ctas - 1) * slice_bytes >= block_bytes ||
      static_cast<long long>(n_ctas) * slice_bytes < block_bytes)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(src) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16)
    return cudaErrorMisalignedAddress;
  const long long smem =
      header_bytes(n_buffers) + static_cast<long long>(n_buffers) * slice_bytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  stream_copy_kernel<<<n_ctas, 32, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      block_bytes, n_blocks, slice_bytes, n_buffers);
  return static_cast<int>(cudaGetLastError());
}
