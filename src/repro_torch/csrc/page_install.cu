// Page pack and page install for the KV paging path, in CUDA C++ for
// Hopper (sm_90a).  Built by repro_torch/kernels/build.py with nvcc into a
// shared library with a plain C interface, loaded with ctypes.
//
// Replaces the TPU kernels of src/repro/kernels/page_install.py:
//   pack_page_kernel     <- _pack_group_kernel (:477), called per dtype
//                           group from _pack_pallas (:502) and stitched by
//                           _pack_stitch (:535).
//   install_pages_kernel <- _install_group_kernel (:355), called per dtype
//                           group from _install_pallas (:411).
//
// Page format (unchanged): a page is every cache leaf's C-order bytes,
// concatenated in tree-flatten order with no gaps.  So the pack is one
// launch over all leaves that writes every byte of the page exactly once:
// the TPU version's zeroed span images and the stitch that adds them have
// no counterpart here.  The install is one launch over all G pages and all
// leaves that have a slot axis; it writes in place into the batch cache,
// where the TPU version aliased its outputs to its inputs.
//
// What bounds them: memory.  Each moves 2 x page_bytes x G bytes (read
// once, written once) and does no arithmetic.  For qwen2-0.5b at max_len
// 128 a page is 1,572,960 bytes: 0.94 us at the H100 SXM's published
// 3.35 TB/s (the rate at its full 700 W power limit), so at that size the
// launch latency dominates (PERF.md holds the times chip_smoke.py
// measured).  This first version aims to be right, not fast: a grid-
// stride copy with the widest word (16, 8, 4 or 1 bytes) that the host
// found every address and size of the leaf aligned to.  The TPU kernel's
// double-buffered VMEM staging has no counterpart: on Hopper the copy
// goes straight from device memory to device memory through L2, and its
// latency hides behind the other blocks in flight.
//
// Tables (int64, built on the host, copied to the device in one H2D):
//   pack:    per leaf  {src, page_offset, nbytes, width}
//   install: per leaf  {dst, page_offset, outer, inner_bytes, width, batch}
//            per page  {page_address, slot}
// A leaf with its slot axis at position a of a batch shape (d_0..d_n) is
// viewed as (outer, B, inner_bytes): outer = d_0..d_{a-1}, inner_bytes =
// d_{a+1}..d_n times the item size.  Byte (o, r) of the page's leaf image
// lands at dst + (o * B + slot) * inner_bytes + r.
//
// Neither kernel allocates or synchronises: both launch on the stream the
// caller passes, and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1024;

template <typename W>
__device__ __forceinline__ void copy_words(const uint8_t* __restrict__ src,
                                           uint8_t* __restrict__ dst,
                                           long long n_words, long long start,
                                           long long stride) {
  const W* s = reinterpret_cast<const W*>(src);
  W* d = reinterpret_cast<W*>(dst);
  for (long long i = start; i < n_words; i += stride) d[i] = s[i];
}

template <typename W>
__device__ __forceinline__ void scatter_rows(const uint8_t* __restrict__ src,
                                             uint8_t* __restrict__ dst,
                                             long long outer, long long inner,
                                             long long batch, long long slot,
                                             long long start,
                                             long long stride) {
  const long long row_words = inner / static_cast<long long>(sizeof(W));
  const long long n_words = outer * row_words;
  const W* s = reinterpret_cast<const W*>(src);
  for (long long i = start; i < n_words; i += stride) {
    const long long o = i / row_words;
    const long long r = i - o * row_words;
    W* row = reinterpret_cast<W*>(dst + (o * batch + slot) * inner);
    row[r] = s[i];
  }
}

// grid: (blocks, leaves).  Each block strides over one leaf's words.
__global__ void pack_page_kernel(const long long* __restrict__ leaves,
                                 uint8_t* __restrict__ page) {
  const long long* L = leaves + 4 * blockIdx.y;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(L[0]);
  uint8_t* dst = page + L[1];
  const long long nbytes = L[2];
  const long long width = L[3];
  const long long start =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  switch (width) {
    case 16: copy_words<uint4>(src, dst, nbytes / 16, start, stride); break;
    case 8: copy_words<uint2>(src, dst, nbytes / 8, start, stride); break;
    case 4: copy_words<uint32_t>(src, dst, nbytes / 4, start, stride); break;
    default: copy_words<uint8_t>(src, dst, nbytes, start, stride); break;
  }
}

// grid: (blocks, leaves, pages).  Each block strides over one leaf of one
// page; pages hold distinct slots (the wrapper keeps only the last page of
// a slot that repeats), so no two blocks write the same byte.
__global__ void install_pages_kernel(const long long* __restrict__ leaves,
                                     const long long* __restrict__ pages) {
  const long long* L = leaves + 6 * blockIdx.y;
  const long long* P = pages + 2 * blockIdx.z;
  uint8_t* dst = reinterpret_cast<uint8_t*>(L[0]);
  const uint8_t* src = reinterpret_cast<const uint8_t*>(P[0]) + L[1];
  const long long outer = L[2], inner = L[3], width = L[4], batch = L[5];
  const long long slot = P[1];
  const long long start =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  switch (width) {
    case 16:
      scatter_rows<uint4>(src, dst, outer, inner, batch, slot, start, stride);
      break;
    case 8:
      scatter_rows<uint2>(src, dst, outer, inner, batch, slot, start, stride);
      break;
    case 4:
      scatter_rows<uint32_t>(src, dst, outer, inner, batch, slot, start,
                             stride);
      break;
    default:
      scatter_rows<uint8_t>(src, dst, outer, inner, batch, slot, start,
                            stride);
      break;
  }
}

unsigned grid_blocks(long long max_words) {
  long long b = (max_words + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<unsigned>(b);
}

}  // namespace

extern "C" int pack_page_launch(const void* leaf_table, int n_leaves,
                                void* page, long long max_words,
                                void* stream) {
  if (n_leaves < 1 || n_leaves > 65535) return cudaErrorInvalidValue;
  dim3 grid(grid_blocks(max_words), n_leaves);
  pack_page_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(leaf_table), static_cast<uint8_t*>(page));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int install_pages_launch(const void* leaf_table, int n_leaves,
                                    const void* page_table, int n_pages,
                                    long long max_words, void* stream) {
  if (n_leaves < 1 || n_leaves > 65535 || n_pages < 1 || n_pages > 65535)
    return cudaErrorInvalidValue;
  dim3 grid(grid_blocks(max_words), n_leaves, n_pages);
  install_pages_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(leaf_table),
      static_cast<const long long*>(page_table));
  return static_cast<int>(cudaGetLastError());
}
