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
// launch itself is most of the time (PERF.md holds the times
// chip_smoke.py measured).  Both copy with the widest word (16, 8, 4 or 1
// bytes) that the host found every address and size of the leaf aligned
// to.  The TPU kernel's double-buffered VMEM staging has no counterpart:
// on Hopper the copy goes straight from device memory to device memory
// through L2, and its latency hides behind the other blocks in flight.
//
// pack: the leaf table is a kernel parameter.  PackTable (at most
// kMaxPackLeaves = 120 leaves of 32 bytes, inside the 4,096 bytes of a
// launch's parameters) is passed by value as a __grid_constant__
// parameter, so a pack is one launch and nothing else: no pinned host
// buffer per call and no H2D copy of a table that the kernel would wait
// for on the stream (which set the time of the first version at max_len
// 128).  The grid is flat over the page's copy words: leaf i owns the
// consecutive blocks from its running offset first_block on, one block
// per kPackBlockWords of its words; a block finds its leaf by a binary
// search over those offsets, and each thread loads kPackUnroll words
// before it stores any.  Indices are 32-bit unless the page reaches 2^31
// bytes.  The served layouts fit one launch: qwen2-0.5b has 3 non-empty
// leaves, recurrentgemma-2b 11 (tests/test_torch_page_install.py counts
// them); a layout with more than 120 takes one launch per 120 leaves.
// No launch attribute is set: the time is the kernel's own.
//
// install: its tables (int64, built on the host, copied to the device in
// one H2D on the stream) are
//   per leaf  {dst, page_offset, outer, inner_bytes, width, batch}
//   per page  {page_address, slot}
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
constexpr int kPackUnroll = 4;                       // words per thread
constexpr int kPackBlockWords = kThreads * kPackUnroll;
constexpr int kMaxPackLeaves = 120;

// One leaf of the pack: its source address, its byte offset in the page,
// its size in bytes, the copy word's width, and its first block of the
// flat grid (the blocks of the leaves before it).
struct PackLeaf {
  long long src;
  long long page_offset;
  long long nbytes;
  int width;
  int first_block;
};

struct PackTable {
  int n;        // leaves in this launch
  int blocks;   // the grid: first_block + blocks of the last leaf
  PackLeaf leaf[kMaxPackLeaves];
};
static_assert(sizeof(PackLeaf) == 32, "PackLeaf is 32 bytes");
static_assert(sizeof(PackTable) + sizeof(void*) <= 4096,
              "the pack's kernel parameters exceed 4,096 bytes");

// kPackUnroll words of one thread, kThreads apart: all loads, then all
// stores.  I is the index type (int below 2^31 page bytes).
template <typename W, typename I>
__device__ __forceinline__ void pack_words(const uint8_t* __restrict__ src,
                                           uint8_t* __restrict__ dst,
                                           I n_words, I start) {
  const W* s = reinterpret_cast<const W*>(src);
  W* d = reinterpret_cast<W*>(dst);
  W w[kPackUnroll];
#pragma unroll
  for (int u = 0; u < kPackUnroll; ++u) {
    const I i = start + static_cast<I>(u) * kThreads;
    if (i < n_words) w[u] = s[i];
  }
#pragma unroll
  for (int u = 0; u < kPackUnroll; ++u) {
    const I i = start + static_cast<I>(u) * kThreads;
    if (i < n_words) d[i] = w[u];
  }
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

// grid: flat, t.blocks blocks; leaf i owns blocks [first_block_i,
// first_block_{i+1}).
template <typename I>
__global__ void __launch_bounds__(kThreads)
    pack_page_kernel(const __grid_constant__ PackTable t,
                     uint8_t* __restrict__ page) {
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0, hi = t.n - 1;   // the last leaf whose first block <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  const PackLeaf& L = t.leaf[lo];
  const uint8_t* src = reinterpret_cast<const uint8_t*>(L.src);
  uint8_t* dst = page + L.page_offset;
  const I start = static_cast<I>(b - L.first_block) * kPackBlockWords +
                  static_cast<I>(threadIdx.x);
  const I n_words = static_cast<I>(L.nbytes / L.width);
  switch (L.width) {
    case 16: pack_words<uint4, I>(src, dst, n_words, start); break;
    case 8: pack_words<uint2, I>(src, dst, n_words, start); break;
    case 4: pack_words<uint32_t, I>(src, dst, n_words, start); break;
    default: pack_words<uint8_t, I>(src, dst, n_words, start); break;
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

// table: a PackTable in host memory, which the launch copies into the
// kernel's parameters; wide: the page reaches 2^31 bytes (64-bit
// indices).  The table is checked against the rule that built it
// (kernels/page_install.py, pack_tables).
extern "C" int pack_page_launch(const void* table, void* page, int wide,
                                void* stream) {
  const PackTable& t = *static_cast<const PackTable*>(table);
  if (t.n < 1 || t.n > kMaxPackLeaves) return cudaErrorInvalidValue;
  long long first = 0;
  for (int i = 0; i < t.n; ++i) {
    const PackLeaf& L = t.leaf[i];
    const int w = L.width;
    if (L.nbytes < 1 || (w != 1 && w != 4 && w != 8 && w != 16) ||
        L.nbytes % w || L.first_block != first)
      return cudaErrorInvalidValue;
    if (!wide && L.page_offset + L.nbytes > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    first += (L.nbytes / w + kPackBlockWords - 1) / kPackBlockWords;
  }
  if (first != t.blocks || first > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* dst = static_cast<uint8_t*>(page);
  if (wide)
    pack_page_kernel<long long><<<t.blocks, kThreads, 0, st>>>(t, dst);
  else
    pack_page_kernel<int><<<t.blocks, kThreads, 0, st>>>(t, dst);
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
