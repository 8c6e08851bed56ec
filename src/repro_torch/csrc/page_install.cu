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
// install: the launch table is a kernel parameter too.  InstallTable
// (at most kMaxInstallLeaves = 32 leaves of 48 bytes and
// kMaxInstallPages = 128 pages of 16 bytes, 3,600 bytes in all) is passed
// by value as a __grid_constant__ parameter, so an install is one launch
// and nothing else: no pinned host buffer, no H2D copy of a table the
// kernel would wait for, and no allocation per call (the first version's
// table crossed H2D on every call).  It holds
//   per leaf  {dst, page_offset, inner, outer, width, row_blocks,
//              rows_per_block, first_block}
//   per page  {page_address, slot}
// A leaf with its slot axis at position a of a batch shape (d_0..d_n) is
// viewed as (outer, B, inner): outer = d_0..d_{a-1}, inner = d_{a+1}..d_n
// times the item size.  Byte (o, r) of the page's leaf image lands at
// dst + (o * B + slot) * inner + r: every row is contiguous on both sides.
//
// The grid is flat: each page owns page_blocks consecutive blocks, and
// inside a page leaf i owns the blocks from its first_block on, so every
// leaf gets blocks in proportion to its words (the first version sized
// a 3-D grid by the largest leaf, which left the small leaves' blocks
// idle).  A block finds its page by one division and its leaf by a
// binary search over first_block.  A block copies kInstallBlockWords
// words: a leaf whose rows hold at least that many is cut into
// row_blocks blocks per row (a contiguous run inside one row, its row
// and column from one division per block); a leaf with shorter rows
// gives each block rows_per_block whole rows, and a word's row comes
// from a 32-bit division.  Each thread loads kInstallUnroll words
// before it stores any.  Indices are 32-bit unless a leaf's batch bytes
// reach 2^31 (page offsets are 64-bit in the table).  The served
// layouts (3 leaves for qwen2-0.5b, 11 for recurrentgemma-2b) install in
// one launch for any G up to 128 pages; a layout or a G past the table
// takes one launch per chunk of leaves and pages.  Pages hold distinct
// slots (the wrapper keeps only the last page of a slot that repeats),
// so no two blocks write the same byte.
//
// What bounds the install: memory, 2 x page_bytes x G bytes (each staged
// byte read once, each cache byte written once).  For qwen2-0.5b at
// max_len 128 and G = 4 that is 12.6 MB, 3.76 us at 3.35 TB/s, so the
// launch is a large part of the time; at recurrentgemma-2b's max_len
// 2304 it is 137.9 MB, 41.2 us, where the copy rate decides it.

// Neither kernel allocates or synchronises: both launch on the stream the
// caller passes, and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPackUnroll = 4;                       // words per thread
constexpr int kPackBlockWords = kThreads * kPackUnroll;
constexpr int kMaxPackLeaves = 120;
constexpr int kInstallUnroll = 4;                    // words per thread
constexpr int kInstallBlockWords = kThreads * kInstallUnroll;
constexpr int kMaxInstallLeaves = 32;
constexpr int kMaxInstallPages = 128;
static_assert(kInstallUnroll == kPackUnroll,
              "a run inside one row is copied by pack_words");

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

// One leaf of the install: its batch leaf's address, its byte offset in
// the page, its row bytes (inner) and rows (outer), the copy word's
// width, its blocks per row (a row of at least kInstallBlockWords words)
// or else its whole rows per block, and its first block among one
// page's blocks.
struct InstallLeaf {
  long long dst;
  long long page_offset;
  long long inner;
  int outer;
  int width;
  int row_blocks;
  int rows_per_block;
  int first_block;
  int pad;
};

struct InstallPage {
  long long addr;   // the staged page's first byte
  int slot;
  int pad;
};

struct InstallTable {
  int n_leaves;     // leaves in this launch
  int n_pages;      // pages in this launch
  int page_blocks;  // blocks per page: the grid is n_pages x page_blocks
  int batch;        // B, the batch leaves' slot-axis size
  InstallLeaf leaf[kMaxInstallLeaves];
  InstallPage page[kMaxInstallPages];
};
static_assert(sizeof(InstallLeaf) == 48, "InstallLeaf is 48 bytes");
static_assert(sizeof(InstallPage) == 16, "InstallPage is 16 bytes");
static_assert(sizeof(InstallTable) <= 4096,
              "the install's kernel parameters exceed 4,096 bytes");

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

// Whole rows [first_row, first_row + n_words / row_words) of one leaf:
// the source side is contiguous, a word's destination row comes from one
// 32-bit division (I = int) per word.  kInstallUnroll words per thread,
// kThreads apart: all loads, then all stores.
template <typename W, typename I>
__device__ __forceinline__ void install_rows(const W* __restrict__ src,
                                             W* __restrict__ dst,
                                             I row_words, I first_row,
                                             I n_words, I batch, I slot) {
  src += first_row * row_words;
  W w[kInstallUnroll];
#pragma unroll
  for (int u = 0; u < kInstallUnroll; ++u) {
    const I i = static_cast<I>(u) * kThreads + static_cast<I>(threadIdx.x);
    if (i < n_words) w[u] = src[i];
  }
#pragma unroll
  for (int u = 0; u < kInstallUnroll; ++u) {
    const I i = static_cast<I>(u) * kThreads + static_cast<I>(threadIdx.x);
    if (i < n_words) {
      const I q = i / row_words;
      const I col = i - q * row_words;
      dst[((first_row + q) * batch + slot) * row_words + col] = w[u];
    }
  }
}

// Block lb of one leaf of one page.
template <typename W, typename I>
__device__ __forceinline__ void install_block(const InstallLeaf& L,
                                              const uint8_t* __restrict__ src,
                                              int batch, int slot, I lb) {
  const I row_words =
      static_cast<I>(L.inner / static_cast<long long>(sizeof(W)));
  const W* s = reinterpret_cast<const W*>(src);
  W* d = reinterpret_cast<W*>(L.dst);
  if (L.row_blocks > 0) {
    // a run of kInstallBlockWords words inside row o
    const I o = lb / L.row_blocks;
    const I c = lb - o * L.row_blocks;
    pack_words<W, I>(reinterpret_cast<const uint8_t*>(s + o * row_words),
                     reinterpret_cast<uint8_t*>(
                         d + (o * batch + slot) * row_words),
                     row_words,
                     c * kInstallBlockWords + static_cast<I>(threadIdx.x));
  } else {
    const I first_row = lb * L.rows_per_block;
    I rows = static_cast<I>(L.outer) - first_row;
    if (rows > L.rows_per_block) rows = L.rows_per_block;
    install_rows<W, I>(s, d, row_words, first_row, rows * row_words,
                       static_cast<I>(batch), static_cast<I>(slot));
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

// grid: flat, n_pages x page_blocks blocks; page g owns blocks
// [g * page_blocks, (g + 1) * page_blocks), and inside them leaf i owns
// [first_block_i, first_block_{i+1}).
template <typename I>
__global__ void __launch_bounds__(kThreads)
    install_pages_kernel(const __grid_constant__ InstallTable t) {
  const int b = static_cast<int>(blockIdx.x);
  const int g = b / t.page_blocks;
  const int r = b - g * t.page_blocks;
  int lo = 0, hi = t.n_leaves - 1;   // the last leaf whose first block <= r
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].first_block <= r) lo = mid; else hi = mid - 1;
  }
  const InstallLeaf& L = t.leaf[lo];
  const InstallPage& P = t.page[g];
  const uint8_t* src = reinterpret_cast<const uint8_t*>(P.addr) + L.page_offset;
  const I lb = static_cast<I>(r - L.first_block);
  switch (L.width) {
    case 16: install_block<uint4, I>(L, src, t.batch, P.slot, lb); break;
    case 8: install_block<uint2, I>(L, src, t.batch, P.slot, lb); break;
    case 4: install_block<uint32_t, I>(L, src, t.batch, P.slot, lb); break;
    default: install_block<uint8_t, I>(L, src, t.batch, P.slot, lb); break;
  }
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

// table: an InstallTable in host memory, which the launch copies into
// the kernel's parameters; wide: a leaf's batch bytes reach 2^31
// (64-bit indices).  The table is checked against the rule that
// built it (kernels/page_install.py, install_tables).
extern "C" int install_pages_launch(const void* table, int wide,
                                    void* stream) {
  const InstallTable& t = *static_cast<const InstallTable*>(table);
  if (t.n_leaves < 1 || t.n_leaves > kMaxInstallLeaves || t.n_pages < 1 ||
      t.n_pages > kMaxInstallPages || t.batch < 1)
    return cudaErrorInvalidValue;
  long long first = 0;
  for (int i = 0; i < t.n_leaves; ++i) {
    const InstallLeaf& L = t.leaf[i];
    const int w = L.width;
    if ((w != 1 && w != 4 && w != 8 && w != 16) || L.inner < w ||
        L.inner % w || L.outer < 1 || L.first_block != first)
      return cudaErrorInvalidValue;
    const long long row_words = L.inner / w;
    long long blocks;
    if (row_words >= kInstallBlockWords) {
      const long long rb =
          (row_words + kInstallBlockWords - 1) / kInstallBlockWords;
      if (L.row_blocks != rb || L.rows_per_block != 0)
        return cudaErrorInvalidValue;
      blocks = L.outer * rb;
    } else {
      const long long rpb = kInstallBlockWords / row_words;
      if (L.row_blocks != 0 || L.rows_per_block != rpb)
        return cudaErrorInvalidValue;
      blocks = (L.outer + rpb - 1) / rpb;
    }
    if (!wide && L.inner * L.outer * t.batch > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    first += blocks;
  }
  if (first != t.page_blocks || first * t.n_pages > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  for (int g = 0; g < t.n_pages; ++g) {
    if (t.page[g].slot < 0 || t.page[g].slot >= t.batch)
      return cudaErrorInvalidValue;
    for (int h = 0; h < g; ++h)   // blocks run in parallel: one page a slot
      if (t.page[h].slot == t.page[g].slot) return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(first * t.n_pages);
  if (wide)
    install_pages_kernel<long long><<<blocks, kThreads, 0, st>>>(t);
  else
    install_pages_kernel<int><<<blocks, kThreads, 0, st>>>(t);
  return static_cast<int>(cudaGetLastError());
}
