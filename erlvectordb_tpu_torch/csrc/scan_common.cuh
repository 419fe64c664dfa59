// Building blocks shared by the scan kernels (fused_topk.cu, tile_scan.cu,
// residual_scan.cu, cell_probe.cu): the row and tile geometry, the nibble
// unpacking of packed int4 codes, the per-thread top-T lists, the monotone
// float -> int key and the cp.async helpers.
//
// Packed int4 codes: 8 signed nibbles per 32-bit word; byte j of a row holds
// element 2j in its high nibble and 2j+1 in its low one (the store's
// layout).  A word unpacks to its high nibbles (elements 0, 2, 4, 6 of its
// 8-element group) and its low nibbles (1, 3, 5, 7); the wrappers hand the
// query over with each 8-element group reordered to [evens | odds] to
// match.  Integer sums are exact in any order.
//
// The top-T kernels (B4, B5, B6) keep a sorted per-thread list of T packed
// keys per query and finish with T rounds of a max per query over the
// threads that share it: keys carry their lane, so they are unique within
// a segment and exactly one thread pops each winner.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace evdb {

constexpr int kThreads = 256;   // threads of a block
constexpr int kSlice = 1024;    // POS_SLICE: rows per key slice (B1-B3, B5)
constexpr int kTile = 4096;     // TILE_N: rows per masked-extraction tile (B4, B6)

// the four high / low nibbles of a packed code word, sign-extended per byte:
// (n ^ 8) - 8 maps 0..15 to 0..7, -8..-1; __vsub4 keeps bytes from borrowing
__device__ __forceinline__ int nib_hi(uint32_t c) {
  return (int)__vsub4(((c >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ int nib_lo(uint32_t c) {
  return (int)__vsub4((c & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// insert v into a descending list of T keys (the smallest falls off)
template <int T>
__device__ __forceinline__ void push_top(int (&top)[T], int v) {
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int hi = max(top[i], v);
    v = min(top[i], v);
    top[i] = hi;
  }
}

// compare-exchange: the larger of a, b to a
__device__ __forceinline__ void cas_desc(int& a, int& b) {
  const int hi = max(a, b);
  b = min(a, b);
  a = hi;
}

// sort 8 keys descending: the 19-comparator network of depth 6
__device__ __forceinline__ void sort8_desc(int* v) {
  cas_desc(v[0], v[2]); cas_desc(v[1], v[3]); cas_desc(v[4], v[6]); cas_desc(v[5], v[7]);
  cas_desc(v[0], v[4]); cas_desc(v[1], v[5]); cas_desc(v[2], v[6]); cas_desc(v[3], v[7]);
  cas_desc(v[0], v[1]); cas_desc(v[2], v[3]); cas_desc(v[4], v[5]); cas_desc(v[6], v[7]);
  cas_desc(v[2], v[4]); cas_desc(v[3], v[5]);
  cas_desc(v[1], v[4]); cas_desc(v[3], v[6]);
  cas_desc(v[1], v[2]); cas_desc(v[3], v[4]); cas_desc(v[5], v[6]);
}

// top <- the 8 largest of (top, a), both sorted descending: the pairwise
// max of top and reversed a is a bitonic sequence holding them, which three
// half-cleaner stages sort: 32 min/max, where push_top takes 16 a key
__device__ __forceinline__ void merge_top8(int (&top)[8], const int* a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) top[i] = max(top[i], a[7 - i]);
#pragma unroll
  for (int d = 4; d > 0; d >>= 1)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if ((i & d) == 0) cas_desc(top[i], top[i + d]);
}

// a thread's 16 keys of a 64-row piece into its sorted list of T: at T = 8
// as two sorted runs of 8 merged in (~9 integer min/max a key, which issue
// at half the FFMA rate), else through push_top
template <int T>
__device__ __forceinline__ void fold_keys(int (&top)[T], int (&key)[16]) {
  if constexpr (T == 8) {
    sort8_desc(key);
    sort8_desc(key + 8);
    merge_top8(top, key);
    merge_top8(top, key + 8);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) push_top<T>(top, key[i]);
  }
}

// One round of the merge of a quad's four lists (lanes 4g .. 4g + 3 of a
// warp): the largest head, which its one holder pops.
template <int T>
__device__ __forceinline__ int pop_quad_max(int (&top)[T]) {
  int mx = max(top[0], __shfl_xor_sync(0xffffffffu, top[0], 1));
  mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const bool pop = top[0] == mx;
#pragma unroll
  for (int i = 0; i + 1 < T; ++i) top[i] = pop ? top[i + 1] : top[i];
  top[T - 1] = pop ? INT32_MIN : top[T - 1];
  return mx;
}

// float order -> int order: negative floats map to INT32_MIN - bits
__device__ __forceinline__ uint32_t float_key(float x) {
  const uint32_t si = (uint32_t)__float_as_int(x);
  return ((int)si >= 0) ? si : 0x80000000u - si;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// asynchronous copies global -> shared of 4 or 16 bytes (16: both ends
// 16-byte aligned), zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's newest commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace evdb
