// Building blocks shared by the scan kernels (fused_topk.cu, residual_scan.cu).
//
// Every scan walks its rows in staged pieces of 256 rows x 64 bytes of codes:
// one thread owns one row of the piece and keeps one dot per query of its
// block's query group in registers.  Three code formats:
//
//   I8   4 int8 codes per 32-bit word, int8 query, __dp4a;
//   F32  one f32 code per word, f32 query, fmaf;
//   I4   8 packed signed nibbles per word (byte j of a row holds element 2j in
//        its high nibble and 2j+1 in its low one, the store's layout), int8
//        query.  A code word unpacks to two __dp4a operands, its high nibbles
//        (elements 0, 2, 4, 6 of its 8-element group) and its low nibbles
//        (1, 3, 5, 7); the wrapper hands the query over with each 8-element
//        group reordered to [evens | odds] to match, so one code word meets
//        two query words.  Sums are exact int32 in any order.
//
// The top-T kernels (B4, B5, B6) keep a sorted per-thread list of T packed
// keys per query and finish with T rounds of a max per query over the
// threads that share it (the block for B4 and B6, a quad for B5): keys
// carry their lane, so they are unique within a segment and exactly one
// thread pops each winner.  The cp.async helpers at the end stage tiles
// for the redesigned scans (B5, B3 on f32 codes).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Each source instantiates its own kernels from these templates (B4 in
// fused_topk.cu, B6 in residual_scan.cu), so no instantiation is shared.
namespace evdb {

constexpr int kThreads = 256;   // rows of a staged piece; one per thread
constexpr int kSlice = 1024;    // POS_SLICE: rows per key slice (B1-B3)
constexpr int kTile = 4096;     // TILE_N: rows per masked-extraction tile (B4, B6)
constexpr int kWords = 16;      // 32-bit code words of a row per staged piece (64 B)
constexpr int kSliceQ = 32;     // queries per block, B1-B3
constexpr int kTileQ = 8;       // queries per block, top-T kernels (T keys each per thread)

struct I8 { using Word = int; static constexpr int QW = 1; };
struct F32 { using Word = float; static constexpr int QW = 1; };
struct I4 { using Word = int; static constexpr int QW = 2; };  // query words per code word

__device__ __forceinline__ int dot_word(int a, int b, int acc) {
  return __dp4a(a, b, acc);
}
__device__ __forceinline__ float dot_word(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ float to_f32(int d) { return __int2float_rn(d); }
__device__ __forceinline__ float to_f32(float d) { return d; }

template <typename Word> struct Vec4;
template <> struct Vec4<int> { using T = int4; };
template <> struct Vec4<float> { using T = float4; };

// the four high / low nibbles of a packed code word, sign-extended per byte:
// (n ^ 8) - 8 maps 0..15 to 0..7, -8..-1; __vsub4 keeps bytes from borrowing
__device__ __forceinline__ int nib_hi(uint32_t c) {
  return (int)__vsub4(((c >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ int nib_lo(uint32_t c) {
  return (int)__vsub4((c & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dots of NQ queries against the thread's row of the 256-row piece starting
// at row0.  ``ww`` is the row width in code words; the query row is
// ww * QW words.  Every thread of the block must call this (it synchronises).
template <class Fmt, int NQ>
__device__ __forceinline__ void piece_dots(
    const typename Fmt::Word* __restrict__ q,
    const typename Fmt::Word* __restrict__ codes, int B, int ww, int q0,
    long long row0, typename Fmt::Word (*cs)[kWords + 1],
    typename Fmt::Word (*qs)[kWords * Fmt::QW], typename Fmt::Word acc[NQ]) {
  using Word = typename Fmt::Word;
  constexpr int QW = Fmt::QW;
  const int t = threadIdx.x;
  const int qww = ww * QW;
#pragma unroll
  for (int j = 0; j < NQ; ++j) acc[j] = Word(0);
  for (int w0 = 0; w0 < ww; w0 += kWords) {
    // codes piece: 256 rows x 16 words, consecutive threads on consecutive words
#pragma unroll
    for (int i = t; i < kThreads * kWords; i += kThreads) {
      const int r = i / kWords, w = i % kWords;
      cs[r][w] = codes[(row0 + r) * ww + w0 + w];
    }
    for (int i = t; i < NQ * kWords * QW; i += kThreads) {
      const int j = i / (kWords * QW), w = i % (kWords * QW);
      qs[j][w] = (q0 + j < B) ? q[(long long)(q0 + j) * qww + w0 * QW + w] : Word(0);
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWords; w += 4) {
      if constexpr (QW == 1) {
        const Word a0 = cs[t][w], a1 = cs[t][w + 1], a2 = cs[t][w + 2], a3 = cs[t][w + 3];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const typename Vec4<Word>::T v =
              *reinterpret_cast<const typename Vec4<Word>::T*>(&qs[j][w]);
          Word s = dot_word(a0, v.x, acc[j]);
          s = dot_word(a1, v.y, s);
          s = dot_word(a2, v.z, s);
          acc[j] = dot_word(a3, v.w, s);
        }
      } else {
        int h[4], l[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint32_t c = (uint32_t)cs[t][w + u];
          h[u] = nib_hi(c);
          l[u] = nib_lo(c);
        }
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int4 v0 = *reinterpret_cast<const int4*>(&qs[j][2 * w]);
          const int4 v1 = *reinterpret_cast<const int4*>(&qs[j][2 * w + 4]);
          int s = __dp4a(h[0], v0.x, acc[j]);
          s = __dp4a(l[0], v0.y, s);
          s = __dp4a(h[1], v0.z, s);
          s = __dp4a(l[1], v0.w, s);
          s = __dp4a(h[2], v1.x, s);
          s = __dp4a(l[2], v1.y, s);
          s = __dp4a(h[3], v1.z, s);
          acc[j] = __dp4a(l[3], v1.w, s);
        }
      }
    }
    __syncthreads();
  }
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

// one round of a block max over the heads of every thread's list; the one
// thread holding the winner pops it.  ``red`` is [2][warps] shared scratch,
// double-buffered by ``round`` so one barrier per round suffices.
template <int T>
__device__ __forceinline__ int pop_block_max(int (&top)[T], int (*red)[kThreads / 32],
                                             int round) {
  const int warp = threadIdx.x / 32;
  const int v = warp_max(top[0]);
  if ((threadIdx.x & 31) == 0) red[round & 1][warp] = v;
  __syncthreads();
  int mx = red[round & 1][0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) mx = max(mx, red[round & 1][w]);
  if (top[0] == mx) {
#pragma unroll
    for (int i = 0; i + 1 < T; ++i) top[i] = top[i + 1];
    top[T - 1] = INT32_MIN;
  }
  return mx;
}

// float order -> int order: negative floats map to INT32_MIN - bits
__device__ __forceinline__ uint32_t float_key(float x) {
  const uint32_t si = (uint32_t)__float_as_int(x);
  return ((int)si >= 0) ? si : 0x80000000u - si;
}

// B4 and B6: one block per (4096-row tile, 8 queries); top-T per tile and
// query of the monotone key of
//   sims = fma(dot * qmult[b], rowmult[r], rowbias[r])
// and, with CELL (int4r stores, B6), of
//   sims = fma(table[b, r / cell_cap] * qmult2[b], rowmult2[r], sims)
// the product pattern XLA compiles the JAX kernel's expressions to.  The low
// 12 bits of each key carry the row's lane in its tile.
template <class Fmt, int T, bool CELL>
__global__ void __launch_bounds__(kThreads) tile_scan_kernel(
    const typename Fmt::Word* __restrict__ q,
    const typename Fmt::Word* __restrict__ codes, int B, int ww, int n_tiles,
    const float* __restrict__ qmult, const float* __restrict__ rowmult,
    const float* __restrict__ rowbias, const float* __restrict__ qmult2,
    const float* __restrict__ rowmult2, const float* __restrict__ table,
    int ldt, int cell_cap, float* __restrict__ vals, int* __restrict__ rows) {
  using Word = typename Fmt::Word;
  __shared__ Word cs[kThreads][kWords + 1];
  __shared__ __align__(16) Word qs[kTileQ][kWords * Fmt::QW];
  __shared__ int red[2][kThreads / 32];
  __shared__ float qm_s[kTileQ], qm2_s[kTileQ];
  const int tile = blockIdx.x, q0 = blockIdx.y * kTileQ, t = threadIdx.x;
  if (t < kTileQ) {  // read after piece_dots' first barrier
    const bool ok = q0 + t < B;
    qm_s[t] = ok ? qmult[q0 + t] : 0.f;
    qm2_s[t] = (CELL && ok) ? qmult2[q0 + t] : 0.f;
  }

  int top[kTileQ][T];
#pragma unroll
  for (int j = 0; j < kTileQ; ++j)
#pragma unroll
    for (int i = 0; i < T; ++i) top[j][i] = INT32_MIN;

  for (int p = 0; p < kTile / kThreads; ++p) {
    const long long row0 = (long long)tile * kTile + p * kThreads;
    Word acc[kTileQ];
    piece_dots<Fmt, kTileQ>(q, codes, B, ww, q0, row0, cs, qs, acc);
    const long long row = row0 + t;
    const uint32_t lane = (uint32_t)(p * kThreads + t);  // row & 4095
    const float rm = rowmult[row], rb = rowbias[row];
    float rm2 = 0.f;
    long long cell = 0;
    if constexpr (CELL) {
      rm2 = rowmult2[row];
      cell = row / cell_cap;
    }
#pragma unroll
    for (int j = 0; j < kTileQ; ++j) {
      float sims = __fmaf_rn(__fmul_rn(to_f32(acc[j]), qm_s[j]), rm, rb);
      if constexpr (CELL) {
        const float tv = (q0 + j < B) ? table[(long long)(q0 + j) * ldt + cell] : 0.f;
        sims = __fmaf_rn(__fmul_rn(tv, qm2_s[j]), rm2, sims);
      }
      push_top<T>(top[j], (int)((float_key(sims) & ~0xFFFu) | lane));
    }
  }

  int round = 0;
#pragma unroll
  for (int j = 0; j < kTileQ; ++j) {
#pragma unroll
    for (int r = 0; r < T; ++r, ++round) {
      const int mx = pop_block_max<T>(top[j], red, round);
      if (t == 0 && q0 + j < B) {
        const uint32_t kt = (uint32_t)mx & ~0xFFFu;
        const uint32_t sr = ((int)kt >= 0) ? kt : 0x80000000u - kt;
        const long long o = (long long)(q0 + j) * n_tiles * T + (long long)tile * T + r;
        vals[o] = __int_as_float((int)sr);
        rows[o] = (int)((uint32_t)mx & 0xFFFu) + tile * kTile;
      }
    }
  }
}

template <class Fmt, bool CELL>
int launch_tile(const void* q, const void* codes, int B, int ww, int n_tiles, int t,
                const void* qmult, const void* rowmult, const void* rowbias,
                const void* qmult2, const void* rowmult2, const void* table,
                int ldt, int cell_cap, void* vals, void* rows, void* stream) {
  using Word = typename Fmt::Word;
  const dim3 grid(n_tiles, (B + kTileQ - 1) / kTileQ);
  cudaStream_t st = (cudaStream_t)stream;
  const Word* qq = (const Word*)q;
  const Word* cc = (const Word*)codes;
  const float *qm = (const float*)qmult, *rm = (const float*)rowmult,
              *rb = (const float*)rowbias, *qm2 = (const float*)qmult2,
              *rm2 = (const float*)rowmult2, *tb = (const float*)table;
  float* v = (float*)vals;
  int* r = (int*)rows;
  if (t == 2)
    tile_scan_kernel<Fmt, 2, CELL><<<grid, kThreads, 0, st>>>(
        qq, cc, B, ww, n_tiles, qm, rm, rb, qm2, rm2, tb, ldt, cell_cap, v, r);
  else if (t == 4)
    tile_scan_kernel<Fmt, 4, CELL><<<grid, kThreads, 0, st>>>(
        qq, cc, B, ww, n_tiles, qm, rm, rb, qm2, rm2, tb, ldt, cell_cap, v, r);
  else if (t == 8)
    tile_scan_kernel<Fmt, 8, CELL><<<grid, kThreads, 0, st>>>(
        qq, cc, B, ww, n_tiles, qm, rm, rb, qm2, rm2, tb, ldt, cell_cap, v, r);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
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
