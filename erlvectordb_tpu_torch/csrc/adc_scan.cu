// B8, B9 and B10, the ADC scans over product-quantization codes for Hopper
// (sm_90a), ported from erlvectordb_tpu/ops/adc_pallas.py:
//
//   B10  adc_pallas_scan (_make_adc_kernel)          top-T per 1024-row tile
//        of the ADC distance, from an int8 or a bf16 LUT;
//   B9   adc_search_exact_fused (_make_adc_exact_kernel)  the same from an
//        int8 LUT, each winner exactly reranked against its int8 row;
//   B8   adc_search_exact_pos (_make_adc_pos_kernel)  top-2 per 1024-row
//        slice, ties to the HIGHER lane (the TPU kernel maxes a key
//        ((-dist) << 10) | lane), each winner exactly reranked.
//
// The ADC distance of row n for query b is sum_m lut[b, m*K + code[n, m]]:
// exact int32 for an int8 LUT; for B10's f32 LUT, each entry rounded to bf16
// (round to nearest even) and the M values added in f32, as the TPU kernel's
// bf16 one-hot contraction does (every product with a one-hot entry is
// exact).  The plain version (ops/adc_pallas.py::_lut_dists) adds them in
// subspace order; this kernel in a canonical order of its own fixed by M
// alone (canonical_lut_dists, below), within bf16_sum_bound of it.  The TPU
// contracts a [rows, M*K] one-hot matrix with the LUT on its matrix unit
// (its way around gathers); these kernels look the LUT up directly.
//
// ---- int8 LUT (B8, B9, B10-int8): adc_packed_kernel
//
// What bounds it on an H100: the lookups.  At config 4's shapes (512 queries
// x 1,007,616 rows x 8 subspaces) a scan makes 4.1e9 of them and reads 8 MB
// of codes.  The first design read one byte of a per-query LUT per lookup: a
// shared-memory load, ~4 integer operations, and bank conflicts among 32
// random codes, and it staged the codes once per 8 queries.  So:
//   * the LUT is packed query-minor by ops/adc_pallas.py::pack_lut: one
//     32-bit word holds 4 queries' entries for one (subspace, code), each
//     +128 so that it is an unsigned byte.  A block holds the LUTs of QG =
//     128 / S queries (64 at S = 2: 128 KB at M 8, K 256) and stages each
//     tile's codes once for all of them;
//   * lane l of a warp is (s, g) = (l / G, l % G), G = 32 / S: it takes
//     subspaces s, s + S, s + 2S, ... of each row for query group g
//     (queries 4g .. 4g + 3).  The S tables of subspaces pS .. pS + S - 1
//     are interleaved word by word, so for every code the lane reads bank
//     l: the 32 loads of a warp never conflict, and each serves 4 lookups;
//   * the even and the odd bytes of each word are summed as two 16-bit
//     lanes of a 32-bit add (exact while M * 255 < 65,536, so M <= 256),
//     and 128 * M comes off at the end: the int32 distance is the plain
//     version's;
//   * a warp scores 2 S rows at a time (independent loads in flight), and
//     the S lanes of a group reduce-scatter their partial sums (S - 1
//     shuffles a lane for S rows, not S log2 S), so lane s ends with the
//     whole sums of one row for its 4 queries: 4 keys (biased sum << 10) |
//     lane-in-tile (B8: | 1023 - lane), unique, so the smallest key is the
//     smallest distance with the TPU kernel's tie rule;
//   * each lane keeps a sorted list of TMAX (>= T) keys for each of its 4
//     queries; at the end of a tile the S lanes of a group merge theirs in
//     place (bitonic: min(a[i], b[TMAX - 1 - i]) and half-cleaners), the
//     warps' lists go to shared memory, and each warp merges the NW lists
//     of its queries, interleaved, in T rounds of a warp minimum;
//   * B8/B9 then rerank the warp's picks 4 rows in flight (the first design
//     read them one after another): qdot = sum(q * x) * scale, d2 = |q|^2 -
//     2 qdot + |x|^2 with every product and sum rounded on its own (no FMA,
//     as XLA computes the TPU kernel's expression), in the first design's
//     order, so the values are unchanged bit for bit;
//   * the grid is one block an SM (as occupancy allows) over the (query
//     group, tile) items in order, a contiguous run each, so a block loads
//     its LUTs once or twice and every SM gets the same share; the next
//     tile's codes arrive by cp.async while the current one is scored.
// What bounds it now, by count at (j) (S 2, P = M / S = 4 words a row):
// the compiled lookup loop spends about 8 instructions a word (the code
// byte, the LUT word, two byte selects, two adds and about 3 of address
// arithmetic), the reduction ~4 and the keys ~4 a warp-row, the lists 2 T a
// key; at one block of 16 warps an SM (the LUTs take 128 KB) that issue,
// not the shared-memory words (~0.12 ms at 32 a clock an SM) or the codes'
// bytes (~0.003 ms), is the limit.
//
// ---- f32 LUT rounded to bf16 (B10-bf16): adc_bf16_packed_kernel
//
// What bounds it on an H100: the lookups again, now of 2-byte entries: at
// (j)'s shapes 4.1e9 of them, at best 2 to a 32-bit shared-memory word,
// 0.245 ms at 32 words a clock on each SM; the codes and the outputs take
// ~0.01 ms of HBM.  The first design read one 16-bit entry per lookup at a
// random bank, staged each code tile once per 8 queries and picked each
// tile's winners in T rounds of a warp minimum (4.1 ms at (j)).  This one
// is adc_packed_kernel's frame with two queries a word:
//   * the block rounds the f32 LUT to bf16 as it stages a query group's
//     tables (stage_bf16_lut) and packs them query-minor: one word holds 2
//     queries' entries for one (subspace, code), and the S tables of
//     subspaces pS .. pS + S - 1 are interleaved word by word, so lane (s,
//     g) of a warp reads word s G + g of a row at any code: bank l, no
//     conflicts, 2 lookups a load (ops/adc_pallas.py::pack_lut_bf16 is
//     these words in plain PyTorch).  A block holds the LUTs of 2 H
//     queries (H = G = 32 / S: 32 at S = 2, 128 KB at M 8, K 256; fewer,
//     H < G, where those do not fit: lanes g >= H then repeat lane g % H's
//     loads and keep nothing);
//   * a word's halves are the two queries' f32 values as they stand (w <<
//     16, w & 0xffff0000): a load, a shift, an and and two adds a word;
//   * the sum order: S0 = 8 chains if M % 8 == 0 (else 4), chain r adding
//     subspaces r, r + S0, ... from 0 (here: from its first term, the
//     staged LUT holding no -0), then a halving tree adding chain r + d
//     into chain r for d = S0/2 .. 1.  Lane s keeps the chains of the
//     classes s, s + S, ..., runs the tree's levels of stride S0/2 .. S in
//     registers and those of stride S/2 .. 1 as the int8 kernel's
//     reduce-scatter over the S lanes of a pair (S - 1 shuffles a lane for
//     S rows; addition commutes, so both partners get the same bits).
//     Every add is __fadd_rn: the sums are those of
//     ops/adc_pallas.py::canonical_lut_dists bit for bit for any S dividing
//     S0 (the plain version adds in subspace order; the two differ by at
//     most bf16_sum_bound);
//   * keys are (f32_order(distance) << 32) | row-in-tile, unique, so the
//     smallest key is the smallest distance, ties to the lower row (the TPU
//     kernel's rule); each lane keeps a sorted list of TMAX (>= T) keys for
//     each of its 2 queries (one in each of two passes for lists deeper
//     than 8), merged at the end of a tile across the S lanes of a pair and
//     then across the warps in shared memory, as in the int8 kernel.  A
//     lane meets its rows in ascending order, so while it scores a tile a
//     list compares the distance word alone (a tie goes after the listed
//     rows);
//   * one block an SM over runs of (query group, tile) items, code tiles
//     double-buffered by cp.async (single where two do not fit beside the
//     LUTs: M past ~100 at small K).
// ops/adc_pallas.py::adc_bf16_layout picks S (2; 4 or 8 for batches of at
// most 16 or 8 queries), H and the buffers, and mirrors bf16_smem.
//
// The entry points launch on the given stream, allocate nothing, and return
// cudaGetLastError() (or the error of the shared-memory attribute call).

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

using evdb::cp_async16;
using evdb::cp_async_commit;
using evdb::cp_async_wait;

constexpr int kTileRows = 1024;   // ADC_TILE_N: rows per tile / slice
constexpr int kSmemMax = 232448;  // shared memory a block may use
constexpr int kMaxM = 256;        // 16-bit sums: M * 255 < 65,536

// butterfly sum: every lane ends with the same value (each pair adds the same
// two operands)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------- int8 LUT

__host__ __device__ constexpr int packed_warps(int tmax) { return tmax > 8 ? 8 : 16; }

// words of a warp's lists in shared memory: [QG queries][TMAX + 1], padded
// to an odd count so the merging lanes (one list each) hit distinct banks
__host__ __device__ constexpr int list_words(int qg, int tmax) {
  return qg * (tmax + 1) + 1;
}

// the block's shared memory: the packed LUTs, two code tiles, the warps'
// lists, the picks, the queries' |q|^2.  ops/adc_pallas.py::adc_layout
// mirrors it.
__host__ __device__ constexpr size_t packed_smem(int M, int K, int S, int tmax) {
  return (size_t)(128 / S) * M * K + 2 * (size_t)kTileRows * M +
         4 * (size_t)packed_warps(tmax) * list_words(128 / S, tmax) +
         4 * (size_t)(128 / S) * tmax + 4 * (size_t)(128 / S);
}

// the smaller and the larger of two keys: min/max for 32-bit keys (two
// integer min/max instructions), one compare and selects for 64-bit ones
template <typename Key>
__device__ __forceinline__ void order2(Key& lo, Key& hi) {
  if constexpr (sizeof(Key) == 4) {
    const Key l = min(lo, hi);
    hi = max(lo, hi);
    lo = l;
  } else {
    const bool sw = hi < lo;
    const Key l = sw ? hi : lo;
    hi = sw ? lo : hi;
    lo = l;
  }
}

// insert v into an ascending list of TMAX keys (the largest falls off):
// branch-free for short lists, past a compare with the last key for long
// ones (a key of a long list is rarely inserted)
template <int TMAX>
__device__ __forceinline__ void push_min(uint32_t (&top)[TMAX], uint32_t v) {
  if (TMAX > 4 && v >= top[TMAX - 1]) return;
#pragma unroll
  for (int i = 0; i < TMAX; ++i) order2(top[i], v);
}

// insert the key (vh, vr) into an ascending list of TMAX keys (th[i],
// tr[i]) whose rows all precede vr: a key that ties on vh then follows them,
// so where it goes needs the compares of vh alone (lt[i]: it goes before
// entry i), and entry i takes entry i - 1 or the key
template <int TMAX>
__device__ __forceinline__ void push_after(uint32_t (&th)[TMAX], uint32_t (&tr)[TMAX],
                                           uint32_t vh, uint32_t vr) {
  bool lt[TMAX];
#pragma unroll
  for (int i = 0; i < TMAX; ++i) lt[i] = vh < th[i];
#pragma unroll
  for (int i = TMAX - 1; i > 0; --i) {
    th[i] = lt[i] ? (lt[i - 1] ? th[i - 1] : vh) : th[i];
    tr[i] = lt[i] ? (lt[i - 1] ? tr[i - 1] : vr) : tr[i];
  }
  th[0] = lt[0] ? vh : th[0];
  tr[0] = lt[0] ? vr : tr[0];
}

// the ascending lists of lanes l and l ^ o -> the TMAX smallest of their
// union in both lanes, in place: min(a[i], b[TMAX - 1 - i]) is a bitonic
// sequence holding them, which log2(TMAX) half-cleaner stages sort
template <int TMAX, typename Key>
__device__ __forceinline__ void merge_partner(Key (&a)[TMAX], int o) {
  Key b[TMAX];
#pragma unroll
  for (int i = 0; i < TMAX; ++i) b[i] = __shfl_xor_sync(0xffffffffu, a[TMAX - 1 - i], o);
#pragma unroll
  for (int i = 0; i < TMAX; ++i) a[i] = min(a[i], b[i]);
#pragma unroll
  for (int d = TMAX / 2; d > 0; d >>= 1)
#pragma unroll
    for (int i = 0; i < TMAX; ++i)
      if ((i & d) == 0) order2(a[i], a[i + d]);
}

// ``lut``: [groups][M / S][K][32] words (ops/adc_pallas.py::pack_lut);
// items = groups x n_tiles, item = group * n_tiles + tile.
template <bool RERANK, bool HIGH, int TMAX, int S>
__global__ void __launch_bounds__(32 * packed_warps(TMAX), 1) adc_packed_kernel(
    const uint8_t* __restrict__ codes, const uint32_t* __restrict__ lut,
    const float* __restrict__ q, const int8_t* __restrict__ i8,
    const float* __restrict__ scales, const float* __restrict__ norms2, int B,
    int M, int K, int D, int n_tiles, int T, float* __restrict__ vals,
    int* __restrict__ rows) {
  constexpr int NW = packed_warps(TMAX);
  constexpr int G = 32 / S, QG = 4 * G, QPW = QG / NW;   // QPW: queries a warp merges
  constexpr int kRowsPerWarp = kTileRows / NW;
  constexpr int kRU = 4;                                  // reranked rows in flight
  constexpr uint32_t kNone = 0xffffffffu;
  constexpr int WS = list_words(QG, TMAX);
  static_assert(QPW >= 1 && kRowsPerWarp % (2 * S) == 0, "layout");
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = M / S;
  uint32_t* lut_s = reinterpret_cast<uint32_t*>(smem);           // [P][K][32]
  uint8_t* codes_s = smem + (size_t)QG * M * K;                   // [2][1024][M]
  uint32_t* lists = reinterpret_cast<uint32_t*>(codes_s + 2 * kTileRows * M);
  uint32_t* picks = lists + NW * WS;                              // [QG][TMAX]
  float* qsq_s = reinterpret_cast<float*>(picks + QG * TMAX);     // [QG]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = lane / G, g = lane % G;
  const uint32_t lane_b = 4 * lane;   // the lane's bank in a LUT row
  const int tile_bytes = kTileRows * M;
  const long long n_items = (long long)(B + QG - 1) / QG * n_tiles;
  const long long i0 = n_items * blockIdx.x / gridDim.x;
  const long long i1 = n_items * (blockIdx.x + 1) / gridDim.x;
  const long long cols = (long long)n_tiles * T;

  auto issue = [&](long long it) {   // the item's code tile -> buffer it & 1
    if (it < i1) {
      const uint8_t* src = codes + (it % n_tiles) * tile_bytes;
      uint8_t* dst = codes_s + (int)(it & 1) * tile_bytes;
      for (int i = 16 * tid; i < tile_bytes; i += 16 * 32 * NW)
        cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };

  issue(i0);
  int cur = -1;
  for (long long it = i0; it < i1; ++it) {
    const int grp = (int)(it / n_tiles), tile = (int)(it % n_tiles);
    if (grp != cur) {   // the group's LUTs and |q|^2
      __syncthreads();  // every warp is done with the previous group's
      const uint4* src = reinterpret_cast<const uint4*>(lut + (size_t)grp * P * K * 32);
      for (int i = tid; i < P * K * 8; i += 32 * NW)
        reinterpret_cast<uint4*>(lut_s)[i] = __ldg(src + i);
      if constexpr (RERANK) {
        for (int ql = warp; ql < QG; ql += NW) {
          const int qa = grp * QG + ql;
          float acc = 0.f;
          if (qa < B)
            for (int e = lane; e < D; e += 32) {
              const float x = __ldg(q + (long long)qa * D + e);
              acc = __fadd_rn(acc, __fmul_rn(x, x));
            }
          const float v = warp_sum(acc);
          if (lane == 0) qsq_s[ql] = v;
        }
      }
      cur = grp;
    }
    issue(it + 1);
    cp_async_wait<1>();   // this thread's copies of the current tile
    __syncthreads();      // everyone's, the LUTs, and the last item is done

    // Score the warp's rows, 2 S at a time: for each row the lane sums its
    // P words (subspaces s, s + S, ...) for query group g, then the S lanes
    // of the group reduce-scatter, so lane s ends with the whole sums of row
    // r0 + s (and r0 + S + s) for queries 4g .. 4g + 3.  Slot u of a lane
    // holds row u ^ s of its S: the half a lane keeps at each level is then
    // its low slots, and the half it sends the partner's low slots.
    // Lists of TMAX keys for SL of the lane's 4 queries: all 4 in one pass
    // over the tile, or one in each of four passes where 4 lists of 32
    // would not fit in registers (T > 8: no served path).
    constexpr int NH = TMAX > 8 ? 4 : 1, SL = 4 / NH;
    // byte offsets into shared memory: the lane's code byte of a row, its
    // bank of a LUT row (kept opaque, so that a lookup's address is one
    // shift-add of the code onto it)
    const uint32_t cb = (uint32_t)(codes_s - smem) + (uint32_t)(it & 1) * tile_bytes + s;
#pragma unroll 1
    for (int hf = 0; hf < NH; ++hf) {
      uint32_t top[SL][TMAX];
#pragma unroll
      for (int j = 0; j < SL; ++j)
#pragma unroll
        for (int i = 0; i < TMAX; ++i) top[j][i] = kNone;
      for (int r0 = warp * kRowsPerWarp; r0 < (warp + 1) * kRowsPerWarp; r0 += 2 * S) {
        uint32_t ae[2][S], ao[2][S], crow[2][S];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int u = 0; u < S; ++u) {
            ae[a][u] = ao[a][u] = 0u;
            crow[a][u] = cb + (r0 + a * S + (u ^ s)) * M;
          }
#pragma unroll 4
        for (int p = 0; p < P; ++p) {
          uint32_t lp = lane_b + (uint32_t)(p * K * 128);
          asm("" : "+r"(lp));
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int u = 0; u < S; ++u) {
              const uint32_t code = smem[crow[a][u] + p * S];
              const uint32_t w = *reinterpret_cast<const uint32_t*>(smem + lp + (code << 7));
              ae[a][u] += w & 0x00ff00ffu;              // bytes 0, 2
              ao[a][u] += __byte_perm(w, 0u, 0x4341);   // bytes 1, 3
            }
        }
#pragma unroll
        for (int h = S / 2; h >= 1; h >>= 1)   // keep the low half, send the high
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int i = 0; i < h; ++i) {
              ae[a][i] += __shfl_xor_sync(0xffffffffu, ae[a][h + i], h * G);
              ao[a][i] += __shfl_xor_sync(0xffffffffu, ao[a][h + i], h * G);
            }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int r = r0 + a * S + s;
          const uint32_t lb = HIGH ? (uint32_t)(kTileRows - 1 - r) : (uint32_t)r;
          // query 4g + j: the low (j < 2) or high 16 bits of ae (j even), ao
#pragma unroll
          for (int j = 0; j < SL; ++j) {
            const int jq = hf * SL + j;
            const uint32_t sum = (((jq & 1) ? ao[a][0] : ae[a][0]) >> (16 * (jq >> 1))) & 0xffffu;
            push_min<TMAX>(top[j], (sum << 10) | lb);
          }
        }
      }
      // the S lanes of a query group merge their lists pairwise, log2(S)
      // levels, and lane s = 0 posts the warp's
#pragma unroll
      for (int o = G; o < 32; o <<= 1)
#pragma unroll
        for (int j = 0; j < SL; ++j) merge_partner<TMAX>(top[j], o);
      if (s == 0) {
#pragma unroll
        for (int j = 0; j < SL; ++j) {
          uint32_t* lt = lists + warp * WS + (4 * g + hf * SL + j) * (TMAX + 1);
#pragma unroll
          for (int i = 0; i < TMAX; ++i) lt[i] = top[j][i];
        }
      }
    }
    __syncthreads();

    // warp w merges the NW lists of each of its QPW queries, QI at a time
    // interleaved (QI x TMAX <= 16 keys a lane): lane L < NW loads list L
    // (the rest hold none), five levels of pair merges leave the top TMAX
    // in every lane, and lane t posts pick t of query i as (its key | i <<
    // 26) at picks[warp][i * T + t] (keys take 26 bits).
    constexpr int QI = QPW < 16 / TMAX ? QPW : (16 / TMAX > 0 ? 16 / TMAX : 1);
    uint32_t* pw = picks + warp * QPW * TMAX;
#pragma unroll 1
    for (int i0 = 0; i0 < QPW; i0 += QI) {
      uint32_t ml[QI][TMAX];
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        const uint32_t* lt = lists + lane * WS + (warp * QPW + i0 + i) * (TMAX + 1);
#pragma unroll
        for (int t = 0; t < TMAX; ++t) ml[i][t] = lane < NW ? lt[t] : kNone;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
#pragma unroll
        for (int i = 0; i < QI; ++i) merge_partner<TMAX>(ml[i], o);
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        uint32_t m = ml[i][0];
#pragma unroll
        for (int t = 1; t < TMAX; ++t) m = lane == t ? ml[i][t] : m;
        if (lane < T) pw[(i0 + i) * T + lane] = m | (uint32_t)(i0 + i) << 26;
      }
    }
    __syncwarp();
    if constexpr (!RERANK) {
      for (int p = lane; p < QPW * T; p += 32) {
        const uint32_t pk = pw[p];
        const int i = (int)(pk >> 26), qa = grp * QG + warp * QPW + i;
        if (qa < B) {
          const long long o = (long long)qa * cols + (long long)tile * T + (p - i * T);
          vals[o] = -(float)((int)((pk & 0x3ffffffu) >> 10) - 128 * M);
          rows[o] = tile * kTileRows + (int)(pk & 1023u);
        }
      }
    } else {
      // the warp's QPW x T picks, kRU rows in flight, each with its scale
      // and norm: d2 in the first design's order
      const int n = QPW * T;
      for (int p0 = 0; p0 < n; p0 += kRU) {
        float acc[kRU], sc[kRU], nn[kRU];
        int row[kRU], ql[kRU];
#pragma unroll
        for (int u = 0; u < kRU; ++u) {
          const uint32_t pk = pw[min(p0 + u, n - 1)];
          const int r = HIGH ? kTileRows - 1 - (int)(pk & 1023u) : (int)(pk & 1023u);
          row[u] = tile * kTileRows + r;
          ql[u] = warp * QPW + (int)(pk >> 26);
          sc[u] = __ldg(scales + row[u]);
          nn[u] = __ldg(norms2 + row[u]);
          acc[u] = 0.f;
        }
        for (int e4 = lane; e4 < D / 4; e4 += 32) {
#pragma unroll
          for (int u = 0; u < kRU; ++u) {
            const float4 qq = __ldg(reinterpret_cast<const float4*>(
                q + (long long)min(grp * QG + ql[u], B - 1) * D) + e4);
            const char4 x = reinterpret_cast<const char4*>(i8 + (long long)row[u] * D)[e4];
            float a = __fadd_rn(acc[u], __fmul_rn(qq.x, (float)x.x));
            a = __fadd_rn(a, __fmul_rn(qq.y, (float)x.y));
            a = __fadd_rn(a, __fmul_rn(qq.z, (float)x.z));
            acc[u] = __fadd_rn(a, __fmul_rn(qq.w, (float)x.w));
          }
        }
#pragma unroll
        for (int u = 0; u < kRU; ++u) {
          const float sum = warp_sum(acc[u]);
          const int p = p0 + u, qa = grp * QG + ql[u];
          if (lane == 0 && p < n && qa < B) {
            const float qdot = __fmul_rn(sum, sc[u]);
            const long long o = (long long)qa * cols + (long long)tile * T +
                                (p - (ql[u] - warp * QPW) * T);
            vals[o] = -__fadd_rn(__fsub_rn(qsq_s[ql[u]], __fmul_rn(2.f, qdot)), nn[u]);
            rows[o] = row[u];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <bool RERANK, bool HIGH, int TMAX, int S>
int launch_packed(const void* codes, const void* lut, const void* q, const void* i8,
                  const void* scales, const void* norms2, int B, int M, int K,
                  int D, int n_tiles, int T, void* vals, void* rows,
                  cudaStream_t st) {
  auto kern = adc_packed_kernel<RERANK, HIGH, TMAX, S>;
  const int threads = 32 * packed_warps(TMAX);
  const int smem = (int)packed_smem(M, K, S, TMAX);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)(B + 128 / S - 1) / (128 / S) * n_tiles;
  const int blocks = (int)std::min<long long>(items, (long long)sms * std::max(per_sm, 1));
  kern<<<blocks, threads, smem, st>>>(
      (const uint8_t*)codes, (const uint32_t*)lut, (const float*)q,
      (const int8_t*)i8, (const float*)scales, (const float*)norms2, B, M, K, D,
      n_tiles, T, (float*)vals, (int*)rows);
  return (int)cudaGetLastError();
}

using PackedLaunch = decltype(&launch_packed<false, false, 2, 2>);

// the instantiation for (the rerank, the tie rule, T, S)
template <bool RERANK, bool HIGH, int TMAX>
PackedLaunch packed_for_s(int S) {
  return S == 2 ? &launch_packed<RERANK, HIGH, TMAX, 2>
       : S == 4 ? &launch_packed<RERANK, HIGH, TMAX, 4>
                : &launch_packed<RERANK, HIGH, TMAX, 8>;
}

template <bool RERANK>
PackedLaunch packed_for(int T, int S) {
  return T <= 2 ? packed_for_s<RERANK, false, 2>(S)
       : T <= 4 ? packed_for_s<RERANK, false, 4>(S)
       : T <= 8 ? packed_for_s<RERANK, false, 8>(S)
                : packed_for_s<RERANK, false, 32>(S);
}

bool bad_packed(int B, int M, int K, int S, int n_tiles, int T) {
  return B < 1 || M < 4 || M % 4 || M > kMaxM || K < 1 || K > 256 ||
         !(S == 2 || S == 4 || S == 8) || M % S || n_tiles < 1 || T < 1 ||
         T > 32 || packed_smem(M, K, S, T <= 2 ? 2 : T <= 4 ? 4 : T <= 8 ? 8 : 32) >
         (size_t)kSmemMax;
}

// ----------------------------------------------------- f32 LUT as bf16

__host__ __device__ constexpr int bf16_warps(int tmax) { return tmax > 8 ? 8 : 16; }

// the block's shared memory: the packed LUT words of 2 H queries, nbuf code
// tiles, the warps' lists of 64-bit keys [2 H queries][TMAX + 1] (padded).
// ops/adc_pallas.py::adc_bf16_smem mirrors it.
__host__ __device__ constexpr size_t bf16_smem(int M, int K, int H, int nbuf, int tmax) {
  return 4 * (size_t)M * K * H + (size_t)nbuf * kTileRows * M +
         8 * (size_t)bf16_warps(tmax) * (2 * H * (tmax + 1) + 1);
}

// monotone f32 -> u32 (ascending floats give ascending words) and back
__device__ __forceinline__ uint32_t f32_order(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float f32_unorder(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// f32 -> bf16 bits, rounded to nearest even as torch rounds (NaN ->
// 0x7fc0), -0 as +0 (a sum from 0 never tells them apart)
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  const uint32_t h = (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
  return (h & 0x7fffu) ? h : 0u;
}

// Query group q0 .. q0 + 2H - 1 of the f32 LUT [B, M*K] -> the packed words
// [M / S][K][S * H] of ops/adc_pallas.py::pack_lut_bf16: word (p, c, l = s H
// + j) holds the entries of queries q0 + 2j (low half) and q0 + 2j + 1 (high)
// for subspace p S + s and code c, 0 past B.  A warp covers 32 / LW codes x
// LW words of a row (LW = 4): a load reads LW queries' runs of 8 entries, a
// store meets at most 8 lanes in a bank.
template <int S>
__device__ __forceinline__ void stage_bf16_lut(uint32_t* __restrict__ dst,
                                               const float* __restrict__ lut, int B,
                                               int M, int K, int H, int q0, int warp,
                                               int lane, int nw) {
  const int SH = S * H, LW = SH < 4 ? SH : 4, CW = 32 / LW;
  const int lo = lane % LW, co = lane / LW;
  const int ncb = (K + CW - 1) / CW, nlb = SH / LW;
  const int n = (M / S) * ncb * nlb;
  const size_t mk = (size_t)M * K;
#pragma unroll 4
  for (int ch = warp; ch < n; ch += nw) {
    const int lb = ch % nlb, cb = (ch / nlb) % ncb, p = ch / (nlb * ncb);
    const int l = lb * LW + lo, c = cb * CW + co;
    if (c < K) {
      const int q = q0 + 2 * (l % H);
      const float* src = lut + (size_t)(p * S + l / H) * K + c;
      const uint32_t a = q < B ? bf16_bits(__ldg(src + (size_t)q * mk)) : 0u;
      const uint32_t b = q + 1 < B ? bf16_bits(__ldg(src + (size_t)(q + 1) * mk)) : 0u;
      dst[((size_t)p * K + c) * SH + l] = a | (b << 16);
    }
  }
}

// ``lut``: the f32 LUT [B, M*K], staged a query group at a time by
// stage_bf16_lut; items = groups x n_tiles, item = group * n_tiles + tile.
// S0 = 8 if M % 8 == 0 else 4: the chains of the canonical sum.
template <int TMAX, int S, int S0>
__global__ void __launch_bounds__(32 * bf16_warps(TMAX), 1) adc_bf16_packed_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ lut, int B,
    int M, int K, int H, int nbuf, int n_tiles, int T, float* __restrict__ vals,
    int* __restrict__ rows) {
  using Key = unsigned long long;
  constexpr int NW = bf16_warps(TMAX);
  constexpr int G = 32 / S, C = S0 / S;   // C: the chains a lane keeps
  constexpr int kRowsPerWarp = kTileRows / NW;
  constexpr Key kNone = ~0ull;
  static_assert(S0 % S == 0 && kRowsPerWarp % (2 * S) == 0, "layout");
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = M / S, QG = 2 * H, WS = QG * (TMAX + 1) + 1;
  const int tile_bytes = kTileRows * M;
  uint8_t* codes_s = smem + 4 * M * K * H;                        // [nbuf][1024][M]
  Key* lists = reinterpret_cast<Key*>(codes_s + nbuf * tile_bytes);  // [NW][WS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = lane / G, g = lane % G;
  const int rs = 31 - __clz(4 * S * H);                  // log2(bytes of a LUT row)
  const uint32_t lane_b = 4 * (s * H + (g & (H - 1)));   // the lane's word of a row
  const long long n_items = (long long)((B + QG - 1) / QG) * n_tiles;
  const long long i0 = n_items * blockIdx.x / gridDim.x;
  const long long i1 = n_items * (blockIdx.x + 1) / gridDim.x;
  const long long cols = (long long)n_tiles * T;

  auto buf = [&](long long it) { return nbuf == 2 ? (int)(it & 1) : 0; };
  auto issue = [&](long long it) {   // the item's code tile -> buffer buf(it)
    if (it < i1) {
      const uint8_t* src = codes + (it % n_tiles) * tile_bytes;
      uint8_t* dst = codes_s + buf(it) * tile_bytes;
      for (int i = 16 * tid; i < tile_bytes; i += 16 * 32 * NW)
        cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };

  if (nbuf == 2) issue(i0);
  int cur = -1;
  for (long long it = i0; it < i1; ++it) {
    const int grp = (int)(it / n_tiles), tile = (int)(it % n_tiles);
    if (grp != cur) {   // the group's LUTs, rounded and packed
      __syncthreads();  // every warp is done with the previous group's
      stage_bf16_lut<S>(reinterpret_cast<uint32_t*>(smem), lut, B, M, K, H, grp * QG,
                        warp, lane, NW);
      cur = grp;
    }
    // two buffers: the next tile's copy overlaps this one's scoring; one:
    // every warp left the buffer at the last item's middle barrier
    if (nbuf == 2) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      issue(it);
      cp_async_wait<0>();
    }
    __syncthreads();    // everyone's copies, the LUTs, and the last item is done

    // Score the warp's rows, 2 S at a time.  Lane (s, g) reads, for each
    // row, the words of subspaces s, s + S, ... (two queries' entries
    // each) and adds word p into chain p % C of its queries: chain i of
    // lane s is class s + i S of the canonical sum.  The in-register
    // levels (strides S0/2 .. S) leave class s; the reduce-scatter over
    // the S lanes of a pair (strides S/2 .. 1) adds the classes as the
    // halving tree does, so lane s ends with the whole sums of rows r0 + s
    // and r0 + S + s for queries 2g, 2g + 1.  Slot u of a lane holds row
    // u ^ s of its S.  Lists of TMAX keys for SL of the 2 queries: both in
    // one pass, or one in each of two passes for lists deeper than 8.
    constexpr int NH = TMAX > 8 ? 2 : 1, SL = 2 / NH;
    const uint32_t cb = (uint32_t)(codes_s - smem) + (uint32_t)(buf(it) * tile_bytes) + s;
#pragma unroll 1
    for (int hf = 0; hf < NH; ++hf) {
      uint32_t th[SL][TMAX], tr[SL][TMAX];   // the lists: distance words, rows
#pragma unroll
      for (int j = 0; j < SL; ++j)
#pragma unroll
        for (int i = 0; i < TMAX; ++i) th[j][i] = tr[j][i] = 0xffffffffu;
      for (int r0 = warp * kRowsPerWarp; r0 < (warp + 1) * kRowsPerWarp; r0 += 2 * S) {
        float acc[2][S][2][C];
        uint32_t crow[2][S];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int u = 0; u < S; ++u) crow[a][u] = cb + (r0 + a * S + (u ^ s)) * M;
        // word p of row (a, u): the LUT word at the row's code of subspace p S + s
        auto word = [&](int a, int u, int p) {
          uint32_t lp = lane_b + ((uint32_t)(p * K) << rs);
          asm("" : "+r"(lp));
          const uint32_t code = smem[crow[a][u] + p * S];
          return *reinterpret_cast<const uint32_t*>(smem + lp + (code << rs));
        };
        // a chain starts at its first term: 0 + x is x, as the packed LUT
        // holds no -0 (pack_lut_bf16 stores it as +0, which no sum from 0
        // tells apart)
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int u = 0; u < S; ++u) {
              const uint32_t w = word(a, u, c);
              acc[a][u][0][c] = __uint_as_float(w << 16);
              acc[a][u][1][c] = __uint_as_float(w & 0xffff0000u);
            }
#pragma unroll 2
        for (int p0 = C; p0 < P; p0 += C) {
#pragma unroll
          for (int c = 0; c < C; ++c)
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
              for (int u = 0; u < S; ++u) {
                const uint32_t w = word(a, u, p0 + c);
                acc[a][u][0][c] = __fadd_rn(acc[a][u][0][c], __uint_as_float(w << 16));
                acc[a][u][1][c] = __fadd_rn(acc[a][u][1][c], __uint_as_float(w & 0xffff0000u));
              }
        }
#pragma unroll
        for (int d = C / 2; d >= 1; d >>= 1)   // strides S0/2 .. S
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int u = 0; u < S; ++u)
#pragma unroll
              for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int i = 0; i < d; ++i)
                  acc[a][u][j][i] = __fadd_rn(acc[a][u][j][i], acc[a][u][j][i + d]);
#pragma unroll
        for (int h = S / 2; h >= 1; h >>= 1)   // strides S/2 .. 1: keep the low half
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int i = 0; i < h; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                acc[a][i][j][0] = __fadd_rn(
                    acc[a][i][j][0], __shfl_xor_sync(0xffffffffu, acc[a][h + i][j][0], h * G));
#pragma unroll
        for (int a = 0; a < 2; ++a)   // rows ascend: r0 + s, then r0 + S + s
#pragma unroll
          for (int j = 0; j < SL; ++j) {
            const float d = NH == 1 ? acc[a][0][j][0] : (hf ? acc[a][0][1][0] : acc[a][0][0][0]);
            push_after<TMAX>(th[j], tr[j], f32_order(d), (uint32_t)(r0 + a * S + s));
          }
      }
      // keys (distance word << 32) | row; the S lanes of a pair merge their
      // lists pairwise, log2(S) levels, and lane s = 0 of each working pair
      // posts the warp's
      Key top[SL][TMAX];
#pragma unroll
      for (int j = 0; j < SL; ++j)
#pragma unroll
        for (int i = 0; i < TMAX; ++i) top[j][i] = ((Key)th[j][i] << 32) | tr[j][i];
#pragma unroll
      for (int o = G; o < 32; o <<= 1)
#pragma unroll
        for (int j = 0; j < SL; ++j) merge_partner<TMAX>(top[j], o);
      if (s == 0 && g < H) {
#pragma unroll
        for (int j = 0; j < SL; ++j) {
          Key* lt = lists + warp * WS + (2 * g + hf * SL + j) * (TMAX + 1);
#pragma unroll
          for (int i = 0; i < TMAX; ++i) lt[i] = top[j][i];
        }
      }
    }
    __syncthreads();

    // warp w merges the NW lists of queries w QI .. w QI + QI - 1, then
    // those NW QI further on, ...: lane L < NW loads list L (the rest hold
    // none), log2(NW) levels of pair merges leave the top TMAX in lanes 0
    // .. NW - 1 (five levels: in every lane, where TMAX > NW), and lane t <
    // T writes pick t
    constexpr int QI = TMAX <= 4 ? 2 : 1, kSpan = TMAX <= NW ? NW : 32;
#pragma unroll 1
    for (int q0 = warp * QI; q0 < QG; q0 += NW * QI) {
      Key ml[QI][TMAX];
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        const Key* lt = lists + lane * WS + (q0 + i) * (TMAX + 1);
#pragma unroll
        for (int t = 0; t < TMAX; ++t) ml[i][t] = lane < NW ? lt[t] : kNone;
      }
#pragma unroll
      for (int o = 1; o < kSpan; o <<= 1)
#pragma unroll
        for (int i = 0; i < QI; ++i) merge_partner<TMAX>(ml[i], o);
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        Key m = ml[i][0];
#pragma unroll
        for (int t = 1; t < TMAX; ++t) m = lane == t ? ml[i][t] : m;
        const int qa = grp * QG + q0 + i;
        if (qa < B && lane < T) {
          const long long o = (long long)qa * cols + (long long)tile * T + lane;
          vals[o] = -f32_unorder((uint32_t)(m >> 32));
          rows[o] = tile * kTileRows + (int)(m & 1023u);
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int TMAX, int S, int S0>
int launch_bf16(const void* codes, const void* lut, int B, int M, int K, int H,
                int nbuf, int n_tiles, int T, void* vals, void* rows,
                cudaStream_t st) {
  auto kern = adc_bf16_packed_kernel<TMAX, S, S0>;
  const int threads = 32 * bf16_warps(TMAX);
  const int smem = (int)bf16_smem(M, K, H, nbuf, TMAX);
  // the shared-memory opt-in (to the most a block may have, so no call
  // lowers it under another's launch) and the blocks the card holds at
  // this shared memory, asked once per host thread, device and size
  static thread_local int memo_dev = -1, memo_smem = -1, memo_blocks = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != memo_dev || smem != memo_smem) {
    if (dev != memo_dev) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (e != cudaSuccess) return (int)e;
    }
    int sms = 132, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    if (e != cudaSuccess) return (int)e;
    memo_dev = dev;
    memo_smem = smem;
    memo_blocks = sms * std::max(per_sm, 1);
  }
  const long long items = (long long)((B + 2 * H - 1) / (2 * H)) * n_tiles;
  const int blocks = (int)std::min<long long>(items, memo_blocks);
  kern<<<blocks, threads, smem, st>>>((const uint8_t*)codes, (const float*)lut, B, M,
                                      K, H, nbuf, n_tiles, T, (float*)vals,
                                      (int*)rows);
  return (int)cudaGetLastError();
}

using Bf16Launch = decltype(&launch_bf16<2, 2, 8>);

// the instantiation for (T, S, S0): S divides S0
template <int TMAX>
Bf16Launch bf16_for_s(int S, int S0) {
  if (S0 == 8)
    return S == 2 ? &launch_bf16<TMAX, 2, 8>
         : S == 4 ? &launch_bf16<TMAX, 4, 8>
                  : &launch_bf16<TMAX, 8, 8>;
  return S == 2 ? &launch_bf16<TMAX, 2, 4> : &launch_bf16<TMAX, 4, 4>;
}

Bf16Launch bf16_for(int T, int S, int S0) {
  return T <= 2 ? bf16_for_s<2>(S, S0)
       : T <= 4 ? bf16_for_s<4>(S, S0)
       : T <= 8 ? bf16_for_s<8>(S, S0)
                : bf16_for_s<32>(S, S0);
}

}  // namespace

// ---------------------------------------------------------------- C interface
// ``codes`` [>= n_tiles * 1024, M] uint8 (16-byte aligned); ``vals`` f32 /
// ``rows`` int32 [B, n_tiles * T]: column tile*T + t holds the tile's t-th
// pick (-distance, store row).  The int8 scans take the packed LUT of
// ops/adc_pallas.py::pack_lut for ``S`` (2, 4 or 8) and refuse M > 256 (the
// 16-bit sums) and layouts past the shared memory; the rerank scans add
// ``q`` [B, D] f32 (16-byte aligned), ``i8`` [rows, D] int8 (D % 4 == 0,
// 4-byte aligned), ``scales`` and ``norms2`` [rows] f32; their vals are
// -d2 of the exact rerank.  The bf16 scan takes the f32 LUT [B, M*K]
// (4-byte aligned), the layout of ops/adc_pallas.py::adc_bf16_layout: ``S``
// (dividing S0), ``H`` query pairs a phase, ``nbuf`` code buffers (1 or 2).

extern "C" {

int evdb_adc_scan_i8(const void* codes, const void* lut, int B, int M, int K,
                     int S, int n_tiles, int T, void* vals, void* rows,
                     void* stream) {
  if (bad_packed(B, M, K, S, n_tiles, T)) return (int)cudaErrorInvalidValue;
  return packed_for<false>(T, S)(codes, lut, nullptr, nullptr, nullptr, nullptr,
                                 B, M, K, 0, n_tiles, T, vals, rows,
                                 (cudaStream_t)stream);
}

int evdb_adc_rerank_scan(const void* codes, const void* lut, const void* q,
                         const void* i8, const void* scales,
                         const void* norms2, int B, int M, int K, int S, int D,
                         int n_tiles, int T, int high_lane, void* vals,
                         void* rows, void* stream) {
  if (bad_packed(B, M, K, S, n_tiles, T) || D < 4 || D % 4 || (high_lane && T != 2))
    return (int)cudaErrorInvalidValue;
  const PackedLaunch go = high_lane ? packed_for_s<true, true, 2>(S)
                                    : packed_for<true>(T, S);
  return go(codes, lut, q, i8, scales, norms2, B, M, K, D, n_tiles, T, vals, rows,
            (cudaStream_t)stream);
}

int evdb_adc_scan_bf16(const void* codes, const void* lut, int B, int M, int K,
                       int S, int H, int nbuf, int n_tiles, int T, void* vals,
                       void* rows, void* stream) {
  const int S0 = M % 8 == 0 ? 8 : 4;
  const int tmax = T <= 2 ? 2 : T <= 4 ? 4 : T <= 8 ? 8 : 32;
  if (B < 1 || M < 4 || M % 4 || K < 1 || K > 256 ||
      !(S == 2 || S == 4 || S == 8) || S0 % S || H < 1 || H > 32 / S ||
      (H & (H - 1)) || !(nbuf == 1 || nbuf == 2) || n_tiles < 1 || T < 1 ||
      T > 32 || bf16_smem(M, K, H, nbuf, tmax) > (size_t)kSmemMax)
    return (int)cudaErrorInvalidValue;
  return bf16_for(T, S, S0)(codes, lut, B, M, K, H, nbuf, n_tiles, T, vals, rows,
                            (cudaStream_t)stream);
}

}  // extern "C"
