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
// (round to nearest even) and the M values added in f32 in subspace order,
// as the TPU kernel's bf16 one-hot contraction does (every product with a
// one-hot entry is exact; only the order of the sum is the port's own).
// The TPU contracts a [rows, M*K] one-hot matrix with the LUT on its matrix
// unit (its way around gathers); these kernels look the LUT up directly.
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
// ---- f32 LUT rounded to bf16 (B10-bf16): adc_bf16_kernel
//
// The first design, kept (no caller but tests): a block holds the LUTs of 8
// queries, one warp a query, stages a 1024-row tile's codes, lane l scores
// rows l, l + 32, ... (one LUT element per lookup), keys (order(dist) << 32)
// | lane, and T rounds of a warp minimum pick the tile's winners.
//
// The entry points launch on the given stream, allocate nothing, and return
// cudaGetLastError() (or the error of the shared-memory attribute call).

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

using evdb::cp_async16;
using evdb::cp_async_commit;
using evdb::cp_async_wait;

constexpr int kTileRows = 1024;   // ADC_TILE_N: rows per tile / slice
constexpr int kSmemMax = 232448;  // shared memory a block may use
constexpr int kMaxM = 256;        // 16-bit sums: M * 255 < 65,536

template <typename T>
__device__ __forceinline__ T warp_min_key(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}

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

// insert v into an ascending list of TMAX keys (the largest falls off):
// branch-free for short lists, past a compare with the last key for long
// ones (a key of a long list is rarely inserted)
template <int TMAX>
__device__ __forceinline__ void push_min(uint32_t (&top)[TMAX], uint32_t v) {
  if (TMAX > 4 && v >= top[TMAX - 1]) return;
#pragma unroll
  for (int i = 0; i < TMAX; ++i) {
    const uint32_t lo = min(top[i], v);
    v = max(top[i], v);
    top[i] = lo;
  }
}

// the ascending lists of lanes l and l ^ o -> the TMAX smallest of their
// union in both lanes, in place: min(a[i], b[TMAX - 1 - i]) is a bitonic
// sequence holding them, which log2(TMAX) half-cleaner stages sort
template <int TMAX>
__device__ __forceinline__ void merge_partner(uint32_t (&a)[TMAX], int o) {
  uint32_t b[TMAX];
#pragma unroll
  for (int i = 0; i < TMAX; ++i) b[i] = __shfl_xor_sync(0xffffffffu, a[TMAX - 1 - i], o);
#pragma unroll
  for (int i = 0; i < TMAX; ++i) a[i] = min(a[i], b[i]);
#pragma unroll
  for (int d = TMAX / 2; d > 0; d >>= 1)
#pragma unroll
    for (int i = 0; i < TMAX; ++i)
      if ((i & d) == 0) {
        const uint32_t lo = min(a[i], a[i + d]);
        a[i + d] = max(a[i], a[i + d]);
        a[i] = lo;
      }
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

constexpr int kBfWarps = 8;                 // queries per block, one warp each
constexpr int kBfThreads = 32 * kBfWarps;
constexpr int kLaneRows = kTileRows / 32;   // rows a lane scores per tile

// monotone f32 -> u32 (ascending floats give ascending words) and back
__device__ __forceinline__ uint32_t f32_order(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float f32_unorder(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__host__ __device__ constexpr size_t bf16_lut_bytes(int M, int K) {
  return (2 * (size_t)kBfWarps * M * K + 15) & ~size_t(15);
}

__global__ void __launch_bounds__(kBfThreads) adc_bf16_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ lut_in, int B,
    int M, int K, int n_tiles, int tiles_per_block, int T,
    float* __restrict__ vals, int* __restrict__ rows) {
  using Key = unsigned long long;
  constexpr Key kMax = ~0ull;
  extern __shared__ __align__(16) unsigned char smem[];
  const int mk = M * K;
  uint8_t* codes_s = smem;                                              // [1024, M]
  __nv_bfloat16* lut_s = reinterpret_cast<__nv_bfloat16*>(smem + kTileRows * M);  // [8, M*K]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (int)blockIdx.y * kBfWarps;
  const int qi = q0 + warp;
  const bool live = qi < B;

  for (int i = tid; i < kBfWarps * mk; i += kBfThreads) {   // rounded to bf16
    const int w = i / mk;
    lut_s[i] = __float2bfloat16_rn(
        q0 + w < B ? lut_in[(long long)(q0 + w) * mk + (i - w * mk)] : 0.f);
  }

  const __nv_bfloat16* lut_w = lut_s + warp * mk;
  const long long cols = (long long)n_tiles * T;
  const int t_end = min(n_tiles, ((int)blockIdx.x + 1) * tiles_per_block);
  for (int tile = (int)blockIdx.x * tiles_per_block; tile < t_end; ++tile) {
    __syncthreads();  // every warp is done with the previous tile's codes
    const uint4* src = reinterpret_cast<const uint4*>(
        codes + (long long)tile * kTileRows * M);
    for (int i = tid; i < kTileRows * M / 16; i += kBfThreads)
      reinterpret_cast<uint4*>(codes_s)[i] = src[i];
    __syncthreads();
    if (!live) continue;

    Key key[kLaneRows];
    Key lmin = kMax;
#pragma unroll
    for (int i = 0; i < kLaneRows; ++i) {
      const int r = lane + 32 * i;
      const uint32_t* cw = reinterpret_cast<const uint32_t*>(codes_s + r * M);
      float acc = 0.f;
      for (int w = 0; w < M / 4; ++w) {
        const uint32_t c = cw[w];
        const __nv_bfloat16* l = lut_w + 4 * w * K;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc = __fadd_rn(acc, __bfloat162float(l[j * K + ((c >> (8 * j)) & 0xffu)]));
      }
      key[i] = ((Key)f32_order(acc) << 32) | (Key)r;
      lmin = key[i] < lmin ? key[i] : lmin;
    }

    for (int t = 0; t < T; ++t) {
      const Key wk = warp_min_key(lmin);
      const int r = (int)(wk & 0xffffffffull);
      if (lane == (r & 31)) {  // the lane that owns the winner drops it
        lmin = kMax;
#pragma unroll
        for (int i = 0; i < kLaneRows; ++i) {
          if (key[i] == wk) key[i] = kMax;
          lmin = key[i] < lmin ? key[i] : lmin;
        }
      }
      if (lane == 0) {
        const long long o = (long long)qi * cols + (long long)tile * T + t;
        vals[o] = -f32_unorder((uint32_t)(wk >> 32));
        rows[o] = tile * kTileRows + r;
      }
    }
  }
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
// -d2 of the exact rerank.  The bf16 scan takes the f32 LUT [B, M*K].

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
                       int n_tiles, int T, void* vals, void* rows, void* stream) {
  if (B < 1 || B > 65535 * kBfWarps || M < 4 || M % 4 || K < 1 || K > 256 ||
      n_tiles < 1 || T < 1 || T > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)kTileRows * M + bf16_lut_bytes(M, K);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        adc_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // about 8 blocks an SM; each walks a run of tiles, so a block loads its
  // LUTs once per run instead of once per tile
  const int groups = (B + kBfWarps - 1) / kBfWarps;
  const long long want = 8LL * sms;
  int chunks = (int)std::min<long long>(
      n_tiles, std::max<long long>(1, (want + groups - 1) / groups));
  const int per_block = (n_tiles + chunks - 1) / chunks;
  chunks = (n_tiles + per_block - 1) / per_block;
  adc_bf16_kernel<<<dim3(chunks, groups), kBfThreads, smem, st>>>(
      (const uint8_t*)codes, (const float*)lut, B, M, K, n_tiles, per_block, T,
      (float*)vals, (int*)rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
