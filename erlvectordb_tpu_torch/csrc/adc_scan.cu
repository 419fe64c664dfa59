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
// The ADC distance of row n for query b is sum_m lut[b, m*K + code[n, m]],
// summed in subspace order: exact int32 for an int8 LUT; for B10's f32 LUT,
// each entry rounded to bf16 (round to nearest even) and the M values added in
// f32, as the TPU kernel's bf16 one-hot contraction does (every product with a
// one-hot entry is exact; only the order of the sum is the port's own).
//
// Where the TPU contracts a [rows, M*K] one-hot matrix with the LUT on its
// matrix unit (the TPU's way around gathers), this kernel looks the LUT up
// directly: a block holds the LUTs of 8 queries in shared memory, one warp a
// query, and walks a run of 1024-row tiles.  For each tile the block stages
// the tile's codes in shared memory (8 bytes a row at M = 8); lane l of a warp
// scores rows l, l + 32, ... (32 rows), keeping one packed key per row in
// registers:
//
//   int8 LUT   (dist << 10) | lane          (B8: | 1023 - lane)
//   bf16 LUT   (order(dist) << 32) | lane   (order: the monotone f32 -> u32 map)
//
// so the smallest key is the smallest distance with the TPU kernel's tie rule.
// T rounds of a warp minimum pick the tile's winners; the lane that owns a
// winner drops it and refreshes its own minimum.  B8/B9 then rerank each
// winner with the whole warp: its int8 row (D bytes) is read straight from
// device memory against the query held in shared memory, qdot = sum(q * x)
// * scale, d2 = |q|^2 - 2 qdot + |x|^2 with every product and sum rounded
// on its own (no FMA, as XLA computes the TPU kernel's expression).  Where
// the TPU rerank gathers the row with a second one-hot contraction, this is
// one 128-byte load at D = 128.
//
// What bounds it on an H100: the lookups.  At the SIFT1M-class shapes (512
// queries x 1,007,616 rows x 8 subspaces) the kernels make 4.1e9 LUT lookups
// and read 8 MB of codes, so they are lookup-bound: one 32-bit shared-memory
// word per lane per clock on 132 SMs is ~0.5 ms at 1,980 MHz, against ~0.04 ms
// for the bytes.  Random codes make the lanes of a warp meet in the same banks;
// a bank-aware LUT layout (or tensor cores on a one-hot tile) is the open
// design work.
//
// The entry points launch on the given stream, allocate nothing, and return
// cudaGetLastError() (or the error of the shared-memory attribute call).

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 1024;             // ADC_TILE_N: rows per tile / slice
constexpr int kAdcWarps = 8;                // queries per block, one warp each
constexpr int kAdcThreads = 32 * kAdcWarps;
constexpr int kLaneRows = kTileRows / 32;   // rows a lane scores per tile

template <bool BF16> struct AdcKey;
template <> struct AdcKey<false> {
  using T = uint32_t;
  using Lut = int8_t;
  static constexpr T kMax = 0xffffffffu;
};
template <> struct AdcKey<true> {
  using T = unsigned long long;
  using Lut = __nv_bfloat16;
  static constexpr T kMax = ~0ull;
};

// monotone f32 -> u32 (ascending floats give ascending words) and back
__device__ __forceinline__ uint32_t f32_order(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float f32_unorder(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

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

__host__ __device__ constexpr size_t round16(size_t b) { return (b + 15) & ~size_t(15); }

template <bool BF16>
__host__ __device__ constexpr size_t lut_bytes(int M, int K) {
  return round16(sizeof(typename AdcKey<BF16>::Lut) * kAdcWarps * (size_t)M * K);
}

template <bool BF16, bool RERANK, bool HIGH>
__global__ void __launch_bounds__(kAdcThreads) adc_scan_kernel(
    const uint8_t* __restrict__ codes, const void* __restrict__ lut_in,
    const float* __restrict__ q, const int8_t* __restrict__ i8,
    const float* __restrict__ scales, const float* __restrict__ norms2, int B,
    int M, int K, int D, int n_tiles, int tiles_per_block, int T,
    float* __restrict__ vals, int* __restrict__ rows) {
  using Key = typename AdcKey<BF16>::T;
  using Lut = typename AdcKey<BF16>::Lut;
  constexpr Key kMax = AdcKey<BF16>::kMax;
  extern __shared__ __align__(16) unsigned char smem[];
  const int mk = M * K;
  uint8_t* codes_s = smem;                                    // [1024, M]
  Lut* lut_s = reinterpret_cast<Lut*>(smem + kTileRows * M);  // [8, M*K]
  float* q_s = reinterpret_cast<float*>(smem + kTileRows * M +
                                        lut_bytes<BF16>(M, K));  // [8, D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (int)blockIdx.y * kAdcWarps;
  const int qi = q0 + warp;
  const bool live = qi < B;

  // the block's 8 LUTs (B10-bf16 rounds the f32 table to bf16 here)
  for (int i = tid; i < kAdcWarps * mk; i += kAdcThreads) {
    const int w = i / mk;
    const long long src = (long long)(q0 + w) * mk + (i - w * mk);
    if constexpr (BF16)
      lut_s[i] = __float2bfloat16_rn(
          q0 + w < B ? static_cast<const float*>(lut_in)[src] : 0.f);
    else
      lut_s[i] = q0 + w < B ? static_cast<const int8_t*>(lut_in)[src] : 0;
  }
  if constexpr (RERANK) {
    for (int i = tid; i < kAdcWarps * D; i += kAdcThreads) {
      const int w = i / D;
      q_s[i] = q0 + w < B ? q[(long long)(q0 + w) * D + (i - w * D)] : 0.f;
    }
  }
  __syncthreads();
  float qsq = 0.f;
  if constexpr (RERANK) {
    float acc = 0.f;
    for (int e = lane; e < D; e += 32)
      acc = __fadd_rn(acc, __fmul_rn(q_s[warp * D + e], q_s[warp * D + e]));
    qsq = warp_sum(acc);
  }

  const Lut* lut_w = lut_s + warp * mk;
  const float4* q_w = reinterpret_cast<const float4*>(q_s + warp * D);
  const long long cols = (long long)n_tiles * T;
  const int t_end = min(n_tiles, ((int)blockIdx.x + 1) * tiles_per_block);
  for (int tile = (int)blockIdx.x * tiles_per_block; tile < t_end; ++tile) {
    __syncthreads();  // every warp is done with the previous tile's codes
    const uint4* src = reinterpret_cast<const uint4*>(
        codes + (long long)tile * kTileRows * M);
    for (int i = tid; i < kTileRows * M / 16; i += kAdcThreads)
      reinterpret_cast<uint4*>(codes_s)[i] = src[i];
    __syncthreads();
    if (!live) continue;

    Key key[kLaneRows];
    Key lmin = kMax;
#pragma unroll
    for (int i = 0; i < kLaneRows; ++i) {
      const int r = lane + 32 * i;
      const uint32_t* cw = reinterpret_cast<const uint32_t*>(codes_s + r * M);
      typename std::conditional<BF16, float, int>::type acc = 0;
      for (int w = 0; w < M / 4; ++w) {
        const uint32_t c = cw[w];
        const Lut* l = lut_w + 4 * w * K;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const Lut v = l[j * K + ((c >> (8 * j)) & 0xffu)];
          if constexpr (BF16)
            acc = __fadd_rn(acc, __bfloat162float(v));
          else
            acc += v;
        }
      }
      if constexpr (BF16)
        key[i] = ((Key)f32_order(acc) << 32) | (Key)r;
      else
        key[i] = ((Key)acc << 10) | (Key)(HIGH ? 1023 - r : r);
      lmin = key[i] < lmin ? key[i] : lmin;
    }

    for (int t = 0; t < T; ++t) {
      const Key wk = warp_min_key(lmin);
      int r;
      if constexpr (BF16)
        r = (int)(wk & 0xffffffffull);
      else
        r = HIGH ? 1023 - (int)(wk & 1023u) : (int)(wk & 1023u);
      if (lane == (r & 31)) {  // the lane that owns the winner drops it
        lmin = kMax;
#pragma unroll
        for (int i = 0; i < kLaneRows; ++i) {
          if (key[i] == wk) key[i] = kMax;
          lmin = key[i] < lmin ? key[i] : lmin;
        }
      }
      const long long row = (long long)tile * kTileRows + r;
      float v;
      if constexpr (RERANK) {
        const char4* xr = reinterpret_cast<const char4*>(i8 + row * D);
        float acc = 0.f;
        for (int e4 = lane; e4 < D / 4; e4 += 32) {
          const char4 x = xr[e4];
          const float4 qq = q_w[e4];
          acc = __fadd_rn(acc, __fmul_rn(qq.x, (float)x.x));
          acc = __fadd_rn(acc, __fmul_rn(qq.y, (float)x.y));
          acc = __fadd_rn(acc, __fmul_rn(qq.z, (float)x.z));
          acc = __fadd_rn(acc, __fmul_rn(qq.w, (float)x.w));
        }
        const float qdot = __fmul_rn(warp_sum(acc), scales[row]);
        v = -__fadd_rn(__fsub_rn(qsq, __fmul_rn(2.f, qdot)), norms2[row]);
      } else if constexpr (BF16) {
        v = -f32_unorder((uint32_t)(wk >> 32));
      } else {
        v = -(float)(int)(wk >> 10);
      }
      if (lane == 0) {
        const long long o = (long long)qi * cols + (long long)tile * T + t;
        vals[o] = v;
        rows[o] = (int)row;
      }
    }
  }
}

template <bool BF16, bool RERANK, bool HIGH>
int launch(const void* codes, const void* lut, const void* q, const void* i8,
           const void* scales, const void* norms2, int B, int M, int K, int D,
           int n_tiles, int T, void* vals, void* rows, cudaStream_t st) {
  auto kern = adc_scan_kernel<BF16, RERANK, HIGH>;
  const size_t smem = (size_t)kTileRows * M + lut_bytes<BF16>(M, K) +
                      (RERANK ? sizeof(float) * kAdcWarps * D : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // about 8 blocks an SM; each walks a run of tiles, so a block loads its
  // LUTs once per run instead of once per tile
  const int groups = (B + kAdcWarps - 1) / kAdcWarps;
  const long long want = 8LL * sms;
  int chunks = (int)std::min<long long>(
      n_tiles, std::max<long long>(1, (want + groups - 1) / groups));
  const int per_block = (n_tiles + chunks - 1) / chunks;
  chunks = (n_tiles + per_block - 1) / per_block;
  kern<<<dim3(chunks, groups), kAdcThreads, smem, st>>>(
      (const uint8_t*)codes, lut, (const float*)q, (const int8_t*)i8,
      (const float*)scales, (const float*)norms2, B, M, K, D, n_tiles,
      per_block, T, (float*)vals, (int*)rows);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int M, int K, int n_tiles, int T) {
  return B < 1 || B > 65535 * kAdcWarps || M < 4 || M % 4 || K < 1 ||
         K > 256 || n_tiles < 1 || T < 1 || T > 32;
}

}  // namespace

// ---------------------------------------------------------------- C interface
// ``codes`` [>= n_tiles * 1024, M] uint8 (16-byte aligned); ``lut`` [B, M*K]
// int8 (``bf16`` = 0) or f32 (``bf16`` = 1, rounded to bf16 in the kernel);
// ``vals`` f32 / ``rows`` int32 [B, n_tiles * T]: column tile*T + t holds the
// tile's t-th pick (-distance, store row).  The rerank scans add ``q`` [B, D]
// f32, ``i8`` [rows, D] int8 (D % 4 == 0, 4-byte aligned), ``scales`` and
// ``norms2`` [rows] f32; their vals are -d2 of the exact rerank.

extern "C" {

int evdb_adc_scan(const void* codes, const void* lut, int bf16, int B, int M,
                  int K, int n_tiles, int T, void* vals, void* rows,
                  void* stream) {
  if (bad_shape(B, M, K, n_tiles, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch<true, false, false>(codes, lut, nullptr, nullptr, nullptr,
                                      nullptr, B, M, K, 0, n_tiles, T, vals,
                                      rows, st);
  return launch<false, false, false>(codes, lut, nullptr, nullptr, nullptr,
                                     nullptr, B, M, K, 0, n_tiles, T, vals,
                                     rows, st);
}

int evdb_adc_rerank_scan(const void* codes, const void* lut, const void* q,
                         const void* i8, const void* scales,
                         const void* norms2, int B, int M, int K, int D,
                         int n_tiles, int T, int high_lane, void* vals,
                         void* rows, void* stream) {
  if (bad_shape(B, M, K, n_tiles, T) || D < 4 || D % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (high_lane)
    return launch<false, true, true>(codes, lut, q, i8, scales, norms2, B, M,
                                     K, D, n_tiles, T, vals, rows, st);
  return launch<false, true, false>(codes, lut, q, i8, scales, norms2, B, M, K,
                                    D, n_tiles, T, vals, rows, st);
}

}  // extern "C"
