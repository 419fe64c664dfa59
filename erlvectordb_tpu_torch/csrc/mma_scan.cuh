// The int8 tensor-core tile core of the scans (residual_scan.cu's B5; meant
// for B1-B4 and B6 too): packed int4 codes unpacked once into shared memory,
// fragments read with ldmatrix, dots on mma.sync m16n8k32 s8 with int32
// accumulators.  Integer sums are exact in any order, so a kernel built on
// this core gives the same dots as a __dp4a scan, bit for bit.
//
// Operands, as the mma sees them:
//   A (16 x 32 int8, row-major)  16 queries of the block's query tile;
//   B (32 x 8 int8, col-major)   8 code rows, each row's 32 bytes of k;
//   C (16 x 8 int32)             thread (g = lane / 4, t = lane % 4) holds
//                                [0], [1]: query g,     code rows 2t, 2t+1;
//                                [2], [3]: query g + 8, code rows 2t, 2t+1.
// A warp covers 16 queries x 64 code rows (8 n-blocks) per kK-wide k stage:
// one ldmatrix.x4 of query per 32 k, one ldmatrix.x4 per two n-blocks.
//
// Shared-memory layout: rows of int8 at a pitch of their width + 16 bytes,
// so the 8 rows an ldmatrix phase reads start 4 banks apart (conflict-free).
// Packed nibbles unpack to the order [high nibbles | low nibbles] of each
// 32-bit code word, i.e. elements [0 2 4 6 | 1 3 5 7] of its 8-element
// group: the order in which the wrappers already hand over the query.

#pragma once

#include "scan_common.cuh"

namespace evdb {
namespace mma {

constexpr int kWarpQ = 16;                  // queries per warp (one m16 tile)
constexpr int kRows = 64;                   // code rows per stage (8 n-blocks)
constexpr int kK = 128;                     // int8 elements per stage (64 packed B)
constexpr int kPad = 16;                    // row pitch pad, bytes
constexpr int kCodePitch = kK + kPad;       // 144 B

// byte-wise sign extension of four nibbles 0..15 -> int8 -8..7: a byte with
// bit 3 set gains 0xF0 (8 * 0x1E = 0xF0, no carry between bytes)
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t x) {
  return x | ((x & 0x08080808u) * 0x1Eu);
}

// one packed code word (8 elements) -> two int8 words: high nibbles
// (elements 0, 2, 4, 6), then low nibbles (1, 3, 5, 7)
__device__ __forceinline__ uint2 unpack_word(uint32_t c) {
  return make_uint2(sext_nibbles((c >> 4) & 0x0F0F0F0Fu),
                    sext_nibbles(c & 0x0F0F0F0Fu));
}

// 16 packed bytes (32 elements) -> 32 int8 bytes at dst (16-byte aligned)
__device__ __forceinline__ void unpack_store(int8_t* dst, uint4 p) {
  const uint2 a = unpack_word(p.x), b = unpack_word(p.y);
  const uint2 c = unpack_word(p.z), d = unpack_word(p.w);
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(a.x, a.y, b.x, b.y);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += dots of the warp's 16 query rows (qs: row 0 of them, pitch qp
// bytes, at the stage's first k) with the 64 code rows at cs (pitch
// kCodePitch) over kK elements; acc[j] is the C fragment of n-block j
// (code rows 8j .. 8j + 7).
__device__ __forceinline__ void warp_tile_dots(const int8_t* qs, int qp,
                                               const int8_t* cs, int (&acc)[8][4]) {
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3, r = lane & 7;
  // ldmatrix.x4 row addresses: lanes 8m .. 8m + 7 give matrix m's rows.
  // A: matrices (rows 0-7, k 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31)
  // B: matrices (n-block j, k 0-15), (j, 16-31), (j + 1, 0-15), (j + 1, 16-31)
  const int8_t* qa = qs + ((m & 1) * 8 + r) * qp + (m >> 1) * 16;
  const int8_t* ca = cs + ((m >> 1) * 8 + r) * kCodePitch + (m & 1) * 16;
#pragma unroll
  for (int ks = 0; ks < kK; ks += 32) {
    uint32_t a[4];
    ldmatrix_x4(a, qa + ks);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, ca + j * 8 * kCodePitch + ks);
      mma_s8(acc[j], a, b[0], b[1]);
      mma_s8(acc[j + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace mma
}  // namespace evdb
