// B7, the multiprobe gather + dot for Hopper (sm_90a), ported from
// erlvectordb_tpu/ops/cell_probe.py (_dma_gather_dots, kernel bodies
// _gather_dots_kernel and _gather_dots_kernel_packed).
//
//   out[b, j, c] = sum_w q[b, w] * code(cells[probe[b, j]], c, w)
//
// for each query b and each probed cell j: the query row against the probed
// cell's [cap, W] block of residual codes.  Two code layouts, one kernel
// (gather_mma_kernel, the layout a template parameter):
//
//   I8   [K, cap, W] int8, W a multiple of 16 (the cell-probe index's
//        8-bit residuals);
//   I4   [K, cap, W/2] uint8, two signed nibbles a byte, element 2p in the
//        high nibble, W a multiple of 32 (the int4r store's own rows).
//
// The query comes rounded to bf16 (held as f32), so every product (a code of
// at most 8 bits times a bf16) is exact in f32 and the results differ from
// any other f32 order of summation only by the rounding of the sums.  Probe
// ids outside [0, K) are clamped into it.
//
// What bounds it on an H100: the bytes, each distinct probed cell's block
// read once plus the [B, nprobe, cap] f32 output (the output is 25% of
// those bytes at (f-mp)'s nprobe 64 on int4 cells of 128 x 64 B, 1% on the
// cell-probe index's int8 cells of 512 x 768 B); the products, ~1 a code,
// are far below the ~295 a byte where the tensor cores would be the limit.
//
// What the design does about the bytes:
//
//   * The plan (ops/cell_probe.py::b7_plan_for, b7_plan): (window, sort,
//     split).  Sorted, the wrapper sorts the flat probe ids, keeping the
//     pair order (``order``), with no host sync; a block takes a window of
//     S consecutive sorted pairs (S <= 32) and walks the runs of equal cells
//     in it, so a cell is read at most (distinct cells + windows) times per
//     batch, not once per pair; a run crossing into the next window is read
//     again by that window's block, from L2.  Unsorted, windows of 1 to 8
//     pairs in pair order, each pair its own run, whose tiles the window's
//     block pipelines.  ``split`` deals a run's row tiles to that many
//     blocks (grid.y: block y takes tiles y, y + split, ...), so few pairs
//     of wide cells (int8 cells of 512 rows are 4 row tiles) still fill the
//     card's SMs.
//   * The staging: a run's cell goes to shared memory through cp.async in
//     tiles of 128 rows x 128 k (I4: 64 bytes a row, 8 KB; I8: 128 bytes a
//     row, 16 KB), double-buffered, so the next tile's copy (or the next
//     run's) is in flight during this tile's products (a third buffer did
//     not pay for int8 at W 768 and cap 512, nor at 128 x 128: the shared
//     memory it takes costs resident blocks).  I8's 16-byte pieces p of row r are
//     stored at slot p ^ 4 (r & 1), so the 8 lanes of a quarter warp (rows
//     g, g + 1) read 8 distinct bank groups.  The run's queries are staged
//     per k chunk as bf16, converted from the f32 rows; in windows of up to
//     8 pairs, the rows are loaded into registers a stage ahead and the
//     first tile's copy and query loads go out before the window's runs are
//     worked out (gather_mma_kernel's EARLY).  Shared memory, whatever cap
//     and W (MmaSmem: tile ring, two query slots, a C tile, the window):
//     I4 25,928 B (windows of up to 8 pairs), 54,536 B (up to 32); I8
//     41,544 / 67,848 B.
//   * The conversion, in registers, once per tile and warp, whatever the
//     number of queries a run holds: a nibble becomes the bf16 (n ^ 8) |
//     0x4300, less 136; a byte's low 7 bits become the bf16 128 + m and its
//     sign bit the bf16 -(128 + 128 s), summed (mma_scan.cuh: nibbles_bf16,
//     bytes_bf16; all steps exact), not through I2F.
//   * The products: mma.sync m16n8k16 bf16 with f32 accumulators (the
//     helpers in mma_scan.cuh).  A is 16 code rows (one warp a 16-row slice
//     of the tile), B the run's queries, 8 to an n-tile (a run of r queries
//     takes ceil(r / 8) of at most 4; idle columns are zero and not
//     stored).  Each element's k sequence is the same whatever its window,
//     its column or its block, so the output does not depend on the plan.
//   * The output: the C fragments go through shared memory, and each pair's
//     strip of rows is written as 16-byte vectors (streaming stores, so the
//     output does not push the cells out of L2), to out[order[i], row].
//
// The k order, stated once (ops/cell_probe.py::b7_query_order is its model).
// Thread (g = lane / 4, t = lane % 4) of a warp takes rows g and g + 8 of its
// 16-row slice; mma k step s of a 128-element chunk takes A pairs (k 2t,
// 2t + 1) and (k 2t + 8, 2t + 9) of both rows and B pairs of the same k of
// query column g.
//   I4: thread t owns packed bytes 16t .. 16t + 15 of each 64-byte chunk,
//       one 32-bit word w (0..3) for each pair of k steps 2w, 2w + 1.  Byte
//       16t + 4w + 2s + j is the A pair of k step 2w + s at k 2t + 8j,
//       2t + 8j + 1 (its high nibble the lower k): elements
//       32t + 8w + 4s + 2j + {0, 1} of the chunk.  The query's bf16 chunk is
//       staged with its 8-element groups transposed (position 32m + 8t + i
//       holds element 32t + 8m + i), so thread t's B pairs for k steps 2w,
//       2w + 1 are the 16 bytes at 64w + 16t of a query's staged row.
//   I8: thread t owns 16-byte pieces t and t + 4 of each 128-byte chunk;
//       word c (0..7) of them, word c % 4 of piece t + 4 (c / 4), is k step
//       c, and its byte 2j + i the A element at k 2t + 8j + i: element
//       16 (t + 4 (c / 4)) + 4 (c % 4) + 2j + i of the chunk.  B for step c
//       is the same four elements of the query, so the query is staged in
//       its own order and thread t's B pairs for k steps c, c + 1 (c even)
//       are the 16 bytes at 32t + 128 (c / 4) + 8 (c % 4) of its staged row.
// Staged query rows are 2 x 128 bytes plus a pad (I4 64, I8 16), so the
// rows of a quarter warp's 16-byte loads fall in distinct banks.  A row's
// tail chunk (W % 128) is zero past W on both sides.
//
// The entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include "mma_scan.cuh"

namespace {

using namespace evdb;

constexpr int kMmaThreads = 256;                 // 8 warps, 16 rows each
constexpr int kTileRows = 128;                   // code rows of a tile
constexpr int kChunk = 128;                      // k elements of a chunk
constexpr int kMaxWindow = 32;                   // pairs of a window, at most
constexpr int kCPitch = kTileRows + 4;           // words of a staged C column

// a layout's bytes of a row's chunk and of a staged query row
template <bool I8>
struct Layout {
  static constexpr int kChunkBytes = I8 ? kChunk : kChunk / 2;
  static constexpr int kQPitch = 2 * kChunk + (I8 ? 16 : 64);
};

// NQ: the query columns a block stages, the window rounded up to whole
// n-tiles (8: windows of up to 8 pairs; 32: up to kMaxWindow)
template <bool I8, int NQ>
struct MmaSmem {
  uint8_t codes[2][kTileRows * Layout<I8>::kChunkBytes];    // the tile ring
  uint8_t qs[2][NQ * Layout<I8>::kQPitch];  // the query chunk, 2 slots
  float cs[NQ * kCPitch];                        // C of a tile, column-major
  long long pair[NQ];                            // the window's flat pairs
  long long qrow[NQ];                            // their queries
  int run0[NQ + 1];                              // window slots the runs start at
  int cell[NQ];                                  // their clamped cells
  int nruns;
};

// the warp's 16 code rows of a chunk (cw: the tile's row 0 of them) against
// the run's nt n-tiles of staged query (qs), into acc
template <bool I8, int NT>
__device__ __forceinline__ void warp_chunk_dots(const uint8_t* cw, const uint8_t* qs,
                                                int nt, float (&acc)[NT][4]) {
  constexpr int CB = Layout<I8>::kChunkBytes, QP = Layout<I8>::kQPitch;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (I8) {
    // pieces t and t + 4 of rows g and g + 8 (one parity: one swizzle)
    const int sw = (g & 1) << 2;
    uint32_t wa[8], wb[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = 16 * ((t + 4 * h) ^ sw);
      const uint4 ra = *reinterpret_cast<const uint4*>(cw + g * CB + slot);
      const uint4 rb = *reinterpret_cast<const uint4*>(cw + (g + 8) * CB + slot);
      wa[4 * h] = ra.x, wa[4 * h + 1] = ra.y, wa[4 * h + 2] = ra.z, wa[4 * h + 3] = ra.w;
      wb[4 * h] = rb.x, wb[4 * h + 1] = rb.y, wb[4 * h + 2] = rb.z, wb[4 * h + 3] = rb.w;
    }
#pragma unroll
    for (int c = 0; c < 8; c += 2) {   // words c, c + 1: k steps c, c + 1
      uint32_t x0[2], y0[2], x1[2], y1[2];   // rows g, g + 8 as bf16 pairs
      mma::bytes_bf16(wa[c], x0);
      mma::bytes_bf16(wb[c], y0);
      mma::bytes_bf16(wa[c + 1], x1);
      mma::bytes_bf16(wb[c + 1], y1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          const uint4 qv = *reinterpret_cast<const uint4*>(
              qs + (8 * j + g) * QP + 32 * t + 128 * (c >> 2) + 8 * (c & 3));
          mma::mma_bf16(acc[j], x0[0], y0[0], x0[1], y0[1], qv.x, qv.y);
          mma::mma_bf16(acc[j], x1[0], y1[0], x1[1], y1[1], qv.z, qv.w);
        }
      }
    }
  } else {
    const uint4 ra = *reinterpret_cast<const uint4*>(cw + g * CB + 16 * t);
    const uint4 rb = *reinterpret_cast<const uint4*>(cw + (g + 8) * CB + 16 * t);
    const uint32_t wa[4] = {ra.x, ra.y, ra.z, ra.w};
    const uint32_t wb[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {   // word c: k steps 2c, 2c + 1
      uint32_t x[4], y[4];          // rows g, g + 8: byte i as a bf16 pair
      mma::nibbles_bf16(wa[c], x);
      mma::nibbles_bf16(wb[c], y);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          const uint4 qv = *reinterpret_cast<const uint4*>(
              qs + (8 * j + g) * QP + 64 * c + 16 * t);
          mma::mma_bf16(acc[j], x[0], y[0], x[1], y[1], qv.x, qv.y);
          mma::mma_bf16(acc[j], x[2], y[2], x[3], y[3], qv.z, qv.w);
        }
      }
    }
  }
}

// Block (x, y) takes the window of ``window`` consecutive pairs from
// x * window: ``cells`` the probe ids (clamped here), sorted, and ``order``
// their flat pairs; or, with no ``order``, the ids in pair order (runs are
// then mostly single pairs, and the window only pipelines their tiles); and
// of each run's row tiles y, y + gridDim.y, ...  EARLY (the windows of up
// to 8 pairs, NQ 8): stage 0's copy and query loads go out before the
// window's runs are worked out, and each next stage's query loads before
// this stage's products.  Without it (NQ 32: 16 registers of loads held
// across the products would cost a block an SM, measured), a stage's query
// is loaded after the previous stage's output, beside its tile's copy.
template <bool I8, int NQ, bool EARLY>
__global__ void __launch_bounds__(kMmaThreads) gather_mma_kernel(
    const uint8_t* __restrict__ codes, const int* __restrict__ cells,
    const long long* __restrict__ order, const float* __restrict__ q,
    int n_cells, int cap, int row_bytes, int w, int nprobe, long long n_pairs,
    int window, float* __restrict__ out) {
  constexpr int NT = NQ / 8;                       // n-tiles of a run, at most
  constexpr int kJobs = NQ * 32 / kMmaThreads;     // query float4s a thread stages
  constexpr int CB = Layout<I8>::kChunkBytes, QP = Layout<I8>::kQPitch;
  constexpr int kPieces = CB / 16;                 // 16-byte pieces of a row's chunk
  const int split = gridDim.y, y = blockIdx.y;
  const int tiles = ((cap + kTileRows - 1) / kTileRows - y + split - 1) / split;
  if (tiles <= 0) return;                          // no row tile of its own
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MmaSmem<I8, NQ>& sm = *reinterpret_cast<MmaSmem<I8, NQ>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long w0 = (long long)blockIdx.x * window;
  const int n_win = (int)min((long long)window, n_pairs - w0);
  const int nk = (w + kChunk - 1) / kChunk;
  const int per_run = tiles * nk;
  auto row0_of = [&](int rem) { return (y + split * (rem / nk)) * kTileRows; };

  // stage st = (run u, row tile, chunk kc): its code tile of the run's
  // ``cell`` into slot st & 1, zero past cap and past the row
  auto issue = [&](int st, int cell) {
    const int rem = st % per_run;
    const int row0 = row0_of(rem), byte0 = rem % nk * CB;
    const uint8_t* blk = codes + (long long)cell * cap * row_bytes;
    uint8_t* d = sm.codes[st & 1];
#pragma unroll
    for (int i = 0; i < kTileRows * kPieces / kMmaThreads; ++i) {
      const int e = tid + kMmaThreads * i, r = e / kPieces, piece = e % kPieces;
      const int byte = byte0 + 16 * piece;
      const bool ok = row0 + r < cap && byte < row_bytes;
      const int slot = I8 ? piece ^ ((r & 1) << 2) : piece;
      cp_async16(d + r * CB + 16 * slot,
                 ok ? blk + (long long)(row0 + r) * row_bytes + byte : blk, ok);
    }
  };
  // the query of a stage, a float4 a job, loaded into registers ahead of
  // its use (ld) and stored as bf16 in the k order (st_q): job e is column
  // e / 32 and staged elements 4 (e % 32) .. + 3 of the chunk: I8 the same
  // elements; I4 (8-element group (e % 32) / 2 = 4m + t, half e % 2)
  // elements 32t + 8m + 4 * half; zero past the column's ``ok`` and past W
  float4 qv[kJobs];
  auto ld = [&](int kc, auto row_of) {
#pragma unroll
    for (int i = 0; i < kJobs; ++i) {
      const int e = tid + kMmaThreads * i, n = e >> 5, pos = (e >> 1) & 15;
      const int k = kc * kChunk +
          (I8 ? 4 * (e & 31) : 32 * (pos & 3) + 8 * (pos >> 2) + 4 * (e & 1));
      const long long row = row_of(n);
      qv[i] = row >= 0 && k < w
          ? __ldg(reinterpret_cast<const float4*>(q + row * w + k))
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto st_q = [&](uint8_t* d) {
#pragma unroll
    for (int i = 0; i < kJobs; ++i) {
      const int e = tid + kMmaThreads * i, n = e >> 5;
      *reinterpret_cast<uint2*>(d + n * QP + 8 * (e & 31)) =
          make_uint2(mma::bf16x2(qv[i].x, qv[i].y), mma::bf16x2(qv[i].z, qv[i].w));
    }
  };

  // stage 0 (run 0 starts at slot 0) needs no run structure: its tile's
  // copy and its query's loads go out before the window's runs are known;
  // columns past run 0 hold the next slots' queries, computed and not stored
  if constexpr (EARLY) {
    issue(0, min(max(cells[w0], 0), n_cells - 1));
    cp_async_commit();
    ld(0, [&](int n) -> long long {
      if (n >= n_win) return -1;
      return (order ? order[w0 + n] : w0 + n) / nprobe;
    });
  }

  // the window's runs of equal cells (sorted cells: maximal runs)
  if (warp == 0) {
    int c = 0;
    if (lane < n_win) {
      c = min(max(cells[w0 + lane], 0), n_cells - 1);
      const long long pr = order ? order[w0 + lane] : w0 + lane;
      sm.cell[lane] = c;
      sm.pair[lane] = pr;
      sm.qrow[lane] = pr / nprobe;
    }
    const int prev = __shfl_up_sync(0xffffffffu, c, 1);
    const unsigned starts =
        __ballot_sync(0xffffffffu, lane < n_win && (lane == 0 || c != prev));
    if ((starts >> lane) & 1u) sm.run0[__popc(starts & ((1u << lane) - 1u))] = lane;
    if (lane == 0) {
      sm.nruns = __popc(starts);
      sm.run0[__popc(starts)] = n_win;
    }
  }
  if constexpr (EARLY) st_q(sm.qs[0]);
  __syncthreads();
  const int n_stage = sm.nruns * per_run;
  if constexpr (!EARLY) {
    const int r0 = sm.run0[1];
    issue(0, sm.cell[0]);
    cp_async_commit();
    ld(0, [&](int n) -> long long { return n < r0 ? sm.qrow[n] : -1; });
    st_q(sm.qs[0]);
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const bool vec = (cap & 3) == 0;

  // at stage st: its tile (issued at st - 1) and its query (stored at the
  // end of st - 1) are published by the barrier that opens it; then stage
  // st + 1's tile copy (and, EARLY, its query loads) go out, in flight
  // during st's products and output, and its query is stored into the
  // other slot (last read at st - 1) at the end
  for (int st = 0; st < n_stage; ++st) {
    const int u = st / per_run, rem = st % per_run;
    const int row0 = row0_of(rem), kc = rem % nk;
    const int p0 = sm.run0[u], r = sm.run0[u + 1] - p0;
    const int nt = (r + 7) >> 3;
    cp_async_wait<0>();
    __syncthreads();
    const bool next = st + 1 < n_stage;
    const int u1 = (st + 1) / per_run, p1 = sm.run0[min(u1, sm.nruns)];
    const int r1 = next ? sm.run0[u1 + 1] - p1 : 0;
    auto ld_next = [&]() {
      ld((st + 1) % per_run % nk,
         [&](int n) -> long long { return n < r1 ? sm.qrow[p1 + n] : -1; });
    };
    if (next) {
      issue(st + 1, sm.cell[p1]);
      if constexpr (EARLY) ld_next();
    }
    cp_async_commit();
    const bool live = row0 + 16 * warp < cap;
    if (live)
      warp_chunk_dots<I8, NT>(sm.codes[st & 1] + 16 * warp * CB,
                              sm.qs[st & 1], nt, acc);
    if (kc == nk - 1) {   // the tile's last chunk: C out through shared memory
      if (live) {
        const int g = lane >> 2, t = lane & 3, row = 16 * warp + g;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nt) {
            float* c0 = sm.cs + (8 * j + 2 * t) * kCPitch + row;
            c0[0] = acc[j][0];
            c0[kCPitch] = acc[j][1];
            c0[8] = acc[j][2];
            c0[kCPitch + 8] = acc[j][3];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        }
      }
      __syncthreads();
      const int rows = min(kTileRows, cap - row0);
      if (vec) {
        const int nv = rows >> 2;
        for (int e = tid; e < r * nv; e += kMmaThreads) {
          const int n = e / nv, v = e - n * nv;
          __stcs(reinterpret_cast<float4*>(out + sm.pair[p0 + n] * cap + row0) + v,
                 *reinterpret_cast<const float4*>(sm.cs + n * kCPitch + 4 * v));
        }
      } else {
        for (int e = tid; e < r * rows; e += kMmaThreads) {
          const int n = e / rows, v = e - n * rows;
          __stcs(out + sm.pair[p0 + n] * cap + row0 + v, sm.cs[n * kCPitch + v]);
        }
      }
    }
    if (next) {
      if constexpr (!EARLY) ld_next();
      st_q(sm.qs[(st + 1) & 1]);
    }
  }
}

template <bool I8, int NQ>
int launch_gather_mma(const void* codes, const void* cells, const void* order,
                      const void* q, int n_cells, int cap, int w, int nprobe,
                      int n_pairs, int window, int split, void* out, void* stream) {
  static const int rc = evdb::mma::configure(gather_mma_kernel<I8, NQ, NQ == 8>);
  if (rc) return rc;
  const dim3 grid((n_pairs + window - 1) / window, split);
  gather_mma_kernel<I8, NQ, NQ == 8>
      <<<grid, kMmaThreads, sizeof(MmaSmem<I8, NQ>), (cudaStream_t)stream>>>(
          (const uint8_t*)codes, (const int*)cells, (const long long*)order,
          (const float*)q, n_cells, cap, I8 ? w : w / 2, w, nprobe, n_pairs,
          window, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------- C interface

extern "C" {

// ``codes`` [n_cells, cap, W] int8 (``int8``; W a multiple of 16) or
// [n_cells, cap, W / 2] packed bytes (W a multiple of 32), 16-byte aligned;
// ``cells`` the n_pairs = B * nprobe probe ids, sorted where ``order``
// (int64, their flat pairs b * nprobe + j) is given, else in pair order;
// ``q`` [B, W] f32, bf16-exact; ``out`` [B, nprobe, cap] f32; ``window``
// pairs a block (1..32), ``split`` blocks a run (1..the row tiles of a
// cell).
int evdb_gather_dots(const void* codes, const void* cells, const void* order,
                     const void* q, int n_cells, int cap, int w, int nprobe,
                     int n_pairs, int window, int split, int int8, void* out,
                     void* stream) {
  if (n_cells < 1 || cap < 1 || nprobe < 1 || n_pairs < 1 || w < 16 ||
      w % (int8 ? 16 : 32) || window < 1 || window > kMaxWindow || split < 1 ||
      split > (cap + kTileRows - 1) / kTileRows)
    return (int)cudaErrorInvalidValue;
  const auto launch = int8 ? (window <= 8 ? launch_gather_mma<true, 8>
                                           : launch_gather_mma<true, kMaxWindow>)
                           : (window <= 8 ? launch_gather_mma<false, 8>
                                          : launch_gather_mma<false, kMaxWindow>);
  return launch(codes, cells, order, q, n_cells, cap, w, nprobe, n_pairs, window,
                split, out, stream);
}

}  // extern "C"
