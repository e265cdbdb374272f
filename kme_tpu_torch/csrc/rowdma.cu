// Row copies by lane id for the sweep engine's position rows: kernels B4
// and B5 of the port.
//
// Replaces kme_tpu/ops/rowdma.py:
//   B4 gather_lane_rows  (:144, kernel _gather_kernel :106)
//      out[w] = flat[lanes[w]]
//   B5 scatter_lane_rows (:159, kernel _scatter_kernel :120)
//      flat[lanes[w]] = rows[w] in place, rows aimed at skip_lane dropped
// A plane is (S, SUB, 128) int32: one lane's planar [lo | hi] position
// row per leading index (row_words = SUB * 128 words; an int64 value's
// low word at column a, its high word at column A + a, A = row_words / 2).
//
// One gather template and one scatter template, over PLANES (1 or 2
// planes per launch) and JOINED:
//   (1, planar): blocks are (W, SUB, 128) int32 rows, the Pallas
//       kernels' own contract (entries kme_gather_lane_rows,
//       kme_scatter_lane_rows);
//   (2, joined): what the lanes step launches (entries kme_gather_pos_rows,
//       kme_scatter_pos_rows). One launch moves the rows of both position
//       planes (pos_amt, pos_avail), and the blocks are the (W, A) int64
//       arrays the step computes on. The JAX package joins a gathered row
//       to int64 and splits it back before the scatter as separate copies
//       (kme_tpu/engine/lanes.py:302-305, :699-702); here that is fused
//       in: an int64 in memory is its low word then its high word (the
//       card is little-endian), so (hi << 32) | (uint32) lo is the word
//       pair (lo, hi), and joining is interleaving a 16-byte vector of
//       four lo words with the vector of their four hi words. No
//       arithmetic, so nothing can wrap.
//
// Bound: bytes. At the kme-serve --engine lanes defaults a (2, joined)
// launch reads 8 rows of 32 KiB of each plane and writes 8 x 4096 int64
// per plane: 1 MiB, 0.313 us at 3.35 TB/s, against ~2 us of launch and
// ramp. So the design is about latency: the grid is sized for the card's
// SMs (a 2-D grid, x over 16-byte groups of a row, y over the W rows;
// blocks shrink to one warp before the grid falls below the SM count),
// and each thread issues all its loads -- kVec independent 16-byte
// vectors per plane half -- before any store, so one launch is about one
// memory round trip with every byte in flight. The TPU's scalar prefetch
// of the lane ids becomes one load of the block's lane. A lane outside
// [0, S) is never dereferenced: gather writes zeros for it and scatter
// skips it; a scatter block whose lane is skip_lane (the scrap lane)
// returns before any load. Scatter targets are distinct apart from
// skip_lane (the scheduler's one-message-per-lane step invariant), so no
// two blocks write one address. Two other forms of (2, joined) were
// measured against this one on an H100 and were no faster inside a CUDA
// graph, so they are not kept (PERF.md): 1-D cp.async.bulk copies of the
// planar halves through shared memory on an mbarrier (the counterpart of
// the TPU's per-row DMA), and gather stores staged per warp in shared
// memory so that each store instruction writes 512 contiguous bytes.
//
// Plain C entries for ctypes; each launches on the given stream (so a
// CUDA graph capture records it), does not synchronise, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kVec = 2;  // 16-byte groups per thread and plane half

struct Ptrs {
  int4* p[2];
};

// interleave 4 lo words and their 4 hi words into 4 int64 (2 vectors)
__device__ __forceinline__ void join4(int4 lo, int4 hi, int4& a, int4& b) {
  a = make_int4(lo.x, hi.x, lo.y, hi.y);
  b = make_int4(lo.z, hi.z, lo.w, hi.w);
}

__device__ __forceinline__ void split4(int4 a, int4 b, int4& lo, int4& hi) {
  lo = make_int4(a.x, a.z, b.x, b.z);
  hi = make_int4(a.y, a.w, b.y, b.w);
}

// gpr: 16-byte groups per block row -- row_words / 4 when planar, and
// A / 4 when joined (a group is then 4 accounts: one lo vector, one hi
// vector, two int64 vectors); a plane row holds row_vec int4.
template <int PLANES, bool JOINED>
__global__ void gather_rows(Ptrs flat, const int* __restrict__ lanes,
                            Ptrs out, int S, int gpr, int row_vec) {
  const int w = blockIdx.y;
  const int lane = lanes[w];
  const bool in = lane >= 0 && lane < S;
  const int g0 = blockIdx.x * blockDim.x * kVec + threadIdx.x;
  int4 lo[PLANES][kVec], hi[PLANES][kVec];
#pragma unroll
  for (int p = 0; p < PLANES; ++p) {
    const int4* __restrict__ row =
        flat.p[p] + (size_t)(in ? lane : 0) * row_vec;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int g = g0 + k * blockDim.x;
      lo[p][k] = hi[p][k] = make_int4(0, 0, 0, 0);
      if (in && g < gpr) {
        lo[p][k] = __ldg(row + g);
        if (JOINED) hi[p][k] = __ldg(row + gpr + g);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < PLANES; ++p) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int g = g0 + k * blockDim.x;
      if (g >= gpr) continue;
      if (JOINED) {
        int4* o = out.p[p] + ((size_t)w * gpr + g) * 2;
        join4(lo[p][k], hi[p][k], o[0], o[1]);
      } else {
        out.p[p][(size_t)w * gpr + g] = lo[p][k];
      }
    }
  }
}

template <int PLANES, bool JOINED>
__global__ void scatter_rows(Ptrs flat, const int* __restrict__ lanes,
                             Ptrs rows, int S, int gpr, int row_vec,
                             int skip_lane) {
  const int w = blockIdx.y;
  const int lane = lanes[w];
  if (lane == skip_lane || lane < 0 || lane >= S) return;
  const int g0 = blockIdx.x * blockDim.x * kVec + threadIdx.x;
  int4 a[PLANES][kVec], b[PLANES][kVec];
#pragma unroll
  for (int p = 0; p < PLANES; ++p) {
    const int4* __restrict__ src = rows.p[p];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int g = g0 + k * blockDim.x;
      if (g >= gpr) continue;
      if (JOINED) {
        a[p][k] = __ldg(src + ((size_t)w * gpr + g) * 2);
        b[p][k] = __ldg(src + ((size_t)w * gpr + g) * 2 + 1);
      } else {
        a[p][k] = __ldg(src + (size_t)w * gpr + g);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < PLANES; ++p) {
    int4* row = flat.p[p] + (size_t)lane * row_vec;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int g = g0 + k * blockDim.x;
      if (g >= gpr) continue;
      if (JOINED) {
        int4 lo, hi;
        split4(a[p][k], b[p][k], lo, hi);
        row[g] = lo;
        row[gpr + g] = hi;
      } else {
        row[g] = a[p][k];
      }
    }
  }
}

// Threads per block: the largest of 256, 128, 64, 32 whose grid still
// gives every SM a block (or 32 when none does).
struct Launch {
  dim3 grid, block;
};

inline Launch launch_of(int W, int gpr, int sms) {
  int threads = 256;
  auto blocks_x = [&](int t) { return (gpr + t * kVec - 1) / (t * kVec); };
  while (threads > 32 && (long long)W * blocks_x(threads) < sms) threads /= 2;
  return {dim3((unsigned)blocks_x(threads), (unsigned)W), dim3(threads)};
}

template <int PLANES, bool JOINED>
int gather(const Ptrs& flat, const void* lanes, const Ptrs& out, int S, int W,
           int row_words, int sms, void* stream) {
  if (W <= 0 || row_words <= 0) return 0;
  const int row_vec = row_words / 4;
  const int gpr = JOINED ? row_vec / 2 : row_vec;
  const Launch l = launch_of(W, gpr, sms);
  gather_rows<PLANES, JOINED><<<l.grid, l.block, 0, (cudaStream_t)stream>>>(
      flat, (const int*)lanes, out, S, gpr, row_vec);
  return (int)cudaGetLastError();
}

template <int PLANES, bool JOINED>
int scatter(const Ptrs& flat, const void* lanes, const Ptrs& rows, int S,
            int W, int row_words, int skip_lane, int sms, void* stream) {
  if (W <= 0 || row_words <= 0) return 0;
  const int row_vec = row_words / 4;
  const int gpr = JOINED ? row_vec / 2 : row_vec;
  const Launch l = launch_of(W, gpr, sms);
  scatter_rows<PLANES, JOINED><<<l.grid, l.block, 0, (cudaStream_t)stream>>>(
      flat, (const int*)lanes, rows, S, gpr, row_vec, skip_lane);
  return (int)cudaGetLastError();
}

}  // namespace

// row_words: int32 words per plane row (SUB * 128, a multiple of 8);
// sms: the card's multiprocessor count, which sizes the grid.
extern "C" int kme_gather_lane_rows(const void* flat, const void* lanes,
                                    void* out, int S, int W, int row_words,
                                    int sms, void* stream) {
  return gather<1, false>(Ptrs{{(int4*)flat, nullptr}}, lanes,
                          Ptrs{{(int4*)out, nullptr}}, S, W, row_words, sms,
                          stream);
}

extern "C" int kme_scatter_lane_rows(void* flat, const void* lanes,
                                     const void* rows, int S, int W,
                                     int row_words, int skip_lane, int sms,
                                     void* stream) {
  return scatter<1, false>(Ptrs{{(int4*)flat, nullptr}}, lanes,
                           Ptrs{{(int4*)rows, nullptr}}, S, W, row_words,
                           skip_lane, sms, stream);
}

// pa, pv: the two (S, SUB, 128) int32 planes; pa_blk, pv_blk: (W, A)
// int64 blocks, A = row_words / 2.
extern "C" int kme_gather_pos_rows(const void* pa, const void* pv,
                                   const void* lanes, void* pa_blk,
                                   void* pv_blk, int S, int W, int row_words,
                                   int sms, void* stream) {
  return gather<2, true>(Ptrs{{(int4*)pa, (int4*)pv}}, lanes,
                         Ptrs{{(int4*)pa_blk, (int4*)pv_blk}}, S, W,
                         row_words, sms, stream);
}

extern "C" int kme_scatter_pos_rows(void* pa, void* pv, const void* lanes,
                                    const void* pa_blk, const void* pv_blk,
                                    int S, int W, int row_words,
                                    int skip_lane, int sms, void* stream) {
  return scatter<2, true>(Ptrs{{(int4*)pa, (int4*)pv}}, lanes,
                          Ptrs{{(int4*)pa_blk, (int4*)pv_blk}}, S, W,
                          row_words, skip_lane, sms, stream);
}


