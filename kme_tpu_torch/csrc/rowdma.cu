// Row copies by lane id for the sweep engine's position rows: kernels B4
// and B5 of the port.
//
// Replaces kme_tpu/ops/rowdma.py:
//   B4 gather_lane_rows  (:144, kernel _gather_kernel :106)
//      out[w] = flat[lanes[w]]
//   B5 scatter_lane_rows (:159, kernel _scatter_kernel :120)
//      flat[lanes[w]] = rows[w] in place, rows aimed at skip_lane dropped
// flat is (S, SUB, 128) int32 (one lane's planar [lo | hi] position row
// per leading index), rows/out are (W, SUB, 128) int32, lanes is (W,)
// int32.
//
// Bound: bytes. Each call moves W rows one way (at the kme-serve
// defaults 8 rows of 32 KiB: 256 KiB read and 256 KiB written) and does
// no arithmetic, so the floor is 2 * W * row_bytes over the card's
// memory rate. On the TPU each row was one async DMA with its own
// semaphore; here one block of 256 threads copies 4 KiB of one row with
// 16-byte int4 loads and stores, neighbouring threads on neighbouring
// addresses, and the grid is W x ceil(row_bytes / 4096) blocks, so all
// rows are in flight at once. Each block reads its lane id itself (the
// TPU's scalar prefetch). A lane outside [0, S) is never dereferenced:
// gather writes zeros for it and scatter skips it. Scatter targets are
// distinct apart from skip_lane (the scheduler's one-message-per-lane
// step invariant), so no two blocks write one address.
//
// Plain C entries for ctypes; each launches on the given stream, does
// not synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_rows(const int4* __restrict__ flat,
                            const int* __restrict__ lanes,
                            int4* __restrict__ out, int S, int row_vec) {
  const int w = blockIdx.x;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= row_vec) return;
  const int lane = lanes[w];
  int4 v = make_int4(0, 0, 0, 0);
  if (lane >= 0 && lane < S) v = flat[(size_t)lane * row_vec + i];
  out[(size_t)w * row_vec + i] = v;
}

__global__ void scatter_rows(int4* __restrict__ flat,
                             const int* __restrict__ lanes,
                             const int4* __restrict__ rows, int S,
                             int row_vec, int skip_lane) {
  const int w = blockIdx.x;
  const int lane = lanes[w];
  if (lane == skip_lane || lane < 0 || lane >= S) return;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= row_vec) return;
  flat[(size_t)lane * row_vec + i] = rows[(size_t)w * row_vec + i];
}

inline dim3 grid_of(int W, int row_vec) {
  return dim3((unsigned)W, (unsigned)((row_vec + kThreads - 1) / kThreads));
}

}  // namespace

// row_words: int32 words per row (SUB * 128, a multiple of 4).
extern "C" int kme_gather_lane_rows(const void* flat, const void* lanes,
                                    void* out, int S, int W, int row_words,
                                    void* stream) {
  if (W <= 0 || row_words <= 0) return 0;
  const int row_vec = row_words / 4;
  gather_rows<<<grid_of(W, row_vec), kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)flat, (const int*)lanes, (int4*)out, S, row_vec);
  return (int)cudaGetLastError();
}

extern "C" int kme_scatter_lane_rows(void* flat, const void* lanes,
                                     const void* rows, int S, int W,
                                     int row_words, int skip_lane,
                                     void* stream) {
  if (W <= 0 || row_words <= 0) return 0;
  const int row_vec = row_words / 4;
  scatter_rows<<<grid_of(W, row_vec), kThreads, 0, (cudaStream_t)stream>>>(
      (int4*)flat, (const int*)lanes, (const int4*)rows, S, row_vec,
      skip_lane);
  return (int)cudaGetLastError();
}
