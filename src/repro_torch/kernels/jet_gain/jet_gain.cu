// jet_gain: the Jetlp connectivity query (paper Alg 4.2 lines 3-7) on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/jet_gain/jet_gain.py:_kernel
// (pallas_call in jet_gain_pallas).  For each row of an ELL panel (one
// vertex of one trial), with ghost slots carrying part k and weight 0:
//   conn_self = connectivity to the row's own part (clamped to [0, k]),
//   best_part = the other part (not k) of largest positive connectivity,
//               smallest id on ties, k when there is none,
//   best_conn = its connectivity, at least 0.
// Slot part ids outside [0, k] count for nothing.  Row r = (b*T + t)*N + v
// reads nbr_parts row r and wgt row b*N + v: the weights are one (N, D)
// panel per lane b of a fleet bucket (one in all without a lane axis),
// shared by the lane's T trials and never copied.
//
// The TPU kernel sweeps all k parts per row, O(k*D), because it cannot
// gather.  A row touches at most D parts, and every untouched part has
// connectivity 0 and never wins, so here nothing k-wide is kept:
//
// jet_gain_rows (D <= 32): a row is a group of G lanes, G the smallest power
// of two >= D, so a warp takes 32/G rows (4 at the refinement's D = 6).
// Lane j holds slot j's part and weight.  Each lane sums, with shuffles
// inside its group, the weights of the slots that carry its part (its
// part's connectivity) and of those that carry the row's own part
// (conn_self); then the group reduces (conn descending, part ascending) over
// the lanes whose part is in [0, k) and is not the row's own.  At G = 32 (a
// warp per row) the D-step shuffle loop gives way to match.any and warp
// reductions, twice as fast at D = 17..32; at G <= 16 the loop is the faster.
// Integer sums, so the order of the adds does not matter; the time does not
// depend on k.
//
// jet_gain_hist (D > 32): one warp per row scatters the row's D slots into a
// per-warp histogram in shared memory with integer atomicAdd, then reduces
// the histogram across the warp.  When k+1 exceeds the per-warp budget of
// kBinsMax bins, the warp loops over chunks of parts and re-reads the row;
// no k and no D is refused.
//
// Bound: memory.  Per trial it must read N*D*8 + N*4 bytes (parts and
// weights of the panel, own parts) and write N*12 (three int32 outputs);
// the arithmetic is a handful of integer operations per slot.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;        // warps per block
constexpr int kBinsMax = 1024;   // shared-memory histogram bins per warp

__device__ __forceinline__ bool better(int c, int p, int best_c, int best_p) {
  return c > best_c || (c == best_c && p < best_p);
}

// the weight row of panel row `row`: row % n without a lane axis (lane_rows
// == rows), else (row / lane_rows) * n + row % n with lane_rows = T*N panel
// rows per lane; in 32 bits where that fits (the result is at most row)
__device__ __forceinline__ long long wgt_row(long long row, long long rows,
                                             long long lane_rows, long long n,
                                             bool narrow) {
  if (narrow) {
    const unsigned r = (unsigned)row, v = r % (unsigned)n;
    return lane_rows == rows ? v : r / (unsigned)lane_rows * (unsigned)n + v;
  }
  const long long v = row % n;
  return lane_rows == rows ? v : row / lane_rows * n + v;
}

template <int G>
__global__ void __launch_bounds__(kWarps * 32)
jet_gain_rows(const int* __restrict__ nbr_parts, const int* __restrict__ wgt,
              const int* __restrict__ parts, int* __restrict__ conn_self,
              int* __restrict__ best_part, int* __restrict__ best_conn,
              long long rows, long long lane_rows, long long n, int d, int k,
              bool narrow) {
  const long long row =
      ((long long)blockIdx.x * (kWarps * 32) + threadIdx.x) / G;
  const int j = threadIdx.x & (G - 1);
  // lanes past the last row stay for the shuffles with a slot of nothing
  int p = -1, w = 0, own = k;
  if (row < rows) {
    own = parts[row];
    if (j < d) {
      p = nbr_parts[row * d + j];
      w = wgt[wgt_row(row, rows, lane_rows, n, narrow) * d + j];
      if (p < 0 || p > k) {
        p = -1;
        w = 0;
      }
    }
  }
  const int own_c = min(max(own, 0), k);
  const bool cand = p >= 0 && p < k && p != own;
  int self_c, best_c, best_p;
  if constexpr (G == 32) {
    // one row per warp: match.any finds the lanes that carry this lane's
    // part, and warp reductions replace the D-step shuffle loop
    const unsigned full = 0xffffffffu;
    const int conn = __reduce_add_sync(__match_any_sync(full, p), w);
    self_c = __reduce_add_sync(full, p == own_c ? w : 0);
    best_c = __reduce_max_sync(full, cand ? max(conn, 0) : 0);
    best_p = __reduce_min_sync(full, cand && conn == best_c ? p : k);
  } else {
    int conn = 0;
    self_c = 0;
    for (int i = 0; i < d; ++i) {
      const int pi = __shfl_sync(0xffffffffu, p, i, G);
      const int wi = __shfl_sync(0xffffffffu, w, i, G);
      conn += pi == p ? wi : 0;
      self_c += pi == own_c ? wi : 0;
    }
    best_c = 0;
    best_p = k;
    if (cand && better(conn, p, best_c, best_p)) {
      best_c = conn;
      best_p = p;
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const int oc = __shfl_xor_sync(0xffffffffu, best_c, off, G);
      const int op = __shfl_xor_sync(0xffffffffu, best_p, off, G);
      if (better(oc, op, best_c, best_p)) {
        best_c = oc;
        best_p = op;
      }
    }
  }
  if (row < rows && j == 0) {
    conn_self[row] = self_c;
    best_part[row] = best_c > 0 ? best_p : k;
    best_conn[row] = best_c;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
jet_gain_hist(const int* __restrict__ nbr_parts, const int* __restrict__ wgt,
              const int* __restrict__ parts, int* __restrict__ conn_self,
              int* __restrict__ best_part, int* __restrict__ best_conn,
              long long rows, long long lane_rows, long long n, int d, int k,
              int bins, bool narrow) {
  extern __shared__ int hist_all[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // the whole warp leaves together
  int* hist = hist_all + warp * bins;
  const int* pr = nbr_parts + row * d;
  const int* wr = wgt + wgt_row(row, rows, lane_rows, n, narrow) * d;
  const int own = parts[row];
  const int own_c = min(max(own, 0), k);

  int self_c = 0, best_c = 0, best_p = k;
  for (int c0 = 0; c0 <= k; c0 += bins) {
    const int width = min(bins, k + 1 - c0);
    for (int b = lane; b < width; b += 32) hist[b] = 0;
    __syncwarp();
    for (int j = lane; j < d; j += 32) {
      const int b = pr[j] - c0;
      if (b >= 0 && b < width) atomicAdd(&hist[b], wr[j]);
    }
    __syncwarp();
    for (int b = lane; b < width; b += 32) {
      const int p = c0 + b;
      const int c = hist[b];
      if (p == own_c) self_c = c;
      if (p != own && p != k && better(c, p, best_c, best_p)) {
        best_c = c;
        best_p = p;
      }
    }
    __syncwarp();
  }
  // one lane holds conn_self (the others hold 0); the best pair reduces by
  // (conn descending, part ascending)
  for (int off = 16; off > 0; off >>= 1) {
    self_c += __shfl_xor_sync(0xffffffffu, self_c, off);
    const int oc = __shfl_xor_sync(0xffffffffu, best_c, off);
    const int op = __shfl_xor_sync(0xffffffffu, best_p, off);
    if (better(oc, op, best_c, best_p)) {
      best_c = oc;
      best_p = op;
    }
  }
  if (lane == 0) {
    conn_self[row] = self_c;
    best_part[row] = best_c > 0 ? best_p : k;
    best_conn[row] = best_c;
  }
}

template <int G>
void launch_rows(const int* nbr_parts, const int* wgt, const int* parts,
                 int* conn_self, int* best_part, int* best_conn,
                 long long rows, long long lane_rows, long long n, int d,
                 int k, bool narrow, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kWarps * 32 / G;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  jet_gain_rows<G><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      nbr_parts, wgt, parts, conn_self, best_part, best_conn, rows,
      lane_rows, n, d, k, narrow);
}

}  // namespace

// rows = B*T*N panel rows, lane_rows = T*N of them per lane (rows when
// there is no lane axis), n = N (rows of a lane's wgt); returns the launch's
// CUDA error.
extern "C" int jet_gain_launch(const int* nbr_parts, const int* wgt,
                               const int* parts, int* conn_self,
                               int* best_part, int* best_conn, long long rows,
                               long long lane_rows, long long n, int d, int k,
                               void* stream) {
  if (rows == 0 || lane_rows == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = rows <= 0xffffffffLL;
  if (d <= 32) {
    int g = 1;
    while (g < d) g *= 2;
    switch (g) {
      case 1:
        launch_rows<1>(nbr_parts, wgt, parts, conn_self, best_part,
                       best_conn, rows, lane_rows, n, d, k, narrow, s);
        break;
      case 2:
        launch_rows<2>(nbr_parts, wgt, parts, conn_self, best_part,
                       best_conn, rows, lane_rows, n, d, k, narrow, s);
        break;
      case 4:
        launch_rows<4>(nbr_parts, wgt, parts, conn_self, best_part,
                       best_conn, rows, lane_rows, n, d, k, narrow, s);
        break;
      case 8:
        launch_rows<8>(nbr_parts, wgt, parts, conn_self, best_part,
                       best_conn, rows, lane_rows, n, d, k, narrow, s);
        break;
      case 16:
        launch_rows<16>(nbr_parts, wgt, parts, conn_self, best_part,
                        best_conn, rows, lane_rows, n, d, k, narrow, s);
        break;
      default:
        launch_rows<32>(nbr_parts, wgt, parts, conn_self, best_part,
                        best_conn, rows, lane_rows, n, d, k, narrow, s);
        break;
    }
    return (int)cudaGetLastError();
  }
  const int bins = k + 1 < kBinsMax ? k + 1 : kBinsMax;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  const size_t smem = sizeof(int) * kWarps * bins;
  jet_gain_hist<<<(unsigned)blocks, kWarps * 32, smem, s>>>(
      nbr_parts, wgt, parts, conn_self, best_part, best_conn, rows, lane_rows,
      n, d, k, bins, narrow);
  return (int)cudaGetLastError();
}
