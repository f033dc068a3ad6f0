// jet_gain: the Jetlp connectivity query (paper Alg 4.2 lines 3-7) on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/jet_gain/jet_gain.py:_kernel
// (pallas_call in jet_gain_pallas).  For each row of an ELL panel (one
// vertex of one trial), with ghost slots carrying part k and weight 0:
//   conn_self = connectivity to the row's own part,
//   best_part = the other part (not k) of largest positive connectivity,
//               smallest id on ties, k when there is none,
//   best_conn = its connectivity, at least 0.
// Row r = t*N + v reads nbr_parts row r and wgt row v: the weights are
// shared by all T trials and never copied.
//
// The TPU kernel sweeps all k parts per row, O(k*D), because it cannot
// gather.  Here one warp owns one row: it scatters the row's D slots into
// a per-warp histogram in shared memory with integer atomicAdd (so the sums
// do not depend on the order of the adds), then reduces the histogram
// across the warp by (conn descending, part ascending).  When k+1 exceeds
// the per-warp budget of BINS_MAX bins, the warp loops over chunks of parts
// and re-reads the row; no k and no D is refused.
//
// Bound: memory.  Per trial it must read N*D*8 + N*4 bytes (parts and
// weights of the panel, own parts) and write N*12 (three int32 outputs);
// the arithmetic is a handful of integer operations per slot.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;        // warps (rows) per block
constexpr int kBinsMax = 1024;   // shared-memory histogram bins per warp

__device__ __forceinline__ bool better(int c, int p, int best_c, int best_p) {
  return c > best_c || (c == best_c && p < best_p);
}

__global__ void __launch_bounds__(kWarps * 32)
jet_gain_kernel(const int* __restrict__ nbr_parts, const int* __restrict__ wgt,
                const int* __restrict__ parts, int* __restrict__ conn_self,
                int* __restrict__ best_part, int* __restrict__ best_conn,
                long long rows, long long n, int d, int k, int bins) {
  extern __shared__ int hist_all[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // the whole warp leaves together
  int* hist = hist_all + warp * bins;
  const int* pr = nbr_parts + row * d;
  const int* wr = wgt + (row % n) * d;
  const int own = parts[row];

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
      if (p == own) {
        self_c = c;
      } else if (p != k && better(c, p, best_c, best_p)) {
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

}  // namespace

// rows = T*N panel rows, n = N (rows of wgt); returns the launch's CUDA error.
extern "C" int jet_gain_launch(const int* nbr_parts, const int* wgt,
                               const int* parts, int* conn_self,
                               int* best_part, int* best_conn, long long rows,
                               long long n, int d, int k, void* stream) {
  if (rows == 0) return 0;
  const int bins = k + 1 < kBinsMax ? k + 1 : kBinsMax;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  const size_t smem = sizeof(int) * kWarps * bins;
  jet_gain_kernel<<<(unsigned)blocks, kWarps * 32, smem,
                    (cudaStream_t)stream>>>(nbr_parts, wgt, parts, conn_self,
                                            best_part, best_conn, rows, n, d,
                                            k, bins);
  return (int)cudaGetLastError();
}
