// segment_reduce: the sorted-segment sum on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce/segment_reduce.py:
// _kernel (pallas_call in segment_sum_sorted_pallas).  For ids seg (M,)
// that do not decrease and rows data (M, F):
//   out[s, :] = sum of data[r, :] over the rows r with seg[r] == s,
// for s in [0, S).  Rows whose id lies outside [0, S) are dropped, and an
// empty segment is 0.  int32 sums wrap (two's complement), as XLA's do.
//
// The TPU kernel builds a one-hot matrix per block for the MXU and then
// scatter-adds the per-block partials.  The card has no reason for a matrix
// unit here: this is a segmented reduce-by-key in two passes.
//
// Pass 1, one block per tile of kTile consecutive rows.  Each thread holds
// kItems consecutive rows and flags the rows that start a run (the id
// differs from the previous row's, or the row is the tile's first).  A
// block-wide segmented inclusive scan (cub::BlockScan with a segmented sum
// operator) leaves each run's sum over the tile on the run's last row.  A
// run that starts and ends inside the tile is complete, and its last row
// stores it with a plain store.  A run that crosses either end of the tile
// writes its partial sum to a per-tile boundary array instead: head[t] for
// a first run that began in an earlier tile, tail[t] for a last run that
// goes on into the next tile.
//
// Pass 2, one thread per tile.  The thread of the tile in which a crossing
// run starts walks forward over the following tiles while the run goes
// on, adds their head partials in tile order, and stores the total.  So a
// run may span any number of tiles.  Nothing is added with atomics: the
// order of every float32 sum is fixed by the tiling, and the result is
// bitwise the same from run to run (it differs from a sequential sum's).
//
// Bound: memory.  The function reads M ids and M*F values (8 bytes per row
// at F = 1 with int32 values) and writes S*F values; it does one add per
// value.  This version also zeroes the output first (S*F*4 more bytes
// written) and reads each column's ids again from cache when F > 1.
#include <climits>

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

// int32 sums wrap as XLA's do: add as unsigned, never a signed overflow
__device__ __forceinline__ int add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }

template <typename T>
struct Run {
  int head;  // a run starts inside the span summed so far
  T val;     // sum since the last run start
};

template <typename T>
struct SegmentedSum {
  __device__ __forceinline__ Run<T> operator()(const Run<T>& a,
                                               const Run<T>& b) const {
    Run<T> r;
    r.head = a.head | b.head;
    r.val = b.head ? b.val : add(a.val, b.val);
    return r;
  }
};

__device__ __forceinline__ bool kept(int s, int num_segments) {
  return s >= 0 && s < num_segments;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_pass(const T* __restrict__ data, const int* __restrict__ seg,
          T* __restrict__ out, T* __restrict__ head_part,
          T* __restrict__ tail_part, long long m, int f_dim,
          int num_segments) {
  using Scan = cub::BlockScan<Run<T>, kThreads>;
  __shared__ typename Scan::TempStorage temp;
  const long long tile = blockIdx.x;
  const long long t0 = tile * kTile;
  const long long t1 = min(t0 + kTile, m);
  const int first_id = seg[t0];
  const int last_id = seg[t1 - 1];
  const bool first_crosses = t0 > 0 && seg[t0 - 1] == first_id;
  const bool last_crosses = t1 < m && seg[t1] == last_id;

  const long long base = t0 + (long long)threadIdx.x * kItems;
  int id[kItems];
  bool head[kItems], tail[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long r = base + i;
    const bool ok = r < t1;
    id[i] = ok ? seg[r] : INT_MAX;
    head[i] = !ok || r == t0 || seg[r - 1] != id[i];
    tail[i] = ok && (r == t1 - 1 || seg[r + 1] != id[i]);
  }
  for (int f = 0; f < f_dim; ++f) {
    Run<T> run[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long r = base + i;
      run[i].head = head[i];
      run[i].val = r < t1 ? data[r * f_dim + f] : T(0);
    }
    Scan(temp).InclusiveScan(run, run, SegmentedSum<T>());
    __syncthreads();  // temp is reused by the next column
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (!tail[i]) continue;
      const bool is_first = id[i] == first_id;
      const bool is_last = base + i == t1 - 1;
      if (is_first && first_crosses) {
        head_part[tile * f_dim + f] = run[i].val;
      }
      if (is_last && last_crosses) {
        tail_part[tile * f_dim + f] = run[i].val;
      }
      const bool crosses =
          (is_first && first_crosses) || (is_last && last_crosses);
      if (!crosses && kept(id[i], num_segments)) {
        out[(long long)id[i] * f_dim + f] = run[i].val;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
carry_pass(const int* __restrict__ seg, T* __restrict__ out,
           const T* __restrict__ head_part, const T* __restrict__ tail_part,
           long long m, long long tiles, int f_dim, int num_segments) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= tiles) return;
  const long long t0 = t * kTile;
  const long long t1 = min(t0 + kTile, m);
  const int s = seg[t1 - 1];
  if (t1 >= m || seg[t1] != s) return;  // the tile's last run ends in it
  if (t0 > 0 && seg[t0 - 1] == s) return;  // ... or began before it
  if (!kept(s, num_segments)) return;
  for (int f = 0; f < f_dim; ++f) {
    T acc = tail_part[t * f_dim + f];
    for (long long u = t + 1;; ++u) {
      acc = add(acc, head_part[u * f_dim + f]);
      const long long u1 = min((u + 1) * kTile, m);
      if (u1 >= m || seg[u1] != s) break;
    }
    out[(long long)s * f_dim + f] = acc;
  }
}

template <typename T>
int launch(const T* data, const int* seg, T* out, T* head_part, T* tail_part,
           long long m, int f_dim, int num_segments, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(T) * (size_t)num_segments * (size_t)f_dim, stream);
  if (err != cudaSuccess || m == 0 || f_dim == 0) return (int)err;
  const long long tiles = (m + kTile - 1) / kTile;
  tile_pass<T><<<(unsigned)tiles, kThreads, 0, stream>>>(
      data, seg, out, head_part, tail_part, m, f_dim, num_segments);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((tiles + kThreads - 1) / kThreads);
  carry_pass<T><<<blocks, kThreads, 0, stream>>>(
      seg, out, head_part, tail_part, m, tiles, f_dim, num_segments);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows per tile: the wrapper sizes the (tiles, F) boundary arrays with it.
extern "C" int segment_sum_tile_rows() { return kTile; }

// data (M, F) and out (S, F) are int32 (is_float = 0) or float32; head and
// tail are (ceil(M / tile rows), F) scratch of the same type.  Returns the
// CUDA error of the launches.
extern "C" int segment_sum_launch(const void* data, const int* seg, void* out,
                                  void* head_part, void* tail_part,
                                  long long m, int f_dim, int num_segments,
                                  int is_float, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_float) {
    return launch<float>((const float*)data, seg, (float*)out,
                         (float*)head_part, (float*)tail_part, m, f_dim,
                         num_segments, st);
  }
  return launch<int>((const int*)data, seg, (int*)out, (int*)head_part,
                     (int*)tail_part, m, f_dim, num_segments, st);
}
