// segment_reduce: the sorted-segment sum on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce/segment_reduce.py:
// _kernel (pallas_call in segment_sum_sorted_pallas).  For ids seg (M,)
// that do not decrease and rows data (M, F):
//   out[s, :] = sum of data[r, :] over the rows r with seg[r] == s,
// for s in [0, S).  Rows whose id lies outside [0, S) are dropped, and an
// empty segment is 0.  int32 sums wrap (two's complement), as XLA's do.
//
// The TPU kernel builds a one-hot matrix per block for the MXU.  Here the
// function is a memory-bound reduce-by-key, so the design is about moving
// each byte once: every id and value is read once with 16-byte loads, and
// every output is written exactly once, empty segments included, with no
// zeroing pass.
//
// Work is cut along the merge path of the rows and the outputs (Merrill &
// Garland, "Merge-based Parallel Sparse Matrix-Vector Multiplication",
// 2016).  Output s comes right after the last row with id <= s, so the
// merged sequence is: rows of id 0, out 0, rows of id 1, out 1, ...  (rows
// with ids < 0 come first, rows with ids >= S last).  Each block takes the
// same number of merged items, so a block's work is bounded whether its
// part of the sequence is one long run (the sorted backend's ghost vertex:
// millions of rows with one id) or one long gap (the run-weight sum: the
// millions of run ids past a trial's last run, all empty).
//
//   splits  one thread per tile boundary finds the rows among the first d
//           merged items: a 4-ary search over seg (three independent loads
//           a step) down one fixed tree, so that the searches of nearby
//           boundaries share their first steps' loads in the L2 cache.
//   tiles   one block per tile.  F = 1: each thread reads up to 16
//           consecutive rows with 16-byte loads of ids and values and sums
//           them in order; a segmented scan over the warp (shuffles) and
//           the block (the warps' totals) gives each thread the run in
//           progress where it starts.  F > 1: a warp per row group, lanes
//           on columns.  Every output of the tile but its first is written
//           in order from shared memory, zeros for empty ones (a tile with
//           no rows writes zeros and nothing else).  The tile's first
//           output (its "lead" partial) and the rows after its last output
//           (its "trail" partial: rows of the id of the next tile's first
//           output) go to per-tile arrays.
//   carry   a segmented scan, in tile order, of the pairs (tile has an
//           output, trail partial) gives each tile the partial of the run
//           that crosses into it; it adds the tile's lead and writes the
//           tile's first output.  Each thread scans a fixed slice of tiles,
//           then the slices are joined by a scan over the block, so no
//           thread's work grows with the number of tiles a run crosses.
//
// A decoupled look-back would fuse the carry into the tiles, but its float
// sums would then depend on which predecessor had published first; with a
// fixed scan every float32 sum runs in an order fixed by the shapes and the
// ids, so the result is bitwise the same from launch to launch (it differs
// from a sequential sum's).  A problem that fits one tile runs the tile
// kernel alone.
//
// Bound: memory.  The function reads M ids and M*F values and writes S*F
// values, one add per value.  The searches read about 40 ids per tile, and
// the per-tile partials are 8*F + 4 bytes a tile.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                 // tile block
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                       // rows per 16-byte load
constexpr int kRows = 16;                     // rows a thread holds at most
// merged items (rows + outputs) per tile at F = 1.  The rows, started at a
// multiple of 4 (up to 3 rows early), fit the block's 4096 row slots.
constexpr int kItems = kThreads * kRows - kVec;
constexpr int kWideElems = 65536;   // values per tile at F > 1
constexpr int kWideItems = 4092;    // items per tile at F > 1, at most
constexpr int kSearchThreads = 64;
constexpr int kCarryWarps = 16;
constexpr int kCarryLoads = 16;     // F > 1: tiles a carry warp loads at once
constexpr int kCarryWindow = 3584;  // F = 1: tiles a carry window holds
constexpr int kCarryCopies = 16;    // F = 1: blocks that share its stores

// int32 sums wrap as XLA's do: add as unsigned, never a signed overflow
__device__ __forceinline__ int add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }

// a segmented sum: head says a run starts inside the span, val is the sum
// since the span's last run start
template <typename T>
struct Run {
  int head;
  T val;
};

template <typename T>
__device__ __forceinline__ Run<T> combine(Run<T> a, Run<T> b) {
  return {a.head | b.head, b.head ? b.val : add(a.val, b.val)};
}

template <typename T>
__device__ __forceinline__ Run<T> shfl_up(Run<T> a, int delta) {
  return {__shfl_up_sync(0xffffffffu, a.head, delta),
          __shfl_up_sync(0xffffffffu, a.val, delta)};
}

__host__ __device__ __forceinline__ int tile_items(int f_dim) {
  if (f_dim <= 1) return kItems;  // F = 0 launches nothing
  const int items = kWideElems / f_dim;
  return items < 32 ? 32 : (items > kWideItems ? kWideItems : items);
}

// position of row r in the merged sequence: r + the outputs before it
__device__ __forceinline__ long long merge_pos(const int* __restrict__ seg,
                                               long long r, int num_segments) {
  const int s = seg[r];
  return r + (s < 0 ? 0 : (s > num_segments ? num_segments : s));
}

// rows among the first d merged items: the first r with merge_pos >= d.
// The search runs down one 4-ary tree over [0, m] whatever d is, so that
// the first steps of nearby boundaries probe the same rows.
__device__ long long rows_before(const int* __restrict__ seg, long long m,
                                 int num_segments, long long d) {
  long long lo = 0, hi = m;  // the answer lies in [lo, hi]
  while (hi - lo >= 4) {     // three independent loads a step
    const long long q = (hi - lo) / 4;
    const bool b1 = merge_pos(seg, lo + q, num_segments) >= d;
    const bool b2 = merge_pos(seg, lo + 2 * q, num_segments) >= d;
    const bool b3 = merge_pos(seg, lo + 3 * q, num_segments) >= d;
    const int c = b1 ? 0 : (b2 ? 1 : (b3 ? 2 : 3));  // probes before d
    hi = c < 3 ? lo + (c + 1) * q : hi;
    lo = c > 0 ? lo + c * q + 1 : lo;
  }
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (merge_pos(seg, mid, num_segments) >= d) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// first row of tile b (b in [0, tiles]); boundaries 0 and tiles are fixed
__device__ __forceinline__ long long row_split(const int* __restrict__ splits,
                                               long long b, long long tiles,
                                               long long m) {
  return b <= 0 ? 0 : (b >= tiles ? m : (long long)splits[b]);
}

__global__ void __launch_bounds__(kSearchThreads)
splits_pass(const int* __restrict__ seg, int* __restrict__ splits,
            long long m, int num_segments, long long tiles, int items) {
  const long long b = (long long)blockIdx.x * kSearchThreads + threadIdx.x + 1;
  if (b >= tiles) return;
  splits[b] = (int)rows_before(seg, m, num_segments, b * items);
}

// A tile: merged items [d0, d1), rows [i0, i1), outputs [j0, j1).  Where a
// run's sum goes: the tile's trail, its first output (the lead, unless the
// tile is the first), another output of the tile, or nowhere (dropped).
struct Tile {
  long long i0, i1;
  int j0, j1, num_segments;
  __device__ Tile(const int* splits, long long b, long long tiles,
                  long long m, int num_segments_, int items)
      : num_segments(num_segments_) {
    const long long d0 = b * items;
    const long long d1 = min(d0 + items, m + num_segments);
    i0 = row_split(splits, b, tiles, m);
    i1 = row_split(splits, b + 1, tiles, m);
    j0 = (int)(d0 - i0);
    j1 = (int)(d1 - i1);
  }
  __device__ __forceinline__ int slot(int s) const {  // -1 drop, -2 trail
    if (s == j1 && j1 < num_segments) return -2;
    return (s >= j0 && s < j1) ? s - j0 : -1;
  }
};

__device__ __forceinline__ void unpack(int4 w, int v[kVec]) {
  v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
}
__device__ __forceinline__ void unpack(int4 w, float v[kVec]) {
  v[0] = __int_as_float(w.x), v[1] = __int_as_float(w.y);
  v[2] = __int_as_float(w.z), v[3] = __int_as_float(w.w);
}

__device__ __forceinline__ unsigned low_bits(int n) {  // n in [0, 32]
  return n >= 32 ? ~0u : (1u << n) - 1;
}

__device__ __forceinline__ int bits(int x) { return x; }
__device__ __forceinline__ int bits(float x) { return __float_as_int(x); }

// rows r .. r+3: one 16-byte load of ids and one of values where the inputs
// are aligned and the rows lie below m, else scalar loads; rows wholly
// outside the tile's [lo, hi) are not read
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ data,
                                      const int* __restrict__ seg, long long r,
                                      long long lo, long long hi, long long m,
                                      bool vec, int id[kVec], T v[kVec]) {
  if (r + kVec <= lo || r >= hi) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) id[e] = INT_MAX, v[e] = T(0);
  } else if (vec && r + kVec <= m) {
    const int4 s4 = *reinterpret_cast<const int4*>(seg + r);
    id[0] = s4.x, id[1] = s4.y, id[2] = s4.z, id[3] = s4.w;
    unpack(*reinterpret_cast<const int4*>(data + r), v);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const bool ok = r + e < m;
      id[e] = ok ? seg[r + e] : INT_MAX;
      v[e] = ok ? data[r + e] : T(0);
    }
  }
}

// F = 1, one block per tile.  Thread t sums the q rows a0 + t q .. (a0 =
// i0 rounded down to a multiple of 4; q the multiple of 4 that spreads the
// tile's rows over the block, at most 16), read as q/4 16-byte loads of
// ids and of values, in order.  A row starts a run where its id differs
// from the row before's (a neighbour in registers, the lane before's last
// row by a shuffle, the warp before's by shared memory) and ends one where
// the next row starts one, or at the tile's ends.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
tiles_pass(const T* __restrict__ data, const int* __restrict__ seg,
           T* __restrict__ out, const int* __restrict__ splits,
           int* __restrict__ first, T* __restrict__ lead,
           T* __restrict__ trail, long long m, int num_segments,
           long long tiles, bool vec) {
  __shared__ __align__(16) T outv[kItems];
  __shared__ int warp_first[kWarps], warp_last[kWarps];
  __shared__ Run<T> warp_agg[kWarps];
  __shared__ T trail_v;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const Tile tile(splits, b, tiles, m, num_segments, kItems);
  const int no = tile.j1 - tile.j0, nr = (int)(tile.i1 - tile.i0);
  const long long a0 = tile.i0 & ~(long long)(kVec - 1);
  const int span = (int)(tile.i1 - a0);
  const int q = max(kVec, ((span + kThreads - 1) / kThreads + kVec - 1) &
                              ~(kVec - 1));
  const int rel0 = (int)(a0 - tile.i0) + tid * q;  // first row - i0

  // the tile's outputs in order, 16 bytes a store where aligned, value(e)
  // for output j0 + e; the first one waits for the carry unless this is
  // the first tile
  auto emit = [&](auto value) {
    const long long gs = tile.j0 + (b > 0), ge = tile.j1;
    long long ga = gs, gb = gs;  // the 16-byte stores cover [ga, gb)
    if (vec) {
      ga = min((gs + kVec - 1) & ~(long long)(kVec - 1), ge);
      gb = max(ga, ge & ~(long long)(kVec - 1));
    }
    for (long long g = gs + tid; g < ga; g += kThreads) {
      out[g] = value(g - tile.j0);
    }
    for (long long g = gb + tid; g < ge; g += kThreads) {
      out[g] = value(g - tile.j0);
    }
    for (long long g = ga + kVec * tid; g < gb; g += kVec * kThreads) {
      const int e = (int)(g - tile.j0);
      *reinterpret_cast<int4*>(out + g) =
          make_int4(bits(value(e)), bits(value(e + 1)), bits(value(e + 2)),
                    bits(value(e + 3)));
    }
  };
  if (nr == 0) {  // outputs only: all empty
    emit([](int) { return T(0); });
    if (tid == 0) {
      first[b] = no > 0 ? tile.j0 : -1;
      lead[b] = trail[b] = T(0);
    }
    return;
  }

  int id[kRows];
  T v[kRows];
#pragma unroll
  for (int k4 = 0; k4 < kRows / kVec; ++k4) {
    if (k4 * kVec < q) {
      load4(data, seg, a0 + tid * q + k4 * kVec, tile.i0, tile.i1, m, vec,
            id + k4 * kVec, v + k4 * kVec);
    }
  }
  int last = id[kVec - 1];
#pragma unroll
  for (int k4 = 1; k4 < kRows / kVec; ++k4) {
    if ((k4 + 1) * kVec == q) last = id[(k4 + 1) * kVec - 1];
  }
  if (lane == 0) warp_first[warp] = id[0];
  if (lane == 31) warp_last[warp] = last;
  int before = __shfl_up_sync(0xffffffffu, last, 1);
  int after = __shfl_down_sync(0xffffffffu, id[0], 1);
  for (int e = tid; e < no; e += kThreads) outv[e] = T(0);
  if (tid == 0) trail_v = T(0);
  __syncthreads();

  unsigned heads = 0;
  if (lane == 0) before = warp > 0 ? warp_last[warp - 1] : 0;
  if (lane == 31) after = warp + 1 < kWarps ? warp_first[warp + 1] : 0;
  // a row starts a run where its id differs from the row before's; the
  // thread's rows of the tile are [lo, hi), and the tile's first and last
  // rows start and end runs
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
    if (e >= q) break;
    heads |= (unsigned)(id[e] != (e > 0 ? id[e > 0 ? e - 1 : 0] : before))
             << e;
  }
  unsigned tails = (heads >> 1) | (unsigned)(after != last) << (q - 1);
  const int lo = max(0, -rel0), hi = min(q, nr - rel0);
  const unsigned valid = hi > lo ? low_bits(hi) & ~low_bits(lo) : 0u;
  if (lo < hi && lo == -rel0) heads |= 1u << lo;
  if (lo < hi && hi == nr - rel0) tails |= 1u << (hi - 1);
  heads &= valid;
  tails &= valid;
  // v[e] becomes the sum since the last run start at or before e; rows
  // outside the tile add nothing
  T acc = T(0);
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
    if (e >= q) break;
    const T x = (valid >> e) & 1 ? v[e] : T(0);
    acc = ((heads >> e) & 1) ? x : add(acc, x);
    v[e] = acc;
  }
  // segmented scan of the threads' sums over the warp, then the block
  Run<T> incl{heads != 0, acc};
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Run<T> up = shfl_up(incl, off);
    if (lane >= off) incl = combine(up, incl);
  }
  const Run<T> excl = shfl_up(incl, 1);
  if (lane == 31) warp_agg[warp] = incl;
  __syncthreads();
  if (tails != 0) {
    Run<T> pre{0, T(0)};  // the run in progress where this thread starts
    for (int w = 0; w < warp; ++w) pre = combine(pre, warp_agg[w]);
    if (lane > 0) pre = combine(pre, excl);
    // rows before the thread's first run start continue that run
    const unsigned open = heads ? (heads & (0u - heads)) - 1 : ~0u;
#pragma unroll
    for (int e = 0; e < kRows; ++e) {
      if (e >= q) break;
      if (!((tails >> e) & 1)) continue;
      const T x = ((open >> e) & 1) ? add(pre.val, v[e]) : v[e];
      const int slot = tile.slot(id[e]);
      if (slot == -2) {
        trail_v = x;
      } else if (slot >= 0) {
        outv[slot] = x;
      }
    }
  }
  __syncthreads();
  emit([&](int e) { return outv[e]; });
  if (tid == 0) {
    first[b] = no > 0 ? tile.j0 : -1;
    lead[b] = no > 0 ? outv[0] : T(0);
    trail[b] = trail_v;
  }
}

// V consecutive columns of a row: one 16-byte access where V = 4
template <typename T, int V>
struct Cols {
  T x[V];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V == 4) {
      unpack(*reinterpret_cast<const int4*>(p), x);
    } else {
      x[0] = *p;
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (V == 4) {
      *reinterpret_cast<int4*>(p) =
          make_int4(bits(x[0]), bits(x[1]), bits(x[2]), bits(x[3]));
    } else {
      *p = x[0];
    }
  }
  __device__ __forceinline__ Cols plus(const Cols& o) const {  // this + o
    Cols r;
#pragma unroll
    for (int u = 0; u < V; ++u) r.x[u] = add(x[u], o.x[u]);
    return r;
  }
};

// F > 1.  Warp w sums the rows [nr*w/8, nr*(w+1)/8) of the tile in order,
// lane l on V columns from c0 + V l (V = 4, one 16-byte load, where F is a
// multiple of 4 and the data aligned); runs that cross a warp's boundary
// are finished, after a barrier, by the warp where they end from the
// warps' last-run partials.  The ids, the run starts and ends and which
// outputs have rows are found once per tile.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
tiles_pass_wide(const T* __restrict__ data, const int* __restrict__ seg,
                T* __restrict__ out, const int* __restrict__ splits,
                int* __restrict__ first, T* __restrict__ lead,
                T* __restrict__ trail, long long m, int f_dim,
                int num_segments, long long tiles, int items) {
  __shared__ int sid[kWideItems];
  __shared__ unsigned char flags[kWideItems];        // bit 0 head, bit 1 tail
  __shared__ unsigned char present[kWideItems + 1];  // output j0 + o has rows
  __shared__ Cols<T, V> gout[kWarps][32];
  __shared__ int gstate[kWarps];  // bit 0 has rows, bit 1 its last run
                                  // began inside it

  const long long b = blockIdx.x;
  const Tile tile(splits, b, tiles, m, num_segments, items);
  const int no = tile.j1 - tile.j0, nr = (int)(tile.i1 - tile.i0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long f = f_dim;

  for (int e = tid; e <= no; e += kThreads) present[e] = 0;
  for (int r = tid; r < nr; r += kThreads) sid[r] = seg[tile.i0 + r];
  __syncthreads();
  for (int r = tid; r < nr; r += kThreads) {
    const int s = sid[r];
    const bool h = r == 0 || sid[r - 1] != s;
    const bool t = r == nr - 1 || sid[r + 1] != s;
    flags[r] = (unsigned char)(h | (t << 1));
    if (s >= tile.j0 && s <= tile.j1) present[s - tile.j0] = 1;
  }
  __syncthreads();

  // empty outputs, and the lead and trail of a tile without such rows
  for (long long e = tid; e < (long long)no * f; e += kThreads) {
    const int o = (int)(e / f);
    const long long c = e - o * f;
    if (present[o]) continue;
    if (o > 0 || b == 0) {
      out[(tile.j0 + o) * f + c] = T(0);
    } else {
      lead[b * f + c] = T(0);
    }
  }
  if (!(tile.j1 < num_segments && present[no])) {
    for (int c = tid; c < f_dim; c += kThreads) trail[b * f + c] = T(0);
  }
  if (no == 0 && b > 0) {
    for (int c = tid; c < f_dim; c += kThreads) lead[b * f + c] = T(0);
  }
  if (tid == 0) first[b] = no > 0 ? tile.j0 : -1;

  auto store = [&](int s, Cols<T, V> x, long long c) {
    const int slot = tile.slot(s);
    T* dst = slot == -2 ? trail + b * f
             : slot == 0 && b > 0 ? lead + b * f
             : slot >= 0 ? out + (long long)s * f : nullptr;
    if (dst != nullptr) x.store(dst + c);
  };

  const int rb = (int)((long long)nr * warp / kWarps);
  const int re = (int)((long long)nr * (warp + 1) / kWarps);
  for (int c0 = 0; c0 < f_dim; c0 += 32 * V) {
    const long long c = c0 + V * lane;
    const bool active = c < f;
    Cols<T, V> acc{}, in_val{};
    bool started = false, closed_in = false;
    int in_id = 0;
#pragma unroll 4
    for (int r = rb; r < re; ++r) {
      const unsigned char fl = flags[r];
      Cols<T, V> x{};
      if (active) x.load(data + (tile.i0 + r) * f + c);
      acc = (fl & 1) ? x : acc.plus(x);
      started |= fl & 1;
      if (fl & 2) {
        if (started) {
          if (active) store(sid[r], acc, c);
        } else {  // the run came in from an earlier warp and ends here
          closed_in = true;
          in_id = sid[r];
          in_val = acc;
        }
      }
    }
    gout[warp][lane] = acc;
    if (lane == 0) gstate[warp] = (re > rb) | (started << 1);
    __syncthreads();
    if (closed_in && active) {
      for (int w = warp - 1; w >= 0; --w) {
        const int st = gstate[w];
        if (!(st & 1)) continue;
        in_val = gout[w][lane].plus(in_val);
        if (st & 2) break;
      }
      store(in_id, in_val, c);
    }
    __syncthreads();  // gout and gstate are reused by the next columns
  }
}

// Tile b's pair is (b has an output, b's trail); the segmented scan of the
// pairs before b is the partial of the run that crosses into b, which b's
// first output adds to its lead.
//
// F = 1: the tiles go through shared memory in windows of kCarryWindow
// (coalesced loads; padded so that threads reading consecutive slices hit
// distinct banks).  Thread i sums its slice of the window in order, a
// segmented scan over the warp (shuffles) and the warps' totals give it
// the run in progress where its slice starts, and a second walk over the
// slice writes the outputs.  The first outputs are single 4-byte stores
// scattered over the output, slow to drain from one SM, so kCarryCopies
// blocks each run the whole scan and write every kCarryCopies-th tile's
// output.  F > 1: warp w takes the w-th of kCarryWarps
// slices of the tiles, kCarryLoads tiles at a time, lanes on 32 columns
// (block x: columns 32x ..), and the warps' totals join the slices.
template <typename T>
__global__ void __launch_bounds__(kCarryWarps * 32)
carry_pass(const int* __restrict__ first, const T* __restrict__ lead,
           const T* __restrict__ trail, T* __restrict__ out, int f_dim,
           long long tiles) {
  __shared__ Run<T> wtot[kCarryWarps][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (f_dim == 1) {
    constexpr int kPadded = kCarryWindow + kCarryWindow / 32;
    __shared__ int sj[kPadded];
    __shared__ T sx[kPadded], sl[kPadded];
    auto pad = [](int t) { return t + (t >> 5); };
    Run<T> window{0, T(0)};  // the run in progress where the window starts
    for (long long ws = 0; ws < tiles; ws += kCarryWindow) {
      const int wn = (int)min((long long)kCarryWindow, tiles - ws);
      for (int t = tid; t < wn; t += kCarryWarps * 32) {
        sj[pad(t)] = first[ws + t];
        sx[pad(t)] = trail[ws + t];
        sl[pad(t)] = lead[ws + t];
      }
      __syncthreads();
      const int per = (wn + kCarryWarps * 32 - 1) / (kCarryWarps * 32);
      const int t0 = min(tid * per, wn), t1 = min(t0 + per, wn);
      Run<T> mine{0, T(0)};
      for (int t = t0; t < t1; ++t) {
        mine = combine(mine, Run<T>{sj[pad(t)] >= 0, sx[pad(t)]});
      }
      Run<T> incl = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const Run<T> up = shfl_up(incl, off);
        if (lane >= off) incl = combine(up, incl);
      }
      const Run<T> excl = shfl_up(incl, 1);
      if (lane == 31) wtot[warp][0] = incl;
      __syncthreads();
      Run<T> pre = window;
      for (int w = 0; w < warp; ++w) pre = combine(pre, wtot[w][0]);
      if (lane > 0) pre = combine(pre, excl);
      for (int t = t0; t < t1; ++t) {
        const int j = sj[pad(t)];
        if (j >= 0 && ws + t > 0 && (ws + t) % gridDim.x == blockIdx.x) {
          out[j] = add(pre.val, sl[pad(t)]);
        }
        pre = combine(pre, Run<T>{j >= 0, sx[pad(t)]});
      }
      for (int w = 0; w < kCarryWarps; ++w) {
        window = combine(window, wtot[w][0]);
      }
      __syncthreads();  // the window's buffers and totals are reused
    }
    return;
  }
  const long long per = (tiles + kCarryWarps - 1) / kCarryWarps;
  const long long w0 = min(warp * per, tiles), w1 = min(w0 + per, tiles);
  const long long f = f_dim;
  const long long c = (long long)blockIdx.x * 32 + lane;
  const bool active = c < f;
  Run<T> agg{0, T(0)};
  for (long long g0 = w0; g0 < w1; g0 += kCarryLoads) {
    int j[kCarryLoads];
    T x[kCarryLoads];
#pragma unroll
    for (int i = 0; i < kCarryLoads; ++i) {
      j[i] = g0 + i < w1 ? first[g0 + i] : -1;
      x[i] = g0 + i < w1 && active ? trail[(g0 + i) * f + c] : T(0);
    }
#pragma unroll
    for (int i = 0; i < kCarryLoads; ++i) {
      agg = combine(agg, Run<T>{j[i] >= 0, x[i]});
    }
  }
  wtot[warp][lane] = agg;
  __syncthreads();
  Run<T> carry{0, T(0)};
  for (int w = 0; w < warp; ++w) carry = combine(carry, wtot[w][lane]);
  if (!active) return;
  for (long long g0 = w0; g0 < w1; g0 += kCarryLoads) {
    int j[kCarryLoads];
    T x[kCarryLoads], l[kCarryLoads];
#pragma unroll
    for (int i = 0; i < kCarryLoads; ++i) {
      j[i] = g0 + i < w1 ? first[g0 + i] : -1;
      x[i] = g0 + i < w1 ? trail[(g0 + i) * f + c] : T(0);
      l[i] = j[i] >= 0 ? lead[(g0 + i) * f + c] : T(0);
    }
#pragma unroll
    for (int i = 0; i < kCarryLoads; ++i) {
      if (j[i] >= 0 && g0 + i > 0) out[j[i] * f + c] = add(carry.val, l[i]);
      carry = combine(carry, Run<T>{j[i] >= 0, x[i]});
    }
  }
}

long long tile_count(long long m, int f_dim, int num_segments) {
  const int items = tile_items(f_dim);
  return (m + num_segments + items - 1) / items;
}

template <typename T>
int launch(const T* data, const int* seg, T* out, int* splits, int* first,
           T* lead, T* trail, long long m, int f_dim, int num_segments,
           cudaStream_t stream) {
  if (num_segments == 0 || f_dim == 0) return 0;
  const int items = tile_items(f_dim);
  const long long tiles = tile_count(m, f_dim, num_segments);
  if (tiles > 1) {
    const unsigned blocks =
        (unsigned)((tiles - 1 + kSearchThreads - 1) / kSearchThreads);
    splits_pass<<<blocks, kSearchThreads, 0, stream>>>(
        seg, splits, m, num_segments, tiles, items);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (f_dim == 1) {
    tiles_pass<T><<<(unsigned)tiles, kThreads, 0, stream>>>(
        data, seg, out, splits, first, lead, trail, m, num_segments, tiles,
        aligned(data) && aligned(seg) && aligned(out));
  } else if (f_dim % 4 == 0 && aligned(data) && aligned(out) &&
             aligned(lead) && aligned(trail)) {
    tiles_pass_wide<T, 4><<<(unsigned)tiles, kThreads, 0, stream>>>(
        data, seg, out, splits, first, lead, trail, m, f_dim, num_segments,
        tiles, items);
  } else {
    tiles_pass_wide<T, 1><<<(unsigned)tiles, kThreads, 0, stream>>>(
        data, seg, out, splits, first, lead, trail, m, f_dim, num_segments,
        tiles, items);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return (int)err;
  carry_pass<T><<<f_dim == 1 ? kCarryCopies : (unsigned)((f_dim + 31) / 32),
                  kCarryWarps * 32, 0, stream>>>(
      first, lead, trail, out, f_dim, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Tiles of a call: the wrapper sizes the scratch with it: lead and trail
// (tiles, F) of the data's type, then splits (tiles + 1) and first (tiles)
// int32.
extern "C" long long segment_sum_tiles(long long m, int f_dim,
                                       int num_segments) {
  return tile_count(m, f_dim, num_segments);
}

// data (M, F) and out (S, F) are int32 (is_float = 0) or float32; scratch
// as segment_sum_tiles says.  Returns the CUDA error of the launches.
extern "C" int segment_sum_launch(const void* data, const int* seg, void* out,
                                  void* scratch, long long m, int f_dim,
                                  int num_segments, int is_float,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = tile_count(m, f_dim, num_segments);
  int* const lead = (int*)scratch;
  int* const trail = lead + tiles * f_dim;
  int* const splits = trail + tiles * f_dim;
  int* const first = splits + tiles + 1;
  if (is_float) {
    return launch<float>((const float*)data, seg, (float*)out, splits, first,
                         (float*)lead, (float*)trail, m, f_dim, num_segments,
                         st);
  }
  return launch<int>((const int*)data, seg, (int*)out, splits, first, lead,
                     trail, m, f_dim, num_segments, st);
}
