// flash_attention_bwd_tc: the backward pass of flash_attention on the tensor
// cores of Hopper, for bfloat16 and float16 inputs.
//
// Replaces no TPU kernel: the reference has no backward Pallas kernel.  It
// trains through chunked_attention (src/repro/models/attention.py:31), which
// XLA differentiates; the port's forward (flash_attention.cu) replaces the
// Pallas _kernel of src/repro/kernels/flash_attention/flash_attention.py, so
// a gradient on the card needs this kernel.  It computes what
// flash_attention_bwd.cu computes for float32 (see that file for the
// formulas): from q (B, H, Sq, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv),
// the forward's output o and per-row log-sum-exp lse, and o's cotangent do,
//   P = exp(S / sqrt(D) - lse), dS = P (dP - Dl), Dl = rowsum(do * o),
//   dq = dS k / sqrt(D), dk = dS^T q / sqrt(D), dv = P^T do
// (dk, dv summed over each kv head's H / Hkv query heads), with the
// forward's masks; a row whose lse is -inf (it sees no key) has P = 0, so
// its dq is 0.  S is scaled after the product, as flash_kernel_tc does.
//
// Three kernels a call, no atomics, every sum in a fixed order, so a result
// is bitwise the same from launch to launch:
//   delta_kernel: Dl, one warp per row.
//   dkdv_tc: one block of 8 warps per (b, kv head, tile of kBn = 64 keys),
//     the lowest key tiles first (under a causal mask they see the most
//     queries).  K and V stay in shared memory in the input type; the
//     block walks the group's query heads in order and, in each, the tiles
//     of BM = 64 query rows that see one of its keys, with the next tile's
//     q, do, lse and Dl arriving by cp.async while this one is multiplied.
//     Per q tile:
//       1. S^T = K q^T and dP^T = V do^T with mma.sync m16n8k16 (operands
//          by ldmatrix, float32 accumulators); warps split the 64 x 64
//          tiles 4 (16 keys) x 2 (32 queries);
//       2. P^T and dS^T in float32 in registers, masked before anything is
//          rounded, then rounded once to the input type into shared memory;
//       3. dV += P^T do and dK += dS^T q with mma.sync (do and q by
//          ldmatrix.trans); here warps split 4 (16 keys) x 2 (half of the
//          D and Dv columns).
//     The column split is FlashAttention-2's hdim-256 layout: dK and dV
//     of 64 keys at D = Dv = 256 are 32,768 float32 values, 128 registers
//     a thread over 8 warps; a warp that owned whole key rows would need
//     256.  P^T and dS^T pass between the two warp layouts through shared
//     memory.  Shared memory at D = Dv = 256: 222,208 bytes (K, V, two
//     stages of q and do, P^T, dS^T, lse, Dl), one block (8 warps) per SM;
//     at MLA's (192, 128): 148,480 bytes.
//   dq_tc: one block per (b * h, tile of 16 x WARPS query rows), the
//     heaviest causal tiles first.  q and do stay in shared memory; kv
//     tiles of BN keys arrive by cp.async into two stages.  Each warp owns
//     16 query rows: S = q K^T and dP = do V^T with mma.sync, dS in
//     float32, then dQ += dS K with dS rounded once to the input type
//     straight from the accumulator registers (the accumulator layout of
//     m16n8k16 is its A-operand layout) and K by ldmatrix.trans.  At D <=
//     128: 4 warps, 64-key tiles; above: 8 warps and 32-key tiles, as the
//     forward's kTcBk, so that dQ (D / 2 registers a thread), S and dP fit.
//     Shared memory at D = Dv = 256: 202,752 bytes, one block per SM.
// Widths: D and Dv are zero-padded in shared memory to the instantiation's
// DK and DV, which are {32, 64, 128, 192, 256} for both and (192, 128) for
// MLA, whose products then run over no zero column.  Any D, Dv <= 256
// works (16-byte copies where the row width and base allow, 8 or 4 bytes,
// else 2-byte loads).
//
// Rounding: P and dS are rounded once to the input type, as FlashAttention-2
// and PyTorch's SDPA round them.  Emulated on the CPU
// (tests/test_torch_flash_bwd_rounding.py), that costs 2.2e-3 to 3.9e-3
// relative L2 to the plain version in bfloat16, within the 2e-2 gate with
// room; the forward's hi/lo split of P is not needed here.
//
// Bound: operations.  The gradient needs 6 D + 4 Dv flops a visible
// (query, key) pair (S, dP, dV, dK, dQ); these kernels do 10 D + 6 Dv,
// since dq_tc computes S and dP again (1.46x at D = Dv), the price of no
// atomics.  At Gemma-3 1B's training layer (B=8, H=4, Hkv=1, S=4096,
// D=Dv=256, causal) the bound is 687.36 GFLOP, 0.695 ms at the bf16
// tensor-core rate, against 336 MB of inputs and outputs (0.100 ms).
// mma.sync with ldmatrix reaches a fraction of the tensor cores' rate that
// wgmma reaches; wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int kMaxDim = 256;
constexpr int kDeltaThreads = 256;   // one warp per row
constexpr int kDkdvWarps = 8;
constexpr int kDkdvThreads = kDkdvWarps * 32;
constexpr int kBn = 64;              // keys per dkdv block: 4 x 16 rows
constexpr int kBm = 64;              // query rows per dkdv step: 2 x 32

__device__ __forceinline__ bool masked(int kpos, int qpos, int skv,
                                       int causal, int window) {
  return kpos >= skv || (causal && kpos > qpos) ||
         (window > 0 && kpos <= qpos - window);
}

// Dl[r] = sum_j do[r, j] o[r, j] in float32, one warp per row (lane-strided
// sums, then a fixed shuffle tree)
template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, long long rows, int dv) {
  const long long r =
      (long long)blockIdx.x * (kDeltaThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* op = o + r * dv;
  const T* dp = dout + r * dv;
  float acc = 0.f;
  for (int j = lane; j < dv; j += 32) acc += to_f(op[j]) * to_f(dp[j]);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[r] = acc;
}

template <typename T, int DK, int DV>
constexpr size_t dkdv_smem_bytes() {
  return 4 * kBm * sizeof(float) +
         ((size_t)kBn * (DK + 8) + (size_t)kBn * (DV + 8) +
          2 * (size_t)kBm * (DK + 8) + 2 * (size_t)kBm * (DV + 8) +
          2 * (size_t)kBn * (kBm + 8)) * sizeof(T);
}

// DK, DV: D and Dv padded to the instantiation's widths (multiples of 32)
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kDkdvThreads, 1)
dkdv_tc(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        T* __restrict__ dk, T* __restrict__ dv, int h, int hkv, int sq,
        int skv, int d, int dvw, int causal, int window, int q_offset,
        float scale, int bhkv, int vec_q, int vec_k, int vec_v, int vec_do,
        int vec_dk, int vec_dv) {
  constexpr int LDK = DK + 8;      // row strides in elements: 16 B of pad,
  constexpr int LDV = DV + 8;      // so ldmatrix's 8 rows hit distinct banks
  constexpr int LDP = kBm + 8;
  constexpr int NQ = kBm / 16;     // n8 tiles of S^T per warp (32 queries)
  constexpr int NK = DK / 16;      // n8 tiles of dK per warp (DK / 2 cols)
  constexpr int NV = DV / 16;      // n8 tiles of dV per warp (DV / 2 cols)
  extern __shared__ __align__(16) unsigned char smem[];
  float* ls = reinterpret_cast<float*>(smem);   // 2 stages of (kBm): lse
  float* dls = ls + 2 * kBm;                    // 2 stages of (kBm): Dl
  T* ks = reinterpret_cast<T*>(dls + 2 * kBm);  // (kBn, LDK)
  T* vs = ks + kBn * LDK;                       // (kBn, LDV)
  T* qs = vs + kBn * LDV;                       // 2 stages of (kBm, LDK)
  T* dos = qs + 2 * kBm * LDK;                  // 2 stages of (kBm, LDV)
  T* ps = dos + 2 * kBm * LDV;                  // (kBn, LDP): P^T
  T* dss = ps + kBn * LDP;                      // (kBn, LDP): dS^T

  const int kt = (int)(blockIdx.x / bhkv);  // lowest key tiles first
  const int bkv = (int)(blockIdx.x % bhkv); // b * hkv + kv head
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int group = h / hkv;
  const int k0 = kt * kBn;
  const int krows = min(kBn, skv - k0);
  const int tid = threadIdx.x;
  load_tile<T, DK, LDK, kDkdvThreads>(ks, k + ((size_t)bkv * skv + k0) * d,
                                      kBn, krows, d, vec_k);
  load_tile<T, DV, LDV, kDkdvThreads>(vs, v + ((size_t)bkv * skv + k0) * dvw,
                                      kBn, krows, dvw, vec_v);

  // query rows that see some key of this tile (causal, window, q_offset)
  const int i_begin = causal ? max(0, k0 - q_offset) : 0;
  const int i_end =
      window > 0 ? min(sq, max(0, k0 + krows - 1 + window - q_offset)) : sq;
  const int qt_begin = i_begin / kBm;
  const int nqt = i_begin < i_end ? (i_end + kBm - 1) / kBm - qt_begin : 0;
  const int n_it = group * nqt;  // (query head, q tile) steps, in order

  // q, do, lse and Dl of step `it` into stage `st`; rows past Sq are zeros
  auto load_step = [&](int it, int st) {
    const int hh = it / nqt;
    const int q0 = (qt_begin + it % nqt) * kBm;
    const int qrows = min(kBm, sq - q0);
    const size_t row = ((size_t)b * h + (size_t)kvh * group + hh) * sq + q0;
    load_tile<T, DK, LDK, kDkdvThreads>(qs + st * kBm * LDK, q + row * d,
                                        kBm, qrows, d, vec_q);
    load_tile<T, DV, LDV, kDkdvThreads>(dos + st * kBm * LDV,
                                        dout + row * dvw, kBm, qrows, dvw,
                                        vec_do);
    for (int r = tid; r < 2 * kBm; r += kDkdvThreads) {
      const int rr = r < kBm ? r : r - kBm;
      const float* src = (r < kBm ? lse : delta) + row + rr;
      float* dst = (r < kBm ? ls : dls) + st * kBm + rr;
      cp_async<4>(smem_u32(dst), rr < qrows ? src : lse, rr < qrows ? 4 : 0);
    }
  };

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // accumulator rows g and g + 8
  const int t4 = lane & 3;   // accumulator columns 2*t4, 2*t4 + 1
  const int wr = warp & 3;   // this warp's 16 keys: wr * 16 ..
  const int wc = warp >> 2;  // its 32 queries (step 1), its columns (step 3)

  // ldmatrix row addresses of this lane.  Step 1: K and V rows (keys) as
  // the A operand; q and do rows (queries, the columns of S^T) as the B
  // operand.  Step 3: P^T and dS^T rows as the A operand; do and q
  // transposed (queries are the k dimension) as the B operand.
  const unsigned k_a = smem_u32(ks + (wr * 16 + (lane & 15)) * LDK +
                                (lane >> 4) * 8);
  const unsigned v_a = smem_u32(vs + (wr * 16 + (lane & 15)) * LDV +
                                (lane >> 4) * 8);
  const int b_row = wc * (kBm / 2) + (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const unsigned q_b = smem_u32(qs + b_row * LDK + b_col);
  const unsigned do_b = smem_u32(dos + b_row * LDV + b_col);
  const unsigned p_a = smem_u32(ps + (wr * 16 + (lane & 15)) * LDP +
                                (lane >> 4) * 8);
  const unsigned ds_a = smem_u32(dss + (wr * 16 + (lane & 15)) * LDP +
                                 (lane >> 4) * 8);
  const unsigned do_t = smem_u32(dos + (lane & 15) * LDV + wc * (DV / 2) +
                                 (lane >> 4) * 8);
  const unsigned q_t = smem_u32(qs + (lane & 15) * LDK + wc * (DK / 2) +
                                (lane >> 4) * 8);
  constexpr unsigned kQStage = kBm * LDK * sizeof(T);
  constexpr unsigned kDoStage = kBm * LDV * sizeof(T);
  constexpr unsigned kQRows16 = 16 * LDK * sizeof(T);
  constexpr unsigned kDoRows16 = 16 * LDV * sizeof(T);

  float acc_k[NK][4], acc_v[NV][4];
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[j][e] = 0.f;

  if (n_it > 0) load_step(0, 0);
  cp_async_commit();  // K, V and the first step's tiles

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) load_step(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the copy just issued has landed
    __syncthreads();
    const int q0 = (qt_begin + it % nqt) * kBm;

    // 1. S^T = K q^T and dP^T = V do^T: this warp's 16 keys x 32 queries
    float s[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DK / 16; ++kd) {
      uint32_t a[4];
      ldsm_x4(a, k_a + kd * 32);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t bq[4];
        ldsm_x4(bq, q_b + st * kQStage + np * kQRows16 + kd * 32);
        mma<T>(s[2 * np], a, bq[0], bq[1]);
        mma<T>(s[2 * np + 1], a, bq[2], bq[3]);
      }
    }
#pragma unroll
    for (int kd = 0; kd < DV / 16; ++kd) {
      uint32_t a[4];
      ldsm_x4(a, v_a + kd * 32);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t bo[4];
        ldsm_x4(bo, do_b + st * kDoStage + np * kDoRows16 + kd * 32);
        mma<T>(dpt[2 * np], a, bo[0], bo[1]);
        mma<T>(dpt[2 * np + 1], a, bo[2], bo[3]);
      }
    }

    // 2. P^T = exp(S^T / sqrt(D) - lse), dS^T = P^T (dP^T - Dl) in float32,
    // masked first, then rounded once into shared memory
    const float* lrow = ls + st * kBm;
    const float* dlrow = dls + st * kBm;
    const bool edge = q0 + kBm > sq || k0 + kBn > skv ||
                      (causal && k0 + kBn - 1 > q0 + q_offset) ||
                      (window > 0 && k0 <= q0 + kBm - 1 + q_offset - window);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int col = wc * (kBm / 2) + j * 8 + 2 * t4;  // local query
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = wr * 16 + g + 8 * (e >> 1);     // local key
        const int c = col + (e & 1);
        const float l = lrow[c];
        bool dead = l == -INFINITY;
        if (edge)
          dead = dead || q0 + c >= sq ||
                 masked(k0 + key, q0 + c + q_offset, skv, causal, window);
        const float p = dead ? 0.f : exp2f((s[j][e] * scale - l) * kLog2e);
        s[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dlrow[c]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = wr * 16 + g + 8 * r;
        *reinterpret_cast<uint32_t*>(ps + key * LDP + col) =
            pack<T>(s[j][2 * r], s[j][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dss + key * LDP + col) =
            pack<T>(dpt[j][2 * r], dpt[j][2 * r + 1]);
      }
    }
    __syncthreads();

    // 3. dV += P^T do and dK += dS^T q: this warp's 16 keys x half the
    // columns
#pragma unroll
    for (int kk = 0; kk < kBm / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, p_a + kk * 32);
#pragma unroll
      for (int c = 0; c < NV / 2; ++c) {
        uint32_t bo[4];
        ldsm_x4_trans(bo, do_t + st * kDoStage + kk * kDoRows16 + c * 32);
        mma<T>(acc_v[2 * c], a, bo[0], bo[1]);
        mma<T>(acc_v[2 * c + 1], a, bo[2], bo[3]);
      }
      ldsm_x4(a, ds_a + kk * 32);
#pragma unroll
      for (int c = 0; c < NK / 2; ++c) {
        uint32_t bq[4];
        ldsm_x4_trans(bq, q_t + st * kQStage + kk * kQRows16 + c * 32);
        mma<T>(acc_k[2 * c], a, bq[0], bq[1]);
        mma<T>(acc_k[2 * c + 1], a, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage and P^T, dS^T are used up
  }
  cp_async_wait<0>();  // K and V, when no step ran
  __syncthreads();

  // dK / sqrt(D) and dV, rounded once, staged in the K and V tiles, then
  // stored row by row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = wr * 16 + g + 8 * r;
#pragma unroll
    for (int j = 0; j < NK; ++j)
      *reinterpret_cast<uint32_t*>(ks + key * LDK + wc * (DK / 2) + j * 8 +
                                   2 * t4) =
          pack<T>(acc_k[j][2 * r] * scale, acc_k[j][2 * r + 1] * scale);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      *reinterpret_cast<uint32_t*>(vs + key * LDV + wc * (DV / 2) + j * 8 +
                                   2 * t4) =
          pack<T>(acc_v[j][2 * r], acc_v[j][2 * r + 1]);
  }
  __syncthreads();
  const size_t row = (size_t)bkv * skv + k0;
  store_tile<T, DK, LDK, kBn, kDkdvThreads>(dk + row * d, ks, krows, d, tid,
                                            vec_dk);
  store_tile<T, DV, LDV, kBn, kDkdvThreads>(dv + row * dvw, vs, krows, dvw,
                                            tid, vec_dv);
}

template <typename T, int DK, int DV, int BN, int WARPS>
constexpr size_t dq_smem_bytes() {
  return ((size_t)16 * WARPS * (DK + 8) + (size_t)16 * WARPS * (DV + 8) +
          2 * (size_t)BN * (DK + 8) + 2 * (size_t)BN * (DV + 8)) *
         sizeof(T);
}

// BN: keys per kv tile; WARPS: warps of 16 query rows each
template <typename T, int DK, int DV, int BN, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
dq_tc(const T* __restrict__ q, const T* __restrict__ k,
      const T* __restrict__ v, const T* __restrict__ dout,
      const float* __restrict__ lse, const float* __restrict__ delta,
      T* __restrict__ dq, int h, int hkv, int sq, int skv, int d, int dvw,
      int causal, int window, int q_offset, float scale, int bhs, int vec_q,
      int vec_k, int vec_v, int vec_do, int vec_dq) {
  constexpr int NT = WARPS * 32;
  constexpr int BM = 16 * WARPS;
  constexpr int LDK = DK + 8;
  constexpr int LDV = DV + 8;
  constexpr int NS = BN / 8;   // n8 tiles of S and dP per warp
  constexpr int ND = DK / 8;   // n8 tiles of dQ per warp
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);   // (BM, LDK)
  T* dos = qs + BM * LDK;               // (BM, LDV)
  T* ks = dos + BM * LDV;               // 2 stages of (BN, LDK)
  T* vs = ks + 2 * BN * LDK;            // 2 stages of (BN, LDV)

  const int nq = (sq + BM - 1) / BM;
  const int bh = (int)(blockIdx.x % bhs);
  const int qt = nq - 1 - (int)(blockIdx.x / bhs);  // heaviest first
  const int group = h / hkv;
  const int kvh = (bh / h) * hkv + (bh % h) / group;
  const T* kp = k + (size_t)kvh * skv * d;
  const T* vp = v + (size_t)kvh * skv * dvw;
  const int q0 = qt * BM;
  const int qrows = min(BM, sq - q0);
  const size_t row0 = (size_t)bh * sq + q0;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  // kv tiles with a visible key for some row of this block (the forward's)
  const int qpos_first = q0 + q_offset;
  const int qpos_last = q0 + qrows - 1 + q_offset;
  const int nk = (skv + BN - 1) / BN;
  int kt_begin = 0, kt_end = nk;
  if (window > 0 && qpos_first - window + 1 > 0)
    kt_begin = min(nk, (qpos_first - window + 1) / BN);
  if (causal) kt_end = qpos_last < 0 ? 0 : min(nk, qpos_last / BN + 1);

  load_tile<T, DK, LDK, NT>(qs, q + row0 * d, BM, qrows, d, vec_q);
  load_tile<T, DV, LDV, NT>(dos, dout + row0 * dvw, BM, qrows, dvw, vec_do);
  if (kt_begin < kt_end) {
    const size_t row = (size_t)kt_begin * BN;
    const int valid = min(BN, skv - kt_begin * BN);
    load_tile<T, DK, LDK, NT>(ks, kp + row * d, BN, valid, d, vec_k);
    load_tile<T, DV, LDV, NT>(vs, vp + row * dvw, BN, valid, dvw, vec_v);
  }
  cp_async_commit();

  // lse and Dl of this lane's rows g and g + 8; rows past Sq see no key
  float lr[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = warp * 16 + g + 8 * r;
    lr[r] = i < qrows ? lse[row0 + i] : -INFINITY;
    dl[r] = i < qrows ? delta[row0 + i] : 0.f;
  }

  // ldmatrix row addresses: q and do rows as the A operand of S and dP; K
  // and V rows (keys, the columns of S) as their B operand; K transposed
  // (keys are the k dimension) as the B operand of dS K
  const unsigned q_a = smem_u32(qs + (warp * 16 + (lane & 15)) * LDK +
                                (lane >> 4) * 8);
  const unsigned do_a = smem_u32(dos + (warp * 16 + (lane & 15)) * LDV +
                                 (lane >> 4) * 8);
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
  const unsigned k_b = smem_u32(ks + b_row * LDK + b_col);
  const unsigned v_b = smem_u32(vs + b_row * LDV + b_col);
  const unsigned k_t = smem_u32(ks + (lane & 15) * LDK + (lane >> 4) * 8);
  constexpr unsigned kKStage = BN * LDK * sizeof(T);
  constexpr unsigned kVStage = BN * LDV * sizeof(T);
  constexpr unsigned kKRows16 = 16 * LDK * sizeof(T);
  constexpr unsigned kVRows16 = 16 * LDV * sizeof(T);

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int qpos0 = q0 + warp * 16 + g + q_offset;  // row g; row g + 8: +8

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {  // the next tile's copy overlaps this tile's work
      const size_t row = (size_t)(kt + 1) * BN;
      const int valid = min(BN, skv - (kt + 1) * BN);
      load_tile<T, DK, LDK, NT>(ks + (st ^ 1) * BN * LDK, kp + row * d, BN,
                                valid, d, vec_k);
      load_tile<T, DV, LDV, NT>(vs + (st ^ 1) * BN * LDV, vp + row * dvw, BN,
                                valid, dvw, vec_v);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // S = q K^T and dP = do V^T: this warp's 16 rows x BN keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DK / 16; ++kd) {
      uint32_t a[4];
      ldsm_x4(a, q_a + kd * 32);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, k_b + st * kKStage + np * kKRows16 + kd * 32);
        mma<T>(s[2 * np], a, bk[0], bk[1]);
        mma<T>(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int kd = 0; kd < DV / 16; ++kd) {
      uint32_t a[4];
      ldsm_x4(a, do_a + kd * 32);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bv[4];
        ldsm_x4(bv, v_b + st * kVStage + np * kVRows16 + kd * 32);
        mma<T>(dp[2 * np], a, bv[0], bv[1]);
        mma<T>(dp[2 * np + 1], a, bv[2], bv[3]);
      }
    }

    // dS = P (dP - Dl) in float32, P masked before anything is rounded
    const int k0 = kt * BN;
    const bool edge = k0 + BN > skv || (causal && k0 + BN - 1 > qpos_first) ||
                      (window > 0 && k0 <= qpos_last - window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        bool dead = lr[r] == -INFINITY;
        if (edge)
          dead = dead || masked(k0 + j * 8 + 2 * t4 + (e & 1), qpos0 + 8 * r,
                                skv, causal, window);
        const float p =
            dead ? 0.f : exp2f((s[j][e] * scale - lr[r]) * kLog2e);
        s[j][e] = p * (dp[j][e] - dl[r]);
      }

    // dQ += dS K: dS's accumulator registers, rounded once, are the A
    // operand
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack<T>(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack<T>(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int c = 0; c < DK / 16; ++c) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, k_t + st * kKStage + kk * kKRows16 + c * 32);
        mma<T>(acc[2 * c], a, bk[0], bk[1]);
        mma<T>(acc[2 * c + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();  // q's and do's copies, when no tile was visited
  __syncthreads();

  // dQ / sqrt(D), rounded once, staged in this warp's own q rows, then
  // stored row by row
  T* stage = qs + warp * 16 * LDK;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * r) * LDK + j * 8 +
                                   2 * t4) =
          pack<T>(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  __syncwarp();
  const int valid = max(0, min(16, qrows - warp * 16));
  store_tile<T, DK, LDK, 16, 32>(dq + (row0 + warp * 16) * d, stage, valid,
                                 d, lane, vec_dq);
}

template <typename T, int DK, int DV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int b, int h, int hkv, int sq, int skv, int d,
           int dvw, int causal, int window, int q_offset, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float scale = (float)(1.0 / std::sqrt((double)d));
  const int es = (int)sizeof(T);
  cudaError_t err;
  const long long rows = (long long)b * h * sq;
  if (rows > 0) {
    const long long blocks =
        (rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    delta_kernel<T><<<(unsigned)blocks, kDeltaThreads, 0, s>>>(
        static_cast<const T*>(o), dot, delta, rows, dvw);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (skv > 0) {
    constexpr size_t smem = dkdv_smem_bytes<T, DK, DV>();
    auto kern = dkdv_tc<T, DK, DV>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int bhkv = b * hkv;
    const long long blocks = (long long)bhkv * ((skv + kBn - 1) / kBn);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    kern<<<(unsigned)blocks, kDkdvThreads, smem, s>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        h, hkv, sq, skv, d, dvw, causal, window, q_offset, scale, bhkv,
        vec_bytes(q, d, es), vec_bytes(k, d, es), vec_bytes(v, dvw, es),
        vec_bytes(dout, dvw, es), vec_bytes(dk, d, es),
        vec_bytes(dv, dvw, es));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (sq > 0) {
    // 8 warps and 32-key tiles where dQ (DK / 2 registers a thread) is wide
    constexpr int kWarps = DK > 128 ? 8 : 4;
    constexpr int kBnq = DK > 128 ? 32 : 64;
    constexpr size_t smem = dq_smem_bytes<T, DK, DV, kBnq, kWarps>();
    auto kern = dq_tc<T, DK, DV, kBnq, kWarps>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks =
        (long long)b * h * ((sq + 16 * kWarps - 1) / (16 * kWarps));
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    kern<<<(unsigned)blocks, kWarps * 32, smem, s>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), h, hkv, sq, skv, d,
        dvw, causal, window, q_offset, scale, b * h, vec_bytes(q, d, es),
        vec_bytes(k, d, es), vec_bytes(v, dvw, es), vec_bytes(dout, dvw, es),
        vec_bytes(dq, d, es));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// The instantiation's widths: (192, 128) for MLA, else max(D, Dv) rounded
// up to 32, 64, 128, 192 or 256 for both.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int b, int h, int hkv, int sq, int skv, int d,
             int dvw, int causal, int window, int q_offset, cudaStream_t s) {
#define FA_BWD_TC(DK, DV)                                                     \
  return launch<T, DK, DV>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h,   \
                           hkv, sq, skv, d, dvw, causal, window, q_offset, s)
  if (d > 128 && d <= 192 && dvw <= 128) FA_BWD_TC(192, 128);
  const int w = std::max(d, dvw);
  if (w <= 32) FA_BWD_TC(32, 32);
  if (w <= 64) FA_BWD_TC(64, 64);
  if (w <= 128) FA_BWD_TC(128, 128);
  if (w <= 192) FA_BWD_TC(192, 192);
  FA_BWD_TC(256, 256);
#undef FA_BWD_TC
}

}  // namespace

extern "C" int flash_attention_bwd_tc_max_head_dim() { return kMaxDim; }

// q (b, h, sq, d), k (b, hkv, skv, d), v (b, hkv, skv, dv), o and dout
// (b, h, sq, dv), dq (b, h, sq, d), dk (b, hkv, skv, d), dv_out (b, hkv, skv,
// dv): contiguous, of one 16-bit type (dtype 1 bfloat16, 2 float16); lse
// and delta (b, h, sq) float32 (delta is scratch).  Returns the CUDA error
// of the launches (0 on success).
extern "C" int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv_out, int b, int h, int hkv, int sq, int skv, int d, int dv,
    int causal, int window, int q_offset, int dtype, void* stream) {
  if (b <= 0 || h <= 0) return 0;
  if (d < 1 || d > kMaxDim || dv < 1 || dv > kMaxDim || hkv < 1 ||
      h % hkv != 0 || sq < 0 || skv < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk,
                                     dv_out, b, h, hkv, sq, skv, d, dv, causal,
                                     window, q_offset, s);
    case 2:
      return dispatch<__half>(q, k, v, o, dout, lse, delta, dq, dk, dv_out, b,
                              h, hkv, sq, skv, d, dv, causal, window, q_offset,
                              s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
