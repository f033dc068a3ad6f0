// flash_attention_bwd: the backward pass of flash_attention on Hopper.
//
// Replaces no TPU kernel: the reference has no backward Pallas kernel.  It
// trains through chunked_attention (src/repro/models/attention.py:31), which
// XLA differentiates.  The port computes that attention with its own forward
// kernel (flash_attention.cu, which replaces the Pallas _kernel of
// src/repro/kernels/flash_attention/flash_attention.py), so a gradient on the
// card needs this kernel.  For q (B, H, Sq, D), k (B, Hkv, Skv, D),
// v (B, Hkv, Skv, Dv), the forward's output o (B, H, Sq, Dv), its per-row
// log-sum-exp lse (B, H, Sq) float32 and the output's cotangent do:
//   P   = exp(S - lse), S = q k^T / sqrt(D) over the visible keys (0 elsewhere)
//   dv  = sum over the group's heads of P^T do
//   dP  = do v^T,  Dl = rowsum(do * o),  dS = P * (dP - Dl)
//   dq  = dS k / sqrt(D),  dk = sum over the group's heads of dS^T q / sqrt(D)
// with the forward's masks (causal, window, q_offset, keys past Skv) and
// GQA (query head h reads kv head h / (H / Hkv)).  A row with no visible
// key has lse = -inf and P = 0, so its dq is 0.  FlashAttention-2's
// backward: P is recomputed tile by tile from q, k and lse; nothing of size
// (Sq, Skv) is stored.  S is recomputed as the forward's variant computes
// it: float32 inputs are scaled before the product (the CUDA-core forward),
// 16-bit ones after it (the tensor-core forward).
//
// Three kernels, no atomics, every sum in a fixed order, so a result is
// bitwise the same from launch to launch:
//   delta_kernel: Dl, one warp per row (lane-strided sums, then a fixed
//     shuffle tree).
//   dkdv_kernel: one block per (b, kv head, tile of kBk = 32 keys).  K and V
//     stay in shared memory; the block walks the group's H / Hkv query heads
//     in order and, in each, the tiles of kBq = 64 query rows that see a key
//     of its tile (causal, window and q_offset bound the range).  Per q
//     tile: S^T and dP^T (a 2 x 4 block per thread), P^T and dS^T through
//     shared memory, then dV += P^T do and dK += dS^T q, each thread holding
//     2 key rows x Dv / 16 (D / 16) columns in registers.
//   dq_kernel: one block per (b * h, tile of 64 query rows), the heaviest
//     causal tiles first; q and do stay in shared memory, kv tiles of 32
//     keys pass through; dS through shared memory, dQ += dS k in registers
//     (4 rows x D / 16 columns a thread).
// Everything is float32 on CUDA cores: inputs are widened when staged into
// shared memory, outputs rounded once to the input type.
//
// Bound: operations.  The gradient needs, per visible (query, key) pair,
// S = q k^T (2 D), dP = do v^T (2 Dv), dV = P^T do (2 Dv), dQ = dS k (2 D)
// and dK = dS^T q (2 D) flops: 6 D + 4 Dv, 2.5 times the forward's.  At
// Gemma-3 1B's training layer (B=8, H=4, Hkv=1, S=4096, D=Dv=256, bf16,
// causal) that is 687.36 GFLOP, 0.695 ms at the bf16 tensor-core rate,
// against 336 MB of inputs and outputs (0.100 ms).  The two kernels do
// 14 D a pair at D = Dv (S and dP are computed in both), on CUDA cores at
// float32 FMA rate, with shared-memory loads (six per eight FMAs in the S
// loop) as the limit: a tensor-core (mma.sync, then wgmma) version is later
// work.  Shared memory at D = Dv = 256: 214 KB (dkdv) and 206 KB (dq), one
// block per SM.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kBq = 64;        // query rows per tile
constexpr int kBk = 32;        // keys per tile
constexpr int kMaxDim = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// An odd row stride (in floats) of at least w: the 16 rows that a half-warp
// reads at one column fall in distinct banks.
__host__ __device__ inline int odd(int w) { return w | 1; }

// rows [0, rows) of a (*, width) row-major matrix at src into shared memory
// as float32 with row stride ld, times mul; rows past `valid` are zeros
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int rows,
                                      int valid, int width, int ld,
                                      float mul) {
  for (int idx = threadIdx.x; idx < rows * width; idx += kThreads) {
    const int r = idx / width;
    const int c = idx - r * width;
    dst[r * ld + c] = r < valid ? to_f(src[(size_t)r * width + c]) * mul : 0.f;
  }
}

__device__ __forceinline__ bool masked(int kpos, int qpos, int skv,
                                       int causal, int window) {
  return kpos >= skv || (causal && kpos > qpos) ||
         (window > 0 && kpos <= qpos - window);
}

// Dl[r] = sum_j do[r, j] o[r, j] in float32, one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, long long rows, int dv) {
  const long long r =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
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

size_t dkdv_smem(int d, int dv) {
  return ((size_t)(kBk + kBq) * (odd(d) + odd(dv)) +
          2 * (size_t)kBk * odd(kBq) + 2 * kBq) *
         sizeof(float);
}

// DPT: columns per lane, 16 * DPT >= max(D, Dv)
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int h, int hkv, int sq,
            int skv, int d, int dvw, int causal, int window, int q_offset,
            float scale, int prescale) {
  extern __shared__ __align__(16) float sm[];
  const int ldk = odd(d), ldv = odd(dvw), ldp = odd(kBq);
  float* ks = sm;                   // (kBk, ldk)
  float* vs = ks + kBk * ldk;       // (kBk, ldv)
  float* qs = vs + kBk * ldv;       // (kBq, ldk)
  float* dos = qs + kBq * ldk;      // (kBq, ldv)
  float* ps = dos + kBq * ldv;      // (kBk, ldp): P^T
  float* dss = ps + kBk * ldp;      // (kBk, ldp): dS^T
  float* ls = dss + kBk * ldp;      // (kBq): lse of the tile's rows
  float* dls = ls + kBq;            // (kBq): Dl of the tile's rows

  const int nk = (skv + kBk - 1) / kBk;
  const int kt = (int)(blockIdx.x % nk);
  const int bkv = (int)(blockIdx.x / nk);  // b * hkv + kv head
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int group = h / hkv;
  const int k0 = kt * kBk;
  const int krows = min(kBk, skv - k0);
  stage(ks, k + ((size_t)bkv * skv + k0) * d, kBk, krows, d, ldk, 1.f);
  stage(vs, v + ((size_t)bkv * skv + k0) * dvw, kBk, krows, dvw, ldv, 1.f);

  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // key rows rg*2, rg*2 + 1
  const int cl = tid & 15;  // query columns cl + 16 j; output columns cl + 16 jj
  const float qmul = prescale ? scale : 1.f;
  const float smul = prescale ? 1.f : scale;

  float acc_k[2][DPT], acc_v[2][DPT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) acc_k[i][jj] = acc_v[i][jj] = 0.f;

  // query rows that see some key of this tile
  const int i_begin = causal ? max(0, k0 - q_offset) : 0;
  const int i_end =
      window > 0 ? min(sq, max(0, k0 + krows - 1 + window - q_offset)) : sq;
  const int qt_begin = i_begin / kBq;
  const int qt_end = i_begin < i_end ? (i_end + kBq - 1) / kBq : qt_begin;

  for (int hh = 0; hh < group; ++hh) {
    const size_t bh = (size_t)b * h + (size_t)kvh * group + hh;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBq;
      const int qrows = min(kBq, sq - q0);
      __syncthreads();  // the previous tile's q, do, P^T and dS^T are used up
      stage(qs, q + (bh * sq + q0) * d, kBq, qrows, d, ldk, qmul);
      stage(dos, dout + (bh * sq + q0) * dvw, kBq, qrows, dvw, ldv, 1.f);
      for (int r = tid; r < kBq; r += kThreads) {
        ls[r] = r < qrows ? lse[bh * sq + q0 + r] : -INFINITY;
        dls[r] = r < qrows ? delta[bh * sq + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[2][4], dp[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < d; ++c) {
        float kv[2], qv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) kv[i] = ks[(rg * 2 + i) * ldk + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) qv[j] = qs[(cl + 16 * j) * ldk + c];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
      }
#pragma unroll 4
      for (int c = 0; c < dvw; ++c) {
        float vv[2], ov[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) vv[i] = vs[(rg * 2 + i) * ldv + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) ov[j] = dos[(cl + 16 * j) * ldv + c];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kpos = k0 + rg * 2 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cl + 16 * j;
          const float l = ls[c];
          const float p =
              (l == -INFINITY ||
               masked(kpos, q0 + c + q_offset, skv, causal, window))
                  ? 0.f
                  : expf(s[i][j] * smul - l);
          ps[(rg * 2 + i) * ldp + c] = p;
          dss[(rg * 2 + i) * ldp + c] = p * (dp[i][j] - dls[c]);
        }
      }
      __syncwarp();  // a row group's P^T and dS^T rows are its own lanes'

#pragma unroll 4
      for (int c = 0; c < kBq; ++c) {
        float pv[2], sv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pv[i] = ps[(rg * 2 + i) * ldp + c];
          sv[i] = dss[(rg * 2 + i) * ldp + c];
        }
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) {
          const int col = cl + 16 * jj;
          const float ov = col < dvw ? dos[c * ldv + col] : 0.f;
          const float qv = col < d ? qs[c * ldk + col] : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            acc_v[i][jj] = fmaf(pv[i], ov, acc_v[i][jj]);
            acc_k[i][jj] = fmaf(sv[i], qv, acc_k[i][jj]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rg * 2 + i;
    if (r >= krows) continue;
    const size_t row = (size_t)bkv * skv + k0 + r;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) {
      const int col = cl + 16 * jj;
      if (col < d) dk[row * d + col] = from_f<T>(acc_k[i][jj] * smul);
      if (col < dvw) dv[row * dvw + col] = from_f<T>(acc_v[i][jj]);
    }
  }
}

size_t dq_smem(int d, int dv) {
  return ((size_t)(kBq + kBk) * (odd(d) + odd(dv)) +
          (size_t)kBq * odd(kBk) + 2 * kBq) *
         sizeof(float);
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int h, int hkv, int sq, int skv, int d, int dvw,
          int causal, int window, int q_offset, float scale, int prescale,
          int bhs) {
  extern __shared__ __align__(16) float sm[];
  const int ldk = odd(d), ldv = odd(dvw), lds = odd(kBk);
  float* qs = sm;                   // (kBq, ldk)
  float* dos = qs + kBq * ldk;      // (kBq, ldv)
  float* ks = dos + kBq * ldv;      // (kBk, ldk)
  float* vs = ks + kBk * ldk;       // (kBk, ldv)
  float* dss = vs + kBk * ldv;      // (kBq, lds): dS
  float* ls = dss + kBq * lds;      // (kBq)
  float* dls = ls + kBq;            // (kBq)

  const int nq = (sq + kBq - 1) / kBq;
  const int bh = (int)(blockIdx.x % bhs);
  const int qt = nq - 1 - (int)(blockIdx.x / bhs);
  const int group = h / hkv;
  const int kvh = (bh / h) * hkv + (bh % h) / group;
  const int q0 = qt * kBq;
  const int qrows = min(kBq, sq - q0);
  const float qmul = prescale ? scale : 1.f;
  const float smul = prescale ? 1.f : scale;
  const T* kp = k + (size_t)kvh * skv * d;
  const T* vp = v + (size_t)kvh * skv * dvw;

  stage(qs, q + ((size_t)bh * sq + q0) * d, kBq, qrows, d, ldk, qmul);
  stage(dos, dout + ((size_t)bh * sq + q0) * dvw, kBq, qrows, dvw, ldv, 1.f);
  const int tid = threadIdx.x;
  for (int r = tid; r < kBq; r += kThreads) {
    ls[r] = r < qrows ? lse[(size_t)bh * sq + q0 + r] : -INFINITY;
    dls[r] = r < qrows ? delta[(size_t)bh * sq + q0 + r] : 0.f;
  }
  const int rg = tid >> 4;  // query rows rg*4 .. rg*4 + 3
  const int cl = tid & 15;  // key columns cl + 16 j; output columns cl + 16 jj

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = 0.f;

  // kv tiles with a visible key for some row of this tile (the forward's)
  const int qpos_first = q0 + q_offset;
  const int qpos_last = q0 + qrows - 1 + q_offset;
  const int nk = (skv + kBk - 1) / kBk;
  int kt_begin = 0, kt_end = nk;
  if (window > 0 && qpos_first - window + 1 > 0)
    kt_begin = min(nk, (qpos_first - window + 1) / kBk);
  if (causal) kt_end = qpos_last < 0 ? 0 : min(nk, qpos_last / kBk + 1);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBk;
    const int krows = min(kBk, skv - k0);
    __syncthreads();  // the previous tile's K, V and dS are used up
    stage(ks, kp + (size_t)k0 * d, kBk, krows, d, ldk, 1.f);
    stage(vs, vp + (size_t)k0 * dvw, kBk, krows, dvw, ldv, 1.f);
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(rg * 4 + i) * ldk + c];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = ks[(cl + 16 * j) * ldk + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll 4
    for (int c = 0; c < dvw; ++c) {
      float ov[4], vv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) ov[i] = dos[(rg * 4 + i) * ldv + c];
#pragma unroll
      for (int j = 0; j < 2; ++j) vv[j] = vs[(cl + 16 * j) * ldv + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const float l = ls[r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = cl + 16 * j;
        const float p =
            (l == -INFINITY ||
             masked(k0 + c, q0 + r + q_offset, skv, causal, window))
                ? 0.f
                : expf(s[i][j] * smul - l);
        dss[r * lds + c] = p * (dp[i][j] - dls[r]);
      }
    }
    __syncwarp();  // a row group's dS rows are its own lanes'

#pragma unroll 4
    for (int c = 0; c < kBk; ++c) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dss[(rg * 4 + i) * lds + c];
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) {
        const int col = cl + 16 * jj;
        const float kx = col < d ? ks[c * ldk + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(sv[i], kx, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (r >= qrows) continue;
    const size_t row = (size_t)bh * sq + q0 + r;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) {
      const int col = cl + 16 * jj;
      if (col < d) dq[row * d + col] = from_f<T>(acc[i][jj] * scale);
    }
  }
}

template <typename T, int DPT>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int b, int h, int hkv, int sq, int skv, int d,
           int dvw, int causal, int window, int q_offset, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float scale = (float)(1.0 / std::sqrt((double)d));
  const int prescale = sizeof(T) == 4;
  cudaError_t err;
  const long long rows = (long long)b * h * sq;
  if (rows > 0) {
    const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    delta_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const T*>(o), dot, delta, rows, dvw);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (skv > 0) {
    const size_t smem = dkdv_smem(d, dvw);
    auto kern = dkdv_kernel<T, DPT>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)b * hkv * ((skv + kBk - 1) / kBk);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    kern<<<(unsigned)blocks, kThreads, smem, s>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        h, hkv, sq, skv, d, dvw, causal, window, q_offset, scale, prescale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (sq > 0) {
    const size_t smem = dq_smem(d, dvw);
    auto kern = dq_kernel<T, DPT>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)b * h * ((sq + kBq - 1) / kBq);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    kern<<<(unsigned)blocks, kThreads, smem, s>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), h, hkv, sq, skv, d,
        dvw, causal, window, q_offset, scale, prescale, b * h);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int b, int h, int hkv, int sq, int skv, int d,
             int dvw, int causal, int window, int q_offset, cudaStream_t s) {
  const int w = d > dvw ? d : dvw;
#define FA_BWD(DPT)                                                        \
  return launch<T, DPT>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, hkv, \
                        sq, skv, d, dvw, causal, window, q_offset, s)
  if (w <= 16) FA_BWD(1);
  if (w <= 32) FA_BWD(2);
  if (w <= 64) FA_BWD(4);
  if (w <= 128) FA_BWD(8);
  FA_BWD(16);
#undef FA_BWD
}

}  // namespace

extern "C" int flash_attention_bwd_max_head_dim() { return kMaxDim; }

// q (b, h, sq, d), k (b, hkv, skv, d), v (b, hkv, skv, dv), o and dout
// (b, h, sq, dv), dq (b, h, sq, d), dk (b, hkv, skv, d), dv_out (b, hkv, skv,
// dv): contiguous, of one type (dtype 0 float32, 1 bfloat16, 2 float16);
// lse and delta (b, h, sq) float32 (delta is scratch).  Returns the CUDA
// error of the launches (0 on success).
extern "C" int flash_attention_bwd_launch(
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
    case 0:
      return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv_out, b,
                             h, hkv, sq, skv, d, dv, causal, window, q_offset,
                             s);
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
