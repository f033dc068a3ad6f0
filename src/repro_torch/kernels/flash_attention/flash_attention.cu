// flash_attention: blocked online-softmax attention (forward) on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py:
// _kernel (pallas_call in flash_attention_pallas).  For q (B, H, Sq, D) and
// k, v (B, Hkv, Skv, D) in float32, bfloat16 or float16:
//   o[b, h, i] = softmax_j(q[b,h,i] . k[b,g,j] / sqrt(D)) v[b,g,j]
// with g = h / (H / Hkv) (GQA: the kv head of query head h, never copied to
// H heads), over the keys j that are visible to query position
// i + q_offset: j <= i + q_offset when causal, and j > i + q_offset - window
// when window > 0.  A row that sees no key is 0, as in the Pallas kernel.
// The output has q's type; everything inside is float32.
//
// Design.  One block of 256 threads per (b*h, tile of kBq = 64 queries),
// looping over tiles of kBk = 64 keys with a running (m, l, acc) per query
// row in registers, as the TPU kernel's sequential kv grid axis does in
// VMEM scratch.  The 256 threads form 16 row groups of 16 lanes; a row
// group owns 4 query rows.  For each kv tile:
//   1. K and V are copied into shared memory in the input type (at D = 256
//      a float32 tile pair is 128 KB, so nothing wider is kept), then
//   2. each lane computes a 4 x 4 block of scores S = (q / sqrt(D)) k^T
//      from the float32 q tile (scaled once, in float32, as the Pallas
//      kernel does) and the K tile, with CUDA-core FMAs;
//   3. masking by the same position tests as the Pallas kernel, and the
//      online-softmax update with its -inf guards (m_safe, corr), row max
//      and row sum by shuffles among the 16 lanes of a row group;
//   4. P goes through shared memory and each lane adds P V into its
//      4 x (D / 16) slice of acc.
// KV tiles that are wholly masked (the causal test and the window test of
// flash_attention.py:40-44) are not visited.  Sq and Skv need not be
// multiples of a tile: rows past Sq are not stored, keys past Skv are
// masked.  Every sum has a fixed order, so a result is bitwise the same from
// launch to launch.
//
// Bound: operations.  At Gemma-3 1B's prefill (B=4, H=4, Hkv=1, Sq=Skv=4096,
// D=256, bfloat16) a causal layer does 4*D flops for each of the ~8.4M
// visible (query, key) pairs per head: 137 GFLOP against 84 MB of inputs
// and output.  The card's bound for that is its bfloat16 tensor-core rate;
// this first kernel uses CUDA cores in float32 (about 67 TFLOP/s at best)
// and leaves the tensor cores (mma/wgmma), TMA and a load pipeline to later
// work.  Shared memory per block: 64 x (D+1) floats of q, 64 x 65 floats of
// P, and the K and V tiles in the input type: 214 KB for float32 at
// D = 256, so one block per SM.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // keys per kv tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kRows = 4;       // query rows per row group (kBq / 16)
constexpr int kCols = 4;       // score columns per lane (kBk / 16)
constexpr int kMaxDim = 256;
constexpr int kLdp = kBk + 1;  // row stride of the P tile (floats)

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

// Row stride of the K tile in elements: an odd number of 32-bit words, so
// the 16 rows read at one column by a half-warp fall in distinct banks.
__host__ __device__ inline int k_stride(int d, int elem_bytes) {
  int words = (d * elem_bytes + 3) / 4;
  if (words % 2 == 0) ++words;
  return words * 4 / elem_bytes;
}

__host__ __device__ inline size_t smem_bytes(int d, int elem_bytes) {
  return (size_t)kBq * (d + 1) * 4 + (size_t)kBq * kLdp * 4 +
         (size_t)kBk * k_stride(d, elem_bytes) * elem_bytes +
         (size_t)kBk * d * elem_bytes;
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// DPT: output columns per lane, 16 * DPT >= D.
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int h, int hkv,
             int sq, int skv, int d, int causal, int window, int q_offset,
             float scale, int bhs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldq = d + 1;
  const int ldk = k_stride(d, sizeof(T));
  float* qs = reinterpret_cast<float*>(smem);        // (kBq, ldq)
  float* ps = qs + kBq * ldq;                        // (kBq, kLdp)
  T* ks = reinterpret_cast<T*>(ps + kBq * kLdp);     // (kBk, ldk)
  T* vs = ks + kBk * ldk;                            // (kBk, d)

  // the last query tiles of a causal head do the most work: the blocks of
  // every head's last tile come first, then those of the tile before it
  const int nq = (sq + kBq - 1) / kBq;
  const int bh = (int)(blockIdx.x % bhs);
  const int qt = nq - 1 - (int)(blockIdx.x / bhs);
  const int group = h / hkv;
  const int kvh = (bh / h) * hkv + (bh % h) / group;
  const T* qp = q + (size_t)bh * sq * d;
  const T* kp = k + (size_t)kvh * skv * d;
  const T* vp = v + (size_t)kvh * skv * d;
  T* op = o + (size_t)bh * sq * d;
  const int q0 = qt * kBq;
  const int qrows = min(kBq, sq - q0);

  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // row group: query rows rg*4 .. rg*4+3
  const int cl = tid & 15;  // lane in the group: columns cl + 16*j

  for (int idx = tid; idx < kBq * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    qs[r * ldq + c] =
        r < qrows ? to_f(qp[(size_t)(q0 + r) * d + c]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = 0.f;
  }

  const int qpos_first = q0 + q_offset;
  const int qpos_last = q0 + qrows - 1 + q_offset;
  const int nk = (skv + kBk - 1) / kBk;
  int kt = 0;
  if (window > 0 && qpos_first - window + 1 > 0)
    kt = (qpos_first - window + 1) / kBk;
  for (; kt < nk; ++kt) {
    const int k0 = kt * kBk;
    if (causal && k0 > qpos_last) break;  // this and every later tile masked
    if (window > 0 && k0 + kBk - 1 <= qpos_first - window) continue;

    __syncthreads();  // every thread is done with the previous K, V and P
    for (int idx = tid; idx < kBk * d; idx += kThreads) {
      const int r = idx / d;
      const int c = idx - r * d;
      const bool in = k0 + r < skv;
      const size_t g = (size_t)(k0 + r) * d + c;
      ks[r * ldk + c] = in ? kp[g] : from_f<T>(0.f);
      vs[r * d + c] = in ? vp[g] : from_f<T>(0.f);
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(rg * kRows + i) * ldq + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = to_f(ks[(cl + 16 * j) * ldk + c]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + rg * kRows + i + q_offset;
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + cl + 16 * j;
        const bool masked = kpos >= skv || (causal && kpos > qpos) ||
                            (window > 0 && kpos <= qpos - window);
        if (masked) s[i][j] = -INFINITY;
        mc = fmaxf(mc, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mc));
      // rows with everything masked keep m = -inf: guard exp(-inf - -inf)
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        ps[(rg * kRows + i) * kLdp + cl + 16 * j] = p;
        psum += p;
      }
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      l[i] = corr * l[i] + group_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) acc[i][jj] *= corr;
    }
    __syncwarp();  // a row group's P rows are written and read by its lanes

#pragma unroll 4
    for (int c = 0; c < kBk; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(rg * kRows + i) * kLdp + c];
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) {
        const int col = cl + 16 * jj;
        const float vv = col < d ? to_f(vs[c * d + col]) : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = rg * kRows + i;
    if (r >= qrows) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) {
      const int col = cl + 16 * jj;
      if (col < d) op[(size_t)(q0 + r) * d + col] = from_f<T>(acc[i][jj] / l_safe);
    }
  }
}

template <typename T, int DPT>
int launch(const void* q, const void* k, const void* v, void* o, int b, int h,
           int hkv, int sq, int skv, int d, int causal, int window,
           int q_offset, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, sizeof(T));
  auto kern = flash_kernel<T, DPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (sq + kBq - 1) / kBq;
  const long long blocks = (long long)b * h * nq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / std::sqrt((double)d));
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), h, hkv, sq, skv, d,
      causal, window, q_offset, scale, b * h);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int h, int hkv, int sq, int skv, int d, int causal, int window,
             int q_offset, cudaStream_t s) {
  if (d <= 16)
    return launch<T, 1>(q, k, v, o, b, h, hkv, sq, skv, d, causal, window,
                        q_offset, s);
  if (d <= 32)
    return launch<T, 2>(q, k, v, o, b, h, hkv, sq, skv, d, causal, window,
                        q_offset, s);
  if (d <= 64)
    return launch<T, 4>(q, k, v, o, b, h, hkv, sq, skv, d, causal, window,
                        q_offset, s);
  if (d <= 128)
    return launch<T, 8>(q, k, v, o, b, h, hkv, sq, skv, d, causal, window,
                        q_offset, s);
  return launch<T, 16>(q, k, v, o, b, h, hkv, sq, skv, d, causal, window,
                       q_offset, s);
}

}  // namespace

extern "C" int flash_attention_max_head_dim() { return kMaxDim; }

// q, o (b, h, sq, d); k, v (b, hkv, skv, d); all contiguous, of one type:
// dtype 0 float32, 1 bfloat16, 2 float16.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int h,
                                      int hkv, int sq, int skv, int d,
                                      int causal, int window, int q_offset,
                                      int dtype, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return 0;
  if (d < 1 || d > kMaxDim || hkv < 1 || h % hkv != 0 || skv < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, o, b, h, hkv, sq, skv, d, causal,
                             window, q_offset, s);
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, o, b, h, hkv, sq, skv, d,
                                     causal, window, q_offset, s);
    case 2:
      return dispatch<__half>(q, k, v, o, b, h, hkv, sq, skv, d, causal,
                              window, q_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
