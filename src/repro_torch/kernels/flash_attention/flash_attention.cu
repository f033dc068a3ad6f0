// flash_attention: blocked online-softmax attention (forward) on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py:
// _kernel (pallas_call in flash_attention_pallas).  For q (B, H, Sq, D),
// k (B, Hkv, Skv, D) and v (B, Hkv, Skv, Dv) in float32, bfloat16 or float16:
//   o[b, h, i] = softmax_j(q[b,h,i] . k[b,g,j] / sqrt(D)) v[b,g,j]
// (o is (B, H, Sq, Dv); Dv = D but for MLA, whose queries and keys are 192
// wide and its values 128, as the reference's chunked_attention allows)
// with g = h / (H / Hkv) (GQA: the kv head of query head h, never copied to
// H heads), over the keys j that are visible to query position
// i + q_offset: j <= i + q_offset when causal, and j > i + q_offset - window
// when window > 0.  A row that sees no key is 0, as in the Pallas kernel.
// The output has q's type; softmax and sums are float32.
//
// Both kernels below run one block per (b*h, tile of 64 queries) and loop
// over kv tiles with a running (m, l, acc) per query row in registers, as
// the TPU kernel's sequential kv grid axis does in VMEM scratch.  KV tiles
// that are wholly masked (the causal and window tests of
// flash_attention.py:40-44) are not visited, the blocks of every head's last
// (heaviest causal) query tile are issued first, rows past Sq are not stored
// and keys past Skv are masked.  Every sum has a fixed order, so a result
// is bitwise the same from launch to launch.
//
// Bound: operations.  At Gemma-3 1B's global layer (B=4, H=4, Hkv=1,
// Sq=Skv=4096, D=256, bfloat16, causal) 4*D flops for each of the 8,390,656
// visible (query, key) pairs per head: 137.47 GFLOP, 0.139 ms at the bf16
// tensor-core rate (989 TFLOP/s), against 84 MB of inputs and output
// (0.025 ms at 3.35 TB/s).  At DeepSeek-V2-Lite's MLA prefill layer (B=4,
// H=Hkv=16, S=4096, D=192, Dv=128) 2*D + 2*Dv flops a pair: 343.68 GFLOP,
// 0.348 ms, against 336 MB (0.100 ms).
//
// flash_kernel_tc (bfloat16, float16): FlashAttention-2 on the tensor cores.
// Four warps own 16 query rows each.  Per kv tile of kTcBk keys:
//   - S = q k^T with mma.sync m16n8k16 (input-type operands read from shared
//     memory with ldmatrix, float32 accumulators), then scaled by 1/sqrt(D)
//     in float32 (exact where that is a power of two, as at D = 16, 64 or
//     256), masked, and folded into the online softmax with the
//     Pallas kernel's -inf guards (m_safe, corr, l_safe); exp(x) is taken
//     as exp2(x log2 e), and acc is not rescaled when no row's max moved
//     (every factor exactly 1);
//   - P never leaves registers: the accumulator layout of m16n8k16 is its
//     A-operand layout.  P is split into P_hi = round(P) and P_lo =
//     round(P - P_hi) in the input type, and both are multiplied with the
//     same V fragments (ldmatrix.trans) into the float32 accumulator.  P then
//     keeps about 16 bits where one rounding keeps 8 (bfloat16): the output
//     stays within one step of its own rounding of the float32 plain version,
//     where one rounding of P is 10-100 times off.  The price is a second
//     P V product: 6*D flops per visible pair, 1.5x the bound's count.
//   - K and V come in with cp.async (16 B where the row's byte width and the
//     base pointer allow, 8 or 4 B otherwise, plain loads at an odd D in
//     16-bit types) into a ring of two stages, so the next tile's copy runs
//     while this tile is multiplied; keys past Skv are zero-filled.
//   - Rows of the q, K and V tiles are zero-padded to DP, a multiple of 16
//     at least max(D, Dv) (D = 8 and 36 work), plus 16 bytes, so
//     ldmatrix's eight rows fall in distinct banks.  kTcBk is 64, and 32 at
//     DP = 256, where the float32 accumulator alone is 128 registers a
//     thread: 101 KB of shared memory, two blocks (8 warps) per SM.  MLA
//     (D = 192, Dv = 128) runs the DP = 256 instantiation: its products run
//     over the zero columns too (a 192-wide one is later speed work).
// Against the CUDA-core kernel it replaced for these types (8.06 ms at the
// layer above on an H100 80GB HBM3 at 700 W; this one takes 0.87 ms there):
// products on tensor cores instead of float32 FMAs, copies that overlap the
// products instead of synchronous loads between two barriers, P in
// registers instead of a round trip through shared memory, and two blocks
// per SM instead of one at D = 256.  At D = 256 it uses all 255 registers
// and so runs 8 warps per SM; it is bound by their latency, not by the
// tensor cores (ablation.py measures each part).  wgmma with TMA and warp
// specialisation is the next step.
//
// flash_kernel (float32): the same algorithm on CUDA cores, everything in
// float32 (TF32 would not keep float32's precision).  One block of 256
// threads in 16 row groups of 16 lanes; a row group owns 4 query rows.  For
// each kv tile, K and V are copied into shared memory, each lane computes a
// 4 x 4 block of S = (q / sqrt(D)) k^T from a float32 q tile scaled once,
// P goes through shared memory, and each lane adds P V into its 4 x (Dv / 16)
// slice of acc.  Shared memory: 214 KB at D = Dv = 256, one block per SM.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // keys per kv tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kRows = 4;       // query rows per row group (kBq / 16)
constexpr int kCols = 4;       // score columns per lane (kBk / 16)
constexpr int kMaxDim = 256;
constexpr int kLdp = kBk + 1;  // row stride of the P tile (floats)

__device__ __forceinline__ float to_f(float x) { return x; }

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

__host__ __device__ inline size_t smem_bytes(int d, int dv, int elem_bytes) {
  return (size_t)kBq * (d + 1) * 4 + (size_t)kBq * kLdp * 4 +
         (size_t)kBk * k_stride(d, elem_bytes) * elem_bytes +
         (size_t)kBk * dv * elem_bytes;
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

// DPT: output columns per lane, 16 * DPT >= Dv.
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int h, int hkv, int sq, int skv, int d,
             int dv, int causal, int window, int q_offset, float scale,
             int bhs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldq = d + 1;
  const int ldk = k_stride(d, sizeof(T));
  float* qs = reinterpret_cast<float*>(smem);        // (kBq, ldq)
  float* ps = qs + kBq * ldq;                        // (kBq, kLdp)
  T* ks = reinterpret_cast<T*>(ps + kBq * kLdp);     // (kBk, ldk)
  T* vs = ks + kBk * ldk;                            // (kBk, dv)

  // the last query tiles of a causal head do the most work: the blocks of
  // every head's last tile come first, then those of the tile before it
  const int nq = (sq + kBq - 1) / kBq;
  const int bh = (int)(blockIdx.x % bhs);
  const int qt = nq - 1 - (int)(blockIdx.x / bhs);
  const int group = h / hkv;
  const int kvh = (bh / h) * hkv + (bh % h) / group;
  const T* qp = q + (size_t)bh * sq * d;
  const T* kp = k + (size_t)kvh * skv * d;
  const T* vp = v + (size_t)kvh * skv * dv;
  T* op = o + (size_t)bh * sq * dv;
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
      ks[r * ldk + c] =
          k0 + r < skv ? kp[(size_t)(k0 + r) * d + c] : from_f<T>(0.f);
    }
    for (int idx = tid; idx < kBk * dv; idx += kThreads) {
      const int r = idx / dv;
      const int c = idx - r * dv;
      vs[r * dv + c] =
          k0 + r < skv ? vp[(size_t)(k0 + r) * dv + c] : from_f<T>(0.f);
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
        const float vv = col < dv ? to_f(vs[c * dv + col]) : 0.f;
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
      if (col < dv)
        op[(size_t)(q0 + r) * dv + col] = from_f<T>(acc[i][jj] / l_safe);
    }
    if (lse != nullptr && cl == 0)
      lse[(size_t)bh * sq + q0 + r] =
          l[i] == 0.f ? -INFINITY : m[i] + logf(l[i]);
  }
}

template <typename T, int DPT>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int h, int hkv, int sq, int skv, int d, int dv, int causal,
           int window, int q_offset, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, dv, sizeof(T));
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, h, hkv, sq, skv, d,
      dv, causal, window, q_offset, scale, b * h);
  return (int)cudaGetLastError();
}

// DPT sizes only the output columns, so the CUDA-core kernel is picked by
// Dv (the q k^T loop runs over D at run time).
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int b, int h, int hkv, int sq, int skv, int d, int dv,
             int causal, int window, int q_offset, cudaStream_t s) {
  if (dv <= 16)
    return launch<T, 1>(q, k, v, o, lse, b, h, hkv, sq, skv, d, dv,
                        causal, window, q_offset, s);
  if (dv <= 32)
    return launch<T, 2>(q, k, v, o, lse, b, h, hkv, sq, skv, d, dv,
                        causal, window, q_offset, s);
  if (dv <= 64)
    return launch<T, 4>(q, k, v, o, lse, b, h, hkv, sq, skv, d, dv,
                        causal, window, q_offset, s);
  if (dv <= 128)
    return launch<T, 8>(q, k, v, o, lse, b, h, hkv, sq, skv, d, dv,
                        causal, window, q_offset, s);
  return launch<T, 16>(q, k, v, o, lse, b, h, hkv, sq, skv, d, dv, causal,
                       window, q_offset, s);
}

// ---------------------------------------------------------------------------
// bfloat16 and float16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcBq = 16 * kTcWarps;  // query rows per block, 16 per warp
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one copy of N bytes into shared memory; the bytes past src_bytes are zeros
template <int N>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src,
                                         int src_bytes) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(N), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a b for one m16n8k16 tile, float32 accumulators
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4],
                                                   const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T2>
__device__ __forceinline__ uint32_t bits(T2 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) rounded to the input type, packed as one 32-bit operand register
template <typename T>
__device__ __forceinline__ uint32_t pack(float x, float y);
template <>
__device__ __forceinline__ uint32_t pack<__nv_bfloat16>(float x, float y) {
  return bits(__floats2bfloat162_rn(x, y));
}
template <>
__device__ __forceinline__ uint32_t pack<__half>(float x, float y) {
  return bits(__floats2half2_rn(x, y));
}

// (x, y) = hi + lo with hi the rounding of (x, y) to the input type and lo
// the rounding of the remainder (x - hi is exact in float32)
template <typename T>
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo);
template <>
__device__ __forceinline__ void split<__nv_bfloat16>(float x, float y,
                                                     uint32_t& hi,
                                                     uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}
template <>
__device__ __forceinline__ void split<__half>(float x, float y, uint32_t& hi,
                                              uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x, y);
  const float2 hf = __half22float2(h);
  hi = bits(h);
  lo = bits(__floats2half2_rn(x - hf.x, y - hf.y));
}

// The largest copy, in bytes, that divides both a row of d elements and the
// alignment of p: 16, 8 or 4 (cp.async), else 2 (plain loads and stores).
inline int vec_bytes(const void* p, int d, int elem_bytes) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(p);
  for (int v = 16; v >= 4; v /= 2)
    if ((d * elem_bytes) % v == 0 && a % v == 0) return v;
  return 2;
}

// rows [0, rows) of a (rows, d) tile at src into shared memory with row
// stride LD, zero-filled past `valid` rows and past column d up to DP
template <typename T, int DP, int LD, int VEC>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int rows,
                                          int valid, int d) {
  constexpr int kPer = VEC / (int)sizeof(T);  // elements per copy
  constexpr int kCpr = DP / kPer;              // copies per row
  for (int idx = threadIdx.x; idx < rows * kCpr; idx += kTcThreads) {
    const int r = idx / kCpr;
    const int c = (idx - r * kCpr) * kPer;
    const bool in = r < valid && c < d;
    if constexpr (VEC >= 4) {
      cp_async<VEC>(smem_u32(dst + r * LD + c),
                    in ? src + (size_t)r * d + c : src, in ? VEC : 0);
    } else {
      dst[r * LD + c] = in ? src[(size_t)r * d + c] : from_f<T>(0.f);
    }
  }
}

template <typename T, int DP, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows,
                                          int valid, int d, int vec) {
  switch (vec) {
    case 16: load_rows<T, DP, LD, 16>(dst, src, rows, valid, d); break;
    case 8: load_rows<T, DP, LD, 8>(dst, src, rows, valid, d); break;
    case 4: load_rows<T, DP, LD, 4>(dst, src, rows, valid, d); break;
    default: load_rows<T, DP, LD, 2>(dst, src, rows, valid, d); break;
  }
}

// rows [0, valid) of a warp's 16 staged output rows to global memory
template <typename T, int DP, int LD, int VEC>
__device__ __forceinline__ void store_rows(T* dst, const T* src, int valid,
                                           int d, int lane) {
  constexpr int kPer = VEC / (int)sizeof(T);
  constexpr int kCpr = DP / kPer;
  for (int idx = lane; idx < 16 * kCpr; idx += 32) {
    const int r = idx / kCpr;
    const int c = (idx - r * kCpr) * kPer;
    if (r >= valid || c >= d) continue;
    const T* s = src + r * LD + c;
    T* g = dst + (size_t)r * d + c;
    if constexpr (VEC == 16)
      *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(s);
    else if constexpr (VEC == 8)
      *reinterpret_cast<uint2*>(g) = *reinterpret_cast<const uint2*>(s);
    else if constexpr (VEC == 4)
      *reinterpret_cast<uint32_t*>(g) = *reinterpret_cast<const uint32_t*>(s);
    else
      *g = *s;
  }
}

template <typename T, int DP, int BK>
constexpr size_t tc_smem_bytes() {
  return (size_t)(kTcBq + 4 * BK) * (DP + 8) * sizeof(T);
}

// DP: max(D, Dv) padded to a multiple of 16; BK: keys per kv tile.
template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kTcThreads)
flash_kernel_tc(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, int h, int hkv, int sq, int skv,
                int d, int dv, int causal, int window, int q_offset,
                float scale, int bhs, int vec_q, int vec_k, int vec_v,
                int vec_o) {
  constexpr int LD = DP + 8;     // row stride in elements: 16 B of padding
  constexpr int NT = BK / 8;     // n8 tiles of S per warp
  constexpr int DT = DP / 8;     // n8 tiles of the output per warp
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);    // (kTcBq, LD)
  T* ks = qs + kTcBq * LD;               // 2 stages of (BK, LD)
  T* vs = ks + 2 * BK * LD;              // 2 stages of (BK, LD)

  const int nq = (sq + kTcBq - 1) / kTcBq;
  const int bh = (int)(blockIdx.x % bhs);
  const int qt = nq - 1 - (int)(blockIdx.x / bhs);
  const int group = h / hkv;
  const int kvh = (bh / h) * hkv + (bh % h) / group;
  const T* qp = q + (size_t)bh * sq * d;
  const T* kp = k + (size_t)kvh * skv * d;
  const T* vp = v + (size_t)kvh * skv * dv;
  T* op = o + (size_t)bh * sq * dv;
  const int q0 = qt * kTcBq;
  const int qrows = min(kTcBq, sq - q0);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // accumulator rows g and g + 8
  const int t4 = lane & 3;  // accumulator columns 2*t4, 2*t4 + 1

  // kv tiles with a visible key for some row of this block
  const int qpos_first = q0 + q_offset;
  const int qpos_last = q0 + qrows - 1 + q_offset;
  const int nk = (skv + BK - 1) / BK;
  int kt_begin = 0, kt_end = nk;
  if (window > 0 && qpos_first - window + 1 > 0)
    kt_begin = (qpos_first - window + 1) / BK;
  if (causal) kt_end = qpos_last < 0 ? 0 : min(nk, qpos_last / BK + 1);

  load_tile<T, DP, LD>(qs, qp + (size_t)q0 * d, kTcBq, qrows, d, vec_q);
  if (kt_begin < kt_end) {
    const size_t row = (size_t)kt_begin * BK;
    const int valid = min(BK, skv - kt_begin * BK);
    load_tile<T, DP, LD>(ks, kp + row * d, BK, valid, d, vec_k);
    load_tile<T, DP, LD>(vs, vp + row * dv, BK, valid, dv, vec_v);
  }
  cp_async_commit();

  // ldmatrix row addresses of this lane: q as the A operand of S, K as its
  // B operand (keys are columns of S), V transposed as the B operand of P V
  const unsigned q_addr =
      smem_u32(qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const unsigned k_addr = smem_u32(
      ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8);
  const unsigned v_addr = smem_u32(vs + (lane & 15) * LD + (lane >> 4) * 8);
  constexpr unsigned kStage = BK * LD * sizeof(T);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int qpos0 = q0 + warp * 16 + g + q_offset;  // row g; row g + 8 is +8

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {  // the next tile's copy overlaps this tile's work
      const size_t row = (size_t)(kt + 1) * BK;
      const int valid = min(BK, skv - (kt + 1) * BK);
      load_tile<T, DP, LD>(ks + (st ^ 1) * BK * LD, kp + row * d, BK, valid, d,
                           vec_k);
      load_tile<T, DP, LD>(vs + (st ^ 1) * BK * LD, vp + row * dv, BK, valid,
                           dv, vec_v);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the copy just issued has landed
    __syncthreads();

    // S = q k^T, float32 accumulators
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const unsigned kb = k_addr + st * kStage;
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) {
      uint32_t a[4];
      ldsm_x4(a, q_addr + kd * 32);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, kb + np * 16 * LD * (unsigned)sizeof(T) + kd * 32);
        mma<T>(s[2 * np], a, b[0], b[1]);
        mma<T>(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // scale, mask, online softmax (the Pallas kernel's -inf guards)
    const int k0 = kt * BK;
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > qpos_first) ||
                      (window > 0 && k0 <= qpos_last - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int kpos = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qpos = qpos0 + 8 * (e >> 1);
          if (kpos >= skv || (causal && kpos > qpos) ||
              (window > 0 && kpos <= qpos - window))
            x = -INFINITY;
        }
        s[j][e] = x;
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mc = fmaxf(mc, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float m_new = fmaxf(m[r], mc);
      // rows with everything masked keep m = -inf: guard exp(-inf - -inf)
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p =
              s[j][e] == -INFINITY ? 0.f : exp2f((s[j][e] - m_safe) * kLog2e);
          s[j][e] = p;
          psum += p;
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      corr[r] = m[r] == -INFINITY ? 0.f : exp2f((m[r] - m_safe) * kLog2e);
      l[r] = corr[r] * l[r] + psum;
      m[r] = m_new;
    }
    // a factor of exactly 1 (no row's max moved) leaves acc as it is
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    }

    // acc += P_hi V + P_lo V: P's accumulator registers are the A operand
    const unsigned vb = v_addr + st * kStage;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split<T>(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split<T>(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split<T>(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split<T>(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vb + kk * 16 * LD * (unsigned)sizeof(T) + dp * 32);
        mma<T>(acc[2 * dp], hi, b[0], b[1]);
        mma<T>(acc[2 * dp + 1], hi, b[2], b[3]);
        mma<T>(acc[2 * dp], lo, b[0], b[1]);
        mma<T>(acc[2 * dp + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();  // q's copy, when no tile was visited
  __syncthreads();

  // o = acc / l, staged in this warp's own q rows, then stored row by row
  T* stage = qs + warp * 16 * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * r) * LD + j * 8 +
                                   2 * t4) =
          pack<T>(acc[j][2 * r] / l_safe, acc[j][2 * r + 1] / l_safe);
    const int row = warp * 16 + g + 8 * r;
    if (lse != nullptr && t4 == 0 && row < qrows)
      lse[(size_t)bh * sq + q0 + row] =
          l[r] == 0.f ? -INFINITY : m[r] + logf(l[r]);
  }
  __syncwarp();
  T* orow = op + (size_t)(q0 + warp * 16) * dv;
  const int valid = min(16, qrows - warp * 16);
  switch (vec_o) {
    case 16: store_rows<T, DP, LD, 16>(orow, stage, valid, dv, lane); break;
    case 8: store_rows<T, DP, LD, 8>(orow, stage, valid, dv, lane); break;
    case 4: store_rows<T, DP, LD, 4>(orow, stage, valid, dv, lane); break;
    default: store_rows<T, DP, LD, 2>(orow, stage, valid, dv, lane); break;
  }
}

template <typename T, int DP, int BK>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int b, int h, int hkv, int sq, int skv, int d,
              int dv, int causal, int window, int q_offset,
              cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<T, DP, BK>();
  auto kern = flash_kernel_tc<T, DP, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (sq + kTcBq - 1) / kTcBq;
  const long long blocks = (long long)b * h * nq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / std::sqrt((double)d));
  const int es = (int)sizeof(T);
  kern<<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, h, hkv, sq, skv, d,
      dv, causal, window, q_offset, scale, b * h, vec_bytes(q, d, es),
      vec_bytes(k, d, es), vec_bytes(v, dv, es), vec_bytes(o, dv, es));
  return (int)cudaGetLastError();
}

// The instantiation is picked by max(D, Dv): its tiles hold both widths.
template <typename T>
int dispatch_tc(const void* q, const void* k, const void* v, void* o,
                float* lse, int b, int h, int hkv, int sq, int skv, int d,
                int dv, int causal, int window, int q_offset, cudaStream_t s) {
  const int w = std::max(d, dv);
  if (w <= 16)
    return launch_tc<T, 16, 64>(q, k, v, o, lse, b, h, hkv, sq, skv, d,
                                dv, causal, window, q_offset, s);
  if (w <= 32)
    return launch_tc<T, 32, 64>(q, k, v, o, lse, b, h, hkv, sq, skv, d,
                                dv, causal, window, q_offset, s);
  if (w <= 64)
    return launch_tc<T, 64, 64>(q, k, v, o, lse, b, h, hkv, sq, skv, d,
                                dv, causal, window, q_offset, s);
  if (w <= 128)
    return launch_tc<T, 128, 64>(q, k, v, o, lse, b, h, hkv, sq, skv, d,
                                 dv, causal, window, q_offset, s);
  return launch_tc<T, 256, 32>(q, k, v, o, lse, b, h, hkv, sq, skv, d, dv,
                               causal, window, q_offset, s);
}

}  // namespace

extern "C" int flash_attention_max_head_dim() { return kMaxDim; }

// q (b, h, sq, d), k (b, hkv, skv, d), v (b, hkv, skv, dv), o (b, h, sq,
// dv); all contiguous, of one type: dtype 0 float32, 1 bfloat16, 2 float16.
// lse, where not null, is (b, h, sq) float32: each row's log-sum-exp of its
// scaled scores, m + log(l), -inf for a row that sees no key (the backward
// kernel recomputes P from it).  Returns the CUDA error of the launch (0 on
// success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int b, int h, int hkv, int sq, int skv,
                                      int d, int dv, int causal, int window,
                                      int q_offset, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return 0;
  if (d < 1 || d > kMaxDim || dv < 1 || dv > kMaxDim || hkv < 1 ||
      h % hkv != 0 || skv < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, o, lse, b, h, hkv, sq, skv, d, dv,
                             causal, window, q_offset, s);
    case 1:
      return dispatch_tc<__nv_bfloat16>(q, k, v, o, lse, b, h, hkv, sq, skv, d,
                                        dv, causal, window, q_offset, s);
    case 2:
      return dispatch_tc<__half>(q, k, v, o, lse, b, h, hkv, sq, skv, d, dv,
                                 causal, window, q_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
