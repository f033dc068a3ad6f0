// fm_interaction: the second-order term of a factorization machine on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/fm_interaction/fm_interaction.py:
// _kernel (pallas_call in fm_interaction_pallas).  For embeddings e (B, F, D),
// float32, bfloat16 or float16 (cast to float32 on load):
//   out[b] = 0.5 * sum_d [ (sum_f e[b,f,d])^2 - sum_f e[b,f,d]^2 ]
// in float32.  The sum-square trick cancels, so s and sq are float32 and are
// subtracted per d before the sum over d, as the reference does.
//
// The TPU kernel reduces a (Bb, F, D) block held in VMEM with three vector
// reductions.  Here one block takes ex = 256 / D consecutive examples (one
// when D >= 256), and each thread one (example, d) pair: it walks the F
// fields of its column (stride D), keeping s and sq in registers, and
// leaves s*s - sq in shared memory.  Then one thread per example adds its D
// partials in order.  No atomics: every sum has a fixed order, so a result
// is bitwise the same from launch to launch.  Any B, F and D (D up to
// kMaxDim) is taken; the ragged last block is masked.
//
// Bound: memory.  The function reads B*F*D inputs once and writes B floats,
// against 3 flops per input (at F=39, D=10 in float32: 0.77 flop per byte).
// The lanes of a warp cover about 32/D examples, so one load instruction
// touches a few 4*D-byte pieces of rows that lie F*D*4 bytes apart; the next
// field's load reuses those cache lines from L1, so each input byte comes
// from device memory about once.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 12288;  // ex * D partials stay within 48 KB

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load(const __half* p) {
  return __half2float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fm_kernel(const T* __restrict__ emb, float* __restrict__ out, long long b,
          int f, int d, int ex) {
  extern __shared__ float part[];  // (ex, d): s*s - sq per example and d
  const long long b0 = (long long)blockIdx.x * ex;
  const long long row = (long long)f * d;
  for (int p = threadIdx.x; p < ex * d; p += blockDim.x) {
    const int e = p / d;
    const int j = p - e * d;
    float t = 0.f;
    if (b0 + e < b) {
      const T* x = emb + (b0 + e) * row + j;
      float s = 0.f, sq = 0.f;
      for (int i = 0; i < f; ++i) {
        const float v = load(x + (long long)i * d);
        s += v;
        sq += v * v;
      }
      t = s * s - sq;
    }
    part[p] = t;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ex && b0 + e < b; e += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < d; ++j) acc += part[e * d + j];
    out[b0 + e] = 0.5f * acc;
  }
}

}  // namespace

extern "C" int fm_interaction_max_dim() { return kMaxDim; }

template <typename T>
void launch(const void* emb, void* out, long long b, int f, int d, int ex,
            long long blocks, size_t smem, cudaStream_t s) {
  fm_kernel<T><<<(unsigned)blocks, kThreads, smem, s>>>(
      static_cast<const T*>(emb), static_cast<float*>(out), b, f, d, ex);
}

// emb (b, f, d) contiguous, float32 (dtype 0), bfloat16 (1) or float16 (2);
// out (b,) float32.  Returns the CUDA error of the launch (0 on success).
extern "C" int fm_interaction_launch(const void* emb, void* out, long long b,
                                     int f, int d, int dtype, void* stream) {
  if (b <= 0) return 0;
  if (d < 1 || d > kMaxDim || f < 0) return (int)cudaErrorInvalidValue;
  const int ex = d >= kThreads ? 1 : kThreads / d;
  const long long blocks = (b + ex - 1) / ex;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ex * d * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(emb, out, b, f, d, ex, blocks, smem, s); break;
    case 1: launch<__nv_bfloat16>(emb, out, b, f, d, ex, blocks, smem, s);
            break;
    case 2: launch<__half>(emb, out, b, f, d, ex, blocks, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
