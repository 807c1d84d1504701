// RMSNorm for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/rmsnorm/kernel.py  rmsnorm_pallas
// out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale, statistics in
// fp32, the result rounded once to the input dtype.  x is [N, d] row-major,
// scale [d]; any N and any d are taken.
//
// One warp per row, eight rows per block of 256 threads.  A lane reads its
// share of the row with 16-byte vector loads when the row is aligned (d a
// multiple of 8 bf16 / 4 fp32 values), else element by element; the sum of
// squares is reduced across the warp with shuffles, and the second pass
// re-reads the row (from L1) to scale and store it.
//
// Bound at the serving shapes (Qwen2-0.5B, d = 896, bf16; H100 SXM data
// sheet, 3.35 TB/s): prefill [512, 896] moves 1.84 MB (x read once, out
// written once, scale) -> 0.55 us, bound by bytes (the 1.8 MFLOP of fp32
// arithmetic would take 0.03 us at 67 TFLOP/s); a decode tick's [8, 896]
// moves 30 KB -> 0.009 us, so there the launch itself is the cost.
// What this simple design leaves on the table: the row is read twice
// (the second read hits L1, not HBM), each warp owns one row, so the
// decode tick's 8 rows fill one block on one SM, and the kernel is not fused
// with the residual add or the next GEMM's prologue, which is where a
// normalisation's bytes can really be saved.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;              // rows (warps) per block
constexpr int THREADS = 32 * ROWS;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);        // round to nearest even, as torch
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int n, int d, float eps, int vec) {
  constexpr int V = 16 / sizeof(T);  // elements in a 16-byte vector
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * ROWS + warp;
  if (row >= n) return;              // the whole warp leaves together
  const T* xr = x + row * d;
  T* outr = out + row * d;

  float ss = 0.0f;
  if (vec) {
    for (int i = lane * V; i < d; i += 32 * V) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f(xr[i]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  if (vec) {
    for (int i = lane * V; i < d; i += 32 * V) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      uint4 sraw = *reinterpret_cast<const uint4*>(scale + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      const T* s = reinterpret_cast<const T*>(&sraw);
      uint4 oraw;
      T* o = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = from_f<T>(to_f(e[j]) * r * to_f(s[j]));
      *reinterpret_cast<uint4*>(outr + i) = oraw;
    }
  } else {
    for (int i = lane; i < d; i += 32)
      outr[i] = from_f<T>(to_f(xr[i]) * r * to_f(scale[i]));
  }
}

template <typename T>
int launch_rmsnorm(const void* x, const void* scale, void* out, int n, int d,
                   float eps, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  constexpr int V = 16 / sizeof(T);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
       reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const int vec = (aligned && d % V == 0) ? 1 : 0;
  const int blocks = (n + ROWS - 1) / ROWS;
  rmsnorm_kernel<T><<<blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(out), n, d, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rmsnorm_bf16(const void* x, const void* scale, void* out, int n, int d,
                 float eps, void* stream) {
  return launch_rmsnorm<__nv_bfloat16>(x, scale, out, n, d, eps, stream);
}

int rmsnorm_f32(const void* x, const void* scale, void* out, int n, int d,
                float eps, void* stream) {
  return launch_rmsnorm<float>(x, scale, out, n, d, eps, stream);
}

}  // extern "C"
