// RMSNorm for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/rmsnorm/kernel.py  rmsnorm_pallas
// out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale, statistics in
// fp32, the result rounded once to the input dtype.  x is [N, d] row-major,
// scale [d]; any N and any d are taken.
//
// Bound at the serving shapes (H100 SXM data sheet, 3.35 TB/s): Qwen2's
// prefill [512, 896] bf16 moves 1.84 MB (x read once, out written once,
// scale) -> 0.55 us, bound by bytes (the fp32 arithmetic would take 0.03 us
// at 67 TFLOP/s); a decode tick's [8, 896] moves 30 KB -> 0.009 us.  At
// these sizes a launch is a chain of latencies (a load round trip, a
// reduction, a store), not a bandwidth problem, so the design cuts rounds
// and spreads each launch over the SMs.
//
// Two routes, chosen by the wrapper (kernels/rmsnorm/ops.py route()):
//
// onepass (d a multiple of the 16-byte vector, at most 2048 vectors a row,
// 16-byte aligned bases).  A team of TPR threads (32 .. 512, a power of
// two) owns a row, and each thread keeps VPT vectors of it in registers (a
// template parameter, 1 .. 4; the wrapper takes the narrowest team that
// holds the row at VPT <= 4: kernels/rmsnorm/kernel.py select_layout): the
// row is read from device memory once, every load of a thread is issued
// before the reduction, and the output is scaled from the registers.  The
// sum of squares is reduced with shuffles inside each warp and, for a team
// of several warps (d > 1024 in bf16, e.g. 8 warps a row at 7168), through
// shared memory.  A block holds max(TPR, 128) threads, so narrow rows share
// a block.  A thread loads its share of `scale` once and reuses it for
// every row its team takes (the grid is capped at one resident wave, past
// which teams stride over the rows).  x and out move with streaming
// (evict-first) loads and stores.  A throwaway sweep of every layout on
// the H100 (not in the repository) put the narrowest team at VPT <= 4
// fastest, or as fast as the fastest, at every serving width, 512 and 8
// rows; teams widened to spread a few rows over more SMs, and VPT 8, were
// slower.
//
// simple (other shapes, e.g. d = 14; also forced by rmsnorm_simple for a
// comparison): the first port's routine, one warp a row and eight rows a
// block; a lane reads its share of the row with 16-byte loads where aligned
// (element by element otherwise), the sum of squares is reduced with
// shuffles, and a second pass re-reads the row (from L1) to scale and store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// =============================================================================
// simple route: one warp per row
// =============================================================================
namespace simple {

constexpr int ROWS = 8;              // rows (warps) per block
constexpr int THREADS = 32 * ROWS;

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
int launch(const void* x, const void* scale, void* out, int n, int d,
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

}  // namespace simple

// =============================================================================
// onepass route: the row in registers
// =============================================================================
namespace onepass {

constexpr int MIN_BLOCK = 128;       // threads of a block, at least
constexpr int MAX_TPR = 512;         // 128 registers a thread: VPT 4 fits
constexpr int MAX_VPT = 4;
constexpr int RESIDENT_THREADS = 2048;   // an SM's resident threads

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Team t = threadIdx.x / tpr of block b owns rows b * R + t, + gridDim.x * R,
// ... (R = blockDim.x / tpr); thread q of a team holds vectors j * tpr + q,
// j < VPT, of its row and of scale.
template <typename T, int VPT>
__global__ void __launch_bounds__(MAX_TPR)
rmsnorm_rows_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    T* __restrict__ out, int n, int d, float eps, int tpr) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float partial[2][MAX_TPR / 32];   // by iteration parity
  const int nvec = d / V;
  const int rows_per_block = blockDim.x / tpr;
  const int team = threadIdx.x / tpr, q = threadIdx.x % tpr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int team_warps = tpr / 32;

  uint4 sv[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = j * tpr + q;
    sv[j] = v < nvec ? __ldg(reinterpret_cast<const uint4*>(scale) + v)
                     : make_uint4(0u, 0u, 0u, 0u);
  }
  // every thread of the block runs the same iterations (the shared-memory
  // reduction synchronises the block); a team past the last row is masked
  const long long stride = static_cast<long long>(gridDim.x) * rows_per_block;
  int parity = 0;
  for (long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
       r0 < n; r0 += stride, parity ^= 1) {
    const long long row = r0 + team;
    const bool live = row < n;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    uint4 xv[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = j * tpr + q;
      xv[j] = live && v < nvec ? load_stream(xr + v)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const T* e = reinterpret_cast<const T*>(&xv[j]);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float f = to_f(e[i]);
        ss += f * f;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (team_warps > 1) {
      if (lane == 0) partial[parity][warp] = ss;
      __syncthreads();
      ss = 0.0f;
      for (int w = 0; w < team_warps; ++w)
        ss += partial[parity][team * team_warps + w];
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    if (!live) continue;
    uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = j * tpr + q;
      if (v >= nvec) continue;
      const T* e = reinterpret_cast<const T*>(&xv[j]);
      const T* s = reinterpret_cast<const T*>(&sv[j]);
      uint4 ov;
      T* o = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int i = 0; i < V; ++i)
        o[i] = from_f<T>(to_f(e[i]) * r * to_f(s[i]));
      store_stream(orow + v, ov);
    }
  }
}

template <typename T, int VPT>
cudaError_t launch_vpt(const void* x, const void* scale, void* out, int n,
                       int d, float eps, int tpr, int sms,
                       cudaStream_t stream) {
  const int block = tpr > MIN_BLOCK ? tpr : MIN_BLOCK;
  const int rows_per_block = block / tpr;
  const long long need = (static_cast<long long>(n) + rows_per_block - 1) /
                         rows_per_block;
  const long long wave = static_cast<long long>(sms) *
                         (RESIDENT_THREADS / block);
  const int grid = static_cast<int>(need < wave ? need : wave);
  rmsnorm_rows_kernel<T, VPT><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(out), n, d, eps, tpr);
  return cudaGetLastError();
}

// `tpr` and `vpt` from the wrapper's select_layout; `sms` caps the grid at
// one resident wave.
template <typename T>
int launch(const void* x, const void* scale, void* out, int n, int d,
           float eps, int tpr, int vpt, int sms, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  constexpr int V = 16 / sizeof(T);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
       reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (!aligned || d % V != 0 || tpr < 32 || tpr > MAX_TPR ||
      (tpr & (tpr - 1)) != 0 || vpt < 1 || vpt > MAX_VPT ||
      static_cast<long long>(tpr) * vpt < d / V || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (vpt) {
    case 1: err = launch_vpt<T, 1>(x, scale, out, n, d, eps, tpr, sms, s);
      break;
    case 2: err = launch_vpt<T, 2>(x, scale, out, n, d, eps, tpr, sms, s);
      break;
    case 3: err = launch_vpt<T, 3>(x, scale, out, n, d, eps, tpr, sms, s);
      break;
    default: err = launch_vpt<T, 4>(x, scale, out, n, d, eps, tpr, sms, s);
  }
  return static_cast<int>(err);
}

}  // namespace onepass

}  // namespace

extern "C" {

int rmsnorm_bf16(const void* x, const void* scale, void* out, int n, int d,
                 float eps, int tpr, int vpt, int sms, void* stream) {
  return onepass::launch<__nv_bfloat16>(x, scale, out, n, d, eps, tpr, vpt,
                                        sms, stream);
}

int rmsnorm_f32(const void* x, const void* scale, void* out, int n, int d,
                float eps, int tpr, int vpt, int sms, void* stream) {
  return onepass::launch<float>(x, scale, out, n, d, eps, tpr, vpt, sms,
                                stream);
}

int rmsnorm_simple_bf16(const void* x, const void* scale, void* out, int n,
                        int d, float eps, void* stream) {
  return simple::launch<__nv_bfloat16>(x, scale, out, n, d, eps, stream);
}

int rmsnorm_simple_f32(const void* x, const void* scale, void* out, int n,
                       int d, float eps, void* stream) {
  return simple::launch<float>(x, scale, out, n, d, eps, stream);
}

}  // extern "C"
