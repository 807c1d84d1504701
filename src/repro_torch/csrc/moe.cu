// Grouped expert SwiGLU MLP for Hopper (sm_90a): moe_gemm.
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/moe_gemm/kernel.py  moe_mlp_pallas
// For every expert e of the capacity buffers
//   out[e] = (silu(buf[e] @ gate[e]) * (buf[e] @ up[e])) @ down[e]
// with buf [E,C,d], gate and up [E,d,f], down [E,f,d], out [E,C,d], all
// row-major in one dtype (bf16 or fp32).  Products accumulate in fp32; h is
// formed in fp32 and rounded to the weights' dtype before the down GEMM, and
// the output is rounded once — where the JAX package's moe_mlp_ref rounds.
//
// The Pallas kernel keeps an fp32 accumulator [bc, d] across F tiles; at
// Kimi-K2's d = 7168 that is 28 KB per row, more than a block's shared
// memory holds for any useful number of rows.  So one wrapper call makes two
// launches of one tile routine:
//   stage 1  grid (f/BN, E): h[e, :, n0:n0+BN] = silu(buf[e] @ gate[e]) *
//            (buf[e] @ up[e]) over that column tile, written to a scratch
//            [E, C, f] the wrapper allocates;
//   stage 2  grid (d/BN, E): out[e, :, n0:n0+BN] = h[e] @ down[e].
// A block walks the reduction dimension in BK-deep stages: the BK x BN weight
// tile(s) go through shared memory (16-byte loads where aligned), the
// matching BK columns of up to ROWS activation rows too, and thread (col, rg)
// accumulates output column col for rows rg, rg + 4, ...  Each weight byte
// is read from device memory once per pass over the rows, and one pass covers
// up to 32 rows (the serving capacities are 1 at a decode tick and at most
// 18 at a 700-token prefill); rows past C, columns past the width and depths
// past the reduction length are masked, so any E, C, d and f are taken.  The
// rows per thread (1, 2, 4 or 8) are chosen from C at launch, so a decode
// tick's single row does not pay for 32.
//
// Bound (Kimi-K2: E 384, d 7168, f 2048, bf16; H100 SXM data sheet, 3.35
// TB/s, 989 TFLOP/s bf16): the expert stacks are 3 x 384 x 7168 x 2048 x 2 B
// = 33.8 GB, so 10.1 ms per call at any capacity up to a few hundred rows;
// a 512-token prefill (C = 13) does 2 x 3 x 384 x 13 x 7168 x 2048 = 0.44
// TFLOP, 0.44 ms.  Like the TPU kernel, it walks every expert, also those
// whose capacity rows are all zero (skipping them needs per-expert counts).
// What this simple design leaves on the table: FMA on the CUDA cores instead
// of tensor cores (fine while C is small, the weights dominate), no
// cp.async/TMA pipeline inside a block (loads and math overlap only across
// the several blocks an SM holds), and h makes a round trip through device
// memory (2 x E x C x f bytes, 20 MB at C = 13, small next to the weights).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;            // output columns per block
constexpr int BK = 64;            // reduction depth per shared-memory stage
constexpr int THREADS = 256;
constexpr int ROW_GROUPS = THREADS / BN;   // 4

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
  return __float2bfloat16(x);
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Copy the BK x BN tile of row-major w [K, N] at (k0, n0) into ws (BN
// elements per row), zero outside the matrix.
template <typename T>
__device__ void load_w_tile(T* __restrict__ ws, const T* __restrict__ w,
                            int k0, int n0, int K, int N, bool vec) {
  constexpr int V = 16 / sizeof(T);          // elements per 16-byte vector
  constexpr int VPR = BN / V;                // vectors per tile row
  for (int i = threadIdx.x; i < BK * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * V;
    const int k = k0 + r, n = n0 + c;
    T* dst = ws + r * BN + c;
    const T* src = w + static_cast<long long>(k) * N + n;
    if (vec && k < K && n + V <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        dst[e] = (k < K && n + e < N) ? src[e] : from_f<T>(0.0f);
    }
  }
}

// out[e, c, n] over one BN column tile of expert e = blockIdx.y:
//   GLU   silu(x @ w0) * (x @ w1), rounded to T   (stage 1, w0 gate, w1 up)
//   else  x @ w0, rounded to T                    (stage 2, w0 down)
// x [E, C, K], w0/w1 [E, K, N], out [E, C, N].  RPT rows per thread, so a
// pass covers ROW_GROUPS * RPT rows.
template <typename T, bool GLU, int RPT>
__global__ void __launch_bounds__(THREADS)
expert_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w0,
                   const T* __restrict__ w1, T* __restrict__ out, int C,
                   int K, int N, int vec) {
  constexpr int ROWS = ROW_GROUPS * RPT;
  __shared__ __align__(16) T w0s[BK * BN];
  __shared__ __align__(16) T w1s[GLU ? BK * BN : 1];
  __shared__ float xs[ROWS * BK];

  const int e = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  const int col = threadIdx.x % BN, rg = threadIdx.x / BN;
  const long long wo = static_cast<long long>(e) * K * N;
  const T* xe = x + static_cast<long long>(e) * C * K;
  T* oe = out + static_cast<long long>(e) * C * N;

  for (int c0 = 0; c0 < C; c0 += ROWS) {
    float acc0[RPT], acc1[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc0[r] = acc1[r] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();                       // the previous stage is consumed
      load_w_tile<T>(w0s, w0 + wo, k0, n0, K, N, vec != 0);
      if constexpr (GLU)
        load_w_tile<T>(w1s, w1 + wo, k0, n0, K, N, vec != 0);
      for (int i = threadIdx.x; i < ROWS * BK; i += THREADS) {
        const int r = i / BK, kk = i % BK;
        const int c = c0 + r, k = k0 + kk;
        xs[i] = (c < C && k < K)
                    ? to_f(xe[static_cast<long long>(c) * K + k]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float g = to_f(w0s[kk * BN + col]);
        float u = 0.0f;
        if constexpr (GLU) u = to_f(w1s[kk * BN + col]);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float xv = xs[(rg + ROW_GROUPS * r) * BK + kk];
          acc0[r] += xv * g;
          if constexpr (GLU) acc1[r] += xv * u;
        }
      }
    }
    const int n = n0 + col;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int c = c0 + rg + ROW_GROUPS * r;
      if (c >= C || n >= N) continue;
      float y = acc0[r];
      if constexpr (GLU) y = y / (1.0f + expf(-y)) * acc1[r];
      oe[static_cast<long long>(c) * N + n] = from_f<T>(y);
    }
  }
}

template <typename T, bool GLU>
cudaError_t launch_stage(const T* x, const T* w0, const T* w1, T* out, int E,
                         int C, int K, int N, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  bool vec = N % V == 0 && reinterpret_cast<uintptr_t>(w0) % 16 == 0;
  if constexpr (GLU) vec = vec && reinterpret_cast<uintptr_t>(w1) % 16 == 0;
  const dim3 grid(cdiv(N, BN), E);
  const int v = vec ? 1 : 0;
  if (C <= ROW_GROUPS)
    expert_gemm_kernel<T, GLU, 1><<<grid, THREADS, 0, s>>>(x, w0, w1, out, C,
                                                           K, N, v);
  else if (C <= 2 * ROW_GROUPS)
    expert_gemm_kernel<T, GLU, 2><<<grid, THREADS, 0, s>>>(x, w0, w1, out, C,
                                                           K, N, v);
  else if (C <= 4 * ROW_GROUPS)
    expert_gemm_kernel<T, GLU, 4><<<grid, THREADS, 0, s>>>(x, w0, w1, out, C,
                                                           K, N, v);
  else
    expert_gemm_kernel<T, GLU, 8><<<grid, THREADS, 0, s>>>(x, w0, w1, out, C,
                                                           K, N, v);
  return cudaGetLastError();
}

template <typename T>
int moe_mlp(const void* buf, const void* gate, const void* up,
            const void* down, void* h, void* out, int E, int C, int d, int f,
            void* stream) {
  if (E < 0 || C < 0 || d <= 0 || f <= 0 || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_stage<T, true>(
      static_cast<const T*>(buf), static_cast<const T*>(gate),
      static_cast<const T*>(up), static_cast<T*>(h), E, C, d, f, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_stage<T, false>(static_cast<const T*>(h),
                               static_cast<const T*>(down), nullptr,
                               static_cast<T*>(out), E, C, f, d, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int moe_mlp_bf16(const void* buf, const void* gate, const void* up,
                 const void* down, void* h, void* out, int E, int C, int d,
                 int f, void* stream) {
  return moe_mlp<__nv_bfloat16>(buf, gate, up, down, h, out, E, C, d, f,
                                stream);
}

int moe_mlp_f32(const void* buf, const void* gate, const void* up,
                const void* down, void* h, void* out, int E, int C, int d,
                int f, void* stream) {
  return moe_mlp<float>(buf, gate, up, down, h, out, E, C, d, f, stream);
}

}  // extern "C"
