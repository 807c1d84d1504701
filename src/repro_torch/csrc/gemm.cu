// Fused multi-branch GEMMs for Hopper (sm_90a): branch_gemm and grouped_gemm.
//
// Replaces the JAX package's Pallas TPU kernels
//   src/repro/kernels/branch_gemm/kernel.py  branch_gemm_pallas
//   src/repro/kernels/grouped_gemm/kernel.py grouped_gemm_pallas
// Both compute out = x @ w per branch with fp32 accumulation and store the
// result in the input dtype.  One tile routine serves both entry points; they
// differ only in how a block finds its rows and its weight:
//   branch_gemm   grid (F/BN, M/BM, N): branch = blockIdx.z, equal M for all
//                 branches, x [N,M,K] @ w [N,K,F] -> [N,M,F].
//   grouped_gemm  grid (F/BN, T): row tile t = blockIdx.y reads the device
//                 table entry (group, row_start, row_end) built once when the
//                 step is lowered; x [sum M, K] holds the groups' rows back to
//                 back with no padding, the tile reads w[group] and masks the
//                 rows past its group's end.  A zero-row group has no tiles.
// Every load and store is masked, so any M, K, F is taken as it is.
//
// Bound at the main path's shapes (Qwen2-0.5B prefill, batch 1, seq 512, bf16,
// H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s):
//   gate||up  [2,512,896] @ [2,896,4864]: 8.93 GFLOP -> 9.0 us; 29.2 MB -> 8.7 us
//             so about 9.0 us, bound by operations.
//   wk||wv    [2,512,896] @ [2,896,128]:  0.235 GFLOP -> 0.24 us; 2.56 MB ->
//             0.76 us, bound by bytes.
// What this simple design leaves on the table: it runs warp-level WMMA
// (mma.sync, 16x16x16 bf16) instead of warpgroup wgmma, stages each K tile
// through registers with no cp.async/TMA pipeline (loads and math do not
// overlap inside a block), and uses 64x64 output tiles, which for wk||wv
// (F = 128) gives 32 blocks for 132 SMs.  The fp32 path (f32 graphs only) is
// plain FMA.  wgmma + TMA + a multi-stage ring are a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows of an output tile (kernel.py TILE_M)
constexpr int BN = 64;   // columns of an output tile
constexpr int THREADS = 128;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---- bf16: WMMA 16x16x16 fragments, 4 warps in a 2x2 grid of 32x32 ---------
constexpr int BK16 = 32;
constexpr int A_LD = BK16 + 8;   // padded leading dims; multiples of 8 keep
constexpr int B_LD = BN + 8;     // every fragment pointer 32-byte aligned
constexpr int C_LD = BN + 4;

__device__ __forceinline__ void load_chunk8(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            int valid) {
  // copy 8 consecutive elements; `valid` of them exist, the rest are zero
  if (valid >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    dst[e] = e < valid ? src[e] : __float2bfloat16(0.0f);
}

__device__ void tile_gemm(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          __nv_bfloat16* __restrict__ out,
                          int row0, int row_end, int K, int F, int col0) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK16 * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK16) {
    // A tile [BM, BK16]: 256 chunks of 8, two per thread
    for (int c = tid; c < BM * BK16 / 8; c += THREADS) {
      const int r = c / (BK16 / 8), kc = (c % (BK16 / 8)) * 8;
      const int gr = row0 + r, gk = k0 + kc;
      const int valid = gr < row_end ? max(0, min(8, K - gk)) : 0;
      load_chunk8(&As[r * A_LD + kc], x + (size_t)gr * K + gk, valid);
    }
    // B tile [BK16, BN]: 256 chunks of 8, two per thread
    for (int c = tid; c < BK16 * BN / 8; c += THREADS) {
      const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gc = col0 + cc;
      const int valid = gk < K ? max(0, min(8, F - gc)) : 0;
      load_chunk8(&Bs[r * B_LD + cc], w + (size_t)gk * F + gc, valid);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wr * 32 + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * B_LD + wc * 32 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wr * 32 + i * 16) * C_LD + wc * 32 + j * 16],
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr < row_end && gc < F)
      out[(size_t)gr * F + gc] = __float2bfloat16(Cs[r * C_LD + c]);
  }
}

// ---- fp32: FMA, each thread owns 4 rows x 8 strided columns ----------------
constexpr int BK32 = 16;

__device__ void tile_gemm(const float* __restrict__ x,
                          const float* __restrict__ w,
                          float* __restrict__ out,
                          int row0, int row_end, int K, int F, int col0) {
  __shared__ float As[BM][BK32 + 1];
  __shared__ float Bs[BK32][BN];
  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;   // 16 x 8 threads
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK32) {
    for (int e = tid; e < BM * BK32; e += THREADS) {
      const int r = e / BK32, kc = e % BK32;
      const int gr = row0 + r, gk = k0 + kc;
      As[r][kc] = (gr < row_end && gk < K) ? x[(size_t)gr * K + gk] : 0.0f;
    }
    for (int e = tid; e < BK32 * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gc = col0 + c;
      Bs[r][c] = (gk < K && gc < F) ? w[(size_t)gk * F + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK32; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= row_end) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = col0 + tx + 8 * j;
      if (gc < F) out[(size_t)gr * F + gc] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
branch_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, int M, int K, int F) {
  const size_t b = blockIdx.z;
  tile_gemm(x + b * M * K, w + b * K * F, out + b * M * F,
            blockIdx.y * BM, M, K, F, blockIdx.x * BN);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, const int* __restrict__ table,
                    int K, int F) {
  const int* e = table + 3 * blockIdx.y;   // (group, row_start, row_end)
  tile_gemm(x, w + (size_t)e[0] * K * F, out, e[1], e[2], K, F,
            blockIdx.x * BN);
}

template <typename T>
int launch_branch(const void* x, const void* w, void* out, int n, int m,
                  int k, int f, void* stream) {
  const dim3 grid(cdiv(f, BN), cdiv(m, BM), n);
  branch_gemm_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (T*)out, m, k, f);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_grouped(const void* x, const void* w, void* out, const void* table,
                   int tiles, int k, int f, void* stream) {
  const dim3 grid(cdiv(f, BN), tiles);
  grouped_gemm_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (T*)out, (const int*)table, k, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gemm_tile_m() { return BM; }

int branch_gemm_bf16(const void* x, const void* w, void* out, int n, int m,
                     int k, int f, void* stream) {
  return launch_branch<__nv_bfloat16>(x, w, out, n, m, k, f, stream);
}

int branch_gemm_f32(const void* x, const void* w, void* out, int n, int m,
                    int k, int f, void* stream) {
  return launch_branch<float>(x, w, out, n, m, k, f, stream);
}

int grouped_gemm_bf16(const void* x, const void* w, void* out,
                      const void* table, int tiles, int k, int f,
                      void* stream) {
  return launch_grouped<__nv_bfloat16>(x, w, out, table, tiles, k, f, stream);
}

int grouped_gemm_f32(const void* x, const void* w, void* out,
                     const void* table, int tiles, int k, int f,
                     void* stream) {
  return launch_grouped<float>(x, w, out, table, tiles, k, f, stream);
}

}  // extern "C"
