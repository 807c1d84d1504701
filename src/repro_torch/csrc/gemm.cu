// Fused multi-branch GEMMs for Hopper (sm_90a): branch_gemm and grouped_gemm.
//
// Replaces the JAX package's Pallas TPU kernels
//   src/repro/kernels/branch_gemm/kernel.py  branch_gemm_pallas
//   src/repro/kernels/grouped_gemm/kernel.py grouped_gemm_pallas
// Both compute out = x @ w per branch with fp32 accumulation and round once
// to the input dtype at the store, as the Pallas kernels do.  They differ only
// in how a block finds its rows and its weight:
//   branch_gemm   x [N,M,K] @ w [N,K,F] -> [N,M,F], equal M for all branches.
//   grouped_gemm  x [sum M, K] holds N groups' rows back to back with no
//                 padding; row tile t reads the device table entry (group,
//                 row_start, row_end) built once when the step is lowered,
//                 reads w[group] and drops the rows past its group's end.  A
//                 zero-row group has no tiles.
//
// Bound at the main path's bf16 shapes (H100 SXM data sheet: 989 TFLOP/s
// dense bf16, 3.35 TB/s; each input read once, each output written once):
//   Qwen2 gate||up    [2,512,896] @ [2,896,4864]:   8.93 GFLOP ->   9.0 us (ops)
//   Qwen2 wk||wv      [2,512,896] @ [2,896,128]:    2.56 MB    ->  0.76 us (bytes)
//   dense-prefix gate||up [2,512,7168] @ [2,7168,18432]: 271 GFLOP -> 274 us (ops)
//   RWKV r||k||v||g   [4,512,2048] @ [4,2048,2048]: 17.2 GFLOP ->  17.4 us (ops)
//   Kimi routed gate||up, 16 groups of 160-480 rows (5120), K 7168, F 4096:
//                     1.05 GB -> 315 us (bytes; 301 GFLOP -> 304 us)
//   Kimi routed down, K 2048, F 7168: 564 MB -> 168 us (bytes)
//
// Three routes, chosen by the Python wrapper from dtype, shape and alignment
// alone (kernels/branch_gemm/ops.py route()); a launch that fails raises and
// never falls back to another route:
//
// wgmma (bf16 with K % 8 == 0, F % 8 == 0, K > 0 and 16-byte aligned bases:
// TMA needs 16-byte aligned addresses and row strides).  A warp-specialised
// block: warpgroup 0 is the producer, of which one thread keeps TMA loads in
// flight into a ring of STAGES tiles (full/empty mbarrier pairs); the BM/64
// consumer warpgroups each issue wgmma.m64nBNk16.f32.bf16.bf16 on their 64
// rows of the BM x BN output tile; with two consumers setmaxnreg moves
// registers from the producer (40) to the consumers (232).  BK = 64, so one
// row of a tile is 128 bytes under the 128-byte swizzle:
//   A (x) is K-major in shared memory: a TMA box of 64 K x BM rows.
//   B (w [K, F], F contiguous) is read MN-major through the descriptor's
//     transpose bit, so the weights are neither copied nor transposed.  A
//     128-byte swizzled box holds at most 64 bf16 on its inner axis, so a BN
//     wide tile is BN/64 boxes of 64 K rows; the descriptor's leading byte
//     offset (LBO) steps from one box to the next (8 KB), its stride byte
//     offset (SBO) from one 8-row group of K to the next (1 KB).
//   Tensor maps: w as 3-D [N, K, F], so a K tile past K reads zeros and not
//     the next branch's rows (a 0 x inf from a neighbour would poison the
//     sum); branch_gemm's x as 3-D [N, M, K], so a branch's M edge reads
//     zeros; grouped_gemm's x as 2-D [sum M, K]: a row tile past its group's
//     end reads the next group's rows, and the store drops them.  The maps
//     are encoded on the host at each launch (cuTensorMapEncodeTiled, looked
//     up through cudaGetDriverEntryPoint, so the library needs no -lcuda)
//     and passed as __grid_constant__ kernel parameters.  Encoding is host
//     work, so a launch inside CUDA-graph capture is legal: the graph keeps
//     the parameters, i.e. the maps of the static buffers it was recorded on.
//   Epilogue: fp32 accumulators -> bf16 pairs, stored with the row mask
//     (M, or row_end from the table) and the column mask (F).
//   Raster: the row tile is the fast block index, so the row tiles of one
//     (branch or group, F tile) run next to each other and share each w tile
//     from L2; a branch's or group's x panel (at most 7.3 MB at Kimi's
//     width) stays in L2 while its F tiles go by.  Dense-prefix gate||up:
//     the 528 MB of weights are read from HBM once instead of up to 8 times
//     (64-row tiles, F tile fastest: ~4.2 GB); x 14.7 MB, out 37.7 MB.
//     grouped_gemm walks groups slowest, then F tiles, then the group's row
//     tiles: each expert's w[g] (58.7 MB at gate||up, more than L2) is read
//     from HBM once, not once per row tile as with the F tile fastest (3-8
//     times at 64-row tiles), and a group's x rows stay in L2 across its F
//     tiles, so x (73 MB) is read once.
//   Tiles: branch_gemm takes (BM, BN) from select_tiles() in the wrapper
//     among the instantiations gemm_has_wgmma_tiles() lists; grouped_gemm's
//     BM is TILE_M = 128 (the table is built with TILE_M rows a tile) and its
//     BN is chosen the same way.
//     At Kimi's capacities (160-480 rows) 128-row tiles pad 16.7% of rows
//     (6144 for 5120); a consumer warpgroup whose 64 rows all lie past its
//     group's end issues no wgmma, so the padding costs 9.1% of the tensor
//     work (5632 rows), as 64-row tiles would.
//
// simple (bf16 outside the wgmma rule, e.g. K = 1 or F = 3): warp-level
// WMMA (mma.sync 16x16x16) on 64x64 tiles with 4 warps and BK = 32, loads
// staged through registers, every load and store masked, so any M, K, F is
// taken.  Also exposed as branch_gemm_simple_bf16 / grouped_gemm_simple_bf16
// so that a measurement can hold the wgmma route against it.
//
// fp32: plain FMA on 64x64 tiles (the fp32 graphs are held at 1e-5
// relative, which TF32 wgmma would break).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TILE_M = 128;   // rows of a grouped_gemm row tile (kernels.TILE_M)

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// =============================================================================
// simple and fp32 routes: 64x64 tiles, 4 warps
// =============================================================================
namespace simple {

constexpr int BM = 64;   // rows of an output tile; TILE_M / BM blocks a row tile
constexpr int BN = 64;   // columns of an output tile
constexpr int THREADS = 128;

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
  const int row0 = e[1] + blockIdx.z * BM;  // TILE_M / BM blocks a row tile
  if (row0 >= e[2]) return;
  tile_gemm(x, w + (size_t)e[0] * K * F, out, row0, e[2], K, F,
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
  const dim3 grid(cdiv(f, BN), tiles, TILE_M / BM);
  grouped_gemm_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (T*)out, (const int*)table, k, f);
  return (int)cudaGetLastError();
}

}  // namespace simple

// =============================================================================
// wgmma route: TMA ring -> warpgroup wgmma, bf16 only
// =============================================================================
namespace wg {

using namespace hopper;

constexpr int BK = 64;                       // 64 bf16 = one 128-byte row
constexpr int BOX = 64;                      // bf16 a 128-byte swizzled box row
constexpr int B_BOX_BYTES = BK * BOX * 2;    // one 64 x 64 box of w: 8 KB
constexpr int SMEM_BUDGET = 196608;          // ring bytes an SM gives its blocks

template <int BM, int BN>
struct Cfg {
  static constexpr int CONSUMERS = BM / 64;            // warpgroups of wgmma
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int MIN_BLOCKS = CONSUMERS == 1 ? 2 : 1;  // blocks an SM
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES =
      SMEM_BUDGET / MIN_BLOCKS / STAGE_BYTES < 6
          ? SMEM_BUDGET / MIN_BLOCKS / STAGE_BYTES : 6;
  // ring, 1024 bytes of slack to align it (the 128-byte swizzle repeats
  // every 1024 bytes), the full/empty barriers and the grouped tile's
  // coordinates
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 16 * STAGES + 16;
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(BN == 64 || BN == 128 || BN == 256, "wgmma N");
  static_assert(STAGES >= 3, "ring too short");
};

// One output tile of BM x BN.  branch_gemm: blockIdx = (row tile, F tile,
// branch).  grouped_gemm: blockIdx.x runs over groups (slowest), then F tiles,
// then the group's row tiles (fastest).
template <int BM, int BN, bool GROUPED>
__global__ void __launch_bounds__(Cfg<BM, BN>::THREADS,
                                  Cfg<BM, BN>::MIN_BLOCKS)
gemm_kernel(const __grid_constant__ CUtensorMap xmap,
            const __grid_constant__ CUtensorMap wmap,
            __nv_bfloat16* __restrict__ out, const int* __restrict__ table,
            int M, int K, int F, int f_tiles) {
  using C = Cfg<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;
  int* coords = reinterpret_cast<int*>(empty + C::STAGES);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);                // the producer's arrive
      mbar_init(smem_u32(&empty[s]), C::CONSUMERS);    // one per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (GROUPED) {
    if (tid < 32) {
      // The blocks of group g are [f_tiles * t0, f_tiles * (t0 + n)) for its
      // n row tiles t0..t0+n-1, so entry b / f_tiles is one of g's tiles;
      // the lanes look back 32 entries at a time for the group's first.
      const int b = blockIdx.x;
      const int q = b / f_tiles;
      const int g = table[3 * q];
      int t0 = -1;
      for (int base = q; t0 < 0; base -= 32) {
        const int idx = base - tid;
        const bool other = idx < 0 || table[3 * idx] != g;
        const unsigned mask = __ballot_sync(0xffffffffu, other);
        if (mask) t0 = base - (__ffs(mask) - 1) + 1;
      }
      const int row_end = table[3 * t0 + 2];
      const int n = cdiv(row_end - table[3 * t0 + 1], TILE_M);
      const int u = b - f_tiles * t0;
      if (tid == 0) {
        coords[0] = table[3 * (t0 + u % n) + 1];   // row0
        coords[1] = row_end;
        coords[2] = (u / n) * BN;                   // col0
        coords[3] = g;
      }
    }
  }
  __syncthreads();
  int row0, row_end, col0, batch;
  if constexpr (GROUPED) {
    row0 = coords[0]; row_end = coords[1]; col0 = coords[2]; batch = coords[3];
  } else {
    row0 = blockIdx.x * BM; row_end = M; col0 = blockIdx.y * BN;
    batch = blockIdx.z;
  }
  const int k_tiles = cdiv(K, BK);

  // The role and the consumer's row mask through a shuffle: values the
  // compiler knows to be warp-uniform, so it does not take the wgmma path for
  // a divergent one (and serialise the wgmmas there).
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    // ---- producer warpgroup: one thread issues every TMA load ------------
    if constexpr (C::CONSUMERS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % C::STAGES;
        mbar_wait(smem_u32(&empty[s]), ((kt / C::STAGES) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, C::STAGE_BYTES);
        const uint32_t a = smem_u32(ring + s * C::STAGE_BYTES);
        if constexpr (GROUPED)
          tma_load_2d(a, &xmap, bar, kt * BK, row0);
        else
          tma_load_3d(a, &xmap, bar, kt * BK, row0, batch);
#pragma unroll
        for (int j = 0; j < BN / BOX; ++j)
          tma_load_3d(a + C::A_BYTES + j * B_BOX_BYTES, &wmap, bar,
                      col0 + j * BOX, kt * BK, batch);
      }
    }
  } else {
    // ---- consumer warpgroups: rows c*64 .. c*64+63 of the tile -----------
    if constexpr (C::CONSUMERS == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int c = role - 1;
    // A consumer whose 64 rows all lie past the end only passes the ring on.
    const bool active = __shfl_sync(0xffffffffu, row0 + c * 64 < row_end, 0);
    if (!active) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % C::STAGES;
        mbar_wait(smem_u32(&full[s]), (kt / C::STAGES) & 1);
        if (tid % 128 == 0) mbar_arrive(smem_u32(&empty[s]));
      }
      return;
    }
    // Only wgmma defines the accumulators (the first product overwrites
    // them) and the loop touches them nowhere else: a register move or a use
    // inside the pipeline would make ptxas serialise the wgmmas.
    float acc[BN / 2];
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % C::STAGES;
      mbar_wait(smem_u32(&full[s]), (kt / C::STAGES) & 1);
      const uint32_t a = smem_u32(ring + s * C::STAGE_BYTES) + c * 64 * 128;
      const uint32_t b = smem_u32(ring + s * C::STAGE_BYTES) + C::A_BYTES;
      // A: K-major, 8-row groups 1 KB apart (LBO unused: one k16 step lies
      // inside a 128-byte row).  B: MN-major, 64-column boxes 8 KB apart
      // (LBO), 8-row groups of K 1 KB apart (SBO).
      const uint64_t da = smem_desc(a, 16, 1024);
      const uint64_t db = smem_desc(b, B_BOX_BYTES, 1024);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      wgmma_fence();
      // a k16 step: 32 bytes along a K-major row of A, 16 rows (2 KB) down
      // the MN-major B (descriptor addresses are in 16-byte units)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<1>(acc, da + 2 * kk, db + 128 * kk, kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();   // the previous K tile's products are done
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      if (kt > 0 && tid % 128 == 0)
        mbar_arrive(smem_u32(&empty[(kt - 1) % C::STAGES]));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);

    // ---- epilogue: accumulator fragment -> bf16 pairs, masked ------------
    // Thread l of warp w holds, for each 8-column group j, rows
    // 16w + l/4 and 16w + l/4 + 8 at columns 8j + 2(l%4) and +1.
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int r = row0 + c * 64 + warp * 16 + lane / 4;
    __nv_bfloat16* base = out + (GROUPED ? 0 : (size_t)batch * M * F);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j + 2 * (lane % 4);
      if (col >= F) continue;   // F % 8 == 0: col < F means col + 1 < F
      if (r < row_end)
        *reinterpret_cast<__nv_bfloat162*>(base + (size_t)r * F + col) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      if (r + 8 < row_end)
        *reinterpret_cast<__nv_bfloat162*>(base + (size_t)(r + 8) * F + col) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ---- host: tensor maps and launches ----------------------------------------
// w [N, K, F] as 3-D, boxes of 64 F x 64 K
int encode_w(CUtensorMap* map, const void* w, int n, int k, int f) {
  const cuuint64_t dims[3] = {(cuuint64_t)f, (cuuint64_t)k, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)f * 2, (cuuint64_t)k * f * 2};
  const cuuint32_t box[3] = {BOX, BK, 1};
  return encode(map, w, 3, dims, strides, box);
}

template <int BM, int BN, bool GROUPED>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap, void* out,
           const void* table, dim3 grid, int m, int k, int f, void* stream) {
  using C = Cfg<BM, BN>;
  gemm_kernel<BM, BN, GROUPED><<<grid, C::THREADS, C::SMEM,
                                 (cudaStream_t)stream>>>(
      xmap, wmap, (__nv_bfloat16*)out, (const int*)table, m, k, f,
      cdiv(f, BN));
  return (int)cudaGetLastError();
}

template <int BM, int BN>
int launch_branch(const void* x, const void* w, void* out, int n, int m, int k,
                  int f, void* stream) {
  CUtensorMap xmap, wmap;
  // x [N, M, K] as 3-D, boxes of 64 K x BM rows
  const cuuint64_t dims[3] = {(cuuint64_t)k, (cuuint64_t)m, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)k * 2, (cuuint64_t)m * k * 2};
  const cuuint32_t box[3] = {BK, BM, 1};
  if (int err = encode(&xmap, x, 3, dims, strides, box)) return err;
  if (int err = encode_w(&wmap, w, n, k, f)) return err;
  const dim3 grid(cdiv(m, BM), cdiv(f, BN), n);
  return launch<BM, BN, false>(xmap, wmap, out, nullptr, grid, m, k, f, stream);
}

template <int BN>
int launch_grouped(const void* x, const void* w, void* out, const void* table,
                   int tiles, int rows, int groups, int k, int f,
                   void* stream) {
  CUtensorMap xmap, wmap;
  // x [sum M, K] as 2-D, boxes of 64 K x TILE_M rows
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {BK, TILE_M};
  if (int err = encode(&xmap, x, 2, dims, strides, box)) return err;
  if (int err = encode_w(&wmap, w, groups, k, f)) return err;
  const dim3 grid(tiles * cdiv(f, BN));
  return launch<TILE_M, BN, true>(xmap, wmap, out, table, grid, rows, k, f,
                                  stream);
}

template <int BM, int BN, bool GROUPED>
int allow_smem() {
  return (int)cudaFuncSetAttribute(gemm_kernel<BM, BN, GROUPED>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Cfg<BM, BN>::SMEM);
}

}  // namespace wg

}  // namespace

extern "C" {

int gemm_tile_m() { return TILE_M; }

// (BM, BN) instantiations of the wgmma route; must match WGMMA_TILES and
// GROUPED_TILES in kernels/branch_gemm/kernel.py (checked when the library
// loads).  grouped_gemm's BM is TILE_M.
int gemm_has_wgmma_tiles(int bm, int bn, int grouped) {
  if (grouped) return bm == TILE_M && (bn == 128 || bn == 256);
  return (bm == 128 && (bn == 128 || bn == 256)) ||
         (bm == 64 && (bn == 64 || bn == 128));
}

// Once per process, when the library loads: lets every wgmma instantiation
// take its ring (above the 48 KB default) and looks up the map encoder.
int gemm_init() {
  using namespace wg;
  const int errs[] = {
      allow_smem<128, 256, false>(), allow_smem<128, 128, false>(),
      allow_smem<64, 128, false>(),  allow_smem<64, 64, false>(),
      allow_smem<TILE_M, 256, true>(), allow_smem<TILE_M, 128, true>(),
      resolve_encoder()};
  for (int err : errs)
    if (err) return err;
  return 0;
}

int branch_gemm_bf16(const void* x, const void* w, void* out, int n, int m,
                     int k, int f, int bm, int bn, void* stream) {
  using namespace wg;
  if (bm == 128 && bn == 256)
    return launch_branch<128, 256>(x, w, out, n, m, k, f, stream);
  if (bm == 128 && bn == 128)
    return launch_branch<128, 128>(x, w, out, n, m, k, f, stream);
  if (bm == 64 && bn == 128)
    return launch_branch<64, 128>(x, w, out, n, m, k, f, stream);
  if (bm == 64 && bn == 64)
    return launch_branch<64, 64>(x, w, out, n, m, k, f, stream);
  return (int)cudaErrorInvalidValue;
}

int grouped_gemm_bf16(const void* x, const void* w, void* out,
                      const void* table, int tiles, int rows, int groups,
                      int k, int f, int bn, void* stream) {
  using namespace wg;
  if (bn == 256)
    return launch_grouped<256>(x, w, out, table, tiles, rows, groups, k, f,
                               stream);
  if (bn == 128)
    return launch_grouped<128>(x, w, out, table, tiles, rows, groups, k, f,
                               stream);
  return (int)cudaErrorInvalidValue;
}

int branch_gemm_simple_bf16(const void* x, const void* w, void* out, int n,
                            int m, int k, int f, void* stream) {
  return simple::launch_branch<__nv_bfloat16>(x, w, out, n, m, k, f, stream);
}

int branch_gemm_f32(const void* x, const void* w, void* out, int n, int m,
                    int k, int f, void* stream) {
  return simple::launch_branch<float>(x, w, out, n, m, k, f, stream);
}

int grouped_gemm_simple_bf16(const void* x, const void* w, void* out,
                             const void* table, int tiles, int k, int f,
                             void* stream) {
  return simple::launch_grouped<__nv_bfloat16>(x, w, out, table, tiles, k, f,
                                               stream);
}

int grouped_gemm_f32(const void* x, const void* w, void* out,
                     const void* table, int tiles, int k, int f,
                     void* stream) {
  return simple::launch_grouped<float>(x, w, out, table, tiles, k, f, stream);
}

}  // extern "C"
