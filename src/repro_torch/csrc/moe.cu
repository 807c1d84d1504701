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
// GEMM launches, stage 1 (h = silu(buf @ gate) * (buf @ up), written to a
// scratch [E, C, f] the wrapper allocates) and stage 2 (out = h @ down).
//
// Bound (Kimi-K2: E 384, d 7168, f 2048, bf16; H100 SXM data sheet, 3.35
// TB/s, 989 TFLOP/s bf16): every expert's stacks are 3 x 384 x 7168 x 2048
// x 2 B = 33.8 GB, 10.1 ms, at any capacity up to a few hundred rows (a
// 512-token prefill, C = 13, does 0.44 TFLOP: 0.44 ms).  But the capacity
// buffers are mostly zero at a decode tick: 8 slots x top-8 fill at most 64
// of the 384 experts' single row (C = 1), and moe_ffn_sort builds buf from
// zeros.  An expert whose rows are all zero gives out[e] = 0 exactly for
// finite weights (silu(0) * 0 = 0, and 0 @ down = 0), so reading its 88 MB
// of weights buys nothing: the tick's least read is the active experts'
// weights, ~59 x 88.1 MB = 5.2 GB, 1.55 ms.  The skip rests on finite
// weights: a skipped expert's row is +0 where the plain version would give
// NaN for an inf or NaN weight (0 * inf).  Every weight in this repository
// is finite.
//
// Three routes, chosen by the wrapper (kernels/moe_gemm/ops.py route());
// a launch that fails raises and never falls back to another route:
//
// wgmma (bf16 with d and f multiples of 8, 16-byte aligned bases, E <=
// MAX_EXPERTS: what TMA can read).  Three launches, no host sync, so the
// call records into the engine's decode CUDA graph as it is:
//   scan     grid E: block e reads buf[e] (C x d; it leaves after the
//            first round of loads that finds a nonzero) and sets flags[e]
//            to whether any element is nonzero (a NaN counts, -0 does not);
//            if none is, it writes out[e] = +0.  At Kimi's C = 1 it reads
//            5.5 MB.
//   stage 1  (GLU) and stage 2: a persistent grid of one block per SM.  Each
//            block compacts the flags into the list of active experts in
//            shared memory (expert order, so every block sees the same
//            list), then walks the work items (active expert, 128-column
//            tile of the weights, chunk of NT capacity rows) b, b + grid,
//            ...  The grid never depends on the active count, which changes
//            from tick to tick inside one recorded graph; an empty expert's
//            weights are never read, and its h rows are never written or
//            read.
//   Swap AB: the capacity rows are few (1 at a tick, <= 27 at a 700-token
//   DeepSeek-V3 prefill), so each item computes out^T = W^T x^T: 64
//   weight columns are wgmma's M, read MN-major in place from gate/up [d, f]
//   or down [f, d] through the transpose bit (wgmma_ss_at), and the rows,
//   padded to NT = 8, 16, 32 or 64, are N, read K-major from buf or h; rows
//   past C read TMA's zeros (3-D maps [E, C, K], so no row of the next
//   expert).  A warp-specialised block: two consumer warpgroups (warps
//   0-7) each own 64 of an item's 128 weight columns and share its row
//   tile; warp 8's first thread keeps a ring of STAGES stages (each the
//   BK = 64 deep weight tiles, 8 KB each, and the NT x 64 row tile) full of
//   TMA loads, across item boundaries, so ~200 KB of weight loads are in
//   flight on every SM; full/empty mbarriers pace them.  Throwaway sweeps
//   on the H100 (not in the repository) found two consumers (each weight
//   row read 256 bytes at a time) faster at full occupancy than one and no
//   slower at a tick's, this ring a little faster than one of 192 KB, and
//   slower: two blocks an SM with half the ring each, an evict-first hint
//   on the weight loads, L2 promotion of 128 bytes or none.  Each weight
//   byte leaves HBM once per call.  Stage 1's epilogue applies SwiGLU to
//   the two fp32 accumulators in registers and rounds h to bf16; stage 2
//   rounds the output.  Zero rows of an active expert are computed (they
//   are the wgmma's N padding, and give 0): tensor work is never the bound.
//
// simple (bf16 outside the wgmma rule, e.g. d = 100 or f = 36; also forced
// by moe_mlp_simple_bf16 for a comparison): the routine of the first port.
// Per stage, grid (N/BN, E): a block walks the reduction dimension in BK-deep
// stages, the BK x BN weight tile(s) and the matching BK columns of up to 32
// activation rows through shared memory, and thread (col, rg) accumulates
// output column col for rows rg, rg + 4, ... with fp32 FMAs.  It walks
// every expert.
//
// fp32: the simple routine's FMAs (no TF32: the fp32 serve runs are held at
// the plain version's tolerance) after the scan, whose flags let a block of
// an empty expert return at once.
//
// Device counts (every route; counts [E] int32, written on the card by the
// expert-parallel layer's dispatch): expert e's rows are its first
// min(counts[e], C); the others are neither read nor computed nor written,
// and no scan runs (an expert is active when its count is above 0).  That
// layer drops no routed pair, so its static buffers hold up to every token
// an expert (C = 512 at a 1 x 512 prefill) while a held expert sees ~16
// (DeepSeek-V3 at 8 of 256 experts, top-8): the work has to follow the
// count, not C.  On the wgmma route each block turns the counts into a
// prefix of the active experts' row chunks, so the item walk holds only
// the chunks the experts fill (E <= MAX_COUNTED_EXPERTS), a tile's chunks
// side by side: a layer whose tokens crowd onto one expert (500 rows, 8
// chunks) reads that expert's weights from HBM once, not once a chunk.  An
// item reads its NT-row tile whole: rows past the count inside it are
// computed into columns of out^T that the epilogue never stores (each
// column depends on its own row alone, so any value there, even a NaN of
// the scratch, stays in it).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
  return __float2bfloat16(x);
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr int MAX_EXPERTS = 4096;  // the wgmma route's list in shared memory
// under device counts: the per-expert flags' bytes hold an int an expert
constexpr int MAX_COUNTED_EXPERTS = MAX_EXPERTS / 4;

// =============================================================================
// scan: which experts hold a nonzero row
// =============================================================================
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_UNROLL = 4;     // 16-byte loads a thread keeps in flight

// Block e: flags[e] = whether buf[e] (n = C x d elements) holds a value other
// than +-0; if not, out[e] = +0.  `vec`: n is a multiple of the 16-byte
// vector and both bases are 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
moe_scan_kernel(const T* __restrict__ buf, T* __restrict__ out,
                int* __restrict__ flags, long long n, int vec) {
  constexpr int V = 16 / sizeof(T);
  // the bits of a 32-bit word that are not sign bits: a word of +-0 values
  // has none of them set
  constexpr uint32_t MAGNITUDE = sizeof(T) == 4 ? 0x7FFFFFFFu : 0x7FFF7FFFu;
  const long long base = static_cast<long long>(blockIdx.x) * n;
  int found = 0;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(buf + base);
    const long long nv = n / V;
    for (long long v0 = 0; v0 < nv; v0 += SCAN_THREADS * SCAN_UNROLL) {
      uint4 r[SCAN_UNROLL];
#pragma unroll
      for (int u = 0; u < SCAN_UNROLL; ++u) {
        const long long v = v0 + u * SCAN_THREADS + threadIdx.x;
        r[u] = v < nv ? __ldg(xv + v) : make_uint4(0u, 0u, 0u, 0u);
      }
      uint32_t bits = 0;
#pragma unroll
      for (int u = 0; u < SCAN_UNROLL; ++u)
        bits |= r[u].x | r[u].y | r[u].z | r[u].w;
      found = __syncthreads_or((bits & MAGNITUDE) != 0);
      if (found) break;
    }
  } else {
    const T* x = buf + base;
    for (long long i0 = 0; i0 < n; i0 += SCAN_THREADS * SCAN_UNROLL) {
      int any = 0;
#pragma unroll
      for (int u = 0; u < SCAN_UNROLL; ++u) {
        const long long i = i0 + u * SCAN_THREADS + threadIdx.x;
        any |= i < n && to_f(x[i]) != 0.0f;   // a NaN counts as nonzero
      }
      found = __syncthreads_or(any);
      if (found) break;
    }
  }
  if (threadIdx.x == 0) flags[blockIdx.x] = found;
  if (found) return;
  if (vec) {
    uint4* ov = reinterpret_cast<uint4*>(out + base);
    for (long long v = threadIdx.x; v < n / V; v += SCAN_THREADS)
      ov[v] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (long long i = threadIdx.x; i < n; i += SCAN_THREADS)
      out[base + i] = from_f<T>(0.0f);
  }
}

template <typename T>
cudaError_t launch_scan(const T* buf, T* out, int* flags, int E, int C, int d,
                        cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const long long n = static_cast<long long>(C) * d;
  const bool vec = n % V == 0 &&
                   (reinterpret_cast<uintptr_t>(buf) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  moe_scan_kernel<T><<<E, SCAN_THREADS, 0, s>>>(buf, out, flags, n,
                                                vec ? 1 : 0);
  return cudaGetLastError();
}

// =============================================================================
// simple and fp32 routes: FMA tiles on the CUDA cores
// =============================================================================
namespace simple {

constexpr int BN = 64;            // output columns per block
constexpr int BK = 64;            // reduction depth per shared-memory stage
constexpr int THREADS = 256;
constexpr int ROW_GROUPS = THREADS / BN;   // 4

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
// pass covers ROW_GROUPS * RPT rows.  With `flags` (the fp32 route), a block
// of an expert the scan found empty returns at once: the scan wrote its
// output rows, and its h rows are never read.  With `counts`, expert e's
// rows are its first min(counts[e], C) alone.
template <typename T, bool GLU, int RPT>
__global__ void __launch_bounds__(THREADS)
expert_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w0,
                   const T* __restrict__ w1, T* __restrict__ out,
                   const int* __restrict__ flags,
                   const int* __restrict__ counts, int C, int K, int N,
                   int vec) {
  constexpr int ROWS = ROW_GROUPS * RPT;
  __shared__ __align__(16) T w0s[BK * BN];
  __shared__ __align__(16) T w1s[GLU ? BK * BN : 1];
  __shared__ float xs[ROWS * BK];

  const int e = blockIdx.y;
  if (flags != nullptr && flags[e] == 0) return;
  const int rows = counts != nullptr ? min(counts[e], C) : C;
  const int n0 = blockIdx.x * BN;
  const int col = threadIdx.x % BN, rg = threadIdx.x / BN;
  const long long wo = static_cast<long long>(e) * K * N;
  const T* xe = x + static_cast<long long>(e) * C * K;
  T* oe = out + static_cast<long long>(e) * C * N;

  for (int c0 = 0; c0 < rows; c0 += ROWS) {
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
        xs[i] = (c < rows && k < K)
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
      if (c >= rows || n >= N) continue;
      float y = acc0[r];
      if constexpr (GLU) y = y / (1.0f + expf(-y)) * acc1[r];
      oe[static_cast<long long>(c) * N + n] = from_f<T>(y);
    }
  }
}

template <typename T, bool GLU>
cudaError_t launch_stage(const T* x, const T* w0, const T* w1, T* out,
                         const int* flags, const int* counts, int E, int C,
                         int K, int N, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  bool vec = N % V == 0 && reinterpret_cast<uintptr_t>(w0) % 16 == 0;
  if constexpr (GLU) vec = vec && reinterpret_cast<uintptr_t>(w1) % 16 == 0;
  const dim3 grid(cdiv(N, BN), E);
  const int v = vec ? 1 : 0;
  if (C <= ROW_GROUPS)
    expert_gemm_kernel<T, GLU, 1><<<grid, THREADS, 0, s>>>(
        x, w0, w1, out, flags, counts, C, K, N, v);
  else if (C <= 2 * ROW_GROUPS)
    expert_gemm_kernel<T, GLU, 2><<<grid, THREADS, 0, s>>>(
        x, w0, w1, out, flags, counts, C, K, N, v);
  else if (C <= 4 * ROW_GROUPS)
    expert_gemm_kernel<T, GLU, 4><<<grid, THREADS, 0, s>>>(
        x, w0, w1, out, flags, counts, C, K, N, v);
  else
    expert_gemm_kernel<T, GLU, 8><<<grid, THREADS, 0, s>>>(
        x, w0, w1, out, flags, counts, C, K, N, v);
  return cudaGetLastError();
}

// Both stages; with `counts` each expert's rows are its count (no scan);
// else with `flags` the scan runs first and empty experts are skipped (the
// fp32 route), without either every expert is computed.
template <typename T>
int moe_mlp(const void* buf, const void* gate, const void* up,
            const void* down, void* h, int* flags, const int* counts,
            void* out, int E, int C, int d, int f, void* stream) {
  if (E < 0 || C < 0 || d <= 0 || f <= 0 || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (counts != nullptr) {
    flags = nullptr;
  } else if (flags != nullptr) {
    err = launch_scan<T>(static_cast<const T*>(buf), static_cast<T*>(out),
                         flags, E, C, d, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = launch_stage<T, true>(
      static_cast<const T*>(buf), static_cast<const T*>(gate),
      static_cast<const T*>(up), static_cast<T*>(h), flags, counts, E, C, d,
      f, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_stage<T, false>(static_cast<const T*>(h),
                               static_cast<const T*>(down), nullptr,
                               static_cast<T*>(out), flags, counts, E, C, f,
                               d, s);
  return static_cast<int>(err);
}

}  // namespace simple

// =============================================================================
// wgmma route: scan, then two persistent TMA + wgmma launches, bf16 only
// =============================================================================
namespace wg {

using namespace hopper;

constexpr int BM = 64;                 // weight columns a consumer owns (M)
constexpr int BK = 64;                 // 64 bf16 = one 128-byte swizzled row
constexpr int CONSUMERS = 2;           // consumer warpgroups a block: an item
                                       // is BM * CONSUMERS weight columns
constexpr int A_BYTES = BK * BM * 2;   // one weight tile: 8 KB
constexpr int RING_BUDGET = 212992;    // ring bytes of the SM's one block
constexpr int MAX_STAGES = 16;

template <bool GLU, int NT>
struct Cfg {
  static constexpr int THREADS = 128 * CONSUMERS + 32;   // + producer warp
  // a stage: each consumer's gate (or down) tile, each consumer's up tile,
  // then the NT x 64 row tile they share
  static constexpr int NA = (GLU ? 2 : 1) * CONSUMERS;
  static constexpr int X_BYTES = NT * BK * 2;
  static constexpr int STAGE_BYTES = NA * A_BYTES + X_BYTES;
  static constexpr int STAGES = RING_BUDGET / STAGE_BYTES < MAX_STAGES
                                    ? RING_BUDGET / STAGE_BYTES : MAX_STAGES;
  // ring, 1024 bytes of slack to align it (the 128-byte swizzle repeats
  // every 1024 bytes), the full/empty barriers, the active count, the list
  // of active experts (uint16) and their flags (bytes)
  static constexpr int SMEM =
      STAGES * STAGE_BYTES + 1024 + 16 * STAGES + 16 + 3 * MAX_EXPERTS;
  static_assert(NT == 8 || NT == 16 || NT == 32 || NT == 64, "wgmma N");
  static_assert(STAGE_BYTES % 1024 == 0, "every tile 1024-byte aligned");
  static_assert(STAGES >= 4, "ring too short");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// Item -> (active expert i, weight tile, row chunk): expert by expert, each
// expert's tiles in turn, the chunks of a tile fastest, so they run side by
// side and read the tile's weights from L2 after the first.  Every expert
// has `chunks` chunks, or under counts (`pre` not null) its own: pre[i] is
// the chunks of the active experts before i, `total` of all of them, and
// the items hold no chunk past an expert's count.
__device__ __forceinline__ void item_of(int item, const int* pre, int n,
                                        int total, int tiles, int chunks,
                                        int& i, int& tile, int& ch) {
  int first = 0, nc = chunks;
  if (pre != nullptr) {
    int lo = 0, hi = n - 1;      // the last expert whose items start <= item
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (pre[mid] * tiles <= item) lo = mid; else hi = mid - 1;
    }
    i = lo;
    first = pre[i] * tiles;
    nc = (i + 1 < n ? pre[i + 1] : total) - pre[i];
  } else {
    i = item / (tiles * chunks);
    first = i * tiles * chunks;
  }
  tile = (item - first) / nc;
  ch = (item - first) % nc;
}

// One launch of a stage over the active experts' work items.
//   GLU   out [E, C, M] = bf16(silu(x @ w0) * (x @ w1))   (w0 gate, w1 up)
//   else  out [E, C, M] = bf16(x @ w0)                    (w0 down)
// x [E, C, K] through xmap (boxes of 64 K x NT rows), w0/w1 [E, K, M] through
// w0map/w1map (boxes of 64 M x 64 K); flags [E] from the scan, or counts [E]
// (then expert e's rows are its first min(counts[e], C)).
template <bool GLU, int NT>
__global__ void __launch_bounds__(Cfg<GLU, NT>::THREADS, 1)
expert_wgmma_kernel(const __grid_constant__ CUtensorMap w0map,
                    const __grid_constant__ CUtensorMap w1map,
                    const __grid_constant__ CUtensorMap xmap,
                    const int* __restrict__ flags,
                    const int* __restrict__ counts,
                    __nv_bfloat16* __restrict__ out, int E, int C, int K,
                    int M) {
  using Cf = Cfg<GLU, NT>;
  constexpr int STAGES = Cf::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * Cf::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  int* active_count = reinterpret_cast<int*>(empty + STAGES);
  uint16_t* list = reinterpret_cast<uint16_t*>(active_count + 4);
  uint8_t* act = reinterpret_cast<uint8_t*>(list + MAX_EXPERTS);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);    // the producer's arrive
      mbar_init(smem_u32(&empty[s]), CONSUMERS);  // one per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // The active experts in expert order: every thread stages flags or
  // counts (loads in flight together), then warp 0 compacts them with
  // ballots.
#pragma unroll 4
  for (int e = tid; e < E; e += Cf::THREADS)
    act[e] = counts != nullptr ? counts[e] > 0 : flags[e] != 0;
  __syncthreads();
  if (tid < 32) {
    int n = 0;
    for (int base = 0; base < E; base += 32) {
      const int e = base + tid;
      const bool a = e < E && act[e];
      const unsigned mask = __ballot_sync(0xffffffffu, a);
      if (a) list[n + __popc(mask & ((1u << tid) - 1u))] = (uint16_t)e;
      n += __popc(mask);
    }
    if (tid == 0) *active_count = n;
  }
  __syncthreads();
  const int tiles = cdiv(M, BM * CONSUMERS), chunks = cdiv(C, NT);
  const int n_active = *active_count;
  // Under counts each active expert's chunks, as a prefix over the active
  // experts in the bytes of act, which the list no longer needs (E <=
  // MAX_COUNTED_EXPERTS, so it holds one int an expert); warp 0 scans.
  int* pre = counts != nullptr ? reinterpret_cast<int*>(act) : nullptr;
  if (pre != nullptr) {
    if (tid < 32) {
      int run = 0;
      for (int base = 0; base < n_active; base += 32) {
        const int i = base + tid;
        const int c = i < n_active ? cdiv(min(counts[list[i]], C), NT) : 0;
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, o);
          if (tid >= o) incl += v;
        }
        if (i < n_active) pre[i] = run + incl - c;
        run += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (tid == 0) active_count[1] = run;
    }
    __syncthreads();
  }
  const int total = pre != nullptr ? active_count[1] : n_active * chunks;
  const int items = total * tiles;
  const int k_tiles = cdiv(K, BK);

  // The role through a shuffle: a value the compiler knows to be
  // warp-uniform, so it does not take the wgmma path for a divergent one.
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == CONSUMERS) {
    // ---- producer warp: one thread keeps the ring full, across items ------
    if (tid == 128 * CONSUMERS) {
      int s = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int i, tile, ch;
        item_of(item, pre, n_active, total, tiles, chunks, i, tile, ch);
        const int col0 = tile * BM * CONSUMERS;
        const int e = list[i];
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(smem_u32(&empty[s]), phase ^ 1);
          const uint32_t bar = smem_u32(&full[s]);
          mbar_expect_tx(bar, Cf::STAGE_BYTES);
          const uint32_t a = smem_u32(ring + s * Cf::STAGE_BYTES);
#pragma unroll
          for (int c = 0; c < CONSUMERS; ++c) {
            tma_load_3d(a + c * A_BYTES, &w0map, bar, col0 + c * BM, kt * BK,
                        e);
            if constexpr (GLU)
              tma_load_3d(a + (CONSUMERS + c) * A_BYTES, &w1map, bar,
                          col0 + c * BM, kt * BK, e);
          }
          tma_load_3d(a + Cf::NA * A_BYTES, &xmap, bar, kt * BK, ch * NT, e);
          if (++s == STAGES) { s = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: consumer `cons` owns the item's weight columns
  // cons * 64 .. + 63.  Thread l of its warp w holds, for each 8-column
  // group j of its 64 x NT tile
  // of out^T, rows (weight columns) 16w + l/4 and +8 at columns (capacity
  // rows) 8j + 2(l%4) and +1: accumulator 4j + q is (row + 8 (q / 2),
  // column 8j + 2(l%4) + q % 2).
  const int lane = tid % 32, warp = (tid % 128) / 32, cons = role;
  int s = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int i, tile, ch;
    item_of(item, pre, n_active, total, tiles, chunks, i, tile, ch);
    const int col0 = tile * BM * CONSUMERS + cons * BM;
    const int e = list[i];
    const int rows = counts != nullptr ? min(counts[e], C) : C;
    // Only wgmma defines the accumulators (the first product overwrites
    // them); the loop touches them nowhere else.
    float acc0[NT / 2];
    float acc1[GLU ? NT / 2 : 1];
    int prev = 0;
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait(smem_u32(&full[s]), phase);
      const uint32_t base = smem_u32(ring + s * Cf::STAGE_BYTES);
      const uint32_t a = base + cons * A_BYTES;
      const uint32_t a1 = base + (CONSUMERS + cons) * A_BYTES;
      const uint32_t x = base + Cf::NA * A_BYTES;
      fence_operands(acc0);
      if constexpr (GLU) fence_operands(acc1);
      wgmma_fence();
      // a k16 step: 16 rows (2 KB) down the MN-major weight tile (one
      // 64-column box, so its LBO is unused; 8-row groups of K 1 KB apart),
      // 32 bytes along the K-major rows of the row tile (8-row groups 1 KB
      // apart)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dx = smem_desc(x + kk * 32, 16, 1024);
        const int accumulate = kt > 0 || kk > 0;
        wgmma_ss_at(acc0, smem_desc(a + kk * 2048, A_BYTES, 1024), dx,
                    accumulate);
        if constexpr (GLU)
          wgmma_ss_at(acc1, smem_desc(a1 + kk * 2048, A_BYTES, 1024),
                      dx, accumulate);
      }
      wgmma_commit();
      wgmma_wait<1>();   // the previous stage's products are done
      fence_operands(acc0);
      if constexpr (GLU) fence_operands(acc1);
      if (kt > 0 && tid % 128 == 0) mbar_arrive(smem_u32(&empty[prev]));
      prev = s;
      if (++s == STAGES) { s = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_operands(acc0);
    if constexpr (GLU) fence_operands(acc1);
    if (tid % 128 == 0) mbar_arrive(smem_u32(&empty[prev]));

    // ---- epilogue: out[e, c, col0 + m] for c < rows and col0 + m < M ------
    __nv_bfloat16* oe = out + static_cast<size_t>(e) * C * M;
    const int m0 = col0 + warp * 16 + lane / 4;
    const int c0 = ch * NT + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + 8 * (q / 2), c = c0 + 8 * j + q % 2;
        if (m >= M || c >= rows) continue;
        float y = acc0[4 * j + q];
        if constexpr (GLU) y = y / (1.0f + expf(-y)) * acc1[4 * j + q];
        oe[static_cast<size_t>(c) * M + m] = __float2bfloat16(y);
      }
    }
  }
}

// ---- host: tensor maps and launches ----------------------------------------
// w [E, K, M] as 3-D, boxes of 64 M x 64 K
int encode_w(CUtensorMap* map, const void* w, int E, int K, int M) {
  const cuuint64_t dims[3] = {(cuuint64_t)M, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)M * 2, (cuuint64_t)K * M * 2};
  const cuuint32_t box[3] = {BM, BK, 1};
  return encode(map, w, 3, dims, strides, box);
}

// x [E, C, K] as 3-D, boxes of 64 K x NT rows
int encode_x(CUtensorMap* map, const void* x, int E, int C, int K, int nt) {
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)C, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)C * K * 2};
  const cuuint32_t box[3] = {BK, (cuuint32_t)nt, 1};
  return encode(map, x, 3, dims, strides, box);
}

template <bool GLU, int NT>
int launch_nt(const void* x, const void* w0, const void* w1, void* out,
              const int* flags, const int* counts, int E, int C, int K, int M,
              int grid, cudaStream_t s) {
  using Cf = Cfg<GLU, NT>;
  CUtensorMap w0map, w1map, xmap;
  if (int err = encode_w(&w0map, w0, E, K, M)) return err;
  if (int err = encode_w(&w1map, GLU ? w1 : w0, E, K, M)) return err;
  if (int err = encode_x(&xmap, x, E, C, K, NT)) return err;
  expert_wgmma_kernel<GLU, NT><<<grid, Cf::THREADS, Cf::SMEM, s>>>(
      w0map, w1map, xmap, flags, counts, static_cast<__nv_bfloat16*>(out),
      E, C, K, M);
  return static_cast<int>(cudaGetLastError());
}

// The row tile NT: the least of 8, 16, 32 that holds C rows, else 64 (and
// chunks of 64 rows past it).
template <bool GLU>
int launch_stage(const void* x, const void* w0, const void* w1, void* out,
                 const int* flags, const int* counts, int E, int C, int K,
                 int M, int grid, cudaStream_t s) {
  if (C <= 8)
    return launch_nt<GLU, 8>(x, w0, w1, out, flags, counts, E, C, K, M, grid,
                             s);
  if (C <= 16)
    return launch_nt<GLU, 16>(x, w0, w1, out, flags, counts, E, C, K, M,
                              grid, s);
  if (C <= 32)
    return launch_nt<GLU, 32>(x, w0, w1, out, flags, counts, E, C, K, M,
                              grid, s);
  return launch_nt<GLU, 64>(x, w0, w1, out, flags, counts, E, C, K, M, grid,
                            s);
}

// `grid`: the persistent grid, one block per SM.  With `counts` no scan
// runs: the counts say which experts are active and how many rows each has.
int moe_mlp(const void* buf, const void* gate, const void* up,
            const void* down, void* h, int* flags, const int* counts,
            void* out, int E, int C, int d, int f, int grid, void* stream) {
  if (E < 0 || C < 0 || d <= 0 || f <= 0 || E > MAX_EXPERTS ||
      (counts != nullptr && E > MAX_COUNTED_EXPERTS) || d % 8 != 0 ||
      f % 8 != 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using T = __nv_bfloat16;
  if (counts == nullptr) {
    const cudaError_t err = launch_scan<T>(
        static_cast<const T*>(buf), static_cast<T*>(out), flags, E, C, d, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (int e1 = launch_stage<true>(buf, gate, up, h, flags, counts, E, C, d, f,
                                  grid, s))
    return e1;
  return launch_stage<false>(h, down, nullptr, out, flags, counts, E, C, f,
                             d, grid, s);
}

template <bool GLU, int NT>
int allow_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      expert_wgmma_kernel<GLU, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<GLU, NT>::SMEM));
}

}  // namespace wg

}  // namespace

extern "C" {

int moe_max_experts() { return MAX_EXPERTS; }

// Once per process, when the library loads (a launch may be recorded into a
// CUDA graph, so it sets no attribute itself): lets every wgmma
// instantiation take its ring (above the 48 KB default) and looks up the map
// encoder.
int moe_init() {
  using namespace wg;
  const int errs[] = {
      allow_smem<true, 8>(),  allow_smem<true, 16>(),
      allow_smem<true, 32>(), allow_smem<true, 64>(),
      allow_smem<false, 8>(), allow_smem<false, 16>(),
      allow_smem<false, 32>(), allow_smem<false, 64>(),
      hopper::resolve_encoder()};
  for (int err : errs)
    if (err) return err;
  return 0;
}

// wgmma route: h [E, C, f] bf16 and flags [E] int32 are scratch; `sms`
// blocks walk the work items.  `counts` (int32 [E], or null) bounds each
// expert's rows, in every route.
int moe_mlp_bf16(const void* buf, const void* gate, const void* up,
                 const void* down, void* h, void* flags, const void* counts,
                 void* out, int E, int C, int d, int f, int sms,
                 void* stream) {
  return wg::moe_mlp(buf, gate, up, down, h, static_cast<int*>(flags),
                     static_cast<const int*>(counts), out, E, C, d, f, sms,
                     stream);
}

int moe_mlp_simple_bf16(const void* buf, const void* gate, const void* up,
                        const void* down, void* h, const void* counts,
                        void* out, int E, int C, int d, int f, void* stream) {
  return simple::moe_mlp<__nv_bfloat16>(buf, gate, up, down, h, nullptr,
                                        static_cast<const int*>(counts), out,
                                        E, C, d, f, stream);
}

int moe_mlp_f32(const void* buf, const void* gate, const void* up,
                const void* down, void* h, void* flags, const void* counts,
                void* out, int E, int C, int d, int f, void* stream) {
  return simple::moe_mlp<float>(buf, gate, up, down, h,
                                static_cast<int*>(flags),
                                static_cast<const int*>(counts), out, E, C, d,
                                f, stream);
}

}  // extern "C"
