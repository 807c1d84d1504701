// WKV6 recurrence (RWKV-6 "Finch" time mix) for Hopper (sm_90a): rwkv6.
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/rwkv6/kernel.py  rwkv6_pallas
// Per (batch row b, head h), with the state S [K, K] in fp32:
//   out_t[j] = sum_i r_t[i] * (u[i] * k_t[i] * v_t[j] + S[i][j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// r, k, v, w, out [B, H, T, K] and s0, s_final [B, H, K, K] fp32 row-major,
// u [H, K]; any T >= 1 and K <= 64 (RWKV-6 uses K = 64).
//
// One block per (b, h); the state never leaves the chip during the T loop:
// thread (j, q) of 256 holds column j of the 16 state rows q*16 .. q*16+15 in
// registers (the rows are independent, so the four row groups need no
// synchronisation inside a step).  The block stages CT = 16 time steps of r,
// k, v, w in shared memory with coalesced loads, walks them (r_t, k_t, w_t
// are read from shared memory as warp-wide broadcasts), leaves each row
// group's partial out_t[j] in shared memory and sums the four partials when
// the stage ends.  The Pallas kernel's grid walks time tiles in order with
// the state in VMEM scratch; here the time loop runs inside the block.
//
// Bound (RWKV6-1.6B: H 32, K 64, fp32; H100 SXM data sheet, 3.35 TB/s): a
// 512-token prefill (B 1) reads r, k, v, w and writes out, 5 x 4 MiB, plus the
// 0.5 MiB state in and out: 22 MB -> 6.6 us; a decode tick (B 8, T 1) moves
// mostly state, 8.4 MB -> 2.5 us.  Bound by bytes: the 4 K^2 B H T FLOPs
// (0.27 GFLOP at the prefill) take 4 us at 67 TFLOP/s fp32.
// What this simple design leaves on the table: B * H = 32 blocks for 132 SMs
// at a prefill, and T dependent steps per block, so the prefill is latency
// bound; the chunked form (intra-chunk products on the tensor cores, an
// inter-chunk state carry) is the later change.
#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 64;          // head size the block is laid out for
constexpr int Q = 4;              // row groups
constexpr int RQ = KMAX / Q;      // state rows per thread
constexpr int THREADS = KMAX * Q;
constexpr int CT = 16;            // time steps staged per pass

__global__ void __launch_bounds__(THREADS)
rwkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             float* __restrict__ out, float* __restrict__ s_final, int H,
             int T, int K) {
  __shared__ float rs[CT][KMAX], ks[CT][KMAX], vs[CT][KMAX], ws[CT][KMAX];
  __shared__ float part[Q][CT][KMAX];
  __shared__ float us[KMAX];

  const int bh = blockIdx.x;
  const int h = bh % H;
  const int j = threadIdx.x % KMAX, q = threadIdx.x / KMAX;
  const bool col = j < K;
  const long long io = static_cast<long long>(bh) * T * K;
  const long long so = static_cast<long long>(bh) * K * K;

  float S[RQ];
#pragma unroll
  for (int ii = 0; ii < RQ; ++ii) {
    const int i = q * RQ + ii;
    S[ii] = (col && i < K) ? s0[so + static_cast<long long>(i) * K + j] : 0.0f;
  }
  if (threadIdx.x < KMAX)
    us[threadIdx.x] = threadIdx.x < K ? u[h * K + threadIdx.x] : 0.0f;

  for (int t0 = 0; t0 < T; t0 += CT) {
    const int n = min(CT, T - t0);
    __syncthreads();                 // the previous pass's partials are read
    for (int e = threadIdx.x; e < n * K; e += THREADS) {
      const int tt = e / K, c = e % K;
      const long long g = io + static_cast<long long>(t0) * K + e;
      rs[tt][c] = r[g];
      ks[tt][c] = k[g];
      vs[tt][c] = v[g];
      ws[tt][c] = w[g];
    }
    __syncthreads();
    if (col) {
      for (int tt = 0; tt < n; ++tt) {
        const float vj = vs[tt][j];
        float o = 0.0f;
#pragma unroll
        for (int ii = 0; ii < RQ; ++ii) {
          const int i = q * RQ + ii;
          if (i < K) {
            const float kv = ks[tt][i] * vj;
            o += rs[tt][i] * (us[i] * kv + S[ii]);
            S[ii] = ws[tt][i] * S[ii] + kv;
          }
        }
        part[q][tt][j] = o;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n * K; e += THREADS) {
      const int tt = e / K, c = e % K;
      out[io + static_cast<long long>(t0) * K + e] =
          (part[0][tt][c] + part[1][tt][c]) + (part[2][tt][c] + part[3][tt][c]);
    }
  }
#pragma unroll
  for (int ii = 0; ii < RQ; ++ii) {
    const int i = q * RQ + ii;
    if (col && i < K) s_final[so + static_cast<long long>(i) * K + j] = S[ii];
  }
}

}  // namespace

extern "C" {

int rwkv6_head_max() { return KMAX; }

int rwkv6_f32(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* out, void* s_final, int B,
              int H, int T, int K, void* stream) {
  if (B < 0 || H < 0 || T < 0 || K <= 0 || K > KMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  rwkv6_kernel<<<B * H, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(s_final), H, T, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
