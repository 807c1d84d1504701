// Mamba selective scan, the op graph's mamba_scan stage, for Hopper
// (sm_90a): mamba_scan.
//
// Replaces no TPU kernel: the JAX package leaves the scan to XLA (its op
// graph's scan payload and models/ssm.py are plain jnp code).  The port's
// plain version (kernels/mamba_scan/ref.py) makes the decays and inputs of
// every step as fp32 [B, T, di, N] tensors and then launches one small
// kernel a position, each waiting on the last: 529 kernels a layer in
// Hymba's op graph, bound by launch latency.  This kernel is the whole stage
// in one launch.
//
// packed [B, T, W], W = 2 di + 2 N + 1, holds x | z | B | C | dt_raw (the
// xproj stage's output) in bf16 or fp32, read through its batch and time
// element strides (the last stride is 1); a_log [di, N] and d_skip [di] are
// fp32 and contiguous; out [B, T, di] is contiguous in packed's dtype.  Per
// batch row, from the zero state:
//   delta_t   = softplus(dt_raw_t) + 1e-4          (one per position)
//   A[d][n]   = -exp(a_log[d][n])
//   h_t[d][n] = exp(delta_t A[d][n]) h_{t-1}[d][n] + delta_t x_t[d] B_t[n]
//   y_t[d]    = sum_n C_t[n] h_t[d][n] + d_skip[d] x_t[d]
//   out_t[d]  = y_t[d] silu(z_t[d])
// Arithmetic and state are fp32; the output is rounded once.  Any T >= 1,
// N <= 64 (Hymba's N is 16).
//
// Bound (Hymba-1.5B: di 3200, N 16, bf16; B 1, T 512; H100 SXM data sheet,
// 3.35 TB/s and 67 TFLOP/s fp32): packed read once is 512 x 6433 x 2 B =
// 6.59 MB, out written once 3.28 MB, 2.9 us a layer; the 7 operations a
// (position, channel, state) make 183 MFLOP, 2.7 us at the fp32 peak.  What
// holds the kernel above that is the walk over T: each channel's state is a
// chain of T dependent updates, and at B 1 there are only di x N = 51200 of
// them, so each warp's chain runs at a low instruction rate and the time is
// that of one warp's T steps plus its share of staging and gating.
//
// Design.  Eight lanes own a channel, each KPT consecutive states of it (N
// padded to 8 KPT with zero B, C and A; KPT 2 at N 16), h in fp32
// registers.  A block is CPB = 16 channels, four warps, so at B 1 the
// di / 16 = 200 blocks cover all 132 SMs.  The block walks T in chunks of
// CH = 16 positions; an iteration gates chunk k - 1, stages chunk k + 1,
// starts the loads of chunk k + 2 and computes chunk k, with one barrier,
// over three buffers of staged inputs and two of shares:
// - staging: the loads are plain, not cp.async (packed's rows are W elements
//   apart and W is odd, so a bf16 row is only 2-byte aligned), into
//   registers, in the iteration before the one that stores them, so that the
//   compiler cannot move them down to their use; a warp reads 32-column blocks
//   of a row's B | C (shared by every channel of the row), lanes 0 .. 15 the
//   rows' dt_raw, and the block's x and z as 16 consecutive channels.  The
//   store converts to fp32 and dt_raw to delta; a position past T stages
//   delta 0 and x 0, which leave h as it is, so a chunk always runs all CH
//   steps with no branch;
// - steps: in groups of G = 4, first the loads, decays (ex2.approx of
//   delta A log2(e), A log2(e) made once per state from expf) and inputs
//   (delta x B) of the group's steps, none of which depends on h, then the
//   four state updates (FMA) and each step's share of C.h, kept in shared
//   memory: no shuffle and no atomic in the chain;
// - gate: the eight shares of a (position, channel) are summed (two 16-byte
//   loads), D x added, silu(z) applied (__expf, __fdividef), the result
//   rounded once and stored, 16 consecutive channels of a row at a time.
// Nothing of size B T di N touches device memory; no atomics, no scratch, no
// allocation, and the result does not depend on the launch order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 8;               // lanes of one channel
constexpr int CPB = 16;                // channels of a block
constexpr int THREADS = LANES * CPB;   // four warps
constexpr int WARPS = THREADS / 32;
constexpr int CH = 16;                 // positions of a staged chunk
constexpr int G = 4;                   // steps of a group (a divisor of CH)
constexpr int KMAX = 8;                // most states a lane
constexpr int NMAX = LANES * KMAX;     // most states (64)
constexpr int XZ = CH * CPB / THREADS; // x (and z) elements of a lane a chunk
constexpr float LOG2E = 1.4426950408889634f;
static_assert(LANES == 8, "the gate sums a channel's shares as two float4");
static_assert(THREADS % 32 == 0 && CH <= THREADS, "whole warps; a lane a row");
static_assert((CH * CPB) % THREADS == 0 && CH % G == 0, "even splits");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 2^x, x <= 0 here: the decays lie in (0, 1]; one below 2^-126 flushes to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(delta A) as 2^(delta A log2(e)), a2 = A log2(e)
__device__ __forceinline__ float decay(float dt, float a2) {
  return exp2_approx(dt * a2);
}

// softplus with PyTorch's default threshold (beta 1, threshold 20)
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

template <int KPT>
__device__ __forceinline__ void load_states(float (&v)[KPT], const float* p) {
  if constexpr (KPT % 4 == 0) {
#pragma unroll
    for (int k = 0; k < KPT; k += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + k);
      v[k] = f.x; v[k + 1] = f.y; v[k + 2] = f.z; v[k + 3] = f.w;
    }
  } else if constexpr (KPT == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

template <typename T, int KPT>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const T* __restrict__ packed, const float* __restrict__ a_log,
                  const float* __restrict__ d_skip, T* __restrict__ out,
                  int seq, int di, int n, long long sb, long long st) {
  constexpr int NP = LANES * KPT;                  // states with the padding
  constexpr int CB = (2 * NP + 31) / 32;           // 32-column blocks of B | C
  constexpr int UB = (CH * CB + WARPS - 1) / WARPS;  // (row, block)s a warp
  // three buffers of the staged inputs (the chunk being computed, the next
  // one, and the one before, whose outputs are being gated), two of shares
  __shared__ float s_dt[3][CH];
  // B in columns [0, NP), C in [NP, 2 NP); the padded states stay zero
  __shared__ __align__(16) float s_bc[3][CH][2 * NP];
  __shared__ float s_x[3][CH][CPB];
  __shared__ float s_z[3][CH][CPB];
  __shared__ __align__(16) float s_part[2][CH][THREADS];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = tid / LANES, q = tid % LANES;   // the step's channel, lane
  const int d0 = blockIdx.x * CPB;
  const T* row = packed + (long long)blockIdx.y * sb;
  T* orow = out + (long long)blockIdx.y * seq * di;
  // staging: a warp loads (row, 32-column block)s of B | C, lane l column l
  // of the block, so a row is read in whole sectors; lanes 0 .. CH-1 load
  // the rows' dt_raw; x and z of channel xc at positions xp0 + THREADS/CPB
  // r, which are also the epilogue's elements
  const int xc = tid % CPB, xp0 = tid / CPB;
  const bool xc_ok = d0 + xc < di;

  for (int i = tid; i < 3 * CH * 2 * NP; i += THREADS)
    (&s_bc[0][0][0])[i] = 0.f;
  float a2[KPT], h[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int s = q * KPT + k;
    a2[k] = (d0 + c < di && s < n)
                ? -expf(a_log[(long long)(d0 + c) * n + s]) * LOG2E : 0.f;
    h[k] = 0.f;
  }
  const float dsk = xc_ok ? d_skip[d0 + xc] : 0.f;

  T r_bc[UB], r_dt, r_x[XZ], r_z[XZ];
  auto load = [&](int t0) {
#pragma unroll
    for (int r = 0; r < UB; ++r) {
      const int u = warp + WARPS * r, t = t0 + u / CB;
      const int j = (u % CB) * 32 + lane;
      if (u < CH * CB && t < seq && j < 2 * n)
        r_bc[r] = row[(long long)t * st + 2 * di + j];
    }
    if (tid < CH && t0 + tid < seq)
      r_dt = row[(long long)(t0 + tid) * st + 2 * di + 2 * n];
#pragma unroll
    for (int r = 0; r < XZ; ++r) {
      const int t = t0 + xp0 + r * (THREADS / CPB);
      if (t < seq && xc_ok) {
        const T* px = row + (long long)t * st + d0 + xc;
        r_x[r] = px[0];
        r_z[r] = px[di];
      }
    }
  };
  // past the sequence a row stages delta 0 and x 0: its steps leave h as it
  // is, so a chunk always runs all CH steps
  auto store = [&](int buf, int t0) {
#pragma unroll
    for (int r = 0; r < UB; ++r) {
      const int u = warp + WARPS * r, p = u / CB;
      const int j = (u % CB) * 32 + lane;
      if (u < CH * CB && t0 + p < seq && j < 2 * n)
        s_bc[buf][p][j < n ? j : j - n + NP] = to_f(r_bc[r]);
    }
    if (tid < CH)
      s_dt[buf][tid] = t0 + tid < seq ? softplus(to_f(r_dt)) + 1e-4f : 0.f;
#pragma unroll
    for (int r = 0; r < XZ; ++r) {
      const int p = xp0 + r * (THREADS / CPB);
      const bool ok = t0 + p < seq && xc_ok;
      s_x[buf][p][xc] = ok ? to_f(r_x[r]) : 0.f;
      s_z[buf][p][xc] = ok ? to_f(r_z[r]) : 0.f;
    }
  };
  // sum each (position, channel)'s shares, add D x, gate by silu(z), round
  // once and store
  auto gate = [&](int buf, int part, int t0) {
#pragma unroll
    for (int r = 0; r < XZ; ++r) {
      const int p = xp0 + r * (THREADS / CPB);
      if (t0 + p < seq && xc_ok) {
        const float4* sp =
            reinterpret_cast<const float4*>(&s_part[part][p][xc * LANES]);
        const float4 lo = sp[0], hi = sp[1];
        const float sum = ((lo.x + lo.y) + (lo.z + lo.w)) +
                          ((hi.x + hi.y) + (hi.z + hi.w));
        const float x = s_x[buf][p][xc], z = s_z[buf][p][xc];
        put(orow + (long long)(t0 + p) * di + d0 + xc,
            (sum + dsk * x) * z * __fdividef(1.f, 1.f + __expf(-z)));
      }
    }
  };

  __syncthreads();                 // the zero padding before the first store
  load(0);
  store(0, 0);
  if (CH < seq) load(CH);
  __syncthreads();
  // chunk k: inputs in buffer k % 3, shares in part k % 2.  An iteration
  // gates chunk k - 1, stages chunk k + 1 (loaded one iteration ago), loads
  // chunk k + 2 and computes chunk k, with one barrier, so the gate's and
  // the staging's latencies hide behind the steps'
  int k = 0, buf = 0;
  for (int t0 = 0; t0 < seq; t0 += CH, ++k) {
    const int prev = buf == 0 ? 2 : buf - 1, next = buf == 2 ? 0 : buf + 1;
    if (k > 0) gate(prev, (k - 1) & 1, t0 - CH);
    if (t0 + CH < seq) store(next, t0 + CH);
    if (t0 + 2 * CH < seq) load(t0 + 2 * CH);
    // the chain: nothing in a step but h depends on the step before; in
    // groups of G steps, first the loads, decays and inputs of the group's
    // steps (independent of h), then their state updates
#pragma unroll
    for (int g = 0; g < CH; g += G) {
      float e[G][KPT], u[G][KPT], cc[G][KPT];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float dt = s_dt[buf][g + i];
        const float dx = dt * s_x[buf][g + i][c];
        float bb[KPT];
        load_states<KPT>(bb, &s_bc[buf][g + i][q * KPT]);
        load_states<KPT>(cc[i], &s_bc[buf][g + i][NP + q * KPT]);
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          e[i][j] = decay(dt, a2[j]);
          u[i][j] = dx * bb[j];
        }
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          h[j] = fmaf(e[i][j], h[j], u[i][j]);
          acc = fmaf(cc[i][j], h[j], acc);
        }
        s_part[k & 1][g + i][tid] = acc;
      }
    }
    __syncthreads();               // chunk k's shares and chunk k + 1's
    buf = next;                    // inputs are whole
  }
  if (k > 0) gate(buf == 0 ? 2 : buf - 1, (k - 1) & 1, (k - 1) * CH);
}

template <typename T>
int launch(const void* packed, const float* a_log, const float* d_skip,
           void* out, int b, int t, int di, int n, long long sb, long long st,
           cudaStream_t stream) {
  if (b < 1 || b > 65535 || t < 1 || di < 1 || n < 1 || n > NMAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((di + CPB - 1) / CPB, b);
  const T* p = static_cast<const T*>(packed);
  T* o = static_cast<T*>(out);
  const int kpt = (n + LANES - 1) / LANES;   // 1, 2, 4 or 8 states a lane
  if (kpt <= 1)
    mamba_scan_kernel<T, 1><<<grid, THREADS, 0, stream>>>(
        p, a_log, d_skip, o, t, di, n, sb, st);
  else if (kpt <= 2)
    mamba_scan_kernel<T, 2><<<grid, THREADS, 0, stream>>>(
        p, a_log, d_skip, o, t, di, n, sb, st);
  else if (kpt <= 4)
    mamba_scan_kernel<T, 4><<<grid, THREADS, 0, stream>>>(
        p, a_log, d_skip, o, t, di, n, sb, st);
  else
    mamba_scan_kernel<T, 8><<<grid, THREADS, 0, stream>>>(
        p, a_log, d_skip, o, t, di, n, sb, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// packed [B, T, 2 di + 2 N + 1] with element strides (sb, st, 1); a_log
// [di, N], d_skip [di] fp32 contiguous; out [B, T, di] contiguous
int mamba_scan_bf16(const void* packed, const float* a_log,
                    const float* d_skip, void* out, int b, int t, int di,
                    int n, long long sb, long long st, void* stream) {
  return launch<__nv_bfloat16>(packed, a_log, d_skip, out, b, t, di, n, sb,
                               st, static_cast<cudaStream_t>(stream));
}

int mamba_scan_f32(const void* packed, const float* a_log, const float* d_skip,
                   void* out, int b, int t, int di, int n, long long sb,
                   long long st, void* stream) {
  return launch<float>(packed, a_log, d_skip, out, b, t, di, n, sb, st,
                       static_cast<cudaStream_t>(stream));
}

int mamba_scan_max_state() { return NMAX; }

}  // extern "C"
