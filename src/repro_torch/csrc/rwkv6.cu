// WKV6 recurrence (RWKV-6 "Finch" time mix) for Hopper (sm_90a): rwkv6.
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/rwkv6/kernel.py  rwkv6_pallas
// Per (batch row b, head h), with the state S [K, K] in fp32:
//   out_t[j] = sum_i r_t[i] * (u[i] * k_t[i] * v_t[j] + S[i][j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// r, k, v, w, out are [B, H, T, K] fp32 read and written through element
// strides (batch, head, time; the K stride is 1), so the kernel layout
// [B, H, T, K] and the model layout [B, T, H, K] take the same launch with no
// copy; s0, s_final [B, H, K, K] and u [H, K] are contiguous.  Any T >= 1 and
// K <= 64 (RWKV-6 uses K = 64).  Two routes:
//
// step (decode and short T): one block per (b, h) walks the T steps with the
// state in registers: thread (j, q) of 256 holds column j of the 16 state rows
// q*16 .. q*16+15 (the rows are independent, so the four row groups need no
// synchronisation inside a step).  The block stages CT = 16 time steps of r,
// k, v, w in shared memory, walks them (r_t, k_t, w_t read from shared memory
// as warp-wide broadcasts), leaves each row group's partial out_t[j] in shared
// memory and sums the four partials when the stage ends.  The Pallas kernel's
// grid walks time tiles in order with the state in VMEM scratch; here the
// time loop runs inside the block.  B * H blocks and T dependent steps: at a
// prefill (B 1, H 32) it fills 32 of 132 SMs and is latency bound.
//
// chunked (prefill): the positions are cut into chunks of L = 64, each into
// four sub-chunks of 16.  Write P(a, b)[i] = prod_{a < s <= b} w_s[i] (the
// empty product 1).  For a chunk c .. c+L-1 entered with state S:
//   out_t = (r_t * P(c-1, t-1)) . S
//         + sum_{c <= s < t} (sum_i r_t[i] k_s[i] P(s, t-1)[i]) v_s
//         + (sum_i r_t[i] u[i] k_t[i]) v_t
//   S'    = diag(P(c-1, c+L-1)) S + sum_s (k_s * P(s, c+L-1))^T v_s
// Every factor is a product of decays, never a quotient or a logarithm, so
// each is <= 1, nothing overflows, and w = 0 gives exact zeros (the log-space
// form of chunked linear attention turns log 0 = -inf into NaN).  Inside a
// sub-chunk the pairwise factors P(s, t-1) are running products; across
// sub-chunks P(s, t-1) = P(s, e_j) P(e_j, b_m) P(b_m, t-1), with e_j the end of
// s's sub-chunk j and b_m the position before t's sub-chunk m: a suffix
// product on k_s, the decays of the sub-chunks between, and a prefix product
// on r_t.  All fp32 FMA on the CUDA cores (no TF32: the route is held at
// 1e-5 of max|plain|), in three launches:
//   1. state: per (b, h, chunk) the chunk's own contribution
//      U_c = sum_s (k_s * P(s, end))^T v_s and its decay D_c = P(c-1, end),
//      into scratch;
//   2. carry: per (b, h, state element) the state each chunk starts from,
//      S_{c+1} = D_c S_c + U_c, written over U_c; the last is s_final;
//   3. out: per (b, h, chunk) the pairs inside each sub-chunk by running
//      products, the pairs across sub-chunks as 4x4 register tiles, then
//      (r * P) S + A V as 4x4 register tiles, from shared memory.
// Launches 1 and 3 copy their tiles by cp.async, all in flight at once, and
// start on the tiles the first steps need while the others arrive.  The
// scratch (state and decay per chunk) comes from the caller.
//
// Bound (RWKV6-1.6B: H 32, K 64, fp32; H100 SXM data sheet, 3.35 TB/s): a
// 512-token prefill (B 1) reads r, k, v, w and writes out, 5 x 4 MiB, plus the
// 0.5 MiB state in and out: 22 MB -> 6.6 us; a decode tick (B 8, T 1) moves
// mostly state, 8.4 MB -> 2.5 us.  The chunked route's ~3 K^2 FMAs a position
// (0.4 GFLOP at the prefill) take ~6 us at 67 TFLOP/s fp32: close to the byte
// bound, so FMA suffices.  What the chunked design leaves on the table: k, v,
// w are read by launches 1 and 3 (the second read mostly from L2), the chunk
// states go through memory (one [K, K] a chunk, the size of one input), and
// the 6 sub-chunk pairs of step 3 keep 192 of 256 threads busy.  The out
// launch is latency bound on the H100: its steps, separated by barriers,
// have 8 warps a block (two blocks an SM) to hide their shared-memory and
// FMA latencies with, and a prefill's blocks all load their tiles at once
// and then all compute.
#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 64;          // head size the blocks are laid out for

// element strides of one [B, H, T, K] operand; the K stride is 1
struct Strides {
  long long b, h, t;
};
struct Io {
  Strides r, k, v, w, o;
};

__device__ __forceinline__ long long row_base(const Strides& s, int b, int h) {
  return static_cast<long long>(b) * s.b + static_cast<long long>(h) * s.h;
}

// ---- step route ----------------------------------------------------------------
constexpr int Q = 4;              // row groups
constexpr int RQ = KMAX / Q;      // state rows per thread
constexpr int THREADS = KMAX * Q;
constexpr int CT = 16;            // time steps staged per pass

__global__ void __launch_bounds__(THREADS)
rwkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             float* __restrict__ out, float* __restrict__ s_final, Io st,
             int H, int T, int K) {
  __shared__ float rs[CT][KMAX], ks[CT][KMAX], vs[CT][KMAX], ws[CT][KMAX];
  __shared__ float part[Q][CT][KMAX];
  __shared__ float us[KMAX];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x % KMAX, q = threadIdx.x / KMAX;
  const bool col = j < K;
  const float* rb = r + row_base(st.r, b, h);
  const float* kb = k + row_base(st.k, b, h);
  const float* vb = v + row_base(st.v, b, h);
  const float* wb = w + row_base(st.w, b, h);
  float* ob = out + row_base(st.o, b, h);
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
      const long long t = t0 + tt;
      rs[tt][c] = rb[t * st.r.t + c];
      ks[tt][c] = kb[t * st.k.t + c];
      vs[tt][c] = vb[t * st.v.t + c];
      ws[tt][c] = wb[t * st.w.t + c];
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
      ob[(t0 + tt) * st.o.t + c] =
          (part[0][tt][c] + part[1][tt][c]) + (part[2][tt][c] + part[3][tt][c]);
    }
  }
#pragma unroll
  for (int ii = 0; ii < RQ; ++ii) {
    const int i = q * RQ + ii;
    if (col && i < K) s_final[so + static_cast<long long>(i) * K + j] = S[ii];
  }
}

// ---- chunked route ---------------------------------------------------------------
constexpr int L = 64;             // positions a chunk
constexpr int SUB = 16;           // positions a sub-chunk
constexpr int NSUB = L / SUB;
constexpr int LD = KMAX + 4;      // shared row stride (floats): 16-byte rows
                                  // that fall on different banks
constexpr int CK_THREADS = 256;
constexpr int TILE_FLOATS = L * LD;
constexpr int KK = KMAX * KMAX;

struct ChunkArgs {
  const float *r, *k, *v, *w, *u, *s0;
  float *out, *s_final;
  float* state;   // [B*H, NC, KMAX, KMAX]: each chunk's own contribution,
                  // then (after the carry) the state the chunk starts from
  float* decay;   // [B*H, NC, KMAX]: each chunk's decay P(c-1, end)
  Io st;
  int H, T, K, NC;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// 16-byte global -> shared copy, asynchronous (cp.async); with valid = false
// nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, n) of a chunk (row stride ts, K columns) into a shared tile of L
// rows of LD, asynchronously; rows past n and columns past K are zeros.
// K % 4 == 0.
__device__ void copy_tile(float* dst, const float* src, long long ts, int n,
                          int K) {
  for (int e = threadIdx.x; e < L * (KMAX / 4); e += CK_THREADS) {
    const int t = e / (KMAX / 4), c = (e % (KMAX / 4)) * 4;
    const bool valid = t < n && c < K;
    cp_async16(dst + t * LD + c, valid ? src + t * ts + c : src, valid);
  }
}

// After the decay tile's copies complete: its rows past n and columns past K
// read 1, which leaves every product as it is (the same threads as
// copy_tile, so no barrier is needed in between)
__device__ void pad_decays(float* ws, int n, int K) {
  if (n == L && K == KMAX) return;
  for (int e = threadIdx.x; e < L * (KMAX / 4); e += CK_THREADS) {
    const int t = e / (KMAX / 4), c = (e % (KMAX / 4)) * 4;
    if (t >= n || c >= K) st4(ws + t * LD + c, make_float4(1, 1, 1, 1));
  }
}

// outer-product accumulate: acc[a][b] += x[a] * y[b]
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 x,
                                       float4 y) {
  const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    acc[a][0] = fmaf(xs[a], y.x, acc[a][0]);
    acc[a][1] = fmaf(xs[a], y.y, acc[a][1]);
    acc[a][2] = fmaf(xs[a], y.z, acc[a][2]);
    acc[a][3] = fmaf(xs[a], y.w, acc[a][3]);
  }
}

// 1. Each chunk's own state contribution U = sum_s (k_s * P(s, end))^T v_s
//    and its decay D = P(c-1, end).  Block (chunk, b*H + h).
__global__ void __launch_bounds__(CK_THREADS)
rwkv6_chunk_state_kernel(ChunkArgs a) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + TILE_FLOATS;
  float* ws = vs + TILE_FLOATS;
  __shared__ float dsub[NSUB][KMAX];

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int t0 = c * L, n = min(L, a.T - t0);
  const int tid = threadIdx.x;
  // k and w first (the decay products need them), v behind them
  copy_tile(ks, a.k + row_base(a.st.k, b, h) + t0 * a.st.k.t, a.st.k.t, n,
            a.K);
  copy_tile(ws, a.w + row_base(a.st.w, b, h) + t0 * a.st.w.t, a.st.w.t, n,
            a.K);
  cp_async_commit();
  copy_tile(vs, a.v + row_base(a.st.v, b, h) + t0 * a.st.v.t, a.st.v.t, n,
            a.K);
  cp_async_commit();
  cp_async_wait<1>();
  pad_decays(ws, n, a.K);
  __syncthreads();

  // k_s <- k_s * P(s, end of its sub-chunk); thread (column i, sub-chunk m)
  const int i = tid % KMAX, m = tid / KMAX;
  {
    float q = 1.0f;
#pragma unroll
    for (int sl = SUB - 1; sl >= 0; --sl) {
      const int s = m * SUB + sl;
      ks[s * LD + i] *= q;
      q *= ws[s * LD + i];
    }
    dsub[m][i] = q;
  }
  __syncthreads();
  // ... times the decays of the later sub-chunks: k_s * P(s, end)
  {
    float q = 1.0f;
    for (int l = m + 1; l < NSUB; ++l) q *= dsub[l][i];
#pragma unroll
    for (int sl = 0; sl < SUB; ++sl) ks[(m * SUB + sl) * LD + i] *= q;
    if (m == 0)
      a.decay[(static_cast<long long>(bh) * a.NC + c) * KMAX + i] =
          dsub[0][i] * q;
  }
  cp_async_wait<0>();
  __syncthreads();

  // U[i0..i0+3][j0..j0+3] over the chunk's positions
  const int i0 = (tid / 16) * 4, j0 = (tid % 16) * 4;
  float acc[4][4] = {};
  for (int s = 0; s < n; ++s)
    outer4(acc, ld4(ks + s * LD + i0), ld4(vs + s * LD + j0));
  float* u_out = a.state + (static_cast<long long>(bh) * a.NC + c) * KK;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    st4(u_out + (i0 + r) * KMAX + j0,
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
}

// 2. The state each chunk starts from, written over its contribution:
//    S_0 = s0, S_{c+1} = D_c S_c + U_c; s_final = S_NC.  Block (element
//    group, b*H + h), one state element a thread; a batch's loads are issued
//    together (past the last chunk they reread it).
constexpr int CARRY_BATCH = 8;

__global__ void __launch_bounds__(CK_THREADS)
rwkv6_chunk_carry_kernel(ChunkArgs a) {
  const int bh = blockIdx.y;
  const int e = blockIdx.x * CK_THREADS + threadIdx.x;
  const int i = e / KMAX, j = e % KMAX;
  const bool live = i < a.K && j < a.K;
  const long long so = static_cast<long long>(bh) * a.K * a.K + i * a.K + j;
  float S = live ? a.s0[so] : 0.0f;
  float* st = a.state + static_cast<long long>(bh) * a.NC * KK + e;
  const float* d = a.decay + static_cast<long long>(bh) * a.NC * KMAX + i;
  for (int c0 = 0; c0 < a.NC; c0 += CARRY_BATCH) {
    float uu[CARRY_BATCH], dd[CARRY_BATCH];
#pragma unroll
    for (int q = 0; q < CARRY_BATCH; ++q) {
      const long long cc = min(c0 + q, a.NC - 1);
      uu[q] = st[cc * KK];
      dd[q] = d[cc * KMAX];
    }
#pragma unroll
    for (int q = 0; q < CARRY_BATCH; ++q)
      if (c0 + q < a.NC) {
        st[static_cast<long long>(c0 + q) * KK] = S;
        S = fmaf(dd[q], S, uu[q]);
      }
  }
  if (live) a.s_final[so] = S;
}

// 3. Each chunk's outputs from the state it starts from.  Block (chunk,
//    b*H + h).
__global__ void __launch_bounds__(CK_THREADS, 2)
rwkv6_chunk_out_kernel(ChunkArgs a) {
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);   // r, then r * prefix
  float* ks = rs + TILE_FLOATS;                  // k, then k * suffix
  float* vs = ks + TILE_FLOATS;
  float* ws = vs + TILE_FLOATS;                  // w, then (r * P)^T [i][t]
  float* ss = ws + TILE_FLOATS;                  // S [i][j]
  float* at = ss + TILE_FLOATS;                  // A^T [s][t]
  __shared__ __align__(16) float us[KMAX];
  __shared__ __align__(16) float dsub[NSUB][KMAX];

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int t0 = c * L, n = min(L, a.T - t0);
  const int tid = threadIdx.x;
  // r, k, w first (steps a-d need them); v and the state this chunk starts
  // from (written by the carry launch) arrive behind them, for step e
  copy_tile(rs, a.r + row_base(a.st.r, b, h) + t0 * a.st.r.t, a.st.r.t, n,
            a.K);
  copy_tile(ks, a.k + row_base(a.st.k, b, h) + t0 * a.st.k.t, a.st.k.t, n,
            a.K);
  copy_tile(ws, a.w + row_base(a.st.w, b, h) + t0 * a.st.w.t, a.st.w.t, n,
            a.K);
  cp_async_commit();
  copy_tile(vs, a.v + row_base(a.st.v, b, h) + t0 * a.st.v.t, a.st.v.t, n,
            a.K);
  const float* s_in = a.state + (static_cast<long long>(bh) * a.NC + c) * KK;
  for (int e = tid; e < KK / 4; e += CK_THREADS) {
    const int i = e / (KMAX / 4), j = (e % (KMAX / 4)) * 4;
    cp_async16(ss + i * LD + j, s_in + i * KMAX + j, true);
  }
  cp_async_commit();
  for (int e = tid; e < TILE_FLOATS; e += CK_THREADS) at[e] = 0.0f;
  if (tid < KMAX) us[tid] = tid < a.K ? a.u[h * a.K + tid] : 0.0f;
  cp_async_wait<1>();
  pad_decays(ws, n, a.K);
  __syncthreads();

  // (a) pairs inside a sub-chunk, s < t, by running products of the decays,
  //     and the bonus term s = t.  Thread (t, g) takes the 16 columns
  //     16 q + 4 g .. +3, q = 0..3 (a warp's four g read 64 contiguous bytes).
  {
    const int t = tid / 4, g = tid % 4;
    const int tl = t % SUB, base = t - tl;
    float p[16];
    float diag = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 16 * q + 4 * g;
      const float4 rr = ld4(rs + t * LD + col);
      const float4 kk = ld4(ks + t * LD + col);
      const float4 uu = ld4(us + col);
      p[4 * q] = rr.x; p[4 * q + 1] = rr.y; p[4 * q + 2] = rr.z;
      p[4 * q + 3] = rr.w;
      diag += rr.x * uu.x * kk.x + rr.y * uu.y * kk.y + rr.z * uu.z * kk.z +
              rr.w * uu.w * kk.w;
    }
    float acc[SUB - 1];
    // s = base + sl from t - 1 down: p = r_t * P(s, t - 1), one more decay a
    // step (w_{s+1}); the lanes past their own t multiply by 1.  A warp's 8
    // positions lie in one half of a sub-chunk, so the first half's warps
    // stop at sl = 6
    const int top = __shfl_sync(0xffffffffu, tl, 31);
#pragma unroll
    for (int sl = SUB - 2; sl >= 0; --sl) {
      if (sl >= top) continue;
      const int s = base + sl;
      const bool more = sl + 1 < tl;
      float sum[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = 16 * q + 4 * g;
        const float4 ww = ld4(ws + (s + 1) * LD + col);
        const float4 kk = ld4(ks + s * LD + col);
        p[4 * q] *= more ? ww.x : 1.0f;
        p[4 * q + 1] *= more ? ww.y : 1.0f;
        p[4 * q + 2] *= more ? ww.z : 1.0f;
        p[4 * q + 3] *= more ? ww.w : 1.0f;
        sum[q] = p[4 * q] * kk.x + p[4 * q + 1] * kk.y + p[4 * q + 2] * kk.z +
                 p[4 * q + 3] * kk.w;
      }
      acc[sl] = (sum[0] + sum[1]) + (sum[2] + sum[3]);
    }
#pragma unroll
    for (int sl = 0; sl < SUB - 1; ++sl) {
      if (sl >= top) break;
      acc[sl] += __shfl_xor_sync(0xffffffffu, acc[sl], 1);
      acc[sl] += __shfl_xor_sync(0xffffffffu, acc[sl], 2);
    }
    diag += __shfl_xor_sync(0xffffffffu, diag, 1);
    diag += __shfl_xor_sync(0xffffffffu, diag, 2);
#pragma unroll
    for (int sl = 0; sl < SUB - 1; ++sl)
      if (sl < tl && sl % 4 == g) at[(base + sl) * LD + t] = acc[sl];
    if (g == 0) at[t * LD + t] = diag;
  }
  __syncthreads();

  // (b) r_t <- r_t * P(b_m, t-1) (prefix inside the sub-chunk), k_s <- k_s *
  //     P(s, e_j) (suffix inside the sub-chunk), the sub-chunk decays.
  //     Thread (column i, sub-chunk m).
  const int i = tid % KMAX, m = tid / KMAX;
  {
    float p = 1.0f, q = 1.0f;
#pragma unroll
    for (int tl = 0; tl < SUB; ++tl) {
      const int t = m * SUB + tl;
      rs[t * LD + i] *= p;
      p *= ws[t * LD + i];
    }
#pragma unroll
    for (int sl = SUB - 1; sl >= 0; --sl) {
      const int s = m * SUB + sl;
      ks[s * LD + i] *= q;
      q *= ws[s * LD + i];
    }
    dsub[m][i] = p;
  }
  __syncthreads();

  // (c) (r_t * P(c-1, t-1))^T into the w tile: the prefix times the decays of
  //     the earlier sub-chunks
  {
    float q = 1.0f;
    for (int l = 0; l < m; ++l) q *= dsub[l][i];
#pragma unroll
    for (int tl = 0; tl < SUB; ++tl) {
      const int t = m * SUB + tl;
      ws[i * LD + t] = rs[t * LD + i] * q;
    }
  }
  // (d) pairs across sub-chunks j < m: A[t][s] = sum_i r~_t[i] prod_{j<l<m}
  //     D_l[i] k~_s[i]: one 4 x 4 tile over the 6 pairs a lane pair, each
  //     lane every other 4 columns, summed by a shuffle (six warps)
  if (tid < 2 * 6 * 16) {
    // pairs (m, j) in the order (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
    const int half = tid % 2, job = tid / 2;
    const int pair = job / 16, tile = job % 16;
    const int pm = pair < 1 ? 1 : pair < 3 ? 2 : 3;
    const int pj = pair - pm * (pm - 1) / 2;
    const int tt = pm * SUB + (tile / 4) * 4, s0 = pj * SUB + (tile % 4) * 4;
    float acc[4][4] = {};
    // a warp holds one pair: adjacent sub-chunks (j + 1 = m) have no decay
    // between them
    const bool adjacent = pj + 1 == pm;
#pragma unroll 2
    for (int col = 4 * half; col < KMAX; col += 8) {
      float4 between = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
      if (!adjacent) {
        between = ld4(&dsub[pj + 1][col]);
        if (pj + 2 < pm) {
          const float4 d = ld4(&dsub[pj + 2][col]);
          between.x *= d.x; between.y *= d.y; between.z *= d.z;
          between.w *= d.w;
        }
      }
      float4 kk[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        kk[q] = ld4(ks + (s0 + q) * LD + col);
        kk[q].x *= between.x; kk[q].y *= between.y; kk[q].z *= between.z;
        kk[q].w *= between.w;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 rr = ld4(rs + (tt + r) * LD + col);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] += dot4(rr, kk[q]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[r][q] += __shfl_xor_sync(0xffffffffu, acc[r][q], 1);
        if (r / 2 == half) at[(s0 + q) * LD + tt + r] = acc[r][q];
      }
  }
  cp_async_wait<0>();
  __syncthreads();

  // (e) out[t0..t0+3][j0..j0+3] = (r * P)^T-rows . S + A V
  const int tq = (tid / 16) * 4, j0 = (tid % 16) * 4;
  float o[4][4] = {};
  for (int ii = 0; ii < KMAX; ++ii)
    outer4(o, ld4(ws + ii * LD + tq), ld4(ss + ii * LD + j0));
  for (int s = 0; s < tq + 4; ++s)
    outer4(o, ld4(at + s * LD + tq), ld4(vs + s * LD + j0));
  if (j0 < a.K) {
    float* ob = a.out + row_base(a.st.o, b, h) + t0 * a.st.o.t;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (tq + r < n)
        st4(ob + (tq + r) * a.st.o.t + j0,
            make_float4(o[r][0], o[r][1], o[r][2], o[r][3]));
  }
}

constexpr size_t STATE_SMEM = 3 * TILE_FLOATS * sizeof(float);
constexpr size_t OUT_SMEM = 6 * TILE_FLOATS * sizeof(float);

Io read_strides(const long long* s) {
  Io io;
  Strides* dst[5] = {&io.r, &io.k, &io.v, &io.w, &io.o};
  for (int n = 0; n < 5; ++n) *dst[n] = {s[3 * n], s[3 * n + 1], s[3 * n + 2]};
  return io;
}

}  // namespace

extern "C" {

int rwkv6_head_max() { return KMAX; }
int rwkv6_chunk_len() { return L; }

// strides: (batch, head, time) element strides of r, k, v, w and out
int rwkv6_f32(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* out, void* s_final, int B,
              int H, int T, int K, const long long* strides, void* stream) {
  if (B < 0 || H < 0 || T < 0 || K <= 0 || K > KMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  rwkv6_kernel<<<B * H, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(s_final),
      read_strides(strides), H, T, K);
  return static_cast<int>(cudaGetLastError());
}

// scratch: B*H*ceil(T/L)*(KMAX*KMAX + KMAX) floats, 16-byte aligned; the
// operands' bases and strides multiples of 16 bytes, K % 4 == 0
int rwkv6_chunked_f32(const void* r, const void* k, const void* v,
                      const void* w, const void* u, const void* s0, void* out,
                      void* s_final, void* scratch, int B, int H, int T, int K,
                      const long long* strides, void* stream) {
  if (B < 0 || H < 0 || T <= 0 || K <= 0 || K > KMAX || K % 4 != 0 ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  ChunkArgs a;
  a.r = static_cast<const float*>(r); a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v); a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u); a.s0 = static_cast<const float*>(s0);
  a.out = static_cast<float*>(out); a.s_final = static_cast<float*>(s_final);
  a.st = read_strides(strides);
  a.H = H; a.T = T; a.K = K;
  a.NC = (T + L - 1) / L;
  a.state = static_cast<float*>(scratch);
  a.decay = a.state + static_cast<long long>(B) * H * a.NC * KK;
  // the shared-memory limits are raised once, so that a launch recorded
  // into a CUDA graph makes no attribute call
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(
        rwkv6_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(STATE_SMEM));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(rwkv6_chunk_out_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(OUT_SMEM));
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 chunks(a.NC, B * H);
  rwkv6_chunk_state_kernel<<<chunks, CK_THREADS, STATE_SMEM, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_chunk_carry_kernel<<<dim3(KK / CK_THREADS, B * H), CK_THREADS, 0,
                             s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_chunk_out_kernel<<<chunks, CK_THREADS, OUT_SMEM, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
