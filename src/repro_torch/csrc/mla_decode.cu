// MLA paged decode for Hopper (sm_90a): DeepSeek-V3's absorbed latent
// attention of one query token per sequence through a block table.
//
// Replaces the MLA form of the JAX package's paged decode,
//   src/repro/kernels/paged_decode/ops.py      paged_mla_decode_attention
// which absorbs q_nope through wk_b (a product outside the Pallas call, done
// by the wrapper here too) and runs
//   src/repro/kernels/paged_decode/kernel.py   paged_decode_attention_pallas
// with one latent KV head: softmax(q_cat k_cat^T * scale) V over positions
// [0, lengths[b]) with q_cat = [q_lat | q_pe] (Dk = rank + rope = 576 on
// DeepSeek-V3), k_cat = [ckv | kpe] and V = ckv (Dv = rank = 512), all 128
// query heads on the one KV head.  fp32 statistics and accumulation, masked
// logits -1e30, output [B, H, rank] in the input dtype.  As in the port's
// other attention kernels the softmax is online and the unnormalised
// p = exp(s - running max) is rounded to the V dtype for the P V product
// (the plain version rounds the normalised p), so the two differ by about an
// ulp of the output.
//
// Design.  The GQA decode routine in attention.cu gives each position to a
// thread and each head a register; at 128 heads of 576 that would not fit
// (its query tile alone would be 295 KB of shared memory).  Here the heads
// are the M dimension of two matrix products: a block takes HG = 16 heads of
// one batch row and one split of the positions, and walks the split in tiles
// of CH = 32 positions:
//   S[16 x 32] = Q[16 x Dk] K^T        (bf16 WMMA, fp32 accumulate; the Dk
//                                       reduction split over 4 warp pairs)
//   online softmax per head row in fp32, p rounded to the V dtype
//   O[16 x rank] = alpha O + P[16 x 32] V[32 x rank]   (WMMA; O in shared
//                                       memory in fp32)
// The K tile is read from the two page arrays through their own pointers and
// strides (no [ckv | kpe] copy of the pool), and its ckv columns are the V
// tile, so V is never loaded twice.  Positions are found through the table
// (page bt[b, t / ps], offset t % ps): any page size; positions at or past
// lengths[b] are masked and never loaded, so trailing table entries may point
// anywhere.  Splits past a row's length exit at once (the work follows the
// data).  Partial (O, max, sum) per (row, head, split) go to a scratch buffer
// and a combine kernel sums the splits in ascending order.  A row with no
// attended position averages V over every table entry (null pages included),
// as the plain version's softmax of an all -1e30 row does.  fp32 inputs take
// the same structure with FMA products on the CUDA cores.
//
// Bound at the serving shape (8 slots, 1024 valid positions each, H 128,
// Dk 576, Dv 512, bf16; H100 SXM data sheet: 989 TFLOP/s bf16, 3.35 TB/s):
// 2 * 128 * (576 + 512) * 8192 = 2.28 GFLOP -> 2.3 us of tensor-core time;
// pages 8192 * 576 * 2 = 9.44 MB -> 2.8 us; bound by bytes.  What this simple
// design leaves on the table: each K tile is read by H / 16 = 8 blocks (from
// L2 after the first), the fp32 partials (about the size of the pages at
// five splits) go through memory, warp-level WMMA instead of wgmma, one K
// buffer (a tile's cp.async copies are all in flight together, but they do
// not overlap the block's products; a TMA ring would), and O is rescaled in
// shared memory.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace nvcuda;

constexpr float NEG_INF = -1e30f;
constexpr int HG = 16;           // query heads per block (the WMMA M)
constexpr int CH = 32;           // KV positions per tile
constexpr int THREADS = 256;     // 8 warps
constexpr int QK_PARTS = 4;      // bf16: the Dk reduction split 4 ways
constexpr int MAX_R = 512;       // latent rank
constexpr int MAX_P = 64;        // rope dims

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

struct MlaArgs {
  const void* q_lat;             // [B, H, R]
  const void* q_pe;              // [B, H, P]
  const void* ckv;               // [pages, ps, R]
  const void* kpe;               // [pages, ps, P]
  const int* bt;                 // [B, maxp]
  const int* lengths;            // [B]
  long long ql_sb, ql_sh, qp_sb, qp_sh;   // element strides; last dim 1
  long long c_s0, c_s1, k_s0, k_s1;       // (page, offset)
  long long o_sb, o_sh;
  int H, R, P, maxp, ps, T;      // T = maxp * ps
  int split_len, n_split;        // positions per split (a multiple of CH)
  int rpad, dpad;                // R and R + P padded to multiples of 16
  float scale;
  float* part;                   // [B,H,n_split,rpad] O, then [..,2] (m, l)
  void* out;                     // [B, H, R]
};

// Row strides in shared memory, each padded so that the rows of a 16 x 16
// WMMA fragment (or an FMA loop's column walk) do not fall on one bank:
// Q/K tiles (bf16: 8 elements more, keeping rows 16-byte aligned for the
// copies and fragments 32-byte aligned; fp32: one more), the scores, the
// probabilities and the O accumulator.
template <typename T>
__host__ __device__ inline int tile_ld(int dpad) {
  return sizeof(T) == 2 ? dpad + 8 : dpad + 1;
}
constexpr int LDS = CH + 4;      // scores, fp32
constexpr int LDP = CH + 8;      // probabilities, in the V dtype
__host__ __device__ inline int o_ld(int rpad) { return rpad + 4; }

template <typename T>
__host__ __device__ inline int qk_parts() {
  return sizeof(T) == 2 ? QK_PARTS : 1;
}

template <typename T>
__host__ __device__ inline size_t smem_bytes(int rpad, int dpad) {
  size_t b = static_cast<size_t>(HG + CH) * tile_ld<T>(dpad) * sizeof(T);
  b = (b + 127) / 128 * 128;
  b += static_cast<size_t>(qk_parts<T>()) * HG * LDS * sizeof(float);  // S
  b += HG * LDP * sizeof(T);                                           // p
  b += static_cast<size_t>(HG) * o_ld(rpad) * sizeof(float);           // O
  b += 3 * HG * sizeof(float);                      // row max, sum, rescale
  return b;
}

// sp[part][HG][CH] = partial Q K^T over a quarter of the Dk steps: warp w
// takes n-tile w % 2 and the Dk steps part, part + 4, ... with part = w / 2.
__device__ void tile_qk(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                        float* sp, int ld, int dpad) {
  const int w = threadIdx.x / 32;
  const int n = w % (CH / 16), part = w / (CH / 16);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  for (int kk = part; kk < dpad / 16; kk += QK_PARTS) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::col_major> b;
    wmma::load_matrix_sync(a, qs + kk * 16, ld);
    wmma::load_matrix_sync(b, ks + (n * 16) * ld + kk * 16, ld);
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(sp + part * HG * LDS + n * 16, acc, LDS,
                          wmma::mem_row_major);
}

__device__ void tile_qk(const float* qs, const float* ks, float* sp, int ld,
                        int dpad) {
  for (int i = threadIdx.x; i < HG * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    float s = 0.0f;
    for (int d = 0; d < dpad; ++d) s += qs[r * ld + d] * ks[c * ld + d];
    sp[r * LDS + c] = s;
  }
}

// os[HG][rpad] = alpha os + P V, V = the first rpad columns of the K tile;
// each warp rescales the 16 x 16 blocks of O it owns before it adds to them
__device__ void tile_pv(const __nv_bfloat16* pp, const __nv_bfloat16* ks,
                        float* os, const float* alpha, int ld, int rpad) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ldo = o_ld(rpad);
  const int r = lane / 2, c0 = (lane % 2) * 8;
  for (int n = w; n < rpad / 16; n += THREADS / 32) {
    float* blk = os + r * ldo + n * 16 + c0;
#pragma unroll
    for (int c = 0; c < 8; ++c) blk[c] *= alpha[r];
    __syncwarp();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, os + n * 16, ldo, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(a, pp + kk * 16, LDP);
      wmma::load_matrix_sync(b, ks + (kk * 16) * ld + n * 16, ld);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(os + n * 16, acc, ldo, wmma::mem_row_major);
  }
}

__device__ void tile_pv(const float* pp, const float* ks, float* os,
                        const float* alpha, int ld, int rpad) {
  for (int i = threadIdx.x; i < HG * rpad; i += THREADS) {
    const int r = i / rpad, n = i % rpad;
    float acc = os[r * o_ld(rpad) + n] * alpha[r];
    for (int j = 0; j < CH; ++j) acc += pp[r * LDP + j] * ks[j * ld + n];
    os[r * o_ld(rpad) + n] = acc;
  }
}

// Asynchronous global -> shared copy of N bytes (4, 8 or 16); with
// valid = false nothing is read and the N bytes are zero-filled.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(N), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Position t's page row: the element offset of its latent (or rope) row.
__device__ __forceinline__ long long page_row(const MlaArgs& a, int b, int t,
                                              long long s0, long long s1) {
  const long long page = a.bt[b * a.maxp + t / a.ps];
  return page * s0 + (t % a.ps) * s1;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mla_partial_kernel(MlaArgs a, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long row_c[CH], row_k[CH];   // page rows of a tile
  const int ld = tile_ld<T>(a.dpad);
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + HG * ld;
  const size_t off = (static_cast<size_t>(HG + CH) * ld * sizeof(T) + 127)
                     / 128 * 128;
  float* sp = reinterpret_cast<float*>(smem + off);
  const int parts = qk_parts<T>();
  T* pp = reinterpret_cast<T*>(sp + parts * HG * LDS);
  float* os = reinterpret_cast<float*>(pp + HG * LDP);
  const int ldo = o_ld(a.rpad);
  float* row_m = os + HG * ldo;
  float* row_l = row_m + HG;
  float* row_alpha = row_l + HG;

  const int split = blockIdx.x, h0 = blockIdx.y * HG, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int len = min(a.lengths[b], a.T);     // attended: [0, len)
  const int t_lo = split * a.split_len;
  const int t_hi = min(t_lo + a.split_len, len);
  const long long pbase = (static_cast<long long>(b) * a.H + h0) *
                          a.n_split + split;
  float* ml = a.part + static_cast<long long>(gridDim.z) * a.H * a.n_split *
                           a.rpad;
  if (t_lo >= t_hi) {              // nothing of this row in this split
    for (int r = tid; r < HG; r += THREADS)
      if (h0 + r < a.H) {
        ml[(pbase + r * a.n_split) * 2] = NEG_INF;
        ml[(pbase + r * a.n_split) * 2 + 1] = 0.0f;
      }
    return;
  }

  // zero both tiles (the padding columns stay zero), then the queries
  for (int i = tid; i < (HG + CH) * ld; i += THREADS) qs[i] = from_f<T>(0.0f);
  for (int i = tid; i < HG * ldo; i += THREADS) os[i] = 0.0f;
  if (tid < HG) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.0f;
  }
  __syncthreads();
  const T* ql = static_cast<const T*>(a.q_lat) + b * a.ql_sb;
  const T* qp = static_cast<const T*>(a.q_pe) + b * a.qp_sb;
  const int width = a.R + a.P;
  for (int i = tid; i < HG * width; i += THREADS) {
    const int r = i / width, c = i % width, h = h0 + r;
    if (h >= a.H) continue;
    if (c < a.R)
      qs[r * ld + c] = ql[h * a.ql_sh + c];
    else
      qs[r * ld + a.rpad + c - a.R] = qp[h * a.qp_sh + c - a.R];
  }

  const T* ckv = static_cast<const T*>(a.ckv);
  const T* kpe = static_cast<const T*>(a.kpe);
  const int row = tid / 16, sub = tid % 16;    // softmax: 16 threads a head
  for (int t0 = t_lo; t0 < t_hi; t0 += CH) {
    __syncthreads();               // the previous tile is consumed
    // K tile: latent columns [0, R), rope columns [rpad, rpad + P).  The
    // page rows of the tile's positions are looked up once; masked
    // positions are written as zeros and never read from the pages.  The
    // copies are asynchronous (cp.async), so all of a thread's are in
    // flight at once; a warp copies one position's row at a time.
    if (tid < CH) {
      const int t = t0 + tid;
      row_c[tid] = t < t_hi ? page_row(a, b, t, a.c_s0, a.c_s1) : -1;
      row_k[tid] = t < t_hi ? page_row(a, b, t, a.k_s0, a.k_s1) : -1;
    }
    __syncthreads();
    const int warp = tid / 32, lane = tid % 32;
    if (vec || sizeof(T) == 4) {
      // bf16 in 8-element (16-byte) chunks, fp32 element by element
      const int per = vec ? 8 : 1;
      const int cr = a.R / per, cpr = cr + a.P / per;
      for (int j = warp; j < CH; j += THREADS / 32) {
        const long long rc = row_c[j], rk = row_k[j];
        for (int c = lane; c < cpr; c += 32) {
          T* dst = ks + j * ld + (c < cr ? c * per : a.rpad + (c - cr) * per);
          const T* src = rc < 0 ? ckv
                         : c < cr ? ckv + rc + c * per
                                  : kpe + rk + (c - cr) * per;
          if (vec)
            cp_async<16>(dst, src, rc >= 0);
          else
            cp_async<4>(dst, src, rc >= 0);
        }
      }
      cp_async_wait_all();
    } else {                       // bf16 rows of odd widths: 2-byte loads
      for (int j = warp; j < CH; j += THREADS / 32) {
        const long long rc = row_c[j], rk = row_k[j];
        for (int c = lane; c < width; c += 32) {
          T val = from_f<T>(0.0f);
          if (rc >= 0) val = c < a.R ? ckv[rc + c] : kpe[rk + c - a.R];
          ks[j * ld + (c < a.R ? c : a.rpad + c - a.R)] = val;
        }
      }
    }
    __syncthreads();
    tile_qk(qs, ks, sp, ld, a.dpad);
    __syncthreads();

    // online softmax: thread (row, sub) scores columns 2*sub and 2*sub + 1
    float s[2];
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = sub * 2 + j;
      float v = 0.0f;
      for (int q = 0; q < parts; ++q) v += sp[(q * HG + row) * LDS + c];
      s[j] = t0 + c < t_hi ? v * a.scale : NEG_INF;
      m_tile = fmaxf(m_tile, s[j]);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, o));
    const float m_prev = row_m[row];
    const float m_new = fmaxf(m_prev, m_tile);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float p = s[j] > NEG_INF ? expf(s[j] - m_new) : 0.0f;
      psum += p;
      pp[row * LDP + sub * 2 + j] = from_f<T>(p);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    __syncwarp();
    if (sub == 0) {
      const float alpha = expf(m_prev - m_new);
      row_alpha[row] = alpha;
      row_l[row] = row_l[row] * alpha + psum;
      row_m[row] = m_new;
    }
    __syncthreads();
    tile_pv(pp, ks, os, row_alpha, ld, a.rpad);
  }
  __syncthreads();

  for (int i = tid; i < HG * a.R; i += THREADS) {
    const int r = i / a.R, d = i % a.R;
    if (h0 + r < a.H)
      a.part[(pbase + r * a.n_split) * a.rpad + d] = os[r * ldo + d];
  }
  if (tid < HG && h0 + tid < a.H) {
    ml[(pbase + tid * a.n_split) * 2] = row_m[tid];
    ml[(pbase + tid * a.n_split) * 2 + 1] = row_l[tid];
  }
}

// out[b, h] = sum_s exp(m_s - M) O_s / sum_s exp(m_s - M) l_s over the splits
// with an attended position, in ascending order.  A row with none: the plain
// version's softmax of T logits of -1e30 is uniform, so it returns
// sum_t T(1/T) v_t over every table entry; this pass sums the same terms.
template <typename T>
__global__ void __launch_bounds__(THREADS) mla_combine_kernel(MlaArgs a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const long long base = (static_cast<long long>(b) * a.H + h) * a.n_split;
  const float* ml = a.part + static_cast<long long>(gridDim.y) * a.H *
                                 a.n_split * a.rpad;
  float m = NEG_INF;
  bool attended = false;
  for (int s = 0; s < a.n_split; ++s)
    if (ml[(base + s) * 2 + 1] > 0.0f) {
      m = fmaxf(m, ml[(base + s) * 2]);
      attended = true;
    }
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
  const T* ckv = static_cast<const T*>(a.ckv);
  for (int d = threadIdx.x; d < a.R; d += THREADS) {
    if (!attended) {
      const float p = to_f(from_f<T>(1.0f / static_cast<float>(a.T)));
      float acc = 0.0f;
      for (int t = 0; t < a.T; ++t)
        acc += p * to_f(ckv[page_row(a, b, t, a.c_s0, a.c_s1) + d]);
      out[d] = from_f<T>(acc);
      continue;
    }
    float num = 0.0f, den = 0.0f;
    for (int s = 0; s < a.n_split; ++s) {
      const float l = ml[(base + s) * 2 + 1];
      if (!(l > 0.0f)) continue;
      const float w = expf(ml[(base + s) * 2] - m);
      num += w * a.part[(base + s) * a.rpad + d];
      den += w * l;
    }
    out[d] = from_f<T>(num / fmaxf(den, 1e-30f));
  }
}

// strides: ql_sb, ql_sh, qp_sb, qp_sh, c_s0, c_s1, k_s0, k_s1, o_sb, o_sh
template <typename T>
int launch_mla(const void* q_lat, const void* q_pe, const void* ckv,
               const void* kpe, const void* bt, const void* lengths,
               void* part, void* out, int B, int H, int R, int P, int maxp,
               int ps, int split_len, const long long* st, float scale,
               void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (R <= 0 || R > MAX_R || P < 0 || P > MAX_P || maxp <= 0 || ps <= 0 ||
      split_len <= 0 || split_len % CH != 0 || B > 65535 ||
      cdiv(H, HG) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  MlaArgs a = {};
  a.q_lat = q_lat; a.q_pe = q_pe; a.ckv = ckv; a.kpe = kpe;
  a.bt = static_cast<const int*>(bt);
  a.lengths = static_cast<const int*>(lengths);
  a.ql_sb = st[0]; a.ql_sh = st[1]; a.qp_sb = st[2]; a.qp_sh = st[3];
  a.c_s0 = st[4]; a.c_s1 = st[5]; a.k_s0 = st[6]; a.k_s1 = st[7];
  a.o_sb = st[8]; a.o_sh = st[9];
  a.H = H; a.R = R; a.P = P; a.maxp = maxp; a.ps = ps;
  a.T = maxp * ps;
  a.split_len = split_len;
  a.n_split = cdiv(a.T, split_len);
  a.rpad = cdiv(R, 16) * 16;
  a.dpad = a.rpad + cdiv(P, 16) * 16;
  a.scale = scale;
  a.part = static_cast<float*>(part);
  a.out = out;
  int vec = 0;
  if (sizeof(T) == 2 && R % 8 == 0 && P % 8 == 0) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(ckv) |
                           reinterpret_cast<uintptr_t>(kpe);
    bool ok = ptrs % 16 == 0;
    for (int i = 4; i < 8; ++i) ok = ok && st[i] % 8 == 0;
    vec = ok ? 1 : 0;
  }
  // the shared-memory limit is raised once, to the largest tile this
  // kernel takes, so that a launch recorded into a CUDA graph makes no
  // attribute call
  static const cudaError_t configured = cudaFuncSetAttribute(
      mla_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<T>(MAX_R, MAX_R + MAX_P)));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const size_t smem = smem_bytes<T>(a.rpad, a.dpad);
  cudaError_t err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(a.n_split, cdiv(H, HG), B);
  mla_partial_kernel<T><<<grid, THREADS, smem, s>>>(a, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_combine_kernel<T><<<dim3(H, B), THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- wgmma route ---------------------------------------------------------------
// DeepSeek-V3's shape (rank 512, rope 64, bf16) on Hopper's tensor memory
// accelerator and warpgroup MMA.  A block takes 64 heads of one batch row
// (wgmma's M; at H = 128 each K tile leaves L2 twice, not H / 16 = 8 times)
// and one split of the table's positions:
//   - Q [64 x 576] stays in shared memory (72 KB, nine 64-column boxes under
//     the 128-byte swizzle: eight of q_lat, one of q_pe);
//   - one producer thread gathers K tiles of 64 positions into a 2-stage TMA
//     ring (72 KB a stage) page segment by page segment through the table,
//     the ckv and kpe pages through their own tensor maps (no [ckv | kpe]
//     copy); a segment past the split's last attended position is loaded
//     from page coordinate `pages` (out of bounds: zeros), so its table
//     entry is never read;
//   - two consumer warpgroups each compute S = Q K^T (wgmma m64n64k16 over
//     the 576 columns; both hold the same S, so neither waits on the other),
//     run the online softmax on the accumulator registers in log2 units,
//     round the unnormalised p to bf16 (as the other routes) and add P V to
//     their half of O [64 x 512] fp32 in registers (256 columns each, two
//     m64n128k16 accumulators), V being the tile's ckv columns read MN-major
//     through the transpose bit;
//   - the splits of a (row, head group), at most 8, are one thread-block
//     cluster: each block leaves its partial (O, max, sum) in its own shared
//     memory (the ring, free by then) and the cluster combines them through
//     distributed shared memory, so no partial goes through device memory
//     (a 64 x 512 fp32 partial per block, 8 splits: 16 MB at the serving
//     shape against 9.4 MB of pages).
// Bound at the serving shape as above: 2.8 us of pages (bytes).  What it
// leaves on the table: both warpgroups compute S (the tensor cores do twice
// the QK^T work, off the critical path of the bytes at 2 tiles a block), the
// producer reads the table entry of each segment on its critical path, and
// Q is read by every split (from L2 after the first).
namespace mla_wg {

using namespace hopper;
namespace cg = cooperative_groups;

constexpr int R = 512, P = 64, DK = R + P;
constexpr int HB = 64;                      // heads a block: wgmma's M
constexpr int BKV = 64;                     // positions a K tile
constexpr int BOX = 64;                     // bf16 in a 128-byte box row
constexpr int NB = DK / BOX;                // boxes a row: 8 latent + 1 rope
constexpr int BOX_BYTES = BKV * 128;        // one box of a tile (or of Q)
constexpr int TILE_BYTES = NB * BOX_BYTES;  // 72 KB: a K tile, or Q
constexpr int STAGES = 2;
constexpr int THREADS = 384;                // 2 consumer + 1 producer warpgroups
constexpr int CONSUMER_THREADS = 256;
// registers a thread after setmaxnreg: O [64 x 256] fp32 a consumer thread
// takes 128; 40 x 128 + 232 x 256 <= 65536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int MAX_SPLITS = 8;               // a cluster's blocks (portable)
constexpr int PART_LD = R + 8;              // fp32 partial row stride
constexpr float LOG2E = 1.4426950408889634f;
// Q, the ring, 1024 bytes of slack to align them (the 128-byte swizzle
// repeats every 1024 bytes), then the barriers: Q full, full and empty per
// stage
constexpr int SMEM = TILE_BYTES * (1 + STAGES) + 1024 + 8 * (1 + 2 * STAGES);
static_assert(HB == BKV, "Q and a K tile share the box layout");
static_assert(HB * PART_LD * 4 + HB * 2 * 4 <= STAGES * TILE_BYTES,
              "the partials fit the ring");

struct Args {
  const int* bt;                 // [B, maxp]
  const int* lengths;            // [B]
  const __nv_bfloat16* ckv;      // the all-masked rows' average
  __nv_bfloat16* out;            // [B, H, R]
  long long c_s0, c_s1;          // ckv page and offset strides (elements)
  long long o_sb, o_sh;
  int H, maxp, ps, seg, pages, T, split_len;
  float scale_log2;              // scale * log2(e)
};

// Every split's partial is in its block: the cluster's consumer threads
// combine them through distributed shared memory, 4 columns of a head
// each.  out = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s over the splits
// with an attended position, in ascending split order; a row with none takes
// the simple route's average of V over every table entry with weights
// bf16(1/T), as the plain version's softmax of an all-masked row gives.
__device__ void combine(const Args& a, const cg::cluster_group& cluster,
                        float* part, float* ml, int h0, int b, int tid) {
  const int nsplit = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = rank + nsplit * tid; i < HB * (R / 4);
       i += nsplit * CONSUMER_THREADS) {
    const int hh = i / (R / 4), c = (i % (R / 4)) * 4;
    if (h0 + hh >= a.H) continue;
    float2 st[MAX_SPLITS];
    float M = -INFINITY;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < nsplit) {
        st[s] = *reinterpret_cast<const float2*>(
            cluster.map_shared_rank(ml, s) + 2 * hh);
        if (st[s].y > 0.0f) M = fmaxf(M, st[s].x);
      }
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float den = 0.0f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < nsplit && st[s].y > 0.0f) {
        const float f = exp2f(st[s].x - M);
        const float4 x = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, s) + hh * PART_LD + c);
        acc[0] += f * x.x;
        acc[1] += f * x.y;
        acc[2] += f * x.z;
        acc[3] += f * x.w;
        den += f * st[s].y;
      }
    if (den > 0.0f) {
      for (int e = 0; e < 4; ++e) acc[e] /= den;
    } else {
      const float w = __bfloat162float(
          __float2bfloat16(1.0f / static_cast<float>(a.T)));
      for (int t = 0; t < a.T; ++t) {
        const long long pg = a.bt[b * a.maxp + t / a.ps];
        const __nv_bfloat16* v = a.ckv + pg * a.c_s0 + (t % a.ps) * a.c_s1 + c;
        for (int e = 0; e < 4; ++e) acc[e] += w * __bfloat162float(v[e]);
      }
    }
    __nv_bfloat16* out = a.out + b * a.o_sb + (h0 + hh) * a.o_sh + c;
    *reinterpret_cast<__nv_bfloat162*>(out) =
        __floats2bfloat162_rn(acc[0], acc[1]);
    *reinterpret_cast<__nv_bfloat162*>(out + 2) =
        __floats2bfloat162_rn(acc[2], acc[3]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
mla_wgmma_kernel(const __grid_constant__ CUtensorMap qlmap,
                 const __grid_constant__ CUtensorMap qpmap,
                 const __grid_constant__ CUtensorMap cmap,
                 const __grid_constant__ CUtensorMap kmap, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = qs + TILE_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + STAGES * TILE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  float* part = reinterpret_cast<float*>(ring);    // after the main loop
  float* ml = part + HB * PART_LD;                 // (max, sum) per head

  const int split = blockIdx.x, h0 = blockIdx.y * HB, b = blockIdx.z;
  const int len = min(a.lengths[b], a.T);          // attended: [0, len)
  const int t_lo = split * a.split_len;
  const int t_hi = min(t_lo + a.split_len, len);
  const int n_tiles = t_hi > t_lo ? cdiv(t_hi - t_lo, BKV) : 0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(smem_u32(q_full), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);    // the producer's arrive
      mbar_init(smem_u32(&empty[s]), 8);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the role through a shuffle: a value the compiler knows to be
  // warp-uniform, so it does not take the wgmma path for a divergent one
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  const cg::cluster_group cluster = cg::this_cluster();
  if (role == 2) {
    // ---- producer warpgroup: one thread issues every TMA load ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 256 && n_tiles > 0) {
      const uint32_t qbar = smem_u32(q_full);
      mbar_expect_tx(qbar, TILE_BYTES);
#pragma unroll
      for (int j = 0; j < R / BOX; ++j)
        tma_load_3d(smem_u32(qs + j * BOX_BYTES), &qlmap, qbar, j * BOX, h0,
                    b);
      tma_load_3d(smem_u32(qs + (R / BOX) * BOX_BYTES), &qpmap, qbar, 0, h0,
                  b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % STAGES;
        const int k0 = t_lo + n * BKV;
        mbar_wait(smem_u32(&empty[s]), ((n / STAGES) & 1) ^ 1);
        const uint32_t stage = smem_u32(ring + s * TILE_BYTES);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, TILE_BYTES);
        for (int g = 0; g < BKV / a.seg; ++g) {
          const int pos = k0 + g * a.seg;
          int page = a.pages, off = 0;           // past t_hi: zeros
          if (pos < t_hi) {
            page = a.bt[b * a.maxp + pos / a.ps];
            off = pos % a.ps;
          }
          const uint32_t row = g * a.seg * 128;
#pragma unroll
          for (int j = 0; j < R / BOX; ++j)
            tma_load_3d(stage + j * BOX_BYTES + row, &cmap, bar, j * BOX, off,
                        page);
          tma_load_3d(stage + (R / BOX) * BOX_BYTES + row, &kmap, bar, 0, off,
                      page);
        }
      }
    }
    __syncwarp();
    cluster.sync();   // the cluster's partials are written
    cluster.sync();   // and combined
  } else {
    // ---- consumer warpgroup `role`: O columns [256 role, 256 role + 256) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    // Thread l of warp w holds rows r = 16w + l/4 and r + 8 of the tile, and
    // for each 8-column group j the columns 8j + 2(l%4) and +1: accumulator
    // 4j + e is (row r + 8 (e / 2), column 8j + 2(l%4) + e % 2).
    const int lane = tid % 32, warp = (tid / 32) % 4;
    const int r0 = warp * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
    float m[2] = {-INFINITY, -INFINITY};   // running max of the raw scores
    float l[2] = {0.0f, 0.0f};             // this thread's share of the sum
    float o0[64], o1[64];                  // defined by the first P V wgmma
    const uint32_t q_addr = smem_u32(qs);
    if (n_tiles > 0) mbar_wait(smem_u32(q_full), 0);

    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % STAGES;
      const uint32_t phase = (n / STAGES) & 1;
      const int k0 = t_lo + n * BKV;
      const uint32_t k_addr = smem_u32(ring + s * TILE_BYTES);

      // S = Q K^T: a k16 step is 32 bytes along a 128-byte box row
      float sc[32];
      mbar_wait(smem_u32(&full[s]), phase);
      fence_operands(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        wgmma_ss<0>(sc, smem_desc(q_addr + off, 16, 1024),
                    smem_desc(k_addr + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);

      // the mask, only on a tile that crosses the split's attended end
      const bool edge = __shfl_sync(0xffffffffu, k0 + BKV > t_hi, 0);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (k0 + 8 * (i / 4) + c0 + i % 2 >= t_hi) sc[i] = -INFINITY;
      }

      // online softmax in registers: a row's four threads share its max
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float alpha[2], msc[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        msc[e] = mx[e] == -INFINITY ? 0.0f : mx[e] * a.scale_log2;
        alpha[e] = exp2f(m[e] * a.scale_log2 - msc[e]);
        m[e] = mx[e];
        l[e] *= alpha[e];
      }
      // p = exp2(s * scale * log2 e - max), summed in fp32 and rounded to
      // bf16 pairs: slice kk of P is registers 4kk .. 4kk+3, the A fragment
      // of a m64k16 wgmma
      uint32_t p[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 =
              exp2f(fmaf(sc[4 * j + 2 * e], a.scale_log2, -msc[e]));
          const float p1 =
              exp2f(fmaf(sc[4 * j + 2 * e + 1], a.scale_log2, -msc[e]));
          l[e] += p0 + p1;
          __nv_bfloat162 pair = __floats2bfloat162_rn(p0, p1);
          p[2 * j + e] = *reinterpret_cast<uint32_t*>(&pair);
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o0[4 * j] *= alpha[0];
        o0[4 * j + 1] *= alpha[0];
        o0[4 * j + 2] *= alpha[1];
        o0[4 * j + 3] *= alpha[1];
        o1[4 * j] *= alpha[0];
        o1[4 * j + 1] *= alpha[0];
        o1[4 * j + 2] *= alpha[1];
        o1[4 * j + 3] *= alpha[1];
      }

      // O += P V, V the tile's latent boxes 4 role .. 4 role + 3 read
      // MN-major: a k16 step is 16 rows (2 KB) down the tile; an N = 128
      // accumulator spans two boxes, BOX_BYTES apart
      fence_operands(o0);
      fence_operands(o1);
      wgmma_fence();
      const uint32_t v_addr = k_addr + 4 * role * BOX_BYTES;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint32_t pa[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                                p[4 * kk + 3]};
        wgmma_rs(o0, pa, smem_desc(v_addr + kk * 2048, BOX_BYTES, 1024),
                 n > 0 || kk > 0);
        wgmma_rs(o1, pa,
                 smem_desc(v_addr + 2 * BOX_BYTES + kk * 2048, BOX_BYTES,
                           1024),
                 n > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o0);
      fence_operands(o1);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
    }

    // ---- the partial (O, max, sum) into the ring, once both warpgroups are
    // done with it
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    }
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (n_tiles > 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 256 * role + 8 * j + c0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* row = part + (r0 + 8 * e) * PART_LD + col;
          *reinterpret_cast<float2*>(row) =
              make_float2(o0[4 * j + 2 * e], o0[4 * j + 2 * e + 1]);
          *reinterpret_cast<float2*>(row + 128) =
              make_float2(o1[4 * j + 2 * e], o1[4 * j + 2 * e + 1]);
        }
      }
    }
    if (role == 0 && lane % 4 == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool any = n_tiles > 0 && l[e] > 0.0f;
        ml[2 * (r0 + 8 * e)] = any ? m[e] * a.scale_log2 : -INFINITY;
        ml[2 * (r0 + 8 * e) + 1] = any ? l[e] : 0.0f;
      }
    }
    cluster.sync();
    combine(a, cluster, part, ml, h0, b, tid);
    cluster.sync();   // keep each block's memory until all have read it
  }
}

// a bf16 [d2, d1, d0] tensor (d0 contiguous) as a 3-D map with boxes of
// 64 x box1 x 1; element strides of d1 and d2
int encode_3d(CUtensorMap* map, const void* ptr, long long d0, long long d1,
              long long d2, long long s1, long long s2, int box1) {
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2};
  const cuuint32_t box[3] = {BOX, (cuuint32_t)box1, 1};
  return encode(map, ptr, 3, dims, strides, box);
}

// strides as launch_mla's; pages: the page count of the pool
int launch(const void* q_lat, const void* q_pe, const void* ckv,
           const void* kpe, const void* bt, const void* lengths, void* out,
           int B, int H, int Rk, int Pk, int maxp, int ps, int pages,
           int split_len, const long long* st, float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const int seg = ps < BKV ? ps : BKV;
  if (Rk != R || Pk != P || maxp <= 0 || pages <= 0 || B > 65535 ||
      cdiv(H, HB) > 65535 || (ps < BKV ? BKV % ps != 0 || ps < 8
                                       : ps % BKV != 0) ||
      split_len <= 0 || split_len % BKV != 0 ||
      cdiv(maxp * ps, split_len) > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qlmap, qpmap, cmap, kmap;
  if (int err = encode_3d(&qlmap, q_lat, R, H, B, st[1], st[0], HB))
    return err;
  if (int err = encode_3d(&qpmap, q_pe, P, H, B, st[3], st[2], HB))
    return err;
  if (int err = encode_3d(&cmap, ckv, R, ps, pages, st[5], st[4], seg))
    return err;
  if (int err = encode_3d(&kmap, kpe, P, ps, pages, st[7], st[6], seg))
    return err;
  Args a;
  a.bt = static_cast<const int*>(bt);
  a.lengths = static_cast<const int*>(lengths);
  a.ckv = static_cast<const __nv_bfloat16*>(ckv);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.c_s0 = st[4]; a.c_s1 = st[5];
  a.o_sb = st[8]; a.o_sh = st[9];
  a.H = H; a.maxp = maxp; a.ps = ps; a.seg = seg; a.pages = pages;
  a.T = maxp * ps;
  a.split_len = split_len;
  a.scale_log2 = scale * LOG2E;
  // the shared-memory limit is raised once, so that a launch recorded into
  // a CUDA graph makes no attribute call
  static const cudaError_t configured = cudaFuncSetAttribute(
      mla_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int n_split = cdiv(a.T, split_len);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, cdiv(H, HB), B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n_split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, mla_wgmma_kernel, qlmap,
                                             qpmap, cmap, kmap, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mla_wg

}  // namespace

extern "C" {

int mla_decode_tile_positions() { return CH; }
int mla_decode_wgmma_tile_positions() { return mla_wg::BKV; }
int mla_decode_wgmma_max_splits() { return mla_wg::MAX_SPLITS; }

// the wgmma route: rank 512, rope 64, bf16; 16-byte bases and strides; page
// sizes 8, 16, 32 or a multiple of 64; `pages` the pool's page count
int mla_decode_wgmma_bf16(const void* q_lat, const void* q_pe,
                          const void* ckv, const void* kpe, const void* bt,
                          const void* lengths, void* out, int B, int H, int R,
                          int P, int maxp, int ps, int pages, int split_len,
                          const long long* strides, float scale,
                          void* stream) {
  return mla_wg::launch(q_lat, q_pe, ckv, kpe, bt, lengths, out, B, H, R, P,
                        maxp, ps, pages, split_len, strides, scale, stream);
}

int mla_decode_bf16(const void* q_lat, const void* q_pe, const void* ckv,
                    const void* kpe, const void* bt, const void* lengths,
                    void* part, void* out, int B, int H, int R, int P,
                    int maxp, int ps, int split_len,
                    const long long* strides, float scale, void* stream) {
  return launch_mla<__nv_bfloat16>(q_lat, q_pe, ckv, kpe, bt, lengths, part,
                                   out, B, H, R, P, maxp, ps, split_len,
                                   strides, scale, stream);
}

int mla_decode_f32(const void* q_lat, const void* q_pe, const void* ckv,
                   const void* kpe, const void* bt, const void* lengths,
                   void* part, void* out, int B, int H, int R, int P,
                   int maxp, int ps, int split_len, const long long* strides,
                   float scale, void* stream) {
  return launch_mla<float>(q_lat, q_pe, ckv, kpe, bt, lengths, part, out, B,
                           H, R, P, maxp, ps, split_len, strides, scale,
                           stream);
}

}  // extern "C"
