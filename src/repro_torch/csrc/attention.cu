// Attention kernels for Hopper (sm_90a): causal/windowed GQA prefill
// (flash_attention) and single-token decode against a dense KV slab
// (decode_attention) or against KV pages through a block table
// (paged_decode).
//
// Replaces the JAX package's Pallas TPU kernels
//   src/repro/kernels/flash_attention/kernel.py   flash_attention_pallas
//   src/repro/kernels/decode_attention/kernel.py  decode_attention_pallas
//   src/repro/kernels/paged_decode/kernel.py      paged_decode_attention_pallas
// All three compute softmax(q k^T * scale, masked) v with fp32 statistics and
// accumulation and store the input dtype; masked logits are -1e30 as there.
// Every operand is read in the model's own layout through strides — q
// [B,S,H,D], k/v [B,T,KVH,D], pages [P,ps,KVH,D] — so no transpose copy is
// made (the JAX wrappers swap axes before their calls).  GQA: query head h
// reads KV head h / (H / KVH).  As in the Pallas kernels, the softmax is
// online and the unnormalised p = exp(s - running max) is rounded to the V
// dtype for the P V product; the model's plain attention rounds the
// normalised p instead, so the two differ by about an ulp of the output.
//
// flash_attention takes one of three routes, picked by the Python wrapper
// from dtype, head dim, strides and alignment alone
// (kernels/flash_attention/ops.py route()); a launch that fails raises and
// never falls back to another route.  In every route the window is a
// runtime int (0 = none), K/V tiles wholly outside the causal/window band
// are skipped, and the result is O / max(l, 1e-30).
//
// wgmma (bf16 with D a multiple of 16 up to 128, the D stride 1, every other
// stride a multiple of 16 bytes and 16-byte aligned bases: what TMA reads).
// The FA3 form for Hopper.  A block of 160 threads owns 64 query rows of one
// (head, batch row): warps 0-3 are the consumer warpgroup, warp 4 the
// producer, of which one thread issues every TMA load.
//   TMA maps over the model's own layout through strides: q as 4-D (D, S, H,
//     B), k and v as (D, T, KVH, B), boxes of 64 D x rows x 1 x 1 under the
//     128-byte swizzle, so a box never reads a neighbouring head or batch
//     row, and rows past S or T and columns past D read zeros.  A box row
//     holds 64 bf16, so D > 64 takes two boxes along D (DP = 128); Kimi-K2's
//     D = 112 gets zeros in columns 112-127.
//   The producer loads the Q tile once, then keeps K and V tiles of BKV rows
//     in flight in a ring of two stages (separate K and V full barriers, so
//     Q K^T starts before V lands; an empty barrier per stage).
//   S = Q K^T: wgmma.m64nBKVk16 from shared memory, both operands K-major,
//     DP/16 k-steps (the zero columns past D add nothing).
//   Softmax on the accumulator registers: thread l of warp w holds rows
//     16w + l/4 and +8, so row max and sum take two quad shuffles; scale *
//     log2(e) is folded into exp2; the mask (-inf, p = 0) runs only on tiles
//     that cross the causal diagonal, the window edge or T (a zero-filled K
//     row past T scores 0 and must still be masked).
//   P stays in registers: the fp32 S accumulators of a 16-column slice are
//     the A-fragment layout of the next wgmma, so they are packed to bf16
//     pairs (the unnormalised online p rounded to bf16, as the Pallas kernel
//     does, ROADMAP C8) and fed as the register A operand.
//   O += P V: wgmma.m64nDPk16 with V [BKV, D] read MN-major in place through
//     the descriptor's transpose bit (LBO: one D box to the next; SBO: one
//     8-row group to the next), as gemm.cu reads w.  O lives in fp32
//     registers and is rescaled there by alpha = exp2(m_old - m_new).
//   Epilogue: O / max(l, 1e-30) rounded to bf16, stored through strides with
//     the S-edge row mask.
//   Raster: blockIdx = (head, batch row, reversed query tile): the query
//     tiles with the most K/V tiles (the last ones of a causal band) launch
//     first, and the H/KVH query heads of one KV group sit next to each other
//     so that their K/V tiles come from L2.  64-row tiles: a 512-token prefill
//     with 14 heads is 112 blocks for 132 SMs (128-row tiles would give 56);
//     each block's shared memory (72 or 80 KB) and registers leave room for
//     two blocks an SM at Kimi-K2's 64 heads (512 blocks).
//   BKV = 128 for DP = 64 (half as many serial tile steps in the latency-
//     bound prefill), 64 for DP = 128 (the O accumulators double).
//
// simple (bf16 outside the wgmma rule, e.g. D = 14): one block of 4 warps
// per (64-row query tile, head, batch row).  The Q tile stays in shared
// memory; the block walks the 64-row K/V tiles of the band with an online
// softmax: S = Q K^T (bf16 WMMA, fp32 accumulate), per-row running max and
// sum in fp32, p rounded to the V dtype and O += P V (WMMA), O kept and
// rescaled in shared memory in fp32.  Any S, T and D <= 128 are taken: D is
// zero-padded to a multiple of 16 in shared memory and rows past S or T are
// masked.  Also exposed as flash_attention_simple_bf16, so that a
// measurement can hold the wgmma route against it.
//
// fp32: the simple route's structure with FMA products on the CUDA cores.
//
// decode_attention / paged_decode: one device routine.  At decode B*KVH is
// small (16 for Qwen2-0.5B at 8 slots), so the KV positions are split into
// chunks of DEC_CHUNK = 128 positions counted from absolute position 0, one
// block per (chunk, KV head, batch row) — flash-decoding.  A block serves all
// query heads of its KV group (7 for Qwen2), so each K/V row is read once per
// group: thread j scores position j of the chunk against every head, a warp
// per head takes the chunk's max and sum, and each thread then accumulates one
// output dimension over the chunk.  Partial (acc, max, sum) go to a scratch
// buffer and a second kernel combines the chunks in ascending order, skipping
// those with no valid position (a row with none at all averages V over every
// position, as the plain versions' softmax of an all-masked row does).  The two entry points differ only in where a
// position's K/V row is (slab stride, or block-table page + offset) and in the
// mask (valid[b, t], or starts[b] <= t < lengths[b]); masked positions are
// never loaded, so trailing table entries may point anywhere.  Because the
// dense and the paged kernel sum the same positions in the same order, a
// paged decode equals the dense decode bit for bit.
//
// Bounds at the serving shapes (Qwen2-0.5B: H 14, KVH 2, D 64, bf16; H100 SXM
// data sheet: 989 TFLOP/s bf16, 3.35 TB/s):
//   prefill S = T = 512: causal QK^T + PV 0.47 GFLOP -> 0.48 us; q, k, v, out
//     2.10 MB -> 0.63 us; bound by bytes.
//   decode 8 slots, T = 1024 fully valid: K + V 4.19 MB -> 1.25 us, bound by
//     bytes (the kernel reads only the valid positions; chip_smoke.py counts
//     those of its run).
//   prefill S = T = 1024 (the serve engine's max_len): 1.88 GFLOP -> 1.9 us;
//     4.19 MB -> 1.25 us; bound by operations.
//   Kimi-K2 prefill S = T = 512, 64/8 heads of 112: 3.77 GFLOP -> 3.8 us;
//     16.5 MB -> 4.9 us; bound by bytes.
// What the wgmma route leaves on the table: within a block the two products
// and the softmax run one after another (FA3's overlap of a tile's softmax
// with the next tile's Q K^T measured slower at the serving shapes, see
// PERF.md), each (query tile, head) block re-reads its K/V tiles from L2
// (Kimi-K2's 8 heads a KV group), and the output is stored from registers
// in 4-byte pieces.  The decode routine
// reads K with one thread per position (each a 128-byte row), walks V one
// position after another per thread (a chain of dependent loads), and leaves
// half of its threads idle in the P V pass when D = 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace nvcuda;

constexpr float NEG_INF = -1e30f;
constexpr int MAX_D = 128;

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

// =============================================================================
// flash attention (prefill)
// =============================================================================

constexpr int BQ = 64;          // query rows per block (16 per warp)
constexpr int BKV = 64;         // key rows per tile
constexpr int FA_THREADS = 128;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long q_sb, q_ss, q_sh;   // element strides; the D stride is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int S, T, H, KVH, D;
  int causal, window;
  float scale;
};

// Row stride (elements) of the Q/K/V tiles in shared memory: bf16 tiles feed
// WMMA, whose pointers must stay 32-byte aligned (dpad is a multiple of 16);
// fp32 tiles are read by FMA loops across rows, so one extra column keeps
// those reads off a single bank.
template <typename T>
__host__ __device__ inline int tile_ld(int dpad) {
  return sizeof(T) == 2 ? dpad : dpad + 1;
}

template <typename T>
__host__ __device__ inline size_t flash_smem_bytes(int dpad) {
  const size_t ld = tile_ld<T>(dpad);
  size_t b = 3 * BQ * ld * sizeof(T);        // Q, K, V tiles
  b = (b + 127) / 128 * 128;
  b += BQ * BKV * sizeof(float);             // scores
  b += BQ * BKV * sizeof(T);                 // p in the V dtype
  b += BQ * dpad * sizeof(float);            // O accumulator
  b += 3 * BQ * sizeof(float);               // row max, sum, rescale
  return b;
}

// Copy `rows` x D elements (row r at src + r * stride) into a BQ x dpad tile
// with row stride ld; rows past `valid_rows` and columns past D are zero.
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, long long stride,
                          int valid_rows, int D, int dpad, bool vec) {
  if (vec) {                    // bf16, 8-element (16-byte) chunks
    const int chunks = dpad / 8;
    for (int idx = threadIdx.x; idx < BQ * chunks; idx += FA_THREADS) {
      const int r = idx / chunks, c = (idx % chunks) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < valid_rows && c < D)
        val = *reinterpret_cast<const uint4*>(src + r * stride + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < BQ * dpad; idx += FA_THREADS) {
    const int r = idx / dpad, c = idx % dpad;
    dst[r * ld + c] = (r < valid_rows && c < D) ? src[r * stride + c]
                                                : from_f<T>(0.0f);
  }
}

// scores[BQ][BKV] = Q K^T over the padded head dim
__device__ void tile_qk(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                        float* ss, int ld, int dpad) {
  const int w = threadIdx.x / 32;
  for (int n = 0; n < BKV / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < dpad / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b;
      wmma::load_matrix_sync(a, qs + (w * 16) * ld + kk * 16, ld);
      wmma::load_matrix_sync(b, ks + (n * 16) * ld + kk * 16, ld);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(ss + (w * 16) * BKV + n * 16, acc, BKV,
                            wmma::mem_row_major);
  }
}

__device__ void tile_qk(const float* qs, const float* ks, float* ss, int ld,
                        int dpad) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = w * 16; r < w * 16 + 16; ++r) {
    for (int c = lane; c < BKV; c += 32) {
      float s = 0.0f;
      for (int d = 0; d < dpad; ++d) s += qs[r * ld + d] * ks[c * ld + d];
      ss[r * BKV + c] = s;
    }
  }
}

// os[BQ][dpad] += P V
__device__ void tile_pv(const __nv_bfloat16* ps, const __nv_bfloat16* vs,
                        float* os, int ld, int dpad) {
  const int w = threadIdx.x / 32;
  for (int n = 0; n < dpad / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, os + (w * 16) * dpad + n * 16, dpad,
                           wmma::mem_row_major);
    for (int kk = 0; kk < BKV / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(a, ps + (w * 16) * BKV + kk * 16, BKV);
      wmma::load_matrix_sync(b, vs + (kk * 16) * ld + n * 16, ld);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(os + (w * 16) * dpad + n * 16, acc, dpad,
                            wmma::mem_row_major);
  }
}

__device__ void tile_pv(const float* ps, const float* vs, float* os, int ld,
                        int dpad) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = w * 16; r < w * 16 + 16; ++r) {
    for (int c = lane; c < dpad; c += 32) {
      float acc = os[r * dpad + c];
      for (int j = 0; j < BKV; ++j) acc += ps[r * BKV + j] * vs[j * ld + c];
      os[r * dpad + c] = acc;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
flash_kernel(FlashArgs a, int dpad, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = tile_ld<T>(dpad);
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + BQ * ld;
  T* vs = ks + BQ * ld;
  size_t off = (3 * BQ * ld * sizeof(T) + 127) / 128 * 128;
  float* ss = reinterpret_cast<float*>(smem + off);
  T* ps = reinterpret_cast<T*>(ss + BQ * BKV);
  float* os = reinterpret_cast<float*>(ps + BQ * BKV);
  float* row_m = os + BQ * dpad;
  float* row_l = row_m + BQ;
  float* row_alpha = row_l + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int tid = threadIdx.x;

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + q0 * a.q_ss +
                h * a.q_sh;
  load_tile<T>(qs, ld, qg, a.q_ss, min(BQ, a.S - q0), a.D, dpad, vec);
  for (int i = tid; i < BQ * dpad; i += FA_THREADS) os[i] = 0.0f;
  for (int i = tid; i < BQ; i += FA_THREADS) {
    row_m[i] = NEG_INF;
    row_l[i] = 0.0f;
  }

  // K/V tiles that meet the band of this query tile
  int hi = a.T;
  if (a.causal) hi = min(hi, q0 + BQ);
  int lo = 0;
  if (a.window > 0) lo = max(0, q0 - a.window + 1) / BKV * BKV;

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const int row = tid / 2;             // softmax: two threads per query row
  const int half = tid % 2;
  const int q_pos = q0 + row;
  for (int k0 = lo; k0 < hi; k0 += BKV) {
    __syncthreads();                   // the previous tile is consumed
    load_tile<T>(ks, ld, kb + k0 * a.k_ss, a.k_ss, min(BKV, a.T - k0), a.D,
                 dpad, vec);
    load_tile<T>(vs, ld, vb + k0 * a.v_ss, a.v_ss, min(BKV, a.T - k0), a.D,
                 dpad, vec);
    __syncthreads();
    tile_qk(qs, ks, ss, ld, dpad);
    __syncthreads();

    float s[32];
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      const int k_pos = k0 + c;
      bool ok = k_pos < a.T;
      if (a.causal) ok = ok && k_pos <= q_pos;
      if (a.window > 0) ok = ok && k_pos > q_pos - a.window;
      s[j] = ok ? ss[row * BKV + c] * a.scale : NEG_INF;
      m_tile = fmaxf(m_tile, s[j]);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    const float m_prev = row_m[row];
    const float m_new = fmaxf(m_prev, m_tile);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = s[j] > NEG_INF ? expf(s[j] - m_new) : 0.0f;
      psum += p;
      ps[row * BKV + half * 32 + j] = from_f<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    __syncwarp();
    if (half == 0) {
      const float alpha = expf(m_prev - m_new);
      row_alpha[row] = alpha;
      row_l[row] = row_l[row] * alpha + psum;
      row_m[row] = m_new;
    }
    __syncthreads();
    for (int i = tid; i < BQ * dpad; i += FA_THREADS)
      os[i] *= row_alpha[i / dpad];
    __syncthreads();
    tile_pv(ps, vs, os, ld, dpad);
  }
  __syncthreads();

  T* og = static_cast<T*>(a.out) + b * a.o_sb + q0 * a.o_ss + h * a.o_sh;
  for (int i = tid; i < BQ * a.D; i += FA_THREADS) {
    const int r = i / a.D, c = i % a.D;
    if (q0 + r < a.S)
      og[r * a.o_ss + c] =
          from_f<T>(os[r * dpad + c] / fmaxf(row_l[r], 1e-30f));
  }
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int T_, int H, int KVH, int D,
                 const long long* strides, int causal, int window,
                 float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (D <= 0 || D > MAX_D || KVH <= 0 || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.q_sb = strides[0]; a.q_ss = strides[1]; a.q_sh = strides[2];
  a.k_sb = strides[3]; a.k_ss = strides[4]; a.k_sh = strides[5];
  a.v_sb = strides[6]; a.v_ss = strides[7]; a.v_sh = strides[8];
  a.o_sb = strides[9]; a.o_ss = strides[10]; a.o_sh = strides[11];
  a.S = S; a.T = T_; a.H = H; a.KVH = KVH; a.D = D;
  a.causal = causal; a.window = window; a.scale = scale;
  const int dpad = cdiv(D, 16) * 16;
  int vec = 0;
  if (sizeof(T) == 2 && D % 8 == 0) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v);
    bool ok = ptrs % 16 == 0;
    for (int i = 0; i < 9; ++i) ok = ok && strides[i] % 8 == 0;
    vec = ok ? 1 : 0;
  }
  const size_t smem = flash_smem_bytes<T>(dpad);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(cdiv(S, BQ), H, B);
  flash_kernel<T><<<grid, FA_THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(a, dpad, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---- wgmma route -------------------------------------------------------------
namespace fa_wg {

using namespace hopper;

constexpr int BQ = 64;          // query rows of a block: one consumer warpgroup
constexpr int BOX = 64;         // bf16 in a 128-byte swizzled box row
constexpr int STAGES = 2;       // K/V ring depth
constexpr int THREADS = 160;    // consumer warpgroup (warps 0-3) + producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <int DP, int BKV>
struct Cfg {
  static constexpr int ND = DP / BOX;                 // boxes along D
  static constexpr int Q_BYTES = ND * BQ * 128;
  static constexpr int KV_BYTES = ND * BKV * 128;     // one K or one V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // Q, the ring, 1024 bytes of slack to align them (the 128-byte swizzle
  // repeats every 1024 bytes), then the barriers: Q full, K full, V full
  // and empty per stage
  static constexpr int SMEM =
      Q_BYTES + STAGES * STAGE_BYTES + 1024 + 8 * (1 + 3 * STAGES);
  static_assert(DP == 64 || DP == 128, "wgmma N of P V");
  static_assert(BKV == 64 || BKV == 128, "wgmma N of Q K^T");
};

struct Args {
  __nv_bfloat16* out;
  long long o_sb, o_ss, o_sh;   // element strides; the D stride is 1
  int S, T, H, KVH, D;
  int causal, window;
  float scale_log2;             // D^-1/2 * log2(e)
};

template <int DP, int BKV>
__global__ void __launch_bounds__(THREADS, 2)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const Args a) {
  using C = Cfg<DP, BKV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = qs + C::Q_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // most K/V tiles first
  const int kvh = h / (a.H / a.KVH);
  // the K/V tiles that meet the band of this query tile
  int hi = a.T;
  if (a.causal) hi = min(hi, q0 + BQ);
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) / BKV * BKV : 0;
  const int n_tiles = hi > lo ? cdiv(hi - lo, BKV) : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(smem_u32(q_full), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&k_full[s]), 1);   // the producer's arrive
      mbar_init(smem_u32(&v_full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4);    // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The role through a shuffle: a value the compiler knows to be
  // warp-uniform, so it does not take the wgmma path for a divergent one.
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 1) {
    // ---- producer warp: one thread issues every TMA load -----------------
    if (tid == 128) {
      const uint32_t qbar = smem_u32(q_full);
      mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int j = 0; j < C::ND; ++j)
        tma_load_4d(smem_u32(qs + j * BQ * 128), &qmap, qbar, j * BOX, q0, h,
                    b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % STAGES;
        const int k0 = lo + n * BKV;
        mbar_wait(smem_u32(&empty[s]), ((n / STAGES) & 1) ^ 1);
        const uint32_t kt = smem_u32(ring + s * C::STAGE_BYTES);
        const uint32_t vt = kt + C::KV_BYTES;
        const uint32_t kbar = smem_u32(&k_full[s]);
        const uint32_t vbar = smem_u32(&v_full[s]);
        mbar_expect_tx(kbar, C::KV_BYTES);
#pragma unroll
        for (int j = 0; j < C::ND; ++j)
          tma_load_4d(kt + j * BKV * 128, &kmap, kbar, j * BOX, k0, kvh, b);
        mbar_expect_tx(vbar, C::KV_BYTES);
#pragma unroll
        for (int j = 0; j < C::ND; ++j)
          tma_load_4d(vt + j * BKV * 128, &vmap, vbar, j * BOX, k0, kvh, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows ---------------------------------
  // Thread l of warp w holds rows r = 16w + l/4 and r + 8 of the tile, and
  // for each 8-column group j the columns 8j + 2(l%4) and +1: accumulator
  // 4j + e is (row r + 8 (e / 2), column 8j + 2(l%4) + e % 2).
  const int lane = tid % 32, warp = tid / 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  float m[2] = {-INFINITY, -INFINITY};   // running max of the raw scores
  float l[2] = {0.0f, 0.0f};             // this thread's share of the sum
  float o[DP / 2];                       // defined by the first P V wgmma
  const uint32_t q_addr = smem_u32(qs);
  mbar_wait(smem_u32(q_full), 0);

  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % STAGES;
    const uint32_t phase = (n / STAGES) & 1;
    const int k0 = lo + n * BKV;
    const uint32_t k_addr = smem_u32(ring + s * C::STAGE_BYTES);
    const uint32_t v_addr = k_addr + C::KV_BYTES;

    // S = Q K^T: a k16 step is 32 bytes along a 128-byte row; the steps past
    // the first 64 columns of D are in the second box
    float sc[BKV / 2];
    mbar_wait(smem_u32(&k_full[s]), phase);
    fence_operands(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<0>(sc,
                  smem_desc(q_addr + (kk / 4) * BQ * 128 + off, 16, 1024),
                  smem_desc(k_addr + (kk / 4) * BKV * 128 + off, 16, 1024),
                  kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);

    // the mask, only on a tile that crosses T, the diagonal or the window
    const bool edge = __shfl_sync(
        0xffffffffu,
        k0 + BKV > a.T || (a.causal && k0 + BKV - 1 > q0) ||
            (a.window > 0 && k0 <= q0 + BQ - 1 - a.window),
        0);
    if (edge) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int q_pos = q0 + r0 + 8 * ((i % 4) / 2);
        const int k_pos = k0 + 8 * (i / 4) + c0 + i % 2;
        bool ok = k_pos < a.T;
        if (a.causal) ok = ok && k_pos <= q_pos;
        if (a.window > 0) ok = ok && k_pos > q_pos - a.window;
        if (!ok) sc[i] = -INFINITY;
      }
    }

    // online softmax in registers: a row's four threads share its max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    float alpha[2], msc[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      // a row with no attended key so far keeps p = 0 and alpha = 0
      msc[e] = mx[e] == -INFINITY ? 0.0f : mx[e] * a.scale_log2;
      alpha[e] = exp2f(m[e] * a.scale_log2 - msc[e]);
      m[e] = mx[e];
      l[e] *= alpha[e];
    }
    // p = exp2(s * scale * log2 e - max), summed in fp32 and rounded to bf16
    // pairs: register 2j + e/2 is the (row, column pair) of accumulators
    // 4j + e, e = 0, 2 — slice kk of P is registers 4kk .. 4kk+3, the A
    // fragment of a m64k16 wgmma
    uint32_t p[BKV / 4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = exp2f(fmaf(sc[4 * j + 2 * e], a.scale_log2, -msc[e]));
        const float p1 =
            exp2f(fmaf(sc[4 * j + 2 * e + 1], a.scale_log2, -msc[e]));
        l[e] += p0 + p1;
        __nv_bfloat162 pair = __floats2bfloat162_rn(p0, p1);
        p[2 * j + e] = *reinterpret_cast<uint32_t*>(&pair);
      }
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // O += P V: a k16 step is 16 rows (2 KB) down the MN-major V tile; its
    // D boxes are KV rows x 128 bytes apart
    mbar_wait(smem_u32(&v_full[s]), phase);
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                              p[4 * kk + 3]};
      wgmma_rs(o, pa, smem_desc(v_addr + kk * 2048, BKV * 128, 1024),
               n > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
  }

  // ---- epilogue: O / max(l, 1e-30) -> bf16 pairs, rows past S dropped ----
  float inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    inv[e] = 1.0f / fmaxf(l[e], 1e-30f);
  }
  __nv_bfloat16* ob = a.out + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + c0;
    if (col >= a.D) continue;   // D % 16 == 0: col < D means col + 1 < D
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q_pos = q0 + r0 + 8 * e;
      if (q_pos >= a.S) continue;
      // no K/V tile at all (a window past T): the simple route's zeros
      const float x0 = n_tiles > 0 ? o[4 * j + 2 * e] * inv[e] : 0.0f;
      const float x1 = n_tiles > 0 ? o[4 * j + 2 * e + 1] * inv[e] : 0.0f;
      *reinterpret_cast<__nv_bfloat162*>(ob + q_pos * a.o_ss + col) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

// one operand [B, rows, heads, D] as a 4-D map (D, rows, heads, B), boxes of
// 64 D x box_rows x 1 x 1; element strides (batch, row, head)
int encode_operand(CUtensorMap* map, const void* ptr, int B, int rows,
                   int heads, int D, const long long* st, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {BOX, (cuuint32_t)box_rows, 1, 1};
  return encode(map, ptr, 4, dims, strides, box);
}

template <int DP, int BKV>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_, int H, int KVH, int D, const long long* st,
           int causal, int window, float scale, void* stream) {
  using C = Cfg<DP, BKV>;
  CUtensorMap qmap, kmap, vmap;
  if (int err = encode_operand(&qmap, q, B, S, H, D, st, BQ)) return err;
  if (int err = encode_operand(&kmap, k, B, T_, KVH, D, st + 3, BKV))
    return err;
  if (int err = encode_operand(&vmap, v, B, T_, KVH, D, st + 6, BKV))
    return err;
  Args a;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.o_sb = st[9]; a.o_ss = st[10]; a.o_sh = st[11];
  a.S = S; a.T = T_; a.H = H; a.KVH = KVH; a.D = D;
  a.causal = causal; a.window = window;
  a.scale_log2 = scale * LOG2E;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DP, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, cdiv(S, BQ));
  flash_wgmma_kernel<DP, BKV><<<grid, THREADS, C::SMEM,
                                static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, a);
  return static_cast<int>(cudaGetLastError());
}

int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int T_, int H, int KVH, int D,
                 const long long* strides, int causal, int window,
                 float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (D <= 0 || D > MAX_D || D % 16 != 0 || KVH <= 0 || H % KVH != 0 ||
      T_ <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= BOX)
    return launch<64, 128>(q, k, v, out, B, S, T_, H, KVH, D, strides, causal,
                           window, scale, stream);
  return launch<128, 64>(q, k, v, out, B, S, T_, H, KVH, D, strides, causal,
                         window, scale, stream);
}

}  // namespace fa_wg

// =============================================================================
// decode: one query token per sequence, dense slab or pages
// =============================================================================

constexpr int DEC_CHUNK = 128;     // KV positions per block (one per thread)
constexpr int DEC_THREADS = DEC_CHUNK;
constexpr int MAX_GROUP = 16;      // query heads per KV head

struct DecodeArgs {
  const void* q;                   // [B, H, Dk]
  const void* k;                   // dense [B,T,KVH,Dk]; paged [P,ps,KVH,Dk]
  const void* v;
  long long q_sb, q_sh;
  long long k_s0, k_s1, k_sh;      // (batch, position) or (page, offset)
  long long v_s0, v_s1, v_sh;
  const unsigned char* valid;      // dense: [B, T] bool
  long long valid_sb;
  const int* bt;                   // paged: [B, maxp]
  const int* starts;               // paged: [B] or null (= 0)
  const int* lengths;              // paged: [B]
  int maxp, page_size;
  int H, KVH, T, Dk, Dv, n_chunks;
  float scale;
  float* part;                     // [B*H*n_chunks*Dv] acc, then [..*2] m, l
  void* out;                       // [B, H, Dv]
  long long o_sb, o_sh;
};

// Where a position's K/V rows are, and whether it is attended.
struct DenseKV {
  __device__ static bool ok(const DecodeArgs& a, int b, int t) {
    return a.valid[b * a.valid_sb + t] != 0;
  }
  __device__ static long long row(const DecodeArgs& a, long long s0,
                                  long long s1, int b, int t) {
    return b * s0 + t * s1;
  }
};

struct PagedKV {
  __device__ static bool ok(const DecodeArgs& a, int b, int t) {
    const int lo = a.starts != nullptr ? a.starts[b] : 0;
    return t >= lo && t < a.lengths[b];
  }
  __device__ static long long row(const DecodeArgs& a, long long s0,
                                  long long s1, int b, int t) {
    const long long page = a.bt[b * a.maxp + t / a.page_size];
    return page * s0 + (t % a.page_size) * s1;
  }
};

template <typename T, typename KV>
__global__ void __launch_bounds__(DEC_THREADS)
decode_partial_kernel(DecodeArgs a, int vec) {
  __shared__ float qs[MAX_GROUP][MAX_D];
  __shared__ float ps[MAX_GROUP][DEC_CHUNK];
  __shared__ unsigned char oks[DEC_CHUNK];
  __shared__ float ms[MAX_GROUP], ls[MAX_GROUP];

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KVH;
  const int tid = threadIdx.x;
  const int t = c * DEC_CHUNK + tid;

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb;
  for (int i = tid; i < G * a.Dk; i += DEC_THREADS) {
    const int g = i / a.Dk, d = i % a.Dk;
    qs[g][d] = to_f(qb[(kvh * G + g) * a.q_sh + d]);
  }
  const bool ok = t < a.T && KV::ok(a, b, t);
  oks[tid] = ok ? 1 : 0;
  __syncthreads();

  // scores of this thread's position against every head of the group
  float s[MAX_GROUP];
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g) s[g] = 0.0f;
  if (ok) {
    const T* kr = static_cast<const T*>(a.k) + KV::row(a, a.k_s0, a.k_s1, b, t)
                  + kvh * a.k_sh;
    if (vec) {
      for (int d0 = 0; d0 < a.Dk; d0 += 8) {
        uint4 raw = *reinterpret_cast<const uint4*>(kr + d0);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float kv = to_f(e[j]);
#pragma unroll
          for (int g = 0; g < MAX_GROUP; ++g)
            if (g < G) s[g] += qs[g][d0 + j] * kv;
        }
      }
    } else {
      for (int d = 0; d < a.Dk; ++d) {
        const float kv = to_f(kr[d]);
#pragma unroll
        for (int g = 0; g < MAX_GROUP; ++g)
          if (g < G) s[g] += qs[g][d] * kv;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g)
    if (g < G) ps[g][tid] = ok ? s[g] * a.scale : NEG_INF;
  __syncthreads();

  // per head: the chunk's max, p = exp(s - max) in the V dtype, and its sum
  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < G; g += DEC_THREADS / 32) {
    float m = NEG_INF;
    for (int j = lane; j < DEC_CHUNK; j += 32)
      if (oks[j]) m = fmaxf(m, ps[g][j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.0f;
    for (int j = lane; j < DEC_CHUNK; j += 32) {
      const float p = oks[j] ? expf(ps[g][j] - m) : 0.0f;
      l += p;
      ps[g][j] = to_f(from_f<T>(p));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      ms[g] = m;
      ls[g] = l;
    }
  }
  __syncthreads();

  // P V: thread d accumulates output dimension d over the chunk
  const long long pbase = (static_cast<long long>(b) * a.H + kvh * G) *
                          a.n_chunks + c;
  if (tid < a.Dv) {
    float acc[MAX_GROUP];
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) acc[g] = 0.0f;
    const T* vb = static_cast<const T*>(a.v) + kvh * a.v_sh + tid;
    for (int j = 0; j < DEC_CHUNK; ++j) {
      if (!oks[j]) continue;
      const float vv =
          to_f(vb[KV::row(a, a.v_s0, a.v_s1, b, c * DEC_CHUNK + j)]);
#pragma unroll
      for (int g = 0; g < MAX_GROUP; ++g)
        if (g < G) acc[g] += ps[g][j] * vv;
    }
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g)
      if (g < G) a.part[(pbase + g * a.n_chunks) * a.Dv + tid] = acc[g];
  }
  if (tid < G) {
    float* ml = a.part + static_cast<long long>(gridDim.z) * a.H *
                             a.n_chunks * a.Dv;
    ml[(pbase + tid * a.n_chunks) * 2] = ms[tid];
    ml[(pbase + tid * a.n_chunks) * 2 + 1] = ls[tid];
  }
}

// out[b, h] = sum_c exp(m_c - M) acc_c / sum_c exp(m_c - M) l_c over the
// chunks with a valid position, in ascending chunk order.  A row with no
// attended position takes a second pass: the softmax of a row of -1e30 logits
// is uniform, so the plain versions (and the JAX package) return
// sum_t bf16(1/T) v_t over every one of the T positions (every table entry,
// null pages included, when paged); the pass sums the same terms.
template <typename T, typename KV>
__global__ void __launch_bounds__(MAX_D)
decode_combine_kernel(DecodeArgs a) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const long long base = (static_cast<long long>(b) * a.H + h) * a.n_chunks;
  const float* ml = a.part + static_cast<long long>(gridDim.y) * a.H *
                                 a.n_chunks * a.Dv;
  float m = NEG_INF;
  bool attended = false;
  for (int c = 0; c < a.n_chunks; ++c)
    if (ml[(base + c) * 2 + 1] > 0.0f) {
      m = fmaxf(m, ml[(base + c) * 2]);
      attended = true;
    }
  if (d >= a.Dv) return;
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh + d;
  if (!attended) {
    const float p = to_f(from_f<T>(1.0f / static_cast<float>(a.T)));
    const T* vb = static_cast<const T*>(a.v) + (h / (a.H / a.KVH)) * a.v_sh
                  + d;
    float acc = 0.0f;
    for (int t = 0; t < a.T; ++t)
      acc += p * to_f(vb[KV::row(a, a.v_s0, a.v_s1, b, t)]);
    *out = from_f<T>(acc);
    return;
  }
  float num = 0.0f, den = 0.0f;
  for (int c = 0; c < a.n_chunks; ++c) {
    const float l = ml[(base + c) * 2 + 1];
    if (!(l > 0.0f)) continue;
    const float w = expf(ml[(base + c) * 2] - m);
    num += w * a.part[(base + c) * a.Dv + d];
    den += w * l;
  }
  *out = from_f<T>(num / fmaxf(den, 1e-30f));
}

template <typename T, typename KV>
int launch_decode(DecodeArgs& a, int B, void* stream) {
  if (B <= 0 || a.H <= 0) return 0;
  if (a.KVH <= 0 || a.H % a.KVH != 0 || a.H / a.KVH > MAX_GROUP ||
      a.Dk <= 0 || a.Dk > MAX_D || a.Dv <= 0 || a.Dv > MAX_D || a.T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.n_chunks = cdiv(a.T, DEC_CHUNK);
  int vec = 0;
  if (sizeof(T) == 2 && a.Dk % 8 == 0) {
    bool ok = reinterpret_cast<uintptr_t>(a.k) % 16 == 0;
    ok = ok && a.k_s0 % 8 == 0 && a.k_s1 % 8 == 0 && a.k_sh % 8 == 0;
    vec = ok ? 1 : 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(a.n_chunks, a.KVH, B);
  decode_partial_kernel<T, KV><<<grid, DEC_THREADS, 0, s>>>(a, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T, KV><<<dim3(a.H, B), MAX_D, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// strides: q_sb, q_sh, k_s0, k_s1, k_sh, v_s0, v_s1, v_sh, then (dense)
// valid_sb, or (paged) nothing; then o_sb, o_sh
DecodeArgs decode_args(const void* q, const void* k, const void* v,
                       void* part, void* out, int H, int KVH, int Dk, int Dv,
                       const long long* st, float scale) {
  DecodeArgs a = {};
  a.q = q; a.k = k; a.v = v;
  a.q_sb = st[0]; a.q_sh = st[1];
  a.k_s0 = st[2]; a.k_s1 = st[3]; a.k_sh = st[4];
  a.v_s0 = st[5]; a.v_s1 = st[6]; a.v_sh = st[7];
  a.H = H; a.KVH = KVH; a.Dk = Dk; a.Dv = Dv;
  a.scale = scale;
  a.part = static_cast<float*>(part);
  a.out = out;
  return a;
}

template <typename T>
int dense_decode(const void* q, const void* k, const void* v,
                 const void* valid, void* part, void* out, int B, int H,
                 int KVH, int T_, int D, const long long* st, float scale,
                 void* stream) {
  DecodeArgs a = decode_args(q, k, v, part, out, H, KVH, D, D, st, scale);
  a.valid = static_cast<const unsigned char*>(valid);
  a.valid_sb = st[8];
  a.o_sb = st[9]; a.o_sh = st[10];
  a.T = T_;
  return launch_decode<T, DenseKV>(a, B, stream);
}

template <typename T>
int paged_decode(const void* q, const void* k, const void* v, const void* bt,
                 const void* starts, const void* lengths, void* part,
                 void* out, int B, int H, int KVH, int maxp, int ps, int Dk,
                 int Dv, const long long* st, float scale, void* stream) {
  DecodeArgs a = decode_args(q, k, v, part, out, H, KVH, Dk, Dv, st, scale);
  a.bt = static_cast<const int*>(bt);
  a.starts = static_cast<const int*>(starts);
  a.lengths = static_cast<const int*>(lengths);
  a.maxp = maxp; a.page_size = ps;
  a.o_sb = st[8]; a.o_sh = st[9];
  if (ps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  a.T = maxp * ps;
  return launch_decode<T, PagedKV>(a, B, stream);
}

}  // namespace

extern "C" {

int decode_chunk_size() { return DEC_CHUNK; }

// strides: (batch, row, head) element strides of q, k, v, out; the D stride
// is 1
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int S, int T, int H, int KVH,
                         int D, const long long* strides, int causal,
                         int window, float scale, void* stream) {
  return fa_wg::launch_flash(q, k, v, out, B, S, T, H, KVH, D, strides,
                             causal, window, scale, stream);
}

int flash_attention_simple_bf16(const void* q, const void* k, const void* v,
                                void* out, int B, int S, int T, int H,
                                int KVH, int D, const long long* strides,
                                int causal, int window, float scale,
                                void* stream) {
  return launch_flash<__nv_bfloat16>(q, k, v, out, B, S, T, H, KVH, D,
                                     strides, causal, window, scale, stream);
}

int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int T, int H, int KVH, int D,
                        const long long* strides, int causal, int window,
                        float scale, void* stream) {
  return launch_flash<float>(q, k, v, out, B, S, T, H, KVH, D, strides,
                             causal, window, scale, stream);
}

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* valid, void* part, void* out, int B,
                          int H, int KVH, int T, int D,
                          const long long* strides, float scale,
                          void* stream) {
  return dense_decode<__nv_bfloat16>(q, k, v, valid, part, out, B, H, KVH, T,
                                     D, strides, scale, stream);
}

int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* valid, void* part, void* out, int B,
                         int H, int KVH, int T, int D,
                         const long long* strides, float scale,
                         void* stream) {
  return dense_decode<float>(q, k, v, valid, part, out, B, H, KVH, T, D,
                             strides, scale, stream);
}

int paged_decode_bf16(const void* q, const void* k, const void* v,
                      const void* bt, const void* starts, const void* lengths,
                      void* part, void* out, int B, int H, int KVH, int maxp,
                      int ps, int Dk, int Dv, const long long* strides,
                      float scale, void* stream) {
  return paged_decode<__nv_bfloat16>(q, k, v, bt, starts, lengths, part, out,
                                     B, H, KVH, maxp, ps, Dk, Dv, strides,
                                     scale, stream);
}

int paged_decode_f32(const void* q, const void* k, const void* v,
                     const void* bt, const void* starts, const void* lengths,
                     void* part, void* out, int B, int H, int KVH, int maxp,
                     int ps, int Dk, int Dv, const long long* strides,
                     float scale, void* stream) {
  return paged_decode<float>(q, k, v, bt, starts, lengths, part, out, B, H,
                             KVH, maxp, ps, Dk, Dv, strides, scale, stream);
}

}  // extern "C"
