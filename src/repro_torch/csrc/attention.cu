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
// decode_attention / paged_decode: one device routine, so a paged decode
// equals the dense decode bit for bit (the same positions summed in the same
// order).  The two entry points differ only in where a position's K/V row is
// (slab stride, or block-table page + offset) and in the mask (valid[b, t],
// or starts[b] <= t < lengths[b]); masked positions are never loaded, so
// trailing table entries may point anywhere.  A row with no attended
// position averages V over every position (every table entry, null pages
// included), as the plain versions' softmax of an all-masked row does.  Two
// routes, picked by the Python wrapper from dtype, head dims, strides and
// alignment alone (kernels/decode_attention/ops.py route()), the same for
// the slab and for pages:
//
// mma (bf16, Dk and Dv multiples of 8, 16-byte aligned bases and strides).
// Split KV to fill the card: the wrapper picks the positions per block from
// (B, KVH, T, SM count) alone, about one block an SM (measured faster than
// two at both serving shapes), whole 16-position tiles counted from
// position 0, so a slab and pages of equal T split alike.
// The n <= 16 splits of one (KV head, batch row) are one thread-block
// cluster.  A block (4 warps) first loads, in one round, the group's G <= 16
// query heads (cp.async into a 16-row tile, rows past G zero), the split's
// slice of valid (dense: a ballot a warp gives two tiles' masks) or its
// table entries with starts and lengths (paged: one read per page).  A split
// with nothing attended loads no K or V and contributes l = 0.  Warp w then
// walks tiles w, w + 4, ... of the split with two in flight: every lane
// issues 16-byte cp.async copies of the attended K and V rows (masked rows
// zero-filled, never read).  Per tile, mma.sync.m16n8k16 (bf16 in, fp32
// accumulate) with the query heads as M: S[16 x 16] = Q K^T (ldmatrix), the
// online softmax on the accumulator fragments in log2 units (scale * log2 e
// folded into exp2, a quad shuffle per row), the unnormalised p rounded to
// bf16 as the A fragment of O += P V with V read by ldmatrix.trans; O stays
// in registers.  The block merges its warps' (O, m, l) in ascending order
// into the split's partial in its own shared memory; after a cluster
// barrier the cluster's threads combine the splits in ascending order
// through distributed shared memory (no partial goes to device memory, one
// launch) and write the output.
//
// simple (any other bf16 shape, e.g. D = 14; also exposed as
// decode_attention_simple_bf16 / paged_decode_simple_bf16 so that a
// measurement can hold the mma route against it) and fp32: chunks of
// DEC_CHUNK = 128 positions, one block per (chunk, KV head, batch row) serving
// all heads of the group: thread j scores position j against every head, a
// warp per head takes the chunk's max and sum, each thread then accumulates
// one output dimension over the chunk (a chain of dependent loads); partial
// (acc, max, sum) go to a scratch buffer and a second kernel combines the
// chunks in ascending order.
//
// Bounds at the serving shapes (Qwen2-0.5B: H 14, KVH 2, D 64, bf16; H100 SXM
// data sheet: 989 TFLOP/s bf16, 3.35 TB/s):
//   prefill S = T = 512: causal QK^T + PV 0.47 GFLOP -> 0.48 us; q, k, v, out
//     2.10 MB -> 0.63 us; bound by bytes.
//   decode 8 slots, T = 1024: bound by bytes, the attended positions' K and V
//     rows (the only ones read), q and the output: 4.19 MB -> 1.25 us when
//     every position is attended; chip_smoke.py counts those of its run
//     (about half at the serve trace's lengths).  No decode kernel nears
//     it: a launch that reads ~2 MB spends its time in the chain of
//     dependent steps (the stage round, the K/V round, the tile products,
//     the merges), not in moving bytes.
//   prefill S = T = 1024 (the serve engine's max_len): 1.88 GFLOP -> 1.9 us;
//     4.19 MB -> 1.25 us; bound by operations.
//   Kimi-K2 prefill S = T = 512, 64/8 heads of 112: 3.77 GFLOP -> 3.8 us;
//     16.5 MB -> 4.9 us; bound by bytes.
// What the wgmma route leaves on the table: within a block the two products
// and the softmax run one after another (FA3's overlap of a tile's softmax
// with the next tile's Q K^T measured slower at the serving shapes, see
// PERF.md), each (query tile, head) block re-reads its K/V tiles from L2
// (Kimi-K2's 8 heads a KV group), and the output is stored from registers
// in 4-byte pieces.  The decode mma route pads the group's G query heads to
// the 16 rows of an mma (7 of 16 used for Qwen2-0.5B, 8 for Kimi-K2) and
// walks a split's tiles in each warp one after another.
#include <cooperative_groups.h>
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

constexpr int DEC_CHUNK = 128;     // simple/fp32: KV positions per block
constexpr int DEC_THREADS = DEC_CHUNK;
constexpr int MAX_GROUP = 16;      // query heads per KV head
constexpr int DT = 16;             // mma: KV positions per tile
constexpr int DM_MAX_SPLITS = 16;  // mma: most splits (a cluster's blocks)
constexpr unsigned FULL = 0xffffffffu;

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
  int H, KVH, T, Dk, Dv;
  int n_chunks;                    // simple/fp32: chunks; mma: splits
  int split_len, dkp;              // mma: positions per split; Dk padded to 16
  float scale;
  float* part;                     // simple/fp32: [B*H*n_chunks*Dv] acc, then
                                   // [..*2] m, l
  void* out;                       // [B, H, Dv]
  long long o_sb, o_sh;
};

// Where a position's K/V rows are, and whether it is attended.  For the mma
// route, stage() (called by every thread of a block) puts the split's tile
// masks (a bit per attended position) into tmask and, paged, the table
// entries of the pages it spans into pages, and says whether any position is
// attended; tile_row() then gives an attended position's K and V rows.
struct DenseKV {
  __device__ static bool ok(const DecodeArgs& a, int b, int t) {
    return a.valid[b * a.valid_sb + t] != 0;
  }
  __device__ static long long row(const DecodeArgs& a, long long s0,
                                  long long s1, int b, int t) {
    return b * s0 + t * s1;
  }
  // the split's slice of valid, a warp per 32 positions (two tiles)
  __device__ static bool stage(const DecodeArgs& a, int b, int s0, int s1,
                               int n_tiles, unsigned short* tmask, int*) {
    const int lane = threadIdx.x % 32;
    int found = 0;
    for (int t0 = s0 + threadIdx.x / 32 * 32; t0 < s0 + n_tiles * DT;
         t0 += blockDim.x) {
      const int t = t0 + lane;
      const bool on = t < s1 && ok(a, b, t);
      const unsigned m = __ballot_sync(FULL, on);
      const int i = (t0 - s0) / DT;
      if (lane == 0) {
        tmask[i] = m & 0xffffu;
        if (i + 1 < n_tiles) tmask[i + 1] = m >> 16;
      }
      found |= on;
    }
    return __syncthreads_or(found) != 0;
  }
  __device__ static void tile_row(const DecodeArgs& a, int b, int t, int,
                                  const int*, long long& k_row,
                                  long long& v_row) {
    k_row = row(a, a.k_s0, a.k_s1, b, t);
    v_row = row(a, a.v_s0, a.v_s1, b, t);
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
  // one read per table entry of the split (an int of the table, whatever
  // page it names), loaded together with starts and lengths
  __device__ static bool stage(const DecodeArgs& a, int b, int s0, int s1,
                               int n_tiles, unsigned short* tmask,
                               int* pages) {
    const int p0 = s0 / a.page_size, np = (s1 - 1) / a.page_size - p0 + 1;
    for (int p = threadIdx.x; p < np; p += blockDim.x)
      pages[p] = a.bt[b * a.maxp + p0 + p];
    const int lo = max(s0, a.starts != nullptr ? a.starts[b] : 0);
    const int hi = min(s1, a.lengths[b]);
    for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
      const int t0 = s0 + i * DT;
      const int x0 = max(lo, t0) - t0, x1 = min(hi, t0 + DT) - t0;
      tmask[i] = x1 > x0 ? ((1u << x1) - 1u) & ~((1u << x0) - 1u) : 0u;
    }
    __syncthreads();
    return lo < hi;
  }
  __device__ static void tile_row(const DecodeArgs& a, int, int t, int s0,
                                  const int* pages, long long& k_row,
                                  long long& v_row) {
    const long long page = pages[t / a.page_size - s0 / a.page_size];
    const int off = t % a.page_size;
    k_row = page * a.k_s0 + off * a.k_s1;
    v_row = page * a.v_s0 + off * a.v_s1;
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

// ---- mma route: split KV over cp.async tiles, tensor-core products ----------
//
// A cluster of n <= DM_MAX_SPLITS blocks owns one (KV head, batch row), a
// block one split of its positions.  A block first stages, with one round of
// loads, the group's queries (cp.async), the split's masks and (paged) its
// table entries.  Then warp w takes tiles w, w + DM_WARPS, ... of the split
// (interleaved, so a split cut short by a row's length still spreads over
// all warps) and keeps DM_STAGES of them in flight.  Per tile the group's
// G <= 16 query heads (zero rows past G) are the M of mma.m16n8k16:
// S[16 x 16] = Q K^T over Dk in k-steps of 16, then O[16 x Dv] += P[16 x 16]
// V[16 x Dv].  The block merges its warps into the split's partial in its
// own shared memory, and after a cluster barrier the blocks combine the
// splits through distributed shared memory: no partial leaves the cluster.

constexpr int DM_WARPS = 4;
constexpr int DM_STAGES = 2;       // tiles in flight per warp
constexpr int DM_THREADS = DM_WARPS * 32;
constexpr int DM_KSTEPS = MAX_D / 16;
constexpr int DM_NBLOCKS = MAX_D / 8;

// Row stride (elements) of a Q, K or V tile in shared memory: the width in
// 16-byte chunks made odd, so the eight rows one ldmatrix phase reads fall
// on eight different bank groups.
__host__ __device__ inline int dm_ld(int width) {
  return (cdiv(width, 8) | 1) * 8;
}

// Dynamic shared memory, in this order: the warps' tile rings (each ring
// then holds its warp's O [16 x Dv], m [16], l [16] in fp32 for the block's
// merge: 64 Dv + 128 bytes, less than the ring's 64 (ldk + ldv)); the
// split's partial (O [16 x Dv], then (m, l) [16]); the Q tile; the tile
// masks (a u16 each); and (paged) the table entries the split spans.
struct DmLayout {
  int ring_elems, part_floats, q_elems, mask_words;
  __host__ __device__ DmLayout(int dkp, int dv, int n_tiles)
      : ring_elems(DM_STAGES * DT * (dm_ld(dkp) + dm_ld(dv))),
        part_floats(16 * dv + 32),
        q_elems(DT * dm_ld(dkp)),
        mask_words(cdiv(n_tiles, 2)) {}
  __host__ __device__ size_t bytes(int n_pages) const {
    return static_cast<size_t>(DM_WARPS) * ring_elems * 2 +
           static_cast<size_t>(part_floats) * 4 +
           static_cast<size_t>(q_elems) * 2 +
           static_cast<size_t>(mask_words) * 4 +
           static_cast<size_t>(n_pages) * 4;
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with on = false nothing is read and the 16
// bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(on ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Put tile i of the split (attended positions in `mask`) in flight into one
// stage.  Lanes j and j + 16 take position s0 + 16 i + j and copy alternate
// 16-byte chunks of its K and V rows; masked rows (and K's pad columns past
// Dk) are zero-filled and never read, so trailing table entries may point
// anywhere.  A tile with no attended position issues nothing.
template <typename KV>
__device__ __forceinline__ void dm_issue(const DecodeArgs& a, int b, int kvh,
                                         int s0, int i, unsigned mask,
                                         const int* pages,
                                         __nv_bfloat16* ks,
                                         __nv_bfloat16* vs) {
  if (mask == 0) return;
  const int lane = threadIdx.x % 32, r = lane % DT;
  const bool ok = (mask >> r) & 1u;
  long long k_row = 0, v_row = 0;
  if (ok) KV::tile_row(a, b, s0 + i * DT + r, s0, pages, k_row, v_row);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  const __nv_bfloat16* kr = k + k_row + kvh * a.k_sh;
  const __nv_bfloat16* vr = v + v_row + kvh * a.v_sh;
  ks += r * dm_ld(a.dkp);
  vs += r * dm_ld(a.Dv);
  for (int c = lane / DT * 8; c < a.dkp; c += 16) {
    const bool on = ok && c < a.Dk;
    cp_async16(ks + c, on ? kr + c : k, on);
  }
  for (int c = lane / DT * 8; c < a.Dv; c += 16)
    cp_async16(vs + c, ok ? vr + c : v, ok);
}

// After the cluster barrier: out = sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s -
// M) l_s over the splits with an attended position, in ascending split
// order, read from the cluster's blocks through distributed shared memory.
// The cluster's threads share the output, 4 columns of a head each.  A group
// with no attended position takes the simple route's second pass: V averaged
// over all T positions with weights bf16(1/T), as the plain versions'
// softmax of an all-masked row gives.
template <typename KV>
__device__ void dm_combine(const DecodeArgs& a, int b, int kvh,
                           float* part) {
  using T = __nv_bfloat16;
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int G = a.H / a.KVH, n = a.n_chunks, d4 = a.Dv / 4;
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = rank + n * static_cast<int>(threadIdx.x); i < G * d4;
       i += n * DM_THREADS) {
    const int r = i / d4, d = (i % d4) * 4, h = kvh * G + r;
    float m = -INFINITY, l = 0.0f;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float2 st[DM_MAX_SPLITS];
    float4 x[DM_MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < DM_MAX_SPLITS; ++s)
      if (s < n) {
        const float* p = cluster.map_shared_rank(part, s);
        st[s] = *reinterpret_cast<const float2*>(p + 16 * a.Dv + 2 * r);
        x[s] = *reinterpret_cast<const float4*>(p + r * a.Dv + d);
      }
#pragma unroll
    for (int s = 0; s < DM_MAX_SPLITS; ++s)
      if (s < n && st[s].y > 0.0f) m = fmaxf(m, st[s].x);
#pragma unroll
    for (int s = 0; s < DM_MAX_SPLITS; ++s)
      if (s < n && st[s].y > 0.0f) {
        const float f = exp2f(st[s].x - m);
        acc[0] += f * x[s].x;
        acc[1] += f * x[s].y;
        acc[2] += f * x[s].z;
        acc[3] += f * x[s].w;
        l += f * st[s].y;
      }
    if (l > 0.0f) {
      for (int e = 0; e < 4; ++e) acc[e] /= fmaxf(l, 1e-30f);
    } else {
      const float p = to_f(from_f<T>(1.0f / static_cast<float>(a.T)));
      const T* vb = static_cast<const T*>(a.v) + kvh * a.v_sh + d;
      for (int t = 0; t < a.T; ++t) {
        const T* vr = vb + KV::row(a, a.v_s0, a.v_s1, b, t);
        for (int e = 0; e < 4; ++e) acc[e] += p * to_f(vr[e]);
      }
    }
    T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh + d;
    for (int e = 0; e < 4; ++e) out[e] = from_f<T>(acc[e]);
  }
}

template <typename KV>
__global__ void __launch_bounds__(DM_THREADS, 3)
decode_mma_kernel(DecodeArgs a) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char dm_smem[];
  __shared__ float merge_w[DM_WARPS][MAX_GROUP];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KVH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int s0 = split * a.split_len;
  const int s1 = min(s0 + a.split_len, a.T);
  const int n_tiles = cdiv(s1 - s0, DT);
  const int ldk = dm_ld(a.dkp), ldv = dm_ld(a.Dv);
  const DmLayout lay(a.dkp, a.Dv, cdiv(a.split_len, DT));
  T* rings = reinterpret_cast<T*>(dm_smem);
  float* part = reinterpret_cast<float*>(rings + DM_WARPS * lay.ring_elems);
  T* qs = reinterpret_cast<T*>(part + lay.part_floats);
  unsigned short* tmask = reinterpret_cast<unsigned short*>(qs + lay.q_elems);
  int* pages = reinterpret_cast<int*>(tmask + 2 * lay.mask_words);
  float* part_ml = part + 16 * a.Dv;         // (m, l) per head

  // one round of loads: the group's queries (rows past G and columns past Dk
  // zero) by cp.async, with the split's masks and (paged) table entries
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb +
                static_cast<long long>(kvh) * G * a.q_sh;
  const int cq = a.dkp / 8;
  for (int c = tid; c < DT * cq; c += DM_THREADS) {
    const int r = c / cq, col = (c % cq) * 8;
    const bool on = r < G && col < a.Dk;
    cp_async16(qs + r * ldk + col, on ? qb + r * a.q_sh + col : qb, on);
  }
  cp_async_commit();

  if (!KV::stage(a, b, s0, s1, n_tiles, tmask, pages)) {
    // nothing attended in the split: an empty partial (l = 0), no K/V load
    cp_async_wait<0>();
    if (tid < G) {
      part_ml[2 * tid] = NEG_INF;
      part_ml[2 * tid + 1] = 0.0f;
    }
  } else {
    T* ring = rings + warp * lay.ring_elems;
    const int stage_elems = lay.ring_elems / DM_STAGES;
#pragma unroll
    for (int s = 0; s < DM_STAGES; ++s) {
      const int i = warp + s * DM_WARPS;
      if (i < n_tiles)
        dm_issue<KV>(a, b, kvh, s0, i, tmask[i], pages,
                     ring + s * stage_elems, ring + s * stage_elems + DT * ldk);
      cp_async_commit();
    }
    cp_async_wait<DM_STAGES>();    // the queries have landed
    __syncthreads();

    // the queries as A fragments of S = Q K^T: lane (g, tq) holds rows g and
    // g + 8, columns 2tq, 2tq + 1 (+ 8) of each k-step
    const int nks = a.dkp / 16, nnb = a.Dv / 8;
    const int mat = lane / 8;
    unsigned qa[DM_KSTEPS][4];
    {
      const T* qbase = qs + ((mat & 1) * 8 + lane % 8) * ldk + (mat >> 1) * 8;
#pragma unroll
      for (int ks = 0; ks < DM_KSTEPS; ++ks)
        if (ks < nks) ldsm_x4(qa[ks], qbase + ks * 16);
    }

    const float c2 = a.scale * 1.4426950408889634f;   // scale * log2(e)
    float o[DM_NBLOCKS][4];
#pragma unroll
    for (int nb = 0; nb < DM_NBLOCKS; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nb][e] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};

    for (int j = 0; warp + j * DM_WARPS < n_tiles; ++j) {
      const int stage = j % DM_STAGES;
      cp_async_wait<DM_STAGES - 1>();
      __syncwarp();
      const unsigned mask = tmask[warp + j * DM_WARPS];
      const T* ks_t = ring + stage * stage_elems;
      const T* vs_t = ks_t + DT * ldk;
      if (mask != 0) {
        // S = Q K^T: one ldmatrix.x4 gives both 8-position halves of a
        // k-step
        float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
        const T* kbase =
            ks_t + ((mat >> 1) * 8 + lane % 8) * ldk + (mat & 1) * 8;
#pragma unroll
        for (int ks = 0; ks < DM_KSTEPS; ++ks)
          if (ks < nks) {
            unsigned kb[4];
            ldsm_x4(kb, kbase + ks * 16);
            mma_bf16(s[0], qa[ks], kb[0], kb[1]);
            mma_bf16(s[1], qa[ks], kb[2], kb[3]);
          }
        // online softmax on the fragments, in log2 units; lane (g, tq) holds
        // positions 8nb + 2tq (+1) of rows g (e = 0, 1) and g + 8 (e = 2, 3)
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int pos = nb * 8 + 2 * tq + e;
              const float x =
                  (mask >> pos) & 1u ? s[nb][2 * h + e] * c2 : -INFINITY;
              s[nb][2 * h + e] = x;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
          // the quad covers all 16 positions, one of them attended: finite
          const float m_new = fmaxf(m_run[h], mx);
          alpha[h] = exp2f(m_run[h] - m_new);
          m_run[h] = m_new;
          float sum = 0.0f;
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = exp2f(s[nb][2 * h + e] - m_new);
              s[nb][2 * h + e] = p;
              sum += p;
            }
          l_run[h] = l_run[h] * alpha[h] + sum;
        }
        // P as the A fragment of O += P V: the unnormalised p rounded to
        // bf16 (ROADMAP C8)
        const unsigned pa[4] = {pack_bf16(s[0][0], s[0][1]),
                                pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]),
                                pack_bf16(s[1][2], s[1][3])};
#pragma unroll
        for (int nb = 0; nb < DM_NBLOCKS; ++nb)
          if (nb < nnb) {
            o[nb][0] *= alpha[0];
            o[nb][1] *= alpha[0];
            o[nb][2] *= alpha[1];
            o[nb][3] *= alpha[1];
          }
        // V [16 x Dv] read transposed by ldmatrix: one .x4 for 16 columns,
        // an .x2 (lanes 0-15 give the rows) for a last 8
        const T* vbase =
            vs_t + ((mat & 1) * 8 + lane % 8) * ldv + (mat >> 1) * 8;
#pragma unroll
        for (int n2 = 0; n2 < DM_NBLOCKS / 2; ++n2) {
          if (2 * n2 + 1 < nnb) {
            unsigned vb[4];
            ldsm_x4_t(vb, vbase + n2 * 16);
            mma_bf16(o[2 * n2], pa, vb[0], vb[1]);
            mma_bf16(o[2 * n2 + 1], pa, vb[2], vb[3]);
          } else if (2 * n2 < nnb) {
            unsigned vb[2];
            ldsm_x2_t(vb, vbase + n2 * 16);
            mma_bf16(o[2 * n2], pa, vb[0], vb[1]);
          }
        }
      }
      __syncwarp();                // the stage is read before it is refilled
      const int i = warp + (j + DM_STAGES) * DM_WARPS;
      if (i < n_tiles)
        dm_issue<KV>(a, b, kvh, s0, i, tmask[i], pages,
                     ring + stage * stage_elems,
                     ring + stage * stage_elems + DT * ldk);
      cp_async_commit();
    }
    cp_async_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(FULL, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(FULL, l_run[h], 2);
    }
    __syncwarp();

    // the warp's (O, m, l) into its own ring, then the block merges its
    // warps in ascending order into the split's partial: a thread per head
    // finds its weights, then a thread per 4 columns sums
    float* wo = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int nb = 0; nb < DM_NBLOCKS; ++nb)
      if (nb < nnb) {
        const int c = nb * 8 + 2 * tq;
        wo[g * a.Dv + c] = o[nb][0];
        wo[g * a.Dv + c + 1] = o[nb][1];
        wo[(g + 8) * a.Dv + c] = o[nb][2];
        wo[(g + 8) * a.Dv + c + 1] = o[nb][3];
      }
    if (tq == 0) {
      wo[16 * a.Dv + g] = m_run[0];
      wo[16 * a.Dv + g + 8] = m_run[1];
      wo[16 * a.Dv + 16 + g] = l_run[0];
      wo[16 * a.Dv + 24 + g] = l_run[1];
    }
    __syncthreads();
    const float* wf = reinterpret_cast<const float*>(dm_smem);
    const int wstride = lay.ring_elems / 2;          // floats a ring
    if (tid < G) {
      float m = -INFINITY, l = 0.0f;
      for (int w = 0; w < DM_WARPS; ++w)
        if (wf[w * wstride + 16 * a.Dv + 16 + tid] > 0.0f)
          m = fmaxf(m, wf[w * wstride + 16 * a.Dv + tid]);
      for (int w = 0; w < DM_WARPS; ++w) {
        const float lw = wf[w * wstride + 16 * a.Dv + 16 + tid];
        const float f =
            lw > 0.0f ? exp2f(wf[w * wstride + 16 * a.Dv + tid] - m) : 0.0f;
        merge_w[w][tid] = f;
        l += f * lw;
      }
      part_ml[2 * tid] = l > 0.0f ? m : NEG_INF;
      part_ml[2 * tid + 1] = l;
    }
    __syncthreads();
    const int d4 = a.Dv / 4;
    for (int i = tid; i < G * d4; i += DM_THREADS) {
      const int r = i / d4, c = (i % d4) * 4;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int w = 0; w < DM_WARPS; ++w) {
        const float f = merge_w[w][r];
        const float4 x =
            *reinterpret_cast<const float4*>(wf + w * wstride + r * a.Dv + c);
        acc.x += f * x.x;
        acc.y += f * x.y;
        acc.z += f * x.z;
        acc.w += f * x.w;
      }
      *reinterpret_cast<float4*>(part + r * a.Dv + c) = acc;
    }
  }

  // every split's partial is in its block's shared memory: combine them
  // across the cluster, and keep each block's memory until all have read it
  cooperative_groups::this_cluster().sync();
  dm_combine<KV>(a, b, kvh, part);
  cooperative_groups::this_cluster().sync();
}

template <typename KV>
int launch_decode_mma(DecodeArgs& a, int B, int split_len, void* stream) {
  if (B <= 0 || a.H <= 0) return 0;
  if (a.KVH <= 0 || a.H % a.KVH != 0 || a.H / a.KVH > MAX_GROUP ||
      a.Dk <= 0 || a.Dk > MAX_D || a.Dk % 8 != 0 || a.Dv <= 0 ||
      a.Dv > MAX_D || a.Dv % 8 != 0 || a.T <= 0 || split_len <= 0 ||
      split_len % DT != 0 || cdiv(a.T, split_len) > DM_MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies: aligned bases and strides
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) |
                         reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v);
  const long long st[] = {a.q_sb, a.q_sh, a.k_s0, a.k_s1, a.k_sh,
                          a.v_s0, a.v_s1, a.v_sh};
  bool aligned = ptrs % 16 == 0;
  for (long long x : st) aligned = aligned && x % 8 == 0;
  if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
  a.split_len = split_len;
  a.n_chunks = cdiv(a.T, split_len);
  a.dkp = cdiv(a.Dk, 16) * 16;
  // paged: the table entries a split spans
  const int n_pages = a.page_size > 0 ? split_len / a.page_size + 2 : 0;
  const size_t smem = DmLayout(a.dkp, a.Dv, split_len / DT).bytes(n_pages);
  // the attributes are set once (the shared-memory limit to the card's
  // most), so that a launch recorded into a CUDA graph makes none
  static const cudaError_t configured = [] {
    int dev = 0, most = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(decode_mma_kernel<KV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most - 1024);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          decode_mma_kernel<KV>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_chunks, a.KVH, B);
  cfg.blockDim = dim3(DM_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.n_chunks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_mma_kernel<KV>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
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

// split > 0 takes the mma route (bf16) with `split` positions a block; 0
// the simple (bf16) or fp32 routine
template <typename T, typename KV>
int route_decode(DecodeArgs& a, int B, int split, void* stream) {
  if constexpr (sizeof(T) == 2)
    if (split > 0) return launch_decode_mma<KV>(a, B, split, stream);
  return launch_decode<T, KV>(a, B, stream);
}

template <typename T>
int dense_decode(const void* q, const void* k, const void* v,
                 const void* valid, void* part, void* out, int B, int H,
                 int KVH, int T_, int D, const long long* st, float scale,
                 int split, void* stream) {
  DecodeArgs a = decode_args(q, k, v, part, out, H, KVH, D, D, st, scale);
  a.valid = static_cast<const unsigned char*>(valid);
  a.valid_sb = st[8];
  a.o_sb = st[9]; a.o_sh = st[10];
  a.T = T_;
  return route_decode<T, DenseKV>(a, B, split, stream);
}

template <typename T>
int paged_decode(const void* q, const void* k, const void* v, const void* bt,
                 const void* starts, const void* lengths, void* part,
                 void* out, int B, int H, int KVH, int maxp, int ps, int Dk,
                 int Dv, const long long* st, float scale, int split,
                 void* stream) {
  DecodeArgs a = decode_args(q, k, v, part, out, H, KVH, Dk, Dv, st, scale);
  a.bt = static_cast<const int*>(bt);
  a.starts = static_cast<const int*>(starts);
  a.lengths = static_cast<const int*>(lengths);
  a.maxp = maxp; a.page_size = ps;
  a.o_sb = st[8]; a.o_sh = st[9];
  if (ps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  a.T = maxp * ps;
  return route_decode<T, PagedKV>(a, B, split, stream);
}

}  // namespace

extern "C" {

int decode_chunk_size() { return DEC_CHUNK; }
int decode_tile_positions() { return DT; }
int decode_max_splits() { return DM_MAX_SPLITS; }

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

// the mma route: `split` positions a block, a multiple of
// decode_tile_positions(), at most decode_max_splits() splits; part unused
int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* valid, void* part, void* out, int B,
                          int H, int KVH, int T, int D,
                          const long long* strides, float scale, int split,
                          void* stream) {
  return dense_decode<__nv_bfloat16>(q, k, v, valid, part, out, B, H, KVH, T,
                                     D, strides, scale, split, stream);
}

// the simple route (one thread per position of a DEC_CHUNK chunk) at any bf16
// shape, so that a measurement can hold the mma route against it
int decode_attention_simple_bf16(const void* q, const void* k, const void* v,
                                 const void* valid, void* part, void* out,
                                 int B, int H, int KVH, int T, int D,
                                 const long long* strides, float scale,
                                 void* stream) {
  return dense_decode<__nv_bfloat16>(q, k, v, valid, part, out, B, H, KVH, T,
                                     D, strides, scale, 0, stream);
}

int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* valid, void* part, void* out, int B,
                         int H, int KVH, int T, int D,
                         const long long* strides, float scale,
                         void* stream) {
  return dense_decode<float>(q, k, v, valid, part, out, B, H, KVH, T, D,
                             strides, scale, 0, stream);
}

int paged_decode_bf16(const void* q, const void* k, const void* v,
                      const void* bt, const void* starts, const void* lengths,
                      void* part, void* out, int B, int H, int KVH, int maxp,
                      int ps, int Dk, int Dv, const long long* strides,
                      float scale, int split, void* stream) {
  return paged_decode<__nv_bfloat16>(q, k, v, bt, starts, lengths, part, out,
                                     B, H, KVH, maxp, ps, Dk, Dv, strides,
                                     scale, split, stream);
}

int paged_decode_simple_bf16(const void* q, const void* k, const void* v,
                             const void* bt, const void* starts,
                             const void* lengths, void* part, void* out,
                             int B, int H, int KVH, int maxp, int ps, int Dk,
                             int Dv, const long long* strides, float scale,
                             void* stream) {
  return paged_decode<__nv_bfloat16>(q, k, v, bt, starts, lengths, part, out,
                                     B, H, KVH, maxp, ps, Dk, Dv, strides,
                                     scale, 0, stream);
}

int paged_decode_f32(const void* q, const void* k, const void* v,
                     const void* bt, const void* starts, const void* lengths,
                     void* part, void* out, int B, int H, int KVH, int maxp,
                     int ps, int Dk, int Dv, const long long* strides,
                     float scale, void* stream) {
  return paged_decode<float>(q, k, v, bt, starts, lengths, part, out, B, H,
                             KVH, maxp, ps, Dk, Dv, strides, scale, 0,
                             stream);
}

}  // extern "C"
