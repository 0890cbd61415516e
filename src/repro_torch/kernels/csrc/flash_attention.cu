// Hopper (sm_90a) flash attention for the LM prefill path:
//   out[b, h, i, :] = softmax_j(q[b, h, i] . k[b, g(h), j] * scale) v[b, g(h), j]
// over the keys j visible to row i, with g(h) = (h0 + h) / group - h0 / group
// (GQA: group query heads a kv head; h0 the launch's first query head in the
// model, so a model rank's heads may straddle groups; by default group =
// hq / hkv and h0 = 0, g(h) = h / (hq / hkv)).
//
// Replaces: repro/kernels/flash_attention.py  flash_attention_pallas.
//
// It computes what that kernel computes: online softmax with f32 logits,
// running max, normalizer and accumulator; row i sits at
// qpos = i + q_offset and sees key kpos when kpos < kv_valid, kpos <= qpos
// (causal) and kpos > qpos - window (sliding window); masked logits carry no
// weight (p = 0); a row that sees no key has l == 0, which is taken as 1, so
// it emits zeros. The output is in the inputs' dtype.
//
// Two kernels, chosen by dtype (never one for the other):
//  * bf16: flash_attention_wgmma_kernel, on the tensor cores (below).
//  * f32: flash_attention_simt_kernel, on the CUDA cores in f32. The tensor
//    cores would take f32 only as TF32, whose ~3 digits miss the f32 route's
//    1e-5 limit, so f32 stays exact here.
//
// What bounds it on the H100: operations. Prefill at qwen2-7b's shape
// (q 4 x 28 x 2048 x 128, k/v 4 x 4 x 2048 x 128, causal) needs
// 4 * b * hq * hd * s(s+1)/2 = 1.2e11 flops over the visible (q, k) pairs
// against 134 MB of q, k, v and output: 0.122 ms at 989 TFLOP/s (bf16 on
// the tensor cores) against 0.040 ms at 3.35 TB/s. On the CUDA cores in f32
// (67 TFLOP/s) the floor is 1.8 ms, so the bf16 kernel does both products
// with wgmma and keeps everything else off their path:
//
//  * Tiles. A block owns 128 query rows of one (batch, head): two
//    warpgroups of 64 rows each, each issuing wgmma.m64nNk16, so the block
//    reads each K/V tile once for 128 rows. It walks kv tiles of 128 keys:
//    S is then 64 f32 registers a thread, O 64 at hd 128, P's two parts 64.
//    At hd 256 O takes 128 registers, so the tiles hold 64 keys (S 32, P's
//    parts 32) and the ring two stages (TcTile).
//  * Registers. 256 threads, so ptxas may give each 255 and the wgmmas run
//    asynchronously. A producer warp on top would cost that: with 9 or 12
//    warps one of the SM's four register files holds 3 warps, so ptxas caps
//    every thread at 168, and setmaxnreg (producer 24 or 40, consumers 240
//    or 232) did not raise what it allocates to the consumer code; at 168
//    the split P V spilled and ptxas serialized the wgmmas (C7512).
//  * Loads. TMA with tensor maps made on the host, 3-D over (hd, seq,
//    batch * heads), so rows past sq or skv and columns past hd arrive as
//    zeros from inside their own head. A three-stage ring of K and V tiles
//    in shared memory, full / empty mbarriers (expect-tx, parity waits);
//    each warp releases a stage once its P V wgmmas have retired. Thread 0
//    issues the loads one tile ahead, into the stage the tile before last
//    used, so it waits only if the other warpgroup lags by more than a
//    tile (two stages, where it waits whenever the other lags at all,
//    measured no slower on the H100 at the prefill shape). q is loaded
//    once.
//    Shared memory at hd 128: q 32 KB + 3 x (32 + 32) KB = 224 KB, one
//    block an SM; at hd 256: q 64 KB + 2 x (32 + 32) KB = 192 KB.
//  * Overlap comes from the two warpgroups: each waits for its own S before
//    its softmax and for its P V before the next S, and the tensor cores run
//    one warpgroup's products while the other computes. Making them take
//    turns to issue (ping-pong, named barriers) measured 2% slower on the
//    H100 at the prefill shape, and issuing the next S beside the last P V
//    (intra-warpgroup overlap) 3% slower, P's two parts then holding 64
//    more registers across the tile.
//  * S = q K^T: both operands from shared memory, 128-byte swizzled, K in
//    its natural (keys, hd) layout as the K-major B operand; f32 accumulate
//    (bf16 products are exact in f32, so only the order of the sum differs
//    from an f32 kernel).
//  * O += P V: P goes from the S accumulator straight into wgmma's register
//    A fragment (the accumulator's layout is the fragment's layout), with no
//    trip through shared memory. V in (keys, hd) layout is the MN-major B
//    operand, read through wgmma's transpose bit. P is split in two bf16
//    parts, P_hi = bf16(p) and P_lo = bf16(p - P_hi), and P V is two wgmmas
//    a k16 slice: p keeps ~16 bits, where one bf16 keeps 8. With P in one
//    bf16, qwen2-7b's logits moved 0.0189 (relative RMS) from the plain
//    version's, past the 0.0181 the f32 kernels meet; the split costs 1.5x
//    the tensor-core work of one bf16 P.
//  * Masks only where a tile needs them: the causal diagonal, the window's
//    edge, the kv_valid / skv edge; interior tiles skip the mask arithmetic.
//    The loop visits only kv tiles that hold a key some row of the block can
//    see (fully masked tiles add nothing).
//  * Softmax in registers, in f32, in base 2: logits times scale * log2(e),
//    ex2.approx; a row's max reduces over the 4 threads that share it in the
//    accumulator layout; l stays per thread and meets once at the end.
//  * Head dims 16, 32, 64 run at a padded 64, 80 and 128 at 128, 256 at
//    256: the tensor maps' boxes are 64 columns (the 128-byte swizzle atom) and TMA
//    zero-fills the columns past hd, so S sums zeros there and P V computes
//    columns that are not written.
//  * Deterministic: one block owns each output tile, no atomics, no split
//    over keys. Grid (b * hq, q tiles), q tiles last-first: every head's
//    longest (causal) tile starts before any shorter one, and the heads that
//    share a kv head run side by side, so their K/V tiles come from L2.
//
// The f32 kernel: grid (query tile of 64 rows, b * hq), 4 warps; a warp owns
// 16 query rows, a thread 4 rows x 8 keys of the 64 x 64 logits tile and 4
// rows x hd/8 columns of the accumulator, with the q, K, V and p tiles in
// shared memory (113 KB at hd = 128), q and K rows padded by one float so
// the 8 keys a warp reads at once fall in 8 banks. Head dims are template
// parameters: 16, 32, 64, 80, 128 and 256 (there with 32-key tiles, 4 keys a
// thread: 137 KB).
#include <cuda.h>   // CUtensorMap; cuTensorMapEncodeTiled is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// -- bf16: the tensor-core kernel ---------------------------------------------

constexpr int kTcBlockM = 128;        // query rows a block
constexpr int kTcWarps = 8;           // 2 warpgroups
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kRowBytes = 128;        // a swizzled row: 64 bf16

// Keys a kv tile and the K/V ring's depth, by padded head dim: 128-key
// tiles in 3 stages to hd 128; at hd 256, 64-key tiles in 2 stages, which
// keeps a block's shared memory (q 64 KB + 2 x (32 + 32) KB) under the
// SM's 227 KB and S at 32 registers a thread beside O's 128.
template <int HDP>
struct TcTile {
  static constexpr int kBlockN = 128;
  static constexpr int kStages = 3;
};
template <>
struct TcTile<256> {
  static constexpr int kBlockN = 64;
  static constexpr int kStages = 2;
};

template <int HDP>
struct TcLayout {
  static constexpr int kBlockN = TcTile<HDP>::kBlockN;
  static constexpr int kStages = TcTile<HDP>::kStages;
  static constexpr int kHalves = HDP / 64;             // 64-column boxes
  static constexpr int kQHalf = kTcBlockM * kRowBytes; // one box of q
  static constexpr int kKVHalf = kBlockN * kRowBytes;
  static constexpr int kQBytes = kHalves * kQHalf;
  static constexpr int kKVBytes = kHalves * kKVHalf;   // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;              // + stage * kKVBytes
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  // barriers: q, then full K, full V and empty of each stage
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// kv tiles of BN keys [t_begin, t_end) hold every key some row of query tile
// q0 can see
template <int BN>
__device__ __forceinline__ void tile_range(int q0, int sq, int q_offset,
                                           int kv_lim, int causal,
                                           int use_window, int window,
                                           int* t_begin, int* t_end) {
  int k_end = kv_lim;
  if (causal) k_end = min(k_end, min(q0 + kTcBlockM, sq) + q_offset);
  const int k_begin = use_window ? max(0, q0 + q_offset - window + 1) : 0;
  *t_begin = k_begin / BN;
  *t_end = k_end > k_begin ? (k_end + BN - 1) / BN : *t_begin;
}

template <int HDP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ out, int hd, int hq,
                             int hkv, int group, int q_head0, int sq,
                             int q_offset, int kv_lim,
                             int causal, int use_window, int window,
                             float scale_log2) {
  using L = TcLayout<HDP>;
  using namespace hopper;
  constexpr int BN = L::kBlockN;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq_tile = base + L::kQ;
  const uint32_t bar_q = base + L::kBar;
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * kStages + s); };

  const int bh = blockIdx.x;
  const int kvh =
      (bh / hq) * hkv + (q_head0 + bh % hq) / group - q_head0 / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBlockM;
  int t_begin, t_end;
  tile_range<BN>(q0, sq, q_offset, kv_lim, causal, use_window, window,
                 &t_begin, &t_end);
  const int n_tiles = t_end - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kTcWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Thread 0 feeds the ring, one tile ahead of its own warpgroup: at the
  // start of tile it it loads tile it + 1 into the stage tile
  // it + 1 - kStages used, which (3 stages) the other warpgroup has released
  // unless it lags by a whole tile (2 stages: unless it lags at all).
  auto load_tile = [&](int it) {
    const int s = it % kStages;
    mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
    const int k0 = (t_begin + it) * BN;
    const uint32_t ks = base + L::kK + s * L::kKVBytes;
    const uint32_t vs = base + L::kV + s * L::kKVBytes;
    mbar_expect_tx(full_k(s), L::kKVBytes);
    for (int h = 0; h < L::kHalves; ++h)
      tma_load_3d(ks + h * L::kKVHalf, &tk, full_k(s), 64 * h, k0, kvh);
    mbar_expect_tx(full_v(s), L::kKVBytes);
    for (int h = 0; h < L::kHalves; ++h)
      tma_load_3d(vs + h * L::kKVHalf, &tv, full_v(s), 64 * h, k0, kvh);
  };
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
    for (int h = 0; h < L::kHalves; ++h)
      tma_load_3d(sq_tile + h * L::kQHalf, &tq, bar_q, 64 * h, q0, bh);
    load_tile(0);
  }
  __syncwarp();

  // warpgroup cw owns query rows q0 + 64 cw .. + 63
  const int cw = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row0 = q0 + 64 * cw + 16 * (t / 32) + lane / 4;  // and row0 + 8
  const int qpos0 = row0 + q_offset;
  const int wg_qpos_min = q0 + 64 * cw + q_offset;
  const int wg_qpos_max = wg_qpos_min + 63;
  const uint32_t q_wg = sq_tile + 64 * cw * kRowBytes;

  constexpr int kS = BN / 2;          // S accumulator a thread
  constexpr int kO = HDP / 2;         // O accumulator a thread
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max, log2 domain
  float l[2] = {0.f, 0.f};               // this thread's part of the sum

  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    if (threadIdx.x == 0 && it + 1 < n_tiles) load_tile(it + 1);
    __syncwarp();
    const int s = it % kStages;
    const uint32_t phase = (it / kStages) & 1;
    const int k0 = (t_begin + it) * BN;
    const uint32_t ks = base + L::kK + s * L::kKVBytes;
    const uint32_t vs = base + L::kV + s * L::kKVBytes;

    // S = q K^T over the (padded) head dim, k16 slices
    float sacc[kS];
    mbar_wait(full_k(s), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;   // 32 bytes a k16 slice
      wgmma_ss<BN>(
          sacc, sw128_desc(q_wg + (kk / 4) * L::kQHalf + off, 16),
          sw128_desc(ks + (kk / 4) * L::kKVHalf + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // logits in the log2 domain; masked ones -inf, only on edge tiles
    const bool edge = k0 + BN > kv_lim ||
                      (causal && k0 + BN - 1 > wg_qpos_min) ||
                      (use_window && k0 <= wg_qpos_max - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kS / 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kpos = k0 + 8 * j + 2 * (lane % 4) + c;
            const int qpos = qpos0 + 8 * i;
            const bool ok = kpos < kv_lim && (!causal || kpos <= qpos) &&
                            (!use_window || kpos > qpos - window);
            float& x = sacc[4 * j + 2 * i + c];
            x = ok ? x * scale_log2 : -INFINITY;
          }
    } else {
#pragma unroll
      for (int e = 0; e < kS; ++e) sacc[e] *= scale_log2;
    }

    // online softmax, row i of this thread = row0 + 8 i
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kS / 4; ++j)
        mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * i], sacc[4 * j + 2 * i + 1]));
      const float m_new = fmaxf(m[i], quad_max(mx));
      const float mo = m_new == -INFINITY ? 0.f : m_new;  // no -inf - -inf
      const float alpha = ex2(m[i] - mo);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kS / 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = sacc[4 * j + 2 * i + c];
          x = ex2(x - mo);
          sum += x;
        }
      l[i] = alpha * l[i] + sum;
#pragma unroll
      for (int j = 0; j < kO / 4; ++j) {
        o[4 * j + 2 * i] *= alpha;
        o[4 * j + 2 * i + 1] *= alpha;
      }
    }

    // P = P_hi + P_lo, both bf16, in the register A fragments of each k16
    // slice of keys: p to ~16 bits, where one bf16 keeps 8
    uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = sacc[8 * kk + 2 * r], x1 = sacc[8 * kk + 2 * r + 1];
        p_hi[kk][r] = pack_bf16(x0, x1);
        const float2 hi = unpack_bf16(p_hi[kk][r]);
        p_lo[kk][r] = pack_bf16(x0 - hi.x, x1 - hi.y);
      }

    // O += P V; V's 64-column boxes lie kKVHalf apart (the MN-major LBO)
    mbar_wait(full_v(s), phase);
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t v_desc = sw128_desc(vs + kk * 16 * kRowBytes, L::kKVHalf);
      wgmma_rs_tb<HDP>(o, p_hi[kk], v_desc);
      wgmma_rs_tb<HDP>(o, p_lo[kk], v_desc);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty(s));
  }

  // O / l, rows < sq and columns < hd, two bf16 a store
  __nv_bfloat16* og = out + (size_t)bh * sq * hd;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lt = quad_sum(l[i]);
    const float inv = 1.f / (lt == 0.f ? 1.f : lt);
    const int row = row0 + 8 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < kO / 4; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row * hd + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                  o[4 * j + 2 * i + 1] * inv);
    }
  }
}

// (hd, rows, heads) bf16, row-major, boxes of 64 columns x box_rows rows of
// one head, 128-byte swizzle, zeros out of bounds
bool make_map(hopper::EncodeTiledFn encode, CUtensorMap* map,
              const void* base, int hd, int rows, int heads, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)hd * 2 * rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int batch, int hq, int hkv, int group, int q_head0,
                      int sq, int skv, int hd,
                      int q_offset, int kv_valid, int causal, int use_window,
                      int window, float scale, cudaStream_t stream) {
  hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  constexpr int kBlockN = TcTile<HDP>::kBlockN;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, hd, sq, batch * hq, kTcBlockM) ||
      !make_map(encode, &tk, k, hd, skv, batch * hkv, kBlockN) ||
      !make_map(encode, &tv, v, hd, skv, batch * hkv, kBlockN))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_wgmma_kernel<HDP>;
  const int smem = TcLayout<HDP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * hq, (sq + kTcBlockM - 1) / kTcBlockM);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), hd, hq, hkv, group,
      q_head0, sq, q_offset, kv_valid < skv ? kv_valid : skv, causal,
      use_window, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// -- f32: the CUDA-core kernel --------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kThreads = 128;
constexpr int kLanesPerRow = 8;                    // tx = lane % 8
constexpr int kRows = 4;                           // query rows a thread owns
constexpr float kNeg = -1e30f;

static_assert(kThreads / kLanesPerRow * kRows == kBlockQ, "row tiling");

// Keys a tile: 64, but 32 at hd 256, where the accumulator alone takes 128
// registers a thread and 64 keys would take 209 KB of shared memory
template <int HD>
struct Layout {
  static constexpr int kBlockK = HD == 256 ? 32 : 64;
  static constexpr int kKeys = kBlockK / kLanesPerRow;   // keys a thread owns
  static constexpr int kQK = HD + 1;               // padded row of q and K
  static constexpr int kP = kBlockK + 1;           // padded row of p
  static constexpr size_t kBytes =
      sizeof(float) * ((size_t)kBlockQ * kQK + (size_t)kBlockK * kQK +
                       (size_t)kBlockK * HD + (size_t)kBlockQ * kP);
};

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < kLanesPerRow; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < kLanesPerRow; o <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_simt_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ out, int hq, int hkv,
                            int group, int q_head0, int sq, int skv,
                            int q_offset, int kv_valid, int causal,
                            int use_window, int window, float scale) {
  using L = Layout<HD>;
  constexpr int kBlockK = L::kBlockK;
  constexpr int kKeys = L::kKeys;
  constexpr int kCols = HD / kLanesPerRow;         // accumulator columns
  static_assert(HD % kLanesPerRow == 0, "head dim tiling");
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * L::kQK;
  float* vs = ks + kBlockK * L::kQK;
  float* ps = vs + kBlockK * HD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int bh = blockIdx.y;
  const int kvh =
      (bh / hq) * hkv + (q_head0 + bh % hq) / group - q_head0 / group;
  const float* qg = q + (size_t)bh * sq * HD;
  const float* kg = k + (size_t)kvh * skv * HD;
  const float* vg = v + (size_t)kvh * skv * HD;
  float* og = out + (size_t)bh * sq * HD;

  const int tid = threadIdx.x;
  const int tx = tid % kLanesPerRow;
  const int r0 = (tid / kLanesPerRow) * kRows;

  for (int e = tid; e < kBlockQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    qs[r * L::kQK + c] = q0 + r < sq ? qg[(size_t)(q0 + r) * HD + c] : 0.f;
  }

  // keys [k_begin, k_end) hold every key some row of this tile can see
  int k_end = kv_valid;
  if (causal) k_end = min(k_end, min(q0 + kBlockQ, sq) + q_offset);
  const int k_begin = use_window ? max(0, q0 + q_offset - window + 1) : 0;
  const int t_begin = k_begin / kBlockK;
  const int t_end = k_end > k_begin ? (k_end + kBlockK - 1) / kBlockK
                                    : t_begin;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();               // q staged; the last tile's K, V, p read
    for (int e = tid; e < kBlockK * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      const bool in = k0 + r < skv;
      const size_t g = (size_t)(k0 + r) * HD + c;
      ks[r * L::kQK + c] = in ? kg[g] : 0.f;
      vs[r * HD + c] = in ? vg[g] : 0.f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(r0 + i) * L::kQK + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        kv[j] = ks[(tx + kLanesPerRow * j) * L::kQK + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + r0 + i + q_offset;
      bool vis[kKeys];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kpos = k0 + tx + kLanesPerRow * j;
        bool ok = kpos < kv_valid;
        if (causal) ok = ok && kpos <= qpos;
        if (use_window) ok = ok && kpos > qpos - window;
        vis[j] = ok;
        s[i][j] = ok ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(r0 + i) * L::kP + tx + kLanesPerRow * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();                  // a warp reads back only its own p rows

#pragma unroll 4
    for (int key = 0; key < kBlockK; ++key) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(r0 + i) * L::kP + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vs[key * HD + tx + kLanesPerRow * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    if (row >= sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      og[(size_t)row * HD + tx + kLanesPerRow * c] = acc[i][c] * inv;
  }
}

template <int HD>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* out, int batch, int hq, int hkv, int group,
                        int q_head0, int sq, int skv, int q_offset,
                        int kv_valid, int causal, int use_window, int window,
                        float scale, cudaStream_t stream) {
  auto kernel = flash_attention_simt_kernel<HD>;
  const size_t smem = Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), hq, hkv, group,
      q_head0, sq, skv, q_offset, kv_valid, causal, use_window, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_simt(int hd, const void* q, const void* k,
                          const void* v, void* out, int batch, int hq, int hkv,
                          int group, int q_head0, int sq, int skv,
                          int q_offset, int kv_valid, int causal,
                          int use_window, int window, float scale,
                          cudaStream_t stream) {
#define REPRO_FLASH_HD(HD)                                                   \
  case HD:                                                                   \
    return launch_simt<HD>(q, k, v, out, batch, hq, hkv, group, q_head0, sq, \
                           skv, q_offset, kv_valid, causal, use_window,      \
                           window, scale, stream);
  switch (hd) {
    REPRO_FLASH_HD(16)
    REPRO_FLASH_HD(32)
    REPRO_FLASH_HD(64)
    REPRO_FLASH_HD(80)
    REPRO_FLASH_HD(128)
    REPRO_FLASH_HD(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_HD
}

bool tc_head_dim(int hd) {
  return hd == 16 || hd == 32 || hd == 64 || hd == 80 || hd == 128 ||
         hd == 256;
}

}  // namespace

extern "C" {

// q, out: (batch, hq, sq, hd); k, v: (batch, hkv, skv, hd); all contiguous,
// all f32 (is_bf16 = 0: the CUDA-core kernel) or all bf16 (= 1: the
// tensor-core kernel, whose inputs must be 16-byte aligned for TMA). Query
// head h reads kv head (q_head0 + h) / group - q_head0 / group, which must be
// < hkv (group = hq / hkv, q_head0 = 0: plain GQA). hd one of 16, 32, 64, 80,
// 128, 256, batch * hq <= 65535. use_window = 0 ignores window. group and
// q_head0 come last: a caller that passes them can also call a library built
// from an older revision of this file, which ignores them
// (tools/flash_variants.py --against). Returns the CUDA error code of the
// launch (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int batch, int hq, int hkv, int sq,
                           int skv, int hd, int q_offset, int kv_valid,
                           int causal, int use_window, int window, float scale,
                           int is_bf16, void* stream_ptr, int group,
                           int q_head0) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (group < 1 || q_head0 < 0 ||
      (hq > 0 && (q_head0 + hq - 1) / group - q_head0 / group >= hkv))
    return (int)cudaErrorInvalidValue;
  if (!is_bf16)
    return (int)dispatch_simt(hd, q, k, v, out, batch, hq, hkv, group, q_head0,
                              sq, skv, q_offset, kv_valid, causal, use_window,
                              window, scale, stream);
  if (!tc_head_dim(hd)) return (int)cudaErrorInvalidValue;
  if (hd <= 64)
    return (int)launch_tc<64>(q, k, v, out, batch, hq, hkv, group, q_head0, sq,
                              skv, hd, q_offset, kv_valid, causal, use_window,
                              window, scale, stream);
  if (hd <= 128)
    return (int)launch_tc<128>(q, k, v, out, batch, hq, hkv, group, q_head0,
                               sq, skv, hd, q_offset, kv_valid, causal,
                               use_window, window, scale, stream);
  return (int)launch_tc<256>(q, k, v, out, batch, hq, hkv, group, q_head0, sq,
                             skv, hd, q_offset, kv_valid, causal, use_window,
                             window, scale, stream);
}

// Dynamic shared memory of one block of the tensor-core kernel at head dim
// hd (bytes), for reports.
int flash_attention_tc_smem_bytes(int hd) {
  return hd <= 64    ? TcLayout<64>::kBytes
         : hd <= 128 ? TcLayout<128>::kBytes
                     : TcLayout<256>::kBytes;
}

}  // extern "C"
